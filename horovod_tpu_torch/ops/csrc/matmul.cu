// C = op(A) * op(B) for Hopper: bf16 inputs, fp32 accumulation, bf16 or fp32
// output.
//
// Replaces, in horovod_tpu/ops/pallas_kernels.py:
//   hvd_matmul <- pallas_matmul / _mm_kernel
// the per-tile compute of the tensor-parallel ring ops (matmul_reducescatter,
// allgather_matmul).
//
// Layouts.  A is (M, K) row-major, or with a_t its transpose stored (K, M)
// row-major.  B is (K, N) row-major, or with b_t its transpose stored (N, K)
// row-major: a PyTorch (out, in) weight read as it is.  C is (M, N)
// row-major.  With those two flags one kernel serves the three products of a
// linear layer without copying an operand: the forward x * W^T (b_t), dX =
// dy * W, and dW = dy^T * x (a_t).  M, N and K are multiples of 8 (one 16-byte
// vector of bf16, which a tensor map's row stride needs); any such shape runs.
//
// Bound: at the tensor-parallel transformer's shapes (m = 6144 tokens,
// k and n 2048-8192) a call moves 59-159 MB and does 52-206 GFLOP, so it is
// bound by operations on an H100 (0.05-0.21 ms at 989 TFLOP/s, 0.1563 ms on
// the mean of the path's 12 products), not by bytes (0.02-0.05 ms at
// 3.35 TB/s).  Only wgmma reaches the tensor cores' full rate, and it must be
// fed from shared memory without the issuing warps copying.
//
// Design: warp-specialised TMA + wgmma (sm90.cuh).  A block of three
// warpgroups computes 128 x 256 tiles of C, one block per SM walking the
// tiles (a persistent schedule: the ring runs on from one tile to the
// next, so the first loads of a tile overlap the last one's epilogue, and
// no block waits for another's launch).  The producer warpgroup gives up
// its registers (setmaxnreg) and one of its threads starts the TMA loads of
// each K step's A (128 x 64) and B (256 x 64) boxes, 48 KB, into a ring of 4
// stages guarded by full/empty mbarrier pairs.  The two consumer warpgroups
// take 232 registers each and compute 64 x 256 each with wgmma.m64n256k16
// straight from shared memory, keeping one wgmma group in flight and freeing
// a stage once the group that read it has retired.  The tensor maps write
// the 128-byte swizzle; each operand's layout is set in its descriptor and
// the wgmma transpose bit, so the three layouts read their operands in place:
// A (M, K) and a (N, K) B are K-major boxes of 64 K columns; a transposed A
// or a (K, N) B are MN-major, loaded as 64-column boxes of 64 K rows.  TMA
// fills zeros past every edge, so ragged M, N and K need no masking in the
// main loop.  The epilogue writes each warpgroup's fp32 accumulators (as
// bf16 or fp32) into two swizzled 8 KB shared buffers, 128 bytes of each
// row at a time, and a TMA store takes each box out, dropping what lies
// past M and N; the stores drain while the next tile's products run
// (stores straight from registers would hold the tensor cores idle).  The
// tiles are walked in groups of 8 row tiles for L2 reuse.  The TPU kernel
// held a whole (bm, k) x (k, bn) strip in VMEM and made one dot of it;
// here the strip streams through the ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using namespace sm90;

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;  // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int GROUP_M = 8;
constexpr int A_BYTES = BM * BK * 2;  // 16 KB
constexpr int B_BYTES = BN * BK * 2;  // 32 KB
constexpr int BOX_BYTES = 64 * 64 * 2;  // an MN-major box: 64 K rows of 64
constexpr int C_BOX_BYTES = 64 * 128;   // a C box: 64 rows of 128 bytes
constexpr size_t SMEM = 1024 + (size_t)STAGES * (A_BYTES + B_BYTES) +
                        (size_t)CONSUMERS * 2 * C_BOX_BYTES + 2 * STAGES * 8;

// Box q of a warpgroup's 64 x 256 accumulators (128 bytes of each row: 64
// bf16 or 32 fp32 columns) into `box`, 128-byte swizzled as the C tensor
// map reads it: 16-byte chunk c of row r at chunk c ^ (r % 8), which also
// keeps a warp's stores free of bank conflicts.
template <typename OutT, int Q>
__device__ __forceinline__ void write_box(unsigned char* box, const float (&acc)[128], int warp,
                                          int lane) {
  constexpr int J = 128 / sizeof(OutT) / 8;  // 8-column accumulator blocks a box
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + lane / 4 + 8 * half;
    unsigned char* row = box + r * 128;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const float lo = acc[4 * (Q * J + jj) + 2 * half], hi = acc[4 * (Q * J + jj) + 2 * half + 1];
      if (sizeof(OutT) == 2) {  // 8 columns are one 16-byte chunk
        *reinterpret_cast<__nv_bfloat162*>(row + ((jj ^ (r & 7)) << 4) + 4 * (lane % 4)) =
            __floats2bfloat162_rn(lo, hi);
      } else {  // 8 columns are two
        const int chunk = 2 * jj + (lane % 4) / 2;
        *reinterpret_cast<float2*>(row + ((chunk ^ (r & 7)) << 4) + 8 * (lane % 2)) =
            make_float2(lo, hi);
      }
    }
  }
}

template <typename OutT, int Q>
__device__ __forceinline__ void store_boxes(const CUtensorMap* map_c, unsigned char* bufs,
                                            const float (&acc)[128], int m0, int n0, int wg,
                                            int warp, int lane, bool leader) {
  if constexpr (Q < BN * (int)sizeof(OutT) / 128) {
    unsigned char* box = bufs + (Q % 2) * C_BOX_BYTES;
    // the store that last read this buffer, two boxes ago, is done with it
    if (leader) bulk_wait_read<1>();
    named_bar_sync(1 + wg, 128);
    write_box<OutT, Q>(box, acc, warp, lane);
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (leader) {
      tma_store_2d(map_c, box, n0 + Q * 128 / (int)sizeof(OutT), m0 + wg * 64);
      bulk_commit();
    }
    store_boxes<OutT, Q + 1>(map_c, bufs, acc, m0, n0, wg, warp, lane, leader);
  }
}

// Tile `tile` of C in the grouped order: GROUP_M row tiles share each
// column tile in turn, so blocks running together reuse A and B in L2.
__device__ __forceinline__ void tile_origin(int tile, int M, int N, int& m0, int& n0) {
  const int num_m = (M + BM - 1) / BM, num_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * num_n;
  const int first_m = (tile / per_group) * GROUP_M;
  const int rows_in_group = min(num_m - first_m, GROUP_M);
  const int in_group = tile % per_group;
  m0 = (first_m + in_group % rows_in_group) * BM;
  n0 = (in_group / rows_in_group) * BN;
}

// grid: at most one block per SM, each walking tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; the ring runs on across tiles, so the
// producer loads a tile's first stages while the consumers store the last.
template <bool AT, bool BT, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
mm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          const __grid_constant__ CUtensorMap map_c, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* sA = smem;                     // [STAGES][A_BYTES]
  unsigned char* sB = smem + STAGES * A_BYTES;  // [STAGES][B_BYTES]
  unsigned char* sC = sB + STAGES * B_BYTES;     // [CONSUMERS][2][C_BOX_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + CONSUMERS * 2 * C_BOX_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int ksteps = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    reg_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      tma_prefetch(&map_a);
      tma_prefetch(&map_b);
      tma_prefetch(&map_c);
      int s = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, M, N, m0, n0);
        for (int kt = 0; kt < ksteps; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
          unsigned char* a = sA + s * A_BYTES;
          unsigned char* b = sB + s * B_BYTES;
          const int k0 = kt * BK;
          if (AT) {  // (K, M) storage: two boxes of 64 M columns
            tma_load_2d(a, &map_a, &full[s], m0, k0);
            tma_load_2d(a + BOX_BYTES, &map_a, &full[s], m0 + 64, k0);
          } else {  // (M, K) storage: one box of 128 rows
            tma_load_2d(a, &map_a, &full[s], k0, m0);
          }
          if (BT) {  // (N, K) storage: one box of 256 rows
            tma_load_2d(b, &map_b, &full[s], k0, n0);
          } else {  // (K, N) storage: four boxes of 64 N columns
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(b + j * BOX_BYTES, &map_b, &full[s], n0 + 64 * j, k0);
          }
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    int s = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, M, N, m0, n0);
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kt = 0; kt < ksteps; ++kt) {
        mbar_wait(&full[s], phase);
        // this warpgroup's 64 rows of A: rows 64*wg.. of a K-major box, or
        // the wg-th 64-column box of an MN-major A; both 8 KB in
        const unsigned char* a = sA + s * A_BYTES + wg * (A_BYTES / 2);
        const unsigned char* b = sB + s * B_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = AT ? desc_sw128(a + kk * 2048, BOX_BYTES, 1024)
                                 : desc_sw128(a + kk * 32, 16, 1024);
          const uint64_t db = BT ? desc_sw128(b + kk * 32, 16, 1024)
                                 : desc_sw128(b + kk * 2048, BOX_BYTES, 1024);
          wgmma_m64n256k16_ss<AT ? 1 : 0, BT ? 0 : 1>(acc, da, db, 1);
        }
        wgmma_commit();
        fence_regs(acc);
        // the group committed one step ago has read its stage: free it
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == STAGES) s = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);

      // C leaves through shared memory by TMA, a 64-row box at a time in
      // two buffers, so the stores drain while the next tile computes
      store_boxes<OutT, 0>(&map_c, sC + wg * 2 * C_BOX_BYTES, acc, m0, n0, wg, warp, lane,
                           threadIdx.x % 128 == 0);
    }
    if (threadIdx.x % 128 == 0) bulk_wait<0>();
  }
}

// The tensor map of a `rows` x `cols` row-major matrix moved in boxes of
// box_rows rows by 128 bytes (64 bf16 or 32 fp32 columns).
template <typename T>
bool matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * sizeof(T)};
  const uint32_t box[2] = {128 / sizeof(T), (uint32_t)box_rows};
  return encode_tensor_map(map, base, 2, dims, strides, box,
                           sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

template <bool AT, bool BT, typename OutT>
int launch(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t s) {
  // first a runtime call, which makes the device's context current in this
  // thread: the encoder needs one, and a thread PyTorch's autograd runs a
  // backward on may not have it yet
  int rc = (int)cudaFuncSetAttribute(mm_kernel<AT, BT, OutT>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (rc) return rc;
  CUtensorMap map_a, map_b, map_c;
  const bool ok =
      (AT ? matrix_map<bf16>(&map_a, a, k, m, 64) : matrix_map<bf16>(&map_a, a, m, k, BM)) &&
      (BT ? matrix_map<bf16>(&map_b, b, n, k, BN) : matrix_map<bf16>(&map_b, b, k, n, 64)) &&
      matrix_map<OutT>(&map_c, c, m, n, 64);
  if (!ok) return -2;
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  int device, sms;
  if ((rc = (int)cudaGetDevice(&device)) ||
      (rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))
    return rc;
  mm_kernel<AT, BT, OutT><<<tiles < sms ? tiles : sms, THREADS, SMEM, s>>>(map_a, map_b, map_c, m,
                                                                         n, k);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch(const void* a, const void* b, void* c, int m, int n, int k, int a_t, int b_t,
             cudaStream_t s) {
  if (a_t) {
    return b_t ? launch<true, true, OutT>(a, b, c, m, n, k, s)
               : launch<true, false, OutT>(a, b, c, m, n, k, s);
  }
  return b_t ? launch<false, true, OutT>(a, b, c, m, n, k, s)
             : launch<false, false, OutT>(a, b, c, m, n, k, s);
}

}  // namespace

// Returns 0, the CUDA error of the launch, -1 when a dimension is not a
// positive multiple of 8, or -2 when the CUDA driver refuses an operand's tensor
// map.  a, b and c are 16-byte aligned; c is (m, n) bf16, or fp32 with
// out_f32.
extern "C" int hvd_matmul(const void* a, const void* b, void* c, int m, int n, int k, int a_t,
                          int b_t, int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % 8 || n % 8 || k % 8) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<float>(a, b, c, m, n, k, a_t, b_t, s)
                 : dispatch<bf16>(a, b, c, m, n, k, a_t, b_t, s);
}
