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
// vector of bf16); every edge is masked, so any such shape runs.
//
// Bound: at the tensor-parallel transformer's shapes (m = 6144 tokens,
// k and n 2048-8192) a call moves 59-159 MB and does 52-206 GFLOP, so it is
// bound by operations on an H100 (0.05-0.21 ms at 989 TFLOP/s), not by
// bytes (0.02-0.05 ms at 3.35 TB/s).
//
// Design (simple first): one 128x128 output tile per block of 8 warps, each
// warp 64 (M) x 32 (N); the K loop in steps of 32 through a 4-stage cp.async
// ring; mma.sync m16n8k16 bf16 with fp32 accumulators, operands through
// ldmatrix -- .trans where an operand's tile is stored K-major (A with a_t,
// B without b_t).  The TPU kernel held a whole (bm, k) x (k, bn) strip in
// VMEM and made one dot of it; here the strip streams through shared memory.
// wgmma, TMA and a persistent schedule are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int LDS = BK + 8;  // a tile stored [128][32 + 8]: rows M or N, K contiguous
constexpr int LDT = BM + 8;  // a tile stored [32][128 + 8]: rows K, M or N contiguous
constexpr int TILE = BM * LDS > BK * LDT ? BM * LDS : BK * LDT;  // elements per tile slot

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// One operand tile of one K step into shared memory, two 16-byte chunks a
// thread.  kmajor: the operand is stored with K as its rows (ld = outer
// extent), so the tile is [32 k][128] with ld LDT; otherwise it is stored with
// K contiguous (ld = K) and the tile is [128][32 k] with ld LDS.  outer0 is the
// tile's first row of M (or N), k0 its first K index.
template <bool KMAJOR>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int outer0, int outer, int k0,
                                          int K, int tid) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (KMAJOR) {
      const int r = (tid >> 4) + j * 16, c = (tid & 15) * 8;
      const int k = k0 + r, o = outer0 + c;
      const bool ok = k < K && o < outer;
      cp_async16(s + r * LDT + c, ok ? g + (size_t)k * outer + o : g, ok);
    } else {
      const int r = (tid >> 2) + j * 64, c = (tid & 3) * 8;
      const int o = outer0 + r, k = k0 + c;
      const bool ok = o < outer && k < K;
      cp_async16(s + r * LDS + c, ok ? g + (size_t)o * K + k : g, ok);
    }
  }
}

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float lo, float hi);

template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32(lo, hi);
}

template <>
__device__ __forceinline__ void store_pair<float>(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// grid (ceil(M / 128), ceil(N / 128))
template <bool AT, bool BT, typename OutT>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, OutT* __restrict__ C, int M,
          int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [STAGES][TILE]
  bf16* sB = sA + STAGES * TILE;             // [STAGES][TILE]
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int ksteps = (K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    // A is K-major when stored transposed; B is K-major when stored (K, N)
    load_tile<AT>(sA + stage * TILE, A, m0, M, kt * BK, K, tid);
    load_tile<!BT>(sB + stage * TILE, B, n0, N, kt * BK, K, tid);
  };

  // acc[mi][ni]: rows wm*64 + mi*16 + {g, g+8}, columns wn*32 + ni*8 + 2*t4 + {0,1}
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ksteps; ++kt) {
    cp_async_wait_stages();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < ksteps) load(next % STAGES, next);
    cp_async_commit();
    const bf16* sa = sA + (kt % STAGES) * TILE;
    const bf16* sb = sB + (kt % STAGES) * TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (AT)
          ldsm_x4_trans(af[mi], sa + (kk + (lane & 7) + ((lane >> 4) << 3)) * LDT + wm * 64 +
                                    mi * 16 + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(af[mi], sa + (wm * 64 + mi * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        if (BT)
          ldsm_x4(r, sb + (wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk +
                         ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_trans(r, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT + wn * 32 +
                               nj * 16 + (lane >> 4) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], af[mi], bfr[ni]);
    }
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (m >= M) continue;
      OutT* row = C + (size_t)m * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // N is a multiple of 8, so a column pair is in or out as a whole
        const int n = n0 + wn * 32 + ni * 8 + t4 * 2;
        if (n < N) store_pair<OutT>(row + n, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

template <bool AT, bool BT, typename OutT>
int launch(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t s) {
  const size_t smem = (size_t)2 * STAGES * TILE * sizeof(bf16);
  int rc = (int)cudaFuncSetAttribute(mm_kernel<AT, BT, OutT>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc) return rc;
  mm_kernel<AT, BT, OutT><<<dim3((m + BM - 1) / BM, (n + BN - 1) / BN), THREADS, smem, s>>>(
      (const bf16*)a, (const bf16*)b, (OutT*)c, m, n, k);
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

// Returns 0, the CUDA error of the launch, or -1 when a dimension is not a
// positive multiple of 8.  a, b and c are 16-byte aligned; c is (m, n) bf16,
// or fp32 with out_f32.
extern "C" int hvd_matmul(const void* a, const void* b, void* c, int m, int n, int k, int a_t,
                          int b_t, int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % 8 || n % 8 || k % 8) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<float>(a, b, c, m, n, k, a_t, b_t, s)
                 : dispatch<bf16>(a, b, c, m, n, k, a_t, b_t, s);
}
