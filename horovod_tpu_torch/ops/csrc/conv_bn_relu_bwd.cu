// Backward of ResNet's stride-1 3x3 segment  b = relu(bn_inference(conv3x3_same(a, W)))
// for Hopper, deterministic (no atomics).
//
// Replaces, in horovod_tpu/ops/pallas_kernels.py:
//   hvd_cbr_bwd <- fused_conv_bn_relu_bwd / _cbr_bwd_kernel
// and computes what it computes, from the relu output b alone:
//   dz     = db * (b > 0)                                   relu mask
//   dbeta  = sum dz,  dgamma = sum dz * (b - beta) / gamma_safe
//   dy     = bf16(dz * seff)                                BN input gradient
//   dW     = 9 taps of  a_shift^T dy                        (wgrad, fp32 out)
//   da     = 9 taps of  dy_shift W^T                        (dgrad, W in bf16)
// gamma_safe is gamma, or 1 where |gamma| < 1e-12, so such a channel's dgamma
// is 0 and not NaN, as in the Pallas kernel.
//
// Layout: db, b, dy and da are (rows = n*h*w, c or cin) bf16, the JAX package's
// NHWC; a is (rows, cin) bf16; the wrapper hands W as wt (cin, 9, c) bf16, so
// that one row of dgrad's B operand is contiguous.  Out-of-image taps are
// masked in the loads (cp.async zero-fill), so nothing is padded in memory.
// Outputs dW (3, 3, cin, c), dgamma and dbeta are fp32.  cin and c must be
// multiples of 128, c at most 2048.
//
// Bound: at the model's shapes (batch 128, 28x28x128 and 14x14x256) the two
// implicit GEMMs are 2 x 29.6 GFLOP on about 104 MB (56 MB), so the kernel is
// bound by operations (0.060 ms at 989 TFLOP/s) and not by bytes (0.031 ms).
// Only wgmma reaches the tensor cores' full rate on Hopper.  Design: four
// launches in one call.
//   1. prologue: relu mask, dy, and per-block fp32 partials of dgamma/dbeta;
//   2. dgrad GEMM, M = rows, N = cin, K = 9*c;
//   3. wgrad GEMM, M = 9*cin, N = c, K = rows, split-K over the rows so that
//      the few output tiles (9 at 128x128 channels) still fill 132 SMs; each
//      split writes its own fp32 partial;
//   4. a fixed-order sum of the partials into dW, dgamma and dbeta.
// Both GEMMs are wgmma (m64n128k16, bf16 in, fp32 accumulators) from shared
// memory, 128x128 tiles of two warpgroups, K steps of 64 through a 3-stage
// cp.async ring that writes the 128-byte-swizzle layout itself (see the GEMM
// block below).  Every sum runs in a fixed order and nothing is atomic, so
// two calls on the same inputs give the same bits.  The TPU kernel's
// sequential grid, which carried dW and the channel sums in VMEM from one
// batch tile to the next, does not carry over: Hopper blocks run in no
// order, hence the partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

using namespace sm90;

constexpr int THREADS = 256;        // prologue and finalize

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Pixel index -> (image, y, x)
struct Pixel {
  int img, y, x;
};

__device__ __forceinline__ Pixel decode(int p, int hh, int ww) {
  const int hw = hh * ww;
  const int img = p / hw, rem = p - img * hw;
  const int y = rem / ww;
  return {img, y, rem - y * ww};
}

// ---------------------------------------------------------------------------
// 1. prologue: relu mask, dy, per-block partials of dgamma and dbeta
// ---------------------------------------------------------------------------
// Each thread owns 8 channels (one 16-byte vector) of THREADS / (c / 8) rows in
// flight; the block walks `block_rows` rows, then sums its threads' partials
// per channel in a fixed order.  part_bn is (2, gridDim.x, c): dgamma, dbeta.
// The wrapper sizes the blocks so that there are about three waves of them
// (cbr_prologue_rows in kernels.py): too few leave the latency of device
// memory uncovered, too many multiply the partials the finalize sums.
__global__ void __launch_bounds__(THREADS)
cbr_prologue(const bf16* __restrict__ db, const bf16* __restrict__ b,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float* __restrict__ seff, bf16* __restrict__ dy, float* __restrict__ part_bn,
             int rows, int c, int block_rows) {
  __shared__ float sred[2][2048];  // groups * c <= 2048
  const int vec = c / 8, groups = THREADS / vec;
  const int tid = threadIdx.x, grp = tid / vec, ch0 = (tid % vec) * 8;
  if (grp < groups) {
    float gsafe[8], bt[8], se[8], gsum[8], bsum[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float gm = gamma[ch0 + j];
      gsafe[j] = fabsf(gm) < 1e-12f ? 1.f : gm;
      bt[j] = beta[ch0 + j];
      se[j] = seff[ch0 + j];
      gsum[j] = bsum[j] = 0.f;
    }
    const int r1 = min((blockIdx.x + 1) * block_rows, rows);
#pragma unroll 4
    for (int r = blockIdx.x * block_rows + grp; r < r1; r += groups) {
      const size_t off = (size_t)r * c + ch0;
      const uint4 vdb = *reinterpret_cast<const uint4*>(db + off);
      const uint4 vb = *reinterpret_cast<const uint4*>(b + off);
      const bf16* pdb = reinterpret_cast<const bf16*>(&vdb);
      const bf16* pb = reinterpret_cast<const bf16*>(&vb);
      uint4 vdy;
      bf16* pdy = reinterpret_cast<bf16*>(&vdy);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = __bfloat162float(pb[j]);
        const float dz = bv > 0.f ? __bfloat162float(pdb[j]) : 0.f;
        bsum[j] += dz;
        gsum[j] += dz * ((bv - bt[j]) / gsafe[j]);
        pdy[j] = __float2bfloat16_rn(dz * se[j]);
      }
      *reinterpret_cast<uint4*>(dy + off) = vdy;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sred[0][grp * c + ch0 + j] = gsum[j];
      sred[1][grp * c + ch0 + j] = bsum[j];
    }
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += THREADS) {
    float g = 0.f, bb = 0.f;
    for (int k = 0; k < groups; ++k) {
      g += sred[0][k * c + ch];
      bb += sred[1][k * c + ch];
    }
    part_bn[(size_t)blockIdx.x * c + ch] = g;
    part_bn[((size_t)gridDim.x + blockIdx.x) * c + ch] = bb;
  }
}

// ---------------------------------------------------------------------------
// the GEMM block shared by dgrad and wgrad: two warpgroups, wgmma
// ---------------------------------------------------------------------------
// A block computes a 128 x 128 tile, warpgroup wg its rows 64 wg .. 64 wg +
// 63, in fp32 registers (64 a thread: the m64n128 fragment of sm90.cuh).
// K runs in steps of 64: each stage holds A and B as 16 KB tiles in the
// 128-byte-swizzle layout that a TMA box has (16-byte chunk j of 128-byte
// row r at chunk j ^ (r % 8), 1024-byte aligned), written by the block's
// own cp.async loads, which gather the shifted pixels and zero-fill the
// taps outside the image (a tiled tensor map would need tiles that stay
// inside one image's band of rows, and 784 and 196 pixels are no multiple
// of 64).  So wgmma reads them through the two validated descriptor
// patterns (sm90.cuh): K-major for dgrad, MN-major for wgrad.  Three
// stages, the loads two steps ahead; after its products a warpgroup waits
// for them, so that one __syncthreads a step both publishes the stage that
// landed and frees the one the next loads overwrite.  Two blocks an SM
// (97 KB each) keep the tensor cores busy through each other's barriers.
// On an H100 this ran faster than one block an SM with deeper rings (4-6
// stages, one wgmma group left in flight) and than persistent
// warp-specialised blocks (one or two producer warpgroups gathering into a
// 6-stage ring, signalling it with cp.async.mbarrier.arrive, for two
// consumer warpgroups).  The gathers and the products still overlap only
// in part.

constexpr int GEMM_THREADS = 256;  // two warpgroups, no producer
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;             // one 128-byte swizzle row of bf16
constexpr int STAGES = 3;
constexpr int TILE_BYTES = 128 * 128;            // 128 rows x 128 bytes
constexpr int STAGE_BYTES = 2 * TILE_BYTES;      // A, then B
constexpr int SLAB_BYTES = 64 * 128;             // an MN-major 64-column slab
constexpr size_t GEMM_SMEM = 1024 + (size_t)STAGES * STAGE_BYTES;

// byte offset of 16-byte chunk j of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * 128 + ((j ^ (r & 7)) << 4));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The K steps [k0, k1) of one tile: `load(stage_base, k)` issues this
// thread's cp.async copies of step k's A and B into a stage; MN selects
// the MN-major descriptors (wgrad) over the K-major ones (dgrad).
template <bool MN, typename Load>
__device__ __forceinline__ void gemm_mainloop(float (&acc)[64], unsigned char* smem, int k0,
                                              int k1, int wg, Load load) {
  const int steps = k1 - k0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(smem + s * STAGE_BYTES, k0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step i landed
    fence_proxy_async();          // ... and are visible to wgmma (async proxy)
    __syncthreads();              // everyone's; and step i - 1's products are done
    const int next = i + STAGES - 1;
    if (next < steps) load(smem + (next % STAGES) * STAGE_BYTES, k0 + next);
    cp_async_commit();
    const unsigned char* a = smem + (i % STAGES) * STAGE_BYTES;
    const unsigned char* b = a + TILE_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (MN) {  // K rows of 128 bytes: a K step of 16 is 16 rows
        wgmma_m64n128k16_ss<1, 1>(acc, desc_sw128(a + wg * SLAB_BYTES + kk * 2048, SLAB_BYTES, 1024),
                                  desc_sw128(b + kk * 2048, SLAB_BYTES, 1024), 1);
      } else {   // M or N rows of 128 bytes: a K step of 16 is 32 bytes
        wgmma_m64n128k16_ss<0, 0>(acc, desc_sw128(a + wg * (TILE_BYTES / 2) + kk * 32, 16, 1024),
                                  desc_sw128(b + kk * 32, 16, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~(uintptr_t)1023);
}

// ---------------------------------------------------------------------------
// 2. dgrad: da[p][ci] = sum_{tap, co} dy[p + (1 - kh, 1 - kw)][co] * W[kh][kw][ci][co]
// ---------------------------------------------------------------------------
// M = rows, N = cin, K = 9 c, tap-major: step kt is tap kt / (c / 64) and
// 64 channels of c, so B's rows are wt[ci][kt * 64 ...].  Both operands are
// K-major (c contiguous).  grid (ceil(rows / 128), cin / 128).
__global__ void __launch_bounds__(GEMM_THREADS, 2)
cbr_dgrad(const bf16* __restrict__ dy, const bf16* __restrict__ wt, bf16* __restrict__ da, int n,
          int hh, int ww, int cin, int c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int rows = n * hh * ww;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, wg = tid / 128;

  // this thread's chunk j of tile rows r, r + 32, r + 64, r + 96: their
  // pixels (-1 past the last row) and (y << 16 | x)
  const int j = tid & 7, r0 = tid >> 3;
  int pix[4], yx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + r0 + 32 * i;
    const Pixel px = decode(p < rows ? p : 0, hh, ww);
    pix[i] = p < rows ? p : -1;
    yx[i] = px.y << 16 | px.x;
  }
  const int kc = c / BK;
  auto load = [&](unsigned char* st, int kt) {
    const int tap = kt / kc, co = (kt - tap * kc) * BK + j * 8;
    const int dh = 1 - tap / 3, dw = 1 - tap % 3;
    const uint32_t sa = smem_addr(st), sb = sa + TILE_BYTES;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 32 * i;
      const int y = (yx[i] >> 16) + dh, x = (yx[i] & 0xffff) + dw;
      const bool ok = pix[i] >= 0 && y >= 0 && y < hh && x >= 0 && x < ww;
      const bf16* src = ok ? dy + (size_t)(pix[i] + dh * ww + dw) * c + co : dy;
      cp_async16(sa + swz(r, j), src, ok);
      cp_async16(sb + swz(r, j), wt + (size_t)(n0 + r) * (9 * c) + kt * BK + j * 8, true);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  gemm_mainloop<false>(acc, smem, 0, 9 * kc, wg, load);

  // fragment: acc[4q + e] is row 16 warp + lane / 4 + 8 (e / 2), column
  // 8q + 2 (lane % 4) + e % 2 of the warpgroup's 64 x 128
  const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * half;
    if (m >= rows) continue;
    bf16* row = da + (size_t)m * cin + n0 + 2 * (lane % 4);
#pragma unroll
    for (int q = 0; q < 16; ++q)
      *reinterpret_cast<uint32_t*>(row + 8 * q) =
          pack_f32(acc[4 * q + 2 * half], acc[4 * q + 2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// 3. wgrad: part[z][tap][ci][co] = sum_{p in split z} a[p + (kh - 1, kw - 1)][ci] * dy[p][co]
// ---------------------------------------------------------------------------
// M = (tap, cin), N = c, K = rows, split-K: both operands are MN-major (cin
// and c contiguous), staged as two 64-column slabs of 64 K rows each.  grid
// (9 * cin / 128, c / 128, splits); split z takes row steps [z *
// steps_per_split, (z + 1) * steps_per_split) of 64 rows and writes its
// whole tile, zeros when its range is empty.
__global__ void __launch_bounds__(GEMM_THREADS, 2)
cbr_wgrad(const bf16* __restrict__ a, const bf16* __restrict__ dy, float* __restrict__ part_w,
          int n, int hh, int ww, int cin, int c, int steps_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int rows = n * hh * ww;
  const int cin_blocks = cin / BM;
  const int tap = blockIdx.x / cin_blocks, ci0 = (blockIdx.x % cin_blocks) * BM;
  const int co0 = blockIdx.y * BN;
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;
  const int total = (rows + BK - 1) / BK;
  const int s0 = min(total, (int)blockIdx.z * steps_per_split);
  const int s1 = min(total, s0 + steps_per_split);
  const int tid = threadIdx.x, wg = tid / 128;

  // this thread's chunk j of slab q in K rows r, r + 16, r + 32, r + 48:
  // their pixels' (y, x), decoded once and walked 64 pixels a step (the
  // loads take the steps in order)
  const int q = (tid >> 3) & 1, j = tid & 7, r0 = tid >> 4;
  const int step_y = BK / ww, step_x = BK % ww;
  int py[4], px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Pixel pix = decode(s0 * BK + r0 + 16 * i, hh, ww);
    py[i] = pix.y;
    px[i] = pix.x;
  }
  auto load = [&](unsigned char* st, int step) {
    const uint32_t sa = smem_addr(st), sb = sa + TILE_BYTES;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * i;
      const int p = step * BK + r;
      const bool okp = p < rows;
      const int y = py[i] + dh, x = px[i] + dw;
      const bool oka = okp && y >= 0 && y < hh && x >= 0 && x < ww;
      const uint32_t off = q * SLAB_BYTES + swz(r, j);
      cp_async16(sa + off, oka ? a + (size_t)(p + dh * ww + dw) * cin + ci0 + q * 64 + j * 8 : a,
                 oka);
      cp_async16(sb + off, okp ? dy + (size_t)p * c + co0 + q * 64 + j * 8 : dy, okp);
      px[i] += step_x;
      py[i] += step_y;
      if (px[i] >= ww) px[i] -= ww, ++py[i];
      while (py[i] >= hh) py[i] -= hh;
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  gemm_mainloop<true>(acc, smem, s0, s1, wg, load);

  float* out = part_w + (size_t)blockIdx.z * 9 * cin * c + (size_t)tap * cin * c;
  const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ci = ci0 + wg * 64 + warp * 16 + lane / 4 + 8 * half;
    float* row = out + (size_t)ci * c + co0 + 2 * (lane % 4);
#pragma unroll
    for (int qq = 0; qq < 16; ++qq)
      *reinterpret_cast<float2*>(row + 8 * qq) =
          make_float2(acc[4 * qq + 2 * half], acc[4 * qq + 2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// 4. fixed-order sums of the partials
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
cbr_finalize(const float* __restrict__ part_w, const float* __restrict__ part_bn,
             float* __restrict__ dw, float* __restrict__ dgamma, float* __restrict__ dbeta,
             int nw4, int splits, int c, int blocks) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const float4* pw = reinterpret_cast<const float4*>(part_w);
  for (int i = first; i < nw4; i += stride) {
    float4 s = pw[i];
    for (int z = 1; z < splits; ++z) {
      const float4 v = pw[(size_t)z * nw4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(dw)[i] = s;
  }
  // one warp per (quantity, channel): lane l sums partials l, l + 32, ...,
  // then a fixed butterfly, so the order is the same on every run
  const int lane = threadIdx.x & 31;
  for (int i = first >> 5; i < 2 * c; i += stride >> 5) {
    const int q = i / c, ch = i - q * c;
    float s = 0.f;
    for (int k = lane; k < blocks; k += 32) s += part_bn[((size_t)q * blocks + k) * c + ch];
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffff, s, off);
    if (lane == 0) (q == 0 ? dgamma : dbeta)[ch] = s;
  }
}

// the GEMMs' shared memory, and the carveout that fits two blocks an SM
int gemm_attributes(const void* fn) {
  int rc = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)GEMM_SMEM);
  if (rc) return rc;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Returns 0, the first CUDA error of the four launches, or -1 when cin or c
// is not a multiple of 128 (or c > 2048) or the split or prologue counts
// are below 1.  The prologue's blocks take prologue_rows rows each, so there
// are blocks = ceil(rows / prologue_rows) of them.  dy (rows, c) bf16,
// part_bn (2, blocks, c) fp32 and part_w (splits, 9 * cin * c) fp32 are the
// caller's scratch.
extern "C" int hvd_cbr_bwd(const void* db, const void* b, const void* a, const void* wt,
                           const void* gamma, const void* beta, const void* seff, void* dy,
                           void* part_bn, void* part_w, void* da, void* dw, void* dgamma,
                           void* dbeta, int n, int h, int w, int cin, int c, int splits,
                           int prologue_rows, void* stream) {
  if (cin % 128 || c % 128 || c > 2048 || splits < 1 || prologue_rows < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = n * h * w;
  const int blocks = (rows + prologue_rows - 1) / prologue_rows;
  int rc;

  cbr_prologue<<<blocks, THREADS, 0, s>>>((const bf16*)db, (const bf16*)b, (const float*)gamma,
                                          (const float*)beta, (const float*)seff, (bf16*)dy,
                                          (float*)part_bn, rows, c, prologue_rows);
  if ((rc = (int)cudaGetLastError())) return rc;

  if ((rc = gemm_attributes((const void*)cbr_dgrad)) ||
      (rc = gemm_attributes((const void*)cbr_wgrad)))
    return rc;
  cbr_dgrad<<<dim3((rows + BM - 1) / BM, cin / BN), GEMM_THREADS, GEMM_SMEM, s>>>(
      (const bf16*)dy, (const bf16*)wt, (bf16*)da, n, h, w, cin, c);
  if ((rc = (int)cudaGetLastError())) return rc;

  const int steps = (rows + BK - 1) / BK;
  const int per_split = (steps + splits - 1) / splits;
  cbr_wgrad<<<dim3(9 * cin / BM, c / BN, splits), GEMM_THREADS, GEMM_SMEM, s>>>(
      (const bf16*)a, (const bf16*)dy, (float*)part_w, n, h, w, cin, c, per_split);
  if ((rc = (int)cudaGetLastError())) return rc;

  const int nw4 = 9 * cin * c / 4;
  const int fin_blocks = min((nw4 + THREADS - 1) / THREADS, 1024);
  cbr_finalize<<<fin_blocks, THREADS, 0, s>>>((const float*)part_w, (const float*)part_bn,
                                              (float*)dw, (float*)dgamma, (float*)dbeta, nw4,
                                              splits, c, blocks);
  return (int)cudaGetLastError();
}
