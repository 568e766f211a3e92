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
// multiples of 128.
//
// Bound: at the model's shapes (batch 128, 28x28x128 and 14x14x256) the two
// implicit GEMMs are 2 x 29.6 GFLOP on about 104 MB (56 MB), so the kernel is
// bound by operations (0.060 ms at 989 TFLOP/s) and not by bytes (0.031 ms).
// Design (simple first): four launches in one call.
//   1. prologue: relu mask, dy, and per-block fp32 partials of dgamma/dbeta;
//   2. dgrad GEMM, M = rows, N = cin, K = 9*c: 128x128 tiles, K steps of 32
//      (one tap and 32 channels of c);
//   3. wgrad GEMM, M = 9*cin, N = c, K = rows, split-K over the rows so that
//      the few output tiles (9 at 128x128 channels) still fill 132 SMs; each
//      split writes its own fp32 partial;
//   4. a fixed-order sum of the partials into dW, dgamma and dbeta.
// Both GEMMs run 8 warps of 64x32 on mma.sync m16n8k16 bf16 with fp32
// accumulators, operands through ldmatrix (.trans for wgrad's k-major tiles)
// from a 3-stage cp.async ring.  The TPU kernel's sequential grid, which
// carried dW and the channel sums in VMEM from one batch tile to the next,
// does not carry over: Hopper blocks run in no order, hence the partials.
// Fusing the passes so that db, b and a cross HBM once, wgmma and TMA are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int PROLOGUE_ROWS = 256;  // CBR_PROLOGUE_ROWS in kernels.py
constexpr int LDS = BK + 8;         // dgrad tiles: [128][32 + 8], row-major in K
constexpr int LDT = BM + 8;         // wgrad tiles: [32][128 + 8], K-major

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
// flight; the block walks PROLOGUE_ROWS rows, then sums its threads' partials
// per channel in a fixed order.  part_bn is (2, gridDim.x, c): dgamma, dbeta.
__global__ void __launch_bounds__(THREADS)
cbr_prologue(const bf16* __restrict__ db, const bf16* __restrict__ b,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float* __restrict__ seff, bf16* __restrict__ dy, float* __restrict__ part_bn,
             int rows, int c) {
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
    const int r1 = min((blockIdx.x + 1) * PROLOGUE_ROWS, rows);
    for (int r = blockIdx.x * PROLOGUE_ROWS + grp; r < r1; r += groups) {
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
// the 128x128 block tile shared by both GEMMs: 8 warps of 64 (M) x 32 (N)
// ---------------------------------------------------------------------------
// acc[mi][ni]: rows wm*64 + mi*16 + {g, g+8}, columns wn*32 + ni*8 + 2*t4 + {0,1}
struct Acc {
  float v[4][4][4];
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
}

// One K step of 32 from tiles stored A row-major [m][k] (ld LDS) and B as [n][k]
// (ld LDS): ldmatrix without transpose.
__device__ __forceinline__ void mma_step_mk(Acc& acc, const bf16* sa, const bf16* sb, int wm,
                                            int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[4][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldsm_x4(af[mi], sa + (wm * 64 + mi * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
      ldsm_x4(r, sb + (wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk +
                     ((lane >> 3) & 1) * 8);
      bfr[2 * nj][0] = r[0];
      bfr[2 * nj][1] = r[1];
      bfr[2 * nj + 1][0] = r[2];
      bfr[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma16816(acc.v[mi][ni], af[mi], bfr[ni]);
  }
}

// One K step of 32 from tiles stored K-major: A as [k][m], B as [k][n] (ld LDT):
// ldmatrix with transpose.
__device__ __forceinline__ void mma_step_km(Acc& acc, const bf16* sa, const bf16* sb, int wm,
                                            int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[4][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldsm_x4_trans(af[mi], sa + (kk + (lane & 7) + ((lane >> 4) << 3)) * LDT + wm * 64 +
                                mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
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
      for (int ni = 0; ni < 4; ++ni) mma16816(acc.v[mi][ni], af[mi], bfr[ni]);
  }
}

// ---------------------------------------------------------------------------
// 2. dgrad: da[p][ci] = sum_{tap, co} dy[p + (1 - kh, 1 - kw)][co] * W[kh][kw][ci][co]
// ---------------------------------------------------------------------------
// grid (ceil(rows / 128), cin / 128).  K runs tap-major: step kt covers tap
// kt / (c / 32) and 32 channels of c, so B's rows are wt[ci][kt * 32 ...].
__global__ void __launch_bounds__(THREADS)
cbr_dgrad(const bf16* __restrict__ dy, const bf16* __restrict__ wt, bf16* __restrict__ da, int n,
          int hh, int ww, int cin, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][LDS]
  bf16* sB = sA + STAGES * BM * LDS;         // [STAGES][BN][LDS]
  const int rows = n * hh * ww;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  // this thread's two 16-byte chunks of each tile: rows tid/4 and tid/4 + 64
  const int col = (tid & 3) * 8;
  int lrow[2];
  Pixel px[2];
  bool live[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    lrow[j] = (tid >> 2) + j * 64;
    live[j] = m0 + lrow[j] < rows;
    px[j] = decode(live[j] ? m0 + lrow[j] : 0, hh, ww);
  }
  const int kc = c / BK, ksteps = 9 * kc;
  auto load = [&](int stage, int kt) {
    const int tap = kt / kc, co0 = (kt - tap * kc) * BK;
    const int dh = 1 - tap / 3, dw = 1 - tap % 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int y = px[j].y + dh, x = px[j].x + dw;
      const bool ok = live[j] && y >= 0 && y < hh && x >= 0 && x < ww;
      const bf16* src = ok ? dy + ((size_t)(px[j].img * hh + y) * ww + x) * c + co0 + col : dy;
      cp_async16(sA + (stage * BM + lrow[j]) * LDS + col, src, ok);
      cp_async16(sB + (stage * BN + lrow[j]) * LDS + col,
                 wt + (size_t)(n0 + lrow[j]) * (9 * c) + kt * BK + col, true);
    }
  };

  Acc acc;
  zero(acc);
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
    const int st = kt % STAGES;
    mma_step_mk(acc, sA + st * BM * LDS, sB + st * BN * LDS, wm, wn, lane);
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (m >= rows) continue;
      bf16* row = da + (size_t)m * cin + n0 + wn * 32 + t4 * 2;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<uint32_t*>(row + ni * 8) =
            pack_f32(acc.v[mi][ni][2 * half], acc.v[mi][ni][2 * half + 1]);
    }
}

// ---------------------------------------------------------------------------
// 3. wgrad: part[z][tap][ci][co] = sum_{p in split z} a[p + (kh - 1, kw - 1)][ci] * dy[p][co]
// ---------------------------------------------------------------------------
// grid (9 * cin / 128, c / 128, splits); split z takes row steps
// [z * steps_per_split, (z + 1) * steps_per_split) of 32 rows and writes its
// whole tile, zeros when its range is empty.
__global__ void __launch_bounds__(THREADS)
cbr_wgrad(const bf16* __restrict__ a, const bf16* __restrict__ dy, float* __restrict__ part_w,
          int n, int hh, int ww, int cin, int c, int steps_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [STAGES][BK][LDT]: a rows, cin columns
  bf16* sB = sA + STAGES * BK * LDT;         // [STAGES][BK][LDT]: dy rows, c columns
  const int rows = n * hh * ww;
  const int cin_blocks = cin / BM;
  const int tap = blockIdx.x / cin_blocks, ci0 = (blockIdx.x % cin_blocks) * BM;
  const int co0 = blockIdx.y * BN;
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;
  const int total = (rows + BK - 1) / BK;
  const int s0 = blockIdx.z * steps_per_split;
  const int s1 = min(total, s0 + steps_per_split);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  // this thread's two 16-byte chunks of each tile: rows tid/16 and tid/16 + 16
  const int col = (tid & 15) * 8;
  auto load = [&](int stage, int step) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = (tid >> 4) + j * 16;
      const int p = step * BK + r;
      const bool okp = p < rows;
      const Pixel px = decode(okp ? p : 0, hh, ww);
      const int y = px.y + dh, x = px.x + dw;
      const bool oka = okp && y >= 0 && y < hh && x >= 0 && x < ww;
      const bf16* src = oka ? a + ((size_t)(px.img * hh + y) * ww + x) * cin + ci0 + col : a;
      cp_async16(sA + (stage * BK + r) * LDT + col, src, oka);
      cp_async16(sB + (stage * BK + r) * LDT + col, okp ? dy + (size_t)p * c + co0 + col : dy,
                 okp);
    }
  };

  Acc acc;
  zero(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s0 + s < s1) load(s, s0 + s);
    cp_async_commit();
  }
  for (int step = s0; step < s1; ++step) {
    const int i = step - s0;
    cp_async_wait_stages();
    __syncthreads();
    const int next = step + STAGES - 1;
    if (next < s1) load((i + STAGES - 1) % STAGES, next);
    cp_async_commit();
    const int st = i % STAGES;
    mma_step_km(acc, sA + st * BK * LDT, sB + st * BK * LDT, wm, wn, lane);
  }

  float* out = part_w + (size_t)blockIdx.z * 9 * cin * c + (size_t)tap * cin * c;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + wm * 64 + mi * 16 + g + half * 8;
      float* row = out + (size_t)ci * c + co0 + wn * 32 + t4 * 2;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(row + ni * 8) =
            make_float2(acc.v[mi][ni][2 * half], acc.v[mi][ni][2 * half + 1]);
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

}  // namespace

// Returns 0, the first CUDA error of the four launches, or -1 when cin or c
// is not a multiple of 128.  dy (rows, c) bf16, part_bn (2, blocks, c) fp32
// and part_w (splits, 9 * cin * c) fp32 are the caller's scratch;
// blocks = ceil(rows / 256).
extern "C" int hvd_cbr_bwd(const void* db, const void* b, const void* a, const void* wt,
                           const void* gamma, const void* beta, const void* seff, void* dy,
                           void* part_bn, void* part_w, void* da, void* dw, void* dgamma,
                           void* dbeta, int n, int h, int w, int cin, int c, int splits,
                           int blocks, void* stream) {
  if (cin % 128 || c % 128 || c > 2048 || splits < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = n * h * w;
  if (blocks != (rows + PROLOGUE_ROWS - 1) / PROLOGUE_ROWS) return -1;
  int rc;

  cbr_prologue<<<blocks, THREADS, 0, s>>>((const bf16*)db, (const bf16*)b, (const float*)gamma,
                                          (const float*)beta, (const float*)seff, (bf16*)dy,
                                          (float*)part_bn, rows, c);
  if ((rc = (int)cudaGetLastError())) return rc;

  const size_t smem_d = (size_t)STAGES * (BM + BN) * LDS * sizeof(bf16);
  if ((rc = (int)cudaFuncSetAttribute(cbr_dgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem_d)))
    return rc;
  cbr_dgrad<<<dim3((rows + BM - 1) / BM, cin / BN), THREADS, smem_d, s>>>(
      (const bf16*)dy, (const bf16*)wt, (bf16*)da, n, h, w, cin, c);
  if ((rc = (int)cudaGetLastError())) return rc;

  const size_t smem_w = (size_t)STAGES * 2 * BK * LDT * sizeof(bf16);
  if ((rc = (int)cudaFuncSetAttribute(cbr_wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem_w)))
    return rc;
  const int steps = (rows + BK - 1) / BK;
  const int per_split = (steps + splits - 1) / splits;
  cbr_wgrad<<<dim3(9 * cin / BM, c / BN, splits), THREADS, smem_w, s>>>(
      (const bf16*)a, (const bf16*)dy, (float*)part_w, n, h, w, cin, c, per_split);
  if ((rc = (int)cudaGetLastError())) return rc;

  const int nw4 = 9 * cin * c / 4;
  const int fin_blocks = min((nw4 + THREADS - 1) / THREADS, 1024);
  cbr_finalize<<<fin_blocks, THREADS, 0, s>>>((const float*)part_w, (const float*)part_bn,
                                              (float*)dw, (float*)dgamma, (float*)dbeta, nw4,
                                              splits, c, blocks);
  return (int)cudaGetLastError();
}
