// Flash attention for Hopper: forward, dQ and dK/dV, in FlashAttention-2's
// split, deterministic (no atomics).
//
// Replaces, in horovod_tpu/ops/pallas_kernels.py:
//   hvd_flash_fwd     <- _flash_fwd / _flash_fwd_kernel
//   hvd_flash_bwd_dq  <- _flash_bwd / _flash_bwd_dq_kernel
//   hvd_flash_bwd_dkv <- _flash_bwd / _flash_bwd_dkv_kernel
// with the same arithmetic: scores in fp32 from bf16 products, the finite
// sentinel NEG_INF = -0.7 * FLT_MAX for masked scores, masked probabilities
// forced to 0, l clamped at 1e-30, and the per-row fp32 logsumexp
// lse = m + log(l) as the forward's residual.  The causal limits are the
// Pallas kernels' own: the forward and dQ stop at the block that holds the
// diagonal (ceil-divide), dK/dV starts at the first Q block that reaches it.
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous (b, t, h, d) bf16, the
// JAX package's layout, read in place (row stride h*d) with no transpose.
// lse and delta are (b*h, t) fp32.  Rows and keys at or past t are masked, so
// any t works; the caller keeps fit_flash_block's dispatch rule.
//
// Global positions (the sp ring's variant, the Pallas kernels' positions=True
// branch): with qpos/kpos, (t,) int32 device vectors, the causal mask is
// qpos[row] >= kpos[col].  A ring shard's positions need not be contiguous
// (zigzag), so dQ and dK/dV skip no tile and the forward skips a tile only
// by the ranges of the positions it holds.  The variant is the template
// flag POS, so the kernels without positions keep their code.  The forward
// and dQ stage each K tile's kpos in shared memory beside K and V; dK/dV
// keeps its keys' kpos in registers and stages each Q tile's qpos beside lse
// and delta.  A row that sees no key (a fully masked visiting block) keeps
// m at the sentinel and l at 0, so O = 0, lse = NEG_INF + log(1e-30) (which
// is NEG_INF in fp32) and its dQ/dK/dV contributions are 0, as in Pallas.
//
// Bound: at the model's shapes (b6 h16 t1024 d128, causal) the forward does
// 25.8 GFLOP on 101 MB: 0.0302 ms to move its bytes at 3.35 TB/s, 0.0261 ms
// for its products at 989 TFLOP/s, so it sits at the ridge and is held to
// its bytes; the backward does 3.5x the products on about the same bytes,
// so it is bound by operations.
//
// Forward design (FlashAttention-3's shape, sm90.cuh's helpers).  A block of
// three warpgroups owns 128 query rows of one (b, h).  The producer
// warpgroup gives its registers to the consumers (setmaxnreg 24 / 240); one
// of its threads loads Q once by TMA, then K and V tiles of 128 keys
// through a 2-stage ring of full/empty mbarriers (160 KB of shared memory
// at d128), so the next tile lands while this one is computed.  The tensor
// maps are 4-D, {d, h, t, b} over the (b, t, h, d) tensors with their real
// strides, so each (b, h) slab is read in place in 64-column boxes with the
// 128-byte swizzle, and rows past t read zeros (still masked: a zero key
// scores 0, not -inf).  Each consumer warpgroup owns 64 rows: S = Q K^T by
// wgmma from shared memory (both operands K-major), the online softmax in
// fp32 on the accumulator fragments, then O += P V by wgmma with P
// converted in registers to bf16 A fragments and V read as an MN-major B;
// the two warpgroups' softmax and products overlap each other.  The mask
// is evaluated only on a tile where a key can be hidden from a row: the
// causal diagonal, the tile past t and, with positions, whatever the
// ranges of the rows' and the tile's positions do not rule out.  A tile
// hidden from every row of a warpgroup is skipped (it would be an exact
// no-op), from every row of the block not even loaded: without positions
// that is the Pallas kernels' ceil-divide limit, with positions it is read
// from per-tile ranges of kpos that the block summarises first.  The
// heaviest causal Q blocks launch first.  With positions the producer warp
// stages each tile's kpos in shared memory beside K and V; qpos is held in
// registers.
//
// dQ and dK/dV (simple first): one block of 4 warps per (b*h, 64-row tile);
// each warp owns 16 rows.  Tiles of 64 rows stream through shared memory
// (rows padded by 8 bf16 against bank conflicts); products run on the
// tensor cores through mma.sync m16n8k16 bf16 with fp32 accumulators in
// registers.  The dK/dV kernel walks each 64-row Q tile in two 32-column
// halves to keep its two D-wide accumulators in registers.  No TMA, wgmma
// or software pipelining yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

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

// A fragment of the 16x16 block at p (row-major, leading dimension ld)
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* p, int ld, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  a[0] = ld_u32(p + g * ld + t4 * 2);
  a[1] = ld_u32(p + (g + 8) * ld + t4 * 2);
  a[2] = ld_u32(p + g * ld + t4 * 2 + 8);
  a[3] = ld_u32(p + (g + 8) * ld + t4 * 2 + 8);
}

// B fragment with B[k][n] = M[n][k]: M row-major, 8 rows (n) x 16 columns (k)
__device__ __forceinline__ void load_b_nk(uint32_t b[2], const bf16* p, int ld, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  b[0] = ld_u32(p + g * ld + t4 * 2);
  b[1] = ld_u32(p + g * ld + t4 * 2 + 8);
}

// B fragment with B[k][n] = M[k][n]: M row-major, 16 rows (k) x 8 columns (n)
__device__ __forceinline__ void load_b_kn(uint32_t b[2], const bf16* p, int ld, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  b[0] = pack_bf16(p[(t4 * 2) * ld + g], p[(t4 * 2 + 1) * ld + g]);
  b[1] = pack_bf16(p[(t4 * 2 + 8) * ld + g], p[(t4 * 2 + 9) * ld + g]);
}

// A fragment (16x16) from two 16x8 fp32 accumulator tiles, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// ROWS x D tile of rows [row0, row0 + ROWS) from a (t, row stride rs) matrix
// into shared memory with leading dimension D + 8; rows >= t become zeros.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, size_t rs, int row0, int t,
                                          int tid) {
  constexpr int LD = D + 8;
  constexpr int CHUNKS = D / 8;
  for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < t) val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

// Whether key col is visible to query row: both inside t and, under the
// causal mask, row >= col (local indices) or qp >= kp (global positions).
template <bool POS>
__device__ __forceinline__ bool visible(int row, int col, int t, int causal, int qp, int kp) {
  if (row >= t || col >= t) return false;
  return !causal || (POS ? qp >= kp : row >= col);
}

// kpos of the BK keys from k0 into shared memory (0 past t: masked anyway)
__device__ __forceinline__ void load_pos(int* s, const int* pos, int k0, int t, int tid) {
  if (tid < BK) s[tid] = k0 + tid < t ? pos[k0 + tid] : 0;
}

// Number of K blocks a Q tile reads: all of them, or under the causal mask
// without positions up to the block holding the tile's last diagonal entry.
template <bool POS>
__device__ __forceinline__ int live_k_blocks(int q0, int t, int causal) {
  int n = (t + BK - 1) / BK;
  if (causal && !POS) n = min(n, max((q0 + BQ + BK - 1) / BK, 1));
  return n;
}

// ---------------------------------------------------------------------------
// Forward: TMA + wgmma (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int FQ = 128;         // query rows of a block: two consumer warpgroups of 64
constexpr int FK = 128;         // keys of a K/V tile
constexpr int KV_STAGES = 2;
constexpr int FWD_THREADS = 384;  // warpgroups 0-1 consume, 2 produces
constexpr int SLAB = FK * 128;    // one 64-column slab of a 128-row tile: 16 KB
constexpr float LOG2E = 1.4426950408889634f;

template <int D, bool POS>
struct FwdSmem {
  static constexpr int TILE = FK * D * 2;  // Q, K or V: D / 64 slabs
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = TILE;
  static constexpr int V_OFF = K_OFF + KV_STAGES * TILE;
  static constexpr int POS_OFF = V_OFF + KV_STAGES * TILE;  // kpos of each stage's keys
  static constexpr int BAR_OFF = POS_OFF + (POS ? KV_STAGES * FK * 4 : 0);
  // qbar, full[KV_STAGES], empty[KV_STAGES]
  static constexpr int RANGE_OFF = BAR_OFF + (1 + 2 * KV_STAGES) * 8;
  // POS: the two warpgroups' least and greatest query positions, then the
  // least and the greatest key position of every K tile
  static constexpr int TILES_OFF = RANGE_OFF + 4 * 4;
  // 1024 bytes of slack to align the base
  static size_t bytes(int t) {
    return 1024 + (POS ? TILES_OFF + 2 * ((t + FK - 1) / FK) * 4 : RANGE_OFF);
  }
};

// S (64 x 128) of this warpgroup's rows against one K tile: both operands
// K-major, D / 16 steps; a step of 16 within a slab moves 32 bytes.
template <int D>
__device__ __forceinline__ void mma_scores(float (&sc)[64], const unsigned char* q_rows,
                                             const unsigned char* k_tile) {
  sm90::fence_regs(sc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * SLAB + (kk % 4) * 32;
    sm90::wgmma_m64n128k16_ss<0, 0>(sc, sm90::desc_sw128(q_rows + off, 16, 1024),
                                    sm90::desc_sw128(k_tile + off, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
}

// O (64 x D) += P (64 x 128 keys, bf16 registers) * V (128 keys x D): V is
// an MN-major B (D contiguous), its 64-column slabs SLAB apart; a step of
// 16 keys moves 16 rows, 2048 bytes.
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&pa)[8][4],
                                         const unsigned char* v_tile) {
  sm90::fence_regs(o);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < FK / 16; ++kk) {
    const uint64_t dv = sm90::desc_sw128(v_tile + kk * 2048, SLAB, 1024);
    if constexpr (D == 128)
      sm90::wgmma_m64n128k16_rs<1>(o, pa[kk], dv, 1);
    else
      sm90::wgmma_m64n64k16_rs<1>(o, pa[kk], dv, 1);
  }
  sm90::wgmma_commit();
}

// grid (b * h, ceil(t / 128)), the heaviest causal Q blocks first
template <int D, bool POS>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, int t, int h, float scale, int causal) {
  using L = FwdSmem<D, POS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* sQ = smem + L::Q_OFF;
  unsigned char* sK = smem + L::K_OFF;
  unsigned char* sV = smem + L::V_OFF;
  int* sKp = reinterpret_cast<int*>(smem + L::POS_OFF);  // POS only: [KV_STAGES][FK]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + KV_STAGES;
  int* qrange = reinterpret_cast<int*>(smem + L::RANGE_OFF);  // POS only
  int* kmin = reinterpret_cast<int*>(smem + L::TILES_OFF);    // POS only: [nt]
  const int nt = (t + FK - 1) / FK;
  int* kmax = kmin + nt;

  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FQ;
  // K tiles: through the diagonal tile under the causal mask without
  // positions (the Pallas kernels' ceil-divide limit), else all of them
  const int nk = causal && !POS ? min(nt, q0 / FK + 1) : nt;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      // POS: the whole producer warp arrives, after staging kpos
      sm90::mbar_init(&full[s], POS ? 32 : 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::fence_mbar_init();
  }
  if (POS) {
    for (int i = threadIdx.x; i < nt; i += FWD_THREADS) kmin[i] = INT_MAX, kmax[i] = INT_MIN;
    if (threadIdx.x < 4) qrange[threadIdx.x] = threadIdx.x & 1 ? INT_MIN : INT_MAX;
  }
  __syncthreads();
  if (POS) {
    // Which tiles a row can see depends on the positions: summarise them
    // once, the key positions per tile, the query positions per warpgroup.
    for (int base = warp * 32; base < t; base += FWD_THREADS) {
      const int i = base + lane;
      const int lo = __reduce_min_sync(~0u, i < t ? kpos[i] : INT_MAX);
      const int hi = __reduce_max_sync(~0u, i < t ? kpos[i] : INT_MIN);
      if (lane == 0) atomicMin(&kmin[base / FK], lo), atomicMax(&kmax[base / FK], hi);
    }
    if (warp < 4) {
      const int row = q0 + threadIdx.x;
      const int lo = __reduce_min_sync(~0u, row < t ? qpos[row] : INT_MAX);
      const int hi = __reduce_max_sync(~0u, row < t ? qpos[row] : INT_MIN);
      if (lane == 0) atomicMin(&qrange[warp / 2 * 2], lo), atomicMax(&qrange[warp / 2 * 2 + 1], hi);
    }
    __syncthreads();
  }
  // A K tile is loaded when some row of the block may see one of its keys.
  // A tile hidden from every row would be an exact no-op (correction 1,
  // p 0), so skipping it changes no bit of the result.
  auto next_live = [&](int kb) {
    if (POS && causal)
      while (kb < nk && max(qrange[1], qrange[3]) < kmin[kb]) ++kb;
    return kb;
  };

  if (wg == 2) {
    // producer: Q once, then K and V tiles through the ring
    sm90::reg_dealloc<24>();
    if (warp == 8) {
      if (lane == 0) {
        sm90::tma_prefetch(&map_q);
        sm90::tma_prefetch(&map_k);
        sm90::tma_prefetch(&map_v);
        sm90::mbar_arrive_expect_tx(qbar, L::TILE);
#pragma unroll
        for (int j = 0; j < D / 64; ++j)
          sm90::tma_load_4d(sQ + j * SLAB, &map_q, qbar, 64 * j, hh, q0, b);
      }
      int s = 0, phase = 0;
      for (int kb = next_live(0); kb < nk; kb = next_live(kb + 1)) {
        const int k0 = kb * FK;
        sm90::mbar_wait(&empty[s], phase ^ 1);
        if (POS) {
          for (int i = lane; i < FK; i += 32) sKp[s * FK + i] = k0 + i < t ? kpos[k0 + i] : 0;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
          for (int j = 0; j < D / 64; ++j) {
            sm90::tma_load_4d(sK + s * L::TILE + j * SLAB, &map_k, &full[s], 64 * j, hh, k0, b);
            sm90::tma_load_4d(sV + s * L::TILE + j * SLAB, &map_v, &full[s], 64 * j, hh, k0, b);
          }
        } else if (POS) {
          sm90::mbar_arrive(&full[s]);
        }
        if (++s == KV_STAGES) s = 0, phase ^= 1;
      }
    }
  } else {
    sm90::reg_alloc<240>();
    const int t4 = lane % 4;
    const int wg_row = q0 + wg * 64;                     // the warpgroup's first row
    const int row0 = wg_row + (warp % 4) * 16 + lane / 4;  // rows row0 and row0 + 8
    int qp[2] = {0, 0};
    if (POS) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i < t) qp[i] = qpos[row0 + 8 * i];
    }
    // The warpgroup's rows by position, qlo..qhi (none: qlo > qhi), and
    // each tile's keys, key_lo(kb)..key_hi(kb).
    const bool rows = wg_row < t;
    const int qlo = POS ? qrange[2 * wg] : rows ? wg_row : INT_MAX;
    const int qhi = POS ? qrange[2 * wg + 1] : rows ? min(wg_row + 63, t - 1) : INT_MIN;
    auto key_lo = [&](int kb) { return POS ? kmin[kb] : kb * FK; };
    auto key_hi = [&](int kb) { return POS ? kmax[kb] : min(kb * FK + FK, t) - 1; };
    // a tile the warpgroup computes: some row of it sees some key of it
    auto live = [&](int kb) { return qlo <= qhi && (!causal || qhi >= key_lo(kb)); };
    // a tile with no key hidden from any of the warpgroup's rows
    auto open = [&](int kb) { return kb * FK + FK <= t && (!causal || qlo >= key_hi(kb)); };
    const unsigned char* q_rows = sQ + wg * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float sc[64];
    uint32_t pa[8][4];

    sm90::mbar_wait(qbar, 0);
    int s = 0, phase = 0;
    for (int kb = next_live(0); kb < nk; kb = next_live(kb + 1)) {
      const int k0 = kb * FK;
      sm90::mbar_wait(&full[s], phase);
      if (live(kb)) {
        mma_scores<D>(sc, q_rows, sK + s * L::TILE);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        // Online softmax on the fragments, the Pallas kernel's arithmetic
        // in one order whether a tile is masked or not, so that both
        // variants agree bit for bit: x = s * scale, the sentinel where
        // masked, p = 2^((x - m) log2 e) (log2 e folded in for the exp2
        // unit), 0 where masked.  A masked x is the sentinel, so its p
        // underflows to exactly 0 once the row has seen a key; a row that
        // has not (m still the sentinel) has only masked entries, and its
        // p is forced to 0 by the row.
        const bool masked = !open(kb);
        float mx[2] = {NEG_INF, NEG_INF};
        if (masked) {
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            const int i = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1);
            const bool v = k0 + c < t &&
                           (!causal || (POS ? qp[i] >= sKp[s * FK + c] : row0 + 8 * i >= k0 + c));
            sc[e] = v ? sc[e] * scale : NEG_INF;
            mx[i] = fmaxf(mx[i], sc[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            sc[e] *= scale;
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
          }
        }
        float corr[2];
        bool seen[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], quad_max(mx[i]));
          corr[i] = m_new == m[i] ? 1.f : exp2f((m[i] - m_new) * LOG2E);
          m[i] = m_new;
          seen[i] = m_new != NEG_INF;
        }
        float ls[2] = {0.f, 0.f};
        if (masked) {
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            const int i = (e >> 1) & 1;
            sc[e] = seen[i] ? exp2f((sc[e] - m[i]) * LOG2E) : 0.f;
            ls[i] += sc[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            const int i = (e >> 1) & 1;
            sc[e] = exp2f((sc[e] - m[i]) * LOG2E);
            ls[i] += sc[e];
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(ls[i]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        // P to bf16 A fragments (rounded to v's type, as the Pallas kernel
        // feeds the MXU): keys 16kk.. are accumulator blocks 2kk, 2kk + 1
#pragma unroll
        for (int kk = 0; kk < FK / 16; ++kk) {
          pa[kk][0] = pack_f32(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        mma_pv<D>(acc, pa, sV + s * L::TILE);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < FK / 16; ++kk) sm90::fence_regs(pa[kk]);
      }
      // this warpgroup is done with the stage (a tile hidden from all its
      // rows is only waited for, so that neither warpgroup laps the ring)
      if (threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[s]);
      if (++s == KV_STAGES) s = 0, phase ^= 1;
    }

    const size_t rs = (size_t)h * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= t) continue;
      const float l_safe = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / l_safe;
      bf16* orow = o + ((size_t)b * t + row) * rs + (size_t)hh * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
            pack_f32(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      if (t4 == 0) lse[(size_t)bh * t + row] = m[i] + logf(l_safe);
    }
  }
}

template <int D, bool POS>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, int t, int h, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LD;
  bf16* sK = sdO + BQ * LD;
  bf16* sV = sK + BK * LD;
  int* sKp = reinterpret_cast<int*>(sV + BK * LD);  // POS only

  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t rs = (size_t)h * D;
  const size_t off = ((size_t)b * t * h + hh) * D;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float row_lse[2], row_delta[2];
  int qp[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_lse[i] = rows[i] < t ? lse[(size_t)bh * t + rows[i]] : 0.f;
    row_delta[i] = rows[i] < t ? delta[(size_t)bh * t + rows[i]] : 0.f;
    if (POS && rows[i] < t) qp[i] = qpos[rows[i]];
  }

  load_tile<BQ, D>(sQ, q + off, rs, q0, t, tid);
  load_tile<BQ, D>(sdO, dout + off, rs, q0, t, tid);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int num_k = live_k_blocks<POS>(q0, t, causal);
  for (int kb = 0; kb < num_k; ++kb) {
    __syncthreads();
    load_tile<BK, D>(sK, k + off, rs, kb * BK, t, tid);
    load_tile<BK, D>(sV, v + off, rs, kb * BK, t, tid);
    if (POS) load_pos(sKp, kpos, kb * BK, t, tid);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], ad[4];
      load_a(a, sQ + warp * 16 * LD + kk * 16, LD, lane);
      load_a(ad, sdO + warp * 16 * LD + kk * 16, LD, lane);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t bb[2];
        load_b_nk(bb, sK + j * 8 * LD + kk * 16, LD, lane);
        mma16816(s[j], a, bb);
        load_b_nk(bb, sV + j * 8 * LD + kk * 16, LD, lane);
        mma16816(dp[j], ad, bb);
      }
    }
    // dS = P o (dP - delta), P = exp(s - lse) rebuilt from the forward's lse
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = j * 8 + t4 * 2 + (e & 1), col = kb * BK + c;
        const bool ok = visible<POS>(rows[i], col, t, causal, qp[i], POS ? sKp[c] : 0);
        const float p = ok ? expf(s[j][e] * scale - row_lse[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_delta[i]);
      }
    // dQ += dS K
#pragma unroll
    for (int js = 0; js < BK / 16; ++js) {
      uint32_t a[4];
      acc_to_a(a, s[2 * js], s[2 * js + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb[2];
        load_b_kn(bb, sK + js * 16 * LD + n * 8, LD, lane);
        mma16816(acc[n], a, bb);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= t) continue;
    bf16* row = dq + off + (size_t)rows[i] * rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + t4 * 2) =
          pack_f32(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <int D, bool POS>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, int t, int h, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int HALF = BQ / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sdO = sQ + BQ * LD;
  float* sL = reinterpret_cast<float*>(sdO + BQ * LD);
  float* sD = sL + BQ;
  int* sQp = reinterpret_cast<int*>(sD + BQ);  // POS only

  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t rs = (size_t)h * D;
  const size_t off = ((size_t)b * t * h + hh) * D;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int kp[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (POS && keys[i] < t) kp[i] = kpos[keys[i]];

  load_tile<BK, D>(sK, k + off, rs, k0, t, tid);
  load_tile<BK, D>(sV, v + off, rs, k0, t, tid);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int num_q = (t + BQ - 1) / BQ;
  const int start = causal && !POS ? k0 / BQ : 0;
  for (int qb = start; qb < num_q; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();
    load_tile<BQ, D>(sQ, q + off, rs, q0, t, tid);
    load_tile<BQ, D>(sdO, dout + off, rs, q0, t, tid);
    if (tid < BQ) {
      const bool ok = q0 + tid < t;
      sL[tid] = ok ? lse[(size_t)bh * t + q0 + tid] : 0.f;
      sD[tid] = ok ? delta[(size_t)bh * t + q0 + tid] : 0.f;
      if (POS) sQp[tid] = ok ? qpos[q0 + tid] : 0;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 queries
      float p[HALF / 8][4], dp[HALF / 8][4];
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK + warp * 16 * LD + kk * 16, LD, lane);
        load_a(av, sV + warp * 16 * LD + kk * 16, LD, lane);
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
          uint32_t bb[2];
          load_b_nk(bb, sQ + (c * HALF + j * 8) * LD + kk * 16, LD, lane);
          mma16816(p[j], ak, bb);
          load_b_nk(bb, sdO + (c * HALF + j * 8) * LD + kk * 16, LD, lane);
          mma16816(dp[j], av, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = c * HALF + j * 8 + t4 * 2 + (e & 1);
          const bool ok =
              visible<POS>(q0 + ql, keys[e >> 1], t, causal, POS ? sQp[ql] : 0, kp[e >> 1]);
          const float pe = ok ? expf(p[j][e] * scale - sL[ql]) : 0.f;
          p[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - sD[ql]);
        }
      // dV += P^T dO and dK += dS^T Q over these 32 queries
#pragma unroll
      for (int js = 0; js < HALF / 16; ++js) {
        uint32_t ap[4], as[4];
        acc_to_a(ap, p[2 * js], p[2 * js + 1]);
        acc_to_a(as, dp[2 * js], dp[2 * js + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bb[2];
          load_b_kn(bb, sdO + (c * HALF + js * 16) * LD + n * 8, LD, lane);
          mma16816(acc_v[n], ap, bb);
          load_b_kn(bb, sQ + (c * HALF + js * 16) * LD + n * 8, LD, lane);
          mma16816(acc_k[n], as, bb);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= t) continue;
    bf16* krow = dk + off + (size_t)keys[i] * rs;
    bf16* vrow = dv + off + (size_t)keys[i] * rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8 + t4 * 2) =
          pack_f32(acc_k[n][2 * i] * scale, acc_k[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8 + t4 * 2) =
          pack_f32(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int D, bool POS>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* qpos,
        const void* kpos, int b, int t, int h, float scale, int causal, cudaStream_t s) {
  // (b, t, h, d) read in place as a 4-D tensor {d, h, t, b}: a box is one
  // (b, h) slab of 128 rows by 64 columns; rows past t read zeros
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)h, (uint64_t)t, (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)h * D * 2, (uint64_t)t * h * D * 2};
  const uint32_t box[4] = {64, 1, FK, 1};
  // the runtime call first: it makes the context current in this thread,
  // which the tensor-map encoder needs
  const size_t smem = FwdSmem<D, POS>::bytes(t);
  int rc = prepare(flash_fwd_kernel<D, POS>, smem);
  if (rc) return rc;
  CUtensorMap map_q, map_k, map_v;
  if (!sm90::encode_tensor_map(&map_q, q, 4, dims, strides, box) ||
      !sm90::encode_tensor_map(&map_k, k, 4, dims, strides, box) ||
      !sm90::encode_tensor_map(&map_v, v, 4, dims, strides, box))
    return -2;
  dim3 grid(b * h, (t + FQ - 1) / FQ);
  flash_fwd_kernel<D, POS><<<grid, FWD_THREADS, smem, s>>>(
      map_q, map_k, map_v, (bf16*)o, (float*)lse, (const int*)qpos, (const int*)kpos, t, h,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int D, bool POS>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, const void* qpos, const void* kpos, int b, int t, int h,
           float scale, int causal, cudaStream_t s) {
  const size_t smem =
      (size_t)(2 * BQ + 2 * BK) * (D + 8) * sizeof(bf16) + (POS ? BK * sizeof(int) : 0);
  int rc = prepare(flash_bwd_dq_kernel<D, POS>, smem);
  if (rc) return rc;
  dim3 grid(b * h, (t + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D, POS><<<grid, THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dq, (const int*)qpos, (const int*)kpos, t, h, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, bool POS>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, const void* qpos, const void* kpos, int b,
            int t, int h, float scale, int causal, cudaStream_t s) {
  const size_t smem = (size_t)(2 * BQ + 2 * BK) * (D + 8) * sizeof(bf16) +
                      2 * BQ * sizeof(float) + (POS ? BQ * sizeof(int) : 0);
  int rc = prepare(flash_bwd_dkv_kernel<D, POS>, smem);
  if (rc) return rc;
  dim3 grid(b * h, (t + BK - 1) / BK);
  flash_bwd_dkv_kernel<D, POS><<<grid, THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, (const int*)qpos, (const int*)kpos, t, h, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 on success), or
// -1 for a head_dim other than 64 or 128.  qpos and kpos are both null (local
// indices) or both (t,) int32 device vectors of global positions.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* qpos, const void* kpos, int b, int t, int h, int d,
                             float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pos = qpos != nullptr;
#define HVD_FWD(D, P) fwd<D, P>(q, k, v, o, lse, qpos, kpos, b, t, h, scale, causal, s)
  if (d == 64) return pos ? HVD_FWD(64, true) : HVD_FWD(64, false);
  if (d == 128) return pos ? HVD_FWD(128, true) : HVD_FWD(128, false);
#undef HVD_FWD
  return -1;
}

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, const void* qpos,
                                const void* kpos, int b, int t, int h, int d, float scale,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pos = qpos != nullptr;
#define HVD_DQ(D, P) \
  bwd_dq<D, P>(q, k, v, dout, lse, delta, dq, qpos, kpos, b, t, h, scale, causal, s)
  if (d == 64) return pos ? HVD_DQ(64, true) : HVD_DQ(64, false);
  if (d == 128) return pos ? HVD_DQ(128, true) : HVD_DQ(128, false);
#undef HVD_DQ
  return -1;
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 const void* qpos, const void* kpos, int b, int t, int h, int d,
                                 float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pos = qpos != nullptr;
#define HVD_DKV(D, P) \
  bwd_dkv<D, P>(q, k, v, dout, lse, delta, dk, dv, qpos, kpos, b, t, h, scale, causal, s)
  if (d == 64) return pos ? HVD_DKV(64, true) : HVD_DKV(64, false);
  if (d == 128) return pos ? HVD_DKV(128, true) : HVD_DKV(128, false);
#undef HVD_DKV
  return -1;
}
