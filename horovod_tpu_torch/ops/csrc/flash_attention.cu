// Flash attention for Hopper: forward, dQ and dK/dV, in FlashAttention-2's
// split, deterministic (no atomics).
//
// Replaces, in horovod_tpu/ops/pallas_kernels.py:
//   hvd_flash_fwd     <- _flash_fwd / _flash_fwd_kernel
//   hvd_flash_bwd_dq  <- _flash_bwd / _flash_bwd_dq_kernel (and its jnp
//                        delta = rowsum(dO o O) pass, folded in)
//   hvd_flash_bwd_dkv <- _flash_bwd / _flash_bwd_dkv_kernel
// with the same arithmetic: scores in fp32 from bf16 products, the finite
// sentinel NEG_INF = -0.7 * FLT_MAX for masked scores, masked probabilities
// forced to 0, l clamped at 1e-30, and the per-row fp32 logsumexp
// lse = m + log(l) as the forward's residual.  The causal limits are the
// Pallas kernels' own: the forward and dQ stop at the tile that holds the
// diagonal, dK/dV starts at the first Q tile that reaches it.
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous (b, t, h, d) bf16, the
// JAX package's layout, read in place (row stride h*d) with no transpose.
// lse and delta are (b*h, t) fp32.  Rows and keys at or past t are masked, so
// any t works, and flash_attention launches the kernels at any t on a card.
//
// Global positions (the sp ring's variant, the Pallas kernels' positions=True
// branch): with qpos/kpos, (t,) int32 device vectors, the causal mask is
// qpos[row] >= kpos[col].  A ring shard's positions need not be contiguous
// (zigzag), so each kernel skips a tile only by the ranges of the positions
// it holds, summarised per block first.  The variant is the template flag
// POS, so the kernels without positions keep their code.  The forward and
// dQ stage each K tile's kpos in shared memory beside K and V; dK/dV keeps
// its keys' kpos in registers and stages each Q tile's qpos beside its lse
// and delta.  A row that sees no key (a fully masked visiting block) keeps
// m at the sentinel and l at 0, so O = 0, lse = NEG_INF + log(1e-30) (which
// is NEG_INF in fp32) and its dQ/dK/dV contributions are 0, as in Pallas.
//
// Bound: at the model's shapes (b6 h16 t1024 d128, causal) the forward does
// 25.8 GFLOP on 101 MB: 0.0302 ms to move its bytes at 3.35 TB/s, 0.0261 ms
// for its products at 989 TFLOP/s, so it sits at the ridge and is held to
// its bytes; dQ does 1.5x and dK/dV 2x its products on about the same
// bytes, so they are bound by operations.
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
// Backward design: each kernel on its own side of the FlashAttention-2
// split, so no block ever adds into another's output.  A block is one
// warpgroup that owns 64 rows (dQ: queries, dK/dV: keys) of one (b, h), two
// blocks an SM, with no producer warpgroup: dK/dV's two D-wide
// accumulators take 128 fp32 registers a thread at d128, and ptxas gives
// the consumers of a warp-specialised 384-thread block only the 168
// registers of its launch bounds whatever setmaxnreg asks (the SASS of such
// a dK/dV showed no register above R191 and ~1.1 KB of spills, and a
// 32-query tile spilled too); a 128-thread block two an SM may use 255.
// The block's own rows load once by TMA; thread 0 issues the TMA loads of
// the next live tile of the other operand into the other of two stages
// while this one is computed, and the first 64 threads stage that tile's
// per-row values (dK/dV: its queries' lse, delta and qpos; dQ with
// positions: its kpos) from registers read under the same compute.  Tiles
// are 64 rows, the TMA boxes 64 rows by 64 columns of the forward's 4-D
// maps, and every product is one of the forward's two wgmma patterns: SS
// with both operands K-major (S = A B^T) or RS with the probabilities in
// registers as bf16 A fragments and an MN-major B.
//  * dQ: Q and dO load once, K and V tiles stream.  Per tile: S = Q K^T
//    and dP = dO V^T (SS), P = exp(S scale - lse) and dS = P o (dP -
//    delta) on the fragments, dQ += dS K (RS, K as B).  With O given,
//    each thread first sums a quarter of its rows' dO o O and the quad
//    adds them: delta is computed here in fp32 and written out for dK/dV,
//    which saves the separate rowsum pass.
//  * dK/dV: K and V load once, Q and dO tiles stream.  The products are
//    taken transposed, so the probabilities land in A fragments:
//    S^T = K Q^T and dP^T = V dO^T (SS), P^T and dS^T per column,
//    dV += P^T dO and dK += dS^T Q (RS, dO and Q as B).
// Tiles are skipped and masked as in the forward: a tile hidden from
// every row of the block is not loaded (without positions, dQ stops at the
// diagonal tile and dK/dV starts at it; with positions, by the ranges the
// block summarises), and the mask is evaluated only where a key can be
// hidden.  A skipped tile would add exact zeros and both variants visit
// the live tiles in one order, so the positions variant at arange equals
// the kernels without positions bit for bit.  The heaviest blocks launch
// first: the last Q blocks for dQ, the first key blocks for dK/dV.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
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

// ---------------------------------------------------------------------------
// Backward: TMA + wgmma (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int BR = 64;          // rows of a backward tile, a block and a TMA box
constexpr int BWD_THREADS = 128;  // one warpgroup, no producer
constexpr int BWD_STAGES = 2;    // two blocks an SM leave shared memory for no third
constexpr int BSLAB = BR * 128;  // one 64-column slab of a 64-row tile: 8 KB
static_assert(BWD_STAGES == 2, "the backward loops alternate two stages (s ^ 1)");

// acc (64 x 64) = A B^T over D: A the warpgroup's 64 rows, B a 64-row tile,
// both K-major (D contiguous) in D / 64 slabs BSLAB apart; a step of 16
// within a slab moves 32 bytes.  mma_scores' pattern.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[32], const unsigned char* a,
                                        const unsigned char* b) {
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * BSLAB + (kk % 4) * 32;
    sm90::wgmma_m64n64k16_ss<0, 0>(acc, sm90::desc_sw128(a + off, 16, 1024),
                                   sm90::desc_sw128(b + off, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
}

// acc (64 x D) += A (64 x 64, bf16 registers) B (a 64-row tile, 64 x D): B
// is MN-major (D contiguous), its slabs BSLAB apart; a step of 16 rows
// moves 2048 bytes.  mma_pv's pattern.
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                       const unsigned char* b) {
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk) {
    const uint64_t db = sm90::desc_sw128(b + kk * 2048, BSLAB, 1024);
    if constexpr (D == 128)
      sm90::wgmma_m64n128k16_rs<1>(acc, a[kk], db, 1);
    else
      sm90::wgmma_m64n64k16_rs<1>(acc, a[kk], db, 1);
  }
  sm90::wgmma_commit();
}

// A 64 x 64 fp32 accumulator fragment rounded to the bf16 A fragments of
// its four 16-column steps (columns 16kk.. are accumulator blocks 2kk, 2kk + 1)
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_f32(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_f32(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_f32(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_f32(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// The least and the greatest of pos[i] over each 64-entry tile of [0, t)
// into lo[] and hi[] (set to INT_MAX and INT_MIN before): each warp takes
// 32 entries a round and issues eight rounds' loads before their
// reductions, so the block waits for memory t / 1024 times, not t / 128.
__device__ __forceinline__ void tile_ranges(const int* __restrict__ pos, int t, int* lo, int* hi,
                                            int warp, int lane) {
  constexpr int ROUNDS = 8;
  for (int base = warp * 32; base < t; base += ROUNDS * BWD_THREADS) {
    int v[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = base + r * BWD_THREADS + lane;
      v[r] = i < t ? pos[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i0 = base + r * BWD_THREADS, i = i0 + lane;
      if (i0 >= t) break;
      const int mn = __reduce_min_sync(~0u, i < t ? v[r] : INT_MAX);
      const int mx = __reduce_max_sync(~0u, i < t ? v[r] : INT_MIN);
      if (lane == 0) atomicMin(&lo[i0 / BR], mn), atomicMax(&hi[i0 / BR], mx);
    }
  }
}

template <int D, bool POS>
struct DqSmem {
  static constexpr int TILE = BR * D * 2;  // Q, dO, or a stage's K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = TILE;
  static constexpr int K_OFF = 2 * TILE;  // K and V tiles through the ring
  static constexpr int V_OFF = K_OFF + BWD_STAGES * TILE;
  static constexpr int POS_OFF = V_OFF + BWD_STAGES * TILE;  // kpos of each stage's keys
  static constexpr int BAR_OFF = POS_OFF + (POS ? BWD_STAGES * BR * 4 : 0);
  // qbar, full[BWD_STAGES]
  static constexpr int RANGE_OFF = BAR_OFF + (1 + BWD_STAGES) * 8;
  // POS: the block's least and greatest query position, then the least
  // and the greatest key position of every K tile
  static constexpr int TILES_OFF = RANGE_OFF + 2 * 4;
  static size_t bytes(int t) {
    return 1024 + (POS ? TILES_OFF + 2 * ((t + BR - 1) / BR) * 4 : RANGE_OFF);
  }
};

// grid (b * h, ceil(t / 64)), two blocks an SM, the heaviest causal Q
// blocks first.  With o set, delta = rowsum(dO o O) is computed here and
// written out; else it is read.
template <int D, bool POS>
__global__ void __launch_bounds__(BWD_THREADS, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq,
                    const int* __restrict__ qpos, const int* __restrict__ kpos, int t, int h,
                    float scale, int causal) {
  using L = DqSmem<D, POS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* sQ = smem + L::Q_OFF;
  unsigned char* sdO = smem + L::DO_OFF;
  unsigned char* sK = smem + L::K_OFF;
  unsigned char* sV = smem + L::V_OFF;
  int* sKp = reinterpret_cast<int*>(smem + L::POS_OFF);  // POS only: [BWD_STAGES][BR]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = qbar + 1;
  int* qrange = reinterpret_cast<int*>(smem + L::RANGE_OFF);  // POS only
  int* kmin = reinterpret_cast<int*>(smem + L::TILES_OFF);    // POS only: [nt]
  const int nt = (t + BR - 1) / BR;
  int* kmax = kmin + nt;

  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t4 = lane % 4;

  if (tid == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < BWD_STAGES; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_mbar_init();
  }
  if (POS) {
    for (int i = tid; i < nt; i += BWD_THREADS) kmin[i] = INT_MAX, kmax[i] = INT_MIN;
    if (tid < 2) qrange[tid] = tid ? INT_MIN : INT_MAX;
  }
  __syncthreads();
  if (POS) {
    tile_ranges(kpos, t, kmin, kmax, warp, lane);
    if (warp < 2) {
      const int row = q0 + tid;
      const int lo = __reduce_min_sync(~0u, row < t ? qpos[row] : INT_MAX);
      const int hi = __reduce_max_sync(~0u, row < t ? qpos[row] : INT_MIN);
      if (lane == 0) atomicMin(&qrange[0], lo), atomicMax(&qrange[1], hi);
    }
    __syncthreads();
  }
  // The block's rows by position, qlo..qhi, and each tile's keys,
  // key_lo(kb)..key_hi(kb).  A K tile is loaded when some row may see one
  // of its keys; a tile hidden from every row would be an exact no-op (dS
  // 0).  Without positions under the causal mask that stops at the tile
  // that holds the block's last diagonal entry.
  const int qlo = POS ? qrange[0] : q0;
  const int qhi = POS ? qrange[1] : min(q0 + BR, t) - 1;
  const int nk = causal && !POS ? min(nt, qhi / BR + 1) : nt;
  auto key_lo = [&](int kb) { return POS ? kmin[kb] : kb * BR; };
  auto key_hi = [&](int kb) { return POS ? kmax[kb] : min(kb * BR + BR, t) - 1; };
  auto next_live = [&](int kb) {
    if (POS && causal)
      while (kb < nk && qhi < key_lo(kb)) ++kb;
    return kb;
  };
  // a tile where every row sees every key
  auto open = [&](int kb) {
    return kb * BR + BR <= t && q0 + BR <= t && (!causal || qlo >= key_hi(kb));
  };
  // K and V of tile kb into stage s by TMA (thread 0); with POS its keys'
  // positions from the first BR threads' registers
  auto load_tile = [&](int kb, int s) {
    sm90::mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      const int at = s * L::TILE + j * BSLAB;
      sm90::tma_load_4d(sK + at, &map_k, &full[s], 64 * j, hh, kb * BR, b);
      sm90::tma_load_4d(sV + at, &map_v, &full[s], 64 * j, hh, kb * BR, b);
    }
  };
  auto read_kpos = [&](int kb) {
    const int k = kb * BR + tid;
    return k < t ? kpos[k] : 0;
  };

  int kb = next_live(0);
  if (tid == 0) {
    sm90::tma_prefetch(&map_q);
    sm90::tma_prefetch(&map_do);
    sm90::tma_prefetch(&map_k);
    sm90::tma_prefetch(&map_v);
    sm90::mbar_arrive_expect_tx(qbar, 2 * L::TILE);
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      sm90::tma_load_4d(sQ + j * BSLAB, &map_q, qbar, 64 * j, hh, q0, b);
      sm90::tma_load_4d(sdO + j * BSLAB, &map_do, qbar, 64 * j, hh, q0, b);
    }
    if (kb < nk) load_tile(kb, 0);
  }
  if (POS && kb < nk && tid < BR) sKp[tid] = read_kpos(kb);

  const int row0 = q0 + warp * 16 + lane / 4;  // rows row0 and row0 + 8
  const float sl2 = scale * LOG2E;
  int qp[2] = {0, 0};
  float lse2[2], dl[2];  // per row: lse log2 e and delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const bool in = row < t;
    if (POS && in) qp[i] = qpos[row];
    lse2[i] = in ? lse[(size_t)bh * t + row] * LOG2E : 0.f;
    if (o != nullptr) {
      // delta = rowsum(dO o O) in fp32: each of the row's four threads
      // sums a quarter of the row, then the quad adds the quarters
      float part = 0.f;
      if (in) {
        const size_t at = (((size_t)b * t + row) * h + hh) * D + t4 * (D / 4);
#pragma unroll
        for (int c = 0; c < D / 4; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
          const uint4 gv = *reinterpret_cast<const uint4*>(dout + at + c);
          const bf16* op = reinterpret_cast<const bf16*>(&ov);
          const bf16* gp = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            part = fmaf(__bfloat162float(gp[e]), __bfloat162float(op[e]), part);
        }
      }
      dl[i] = quad_sum(part);
      if (in && t4 == 0) delta[(size_t)bh * t + row] = dl[i];
    } else {
      dl[i] = in ? delta[(size_t)bh * t + row] : 0.f;
    }
  }
  __syncthreads();  // the first tile's kpos

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[4][4];

  sm90::mbar_wait(qbar, 0);
  int s = 0;
  uint32_t phase = 0;  // bit s: the parity of stage s's next fill
  while (kb < nk) {
    // the next live tile loads into the other stage while this one is
    // computed (its last reader finished before the previous barrier)
    const int next = next_live(kb + 1);
    int kp_next = 0;
    if (next < nk) {
      if (tid == 0) load_tile(next, s ^ 1);
      if (POS && tid < BR) kp_next = read_kpos(next);
    }
    sm90::mbar_wait(&full[s], (phase >> s) & 1);
    phase ^= 1u << s;
    const int k0 = kb * BR;
    const unsigned char* k_tile = sK + s * L::TILE;
    mma_abt<D>(sc, sQ, k_tile);             // S = Q K^T
    mma_abt<D>(dp, sdO, sV + s * L::TILE);  // dP = dO V^T
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    // P = exp(S scale - lse), 2^x with log2 e folded in, 0 where masked;
    // dS = P o (dP - delta).  One expression whether a tile is masked or
    // not and in both variants, so they agree bit for bit.
    if (!open(kb)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1);
        const bool v = row0 + 8 * i < t && k0 + c < t &&
                       (!causal || (POS ? qp[i] >= sKp[s * BR + c] : row0 + 8 * i >= k0 + c));
        sc[e] = v ? exp2f(fmaf(sc[e], sl2, -lse2[i])) : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = exp2f(fmaf(sc[e], sl2, -lse2[(e >> 1) & 1]));
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = sc[e] * (dp[e] - dl[(e >> 1) & 1]);
    // dS to bf16 A fragments, as the Pallas kernel casts ds to K's type
    to_a(da, dp);
    mma_ab<D>(acc, da, k_tile);  // dQ += dS K
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(da[kk]);
    if (POS && next < nk && tid < BR) sKp[(s ^ 1) * BR + tid] = kp_next;
    __syncthreads();  // this stage is free for the tile after next
    kb = next;
    s ^= 1;
  }

  const size_t rs = (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= t) continue;
    bf16* qrow = dq + ((size_t)b * t + row) * rs + (size_t)hh * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(qrow + 8 * j + 2 * t4) =
          pack_f32(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

template <int D, bool POS>
struct DkvSmem {
  static constexpr int TILE = BR * D * 2;  // K, V, or a stage's Q or dO tile
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = TILE;
  static constexpr int Q_OFF = 2 * TILE;  // Q and dO tiles through the ring
  static constexpr int DO_OFF = Q_OFF + BWD_STAGES * TILE;
  // per stage and query: lse log2 e, delta and, with POS, qpos
  static constexpr int ROWS = POS ? 3 : 2;
  static constexpr int ROW_OFF = DO_OFF + BWD_STAGES * TILE;
  static constexpr int BAR_OFF = ROW_OFF + BWD_STAGES * ROWS * BR * 4;
  // kvbar, full[BWD_STAGES]
  static constexpr int RANGE_OFF = BAR_OFF + (1 + BWD_STAGES) * 8;
  // POS: the block's least and greatest key position, then the least and
  // the greatest query position of every Q tile
  static constexpr int TILES_OFF = RANGE_OFF + 2 * 4;
  static size_t bytes(int t) {
    return 1024 + (POS ? TILES_OFF + 2 * ((t + BR - 1) / BR) * 4 : RANGE_OFF);
  }
};

// grid (b * h, ceil(t / 64)), two blocks an SM: under the causal mask the
// first key blocks see the most queries, and they launch first
template <int D, bool POS>
__global__ void __launch_bounds__(BWD_THREADS, 2)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, int t, int h, float scale, int causal) {
  using L = DkvSmem<D, POS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* sK = smem + L::K_OFF;
  unsigned char* sV = smem + L::V_OFF;
  unsigned char* sQ = smem + L::Q_OFF;
  unsigned char* sdO = smem + L::DO_OFF;
  float* sRows = reinterpret_cast<float*>(smem + L::ROW_OFF);  // [BWD_STAGES][ROWS][BR]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kvbar + 1;
  int* krange = reinterpret_cast<int*>(smem + L::RANGE_OFF);  // POS only
  int* qmin = reinterpret_cast<int*>(smem + L::TILES_OFF);    // POS only: [nq]
  const int nq = (t + BR - 1) / BR;
  int* qmax = qmin + nq;

  const int bh = blockIdx.x, b = bh / h, hh = bh % h;
  const int k0 = blockIdx.y * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t4 = lane % 4;

  if (tid == 0) {
    sm90::mbar_init(kvbar, 1);
    for (int s = 0; s < BWD_STAGES; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_mbar_init();
  }
  if (POS) {
    for (int i = tid; i < nq; i += BWD_THREADS) qmin[i] = INT_MAX, qmax[i] = INT_MIN;
    if (tid < 2) krange[tid] = tid ? INT_MIN : INT_MAX;
  }
  __syncthreads();
  if (POS) {
    tile_ranges(qpos, t, qmin, qmax, warp, lane);
    if (warp < 2) {
      const int key = k0 + tid;
      const int lo = __reduce_min_sync(~0u, key < t ? kpos[key] : INT_MAX);
      const int hi = __reduce_max_sync(~0u, key < t ? kpos[key] : INT_MIN);
      if (lane == 0) atomicMin(&krange[0], lo), atomicMax(&krange[1], hi);
    }
    __syncthreads();
  }
  // The block's keys by position, klo..khi, and each tile's queries,
  // query_lo(qb)..query_hi(qb).  A Q tile is loaded when one of its
  // queries may see one of the keys; a tile hidden from every key would be
  // an exact no-op (P 0).  Without positions under the causal mask that
  // starts at the tile that holds the block's diagonal.
  const int klo = POS ? krange[0] : k0;
  const int khi = POS ? krange[1] : min(k0 + BR, t) - 1;
  auto query_lo = [&](int qb) { return POS ? qmin[qb] : qb * BR; };
  auto query_hi = [&](int qb) { return POS ? qmax[qb] : min(qb * BR + BR, t) - 1; };
  auto next_live = [&](int qb) {
    if (causal)
      while (qb < nq && query_hi(qb) < klo) ++qb;
    return qb;
  };
  // a tile whose every query sees every key
  auto open = [&](int qb) {
    return qb * BR + BR <= t && k0 + BR <= t && (!causal || query_lo(qb) >= khi);
  };
  // Q and dO of tile qb into stage s by TMA (thread 0), and the tile's lse
  // log2 e, delta and qpos from the first BR threads' registers
  auto load_tile = [&](int qb, int s) {
    sm90::mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      const int at = s * L::TILE + j * BSLAB;
      sm90::tma_load_4d(sQ + at, &map_q, &full[s], 64 * j, hh, qb * BR, b);
      sm90::tma_load_4d(sdO + at, &map_do, &full[s], 64 * j, hh, qb * BR, b);
    }
  };
  struct Row { float lse2, delta; int pos; };
  auto read_row = [&](int qb) {
    const int q = qb * BR + tid;
    Row r = {0.f, 0.f, 0};
    if (q < t) {
      r.lse2 = lse[(size_t)bh * t + q] * LOG2E;
      r.delta = delta[(size_t)bh * t + q];
      if (POS) r.pos = qpos[q];
    }
    return r;
  };
  auto stage_row = [&](const Row& r, int s) {
    float* rows = sRows + s * L::ROWS * BR;
    rows[tid] = r.lse2;
    rows[BR + tid] = r.delta;
    if (POS) reinterpret_cast<int*>(rows)[2 * BR + tid] = r.pos;
  };

  int qb = next_live(0);
  if (tid == 0) {
    sm90::tma_prefetch(&map_k);
    sm90::tma_prefetch(&map_v);
    sm90::tma_prefetch(&map_q);
    sm90::tma_prefetch(&map_do);
    sm90::mbar_arrive_expect_tx(kvbar, 2 * L::TILE);
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      sm90::tma_load_4d(sK + j * BSLAB, &map_k, kvbar, 64 * j, hh, k0, b);
      sm90::tma_load_4d(sV + j * BSLAB, &map_v, kvbar, 64 * j, hh, k0, b);
    }
    if (qb < nq) load_tile(qb, 0);
  }
  if (qb < nq && tid < BR) stage_row(read_row(qb), 0);
  __syncthreads();

  const int key0 = k0 + warp * 16 + lane / 4;  // keys key0 and key0 + 8
  const float sl2 = scale * LOG2E;
  int kp[2] = {0, 0};
  if (POS) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (key0 + 8 * i < t) kp[i] = kpos[key0 + 8 * i];
  }
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  float st[32], dpt[32];
  uint32_t pa[4][4], da[4][4];

  sm90::mbar_wait(kvbar, 0);
  int s = 0;
  uint32_t phase = 0;  // bit s: the parity of stage s's next fill
  while (qb < nq) {
    // the next live tile loads into the other stage while this one is
    // computed (its last reader finished before the previous barrier)
    const int next = next_live(qb + 1);
    Row row_next = {0.f, 0.f, 0};
    if (next < nq) {
      if (tid == 0) load_tile(next, s ^ 1);
      if (tid < BR) row_next = read_row(next);
    }
    sm90::mbar_wait(&full[s], (phase >> s) & 1);
    phase ^= 1u << s;
    const int q0 = qb * BR;
    const unsigned char* q_tile = sQ + s * L::TILE;
    const unsigned char* do_tile = sdO + s * L::TILE;
    const float* rows = sRows + s * L::ROWS * BR;  // lse log2 e, delta, qpos
    const int* sqp = reinterpret_cast<const int*>(rows + 2 * BR);
    mma_abt<D>(st, sK, q_tile);    // S^T = K Q^T
    mma_abt<D>(dpt, sV, do_tile);  // dP^T = V dO^T
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    // P^T and dS^T per column (query) as dQ computes them per row
    if (!open(qb)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1);
        const bool v = key0 + 8 * i < t && q0 + c < t &&
                       (!causal || (POS ? sqp[c] >= kp[i] : q0 + c >= key0 + 8 * i));
        st[e] = v ? exp2f(fmaf(st[e], sl2, -rows[c])) : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = 8 * (e >> 2) + 2 * t4 + (e & 1);
        st[e] = exp2f(fmaf(st[e], sl2, -rows[c]));
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = 8 * (e >> 2) + 2 * t4 + (e & 1);
      dpt[e] = st[e] * (dpt[e] - rows[BR + c]);
    }
    // P^T rounded to dO's type and dS^T to Q's, as the Pallas kernel casts
    // them, in bf16 A fragments
    to_a(pa, st);
    to_a(da, dpt);
    mma_ab<D>(acc_v, pa, do_tile);  // dV += P^T dO
    mma_ab<D>(acc_k, da, q_tile);   // dK += dS^T Q
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_v);
    sm90::fence_regs(acc_k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(pa[kk]), sm90::fence_regs(da[kk]);
    if (next < nq && tid < BR) stage_row(row_next, s ^ 1);
    __syncthreads();  // this stage is free for the tile after next
    qb = next;
    s ^= 1;
  }

  const size_t rs = (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= t) continue;
    bf16* krow = dk + ((size_t)b * t + key) * rs + (size_t)hh * D;
    bf16* vrow = dv + ((size_t)b * t + key) * rs + (size_t)hh * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(krow + 8 * j + 2 * t4) =
          pack_f32(acc_k[4 * j + 2 * i] * scale, acc_k[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * j + 2 * t4) =
          pack_f32(acc_v[4 * j + 2 * i], acc_v[4 * j + 2 * i + 1]);
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// A (b, t, h, d) bf16 tensor read in place as the 4-D tensor {d, h, t, b}: a
// box is `rows` rows by 64 columns of one (b, h) slab; rows past t read zeros
bool tile_map(CUtensorMap* map, const void* x, int b, int t, int h, int d, int rows) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)h, (uint64_t)t, (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)d * 2, (uint64_t)h * d * 2, (uint64_t)t * h * d * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return sm90::encode_tensor_map(map, x, 4, dims, strides, box);
}

// Each launcher makes a runtime call first (prepare): it makes the context
// current in this thread, which the tensor-map encoder needs (a backward
// runs on autograd's worker thread).
template <int D, bool POS>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* qpos,
        const void* kpos, int b, int t, int h, float scale, int causal, cudaStream_t s) {
  const size_t smem = FwdSmem<D, POS>::bytes(t);
  int rc = prepare(flash_fwd_kernel<D, POS>, smem);
  if (rc) return rc;
  CUtensorMap map_q, map_k, map_v;
  if (!tile_map(&map_q, q, b, t, h, D, FK) || !tile_map(&map_k, k, b, t, h, D, FK) ||
      !tile_map(&map_v, v, b, t, h, D, FK))
    return -2;
  dim3 grid(b * h, (t + FQ - 1) / FQ);
  flash_fwd_kernel<D, POS><<<grid, FWD_THREADS, smem, s>>>(
      map_q, map_k, map_v, (bf16*)o, (float*)lse, (const int*)qpos, (const int*)kpos, t, h,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int D, bool POS>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           void* delta, void* dq, const void* qpos, const void* kpos, const void* o, int b,
           int t, int h, float scale, int causal, cudaStream_t s) {
  const size_t smem = DqSmem<D, POS>::bytes(t);
  int rc = prepare(flash_bwd_dq_kernel<D, POS>, smem);
  if (rc) return rc;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tile_map(&map_q, q, b, t, h, D, BR) || !tile_map(&map_k, k, b, t, h, D, BR) ||
      !tile_map(&map_v, v, b, t, h, D, BR) || !tile_map(&map_do, dout, b, t, h, D, BR))
    return -2;
  dim3 grid(b * h, (t + BR - 1) / BR);
  flash_bwd_dq_kernel<D, POS><<<grid, BWD_THREADS, smem, s>>>(
      map_q, map_k, map_v, map_do, (const bf16*)o, (const bf16*)dout, (const float*)lse,
      (float*)delta, (bf16*)dq, (const int*)qpos, (const int*)kpos, t, h, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, bool POS>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, const void* qpos, const void* kpos, int b,
            int t, int h, float scale, int causal, cudaStream_t s) {
  const size_t smem = DkvSmem<D, POS>::bytes(t);
  int rc = prepare(flash_bwd_dkv_kernel<D, POS>, smem);
  if (rc) return rc;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tile_map(&map_q, q, b, t, h, D, BR) || !tile_map(&map_k, k, b, t, h, D, BR) ||
      !tile_map(&map_v, v, b, t, h, D, BR) || !tile_map(&map_do, dout, b, t, h, D, BR))
    return -2;
  dim3 grid(b * h, (t + BR - 1) / BR);
  flash_bwd_dkv_kernel<D, POS><<<grid, BWD_THREADS, smem, s>>>(
      map_q, map_k, map_v, map_do, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, (const int*)qpos, (const int*)kpos, t, h, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 on success), -1
// for a head_dim other than 64 or 128, or -2 when the CUDA driver refuses a
// tensor map.  qpos and kpos are both null (local indices) or both (t,)
// int32 device vectors of global positions.
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

// out null: delta is read; out set (the forward's O): delta = rowsum(dO o O)
// is computed from it and written to delta for the dK/dV launch.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, void* delta, void* dq, const void* qpos,
                                const void* kpos, const void* out, int b, int t, int h, int d,
                                float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pos = qpos != nullptr;
#define HVD_DQ(D, P) \
  bwd_dq<D, P>(q, k, v, dout, lse, delta, dq, qpos, kpos, out, b, t, h, scale, causal, s)
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
