// fused_scale: out = (float(x) * factor) cast to the output type, in one pass.
//
// Replaces horovod_tpu/ops/pallas_kernels.py fused_scale (_scale_kernel), the
// fusion-buffer pre/postscale pass of the gradient exchange and the
// fp16/bf16 compressor cast.  The reference Horovod wrote the same pass in
// CUDA (ops/cuda/cuda_kernels.cu, ScaleBufferCudaImpl).
//
// Bound: bytes.  One read of the input and one write of the output; the single
// multiply per element is nothing beside H100's 3.35 TB/s.  So the design is
// about keeping enough bytes in flight to cover the latency of device memory:
//   * batched registers: each thread loads U = 4 independent 16-byte
//     vectors (16 fp32 or 32 bf16/fp16 values) into registers before it
//     converts or stores any of them, so four loads are in flight a thread.
//     x and y may be the same buffer (the exchange scales a bucket in
//     place); every element is read and written by one thread, loads
//     before stores, so that is safe without __restrict__;
//   * streaming cache hints: ld.global.cs / st.global.cs (__ldcs, __stcs),
//     since the data is touched once.  Not ld.global.nc (__ldg), which
//     assumes x is read-only for the kernel's lifetime, false in place;
//   * a grid as wide as the buffer: each block owns U x THREADS
//     contiguous vectors, a thread's U of them THREADS apart, so that each
//     load instruction of a warp reads 512 contiguous bytes;
//   * blocks take the buffer from its end: blocks start in index order,
//     and the exchange scales a bucket just after packing it, so the end
//     is what is still in L2.  (On an H100, over the buckets of a
//     transformer step, a persistent grid walking the buffer in strides of
//     the whole grid ran slower, and blocks from the start 2 % slower on
//     freshly packed buckets; a thread's vectors a grid-width apart ran
//     within 1 % either way.  scale_bench.py measures the layouts.)
// Any length and any 16-byte aligned pointers: a thread skips its vectors
// past the end, and the last n % VEC elements go through a scalar tail, so
// nothing is padded.  Conversions round to nearest even
// (__float2bfloat16_rn, __float2half_rn), as the plain version's .to() does,
// so results are bit-exact with it.  No shared memory, no synchronisation.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int THREADS = 256;
constexpr int U = 4;  // 16-byte vectors in flight a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// The output of one 16-byte input vector: VEC values of Out, 8, 16 or 32
// bytes, stored with streaming hints.
template <typename In, typename Out>
struct OutVec {
  static constexpr int VEC = 16 / sizeof(In);
  static constexpr int BYTES = VEC * sizeof(Out);
  static constexpr int WORDS = BYTES >= 16 ? BYTES / 16 : 1;
  uint4 w[WORDS];

  __device__ __forceinline__ void convert(const uint4& raw, float factor) {
    const In* in = reinterpret_cast<const In*>(&raw);
    Out* out = reinterpret_cast<Out*>(w);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = from_f32<Out>(to_f32(in[j]) * factor);
  }

  __device__ __forceinline__ void store(Out* y, int64_t v) const {
    if constexpr (BYTES >= 16) {
      uint4* dst = reinterpret_cast<uint4*>(y + v * VEC);
#pragma unroll
      for (int j = 0; j < WORDS; ++j) __stcs(dst + j, w[j]);
    } else {  // fp32 -> bf16/fp16: four outputs are 8 bytes
      __stcs(reinterpret_cast<uint2*>(y + v * VEC), make_uint2(w[0].x, w[0].y));
    }
  }
};

template <typename In, typename Out>
__global__ void __launch_bounds__(THREADS)
scale_vec_kernel(const In* x, Out* y, int64_t n, float factor) {
  using O = OutVec<In, Out>;
  constexpr int VEC = O::VEC;
  const int64_t nvec = n / VEC;
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  // vectors first, first + THREADS, ... of the block's U x THREADS, block 0
  // at the end (launch sizes the grid to cover the buffer); past the end a
  // vector is skipped
  const int64_t first = (int64_t)(gridDim.x - 1 - blockIdx.x) * U * THREADS + threadIdx.x;
  uint4 raw[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (first + u * THREADS < nvec) raw[u] = __ldcs(xv + first + u * THREADS);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (first + u * THREADS < nvec) {
      O out;
      out.convert(raw[u], factor);
      out.store(y, first + u * THREADS);
    }
  }
  // scalar tail: the last n % VEC elements, one for each of block 0's
  // first threads
  const int64_t t = nvec * VEC + (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t < n) y[t] = from_f32<Out>(to_f32(x[t]) * factor);
}

template <typename In, typename Out>
int launch(const void* x, void* y, int64_t n, float factor, cudaStream_t stream) {
  // U vectors a thread, the scalar tail included
  constexpr int VEC = 16 / sizeof(In);
  const int64_t blocks = ((n + VEC - 1) / VEC + U * THREADS - 1) / (U * THREADS);
  scale_vec_kernel<In, Out><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(y), n, factor);
  return (int)cudaGetLastError();
}

template <typename In>
int dispatch_out(int out_dtype, const void* x, void* y, int64_t n, float factor,
                 cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch<In, float>(x, y, n, factor, s);
    case kBF16: return launch<In, __nv_bfloat16>(x, y, n, factor, s);
    case kF16: return launch<In, __half>(x, y, n, factor, s);
  }
  return -1;
}

}  // namespace

// x and y must be 16-byte aligned (y may equal x).  Returns the CUDA error of
// the launch (0 on success), -1 for an unknown dtype code, or -2 for a
// misaligned pointer.  n == 0 launches nothing.
extern "C" int hvd_fused_scale(const void* x, void* y, int64_t n, float factor,
                               int in_dtype, int out_dtype, void* stream) {
  if (n <= 0) return 0;
  if ((uintptr_t)x % 16 || (uintptr_t)y % 16) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32: return dispatch_out<float>(out_dtype, x, y, n, factor, s);
    case kBF16: return dispatch_out<__nv_bfloat16>(out_dtype, x, y, n, factor, s);
    case kF16: return dispatch_out<__half>(out_dtype, x, y, n, factor, s);
  }
  return -1;
}
