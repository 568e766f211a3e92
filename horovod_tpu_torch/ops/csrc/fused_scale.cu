// fused_scale: out = (float(x) * factor) cast to the output type, in one pass.
//
// Replaces horovod_tpu/ops/pallas_kernels.py fused_scale (_scale_kernel), the
// fusion-buffer pre/postscale pass of the gradient exchange and the
// fp16/bf16 compressor cast.  The reference Horovod wrote the same pass in
// CUDA (ops/cuda/cuda_kernels.cu, ScaleBufferCudaImpl).
//
// Bound: bytes.  One read of the input and one write of the output; the single
// multiply per element is nothing beside H100's 3.35 TB/s.  Design: a
// grid-stride loop in which each thread moves one 16-byte vector of input per
// iteration (4 fp32 or 8 bf16/fp16 values), converts through fp32 and stores
// the matching output vector.  Any length: the last n % VEC elements go
// through a scalar tail, so nothing is padded.  x and y may be the same buffer
// (the exchange scales a bucket in place): each element is read and written by
// one thread, so the pointers are not declared __restrict__.  The wrapper
// hands over 16-byte aligned pointers.  No shared memory, no synchronisation.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

template <typename In, typename Out>
__global__ void scale_vec_kernel(const In* x, Out* y, int64_t n, float factor) {
  constexpr int VEC = 16 / sizeof(In);
  const int64_t nvec = n / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const uint4 raw = xv[i];
    const In* in = reinterpret_cast<const In*>(&raw);
    constexpr int OUT_BYTES = VEC * sizeof(Out);
    uint4 packed[(OUT_BYTES + 15) / 16];
    Out* out = reinterpret_cast<Out*>(packed);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = from_f32<Out>(to_f32(in[j]) * factor);
    if (OUT_BYTES >= 16) {
      uint4* yv = reinterpret_cast<uint4*>(y + i * VEC);
#pragma unroll
      for (int j = 0; j < OUT_BYTES / 16; ++j) yv[j] = packed[j];
    } else {
      // fp32 -> bf16/fp16: four outputs are 8 bytes
      *reinterpret_cast<uint2*>(y + i * VEC) = *reinterpret_cast<const uint2*>(packed);
    }
  }
  // scalar tail: the last n % VEC elements
  const int64_t tail = nvec * VEC;
  const int64_t t = tail + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) y[t] = from_f32<Out>(to_f32(x[t]) * factor);
}

template <typename In, typename Out>
void launch(const void* x, void* y, int64_t n, float factor, cudaStream_t stream) {
  constexpr int THREADS = 256;
  constexpr int VEC = 16 / sizeof(In);
  int64_t blocks = ((n + VEC - 1) / VEC + THREADS - 1) / THREADS;
  // enough blocks to fill 132 SMs several times over; the grid-stride loop
  // covers the rest
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  scale_vec_kernel<In, Out><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(y), n, factor);
}

template <typename In>
int dispatch_out(int out_dtype, const void* x, void* y, int64_t n, float factor,
                 cudaStream_t s) {
  switch (out_dtype) {
    case kF32: launch<In, float>(x, y, n, factor, s); return 0;
    case kBF16: launch<In, __nv_bfloat16>(x, y, n, factor, s); return 0;
    case kF16: launch<In, __half>(x, y, n, factor, s); return 0;
  }
  return -1;
}

}  // namespace

// x and y must be 16-byte aligned (y may equal x).  Returns cudaGetLastError()
// after the launch (0 on success), -1 for an unknown dtype code, or -2 for a
// misaligned pointer.  n == 0 launches nothing.
extern "C" int hvd_fused_scale(const void* x, void* y, int64_t n, float factor,
                               int in_dtype, int out_dtype, void* stream) {
  if (n <= 0) return 0;
  if ((uintptr_t)x % 16 || (uintptr_t)y % 16) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  switch (in_dtype) {
    case kF32: rc = dispatch_out<float>(out_dtype, x, y, n, factor, s); break;
    case kBF16: rc = dispatch_out<__nv_bfloat16>(out_dtype, x, y, n, factor, s); break;
    case kF16: rc = dispatch_out<__half>(out_dtype, x, y, n, factor, s); break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
