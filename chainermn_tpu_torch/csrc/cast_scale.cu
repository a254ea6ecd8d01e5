// Fused cast + scale over a flat buffer, for Hopper (sm_90a).
//
//     y[i] = dst((float)x[i] * scale)
//
// Replaces the Pallas kernel chainermn_tpu/ops/cast_scale.py:33 (`_kernel`,
// reached from `cast_scale` at :43), which in turn rebuilt the reference's
// runtime-compiled CUDA cast kernels around `ncclAllReduce` in the fork's
// pure_nccl communicator: f32 gradients -> f16 wire buffer before the
// all-reduce, f16 sum -> f32 with the 1/size scale after it.
//
// What bounds it: one float multiply per element against 2 + 4 bytes
// (f32 <-> f16/bf16) of device memory traffic, so the card's memory rate
// (3.35 TB/s on an H100 SXM) and not its arithmetic sets its least time:
// (source bytes + destination bytes) / 3.35 TB/s.  The design does what a
// bytes-bound pass needs and nothing more:
//  * one grid-stride pass, each thread moving 8 elements at a time with
//    16-byte loads and stores (one 16 B access for a 2-byte type, two for
//    float), so a warp touches 512 B contiguous per access;
//  * a scalar grid-stride path for the tail (n % 8) and for any buffer whose
//    source or destination is not 16-byte aligned (a slice of a packed
//    buffer can start anywhere);
//  * arithmetic in float whatever the types, rounding to the destination
//    with round-to-nearest-even (__float2half_rn / __float2bfloat16_rn), as
//    torch.Tensor.to and XLA's convert do: f16 overflow gives +-inf.
//
// Plain C entry point (bound from Python with ctypes, no PyTorch headers):
// the caller passes the stream and the device, allocates the output, and
// raises if the returned cudaError_t is not 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with chainermn_tpu_torch/ops/cast_scale.py
enum Code { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kVec = 8;          // elements per vector step of a thread
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 256 threads per SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename D> __device__ __forceinline__ D from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
cast_scale_kernel(const S* __restrict__ x, D* __restrict__ y, int64_t n,
                  float scale, int vectorized) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vectorized) {
    // 8 elements = 16 B of a 2-byte type, 32 B of float
    constexpr int kInWords = sizeof(S) * kVec / sizeof(uint4);
    constexpr int kOutWords = sizeof(D) * kVec / sizeof(uint4);
    const int64_t nvec = n / kVec;
    const uint4* src = reinterpret_cast<const uint4*>(x);
    uint4* dst = reinterpret_cast<uint4*>(y);
    for (int64_t i = tid; i < nvec; i += stride) {
      uint4 in[kInWords], out[kOutWords];
#pragma unroll
      for (int k = 0; k < kInWords; ++k) in[k] = src[i * kInWords + k];
      const S* iv = reinterpret_cast<const S*>(in);
      D* ov = reinterpret_cast<D*>(out);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        ov[k] = from_f32<D>(to_f32(iv[k]) * scale);
#pragma unroll
      for (int k = 0; k < kOutWords; ++k) dst[i * kOutWords + k] = out[k];
    }
    done = nvec * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    y[i] = from_f32<D>(to_f32(x[i]) * scale);
}

template <typename S, typename D>
cudaError_t launch(const void* x, void* y, int64_t n, float scale,
                   cudaStream_t stream) {
  const int vectorized =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       (sizeof(uint4) - 1)) == 0;
  const int64_t work = vectorized ? n / kVec + n % kVec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  cast_scale_kernel<S, D><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(static_cast<const S*>(x),
                                      static_cast<D*>(y), n, scale,
                                      vectorized);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch_dst(const void* x, void* y, int64_t n, float scale,
                         int dst, cudaStream_t stream) {
  switch (dst) {
    case kF32: return launch<S, float>(x, y, n, scale, stream);
    case kBF16: return launch<S, __nv_bfloat16>(x, y, n, scale, stream);
    case kF16: return launch<S, __half>(x, y, n, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// y = dst((float)x * scale) over n elements on `stream` of `device`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cmn_cast_scale(const void* x, void* y, int64_t n, float scale,
                              int src, int dst, int device, void* stream) {
  if (n <= 0) return cudaSuccess;
  // this library carries its own CUDA runtime: point it at the tensor's
  // device (the primary context PyTorch uses too) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src) {
    case kF32: return dispatch_dst<float>(x, y, n, scale, dst, s);
    case kBF16: return dispatch_dst<__nv_bfloat16>(x, y, n, scale, dst, s);
    case kF16: return dispatch_dst<__half>(x, y, n, scale, dst, s);
  }
  return cudaErrorInvalidValue;
}
