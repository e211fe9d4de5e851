// ZeroEven: copy a 1-D tensor with every even index set to 0.
//
// Replaces the TPU kernel pps_tpu/ops/pallas/zero_even.py:zero_even
// (body _zero_even_kernel), the reference's kernel-authoring smoke-test op.
// The Pallas version pads to a multiple of 128, views the array as one
// [1, n_pad] VMEM block, computes in float32 and casts back.  None of that
// is needed here: the kernel is templated on the element type (float32,
// bfloat16, float16) and masks the ragged tail itself, so it reads and
// writes the caller's dtype with no round trip and no padding.  The result
// equals the TPU kernel's: odd indices are copied bit for bit (a cast of a
// bf16/f16 value to float32 and back is exact), even indices are +0, even
// where the input there is NaN.
//
// Bound: pure data movement, 2 * n * itemsize bytes (x read once, out
// written once) over the H100's 3.35 TB/s, i.e. about 40 us for 2^24
// float32 values; it does one select per element and no arithmetic.
// Design: a grid-stride loop with consecutive threads on consecutive
// elements, so every warp's loads and stores coalesce into full 32-byte
// sectors.  The grid is capped at a few blocks per SM and each thread
// walks the array, which keeps enough loads in flight to cover memory
// latency at any n without launching millions of tiny blocks.
//
// Plain C interface, loaded from Python with ctypes
// (pps_tpu_torch/kernels/zero_even.py): the launch goes on the caller's
// stream, does not synchronise, allocates nothing, and the function
// returns cudaGetLastError() so a refused launch is reported.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T zero_value();

template <>
__device__ __forceinline__ float zero_value<float>() {
  return 0.0f;
}

template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

template <>
__device__ __forceinline__ __half zero_value<__half>() {
  return __float2half(0.0f);
}

template <typename T>
__global__ void zero_even_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = (i & 1) ? x[i] : zero_value<T>();
  }
}

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        count <= 0) {
      count = 132;  // H100 SXM
    }
  }
  return count;
}

template <typename T>
int launch(const void* x, void* out, int64_t n, cudaStream_t stream) {
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  zero_even_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// (0 on success); -1 for an unknown dtype code.
extern "C" int pps_zero_even(const void* x, void* out, long long n, int dtype,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, out, n, s);
    case 1:
      return launch<__nv_bfloat16>(x, out, n, s);
    case 2:
      return launch<__half>(x, out, n, s);
    default:
      return -1;
  }
}
