// Hand-written Hopper (sm_90a) quantize / dequantize kernels.
//
// Port of the two Pallas TPU kernels of src/repro/kernels/quantized.py:
//
// * quantize_kernel replaces _quantize_kernel / quantize_pallas:
//   q[R, C] = cast(clip(x / s[R], +-qmax)), x in f32 or bf16, q in fp8
//   e4m3 / e5m2 or int8.  The divide is a true IEEE divide (this file must
//   not be built with fast-math): x * (1 / s) moves the last bit of the
//   quotient and flips fp8 roundings against the reference.  fp8 is cast
//   with __nv_cvt_float_to_fp8(..., __NV_SATFINITE, ...), which rounds to
//   nearest even like ml_dtypes and torch; int8 rounds half to even
//   (rintf, like jnp.round) after the clip.
// * dequantize_kernel replaces _dequantize_kernel / dequantize_pallas:
//   x[R, C] = q * s[R] in f32, then cast to f32 or bf16 (nearest even).
//
// Bound on the H100: one pass over device memory, a few operations per
// element (2 or 5 bytes read, 1 or 2-4 written): bytes.  Design: one thread
// per element, grid-stride over the flat [R, C] array, the row's scale read
// per element (it stays in L1/L2).  The TPU kernel blocks rows to stream
// through VMEM; nothing here needs on-chip staging.
//
// Plain C interface (loaded with ctypes): every launch goes to the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with kernels/quantized.py and fused_contraction.py
enum Code { kF32 = 0, kBF16 = 1, kE4M3 = 2, kE5M2 = 3, kI8 = 4 };

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const __nv_fp8_e4m3* p, int64_t i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float load_f(const __nv_fp8_e5m2* p, int64_t i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float load_f(const int8_t* p, int64_t i) {
  return static_cast<float>(p[i]);
}

template <int kOut>
__device__ __forceinline__ void store_q(void* q, int64_t i, float y) {
  if (kOut == kE4M3) {
    static_cast<__nv_fp8_storage_t*>(q)[i] =
        __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  } else if (kOut == kE5M2) {
    static_cast<__nv_fp8_storage_t*>(q)[i] =
        __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E5M2);
  } else {
    static_cast<int8_t*>(q)[i] = static_cast<int8_t>(rintf(y));
  }
}

template <typename TIn, int kOut>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const TIn* __restrict__ x, const float* __restrict__ s,
                    void* __restrict__ q, int64_t n, int64_t cols,
                    float qmax) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float y = __fdiv_rn(load_f(x, i), s[i / cols]);
    // Clip without fminf/fmaxf, so a NaN stays NaN as in jnp.clip.
    y = y < -qmax ? -qmax : (y > qmax ? qmax : y);
    store_q<kOut>(q, i, y);
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const TIn* __restrict__ q, const float* __restrict__ s,
                      TOut* __restrict__ out, int64_t n, int64_t cols) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = __fmul_rn(load_f(q, i), s[i / cols]);
    if constexpr (sizeof(TOut) == 4)
      out[i] = v;
    else
      out[i] = __float2bfloat16_rn(v);
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename TIn>
int launch_quantize(int out, const void* x, const float* s, void* q,
                    int64_t n, int64_t cols, float qmax, cudaStream_t st) {
  const TIn* xp = static_cast<const TIn*>(x);
  const int g = blocks_for(n);
  if (out == kE4M3)
    quantize_kernel<TIn, kE4M3><<<g, kThreads, 0, st>>>(xp, s, q, n, cols,
                                                        qmax);
  else if (out == kE5M2)
    quantize_kernel<TIn, kE5M2><<<g, kThreads, 0, st>>>(xp, s, q, n, cols,
                                                        qmax);
  else if (out == kI8)
    quantize_kernel<TIn, kI8><<<g, kThreads, 0, st>>>(xp, s, q, n, cols,
                                                      qmax);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_dequantize(int out, const void* q, const float* s, void* o,
                      int64_t n, int64_t cols, cudaStream_t st) {
  const TIn* qp = static_cast<const TIn*>(q);
  const int g = blocks_for(n);
  if (out == kF32)
    dequantize_kernel<TIn, float><<<g, kThreads, 0, st>>>(
        qp, s, static_cast<float*>(o), n, cols);
  else if (out == kBF16)
    dequantize_kernel<TIn, __nv_bfloat16><<<g, kThreads, 0, st>>>(
        qp, s, static_cast<__nv_bfloat16*>(o), n, cols);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in_dtype: 0 = float32, 1 = bfloat16; out_dtype: 2 = e4m3, 3 = e5m2, 4 = int8.
int q_quantize(int in_dtype, int out_dtype, const void* x, const void* s,
               void* q, int64_t rows, int64_t cols, float qmax,
               void* stream) {
  if (rows < 0 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = rows * cols;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  if (in_dtype == kF32)
    return launch_quantize<float>(out_dtype, x, sp, q, n, cols, qmax, st);
  if (in_dtype == kBF16)
    return launch_quantize<__nv_bfloat16>(out_dtype, x, sp, q, n, cols, qmax,
                                          st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// in_dtype: 2 = e4m3, 3 = e5m2, 4 = int8; out_dtype: 0 = float32, 1 = bfloat16.
int q_dequantize(int in_dtype, int out_dtype, const void* q, const void* s,
                 void* out, int64_t rows, int64_t cols, void* stream) {
  if (rows < 0 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = rows * cols;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  if (in_dtype == kE4M3)
    return launch_dequantize<__nv_fp8_e4m3>(out_dtype, q, sp, out, n, cols,
                                            st);
  if (in_dtype == kE5M2)
    return launch_dequantize<__nv_fp8_e5m2>(out_dtype, q, sp, out, n, cols,
                                            st);
  if (in_dtype == kI8)
    return launch_dequantize<int8_t>(out_dtype, q, sp, out, n, cols, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
