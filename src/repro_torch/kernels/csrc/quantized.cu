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
// * The per-tensor requantize is B5 with the scale found on the card:
//   amax = max |x| (f32), s = clamp(amax, min=eps) * margin / qmax, then
//   B5's cast with that one scale; s is written to a device scalar.  It
//   is the reference's quant.quantize(x, policy) at granularity "tensor"
//   (plain jnp there, fused by XLA).  Up to kOneLaunchMax elements it is
//   one launch, requant_block_kernel: one block of 1024 threads holds the
//   tensor in registers between the amax and the cast (one read, one
//   write); its time past a few thousand elements is the divides of one
//   SM, so a thread takes 8 adjacent elements at once (8 independent
//   divides in flight).  Larger tensors take two launches:
//   requant_amax_kernel writes one partial amax a block,
//   requant_cast_kernel reduces them (every block, from L2) and casts.  No atomics and no scratch to clear: the
//   result and its bits do not depend on the order of the blocks.  (A
//   thread block cluster of 2 to 8 blocks sharing the amax through
//   distributed shared memory was tried for the middle sizes: it took 4.7
//   to 6.1 us at every size probed, 6,144 to 73,728 elements, more than
//   one block's divides.)
//
// The amax compares |x| as unsigned bit patterns: for non-negative floats
// they order as the values do, with every NaN above +inf, so the maximum
// is torch.amax(x.abs()) exactly, NaN carried through.  The clamp is a
// compare, not fmaxf, so a NaN amax stays NaN as in torch.clamp.
//
// Bound on the H100: one pass over device memory and a few operations
// per element: bytes, and for the many small tensors of a step the launch
// itself.  Design: a scale is either one per row (s[R, 1]) or one for the
// tensor (a device scalar); a per-tensor scale walks the array as one flat
// row.  Threads tile the rows: a power-of-two group of threads a row, the
// rest of the block on further rows, so each thread knows its row without
// an integer division.  A thread moves 4 elements a step and consecutive
// threads take consecutive groups of 4, so every warp access is one
// contiguous span: 16-byte loads of f32 (8 of bf16) and 4-byte stores of
// the packed fp8/int8 result, and for dequantize 4-byte loads and 16-byte
// f32 (8-byte bf16) stores.  A row short of the block's threads gives each
// thread one step (a small tensor costs one step's latency); large arrays
// give each thread 2 or 4 steps, issued together.  A row whose length is
// not a multiple of 4, or a misaligned pointer, takes the scalar
// instantiation.  The grid is sized to the work.  The TPU kernel blocks
// rows to stream through VMEM; nothing here needs on-chip staging.
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

constexpr int kThreads = 256;      // quantize / dequantize / requant passes
constexpr int kVec = 4;            // elements a thread moves per step
constexpr int kMaxSteps = 4;       // steps a thread takes at most
// Blocks the grid should hold before threads take more steps (2 an SM).
constexpr int64_t kWideGrid = 2 * 132;
// The one-launch requantize: one block of kBlockThreads threads, each
// holding up to kBlockUnits units of kVec elements in registers
// (mirrored by quantized.REQUANT_ONE_LAUNCH_MAX).
constexpr int kBlockThreads = 1024;
constexpr int kBlockUnits = 8;
constexpr int64_t kOneLaunchMax =
    int64_t(kBlockThreads) * kBlockUnits * kVec;
// Partial amaxes of the two-launch requantize, at most (mirrored by
// quantized.REQUANT_MAX_PARTIALS).
constexpr int kMaxPartials = 512;
constexpr int kMaxGridY = 65535;

// ---- element conversions ---------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f(__nv_fp8_e5m2 v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f(int8_t v) {
  return static_cast<float>(v);
}

// q's byte for y (already divided and clipped).
template <int kOut>
__device__ __forceinline__ uint8_t q_byte(float y) {
  if constexpr (kOut == kE4M3)
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  else if constexpr (kOut == kE5M2)
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E5M2);
  else
    return static_cast<uint8_t>(static_cast<int8_t>(rintf(y)));
}

// B5's element: divide, clip (a NaN stays NaN, as in jnp.clip), cast.
template <int kOut>
__device__ __forceinline__ uint8_t quantize_one(float x, float s,
                                                float qmax) {
  float y = __fdiv_rn(x, s);
  y = y < -qmax ? -qmax : (y > qmax ? qmax : y);
  return q_byte<kOut>(y);
}

// B5 on 4 elements, packed into a word (element 0 in the low byte).
template <int kOut>
__device__ __forceinline__ uint32_t pack_q(const float (&v)[4], float s,
                                           float qmax) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w |= uint32_t(quantize_one<kOut>(v[j], s, qmax)) << (8 * j);
  return w;
}

// ---- 4-element vectors ---------------------------------------------------

// Load 4 consecutive elements as f32: one wide load (kWide) or scalars.
template <bool kWide>
__device__ __forceinline__ void load4(const float* p, float (&v)[kVec]) {
  if constexpr (kWide) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = p[j];
  }
}
template <bool kWide>
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  if constexpr (kWide) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    // bf16 -> f32 is the high half of the f32 word: exact
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = __bfloat162float(p[j]);
  }
}
template <bool kWide, typename T8>
__device__ __forceinline__ void load4(const T8* p, float (&v)[kVec]) {
  // 8-bit payloads (fp8 e4m3 / e5m2, int8): one 4-byte load
  if constexpr (kWide) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint8_t b = static_cast<uint8_t>(w >> (8 * j));
      v[j] = to_f(*reinterpret_cast<const T8*>(&b));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = to_f(p[j]);
  }
}

template <bool kWide>
__device__ __forceinline__ void store4(float* p, const float (&v)[kVec]) {
  if constexpr (kWide) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) p[j] = v[j];
  }
}
template <bool kWide>
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  if constexpr (kWide) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

__device__ __forceinline__ void store1(float* p, float y) { *p = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float y) {
  *p = __float2bfloat16_rn(y);
}

// ---- the row tiling --------------------------------------------------------
//
// A block is kThreads threads: 2^tpr_log2 threads a row, the rest on the
// next rows (kThreads >> tpr_log2 rows a block, blockIdx.y walking the
// row groups).  A row is cut into units of kVec elements (kWide) or of one
// element; blockIdx.x takes a span of steps * 2^tpr_log2 units of every
// row, each thread `steps` of them, 2^tpr_log2 apart, so a warp's step is
// one contiguous span.  Elements past the last whole unit of a row (at
// most kVec - 1: a per-tensor scale's flat row) are the tail, done element
// by element by the first x-block.

struct Tiling {
  int tpr_log2;        // log2(threads a row)
  int steps;           // units a thread takes (1, 2 or 4)
  int64_t rows, cols;  // the array as the kernel walks it
  int64_t units;       // whole units a row (of kVec elements, or of 1)
};

template <typename Fn>
__device__ __forceinline__ void for_each_row(const Tiling& t, Fn&& fn) {
  const int tpr = 1 << t.tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int64_t rows_per_block = kThreads >> t.tpr_log2;
  const int64_t u0 = int64_t(blockIdx.x) * t.steps * tpr + lane;
  for (int64_t r = blockIdx.y * rows_per_block + (threadIdx.x >> t.tpr_log2);
       r < t.rows; r += int64_t(gridDim.y) * rows_per_block)
    fn(r, u0, lane, tpr);
}

template <typename TIn, int kOut, bool kWide>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const TIn* __restrict__ x, const float* __restrict__ s,
                    int s_per_row, uint8_t* __restrict__ q, Tiling t,
                    float qmax) {
  constexpr int kUnit = kWide ? kVec : 1;
  for_each_row(t, [&](int64_t r, int64_t u0, int lane, int tpr) {
    const float sr = s[s_per_row ? r : 0];
    const TIn* xr = x + r * t.cols;
    uint8_t* qr = q + r * t.cols;
    float v[kMaxSteps][kVec];
#pragma unroll
    for (int k = 0; k < kMaxSteps; ++k) {
      const int64_t u = u0 + int64_t(k) * tpr;
      if (k < t.steps && u < t.units) {
        if constexpr (kWide) load4<true>(xr + u * kUnit, v[k]);
        else v[k][0] = to_f(xr[u]);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxSteps; ++k) {
      const int64_t u = u0 + int64_t(k) * tpr;
      if (k < t.steps && u < t.units) {
        if constexpr (kWide)
          *reinterpret_cast<uint32_t*>(qr + u * kUnit) =
              pack_q<kOut>(v[k], sr, qmax);
        else
          qr[u] = quantize_one<kOut>(v[k][0], sr, qmax);
      }
    }
    if (kWide && blockIdx.x == 0)
      for (int64_t e = t.units * kUnit + lane; e < t.cols; e += tpr)
        qr[e] = quantize_one<kOut>(to_f(xr[e]), sr, qmax);
  });
}

template <typename TIn, typename TOut, bool kWide>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const TIn* __restrict__ q, const float* __restrict__ s,
                      int s_per_row, TOut* __restrict__ out, Tiling t) {
  constexpr int kUnit = kWide ? kVec : 1;
  for_each_row(t, [&](int64_t r, int64_t u0, int lane, int tpr) {
    const float sr = s[s_per_row ? r : 0];
    const TIn* qr = q + r * t.cols;
    TOut* orow = out + r * t.cols;
    float v[kMaxSteps][kVec];
#pragma unroll
    for (int k = 0; k < kMaxSteps; ++k) {
      const int64_t u = u0 + int64_t(k) * tpr;
      if (k < t.steps && u < t.units) {
        if constexpr (kWide) load4<true>(qr + u * kUnit, v[k]);
        else v[k][0] = to_f(qr[u]);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxSteps; ++k) {
      const int64_t u = u0 + int64_t(k) * tpr;
      if (k < t.steps && u < t.units) {
        if constexpr (kWide) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[k][j] = __fmul_rn(v[k][j], sr);
          store4<true>(orow + u * kUnit, v[k]);
        } else {
          store1(orow + u, __fmul_rn(v[k][0], sr));
        }
      }
    }
    if (kWide && blockIdx.x == 0)
      for (int64_t e = t.units * kUnit + lane; e < t.cols; e += tpr)
        store1(orow + e, __fmul_rn(to_f(qr[e]), sr));
  });
}

// ---- the per-tensor requantize ---------------------------------------------

struct Scaling {
  float qmax, margin, eps;
};

// s = clamp(amax, min=eps) * margin / qmax in f32, in that order (the
// precision policy's compute_scale); the clamp keeps a NaN.
__device__ __forceinline__ float scale_of(uint32_t amax_bits, Scaling c) {
  const float a = __uint_as_float(amax_bits);
  const float cl = a < c.eps ? c.eps : a;
  return __fdiv_rn(__fmul_rn(cl, c.margin), c.qmax);
}

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Max over the block of each thread's m; every thread gets it.
template <int kNThreads>
__device__ __forceinline__ uint32_t block_max(uint32_t m) {
  __shared__ uint32_t warp_max[kNThreads / 32];
  __shared__ uint32_t result;
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    uint32_t w = threadIdx.x < kNThreads / 32 ? warp_max[threadIdx.x] : 0u;
    w = __reduce_max_sync(0xffffffffu, w);
    if (threadIdx.x == 0) result = w;
  }
  __syncthreads();
  return result;
}

// Units of kVec elements, flat; the last one may be partial (n % kVec)
// and is then read and written element by element.
template <bool kWide, typename TIn>
__device__ __forceinline__ void load_unit(const TIn* x, int64_t u, int64_t n,
                                          float (&v)[kVec]) {
  const int64_t e0 = u * kVec;
  if (e0 + kVec <= n) {
    load4<kWide>(x + e0, v);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      v[j] = e0 + j < n ? to_f(x[e0 + j]) : 0.0f;
  }
}
// Unit u's 4 bytes (packed, element 0 lowest), stored whole or, for the
// partial last unit, element by element.
template <bool kWide>
__device__ __forceinline__ void store_unit(uint8_t* q, int64_t u, int64_t n,
                                           uint32_t w) {
  const int64_t e0 = u * kVec;
  if (e0 + kVec <= n) {
    if constexpr (kWide) {
      *reinterpret_cast<uint32_t*>(q + e0) = w;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        q[e0 + j] = static_cast<uint8_t>(w >> (8 * j));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (e0 + j < n) q[e0 + j] = static_cast<uint8_t>(w >> (8 * j));
  }
}

// amax, scale and cast of a tensor of n <= kOneLaunchMax elements in one
// block.  A thread takes pairs of adjacent units (8 elements: 8
// independent divides a pair, which its latency needs more than the
// warp's contiguous span), pair k of thread t being k * kBlockThreads + t.
template <typename TIn, int kOut, bool kWide>
__global__ void __launch_bounds__(kBlockThreads, 1)
    requant_block_kernel(const TIn* __restrict__ x, uint8_t* __restrict__ q,
                         float* __restrict__ scale_out, int64_t n,
                         Scaling c) {
  constexpr int kPairs = kBlockUnits / 2;
  const int64_t units = (n + kVec - 1) / kVec;
  float v[kPairs][2][kVec];
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int64_t u = 2 * (int64_t(k) * kBlockThreads + threadIdx.x);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (u + h < units) {
        load_unit<kWide>(x, u + h, n, v[k][h]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) m = max(m, abs_bits(v[k][h][j]));
      }
  }
  const float s = scale_of(block_max<kBlockThreads>(m), c);
  if (threadIdx.x == 0) *scale_out = s;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int64_t u = 2 * (int64_t(k) * kBlockThreads + threadIdx.x);
    if (u < units) {
      const uint32_t w0 = pack_q<kOut>(v[k][0], s, c.qmax);
      const uint32_t w1 = pack_q<kOut>(v[k][1], s, c.qmax);
      store_unit<kWide>(q, u, n, w0);
      if (u + 1 < units) store_unit<kWide>(q, u + 1, n, w1);
    }
  }
}

// Launch 1 of a larger tensor: the max |x| bits of each block's units.
template <typename TIn, bool kWide>
__global__ void __launch_bounds__(kThreads)
    requant_amax_kernel(const TIn* __restrict__ x,
                        uint32_t* __restrict__ partial, int64_t n) {
  const int64_t units = (n + kVec - 1) / kVec;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  uint32_t m = 0;
  for (int64_t u = int64_t(blockIdx.x) * kThreads + threadIdx.x; u < units;
       u += kMaxSteps * stride) {
    float v[kMaxSteps][kVec];
#pragma unroll
    for (int k = 0; k < kMaxSteps; ++k)
      if (u + k * stride < units) load_unit<kWide>(x, u + k * stride, n, v[k]);
#pragma unroll
    for (int k = 0; k < kMaxSteps; ++k)
      if (u + k * stride < units) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) m = max(m, abs_bits(v[k][j]));
      }
  }
  m = block_max<kThreads>(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// Launch 2: every block reduces the partials (L2-resident), block 0
// writes the scale, and all cast their units.
template <typename TIn, int kOut, bool kWide>
__global__ void __launch_bounds__(kThreads)
    requant_cast_kernel(const TIn* __restrict__ x,
                        const uint32_t* __restrict__ partial, int n_partial,
                        uint8_t* __restrict__ q, float* __restrict__ scale_out,
                        int64_t n, Scaling c) {
  uint32_t m = 0;
  for (int i = threadIdx.x; i < n_partial; i += kThreads)
    m = max(m, partial[i]);
  const float s = scale_of(block_max<kThreads>(m), c);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;
  const int64_t units = (n + kVec - 1) / kVec;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t u = int64_t(blockIdx.x) * kThreads + threadIdx.x; u < units;
       u += kMaxSteps * stride) {
    float v[kMaxSteps][kVec];
#pragma unroll
    for (int k = 0; k < kMaxSteps; ++k)
      if (u + k * stride < units) load_unit<kWide>(x, u + k * stride, n, v[k]);
#pragma unroll
    for (int k = 0; k < kMaxSteps; ++k)
      if (u + k * stride < units)
        store_unit<kWide>(q, u + k * stride, n,
                          pack_q<kOut>(v[k], s, c.qmax));
  }
}

// ---- launch configuration --------------------------------------------------

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Steps a thread takes over `units` units: one until the grid holds
// kWideGrid blocks, then 2, then 4.
int steps_for(int64_t units) {
  if (units >= kWideGrid * kThreads * 4) return 4;
  if (units >= kWideGrid * kThreads * 2) return 2;
  return 1;
}

// The tiling of [rows, cols] (a per-tensor scale: one row of rows * cols)
// and its grid.  kWide needs rows of whole units (or a single row) and
// aligned pointers; the caller checks.
Tiling tile(int64_t rows, int64_t cols, bool wide, dim3* grid) {
  Tiling t;
  t.rows = rows;
  t.cols = cols;
  t.units = wide ? cols / kVec : cols;
  const int64_t need = t.units > 0 ? t.units : 1;
  int lg = 0;  // threads a row: the power of two that covers its units
  while (lg < 8 && (int64_t(1) << lg) < need) ++lg;
  t.tpr_log2 = lg;
  t.steps = steps_for(rows * need);
  const int64_t span = int64_t(t.steps) << lg;
  const int64_t rows_per_block = kThreads >> lg;
  const int64_t gx = (need + span - 1) / span;
  const int64_t gy = (rows + rows_per_block - 1) / rows_per_block;
  grid->x = static_cast<unsigned>(gx);
  grid->y = static_cast<unsigned>(gy < kMaxGridY ? gy : kMaxGridY);
  grid->z = 1;
  return t;
}

template <typename TIn, int kOut>
int launch_quantize(const void* x, const float* s, int per_row, void* q,
                    int64_t rows, int64_t cols, float qmax, cudaStream_t st) {
  // A per-tensor scale walks the array as one flat row.
  if (!per_row) {
    cols *= rows;
    rows = 1;
  }
  const bool wide = aligned(x, kVec * sizeof(TIn)) && aligned(q, kVec) &&
                    (rows == 1 || cols % kVec == 0);
  dim3 g;
  const Tiling t = tile(rows, cols, wide, &g);
  const TIn* xp = static_cast<const TIn*>(x);
  uint8_t* qp = static_cast<uint8_t*>(q);
  if (wide)
    quantize_kernel<TIn, kOut, true><<<g, kThreads, 0, st>>>(
        xp, s, per_row, qp, t, qmax);
  else
    quantize_kernel<TIn, kOut, false><<<g, kThreads, 0, st>>>(
        xp, s, per_row, qp, t, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn, typename TOut>
int launch_dequantize(const void* q, const float* s, int per_row, void* o,
                      int64_t rows, int64_t cols, cudaStream_t st) {
  if (!per_row) {
    cols *= rows;
    rows = 1;
  }
  const bool wide = aligned(q, kVec) && aligned(o, kVec * sizeof(TOut)) &&
                    (rows == 1 || cols % kVec == 0);
  dim3 g;
  const Tiling t = tile(rows, cols, wide, &g);
  const TIn* qp = static_cast<const TIn*>(q);
  TOut* op = static_cast<TOut*>(o);
  if (wide)
    dequantize_kernel<TIn, TOut, true><<<g, kThreads, 0, st>>>(qp, s, per_row,
                                                               op, t);
  else
    dequantize_kernel<TIn, TOut, false><<<g, kThreads, 0, st>>>(
        qp, s, per_row, op, t);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn, int kOut, bool kWide>
int launch_requantize_w(const TIn* x, uint8_t* q, float* scale_out,
                        uint32_t* partial, int64_t n, Scaling c,
                        cudaStream_t st) {
  if (n <= kOneLaunchMax) {
    requant_block_kernel<TIn, kOut, kWide>
        <<<1, kBlockThreads, 0, st>>>(x, q, scale_out, n, c);
    return static_cast<int>(cudaGetLastError());
  }
  if (partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t units = (n + kVec - 1) / kVec;
  // amax: each thread reads about 16 units (64 elements)
  int64_t ga = (units + int64_t(kThreads) * 16 - 1) / (int64_t(kThreads) * 16);
  ga = ga < kMaxPartials ? ga : kMaxPartials;
  requant_amax_kernel<TIn, kWide>
      <<<static_cast<unsigned>(ga), kThreads, 0, st>>>(x, partial, n);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int steps = steps_for(units);
  const int64_t gc = (units + int64_t(kThreads) * steps - 1) /
                     (int64_t(kThreads) * steps);
  requant_cast_kernel<TIn, kOut, kWide>
      <<<static_cast<unsigned>(gc), kThreads, 0, st>>>(
          x, partial, static_cast<int>(ga), q, scale_out, n, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn, int kOut>
int launch_requantize(const void* x, void* q, float* scale_out,
                      uint32_t* partial, int64_t n, Scaling c,
                      cudaStream_t st) {
  const TIn* xp = static_cast<const TIn*>(x);
  uint8_t* qp = static_cast<uint8_t*>(q);
  if (aligned(x, kVec * sizeof(TIn)) && aligned(q, kVec))
    return launch_requantize_w<TIn, kOut, true>(xp, qp, scale_out, partial, n,
                                                c, st);
  return launch_requantize_w<TIn, kOut, false>(xp, qp, scale_out, partial, n,
                                               c, st);
}

template <typename TIn>
int dispatch_quantize(int out, const void* x, const float* s, int per_row,
                      void* q, int64_t rows, int64_t cols, float qmax,
                      cudaStream_t st) {
  if (out == kE4M3)
    return launch_quantize<TIn, kE4M3>(x, s, per_row, q, rows, cols, qmax, st);
  if (out == kE5M2)
    return launch_quantize<TIn, kE5M2>(x, s, per_row, q, rows, cols, qmax, st);
  if (out == kI8)
    return launch_quantize<TIn, kI8>(x, s, per_row, q, rows, cols, qmax, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TIn>
int dispatch_dequantize(int out, const void* q, const float* s, int per_row,
                        void* o, int64_t rows, int64_t cols,
                        cudaStream_t st) {
  if (out == kF32)
    return launch_dequantize<TIn, float>(q, s, per_row, o, rows, cols, st);
  if (out == kBF16)
    return launch_dequantize<TIn, __nv_bfloat16>(q, s, per_row, o, rows, cols,
                                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TIn>
int dispatch_requantize(int out, const void* x, void* q, float* scale_out,
                        uint32_t* partial, int64_t n, Scaling c,
                        cudaStream_t st) {
  if (out == kE4M3)
    return launch_requantize<TIn, kE4M3>(x, q, scale_out, partial, n, c, st);
  if (out == kE5M2)
    return launch_requantize<TIn, kE5M2>(x, q, scale_out, partial, n, c, st);
  if (out == kI8)
    return launch_requantize<TIn, kI8>(x, q, scale_out, partial, n, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// in_dtype: 0 = float32, 1 = bfloat16; out_dtype: 2 = e4m3, 3 = e5m2, 4 = int8.
// s: f32 [rows] scales when per_row, else one f32 device scalar.
int q_quantize(int in_dtype, int out_dtype, const void* x, const void* s,
               int per_row, void* q, int64_t rows, int64_t cols, float qmax,
               void* stream) {
  if (rows < 0 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows * cols == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  if (in_dtype == kF32)
    return dispatch_quantize<float>(out_dtype, x, sp, per_row, q, rows, cols,
                                    qmax, st);
  if (in_dtype == kBF16)
    return dispatch_quantize<__nv_bfloat16>(out_dtype, x, sp, per_row, q, rows,
                                            cols, qmax, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// in_dtype: 2 = e4m3, 3 = e5m2, 4 = int8; out_dtype: 0 = float32, 1 = bfloat16.
int q_dequantize(int in_dtype, int out_dtype, const void* q, const void* s,
                 int per_row, void* out, int64_t rows, int64_t cols,
                 void* stream) {
  if (rows < 0 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows * cols == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  if (in_dtype == kE4M3)
    return dispatch_dequantize<__nv_fp8_e4m3>(out_dtype, q, sp, per_row, out,
                                              rows, cols, st);
  if (in_dtype == kE5M2)
    return dispatch_dequantize<__nv_fp8_e5m2>(out_dtype, q, sp, per_row, out,
                                              rows, cols, st);
  if (in_dtype == kI8)
    return dispatch_dequantize<int8_t>(out_dtype, q, sp, per_row, out, rows,
                                       cols, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The per-tensor requantize of n elements of x (dense, any layout: the
// kernels walk its storage flat): q and the f32 scalar scale_out.
// partial: q_requantize_max_partials() uint32 of scratch, needed (and
// only read or written) when n > q_requantize_one_launch_max().
int q_requantize(int in_dtype, int out_dtype, const void* x, void* q,
                 void* scale_out, void* partial, int64_t n, float qmax,
                 float margin, float eps, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scaling c{qmax, margin, eps};
  float* so = static_cast<float*>(scale_out);
  uint32_t* pp = static_cast<uint32_t*>(partial);
  if (in_dtype == kF32)
    return dispatch_requantize<float>(out_dtype, x, q, so, pp, n, c, st);
  if (in_dtype == kBF16)
    return dispatch_requantize<__nv_bfloat16>(out_dtype, x, q, so, pp, n, c,
                                              st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int64_t q_requantize_one_launch_max() { return kOneLaunchMax; }
int64_t q_requantize_max_partials() { return kMaxPartials; }

const char* q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
