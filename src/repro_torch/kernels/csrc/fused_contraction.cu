// Hand-written Hopper (sm_90a) kernels for the tensor-contraction hot spots.
//
// Port of the Pallas TPU kernels of src/repro/kernels/fused_contraction.py:
//
// * gemm_kernel replaces _matmul_kernel / matmul_pallas: C[M,N] = X[M,K] @ W
//   with W stored [K,N] or [N,K] ("transpose_rhs").  The [N,K] tile is
//   transposed while it is staged into shared memory, never in device
//   memory: FETTA's "layout reordering during computation".  f32
//   accumulation, K innermost, output rounded to the operand type.
//   Bound on the H100: on the serving path K = 8, so one product does
//   2*K = 16 FLOPs per output element written; the kernel is bound by the
//   bytes of C (and X, W) it moves.  Design: SIMT, one 64x64 output tile per
//   256-thread block, 4x4 outputs per thread with stride-16 rows/columns so
//   each warp writes contiguous runs of C.  K = 8 is below one bf16 mma
//   k-step (16), so tensor cores, wgmma and TMA are left to a later PR.
//   Its scaled form replaces _matmul_scaled_kernel (matmul_pallas with
//   scales=): fp8 e4m3/e5m2 or int8 operands are upcast to f32 (exactly) as
//   they are staged into the same tiles, and the epilogue writes
//   (acc * sl[row]) * sr[col] in f32: the dequantization never takes its
//   own pass over device memory.  Operands are 1 byte, the output 4, so
//   the scaled GEMM is bound by the bytes of C as well.  fp8 wgmma needs
//   K >= 32; the ATIS plans' K = 8 is below it, so this stays SIMT.
//
// * chain_kernel replaces _chain_n_kernel / chain_n_pallas:
//   Y = (((X @ W1) -> regroup -> @ W2) ... @ Wn).  One block owns a band of
//   final output rows and runs every link with the intermediate in shared
//   memory; the regroup [r, n_i] -> [r/g, g*n_i] is pure index arithmetic on
//   that contiguous buffer ("tensor shaping during computation"), so no
//   padding of n_i is needed.  Intermediates are accumulated in f32 and
//   rounded to the operand type before the next link, like the reference.
//   All weights stay resident in shared memory as f32; X streams from
//   device memory into link 0 (its [band * mult0, k] block can exceed shared
//   memory, e.g. 2048 x 192 bf16 = 786 KB).  Bound: device-memory bytes of
//   X and Y; the intermediates never leave the chip.  The wrapper picks the
//   band height so weights + intermediates fit the 227 KB per-block budget
//   and refuses (ChainLoweringError) what does not fit.
//   Its scaled form replaces the quantized branch of _chain_n_kernel: X
//   and W in fp8/int8 (staged to f32 exactly, which equals the reference's
//   bf16 cast of the interior weights), link 0 scaled per link-0 row by
//   s_first, interior links by one scalar each, the last link per output
//   column by s_last; every intermediate is rounded to bf16 (the
//   reference's VMEM intermediate type) after its scale, and Y is f32.
//   The weights stay f32 in shared memory, so the budget is the same as
//   the unscaled chain's: a chain fused at compile time is never refused
//   at run time for being quantized.
//
// Plain C interface (loaded with ctypes): every launch goes to the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxLinks = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory one block may use

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

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// ---------------------------------------------------------------------------
// GEMM with the rhs transpose fused into the shared-memory stage
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

// TOut is T for the plain GEMM; the scaled form (kScaled) reads fp8/int8
// T, writes f32 and multiplies by sl[row] and sr[col] in its epilogue.
template <typename T, typename TOut, bool kTransRhs, bool kScaled>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ sl, const float* __restrict__ sr,
                TOut* __restrict__ out, int M, int N, int K) {
  __shared__ float xs[kBK][kBM + 1];  // X tile, k-major
  __shared__ float ws[kBK][kBN + 1];  // W tile as [k][n] whatever its layout
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      const int m = e / kBK, kk = e % kBK;
      const int gm = row0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kGemmThreads) {
      if (kTransRhs) {  // W stored [N, K]: read along k, store as [k][n]
        const int n = e / kBK, kk = e % kBK;
        const int gn = col0 + n, gk = k0 + kk;
        ws[kk][n] = (gn < N && gk < K) ? to_f(w[(size_t)gn * K + gk]) : 0.f;
      } else {  // W stored [K, N]
        const int kk = e / kBN, n = e % kBN;
        const int gn = col0 + n, gk = k0 + kk;
        ws[kk][n] = (gn < N && gk < K) ? to_f(w[(size_t)gk * N + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (kScaled) v = __fmul_rn(__fmul_rn(v, sl[gm]), sr[gn]);
      out[(size_t)gm * N + gn] = from_f<TOut>(v);
    }
  }
}

template <typename T, typename TOut, bool kScaled>
int launch_gemm(int trans, const void* x, const void* w, const float* sl,
                const float* sr, void* out, int M, int N, int K,
                cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  TOut* op = static_cast<TOut*>(out);
  if (trans)
    gemm_kernel<T, TOut, true, kScaled><<<grid, kGemmThreads, 0, stream>>>(
        xp, wp, sl, sr, op, M, N, K);
  else
    gemm_kernel<T, TOut, false, kScaled><<<grid, kGemmThreads, 0, stream>>>(
        xp, wp, sl, sr, op, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// N-link chain with on-chip intermediates and in-place regrouping
// ---------------------------------------------------------------------------

struct ChainArgs {
  const void* w[kMaxLinks];  // W_i, row-major [k_i, n_i]
  // Scaled chain only: link 0's scale per link-0 row, one scalar per
  // interior link, the last link's scale per output column.
  const float* s[kMaxLinks];
  int k[kMaxLinks];
  int n[kMaxLinks];
  int mult[kMaxLinks];   // link i's rows per final output row
  int w_off[kMaxLinks];  // float offset of W_i in shared memory
  int buf_off[2];        // float offsets of the ping-pong intermediates
  int links;
  int m_final;  // final output rows
  int band;     // final output rows per block
};

// T: the type of X and every W.  TH: the type each intermediate is rounded
// to before the next link reads it.  TOut: the type of Y.  The plain chain
// is <T, T, T, false>; the scaled one <fp8|int8, bf16, float, true>.
template <typename T, typename TH, typename TOut, bool kScaled>
__global__ void chain_kernel(const T* __restrict__ x, TOut* __restrict__ out,
                             ChainArgs a) {
  extern __shared__ float smem[];
  for (int i = 0; i < a.links; ++i) {
    const T* w = static_cast<const T*>(a.w[i]);
    float* dst = smem + a.w_off[i];
    const int cnt = a.k[i] * a.n[i];
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) dst[e] = to_f(w[e]);
  }
  __syncthreads();

  const int f0 = blockIdx.x * a.band;  // first final row of this band
  const int rows_final = min(a.band, a.m_final - f0);
  const T* xband = x + (size_t)f0 * a.mult[0] * a.k[0];
  for (int i = 0; i < a.links; ++i) {
    const int k = a.k[i], n = a.n[i];
    const int rows = rows_final * a.mult[i];
    const float* wsm = smem + a.w_off[i];
    // Link i-1 wrote buf[(i-1) & 1] == buf[(i+1) & 1]; link i writes buf[i & 1].
    const float* src = smem + a.buf_off[(i + 1) & 1];
    float* dst = smem + a.buf_off[i & 1];
    const bool last = (i == a.links - 1);
    for (int o = threadIdx.x; o < rows * n; o += blockDim.x) {
      const int r = o / n, c = o - r * n;
      float acc = 0.f;
      if (i == 0) {
        const T* xr = xband + (size_t)r * k;
        for (int kk = 0; kk < k; ++kk)
          acc = fmaf(to_f(xr[kk]), wsm[kk * n + c], acc);
      } else {
        // The regroup: row r of the [rows, k] view of the contiguous
        // [rows_prev, n_prev] intermediate of this band.
        const float* hr = src + (size_t)r * k;
        for (int kk = 0; kk < k; ++kk) acc = fmaf(hr[kk], wsm[kk * n + c], acc);
      }
      if (kScaled) {
        const float sc = i == 0 ? a.s[0][((size_t)f0 * a.mult[0]) + r]
                                : (last ? a.s[i][c] : a.s[i][0]);
        acc = __fmul_rn(acc, sc);
      }
      if (last)
        out[((size_t)f0 + r) * n + c] = from_f<TOut>(acc);
      else
        dst[o] = to_f(from_f<TH>(acc));  // round to the intermediate type
    }
    __syncthreads();
  }
}

template <typename T, typename TH, typename TOut, bool kScaled>
int launch_chain(const void* x, const void* const* ws,
                 const float* const* scales, const int* ks, const int* ns,
                 const int* mults, int links, int m_final, int band,
                 int threads, void* out, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_kernel<T, TH, TOut, kScaled>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  ChainArgs a{};
  int off = 0, max_mid = 0;
  for (int i = 0; i < links; ++i) {
    a.w[i] = ws[i];
    a.s[i] = kScaled ? scales[i] : nullptr;
    a.k[i] = ks[i];
    a.n[i] = ns[i];
    a.mult[i] = mults[i];
    a.w_off[i] = off;
    off += ks[i] * ns[i];
    if (i < links - 1 && mults[i] * ns[i] > max_mid) max_mid = mults[i] * ns[i];
  }
  a.buf_off[0] = off;
  off += band * max_mid;
  a.buf_off[1] = a.buf_off[0];
  if (links > 2) {
    a.buf_off[1] = off;
    off += band * max_mid;
  }
  a.links = links;
  a.m_final = m_final;
  a.band = band;
  const size_t smem = (size_t)off * sizeof(float);
  if (smem > (size_t)kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (m_final + band - 1) / band;
  chain_kernel<T, TH, TOut, kScaled><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<TOut*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes (shared with kernels/quantized.cu): 0 = float32,
// 1 = bfloat16, 2 = fp8 e4m3, 3 = fp8 e5m2, 4 = int8.
int fc_matmul(int dtype, int trans, const void* x, const void* w, void* out,
              int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gemm<float, float, false>(trans, x, w, nullptr, nullptr,
                                            out, M, N, K, s);
  if (dtype == 1)
    return launch_gemm<__nv_bfloat16, __nv_bfloat16, false>(
        trans, x, w, nullptr, nullptr, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C[M, N] = (Xq @ Wq) * sl[M] * sr[N] in f32; dtype 2, 3 or 4.
int fc_matmul_scaled(int dtype, int trans, const void* x, const void* w,
                     const void* sl, const void* sr, void* out, int M, int N,
                     int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(sl);
  const float* r = static_cast<const float*>(sr);
  if (dtype == 2)
    return launch_gemm<__nv_fp8_e4m3, float, true>(trans, x, w, l, r, out, M,
                                                   N, K, s);
  if (dtype == 3)
    return launch_gemm<__nv_fp8_e5m2, float, true>(trans, x, w, l, r, out, M,
                                                   N, K, s);
  if (dtype == 4)
    return launch_gemm<int8_t, float, true>(trans, x, w, l, r, out, M, N, K,
                                            s);
  return static_cast<int>(cudaErrorInvalidValue);
}

static bool chain_args_ok(int links, int band, int threads) {
  return links >= 2 && links <= kMaxLinks && band >= 1 && threads >= 32 &&
         threads <= 1024;
}

int fc_chain(int dtype, const void* x, const void* const* ws, const int* ks,
             const int* ns, const int* mults, int links, int m_final, int band,
             int threads, void* out, void* stream) {
  if (!chain_args_ok(links, band, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_chain<float, float, float, false>(
        x, ws, nullptr, ks, ns, mults, links, m_final, band, threads, out, s);
  if (dtype == 1)
    return launch_chain<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, false>(
        x, ws, nullptr, ks, ns, mults, links, m_final, band, threads, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scaled chain: X and W in dtype 2, 3 or 4, bf16 intermediates, f32 Y;
// scales[i] as ChainArgs::s.
int fc_chain_scaled(int dtype, const void* x, const void* const* ws,
                    const void* const* scales, const int* ks, const int* ns,
                    const int* mults, int links, int m_final, int band,
                    int threads, void* out, void* stream) {
  if (!chain_args_ok(links, band, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const* sc = reinterpret_cast<const float* const*>(scales);
  if (dtype == 2)
    return launch_chain<__nv_fp8_e4m3, __nv_bfloat16, float, true>(
        x, ws, sc, ks, ns, mults, links, m_final, band, threads, out, s);
  if (dtype == 3)
    return launch_chain<__nv_fp8_e5m2, __nv_bfloat16, float, true>(
        x, ws, sc, ks, ns, mults, links, m_final, band, threads, out, s);
  if (dtype == 4)
    return launch_chain<int8_t, __nv_bfloat16, float, true>(
        x, ws, sc, ks, ns, mults, links, m_final, band, threads, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int fc_max_links(void) { return kMaxLinks; }

const char* fc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
