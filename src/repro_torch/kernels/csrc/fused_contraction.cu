// Hand-written Hopper (sm_90a) kernels for the tensor-contraction hot spots.
//
// Port of the two Pallas TPU kernels of src/repro/kernels/fused_contraction.py
// that the serving path reaches:
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
//
// * chain_kernel replaces _chain_n_kernel / chain_n_pallas (non-quantized):
//   Y = (((X @ W1) -> regroup -> @ W2) ... @ Wn).  One block owns a band of
//   final output rows and runs every link with the intermediate in shared
//   memory; the regroup [r, n_i] -> [r/g, g*n_i] is pure index arithmetic on
//   that contiguous buffer ("tensor shaping during computation"), so no
//   padding of n_i is needed.  Intermediates are accumulated in f32 and
//   rounded to the operand type before the next link, like the reference.
//   All weights stay resident in shared memory; X streams from device memory
//   into link 0 (its [band * mult0, k] block can exceed shared memory, e.g.
//   2048 x 192 bf16 = 786 KB).  Bound: device-memory bytes of X and Y; the
//   intermediates never leave the chip.  The wrapper picks the band height
//   so weights + intermediates fit the 227 KB per-block budget and refuses
//   (ChainLoweringError) what does not fit.
//
// Plain C interface (loaded with ctypes): every launch goes to the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxLinks = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory one block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

template <typename T, bool kTransRhs>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int M, int N, int K) {
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
      if (gn < N) out[(size_t)gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_gemm(int trans, const void* x, const void* w, void* out, int M,
                int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (trans)
    gemm_kernel<T, true><<<grid, kGemmThreads, 0, stream>>>(xp, wp, op, M, N,
                                                            K);
  else
    gemm_kernel<T, false><<<grid, kGemmThreads, 0, stream>>>(xp, wp, op, M,
                                                             N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// N-link chain with on-chip intermediates and in-place regrouping
// ---------------------------------------------------------------------------

struct ChainArgs {
  const void* w[kMaxLinks];  // W_i, row-major [k_i, n_i]
  int k[kMaxLinks];
  int n[kMaxLinks];
  int mult[kMaxLinks];   // link i's rows per final output row
  int w_off[kMaxLinks];  // float offset of W_i in shared memory
  int buf_off[2];        // float offsets of the ping-pong intermediates
  int links;
  int m_final;  // final output rows
  int band;     // final output rows per block
};

template <typename T>
__global__ void chain_kernel(const T* __restrict__ x, T* __restrict__ out,
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
      if (last)
        out[((size_t)f0 + r) * n + c] = from_f<T>(acc);
      else
        dst[o] = to_f(from_f<T>(acc));  // round to the operand type
    }
    __syncthreads();
  }
}

template <typename T>
int launch_chain(const void* x, const void* const* ws, const int* ks,
                 const int* ns, const int* mults, int links, int m_final,
                 int band, int threads, void* out, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  ChainArgs a{};
  int off = 0, max_mid = 0;
  for (int i = 0; i < links; ++i) {
    a.w[i] = ws[i];
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
  chain_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int fc_matmul(int dtype, int trans, const void* x, const void* w, void* out,
              int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gemm<float>(trans, x, w, out, M, N, K, s);
  if (dtype == 1)
    return launch_gemm<__nv_bfloat16>(trans, x, w, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int fc_chain(int dtype, const void* x, const void* const* ws, const int* ks,
             const int* ns, const int* mults, int links, int m_final, int band,
             int threads, void* out, void* stream) {
  if (links < 2 || links > kMaxLinks || band < 1 || threads < 32 ||
      threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_chain<float>(x, ws, ks, ns, mults, links, m_final, band,
                               threads, out, s);
  if (dtype == 1)
    return launch_chain<__nv_bfloat16>(x, ws, ks, ns, mults, links, m_final,
                                       band, threads, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int fc_max_links(void) { return kMaxLinks; }

const char* fc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
