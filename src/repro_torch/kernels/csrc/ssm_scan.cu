// Hand-written Hopper (sm_90a) chunked linear-recurrence scan.
//
// Port of the Pallas TPU kernel src/repro/kernels/ssm_scan.py
// (_scan_kernel / linear_scan_pallas): the token mixing of RWKV-6 and
// Mamba-2,
//   S_t = diag(d_t) S_{t-1} + k_t^T v_t          (state [dk, dv], f32)
//   o_t = q_t (diag(a_t) S_{t-1} + diag(g_t) k_t^T v_t)
// with mode ssd (a = d, g = 1) or rwkv6 (a = 1, g = u, the bonus on the
// current token).  The semantics are the reference's chunked form, term
// for term, in f32 whatever the operand type:
//   * per chunk of C tokens, lc = the in-chunk inclusive cumulative sum
//     of the log-decay per channel (summed in token order);
//     ex = lc (ssd) or lc - log_decay (rwkv6);
//   * q_t = q * exp(ex), k_t = k * exp(-lc): the reference's factorization,
//     kept so that the kernel agrees with it wherever it is finite (it
//     overflows f32 where lc drops below about -88.7 in a chunk, as the
//     reference's does);
//   * att = q_t k_t^T, masked to j < i (rwkv6, plus sum(q * u * k) on the
//     diagonal) or j <= i (ssd); o = att v + q_t S (two sums, then added);
//   * S = S * exp(lc[C-1]) + (k * exp(lc[C-1] - lc))^T v.
// IEEE expf (the build uses no fast-math), f32 accumulation throughout.
//
// What it does not copy is the TPU grid: there the chunk axis is a
// sequential grid dimension carrying S in VMEM scratch; here one thread
// block owns one batch*head stream and walks its chunks in order, and S
// stays in shared memory for the whole sequence, never in device memory
// (it is written once, at the end, as the final state).
//
// Bound on the H100: at the rwkv6_7b training shape (BH 512, T 128,
// dk = dv = 64, bf16 q/k/v/o, f32 log-decay, u and state) the function
// moves each input and output once, about 59 MB, and does about 2.2 GFLOP
// (two causal C x C x 64 products and two C x 64 x 64 products per
// chunk): some 36 FLOPs per byte, under the card's ridge, so it is bound
// by bytes (about 17.6 us at 3.35 TB/s).
// Design: SIMT and simple first.  Per chunk the block stages the
// log-decay (turned into lc in place, then into q_t), k_t, the state's
// k * exp(lc_last - lc) and v as f32 in shared memory (rows padded by one
// float against bank conflicts), then computes att in tiles of R rows
// (R chosen by the wrapper so that the footprint, smem_floats below,
// fits the 227 KB a block may use: R = C at dk = dv = 64 and C = 128,
// R = 64 at zamba2's dv = 112) and each tile's outputs, then the state
// update.  Every product runs on a 16 x 16 thread grid, each thread
// holding a 4 x 4 register tile.  Tensor cores (mma/wgmma), TMA and double
// buffering of the next chunk are later work.
//
// Plain C interface (loaded with ctypes): the launch goes to the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTG = 16;               // thread grid side
constexpr int kThreads = kTG * kTG;   // 256
constexpr int kMT = 4;                // register tile side
constexpr int kTile = kTG * kMT;      // 64: rows/cols one pass covers
constexpr long long kSmemBudget = 232448;  // bytes a block may use (H100)

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

// Floats of dynamic shared memory for chunk C, head dims dk/dv and att
// tiles of R rows.  The wrapper's footprint rule
// (ssm_scan.scan_smem_bytes) is the same formula.
__host__ __device__ inline long long smem_floats(int C, int dk, int dv,
                                                 int R) {
  return 3LL * C * (dk + 1)           // lc -> q_t, k_t, k_s (padded rows)
         + (long long)C * dv          // v
         + (long long)dk * dv         // the state S
         + (long long)R * (C + 1)     // one tile of att rows (padded)
         + C                          // rwkv6 diagonal
         + dk;                        // lc of the chunk's last token
}

// acc[a][b] += sum_k X(m, k) * Y(n, k) for m = m0 + ty + 16 a and
// n = n0 + tx + 16 b, with X(m, k) = X[m * xm + k * xk] and Y(n, k) =
// Y[n * yn + k * yk].  Rows past M (columns past N) read row M - 1
// (column N - 1); the caller drops those outputs.
__device__ __forceinline__ void tile_mm(float (&acc)[kMT][kMT],
                                        const float* X, int xm, int xk,
                                        int M, const float* Y, int yn,
                                        int yk, int N, int K, int m0,
                                        int n0) {
  const int tx = threadIdx.x % kTG, ty = threadIdx.x / kTG;
  const float* xp[kMT];
  const float* yp[kMT];
#pragma unroll
  for (int a = 0; a < kMT; ++a)
    xp[a] = X + (size_t)min(m0 + ty + kTG * a, M - 1) * xm;
#pragma unroll
  for (int b = 0; b < kMT; ++b)
    yp[b] = Y + (size_t)min(n0 + tx + kTG * b, N - 1) * yn;
  for (int k = 0; k < K; ++k) {
    float xr[kMT], yr[kMT];
#pragma unroll
    for (int a = 0; a < kMT; ++a) xr[a] = xp[a][k * xk];
#pragma unroll
    for (int b = 0; b < kMT; ++b) yr[b] = yp[b][k * yk];
#pragma unroll
    for (int a = 0; a < kMT; ++a)
#pragma unroll
      for (int b = 0; b < kMT; ++b) acc[a][b] = fmaf(xr[a], yr[b], acc[a][b]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ ld,
                const float* __restrict__ u, T* __restrict__ out,
                float* __restrict__ state_out, int Tn, int dk, int dv, int C,
                int R, int ssd) {
  extern __shared__ float smem[];
  const int dkp = dk + 1, ap = C + 1;
  float* qt = smem;             // [C][dkp]: lc, then q * exp(ex)
  float* kt = qt + C * dkp;     // [C][dkp]: k * exp(-lc)
  float* ks = kt + C * dkp;     // [C][dkp]: k * exp(lc_last - lc)
  float* vs = ks + C * dkp;     // [C][dv]
  float* S = vs + C * dv;       // [dk][dv]
  float* att = S + dk * dv;     // [R][ap]
  float* diag = att + R * ap;   // [C]
  float* lcl = diag + C;        // [dk]

  const int tid = threadIdx.x;
  const int tx = tid % kTG, ty = tid / kTG;
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * Tn * dk;
  const T* kb = k + bh * Tn * dk;
  const T* vb = v + bh * Tn * dv;
  const float* ldb = ld + bh * Tn * dk;
  const float* ub = u + bh * dk;
  T* ob = out + bh * Tn * dv;

  for (int e = tid; e < dk * dv; e += kThreads) S[e] = 0.f;

  for (int c0 = 0; c0 < Tn; c0 += C) {
    // Stage the chunk's log-decay and v.
    for (int e = tid; e < C * dk; e += kThreads)
      qt[(e / dk) * dkp + e % dk] = ldb[(size_t)c0 * dk + e];
    for (int e = tid; e < C * dv; e += kThreads)
      vs[e] = to_f(vb[(size_t)c0 * dv + e]);
    __syncthreads();
    // lc: inclusive cumulative sum over the chunk, per channel.
    for (int d = tid; d < dk; d += kThreads) {
      float s = 0.f;
      for (int i = 0; i < C; ++i) {
        s += qt[i * dkp + d];
        qt[i * dkp + d] = s;
      }
      lcl[d] = s;
    }
    __syncthreads();
    // The decay factored into q and k.
    for (int e = tid; e < C * dk; e += kThreads) {
      const int i = e / dk, d = e % dk;
      const size_t g = (size_t)c0 * dk + e;
      const float lc = qt[i * dkp + d];
      const float ex = ssd ? lc : lc - ldb[g];
      const float kv = to_f(kb[g]);
      qt[i * dkp + d] = to_f(qb[g]) * expf(ex);
      kt[i * dkp + d] = kv * expf(-lc);
      ks[i * dkp + d] = kv * expf(lcl[d] - lc);
    }
    if (!ssd) {
      for (int i = tid; i < C; i += kThreads) {
        const size_t g = (size_t)(c0 + i) * dk;
        float s = 0.f;
        for (int d = 0; d < dk; ++d)
          s += to_f(qb[g + d]) * ub[d] * to_f(kb[g + d]);
        diag[i] = s;
      }
    }
    __syncthreads();

    // Outputs, R rows at a time.
    for (int r0 = 0; r0 < C; r0 += R) {
      const int rows = min(R, C - r0), cols = r0 + rows;
      const float* qr = qt + r0 * dkp;
      for (int m0 = 0; m0 < rows; m0 += kTile)
        for (int n0 = 0; n0 < cols; n0 += kTile) {
          float acc[kMT][kMT] = {};
          tile_mm(acc, qr, dkp, 1, rows, kt, dkp, 1, cols, dk, m0, n0);
#pragma unroll
          for (int a = 0; a < kMT; ++a)
#pragma unroll
            for (int b = 0; b < kMT; ++b) {
              const int r = m0 + ty + kTG * a, j = n0 + tx + kTG * b;
              if (r >= rows || j >= cols) continue;
              const int i = r0 + r;
              float val = (j < i || (ssd && j == i)) ? acc[a][b] : 0.f;
              if (!ssd && j == i) val = diag[i];
              att[r * ap + j] = val;
            }
        }
      __syncthreads();
      for (int m0 = 0; m0 < rows; m0 += kTile)
        for (int n0 = 0; n0 < dv; n0 += kTile) {
          float av[kMT][kMT] = {}, qs[kMT][kMT] = {};
          tile_mm(av, att, ap, 1, rows, vs, 1, dv, dv, cols, m0, n0);
          tile_mm(qs, qr, dkp, 1, rows, S, 1, dv, dv, dk, m0, n0);
#pragma unroll
          for (int a = 0; a < kMT; ++a)
#pragma unroll
            for (int b = 0; b < kMT; ++b) {
              const int r = m0 + ty + kTG * a, e = n0 + tx + kTG * b;
              if (r < rows && e < dv)
                ob[(size_t)(c0 + r0 + r) * dv + e] =
                    from_f<T>(av[a][b] + qs[a][b]);
            }
        }
      __syncthreads();
    }

    // State update; each element is read and written by one thread.
    for (int m0 = 0; m0 < dk; m0 += kTile)
      for (int n0 = 0; n0 < dv; n0 += kTile) {
        float acc[kMT][kMT] = {};
        tile_mm(acc, ks, 1, dkp, dk, vs, 1, dv, dv, C, m0, n0);
#pragma unroll
        for (int a = 0; a < kMT; ++a)
#pragma unroll
          for (int b = 0; b < kMT; ++b) {
            const int d = m0 + ty + kTG * a, e = n0 + tx + kTG * b;
            if (d < dk && e < dv)
              S[d * dv + e] = S[d * dv + e] * expf(lcl[d]) + acc[a][b];
          }
      }
    __syncthreads();
  }
  for (int e = tid; e < dk * dv; e += kThreads)
    state_out[bh * dk * dv + e] = S[e];
}

template <typename T>
int launch_scan(int ssd, const void* q, const void* k, const void* v,
                const void* ld, const void* u, void* out, void* state,
                int BH, int Tn, int dk, int dv, int C, int R,
                cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const size_t smem = (size_t)smem_floats(C, dk, dv, R) * sizeof(float);
  scan_kernel<T><<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ld),
      static_cast<const float*>(u), static_cast<T*>(out),
      static_cast<float*>(state), Tn, dk, dv, C, R, ssd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of shared memory one block uses (see smem_floats).
long long ss_smem_bytes(int chunk, int dk, int dv, int rows) {
  return smem_floats(chunk, dk, dv, rows) * (long long)sizeof(float);
}

long long ss_smem_budget(void) { return kSmemBudget; }

// dtype (of q, k, v and out): 0 = float32, 1 = bfloat16.  mode: 0 = ssd,
// 1 = rwkv6 (u is read only then).  log-decay, u and the state are f32.
// T must be a multiple of chunk; rows (att rows per tile) in 1..chunk
// with the footprint within the budget.
int ss_scan(int dtype, int mode, const void* q, const void* k, const void* v,
            const void* ld, const void* u, void* out, void* state, int BH,
            int Tn, int dk, int dv, int chunk, int rows, void* stream) {
  if (BH < 1 || Tn < 1 || dk < 1 || dv < 1 ||
      chunk < 1 || Tn % chunk != 0 || rows < 1 || rows > chunk ||
      (mode != 0 && mode != 1) ||
      ss_smem_bytes(chunk, dk, dv, rows) > kSmemBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ssd = mode == 0;
  if (dtype == 0)
    return launch_scan<float>(ssd, q, k, v, ld, u, out, state, BH, Tn, dk,
                              dv, chunk, rows, s);
  if (dtype == 1)
    return launch_scan<__nv_bfloat16>(ssd, q, k, v, ld, u, out, state, BH,
                                      Tn, dk, dv, chunk, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
