// Hand-written Hopper (sm_90a) flash-attention forward.
//
// Port of the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention_fwd): GQA attention with an online
// softmax, returning out [B, Tq, H, D] in the operand type and the
// log-sum-exp lse [B, Tq, KV, G] in f32 (the stats the backward reads).
// The semantics are the reference's, term for term:
//   * scores s = (q . k) * scale in f32;
//   * the causal mask writes -1e30 (not -inf) where q_pos < k_pos;
//   * per row, a running max m (start -1e30) and denominator l; for each
//     kv chunk m_new = max(m, rowmax(s)), p = exp(s - m_new),
//     corr = exp(m - m_new), l = l * corr + sum(p) over the UNROUNDED p,
//     acc = acc * corr + round_to_v_type(p) . v;
//   * out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30));
//   * query head h reads KV head h / G; lse is KV-major (h = kv * G + g),
//     which makes it the flat [B, Tq, H] array.
// What it does not copy is the TPU grid: there the kv axis is a
// sequential grid dimension carrying m/l/acc in VMEM scratch; here one
// thread block owns one (batch, head, 32-row q tile) and loops over the
// kv chunks itself, ascending.  The online-softmax step is the caller's
// kv chunk (up to 1024 keys), as in the reference, so p is rounded against
// the same running max: the block stages the chunk's keys 64 at a time,
// writes the chunk's whole score rows to shared memory, takes the row
// statistics once per chunk, then stages the chunk's values 64 at a time
// for the PV product.  Under the causal mask it stops at the key of the
// tile's last query position: later keys are masked for every row of the
// tile, where p = 0 exactly (the running max is finite from key 0 on), so
// the numbers are the ones a full sweep gives.
//
// Bound on the H100: at the training shape (B 8, T 128, H 12, D 64) the
// function moves q, k, v and out once (1.57 MB each in bf16) and does
// 4 * B * H * Tq * Tk * D FLOPs (half of that under the causal mask);
// that is about 32 FLOPs per byte, far under the card's ~295 FLOP/byte
// ridge in bf16, so it is bound by bytes (about 1.9 us at 3.35 TB/s).
// Design: SIMT and simple first.  q and the staged k or v sub-tile are
// held in shared memory as f32 (padded rows, no bank conflicts on the
// strided reads); the 32 x chunk score rows live in shared memory between
// the QK^T product, the row statistics (4 threads per row, warp shuffles)
// and the PV product; the f32 output accumulator stays in registers (4
// rows x 8 head-dim columns a thread).  Tensor cores (mma/wgmma), TMA and
// a ring of double-buffered tiles are later work.
//
// Plain C interface (loaded with ctypes): the launch goes to the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 32;          // query rows per block
constexpr int kBK = 64;          // keys per staged k / v sub-tile
constexpr int kMaxD = 128;       // largest head dim
constexpr int kMaxChunk = 1024;  // largest kv chunk (one online-softmax step)
constexpr int kThreads = 128;    // 8 row groups x 16 column lanes
constexpr int kDJ = kMaxD / 16;

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

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Floats of dynamic shared memory one block uses for head dim D and kv
// chunk kc.
__host__ __device__ inline int smem_floats(int D, int kc) {
  return kBQ * (D + 1)                      // q tile, padded rows
         + kBK * (D + 1)                    // k or v sub-tile, padded rows
         + kBQ * (round_up(kc, kBK) + 1)    // score rows, then rounded p
         + 3 * kBQ;                         // m, l, corr per row
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int H, int KV,
                     int D, int kc, float scale, int causal, int nq) {
  extern __shared__ float smem[];
  const int QS = D + 1, KS = D + 1, PS = round_up(kc, kBK) + 1;
  float* qs = smem;
  float* kvs = qs + kBQ * QS;
  float* ps = kvs + kBK * KS;
  float* m_s = ps + kBQ * PS;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qt = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, Tq - q0);

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qs[r * QS + d] =
        r < rows ? to_f(q[(((size_t)b * Tq + q0 + r) * H + h) * D + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;

  // Causal: keys at or past k_end are masked for every row of this tile.
  int k_end = Tk;
  if (causal) k_end = min(Tk, q0 + rows);
  const int nchunks = (k_end + kc - 1) / kc;

  for (int ch = 0; ch < nchunks; ++ch) {
    const int c0 = ch * kc;
    const int live = min(kc, k_end - c0);  // keys of the chunk to visit
    const int nsub = (live + kBK - 1) / kBK;

    // s = (q . k) * scale over the chunk, masked, one sub-tile at a time.
    for (int st = 0; st < nsub; ++st) {
      const int t0 = st * kBK;  // first key of the sub-tile, chunk-relative
      __syncthreads();          // earlier readers are done with kvs
      for (int e = tid; e < kBK * D; e += kThreads) {
        const int t = e / D, d = e % D;
        kvs[t * KS + d] =
            t0 + t < live
                ? to_f(k[(((size_t)b * Tk + c0 + t0 + t) * KV + kvh) * D + d])
                : 0.f;
      }
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 8 * i) * QS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = kvs[(tx + 16 * j) * KS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + tx + 16 * j;
          float val = s[i][j] * scale;
          if (causal && q0 + r < c0 + t) val = -1e30f;
          if (t >= live) val = -INFINITY;  // not visited: absent, p = 0
          ps[r * PS + t] = val;
        }
      }
    }
    __syncthreads();

    // Row statistics over the chunk: 4 neighbouring lanes per row, each a
    // quarter of the visited columns.
    {
      const int r = tid / 4, sub = tid % 4;
      const int seg = nsub * kBK / 4;
      float* prow = ps + r * PS + sub * seg;
      float mx = -INFINITY;
      for (int t = 0; t < seg; ++t) mx = fmaxf(mx, prow[t]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < seg; ++t) {
        const float p = expf(prow[t] - m_new);
        sum += p;
        prow[t] = to_f(from_f<T>(p));  // p rounded to v's type for PV
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sub == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }

    // acc = acc * corr + p . v, the chunk's values one sub-tile at a time.
    float pv[4][kDJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDJ; ++j) pv[i][j] = 0.f;
    for (int st = 0; st < nsub; ++st) {
      const int t0 = st * kBK;
      __syncthreads();  // scores / p and the previous sub-tile are settled
      for (int e = tid; e < kBK * D; e += kThreads) {
        const int t = e / D, d = e % D;
        kvs[t * KS + d] =
            t0 + t < live
                ? to_f(v[(((size_t)b * Tk + c0 + t0 + t) * KV + kvh) * D + d])
                : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 8 * i) * PS + t0 + kk];
#pragma unroll
        for (int j = 0; j < kDJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float vv = kvs[kk * KS + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i][j] = fmaf(a[i], vv, pv[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] = acc[i][j] * corr + pv[i][j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    if (r >= rows) continue;
    const float l_safe = fmaxf(l_s[r], 1e-30f);
    T* orow = out + (((size_t)b * Tq + q0 + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f<T>(acc[i][j] / l_safe);
    }
  }
  if (tid < rows)
    lse[((size_t)b * Tq + q0 + tid) * H + h] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 void* lse, int B, int Tq, int Tk, int H, int KV, int D,
                 int kc, float scale, int causal, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(kMaxD, kMaxChunk) * (int)sizeof(float));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int nq = (Tq + kBQ - 1) / kBQ;
  const long long blocks = (long long)nq * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)smem_floats(D, kc) * sizeof(float);
  flash_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Tq, Tk, H, KV, D, kc, scale, causal, nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  kv_chunk: keys per online-softmax
// step, 1..kMaxChunk.
int fa_forward(int dtype, const void* q, const void* k, const void* v,
               void* out, void* lse, int B, int Tq, int Tk, int H, int KV,
               int D, int kv_chunk, float scale, int causal, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > kMaxD || kv_chunk < 1 || kv_chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_flash<float>(q, k, v, out, lse, B, Tq, Tk, H, KV, D,
                               kv_chunk, scale, causal, s);
  if (dtype == 1)
    return launch_flash<__nv_bfloat16>(q, k, v, out, lse, B, Tq, Tk, H, KV,
                                       D, kv_chunk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int fa_max_head_dim(void) { return kMaxD; }
int fa_max_kv_chunk(void) { return kMaxChunk; }

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
