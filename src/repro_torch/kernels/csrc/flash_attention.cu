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
// thread block owns one (batch, head, q tile) and loops over the kv chunks
// itself, ascending.  The online-softmax step is the caller's kv chunk (up
// to 1024 keys), as in the reference, so p is rounded against the same
// running max.  Under the causal mask a block stops at the key of its
// tile's last query position: later keys are masked for every row of the
// tile, where p = 0 exactly (the running max is finite from key 0 on), so
// the numbers are the ones a full sweep gives.
//
// Bound on the H100: at the training shape (B 8, T 128, H 12, D 64) the
// function moves q, k, v and out once (1.57 MB each in bf16) and does
// 4 * B * H * Tq * Tk * D FLOPs (half of that under the causal mask);
// that is about 32 FLOPs per byte, far under the card's ~295 FLOP/byte
// ridge in bf16, so it is bound by bytes (about 1.9 us at 3.35 TB/s).
//
// Two kernels; the wrapper picks one by dtype and head dim.
//
// flash_fwd_tc_kernel, bf16 with D a multiple of 8 (the main path: ATIS
// bf16 and fp8 training run attention in bf16).  Four warps own 16 query
// rows each of a 64-row q tile (the ATIS shape launches 192 blocks on 132
// SMs).  q, k and v stay bf16: q, and each 64-key k or v tile, arrive
// through cp.async (zero-filled past the live keys and the head dim) into
// padded shared rows, q's fragments through ldmatrix once, k's through
// ldmatrix and v's through ldmatrix.trans, and QK^T and PV run on the
// tensor cores (mma.sync m16n8k16, f32 accumulation: the bf16 products are
// exact, so only the order of the sums differs from the reference).
// Scores and row statistics stay in registers (quad shuffles).  p must be
// rounded against the running max of the whole kv chunk, not of a 64-key
// tile, so a chunk of up to 128 keys keeps all its scores in registers
// (64 a thread) and takes its max before any p is formed; a longer chunk
// takes two passes over its keys, the first for the max, the second
// recomputing s, forming p and accumulating PV.  The rounded p feeds PV
// straight from the score accumulators as the A fragment; l sums the
// unrounded p.  The loads of a chunk's tiles are all in flight (4 slots)
// before its first product.
//
// flash_fwd_kernel, f32 (and any other head dim): SIMT.  q and the staged k
// or v sub-tile are held in shared memory as f32 (padded rows, no bank
// conflicts on the strided reads); the 32 x chunk score rows live in shared
// memory between the QK^T product, the row statistics (4 threads per row,
// warp shuffles) and the PV product; the f32 output accumulator stays in
// registers (4 rows x 8 head-dim columns a thread).  Tensor cores would
// mean TF32, which keeps ~3 digits and misses the f32 gate.
//
// Plain C interface (loaded with ctypes): the launch goes to the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sm90.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// Four warps of 16 q rows: at the ATIS shape 192 blocks, all resident at
// once (two or eight warps a block measured slower there).
constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // q rows per block
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcKeys = 64;     // keys per staged k or v tile
constexpr int kTcSlots = 4;     // staged tiles in flight

// Shared-memory row pitch (bf16 elements) for head dim padded to DP: an odd
// number of 16-byte units, so the 8 rows of an ldmatrix phase hit 8
// distinct bank groups.
__host__ __device__ constexpr int tc_pitch(int DP) { return DP + 8; }

__host__ __device__ constexpr int tc_smem_bytes(int DP) {
  return (kTcRows + kTcSlots * kTcKeys) * tc_pitch(DP) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int BH, int Tq, int Tk,
                        int H, int KV, int D, int kc, float scale, int causal,
                        int nq) {
  using bf16 = __nv_bfloat16;
  constexpr int P = tc_pitch(DP);
  constexpr int kTile = kTcKeys * P;  // elements of one staged k / v tile
  constexpr int NKS = DP / 16;        // k steps of QK^T
  constexpr int NDT = DP / 8;         // n tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* slots = qs + kTcRows * P;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // The heaviest causal tiles (the last ones) are dispatched first.
  const int qt = nq - 1 - blockIdx.x / BH, bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kTcRows, rows = min(kTcRows, Tq - q0);
  const size_t kv_stride = (size_t)KV * D;
  const bf16* kb = k + ((size_t)b * Tk * KV + kvh) * D;
  const bf16* vb = v + ((size_t)b * Tk * KV + kvh) * D;
  const int dch = D / 8;  // 16-byte pieces of a row

  // Rows [0, valid) of an n-row tile, row r at src + r * stride; the rest,
  // and the head dim past D, zero-filled.
  auto load = [&](bf16* dst, const bf16* src, size_t stride, int valid,
                  int n = kTcKeys) {
    for (int e = tid; e < n * (DP / 8); e += kTcThreads) {
      const int r = e / (DP / 8), c = e % (DP / 8);
      const bool ok = r < valid && c < dch;
      cp_async<16>(smem_u32(dst + r * P + c * 8),
                   ok ? src + r * stride + c * 8 : q, ok ? 16 : 0);
    }
  };

  load(qs, q + ((size_t)b * Tq * H + (size_t)q0 * H + h) * D, (size_t)H * D,
       rows, kTcRows);
  cp_async_commit();

  uint32_t qf[NKS][4];
  bool qf_ready = false;
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // rows g, g + 8
  const int row0 = 16 * warp + g;  // this lane's first row in the tile

  auto load_q_frags = [&]() {
    if (qf_ready) return;
#pragma unroll
    for (int s = 0; s < NKS; ++s)
      ldsm_x4(smem_u32(qs + (16 * warp + lane % 16) * P + s * 16 +
                       (lane / 16) * 8),
              qf[s]);
    qf_ready = true;
  };

  // s = (q . k) * scale over the 64 keys of a staged k tile, masked:
  // -inf past the chunk's live keys, -1e30 where causal hides the key.
  auto score = [&](const bf16* ks, int key0, int c0, int live,
                   float (&s)[8][4]) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(smem_u32(ks + (np * 16 + lane % 8 + (lane / 16) * 8) * P +
                         kk * 16 + ((lane / 8) % 2) * 8),
                bf);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = key0 + 8 * n + 2 * t + (r & 1);  // in the chunk
        const int row = row0 + (r >= 2 ? 8 : 0);
        float x = s[n][r] * scale;
        if (key >= live)
          x = -INFINITY;  // not visited: absent, p = 0
        else if (causal && q0 + row < c0 + key)
          x = -1e30f;
        s[n][r] = x;
      }
  };

  auto row_max = [&](const float (&s)[8][4], float* mx) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
  };

  // The chunk's max is known: rescale l and o, make it the running max.
  auto advance = [&](float* mx) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      const float corr = expf(m[i] - m_new);
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
      m[i] = m_new;
    }
  };

  // p = exp(s - m) for 64 keys: l sums it unrounded, and, rounded to bf16,
  // it is the A fragment of o += p v over the staged v tile.
  auto pv = [&](const float (&s)[8][4], const bf16* vs) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p[j][r] = expf(s[2 * kk + j][r] - m[r >> 1]);
          l[r >> 1] += p[j][r];
        }
      const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                             pack_bf16(p[0][2], p[0][3]),
                             pack_bf16(p[1][0], p[1][1]),
                             pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int nd = 0; nd < NDT / 2; ++nd) {
        uint32_t bf[4];
        ldsm_x4_t(smem_u32(vs + (kk * 16 + lane % 16) * P + nd * 16 +
                           (lane / 16) * 8),
                  bf);
        mma_bf16(o[2 * nd], a, bf[0], bf[1]);
        mma_bf16(o[2 * nd + 1], a, bf[2], bf[3]);
      }
    }
  };

  // Causal: keys at or past k_end are masked for every row of this tile.
  const int k_end = causal ? min(Tk, q0 + rows) : Tk;
  const int nchunks = (k_end + kc - 1) / kc;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int c0 = ch * kc;
    const int live = min(kc, k_end - c0);  // keys of the chunk to visit
    const int nsub = (live + kTcKeys - 1) / kTcKeys;
    auto tile_rows = [&](int st) { return min(kTcKeys, live - st * kTcKeys); };
    __syncthreads();  // every warp is done with the slots
    if (nsub <= 2) {
      // One pass: every score of the chunk in registers.
      for (int st = 0; st < 2; ++st) {
        if (st < nsub)
          load(slots + st * kTile, kb + (size_t)(c0 + st * kTcKeys) * kv_stride,
               kv_stride, tile_rows(st));
        cp_async_commit();
      }
      for (int st = 0; st < 2; ++st) {
        if (st < nsub)
          load(slots + (2 + st) * kTile,
               vb + (size_t)(c0 + st * kTcKeys) * kv_stride, kv_stride,
               tile_rows(st));
        cp_async_commit();
      }
      float sa[8][4], sb[8][4];
      float mx[2] = {-INFINITY, -INFINITY};
      cp_async_wait<3>();
      __syncthreads();
      load_q_frags();
      score(slots, 0, c0, live, sa);
      row_max(sa, mx);
      if (nsub == 2) {
        cp_async_wait<2>();
        __syncthreads();
        score(slots + kTile, kTcKeys, c0, live, sb);
        row_max(sb, mx);
      }
      advance(mx);
      cp_async_wait<1>();
      __syncthreads();
      pv(sa, slots + 2 * kTile);
      if (nsub == 2) {
        cp_async_wait<0>();
        __syncthreads();
        pv(sb, slots + 3 * kTile);
      }
    } else {
      // Two passes: the chunk's max over its k tiles (two slots in turn),
      // then s again, p and PV over (k, v) tile pairs (two pairs in turn).
      float sa[8][4];
      float mx[2] = {-INFINITY, -INFINITY};
      load(slots, kb + (size_t)c0 * kv_stride, kv_stride, tile_rows(0));
      cp_async_commit();
      for (int st = 0; st < nsub; ++st) {
        if (st + 1 < nsub)
          load(slots + ((st + 1) % 2) * kTile,
               kb + (size_t)(c0 + (st + 1) * kTcKeys) * kv_stride, kv_stride,
               tile_rows(st + 1));
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        load_q_frags();
        score(slots + (st % 2) * kTile, st * kTcKeys, c0, live, sa);
        row_max(sa, mx);
        __syncthreads();  // slot st % 2 is free again
      }
      advance(mx);
      load(slots, kb + (size_t)c0 * kv_stride, kv_stride, tile_rows(0));
      load(slots + kTile, vb + (size_t)c0 * kv_stride, kv_stride,
           tile_rows(0));
      cp_async_commit();
      for (int st = 0; st < nsub; ++st) {
        if (st + 1 < nsub) {
          const size_t off = (size_t)(c0 + (st + 1) * kTcKeys) * kv_stride;
          const int pair = 2 * ((st + 1) % 2);
          load(slots + pair * kTile, kb + off, kv_stride, tile_rows(st + 1));
          load(slots + (pair + 1) * kTile, vb + off, kv_stride,
               tile_rows(st + 1));
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int pair = 2 * (st % 2);
        score(slots + pair * kTile, st * kTcKeys, c0, live, sa);
        pv(sa, slots + (pair + 1) * kTile);
        __syncthreads();  // the pair's slots are free again
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= rows) continue;
    // One reciprocal a row (a division an element costs a tenth of the
    // kernel): within an f32 ulp of acc / l before the bf16 rounding.
    const float l_safe = fmaxf(l[i], 1e-30f), inv = 1.f / l_safe;
    bf16* orow = out + (((size_t)b * Tq + q0 + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
    if (t == 0)
      lse[((size_t)b * Tq + q0 + row) * H + h] = m[i] + logf(l_safe);
  }
}

template <int DP>
int launch_flash_tc(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int Tq, int Tk, int H, int KV, int D,
                    int kc, float scale, int causal, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc_smem_bytes(DP));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int nq = (Tq + kTcRows - 1) / kTcRows;
  const long long blocks = (long long)nq * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_tc_kernel<DP><<<(unsigned)blocks, kTcThreads, tc_smem_bytes(DP),
                            stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), B * H, Tq, Tk, H, KV, D, kc, scale, causal,
      nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  kernel: 0 = the SIMT kernel, 1 = the
// tensor-core one (bf16, D a multiple of 8, 16-byte aligned operands).
// kv_chunk: keys per online-softmax step, 1..kMaxChunk.
int fa_forward(int dtype, int kernel, const void* q, const void* k,
               const void* v, void* out, void* lse, int B, int Tq, int Tk,
               int H, int KV, int D, int kv_chunk, float scale, int causal,
               void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > kMaxD || kv_chunk < 1 || kv_chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    if (dtype != 1 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 32)
      return launch_flash_tc<32>(q, k, v, out, lse, B, Tq, Tk, H, KV, D,
                                 kv_chunk, scale, causal, s);
    if (D <= 64)
      return launch_flash_tc<64>(q, k, v, out, lse, B, Tq, Tk, H, KV, D,
                                 kv_chunk, scale, causal, s);
    return launch_flash_tc<128>(q, k, v, out, lse, B, Tq, Tk, H, KV, D,
                                kv_chunk, scale, causal, s);
  }
  if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
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
