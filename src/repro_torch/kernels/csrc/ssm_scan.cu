// Hand-written Hopper (sm_90a) chunked linear-recurrence scan.
//
// Port of the Pallas TPU kernel src/repro/kernels/ssm_scan.py
// (_scan_kernel / linear_scan_pallas): the token mixing of RWKV-6 and
// Mamba-2,
//   S_t = diag(d_t) S_{t-1} + k_t^T v_t          (state [dk, dv], f32)
//   o_t = q_t (diag(a_t) S_{t-1} + diag(g_t) k_t^T v_t)
// with mode ssd (a = d, g = 1) or rwkv6 (a = 1, g = u, the bonus on the
// current token).  The semantics are the plain twin's
// (kernels/ref.py chunked_linear_scan), term for term, in f32 whatever
// the operand type:
//   * per chunk of C tokens, lc = the in-chunk inclusive cumulative sum
//     of the log-decay per channel, summed in token order;
//   * rwkv6 and a per-channel ssd decay keep the reference's
//     factorization: ex = lc (ssd) or lc - log_decay (rwkv6),
//     q_t = q * exp(ex), k_t = k * exp(-lc), att = q_t k_t^T masked to
//     j < i (rwkv6, plus sum(q * u * k) on the diagonal) or j <= i (ssd),
//     o = att v + q_t S, S = S * exp(lc[C-1]) + (k * exp(lc[C-1] - lc))^T v.
//     It agrees with the reference wherever that is finite, and
//     overflows f32 where it does (lc below about -88.7 in a chunk);
//   * an ssd decay that is one scalar per token (mode 2, handed over as
//     [BH, T]) takes the form whose every exponent is <= 0:
//     att_ij = (q_i . k_j) * exp(lc_i - lc_j) for j <= i,
//     o = att v + exp(lc) * (q S), and the same state update.  It never
//     overflows (Mamba-2 at init decays by about -0.69 a token: lc
//     reaches -88.7 within a 128-token chunk).
// IEEE expf (the build uses no fast-math), f32 accumulation throughout.
//
// What it does not copy is the TPU grid: there the chunk axis is a
// sequential grid dimension carrying S in VMEM scratch; here one thread
// block owns one batch*head stream and walks its chunks in order, and S
// stays in shared memory for the whole sequence (written once, at the
// end, as the final state).
//
// Bound on the H100: at the rwkv6_7b training shape (BH 512, T 128,
// dk = dv = 64, bf16 q/k/v/o, f32 log-decay, u and state) the function
// moves each input and output once, about 59 MB (17.6 us at 3.35 TB/s),
// and does about 2.2 GFLOP: two causal C x C x 64 products and two
// C x 64 x 64 products per chunk.  Those are f32 products (q_t = q *
// exp(ex) is no bf16 value), which at the f32 FMA rate alone would take
// 32 us: only the tensor cores can bring the kernel near its bytes.
// Design:
//   * all four products run on the tensor cores (mma.sync m16n8k8) in
//     split TF32: each f32 operand is a TF32 high part plus a residual,
//     and a * b = a_hi b_hi + a_hi b_lo + a_lo b_hi keeps f32 accuracy
//     (plain TF32 keeps ~3 digits and would fail the f32 gate).  An
//     operand that is a bf16 value is exact in TF32 and needs no residual:
//     v in bf16 (att v, the state update), and q, k in bf16 in the scalar
//     form (one product for q k^T).  Each kind of product is issued for
//     every accumulator of a k step before the next kind, so consecutive
//     products do not wait on each other;
//   * 8 warps; each takes 16-row tiles of the chunk.  A tile's q_t
//     fragments are formed once in registers, exp factor and all, from
//     device memory (every load of the tile issued before any is used),
//     and serve both att and q_t S.  att is made 32 keys at a time in
//     registers, up to the diagonal, and used at once as the A fragment of
//     att v (its accumulator layout is an A layout up to the order of the
//     8 keys of each k step, which the B fragment follows).  q_t S is
//     skipped on the first chunk, where S is zero.  The causal mask makes
//     tile m cost m / 2 + 1 key blocks; the warps that share a scheduler
//     take a light and a heavy tile;
//   * shared memory holds the log-decay and v as they arrive by 16-byte
//     cp.async copies (the log-decay is turned into lc in place, later into
//     the state update's k_s), k_t = k * exp(-lc) formed once, and the
//     state transposed; rows padded so every fragment load is one 4- or
//     8-byte load without bank conflicts: 111.6 KB at the rwkv6 shape, two
//     blocks an SM;
//   * the cumsum runs one thread per channel in token order (the twin's
//     order, 8 tokens' loads ahead of their sums); k_t and k_s read k from
//     device memory 16 pairs a thread at a time, all loads in flight at
//     once; the rwkv6 diagonal is summed in the q fragments' own lanes and
//     reduced over the quad.
//
// Plain C interface (loaded with ctypes): the launch goes to the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr long long kSmemBudget = 232448;  // bytes a block may use (H100)
constexpr int kMaxDk = 128;

enum Mode { kSsd = 0, kRwkv6 = 1, kSsdScalar = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// Shared-memory layout for chunk C, head dims dk / dv: the chunk padded to
// cp = 16k rows, dk to 8, dv to 16, all padding zero.  Rows keep the
// row-major layout of device memory (the log-decay and v arrive by 16-byte
// cp.async copies) and carry 8 elements of padding, which puts the 8 rows
// a fragment load touches on distinct banks.
//   lc  [cp][dk8 + 8] f32: the log-decay, turned into lc in place, then
//       into the state update's k_s = k * exp(lc_last - lc);
//   k_t [cp][dk8 + 8] f32: k * exp(-lc) (k in the scalar form);
//   v   [cp][dv16 + 8] in the operand type;
//   the state, transposed, [dv16][dk8 + 8] f32;
//   the chunk's last lc [dk8], u [dk8] and the scalar lc [cp], f32.
struct Layout {
  int cp, dk8, dv16, lp, vp, sp;
  __host__ __device__ Layout(int C, int dk, int dv)
      : cp(round_up(C, 16)), dk8(round_up(dk, 8)), dv16(round_up(dv, 16)),
        lp(dk8 + 8), vp(dv16 + 8), sp(dk8 + 8) {}
};

// Bytes of dynamic shared memory one block uses; the wrapper's footprint
// rule (ssm_scan.scan_smem_bytes) is the same formula.
__host__ __device__ inline long long smem_bytes(int C, int dk, int dv,
                                                int size) {
  const Layout L(C, dk, dv);
  return 8LL * L.cp * L.lp + (long long)size * L.cp * L.vp +
         4LL * L.dv16 * L.sp + 4LL * (2 * L.dk8 + L.cp);
}

template <typename T>
__device__ __forceinline__ T zero() {
  return from_f<T>(0.f);
}

// Rows [0, n) x elements [0, w) of a row-major device array (pitch gp
// elements) into shared rows of pitch sp: 16-byte cp.async copies when
// vec (w a whole number of 16-byte pieces, 16-byte aligned rows), else
// element loads; rows [n, rows) and elements [w, w_pad) zero-filled.
template <typename E>
__device__ __forceinline__ void stage(E* dst, int sp, const E* src, size_t gp,
                                      int n, int rows, int w, int w_pad,
                                      bool vec) {
  constexpr int kPer = 16 / sizeof(E);
  if (vec) {
    const int per_row = w_pad / kPer;
    for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
      const int r = e / per_row, c = (e % per_row) * kPer;
      const bool ok = r < n && c < w;
      cp_async<16>(smem_u32(dst + r * sp + c), ok ? src + r * gp + c : src,
                   ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * w_pad; e += kThreads) {
      const int r = e / w_pad, c = e % w_pad;
      dst[r * sp + c] = r < n && c < w ? src[r * gp + c] : zero<E>();
    }
  }
}

// Split (or, for a value exact in TF32, pass through) the four A-fragment
// values x into high parts and residuals.
template <bool kExact>
__device__ __forceinline__ void split4(const float* x, uint32_t* hi,
                                       uint32_t* lo) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if constexpr (kExact) {
      hi[r] = __float_as_uint(x[r]);
      lo[r] = 0u;
    } else {
      split_tf32(x[r], hi[r], lo[r]);
    }
  }
}

// The B fragment pair (b0, b1) of one k step as high parts and residuals
// (zero residuals for values exact in TF32).
template <bool kExact>
__device__ __forceinline__ void split2(float b0, float b1, uint32_t* hi,
                                       uint32_t* lo) {
  const float x[4] = {b0, b1, 0.f, 0.f};
  uint32_t h[4], l[4];
  split4<kExact>(x, h, l);
  hi[0] = h[0], hi[1] = h[1], lo[0] = l[0], lo[1] = l[1];
}

// Split-TF32 products of one k step for N independent accumulators: acc[n]
// += a * b[n] as a_hi b_hi into acc, and the residual terms a_lo b_hi +
// a_hi b_lo into res (res may be acc; a term is skipped where its operand
// is exact in TF32).  Each kind is issued for every n before the next, so
// no product waits on the one before it; none is predicated (a predicated
// mma.sync costs a warp sync), so callers point unused tiles at harmless
// in-bounds data.
template <int N, bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_split(float (*acc)[4], float (*res)[4],
                                          const uint32_t* ah,
                                          const uint32_t* al,
                                          uint32_t (*bh)[2],
                                          uint32_t (*bl)[2]) {
  if constexpr (!kAExact) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(res[n], al, bh[n][0], bh[n][1]);
  }
  if constexpr (!kBExact) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(res[n], ah, bl[n][0], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
}

// Elements [e0, e0 + 2 * kBatch * kThreads) of the chunk's k, as pairs
// (k[j][d], k[j][d + 1]) with d even, this thread's every kThreads-th pair:
// all loads issued before any is used.  Pairs past the chunk or dk are 0.
template <typename T, int kBatch>
__device__ __forceinline__ void load_k_pairs(const T* kb, int c0, int C,
                                             int dk, int dk8, int e0,
                                             float2 (&kv)[kBatch]) {
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    const int e = e0 + 2 * (threadIdx.x + r * kThreads);
    const int j = e / dk8, d = e % dk8;
    const T* src = kb + (size_t)(c0 + j) * dk + d;
    kv[r].x = j < C && d < dk ? to_f(src[0]) : 0.f;
    kv[r].y = j < C && d + 1 < dk ? to_f(src[1]) : 0.f;
  }
}

// KD: k steps of 8 over dk held in registers (dk <= 8 KD); NE: output
// n-tiles of 8 columns of v per pass over att (dv <= 8 NE takes one); M:
// the Mode.  vec: bit 0, v takes 16-byte copies; bit 1, the log-decay.
template <typename T, int KD, int NE, int M>
__global__ void __launch_bounds__(kThreads, KD <= 8 && NE <= 8 ? 2 : 1)
    scan_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ld,
                   const float* __restrict__ u, T* __restrict__ out,
                   float* __restrict__ state_out, int Tn, int dk, int dv,
                   int C, int vec) {
  constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kBatch = 16;  // k pairs a thread loads at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(C, dk, dv);
  float* lc = reinterpret_cast<float*>(smem_raw);  // [cp][lp]
  float* kt = lc + L.cp * L.lp;                    // [cp][lp]
  T* vs = reinterpret_cast<T*>(kt + L.cp * L.lp);  // [cp][vp]
  float* st = reinterpret_cast<float*>(vs + L.cp * L.vp);  // [dv16][sp]
  float* lcl = st + L.dv16 * L.sp;  // [dk8]: the chunk's last lc
  float* us = lcl + L.dk8;          // [dk8]: u
  float* lcs = us + L.dk8;          // [cp]: lc of the scalar form

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  constexpr bool scalar = M == kSsdScalar, rwkv = M == kRwkv6;
  constexpr bool kQkExact = scalar && kBf;  // q k^T of two bf16 values
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * Tn * dk;
  const T* kb = k + bh * Tn * dk;
  const T* vb = v + bh * Tn * dv;
  const float* ldb = ld + bh * Tn * (scalar ? 1 : dk);
  T* ob = out + bh * Tn * dv;
  const int nks = L.dk8 / 8;
  const int npairs = L.cp * L.dk8;  // elements of k_t / k_s, in pairs

  for (int e = tid; e < L.dv16 * L.sp; e += kThreads) st[e] = 0.f;
  for (int d = tid; d < L.dk8; d += kThreads)
    us[d] = rwkv && d < dk ? u[bh * dk + d] : 0.f;

  for (int c0 = 0; c0 < Tn; c0 += C) {
    // -- stage the log-decay and v (16-byte copies in flight at once) ------
    if (scalar) {
      for (int i = tid; i < L.cp; i += kThreads)
        lcs[i] = i < C ? ldb[c0 + i] : 0.f;
    } else {
      stage(lc, L.lp, ldb + (size_t)c0 * dk, dk, C, L.cp, dk, L.dk8,
            vec & 2);
    }
    cp_async_commit();
    stage(vs, L.vp, vb + (size_t)c0 * dv, dv, C, L.cp, dv, L.dv16, vec & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // -- lc in place: one thread per channel, in token order (the twin's
    // order), 8 tokens' loads ahead of their sums; padded tokens carry
    // the last sum (their decay is 0) -----------------------------------
    {
      auto scan_col = [&](float* col, int pitch, int n) {
        float s = 0.f;
        for (int i0 = 0; i0 < L.cp; i0 += 8) {
          float x[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            x[r] = i0 + r < n ? col[(i0 + r) * pitch] : 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (i0 + r < n) s += x[r];
            col[(i0 + r) * pitch] = s;
          }
        }
        return s;
      };
      if (scalar) {
        if (tid == 0) scan_col(lcs, 1, C);
      } else {
        for (int d = tid; d < L.dk8; d += kThreads)
          lcl[d] = scan_col(lc + d, L.lp, d < dk ? C : 0);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // -- k_t = k * exp(-lc) (k itself in the scalar form) ------------------
    for (int e0 = 0; e0 < npairs; e0 += 2 * kBatch * kThreads) {
      float2 kv[kBatch];
      load_k_pairs<T, kBatch>(kb, c0, C, dk, L.dk8, e0, kv);
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int e = e0 + 2 * (tid + r * kThreads);
        if (e >= npairs) break;
        const int j = e / L.dk8, d = e % L.dk8;
        float2 x = kv[r];
        if (!scalar) {
          const float2 l = ld_pair(lc + j * L.lp + d);
          x.x *= expf(-l.x);
          x.y *= expf(-l.y);
        }
        *reinterpret_cast<float2*>(kt + j * L.lp + d) = x;
      }
    }
    __syncthreads();

    // -- outputs: each warp its 16-row tiles --------------------------------
    // Under the causal mask tile m costs m / 2 + 1 key blocks; warps w and
    // w + 4 share a scheduler, so within each group of 8 tiles warp w
    // takes tile w and warp 4 + w tile 7 - w.
    const int nmt = L.cp / 16;
    for (int r = warp; r < nmt; r += kWarps) {
      const int base = r - r % kWarps;
      const int mt = base + kWarps <= nmt && r % kWarps >= kWarps / 2
                         ? base + kWarps + kWarps / 2 - 1 - r % kWarps
                         : r;
      const int jhi = mt / 2 + 1;  // key blocks up to the diagonal
      const int i0 = mt * 16 + g, i1 = i0 + 8;
      // q_t fragments: a0 (i0, d), a1 (i1, d), a2 (i0, d + 1), a3 (i1,
      // d + 1) with d = 8s + 2t, the channel pair this lane feeds to k
      // rows t and t + 4 of each k step.  Every device-memory load of
      // these rows (q; for rwkv6 k, for the diagonal, and the raw
      // log-decay of lc - log_decay) is issued before any is used.
      float qa[KD][4];
      float dg[2] = {0.f, 0.f};  // rwkv6: this lane's part of the diagonal
      // Two halves of the k steps, each with all its loads in flight.
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        constexpr int kH = KD / 2;
        float2 qv[kH][2], kr[kH][2], lr[kH][2];
#pragma unroll
        for (int sh = 0; sh < kH; ++sh)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int s = hf * kH + sh;
            const int i = h ? i1 : i0, d = 8 * s + 2 * t;
            const bool ok = s < nks && i < C;
            const size_t gi = (size_t)(c0 + i) * dk + d;
            qv[sh][h] = make_float2(ok && d < dk ? to_f(qb[gi]) : 0.f,
                                    ok && d + 1 < dk ? to_f(qb[gi + 1]) : 0.f);
            if (rwkv) {
              kr[sh][h] =
                  make_float2(ok && d < dk ? to_f(kb[gi]) : 0.f,
                              ok && d + 1 < dk ? to_f(kb[gi + 1]) : 0.f);
              lr[sh][h] = make_float2(ok && d < dk ? ldb[gi] : 0.f,
                                      ok && d + 1 < dk ? ldb[gi + 1] : 0.f);
            }
          }
#pragma unroll
        for (int sh = 0; sh < kH; ++sh)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int s = hf * kH + sh;
            const int i = h ? i1 : i0, d = 8 * s + 2 * t;
            float q0 = qv[sh][h].x, q1 = qv[sh][h].y;
            if (rwkv)
              dg[h] += q0 * us[d] * kr[sh][h].x + q1 * us[d + 1] * kr[sh][h].y;
            if (!scalar && s < nks) {
              const float2 l = ld_pair(lc + i * L.lp + d);
              q0 *= expf(rwkv ? l.x - lr[sh][h].x : l.x);
              q1 *= expf(rwkv ? l.y - lr[sh][h].y : l.y);
            }
            qa[s][h] = q0;
            qa[s][h + 2] = q1;
          }
      }
      if (rwkv) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dg[h] += __shfl_xor_sync(0xffffffffu, dg[h], 1);
          dg[h] += __shfl_xor_sync(0xffffffffu, dg[h], 2);
        }
      }

      for (int e0b = 0; e0b < dv; e0b += 8 * NE) {
        float o[NE][4];
#pragma unroll
        for (int n = 0; n < NE; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) o[n][r] = 0.f;

        // q_t S (S is zero on the first chunk).
        if (c0 > 0) {
          float res[NE][4];
#pragma unroll
          for (int n = 0; n < NE; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r) res[n][r] = 0.f;
#pragma unroll
          for (int s = 0; s < KD; ++s) {
            if (s >= nks) break;
            uint32_t ah[4], al[4], bhi[NE][2], blo[NE][2];
            split4<kQkExact>(qa[s], ah, al);
#pragma unroll
            for (int n = 0; n < NE; ++n) {
              // Columns past dv read the last state row (results unused).
              const int e = min(e0b + 8 * n + g, L.dv16 - 1);
              const float2 sv = ld_pair(st + e * L.sp + 8 * s + 2 * t);
              split2<false>(sv.x, sv.y, bhi[n], blo[n]);
            }
            mma_split<NE, kQkExact, false>(o, res, ah, al, bhi, blo);
          }
#pragma unroll
          for (int n = 0; n < NE; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r) o[n][r] += res[n][r];
          if (scalar) {
            const float f0 = expf(lcs[i0]), f1 = expf(lcs[i1]);
#pragma unroll
            for (int n = 0; n < NE; ++n) {
              o[n][0] *= f0;
              o[n][1] *= f0;
              o[n][2] *= f1;
              o[n][3] *= f1;
            }
          }
        }

        // att, 32 keys at a time up to the diagonal, then att v.
        for (int jb = 0; jb < jhi; ++jb) {
          float a[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r) a[n][r] = 0.f;
#pragma unroll
          for (int s = 0; s < KD; ++s) {
            if (s >= nks) break;
            uint32_t ah[4], al[4], bhi[4][2], blo[4][2];
            split4<kQkExact>(qa[s], ah, al);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              // Keys past the diagonal are masked below; past the chunk
              // they read its last row.
              const int row = min(jb * 32 + 8 * n + g, L.cp - 1);
              const float2 kv = ld_pair(kt + row * L.lp + 8 * s + 2 * t);
              split2<kQkExact>(kv.x, kv.y, bhi[n], blo[n]);
            }
            // One accumulator: 24 products, 4 independent.
            mma_split<4, kQkExact, kQkExact>(a, a, ah, al, bhi, blo);
          }
          // Mask (and, in the scalar form, decay) in registers.
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = r < 2 ? i0 : i1;
              const int j = jb * 32 + 8 * n + 2 * t + (r & 1);
              float x = a[n][r];
              if (rwkv)
                x = j < i ? x : (j == i ? dg[r >> 1] : 0.f);
              else if (j > i)
                x = 0.f;
              else if (scalar)
                x *= expf(lcs[i] - lcs[j]);
              a[n][r] = x;
            }
          // att v: the accumulator of keys j0 + 2t, j0 + 2t + 1 is the A
          // fragment's columns t, t + 4, so v rows j0 + 2t, j0 + 2t + 1
          // feed B rows t, t + 4.  Keys past the diagonal carry att = 0
          // (past the chunk, its last rows of v).
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float x[4] = {a[n][0], a[n][2], a[n][1], a[n][3]};
            uint32_t ah[4], al[4], bhi[NE][2], blo[NE][2];
            split4<false>(x, ah, al);
            const T* vr =
                vs + min(jb * 32 + 8 * n + 2 * t, L.cp - 2) * L.vp;
#pragma unroll
            for (int m = 0; m < NE; ++m) {
              // Columns past dv read column dv16 - 1 (results unused).
              const int e = min(e0b + 8 * m + g, L.dv16 - 1);
              split2<kBf>(to_f(vr[e]), to_f(vr[L.vp + e]), bhi[m], blo[m]);
            }
            mma_split<NE, false, kBf>(o, o, ah, al, bhi, blo);
          }
        }

        // Store: rows i0, i1, columns e0 + 2t, e0 + 2t + 1.
#pragma unroll
        for (int n = 0; n < NE; ++n) {
          const int e = e0b + 8 * n + 2 * t;
          if (e >= dv) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = h ? i1 : i0;
            if (i >= C) continue;
            T* dst = ob + (size_t)(c0 + i) * dv + e;
            if (e + 1 < dv && dv % 2 == 0) {
              st_pair(dst, o[n][2 * h], o[n][2 * h + 1]);
            } else {
              dst[0] = from_f<T>(o[n][2 * h]);
              if (e + 1 < dv) dst[1] = from_f<T>(o[n][2 * h + 1]);
            }
          }
        }
      }
    }
    __syncthreads();

    // -- k_s = k * exp(lc_last - lc), in place of lc ------------------------
    for (int e0 = 0; e0 < npairs; e0 += 2 * kBatch * kThreads) {
      float2 kv[kBatch];
      load_k_pairs<T, kBatch>(kb, c0, C, dk, L.dk8, e0, kv);
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int e = e0 + 2 * (tid + r * kThreads);
        if (e >= npairs) break;
        const int j = e / L.dk8, d = e % L.dk8;
        float2* cell = reinterpret_cast<float2*>(lc + j * L.lp + d);
        const float2 l = *cell;
        *cell = scalar ? make_float2(kv[r].x * expf(lcs[C - 1] - lcs[j]),
                                     kv[r].y * expf(lcs[C - 1] - lcs[j]))
                       : make_float2(kv[r].x * expf(lcl[d] - l.x),
                                     kv[r].y * expf(lcl[d + 1] - l.y));
      }
    }
    __syncthreads();

    // -- S^T = S^T * exp(lc_last) + v^T k_s: 16 rows of v^T x 32 channels
    // per unit of work -------------------------------------------------------
    {
      const int ngr = (L.dk8 + 31) / 32, units = (L.dv16 / 16) * ngr;
      const float dec_s = scalar ? expf(lcs[C - 1]) : 0.f;
      for (int w = warp; w < units; w += kWarps) {
        const int m0 = (w / ngr) * 16, n0 = (w % ngr) * 32;
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
        float res[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) res[n][r] = 0.f;
#pragma unroll 4
        for (int j0 = 0; j0 < L.cp; j0 += 8) {
          // a0 (e m0 + g, key j0 + 2t), a1 (e + 8, same key), a2 / a3 the
          // next key: v rows j0 + 2t and j0 + 2t + 1.
          const T* va = vs + (j0 + 2 * t) * L.vp + m0 + g;
          const float x[4] = {to_f(va[0]), to_f(va[8]), to_f(va[L.vp]),
                              to_f(va[L.vp + 8])};
          uint32_t ah[4], al[4], bhi[4][2], blo[4][2];
          split4<kBf>(x, ah, al);
          const float* k0 = lc + (j0 + 2 * t) * L.lp;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            // Channels past dk8 read channel dk8 - 1 (results unused).
            const int d = min(n0 + 8 * n + g, L.dk8 - 1);
            split2<false>(k0[d], k0[L.lp + d], bhi[n], blo[n]);
          }
          mma_split<4, kBf, false>(acc, res, ah, al, bhi, blo);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[n][r] += res[n][r];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int d0 = n0 + 8 * n;
          if (d0 >= L.dk8) break;
          const float dec[2] = {scalar ? dec_s : expf(lcl[d0 + 2 * t]),
                                scalar ? dec_s : expf(lcl[d0 + 2 * t + 1])};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = m0 + g + (r >= 2 ? 8 : 0), d = d0 + 2 * t + (r & 1);
            float* cell = st + e * L.sp + d;
            *cell = *cell * dec[r & 1] + acc[n][r];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < dk * dv; e += kThreads)
    state_out[bh * dk * dv + e] = st[(e % dv) * L.sp + e / dv];
}

template <typename T, int KD, int NE, int M>
cudaError_t prepare() {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_tc_kernel<T, KD, NE, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBudget);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  return cudaSuccess;
}

struct Args {
  int mode;
  const void *q, *k, *v, *ld, *u;
  void *out, *state;
  int BH, Tn, dk, dv, C;
  cudaStream_t stream;
};

template <typename T, int KD, int NE, int M>
int launch_scan(const Args& a) {
  const cudaError_t err = prepare<T, KD, NE, M>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)smem_bytes(a.C, a.dk, a.dv, sizeof(T));
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = (a.dv * sizeof(T) % 16 == 0 && al16(a.v)) |
                  (a.dk % 4 == 0 && al16(a.ld)) << 1;
  scan_tc_kernel<T, KD, NE, M><<<a.BH, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.ld),
      static_cast<const float*>(a.u), static_cast<T*>(a.out),
      static_cast<float*>(a.state), a.Tn, a.dk, a.dv, a.C, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KD, int NE, int M>
int occupancy(long long smem) {
  if (prepare<T, KD, NE, M>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, scan_tc_kernel<T, KD, NE, M>, kThreads, (size_t)smem) !=
      cudaSuccess)
    return -1;
  return n;
}

// The instantiation a shape runs: dk <= 64 keeps 8 k steps of q in
// registers, else 16; dv <= 64 one pass of 8 output n-tiles (two blocks an
// SM), else passes of 16 (one block an SM: the footprint allows no more).
template <typename T, int M>
int launch_m(const Args& a) {
  if (a.dk <= 64)
    return a.dv <= 64 ? launch_scan<T, 8, 8, M>(a)
                      : launch_scan<T, 8, 16, M>(a);
  return launch_scan<T, 16, 8, M>(a);
}

template <typename T>
int launch_t(const Args& a) {
  if (a.mode == kSsd) return launch_m<T, kSsd>(a);
  if (a.mode == kRwkv6) return launch_m<T, kRwkv6>(a);
  return launch_m<T, kSsdScalar>(a);
}

template <typename T, int M>
int occupancy_m(int dk, int dv, long long smem) {
  if (dk <= 64)
    return dv <= 64 ? occupancy<T, 8, 8, M>(smem)
                    : occupancy<T, 8, 16, M>(smem);
  return occupancy<T, 16, 8, M>(smem);
}

template <typename T>
int occupancy_t(int mode, int dk, int dv, long long smem) {
  if (mode == kSsd) return occupancy_m<T, kSsd>(dk, dv, smem);
  if (mode == kRwkv6) return occupancy_m<T, kRwkv6>(dk, dv, smem);
  return occupancy_m<T, kSsdScalar>(dk, dv, smem);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block uses (see smem_bytes); size is the
// byte width of q, k, v.
long long ss_smem_bytes(int chunk, int dk, int dv, int size) {
  return smem_bytes(chunk, dk, dv, size);
}

long long ss_smem_budget(void) { return kSmemBudget; }

int ss_max_dk(void) { return kMaxDk; }

// Blocks of the kernel one SM holds at this shape and mode (-1 on error).
int ss_blocks_per_sm(int dtype, int mode, int chunk, int dk, int dv,
                     int size) {
  const long long smem = smem_bytes(chunk, dk, dv, size);
  if (mode < 0 || mode > 2) return -1;
  if (dtype == 0) return occupancy_t<float>(mode, dk, dv, smem);
  if (dtype == 1) return occupancy_t<__nv_bfloat16>(mode, dk, dv, smem);
  return -1;
}

// dtype (of q, k, v and out): 0 = float32, 1 = bfloat16.  mode: 0 = ssd
// with a per-channel log-decay [BH, T, dk], 1 = rwkv6 (u is read only
// then), 2 = ssd with one log-decay per token, [BH, T].  log-decay, u and
// the state are f32.  T must be a multiple of chunk, dk at most kMaxDk,
// and the footprint within the budget.
int ss_scan(int dtype, int mode, const void* q, const void* k, const void* v,
            const void* ld, const void* u, void* out, void* state, int BH,
            int Tn, int dk, int dv, int chunk, void* stream) {
  if (BH < 1 || Tn < 1 || dk < 1 || dk > kMaxDk || dv < 1 || chunk < 1 ||
      Tn % chunk != 0 || mode < 0 || mode > 2 || (dtype != 0 && dtype != 1) ||
      smem_bytes(chunk, dk, dv, dtype == 0 ? 4 : 2) > kSmemBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{mode, q, k, v, ld, u, out, state, BH, Tn, dk, dv, chunk,
               static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? launch_t<float>(a) : launch_t<__nv_bfloat16>(a);
}

const char* ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
