// Hand-written Hopper (sm_90a) kernels for the tensor-contraction hot spots.
//
// Port of the Pallas TPU kernels of src/repro/kernels/fused_contraction.py:
//
// * The GEMM replaces _matmul_kernel / matmul_pallas: C[M,N] = X[M,K] @ W
//   with W stored [K,N] or [N,K] ("transpose_rhs"), f32 accumulation,
//   output rounded to the operand type.  Its scaled form replaces
//   _matmul_scaled_kernel (matmul_pallas with scales=): fp8 e4m3/e5m2 or
//   int8 operands, epilogue (acc * sl[row]) * sr[col] in f32, so the
//   dequantization never takes its own pass over device memory.
//   What bounds it on the H100: bytes, at every geometry of the main
//   paths.  The TT plans' products have one small side (K = 1..128 with
//   M, N in the thousands: C's bytes; or M and N = 8..128 with K =
//   768..14,336: the operands' bytes), at most ~64 operations per byte
//   where the bf16 tensor cores need ~295 to be the limit.
//   Design: four warps per block and one output tile from a small table
//   (128x64 and 64x64, and 128x16 and 128x8 for the N = 12..16 and N = 8
//   products; fused_contraction.gemm_config picks it), operand tiles
//   staged 64 bytes of K at a time through a 4-deep ring of cp.async
//   copies (16 bytes each, narrower where a row pitch or base address is
//   not 16-byte aligned, e.g. K = 12 in bf16 or fp8; zero-filled past the
//   edges, so a ragged K adds zero terms), rows padded to an odd number of
//   16-byte units so ldmatrix reads hit distinct banks.  bf16 runs
//   mma.sync m16n8k16 and int8 m16n8k32 on the tensor cores; the [N,K]
//   layout is read by ldmatrix and the [K,N] one by ldmatrix.trans (an
//   8-bit [K,N] tile as byte pairs, regrouped by byte permutes): FETTA's
//   "layout reordering during computation" happens between shared memory
//   and registers, never in device memory.  The output tile is staged in
//   shared memory and written in 16-byte rows, which the C-bound products
//   (K = 8..64) need more than anything else.  Where the output tiles
//   cannot fill the card's 132 SMs and K is long, K is split into slices
//   (whole stages), each block writes an f32 partial tile and
//   gemm_splitk_reduce sums the slices in a fixed order and applies the
//   epilogue: no atomics, so the same inputs give the same bits on every
//   run.  f32 keeps the FMA units (TF32 holds ~3 decimal digits, under the
//   1e-5 gate) with the same tiles, ring and split-K.
//   fp8: the DeepSeek-V3 report (arXiv:2412.19437, section 3.3.2) measured
//   Hopper's fp8 tensor-core sums to keep ~14 significant bits.  Here the
//   fp8 bytes are widened exactly to f16 in registers (every e4m3 and e5m2
//   value is an f16) and run through the f16 mma with f32 accumulators,
//   and, as for int8's s32 sums, each stage's tensor-core sums (64
//   elements of K) are promoted into separate f32 registers: one promotion
//   per <= 128 elements, the report's interval.  The widening is kept
//   over the native e4m3/e5m2 mma.sync because its sums rest on the
//   documented f32 accumulation of the f16 mma, not on the fp8
//   datapath's undocumented width; measured on the H100, the native form
//   had no lower error and was no faster (PERF.md).
//
// * chain_tc_kernel replaces _chain_n_kernel / chain_n_pallas:
//   Y = (((X @ W1) -> regroup -> @ W2) ... @ Wn), every intermediate in
//   shared memory, rounded to bf16 after its link's f32 sum.  One block
//   owns a band of final output rows.  What bounds it on the H100: the
//   bytes of X, at every main-path chain (link 0 is a long skinny
//   product, X[rows, 8..3,072] @ W1[K, 8]; the later links read only
//   shared memory).  Design: X streams through the GEMM's cp.async ring
//   (copies narrowed for an unaligned row pitch, zero-filled past K),
//   the block's 8 warps split link 0's K and run mma.sync on it (bf16
//   m16n8k16; fp8 widened exactly to f16; int8 m16n8k32, exact s32), and
//   sum their partial tiles in warp order through shared memory, so a
//   call's bits never vary.  Link 0's epilogue writes element (r, c)
//   straight to row r / g, column (r mod g) n0 + c of link 1's A operand
//   in shared memory: FETTA's "tensor shaping during computation" as an
//   address map, with no pass of its own.  Later links run one m16n8
//   tile a warp from shared memory, W read as bf16; the last stages Y
//   for 16-byte stores.  fused_contraction.chain_config picks
//   band, warp slice and copy width; chain_tc_layout is the kernel's own
//   check of them.
//   Its scaled form replaces the quantized branch of _chain_n_kernel: X
//   and W in fp8/int8 (the interior weights read as bf16, exactly the
//   reference's cast), link 0 scaled per link-0 row by s_first, interior
//   links by one scalar each, the last link per output column by s_last;
//   every intermediate is rounded to bf16 after its scale, Y is f32.
//   chain_kernel keeps f32 chains on the FMA units (TF32 would miss the
//   1e-5 gate): one thread per output element, weights resident as f32.
//   Which chains fuse is fused_contraction.chain_band_rows' rule (the f32
//   kernel's footprint), so both kernels fuse the same chains.
//
// * Both take a batch axis (fc_matmul's and the chains' `batch`): the
//   reference vmaps matmul_pallas and chain_n_pallas over a MoE's experts,
//   a batched pallas_call.  Here one launch runs every expert: the GEMM's
//   batch shares blockIdx.z with the K slices (z = b * splits + slice;
//   the partials grow by the batch and the reduce sums each expert's own
//   slices), the chains' batch is blockIdx.y; each expert's operands sit
//   a fixed stride apart.  The same computation as one entry, indexed by
//   expert, with one entry's configuration.
//
// Plain C interface (loaded with ctypes): every launch goes to the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kMaxLinks = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory one block may use

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
// GEMM: a cp.async ring, tensor cores, deterministic split-K
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 128;  // four warps
constexpr int kGemmStages = 4;     // depth of the cp.async ring
constexpr int kStageBytes = 64;    // bytes of K per operand row per stage
// Blocks per SM the kernels are compiled for: a register cap of 170
// (65,536 / (3 * 128)).  Only the 8-bit 128x64 tile meets it (12-44 bytes
// of spills), and it measured faster so than at 2 blocks without them.
constexpr int kGemmMinBlocks = 3;
// The tile table (BM, BN), shared with fused_contraction.py's GEMM_TILES:
// 2x2 warps on the 64-wide tiles, 4x1 on the narrow ones.
constexpr int kGemmTiles = 4;
constexpr int kTileBM[kGemmTiles] = {128, 64, 128, 128};
constexpr int kTileBN[kGemmTiles] = {64, 64, 16, 8};

// Shared-memory row pitch: whole 16-byte units, an odd number of them, so
// the 8 rows one ldmatrix phase reads fall in 8 distinct bank groups.
__host__ __device__ constexpr int gemm_pitch(int row_bytes) {
  return 16 * (((row_bytes + 15) / 16) | 1);
}

// Bytes of dynamic shared memory one block of the GEMM uses (mirrored by
// fused_contraction.gemm_smem_bytes).
__host__ __device__ constexpr int gemm_smem_bytes(int size, bool trans,
                                                  int bm, int bn) {
  return kGemmStages *
         (bm * gemm_pitch(kStageBytes) +
          (trans ? bn * gemm_pitch(kStageBytes)
                 : (kStageBytes / size) * gemm_pitch(bn * size)));
}

// Bytes of the f32 output tile the tensor-core kernel stages in shared
// memory before it writes C (rows padded by 4 floats, 16-byte aligned).
__host__ __device__ constexpr int gemm_out_tile_bytes(int bm, int bn) {
  return bm * (bn + 4) * 4;
}

// D += A[16x16] B[16x8] in f16, f32 accumulators.
__device__ __forceinline__ void mma_f16(float* d, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// D += A[16x32] B[32x8] in int8, exact s32 accumulators.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp8 values (the low 16 bits of v, lower byte first) as f16x2, the
// lower one in the low half: exact for e4m3 and e5m2 alike.
template <typename T>
__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint32_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v & 0xffffu),
      std::is_same<T, __nv_fp8_e5m2>::value ? __NV_E5M2 : __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

// Copy rows [r0, r0 + kRows) x bytes [c0, c0 + kRowBytes) of a row-major
// global array (pitch gpitch bytes) into shared memory (pitch spitch),
// kW bytes per copy; rows >= rlim and bytes >= clim are zero-filled.
// kW >= 4 goes through cp.async; 2 and 1 (a row pitch or base that no
// wider copy divides) through plain loads and stores.
template <int kRows, int kRowBytes, int kW>
__device__ __forceinline__ void copy_tile_w(unsigned char* dst, int spitch,
                                            const unsigned char* src,
                                            size_t gpitch, int r0, int rlim,
                                            int c0, int clim) {
  constexpr int kChunks = kRowBytes / kW;
  if constexpr (kChunks > 0) {
    // Rolled: unrolled, the per-copy addresses of every width would be
    // hoisted out of the K loop and hold registers for the whole kernel.
#pragma unroll 1
    for (int e = threadIdx.x; e < kRows * kChunks; e += kGemmThreads) {
      const int r = e / kChunks, c = (e % kChunks) * kW;
      const int gr = r0 + r, gc = c0 + c;
      const int valid = gr < rlim ? min(max(clim - gc, 0), kW) : 0;
      const unsigned char* s = src + (valid > 0 ? gr * gpitch + gc : 0);
      unsigned char* d = dst + r * spitch + c;
      if constexpr (kW >= 4) {
        cp_async<kW>(smem_u32(d), s, valid);
      } else {
#pragma unroll
        for (int b = 0; b < kW; ++b) d[b] = b < valid ? s[b] : 0;
      }
    }
  }
}

template <int kRows, int kRowBytes>
__device__ __forceinline__ void copy_tile(int cw, unsigned char* dst,
                                          int spitch, const void* src,
                                          size_t gpitch, int r0, int rlim,
                                          int c0, int clim) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  switch (cw) {  // uniform across the grid
    case 16:
      copy_tile_w<kRows, kRowBytes, 16>(dst, spitch, s, gpitch, r0, rlim, c0,
                                        clim);
      break;
    case 8:
      copy_tile_w<kRows, kRowBytes, 8>(dst, spitch, s, gpitch, r0, rlim, c0,
                                       clim);
      break;
    case 4:
      copy_tile_w<kRows, kRowBytes, 4>(dst, spitch, s, gpitch, r0, rlim, c0,
                                       clim);
      break;
    case 2:
      copy_tile_w<kRows, kRowBytes, 2>(dst, spitch, s, gpitch, r0, rlim, c0,
                                       clim);
      break;
    default:
      copy_tile_w<kRows, kRowBytes, 1>(dst, spitch, s, gpitch, r0, rlim, c0,
                                       clim);
  }
}

// The ring: stage kt of this block's K slice is loaded kGemmStages - 1
// stages ahead of its product; one barrier per stage.  load(slot, kt)
// and compute(slot, kt) get the ring slot and the stage's index.
template <typename Load, typename Compute>
__device__ __forceinline__ void gemm_pipeline(int nk, Load&& load,
                                              Compute&& compute) {
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1's slot is free
    const int next = kt + kGemmStages - 1;
    if (next < nk) load(next % kGemmStages, next);
    cp_async_commit();
    compute(kt % kGemmStages, kt);
  }
}

// The one block's operand tiles of stage kt (K elements [kb, kb + BK)).
template <typename T, bool kTransRhs, int BM, int BN>
struct GemmTiles {
  static constexpr int kSize = sizeof(T);
  static constexpr int BK = kStageBytes / kSize;
  static constexpr int kXPitch = gemm_pitch(kStageBytes);
  static constexpr int kWPitch =
      kTransRhs ? gemm_pitch(kStageBytes) : gemm_pitch(BN * kSize);
  static constexpr int kXStage = BM * kXPitch;
  static constexpr int kWStage = (kTransRhs ? BN : BK) * kWPitch;
  static constexpr int kStage = kXStage + kWStage;  // one ring slot: X, then W

  __device__ static void load(unsigned char* smem, int slot, int kb,
                              int k_end, const T* x, const T* w, int M, int N,
                              int K, int m0, int n0, int cw) {
    unsigned char* xs = smem + slot * kStage;
    unsigned char* ws = xs + kXStage;
    copy_tile<BM, kStageBytes>(cw, xs, kXPitch, x, (size_t)K * kSize, m0, M,
                               kb * kSize, k_end * kSize);
    if constexpr (kTransRhs)  // W [N, K]: rows n, k contiguous
      copy_tile<BN, kStageBytes>(cw, ws, kWPitch, w, (size_t)K * kSize, n0,
                                 N, kb * kSize, k_end * kSize);
    else  // W [K, N]: rows k, n contiguous
      copy_tile<BK, BN * kSize>(cw, ws, kWPitch, w, (size_t)N * kSize, kb,
                                k_end, n0 * kSize, N * kSize);
  }
};

// The epilogue of one output element: the operand type's rounding, or
// (acc * sl[row]) * sr[col] in f32 for the scaled form.
template <typename T, typename TOut>
__device__ __forceinline__ TOut gemm_epilogue(float v, const float* sl,
                                              const float* sr, int row,
                                              int col) {
  if constexpr (sizeof(T) == 1)
    return __fmul_rn(__fmul_rn(v, sl[row]), sr[col]);
  else
    return from_f<TOut>(v);
}

// Write a BM x BN f32 tile staged in shared memory (pitch tp floats) to C
// through the epilogue, or to a split's partials, 4 columns (16 bytes of
// f32, 8 of bf16) per store where N allows.
template <typename T, typename TOut, int BM, int BN>
__device__ __forceinline__ void gemm_write_tile(const float* tile, int tp,
                                                TOut* out, float* part,
                                                const float* sl,
                                                const float* sr, int M, int N,
                                                int m0, int n0) {
  constexpr int kQ = BN / 4;
  const bool vec = (N % 4) == 0;
#pragma unroll 1
  for (int e = threadIdx.x; e < BM * kQ; e += kGemmThreads) {
    const int r = e / kQ, c = (e % kQ) * 4;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * tp + c);
    const float vs[4] = {v.x, v.y, v.z, v.w};
    const size_t o = (size_t)row * N + col;
    const bool full = vec && col + 3 < N;
    if (part != nullptr) {
      if (full) {
        *reinterpret_cast<float4*>(part + o) = v;
      } else {
        for (int k = 0; k < 4 && col + k < N; ++k) part[o + k] = vs[k];
      }
      continue;
    }
    TOut y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      y[k] = gemm_epilogue<T, TOut>(vs[k], sl, sr, row, min(col + k, N - 1));
    if (!full) {
      for (int k = 0; k < 4 && col + k < N; ++k) out[o + k] = y[k];
    } else if constexpr (std::is_same<TOut, float>::value) {
      *reinterpret_cast<float4*>(out + o) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      __nv_bfloat162 lo, hi;
      lo.x = y[0];
      lo.y = y[1];
      hi.x = y[2];
      hi.y = y[3];
      uint2 pk;
      pk.x = *reinterpret_cast<uint32_t*>(&lo);
      pk.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out + o) = pk;
    }
  }
}

// Tensor-core GEMM, one BM x BN output tile and one K slice of one batch
// entry per block (blockIdx.z = b * splits + slice; one split writes C,
// more write f32 partials to part[z] for gemm_splitk_reduce).  Batch entry
// b reads X at x + b * sx and W at w + b * sw (elements) and writes the
// b-th [M, N] of C: the expert axis of a vmapped matmul_pallas.
// bf16: m16n8k16 with f32 accumulators.
// fp8: each m16n8k32 step as two f16 m16n8k16 steps on the bytes widened
// exactly to f16 in registers, the tensor-core sums promoted into f32
// registers once per stage (64 elements of K).  int8: m16n8k32 with s32
// accumulators (exact), widened to f32 once per stage.  X and a [N, K] W
// reach the fragments with ldmatrix, a [K, N] W with ldmatrix.trans.
template <typename T, typename TOut, bool kTransRhs, int BM, int BN,
          int kWarpsM, int kWarpsN>
__global__ void __launch_bounds__(kGemmThreads, kGemmMinBlocks)
    gemm_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ sl, const float* __restrict__ sr,
                   TOut* __restrict__ out, float* __restrict__ part, int M,
                   int N, int K, int k_slice, int cw, int splits,
                   long long sx, long long sw) {
  using Tiles = GemmTiles<T, kTransRhs, BM, BN>;
  constexpr int kSize = sizeof(T);
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr bool kFp8 = kSize == 1 && !kInt8;
  constexpr int kWTM = BM / kWarpsM, kWTN = BN / kWarpsN;
  constexpr int MI = kWTM / 16, NI = kWTN / 8;
  constexpr int kXPitch = Tiles::kXPitch, kWPitch = Tiles::kWPitch;
  static_assert(kWarpsM * kWarpsN * 32 == kGemmThreads, "four warps");
  static_assert(MI >= 1 && NI >= 1, "warp tile below one mma atom");
  extern __shared__ __align__(16) unsigned char gemm_smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm0 = (warp / kWarpsN) * kWTM, wn0 = (warp % kWarpsN) * kWTN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int bz = blockIdx.z / splits;  // batch entry
  const int k_begin = (blockIdx.z - bz * splits) * k_slice;
  const int k_end = min(K, k_begin + k_slice);
  const int nk = (k_end - k_begin + Tiles::BK - 1) / Tiles::BK;
  x += bz * sx;
  w += bz * sw;
  out += (size_t)bz * M * N;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Per-lane shared-memory addresses of the fragments in ring slot 0; a
  // slot adds slot * kStage, a k-step 32 bytes (X, [N, K] W) or 16 (bf16)
  // or 32 (8-bit) rows ([K, N] W).
  const uint32_t x_frag = smem_u32(gemm_smem) +
                          (wm0 + (lane & 15)) * kXPitch + (lane >> 4) * 16;
  const uint32_t w_base = smem_u32(gemm_smem) + Tiles::kXStage;
  uint32_t w_frag;
  if constexpr (kTransRhs)  // [n][k] rows: matrices (n 0-7 | 8-15) x (k lo | hi)
    w_frag = w_base + (wn0 + (lane & 7) + (lane >> 4) * 8) * kWPitch +
             ((lane >> 3) & 1) * 16;
  else if constexpr (kSize == 2)  // bf16 [k][n]: (k 0-7 | 8-15) x (n 0-7 | 8-15)
    w_frag = w_base + ((lane & 7) + ((lane >> 3) & 1) * 8) * kWPitch +
             (wn0 + (lane >> 4) * 8) * 2;
  else  // 8-bit [k][n], see kPairCols
    w_frag = w_base +
             (16 * (lane >> 4) + 4 * ((lane & 7) >> 1) + (lane & 1) +
              2 * ((lane >> 3) & 1)) * kWPitch + wn0;
  // 8-bit [K, N] W with an even number of n8 blocks: ldmatrix.trans reads
  // byte pairs, so one x4 covers 16 columns x 2 x 16 k.  Matrix rows are
  // picked so that lane (g, q) holds k = 4q, 4q+1 (lo) and 4q+2, 4q+3 (hi)
  // of columns 2g and 2g+1; byte permutes make them the k32 fragments of
  // two mma blocks over the even and the odd columns, which the epilogue
  // puts back in order.  An odd count (the 128x8 tile) gathers bytes.
  constexpr bool kPairCols = kSize == 1 && !kTransRhs && NI % 2 == 0;

  auto load = [&](int slot, int kt) {
    Tiles::load(gemm_smem, slot, k_begin + kt * Tiles::BK, k_end, x, w, M, N, K,
                m0, n0, cw);
  };
  auto compute = [&](int slot, int) {
    const uint32_t xs = x_frag + slot * Tiles::kStage;
    const uint32_t wsa = w_frag + slot * Tiles::kStage;
    const unsigned char* ws = gemm_smem + slot * Tiles::kStage + Tiles::kXStage;
    // The 8-bit kinds sum each stage apart and promote it to acc after.
    using Part = typename std::conditional<kInt8, int, float>::type;
    Part stage[MI][NI][4];
    if constexpr (kSize == 1) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) stage[i][j][e] = 0;
    }
#pragma unroll
    for (int ks = 0; ks < kStageBytes / 32; ++ks) {  // 32 bytes of K a step
      const int kb = ks * 32;                       // byte column
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldsm_x4(xs + i * 16 * kXPitch + kb, a[i]);
      if constexpr (kTransRhs) {  // [n][k] rows: as X
#pragma unroll
        for (int j = 0; j + 1 < NI; j += 2) {
          uint32_t r[4];
          ldsm_x4(wsa + j * 8 * kWPitch + kb, r);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
        if constexpr (NI & 1)
          ldsm_x2(wsa + (NI - 1) * 8 * kWPitch + kb, b[NI - 1]);
      } else if constexpr (kSize == 2) {  // bf16 [k][n] rows: transposed
#pragma unroll
        for (int j = 0; j + 1 < NI; j += 2) {
          uint32_t r[4];
          ldsm_x4_t(wsa + ks * 16 * kWPitch + j * 16, r);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
        if constexpr (NI & 1)
          ldsm_x2_t(wsa + ks * 16 * kWPitch + (NI - 1) * 16, b[NI - 1]);
      } else if constexpr (kPairCols) {
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          uint32_t r[4];
          ldsm_x4_t(wsa + kb * kWPitch + j * 8, r);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            b[j][h] = __byte_perm(r[2 * h], r[2 * h + 1], 0x6420);
            b[j + 1][h] = __byte_perm(r[2 * h], r[2 * h + 1], 0x7531);
          }
        }
      } else {  // 8-bit [k][n], one n8 block: gather 4 k of column n
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned char* p =
                ws + (kb + h * 16 + q * 4) * kWPitch + wn0 + j * 8 + g;
            b[j][h] = static_cast<uint32_t>(p[0]) |
                      (static_cast<uint32_t>(p[kWPitch]) << 8) |
                      (static_cast<uint32_t>(p[2 * kWPitch]) << 16) |
                      (static_cast<uint32_t>(p[3 * kWPitch]) << 24);
          }
      }
      if constexpr (kSize == 2) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      } else if constexpr (kInt8) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
            mma_s8(stage[i][j], a[i], b[j][0], b[j][1]);
      } else {
        static_assert(kFp8, "fp8 operands");
        // A k32 register holds k = 4q..4q+3 of its row; widened, its lower
        // pair fills f16 slots 2q, 2q+1 and its upper pair slots 2q+8,
        // 2q+9 of a k16 step.  B is widened the same way, so slot s pairs
        // A and B at the same k and each k16 step sums the same 16 terms.
        uint32_t bw[NI][2][2];
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bw[j][h][0] = fp8x2_to_f16x2<T>(b[j][h]);
            bw[j][h][1] = fp8x2_to_f16x2<T>(b[j][h] >> 16);
          }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // k 0..15, then 16..31
            const uint32_t aw[4] = {fp8x2_to_f16x2<T>(a[i][2 * h]),
                                    fp8x2_to_f16x2<T>(a[i][2 * h + 1]),
                                    fp8x2_to_f16x2<T>(a[i][2 * h] >> 16),
                                    fp8x2_to_f16x2<T>(a[i][2 * h + 1] >> 16)};
#pragma unroll
            for (int j = 0; j < NI; ++j)
              mma_f16(stage[i][j], aw, bw[j][h][0], bw[j][h][1]);
          }
      }
    }
    if constexpr (kSize == 1) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += static_cast<float>(stage[i][j][e]);
    }
  };
  gemm_pipeline(nk, load, compute);

  float* p = splits > 1 ? part + (size_t)blockIdx.z * M * N : nullptr;
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: reuse it for the output tile
  constexpr int kTP = BN + 4;  // gemm_out_tile_bytes' pitch
  float* tile = reinterpret_cast<float*>(gemm_smem);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* trow = tile + (wm0 + i * 16 + g + 8 * h) * kTP + wn0;
      if constexpr (kPairCols) {
#pragma unroll
        for (int j = 0; j < NI; j += 2)
          *reinterpret_cast<float4*>(trow + j * 8 + 4 * q) =
              make_float4(acc[i][j][2 * h], acc[i][j + 1][2 * h],
                          acc[i][j][2 * h + 1], acc[i][j + 1][2 * h + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < NI; ++j)
          *reinterpret_cast<float2*>(trow + j * 8 + 2 * q) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  __syncthreads();
  gemm_write_tile<T, TOut, BM, BN>(tile, kTP, out, p, sl, sr, M, N, m0, n0);
}

// f32 GEMM on the FMA units (no TF32: it keeps ~3 decimal digits), the
// same tiles, ring, split-K and batch axis as gemm_tc_kernel; each thread owns a
// TM x TN register tile with stride-TY rows and stride-TX columns, so a
// warp writes contiguous runs of C.  K is summed with fmaf in order.
template <bool kTransRhs, int BM, int BN>
__global__ void __launch_bounds__(kGemmThreads, kGemmMinBlocks)
    gemm_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, float* __restrict__ part, int M,
                     int N, int K, int k_slice, int cw, int splits,
                     long long sx, long long sw) {
  using Tiles = GemmTiles<float, kTransRhs, BM, BN>;
  constexpr int TX = BN < 16 ? BN : 16, TY = kGemmThreads / TX;
  constexpr int TM = BM / TY, TN = BN / TX;
  constexpr int kXP = Tiles::kXPitch / 4, kWP = Tiles::kWPitch / 4;
  extern __shared__ __align__(16) unsigned char gemm_smem[];

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int bz = blockIdx.z / splits;  // batch entry
  const int k_begin = (blockIdx.z - bz * splits) * k_slice;
  const int k_end = min(K, k_begin + k_slice);
  const int nk = (k_end - k_begin + Tiles::BK - 1) / Tiles::BK;
  x += bz * sx;
  w += bz * sw;
  out += (size_t)bz * M * N;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto load = [&](int slot, int kt) {
    Tiles::load(gemm_smem, slot, k_begin + kt * Tiles::BK, k_end, x, w, M, N, K,
                m0, n0, cw);
  };
  auto compute = [&](int slot, int) {
    const float* xs =
        reinterpret_cast<const float*>(gemm_smem + slot * Tiles::kStage);
    const float* ws = xs + Tiles::kXStage / 4;
#pragma unroll
    for (int kk = 0; kk < Tiles::BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty + TY * i) * kXP + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = kTransRhs ? ws[(tx + TX * j) * kWP + kk]
                         : ws[kk * kWP + tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };
  gemm_pipeline(nk, load, compute);

  float* p = splits > 1 ? part + (size_t)blockIdx.z * M * N : out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + TY * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + TX * j;
      if (col < N) p[(size_t)row * N + col] = acc[i][j];
    }
  }
}

// Split-K's second pass: C = epilogue(part[0] + part[1] + ... +
// part[S-1]), summed in that fixed order (no atomics: the same inputs
// give the same bits on every run); batch entry b sums its own slices
// part[b * S .. b * S + S - 1].
template <typename T, typename TOut>
__global__ void __launch_bounds__(256)
    gemm_splitk_reduce(const float* __restrict__ part, int splits,
                       const float* __restrict__ sl,
                       const float* __restrict__ sr, TOut* __restrict__ out,
                       int M, int N, int batch) {
  const size_t mn = (size_t)M * N, total = mn * batch;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / mn, j = i - b * mn;
    const float* pb = part + b * splits * mn + j;
    float v = pb[0];
    for (int z = 1; z < splits; ++z) v += pb[(size_t)z * mn];
    const int row = static_cast<int>(j / N), col = static_cast<int>(j % N);
    out[i] = gemm_epilogue<T, TOut>(v, sl, sr, row, col);
  }
}

// Whether (tile, splits, cw) is a configuration the kernels take for
// these operands (the rule fused_contraction.gemm_config follows), with
// `batch` entries sx and sw elements apart; sets k_slice, the elements of
// K each split walks.
template <typename T>
bool gemm_config_ok(int trans, int tile, int splits, int cw, const void* x,
                    const void* w, const void* part, int M, int N, int K,
                    int batch, long long sx, long long sw, int* k_slice) {
  constexpr int kSize = sizeof(T);
  if (tile < 0 || tile >= kGemmTiles) return false;
  if (M <= 0 || N <= 0 || K < 0 || batch < 1 || sx < 0 || sw < 0)
    return false;
  if (cw != 1 && cw != 2 && cw != 4 && cw != 8 && cw != 16) return false;
  if (reinterpret_cast<uintptr_t>(x) % cw ||
      reinterpret_cast<uintptr_t>(w) % cw || ((size_t)K * kSize) % cw ||
      (sx * kSize) % cw || (sw * kSize) % cw)
    return false;
  if (!trans && (((size_t)N * kSize) % cw || cw > kTileBN[tile] * kSize))
    return false;
  const int bk = kStageBytes / kSize;
  const int steps = (K + bk - 1) / bk;
  if (splits < 1 || (long long)splits * batch > 65535) return false;
  if (steps == 0) {
    *k_slice = bk;
    return splits == 1;
  }
  const int per = (steps + splits - 1) / splits;
  if ((steps + per - 1) / per != splits) return false;  // no empty split
  if (splits > 1 && part == nullptr) return false;
  *k_slice = per * bk;
  return true;
}

template <typename T, typename TOut, bool kTrans, int BM, int BN, int kWM,
          int kWN>
int launch_gemm_tile(const void* x, const void* w, const float* sl,
                     const float* sr, void* out, float* part, int M, int N,
                     int K, int splits, int k_slice, int cw, int batch,
                     long long sx, long long sw, cudaStream_t stream) {
  constexpr int kRing = gemm_smem_bytes(sizeof(T), kTrans, BM, BN);
  static_assert(kRing <= kSmemLimit, "GEMM tile over the shared-memory budget");
  static_assert(gemm_out_tile_bytes(BM, BN) <= kRing, "output tile over the ring");
  // A slice of fewer stages than the ring uses only that many slots.
  const int stages = (k_slice * static_cast<int>(sizeof(T)) + kStageBytes - 1) /
                     kStageBytes;
  int smem = kRing / kGemmStages * std::max(1, std::min(stages, kGemmStages));
  if constexpr (!std::is_same<T, float>::value)  // the staged output tile
    smem = std::max(smem, gemm_out_tile_bytes(BM, BN));
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits * batch);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  TOut* op = static_cast<TOut*>(out);
  static bool attr_set = false;
  if constexpr (std::is_same<T, float>::value) {
    auto kern = gemm_simt_kernel<kTrans, BM, BN>;
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kRing);
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set = true;
    }
    kern<<<grid, kGemmThreads, smem, stream>>>(xp, wp, op, part, M, N, K,
                                               k_slice, cw, splits, sx, sw);
  } else {
    auto kern = gemm_tc_kernel<T, TOut, kTrans, BM, BN, kWM, kWN>;
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kRing);
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set = true;
    }
    kern<<<grid, kGemmThreads, smem, stream>>>(xp, wp, sl, sr, op, part, M,
                                               N, K, k_slice, cw, splits, sx,
                                               sw);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = (size_t)M * N * batch;
  const int blocks = static_cast<int>(
      std::min<size_t>((total + 255) / 256, (size_t)132 * 8));
  gemm_splitk_reduce<T, TOut>
      <<<blocks, 256, 0, stream>>>(part, splits, sl, sr, op, M, N, batch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TOut, bool kTrans>
int launch_gemm_trans(int tile, const void* x, const void* w, const float* sl,
                      const float* sr, void* out, float* part, int M, int N,
                      int K, int splits, int k_slice, int cw, int batch,
                      long long sx, long long sw, cudaStream_t s) {
  switch (tile) {
    case 0:
      return launch_gemm_tile<T, TOut, kTrans, 128, 64, 2, 2>(
          x, w, sl, sr, out, part, M, N, K, splits, k_slice, cw, batch, sx,
          sw, s);
    case 1:
      return launch_gemm_tile<T, TOut, kTrans, 64, 64, 2, 2>(
          x, w, sl, sr, out, part, M, N, K, splits, k_slice, cw, batch, sx,
          sw, s);
    case 2:
      return launch_gemm_tile<T, TOut, kTrans, 128, 16, 4, 1>(
          x, w, sl, sr, out, part, M, N, K, splits, k_slice, cw, batch, sx,
          sw, s);
    case 3:
      return launch_gemm_tile<T, TOut, kTrans, 128, 8, 4, 1>(
          x, w, sl, sr, out, part, M, N, K, splits, k_slice, cw, batch, sx,
          sw, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename TOut>
int launch_gemm(int trans, int tile, int splits, int cw, const void* x,
                const void* w, const float* sl, const float* sr, void* out,
                void* part, int M, int N, int K, int batch, long long sx,
                long long sw, cudaStream_t s) {
  int k_slice = 0;
  if (!gemm_config_ok<T>(trans, tile, splits, cw, x, w, part, M, N, K, batch,
                         sx, sw, &k_slice))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pp = static_cast<float*>(part);
  if (trans)
    return launch_gemm_trans<T, TOut, true>(tile, x, w, sl, sr, out, pp, M, N,
                                            K, splits, k_slice, cw, batch, sx,
                                            sw, s);
  return launch_gemm_trans<T, TOut, false>(tile, x, w, sl, sr, out, pp, M, N,
                                           K, splits, k_slice, cw, batch, sx,
                                           sw, s);
}

// ---------------------------------------------------------------------------
// N-link chain: f32 on the FMA units
// ---------------------------------------------------------------------------

struct ChainArgs {
  const float* w[kMaxLinks];  // W_i, row-major [k_i, n_i]
  int k[kMaxLinks];
  int n[kMaxLinks];
  int mult[kMaxLinks];   // link i's rows per final output row
  int w_off[kMaxLinks];  // float offset of W_i in shared memory
  int buf_off[2];        // float offsets of the ping-pong intermediates
  int links;
  int m_final;  // final output rows
  int band;     // final output rows per block
  // Batch entry blockIdx.y reads X, W_i and writes Y these many elements
  // past entry 0 (a vmapped chain_n_pallas: one chain per expert).
  long long x_stride, out_stride, w_stride[kMaxLinks];
};

// One thread per output element of a link, K walked serially with fmaf;
// every weight resident in shared memory, the intermediates ping-pong
// between two buffers and are read regrouped as [rows, k] views.
__global__ void chain_kernel(const float* __restrict__ x,
                             float* __restrict__ out, ChainArgs a) {
  extern __shared__ float smem[];
  x += blockIdx.y * a.x_stride;
  out += blockIdx.y * a.out_stride;
  for (int i = 0; i < a.links; ++i) {
    const float* w = a.w[i] + blockIdx.y * a.w_stride[i];
    float* dst = smem + a.w_off[i];
    const int cnt = a.k[i] * a.n[i];
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) dst[e] = w[e];
  }
  __syncthreads();

  const int f0 = blockIdx.x * a.band;  // first final row of this band
  const int rows_final = min(a.band, a.m_final - f0);
  const float* xband = x + (size_t)f0 * a.mult[0] * a.k[0];
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
      if (i == 0) {  // X from device memory
        const float* xr = xband + (size_t)r * k;
        for (int kk = 0; kk < k; ++kk) acc = fmaf(xr[kk], wsm[kk * n + c], acc);
      } else {
        // The regroup: row r of the [rows, k] view of the contiguous
        // [rows_prev, n_prev] intermediate of this band.
        const float* hr = src + (size_t)r * k;
        for (int kk = 0; kk < k; ++kk) acc = fmaf(hr[kk], wsm[kk * n + c], acc);
      }
      if (last)
        out[((size_t)f0 + r) * n + c] = acc;
      else
        dst[o] = acc;
    }
    __syncthreads();
  }
}

int launch_chain(const void* x, const void* const* ws, const int* ks,
                 const int* ns, const int* mults, int links, int m_final,
                 int band, int threads, void* out, int batch,
                 long long x_stride, const long long* w_strides,
                 long long out_stride, cudaStream_t stream) {
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  ChainArgs a{};
  int off = 0, max_mid = 0;
  for (int i = 0; i < links; ++i) {
    a.w[i] = static_cast<const float*>(ws[i]);
    a.k[i] = ks[i];
    a.n[i] = ns[i];
    a.mult[i] = mults[i];
    a.w_off[i] = off;
    a.w_stride[i] = w_strides[i];
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
  a.x_stride = x_stride;
  a.out_stride = out_stride;
  const size_t smem = (size_t)off * sizeof(float);
  if (smem > (size_t)kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m_final + band - 1) / band, batch);
  chain_kernel<<<grid, threads, smem, stream>>>(static_cast<const float*>(x),
                                                static_cast<float*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// N-link chain on the tensor cores: bf16, fp8 e4m3/e5m2, int8
// ---------------------------------------------------------------------------

constexpr int kChainWarps = 8;
constexpr int kChainThreads = kChainWarps * 32;
constexpr int kChainRowTile = 64;      // link-0 rows of one pass: 4 m16 tiles
constexpr int kChainMaxWarpSteps = 8;  // 32-byte k-steps a warp takes a stage

constexpr long long align16(long long b) { return (b + 15) / 16 * 16; }

// Row pitch of an interior link's A operand (bf16, K padded with zeros to
// whole k16 steps; an odd number of 16-byte units, as the GEMM's tiles).
__host__ __device__ constexpr int chain_a_pitch(int k) {
  return gemm_pitch((k + 15) / 16 * 32);
}

struct ChainTcArgs {
  const void* w[kMaxLinks];  // W_i, row-major [k_i, n_i]
  // The scaled chain's factors: link 0's per link-0 row, one scalar per
  // interior link, the last link's per output column.
  const float* s[kMaxLinks];
  int k[kMaxLinks], n[kMaxLinks];
  int mult[kMaxLinks];     // link i's rows per final output row
  int w_off[kMaxLinks];    // byte offset of W_i, in X's type
  int s_off[kMaxLinks];    // byte offset of link i's scales (scaled chain)
  int a_off[kMaxLinks];    // byte offset of link i's A operand (i >= 1)
  int a_pitch[kMaxLinks];  // and its row pitch in bytes
  int y_off;               // the block's Y rows, flat
  int ring_off;            // link 0's X ring; its partial sums alias it
  int ring_pitch;          // bytes of one X row in a ring slot
  int ring_slot;           // bytes of one ring slot
  int stage_bytes;         // bytes of K0 a stage holds (whole 32-byte k-steps)
  int warp_steps;          // k-steps each warp takes of a stage
  int stages;              // stages of K0 a pass walks
  int links, m_final, band, cw;
  // Batch entry blockIdx.y (one chain per expert): X, W_i and Y this many
  // bytes past entry 0.
  long long x_stride, out_stride, w_stride[kMaxLinks];
};

// The shared-memory layout of one chain block (mirrored by
// fused_contraction.chain_tc_smem_bytes); returns its bytes, or -1 for
// geometry or a warp slice the kernel does not take.  warp_k: elements
// of K0 each warp takes of a stage.
long long chain_tc_layout(int size, int out_size, const int* ks,
                          const int* ns, const int* mults, int links,
                          int band, int warp_k, ChainTcArgs* a) {
  if (links < 2 || links > kMaxLinks || band < 1 || warp_k < 1) return -1;
  if ((warp_k * size) % 32 || warp_k * size / 32 > kChainMaxWarpSteps)
    return -1;
  for (int i = 0; i < links; ++i) {
    if (ks[i] < 1 || ns[i] < 1 || mults[i] < 1) return -1;
    if (i > 0 && (ks[i] % ns[i - 1] ||
                  mults[i - 1] != mults[i] * (ks[i] / ns[i - 1])))
      return -1;
  }
  if (mults[links - 1] != 1) return -1;
  long long off = 0;
  for (int i = 0; i < links; ++i) {
    a->w_off[i] = static_cast<int>(off);
    off += align16((long long)ks[i] * ns[i] * size);
  }
  for (int i = 0; size == 1 && i < links; ++i) {  // the block's scales
    a->s_off[i] = static_cast<int>(off);
    const long long cnt =
        i == 0 ? (long long)band * mults[0] : i == links - 1 ? ns[i] : 1;
    off += align16(cnt * 4);
  }
  for (int i = 1; i < links; ++i) {
    a->a_pitch[i] = chain_a_pitch(ks[i]);
    a->a_off[i] = static_cast<int>(off);
    off += (long long)band * mults[i] * a->a_pitch[i];
  }
  a->y_off = static_cast<int>(off);
  off += align16((long long)band * ns[links - 1] * out_size);
  const int ksteps = (ks[0] * size + 31) / 32;
  a->warp_steps = warp_k * size / 32;
  const int stage_steps = std::min(kChainWarps * a->warp_steps, ksteps);
  a->stage_bytes = 32 * stage_steps;
  a->stages = (ksteps + stage_steps - 1) / stage_steps;
  const int rv = static_cast<int>(
      std::min<long long>(kChainRowTile, (long long)band * mults[0]));
  a->ring_pitch = gemm_pitch(a->stage_bytes);
  a->ring_slot = rv * a->ring_pitch;
  const long long ring =
      (long long)std::min(kGemmStages, a->stages) * a->ring_slot;
  const long long part = (long long)kChainWarps * ((rv + 15) / 16 * 16) * 8 * 4;
  a->ring_off = static_cast<int>(off);
  off += std::max(ring, part);
  return off;
}

// Copy `bytes` contiguous bytes to shared memory: cp.async in the widest of
// 16, 8, 4 bytes that the source address allows, byte by byte below that
// and for a tail.
__device__ __forceinline__ void copy_flat(unsigned char* dst,
                                          const void* src_, int bytes) {
  const unsigned char* src = static_cast<const unsigned char*>(src_);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const int w = sa % 16 == 0 ? 16 : sa % 8 == 0 ? 8 : sa % 4 == 0 ? 4 : 1;
  const int chunks = bytes / w;
#pragma unroll 1
  for (int e = threadIdx.x; e < chunks; e += kChainThreads) {
    const uint32_t d = smem_u32(dst + e * w);
    if (w == 16)
      cp_async<16>(d, src + e * 16, 16);
    else if (w == 8)
      cp_async<8>(d, src + e * 8, 8);
    else if (w == 4)
      cp_async<4>(d, src + e * 4, 4);
    else
      dst[e] = src[e];
  }
  for (int e = chunks * w + threadIdx.x; e < bytes; e += kChainThreads)
    dst[e] = src[e];
}

// Rows [0, rows) x bytes [c0, c0 + cbytes) of a row-major global array
// (pitch gpitch) into shared memory (pitch spitch), kW bytes a copy,
// zero-filled past byte clim of a row.
template <int kW>
__device__ __forceinline__ void copy_rows_w(unsigned char* dst, int spitch,
                                            const unsigned char* src,
                                            int gpitch, int rows, int c0,
                                            int cbytes, int clim) {
  const int per = cbytes / kW;
#pragma unroll 1
  for (int e = threadIdx.x; e < rows * per; e += kChainThreads) {
    const int r = e / per, c = (e - r * per) * kW;
    const int gc = c0 + c;
    const int valid = min(max(clim - gc, 0), kW);
    const unsigned char* s = src + (valid > 0 ? (size_t)r * gpitch + gc : 0);
    unsigned char* d = dst + r * spitch + c;
    if constexpr (kW >= 4) {
      cp_async<kW>(smem_u32(d), s, valid);
    } else {
#pragma unroll
      for (int b = 0; b < kW; ++b) d[b] = b < valid ? s[b] : 0;
    }
  }
}

__device__ __forceinline__ void copy_rows(int cw, unsigned char* dst,
                                          int spitch, const unsigned char* src,
                                          int gpitch, int rows, int c0,
                                          int cbytes, int clim) {
  switch (cw) {  // uniform across the grid
    case 16:
      copy_rows_w<16>(dst, spitch, src, gpitch, rows, c0, cbytes, clim);
      break;
    case 8:
      copy_rows_w<8>(dst, spitch, src, gpitch, rows, c0, cbytes, clim);
      break;
    case 4:
      copy_rows_w<4>(dst, spitch, src, gpitch, rows, c0, cbytes, clim);
      break;
    case 2:
      copy_rows_w<2>(dst, spitch, src, gpitch, rows, c0, cbytes, clim);
      break;
    default:
      copy_rows_w<1>(dst, spitch, src, gpitch, rows, c0, cbytes, clim);
  }
}

// Element (k, n) of a row-major [K, N] matrix of 16-bit or 8-bit values
// in shared memory, zero past its edges (a k-step or n8 tile ragged).
__device__ __forceinline__ uint32_t w16(const uint16_t* w, int k, int n,
                                        int K, int N) {
  return k < K && n < N ? w[k * N + n] : 0u;
}
__device__ __forceinline__ uint32_t w8(const uint8_t* w, int k, int n, int K,
                                       int N) {
  return k < K && n < N ? w[k * N + n] : 0u;
}
// The same element of a W in T as bf16 bits (exact from fp8/int8).
template <typename T>
__device__ __forceinline__ uint32_t wbf16(const unsigned char* w, int k,
                                          int n, int K, int N) {
  if constexpr (sizeof(T) == 2) {
    return w16(reinterpret_cast<const uint16_t*>(w), k, n, K, N);
  } else {
    if (k >= K || n >= N) return 0u;
    return __bfloat16_as_ushort(
        __float2bfloat16(to_f(reinterpret_cast<const T*>(w)[k * N + n])));
  }
}

// Tensor-core chain: one block owns a band of final rows and runs every
// link with the intermediates in shared memory.
// * Link 0 (long K: up to 3,072 on the main paths): passes of up to 64
//   link-0 rows x one n8 tile; X streams through the GEMM's 4-deep
//   cp.async ring, the 8 warps split each stage's k-steps, and the warps'
//   partial tiles are summed in warp order through shared memory (the
//   same bits on every call).  A warp issues its k-steps of a stage
//   together (their loads in flight at once) into two accumulator sets:
//   one serial chain of dependent loads and mma.sync per k-step cost more
//   than the bytes.  The epilogue applies s_first, rounds to bf16 and
//   stores element (r, c) at row r / g, column (r mod g) n0 + c of link
//   1's A operand: the regroup is the store's address map.
// * Links 1.. (K and N of 8..128, a few hundred rows at most): one m16n8
//   tile per warp at a time over the whole K, two k-steps at a time, A by
//   ldmatrix, W read as bf16 (an 8-bit W widened exactly as it is read);
//   the last link stages Y in shared memory for 16-byte stores.
// bf16 runs m16n8k16; fp8 widens each k32 step exactly to two f16 k16
// steps and int8 runs m16n8k32 into s32, each k32 step's sums promoted
// into f32 registers.  Rows past a pass's or link's end read a clamped
// row (their outputs are dropped); K past the edge reads zeros, and a
// k-step past a warp's share reads a valid address and a zero W.
template <typename T, typename TOut, bool kScaled>
__global__ void __launch_bounds__(kChainThreads)
    chain_tc_kernel(const T* __restrict__ x, TOut* __restrict__ out,
                    ChainTcArgs a) {
  constexpr int kSize = sizeof(T);
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr bool kFp8 = kSize == 1 && !kInt8;
  extern __shared__ __align__(16) unsigned char chain_smem[];
  unsigned char* smem = chain_smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int f0 = blockIdx.x * a.band;
  const int rows_final = min(a.band, a.m_final - f0);
  const int k0 = a.k[0], n0 = a.n[0];
  const int row_bytes = k0 * kSize;
  const int rows0 = rows_final * a.mult[0];  // this block's link-0 rows
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x) +
                            blockIdx.y * a.x_stride +
                            (size_t)f0 * a.mult[0] * row_bytes;

  // Every weight in X's type, and the scaled chain's scales of this block,
  // by cp.async: one group ahead of the ring's, so no plain load stalls
  // the block before its X is in flight.  The A operands are zeroed: their
  // pad columns meet the zero rows of W past K.
  for (int i = 0; i < a.links; ++i)
    copy_flat(smem + a.w_off[i],
              static_cast<const unsigned char*>(a.w[i]) +
                  blockIdx.y * a.w_stride[i],
              a.k[i] * a.n[i] * kSize);
  if constexpr (kScaled) {
    copy_flat(smem + a.s_off[0], a.s[0] + (size_t)f0 * a.mult[0], rows0 * 4);
    for (int i = 1; i < a.links; ++i)
      copy_flat(smem + a.s_off[i], a.s[i],
                (i == a.links - 1 ? a.n[i] : 1) * 4);
  }
  cp_async_commit();
  for (int i = 1; i < a.links; ++i) {
    uint4* z = reinterpret_cast<uint4*>(smem + a.a_off[i]);
    const int cnt = a.band * a.mult[i] * a.a_pitch[i] / 16;
    for (int e = threadIdx.x; e < cnt; e += kChainThreads)
      z[e] = make_uint4(0, 0, 0, 0);
  }

  // -- link 0 ---------------------------------------------------------------
  const int ksteps = (row_bytes + 31) / 32;
  const int stage_steps = a.stage_bytes / 32;
  const int g1 = a.k[1] / n0;  // link 1's regroup factor
  unsigned char* a1 = smem + a.a_off[1];
  float* part = reinterpret_cast<float*>(smem + a.ring_off);
  const uint8_t* w0b = smem + a.w_off[0];
  const float* s0 = reinterpret_cast<const float*>(smem + a.s_off[0]);
  for (int p0 = 0; p0 < rows0; p0 += kChainRowTile) {
    const int rv = min(kChainRowTile, rows0 - p0);
    const int mts = (rv + 15) / 16;
    const unsigned char* xp = xb + (size_t)p0 * row_bytes;
    for (int c0 = 0; c0 < n0; c0 += 8) {
      float acc[2][4][4];  // two sets: even and odd k-steps of a stage
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][i][e] = 0.f;
      const int n = c0 + g;  // this lane's W_0 column
      auto load = [&](int slot, int st) {
        const int cb = st * a.stage_bytes;
        copy_rows(a.cw, smem + a.ring_off + slot * a.ring_slot, a.ring_pitch,
                  xp, row_bytes, rv, cb,
                  min(a.stage_bytes, (ksteps * 32) - cb), row_bytes);
      };
      auto compute = [&](int slot, int st) {
        const unsigned char* xs = smem + a.ring_off + slot * a.ring_slot;
        // this warp's k-steps of the stage: [ls0, ls0 + steps)
        const int ls0 = warp * a.warp_steps;
        const int steps = min(min(a.warp_steps, stage_steps - ls0),
                              ksteps - st * stage_steps - ls0);
        if (steps <= 0) return;
        // W_0's fragments of every k-step first, then per m16 tile the A
        // fragments of every k-step, then the products: the loads of a
        // stage are in flight together.
        uint32_t b[kChainMaxWarpSteps][2];
#pragma unroll
        for (int t = 0; t < kChainMaxWarpSteps; ++t) {
          if (t >= steps) break;
          const int kk = (st * stage_steps + ls0 + t) * (32 / kSize);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (kSize == 2) {
              const uint16_t* w = reinterpret_cast<const uint16_t*>(w0b);
              const int k = kk + 2 * q + 8 * h;
              b[t][h] = w16(w, k, n, k0, n0) | (w16(w, k + 1, n, k0, n0) << 16);
            } else {
              const int k = kk + 16 * h + 4 * q;
              b[t][h] = w8(w0b, k, n, k0, n0) |
                        (w8(w0b, k + 1, n, k0, n0) << 8) |
                        (w8(w0b, k + 2, n, k0, n0) << 16) |
                        (w8(w0b, k + 3, n, k0, n0) << 24);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= mts) break;
          const int row = min(mt * 16 + (lane & 15), rv - 1);
          const uint32_t arow = smem_u32(xs + row * a.ring_pitch +
                                         ls0 * 32 + (lane >> 4) * 16);
          uint32_t af[kChainMaxWarpSteps][4];
#pragma unroll
          for (int t = 0; t < kChainMaxWarpSteps; ++t)
            if (t < steps) ldsm_x4(arow + t * 32, af[t]);
#pragma unroll
          for (int t = 0; t < kChainMaxWarpSteps; ++t) {
            if (t >= steps) break;
            float* c = acc[t & 1][mt];
            if constexpr (kSize == 2) {
              mma_bf16(c, af[t], b[t][0], b[t][1]);
            } else if constexpr (kInt8) {
              int sum[4] = {0, 0, 0, 0};
              mma_s8(sum, af[t], b[t][0], b[t][1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) c[e] += static_cast<float>(sum[e]);
            } else {
              // As gemm_tc_kernel: a k32 register's lower pair fills f16
              // slots 2q, 2q+1 and its upper pair 2q+8, 2q+9 of a k16 step.
              float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t aw[4] = {
                    fp8x2_to_f16x2<T>(af[t][2 * h]),
                    fp8x2_to_f16x2<T>(af[t][2 * h + 1]),
                    fp8x2_to_f16x2<T>(af[t][2 * h] >> 16),
                    fp8x2_to_f16x2<T>(af[t][2 * h + 1] >> 16)};
                mma_f16(sum, aw, fp8x2_to_f16x2<T>(b[t][h]),
                        fp8x2_to_f16x2<T>(b[t][h] >> 16));
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) c[e] += sum[e];
            }
          }
        }
      };
      gemm_pipeline(a.stages, load, compute);
      cp_async_wait<0>();
      __syncthreads();  // the ring is drained: its space takes the partials
      const int rp = mts * 16;
      float* mine = part + warp * rp * 8;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mts) break;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(mine + (mt * 16 + g + 8 * h) * 8 + 2 * q) =
              make_float2(acc[0][mt][2 * h] + acc[1][mt][2 * h],
                          acc[0][mt][2 * h + 1] + acc[1][mt][2 * h + 1]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < rv * 8; e += kChainThreads) {
        const int r = e >> 3, c = c0 + (e & 7);
        if (c >= n0) continue;
        float v = part[e];
#pragma unroll
        for (int w = 1; w < kChainWarps; ++w) v += part[w * rp * 8 + e];
        const int rr = p0 + r;  // the block's link-0 row
        if constexpr (kScaled)
          v = __fmul_rn(v, s0[rr]);
        *reinterpret_cast<__nv_bfloat16*>(
            a1 + (rr / g1) * a.a_pitch[1] + ((rr % g1) * n0 + c) * 2) =
            __float2bfloat16(v);
      }
      __syncthreads();  // A_1 written; the ring is free again
    }
  }

  // -- links 1.. --------------------------------------------------------------
  TOut* ys = reinterpret_cast<TOut*>(smem + a.y_off);
  for (int i = 1; i < a.links; ++i) {
    const int k = a.k[i], n = a.n[i];
    const int rows = rows_final * a.mult[i];
    const int mts = (rows + 15) / 16, nts = (n + 7) / 8;
    const int ks = (k + 15) / 16;
    const bool last = i == a.links - 1;
    const unsigned char* w = smem + a.w_off[i];
    const float* sc = reinterpret_cast<const float*>(smem + a.s_off[i]);
    const unsigned char* ai = smem + a.a_off[i];
    const int gi = last ? 1 : a.k[i + 1] / n;
    for (int t = warp; t < mts * nts; t += kChainWarps) {
      const int mt = t / nts, nt = t - mt * nts;
      const int row = min(mt * 16 + (lane & 15), rows - 1);
      const uint32_t abase =
          smem_u32(ai + row * a.a_pitch[i] + (lane >> 4) * 16);
      const int col = nt * 8 + g;
      float acc[2][4] = {};  // even and odd k-steps
#pragma unroll 1
      for (int s0 = 0; s0 < ks; s0 += 2) {
        const int np = min(2, ks - s0);
        uint32_t af[2][4], b[2][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (p >= np) break;
          ldsm_x4(abase + (s0 + p) * 32, af[p]);
          const int kk = (s0 + p) * 16 + 2 * q;
          b[p][0] = wbf16<T>(w, kk, col, k, n) |
                    (wbf16<T>(w, kk + 1, col, k, n) << 16);
          b[p][1] = wbf16<T>(w, kk + 8, col, k, n) |
                    (wbf16<T>(w, kk + 9, col, k, n) << 16);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (p < np) mma_bf16(acc[p], af[p], b[p][0], b[p][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + 8 * (e >> 1), c = nt * 8 + 2 * q + (e & 1);
        if (r >= rows || c >= n) continue;
        float v = acc[0][e] + acc[1][e];
        if constexpr (kScaled) v = __fmul_rn(v, sc[last ? c : 0]);
        if (last) {
          ys[r * n + c] = from_f<TOut>(v);
        } else {
          *reinterpret_cast<__nv_bfloat16*>(
              smem + a.a_off[i + 1] + (r / gi) * a.a_pitch[i + 1] +
              ((r % gi) * n + c) * 2) = __float2bfloat16(v);
        }
      }
    }
    __syncthreads();
  }

  // -- Y: the block's rows are one contiguous run of the output -------------
  const int ybytes =
      rows_final * a.n[a.links - 1] * static_cast<int>(sizeof(TOut));
  unsigned char* yd = reinterpret_cast<unsigned char*>(
                          out + (size_t)f0 * a.n[a.links - 1]) +
                      blockIdx.y * a.out_stride;
  const unsigned char* yb = smem + a.y_off;
  const uintptr_t ya = reinterpret_cast<uintptr_t>(yd);
  if (ya % 16 == 0 && ybytes % 16 == 0) {
    for (int e = threadIdx.x; e < ybytes / 16; e += kChainThreads)
      reinterpret_cast<uint4*>(yd)[e] = reinterpret_cast<const uint4*>(yb)[e];
  } else if (ya % 4 == 0 && ybytes % 4 == 0) {
    for (int e = threadIdx.x; e < ybytes / 4; e += kChainThreads)
      reinterpret_cast<uint32_t*>(yd)[e] =
          reinterpret_cast<const uint32_t*>(yb)[e];
  } else {
    for (int e = threadIdx.x; e < ybytes / 2; e += kChainThreads)
      reinterpret_cast<uint16_t*>(yd)[e] =
          reinterpret_cast<const uint16_t*>(yb)[e];
  }
}

// Whether the kernel takes cw for this X (alignment of its base, its row
// pitch and the bytes between batch entries).
bool chain_cw_ok(int cw, const void* x, int row_bytes, long long x_stride) {
  return (cw == 1 || cw == 2 || cw == 4 || cw == 8 || cw == 16) &&
         reinterpret_cast<uintptr_t>(x) % cw == 0 && row_bytes % cw == 0 &&
         x_stride % cw == 0;
}

template <typename T, typename TOut, bool kScaled>
int launch_chain_tc(const void* x, const void* const* ws,
                    const float* const* scales, const int* ks, const int* ns,
                    const int* mults, int links, int m_final, int band,
                    int warp_k, int cw, void* out, int batch,
                    long long x_stride, const long long* w_strides,
                    long long out_stride, cudaStream_t stream) {
  ChainTcArgs a{};
  const long long smem = chain_tc_layout(sizeof(T), sizeof(TOut), ks, ns,
                                         mults, links, band, warp_k, &a);
  const long long sz = sizeof(T);
  // The scaled chain's scales have no batch axis: it runs one chain.
  if (smem < 0 || smem > kSmemLimit || m_final < 1 || batch < 1 ||
      batch > 65535 || (kScaled && batch != 1) ||
      !chain_cw_ok(cw, x, ks[0] * static_cast<int>(sizeof(T)),
                   x_stride * sz))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = chain_tc_kernel<T, TOut, kScaled>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  for (int i = 0; i < links; ++i) {
    a.w[i] = ws[i];
    a.w_stride[i] = w_strides[i] * sz;
    a.s[i] = kScaled ? scales[i] : nullptr;
    a.k[i] = ks[i];
    a.n[i] = ns[i];
    a.mult[i] = mults[i];
  }
  a.links = links;
  a.m_final = m_final;
  a.band = band;
  a.cw = cw;
  a.x_stride = x_stride * sz;
  a.out_stride = out_stride * static_cast<long long>(sizeof(TOut));
  const dim3 grid((m_final + band - 1) / band, batch);
  kern<<<grid, kChainThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(x), static_cast<TOut*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes (shared with kernels/quantized.cu): 0 = float32,
// 1 = bfloat16, 2 = fp8 e4m3, 3 = fp8 e5m2, 4 = int8.
//
// The GEMMs take the configuration fused_contraction.gemm_config chose:
// tile (an index into kTileBM/kTileBN), splits (K slices, one block each
// per output tile; above 1, part is an f32 workspace [splits, M, N]) and
// cw (bytes per copy: 16, 8, 4 by cp.async, 2 or 1 by plain loads).  A
// configuration the kernels do not take returns cudaErrorInvalidValue.
// fc_matmul runs `batch` products at once (one launch): X entries sx
// elements apart, W entries sw apart, C entries M * N apart (contiguous);
// part is then [batch, splits, M, N].  batch 1 is the plain GEMM.
int fc_matmul(int dtype, int trans, const void* x, const void* w, void* out,
              void* part, int batch, long long sx, long long sw, int M, int N,
              int K, int tile, int splits, int cw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gemm<float, float>(trans, tile, splits, cw, x, w, nullptr,
                                     nullptr, out, part, M, N, K, batch, sx,
                                     sw, s);
  if (dtype == 1)
    return launch_gemm<__nv_bfloat16, __nv_bfloat16>(
        trans, tile, splits, cw, x, w, nullptr, nullptr, out, part, M, N, K,
        batch, sx, sw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C[M, N] = (Xq @ Wq) * sl[M] * sr[N] in f32; dtype 2, 3 or 4.
int fc_matmul_scaled(int dtype, int trans, const void* x, const void* w,
                     const void* sl, const void* sr, void* out, void* part,
                     int M, int N, int K, int tile, int splits, int cw,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(sl);
  const float* r = static_cast<const float*>(sr);
  if (dtype == 2)
    return launch_gemm<__nv_fp8_e4m3, float>(trans, tile, splits, cw, x, w, l,
                                             r, out, part, M, N, K, 1, 0, 0, s);
  if (dtype == 3)
    return launch_gemm<__nv_fp8_e5m2, float>(trans, tile, splits, cw, x, w, l,
                                             r, out, part, M, N, K, 1, 0, 0, s);
  if (dtype == 4)
    return launch_gemm<int8_t, float>(trans, tile, splits, cw, x, w, l, r,
                                      out, part, M, N, K, 1, 0, 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The GEMM's shared memory per block for an operand of `size` bytes, or -1
// for a tile the table does not have.
int fc_gemm_smem_bytes(int size, int trans, int tile) {
  if (tile < 0 || tile >= kGemmTiles) return -1;
  return gemm_smem_bytes(size, trans != 0, kTileBM[tile], kTileBN[tile]);
}

// The elements of K each split walks under this configuration, or -1
// where the kernels refuse it (pointers are only checked for alignment).
int fc_gemm_k_slice(int dtype, int trans, int tile, int splits, int cw,
                    const void* x, const void* w, int M, int N, int K) {
  int k_slice = -1;
  const void* part = reinterpret_cast<const void*>(uintptr_t{16});
  bool ok = false;
  if (dtype == 0)
    ok = gemm_config_ok<float>(trans, tile, splits, cw, x, w, part, M, N, K,
                               1, 0, 0, &k_slice);
  else if (dtype == 1)
    ok = gemm_config_ok<__nv_bfloat16>(trans, tile, splits, cw, x, w, part, M,
                                       N, K, 1, 0, 0, &k_slice);
  else if (dtype >= 2 && dtype <= 4)
    ok = gemm_config_ok<int8_t>(trans, tile, splits, cw, x, w, part, M, N, K,
                                1, 0, 0, &k_slice);
  return ok ? k_slice : -1;
}

// The chains run `batch` chains at once (one launch, batch entries along
// blockIdx.y): X entries x_stride elements apart, W_i entries
// w_strides[i] apart, Y entries out_stride apart.  batch 1 is one chain.
//
// The f32 chain (dtype 0) on the FMA units.
int fc_chain(int dtype, const void* x, const void* const* ws, const int* ks,
             const int* ns, const int* mults, int links, int m_final, int band,
             int threads, void* out, int batch, long long x_stride,
             const long long* w_strides, long long out_stride, void* stream) {
  if (dtype != 0 || links < 2 || links > kMaxLinks || band < 1 ||
      threads < 32 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_chain(x, ws, ks, ns, mults, links, m_final, band, threads,
                      out, batch, x_stride, w_strides, out_stride,
                      static_cast<cudaStream_t>(stream));
}

// The tensor-core chain: dtype 1 (bf16 X, W and Y) or, with scales (as
// ChainTcArgs::s), 2, 3 or 4 (fp8/int8 X and W, bf16 intermediates, f32
// Y).  band, warp_k and cw as fused_contraction.chain_config chose them;
// a configuration the kernel does not take returns cudaErrorInvalidValue.
int fc_chain_tc(int dtype, const void* x, const void* const* ws,
                const void* const* scales, const int* ks, const int* ns,
                const int* mults, int links, int m_final, int band,
                int warp_k, int cw, void* out, int batch, long long x_stride,
                const long long* w_strides, long long out_stride,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const* sc = reinterpret_cast<const float* const*>(scales);
  if (links < 2 || links > kMaxLinks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return launch_chain_tc<__nv_bfloat16, __nv_bfloat16, false>(
        x, ws, nullptr, ks, ns, mults, links, m_final, band, warp_k, cw, out,
        batch, x_stride, w_strides, out_stride, s);
  if (sc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 2)
    return launch_chain_tc<__nv_fp8_e4m3, float, true>(
        x, ws, sc, ks, ns, mults, links, m_final, band, warp_k, cw, out,
        batch, x_stride, w_strides, out_stride, s);
  if (dtype == 3)
    return launch_chain_tc<__nv_fp8_e5m2, float, true>(
        x, ws, sc, ks, ns, mults, links, m_final, band, warp_k, cw, out,
        batch, x_stride, w_strides, out_stride, s);
  if (dtype == 4)
    return launch_chain_tc<int8_t, float, true>(
        x, ws, sc, ks, ns, mults, links, m_final, band, warp_k, cw, out,
        batch, x_stride, w_strides, out_stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core chain's shared memory per block for dtype 1-4, or -1
// where its layout refuses the geometry or warp_k.
long long fc_chain_tc_smem_bytes(int dtype, const int* ks, const int* ns,
                                 const int* mults, int links, int band,
                                 int warp_k) {
  if (dtype < 1 || dtype > 4) return -1;
  ChainTcArgs a{};
  return chain_tc_layout(dtype == 1 ? 2 : 1, dtype == 1 ? 2 : 4, ks, ns,
                         mults, links, band, warp_k, &a);
}

int fc_max_links(void) { return kMaxLinks; }

const char* fc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
