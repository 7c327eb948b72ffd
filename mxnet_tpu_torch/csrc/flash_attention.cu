// Flash attention, forward and backward, written by hand for Hopper (sm_90a).
//
// Replaces the three TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py
// that _flash_core's custom_vjp launches through pl.pallas_call:
//
//   flash_fwd_kernel     <- _flash_fwd     (out and the per-row lse)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq  (dq)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv (dk, dv)
//
// and, in the library of the (bf16, bf16) pair, flash_fwd_bf16_kernel,
// flash_bwd_dq_bf16_kernel and flash_bwd_dkv_bf16_kernel in place of the
// three (below).
//
// Over (BH, T, D) tensors, with kvalid (B,) int32 valid key counts
// (bh / H picks the row) and the causal diagonal offset causal_off = Tk - Tq
// of the unpadded lengths, each computes what its Pallas kernel computes:
//
//   s[i, j] = (q[i] * scale) . k[j], kept iff j < kvalid and, if causal,
//             j <= i + causal_off; a dropped score is the finite -1e30
//   fwd:  out = softmax_j(s) @ v, lse = log-sum-exp_j(s); a row with no kept
//         key gives out = 0 exactly and lse = -1e30
//   dq:   p = exp(s - lse) (0 where lse is -1e30), ds = p * (g . v[j] - delta)
//         dq = scale * ds @ k
//   dkv:  dv = p^T @ g, dk = ds^T @ (q * scale)
//
// where delta = rowsum(g * out) is computed outside the kernels, as the JAX
// package computes it in XLA (_flash_core_bwd).
//
// Element types, as the TPU kernels take them: q, k and g share one dtype and
// v has its own, each f32, bf16 or f16. A library is built for one pair
// (-DMXTT_FLASH_QK=c -DMXTT_FLASH_V=c, c = 0 f32, 1 bf16, 2 f16; both 0 by
// default) and says which (mxtt_flash_dtypes). Every operand is widened to
// f32 as it enters shared memory, as the TPU kernels upcast in VMEM, so the
// math below is the same f32 math for every pair; out and dq are written in
// q's dtype, dk in k's, dv in v's, lse stays f32 and delta comes in f32.
// f32 operands arrive by cp.async; a bf16 or f16 operand is read into
// registers (8-byte loads of four values, all of a thread's loads before
// its first store), widened and stored, so its loads are not in flight
// while the previous tile is used. The (bf16, bf16) kernels keep their
// tiles in bf16 and compute the same values from them (their own section
// below); the kernels of every other pair are this f32 design.
//
// Bound: operations. Per kept (query, key) pair the forward does 4 * D
// flops, dq 6 * D and dk/dv 8 * D, all as 3xTF32 products on the tensor
// cores (three TF32 products per f32 product at 495 TFLOP/s). At the
// training shape (B = 2, H = 32, T = 2048, D = 128, causal: 134 M kept
// pairs) the forward's 68.8 GFLOP take at least 0.42 ms (1.03 ms at the
// card's 67 TFLOP/s of f32 outside the tensor cores), against 268 MB of
// inputs and outputs, 0.08 ms at 3.35 TB/s; the backward's 240.6 GFLOP at
// least 0.62 ms (dq) + 0.83 ms (dk/dv), or 1.54 + 2.05 ms in f32.
//
// Design:
//  * every product on the tensor cores, mma.sync m16n8k8 TF32 with f32
//    accumulators, in 3xTF32: an f32 operand x splits in registers, as its
//    fragment is loaded, into hi = tf32(x) and lo = tf32(x - hi), both
//    rounded to nearest (cvt.rna's rounding), and a product is
//    lo*hi + hi*lo + hi*hi, the two small cross terms first.
//    x - (hi + lo) is below 2^-22 |x| and the dropped lo*lo term is below
//    2^-22 |x y|, so a product keeps f32-class accuracy (one TF32 pass
//    keeps 2^-11, about three decimal digits, which the port's f32
//    tolerance does not allow). The tensor cores add into an accumulator
//    with truncation, so sums are kept short: a score sums 4 (forward, dq)
//    or 2 (dk/dv) k-steps at a time and an output tile's products one tile
//    at a time, then join with f32 adds. Those sums are chains of dependent
//    products; the output tiles are taken in groups under one guard (the
//    forward: all of a warp's tiles), so that a group's chains overlap;
//  * forward and dq: one block of 8 warps per (bh, 128-row query tile)
//    keeps q (the forward: q * scale; dq: q and dO) resident and streams
//    32-key tiles of K and V; dk/dv: one block per (bh, 128-key tile) keeps
//    K and V resident and streams 32-query tiles of q, dO, lse and delta.
//    The longest causal query tiles go first. A warp skips a tile the mask
//    hides from it, and the key loop stops at the last tile a row may see
//    (kvalid, the causal diagonal), the TPU kernels' whole-tile skip. Tiles
//    arrive by 16-byte cp.async into two stages, the next tile in flight
//    while the current one is used, one barrier a tile; the ragged edge of
//    T and the columns past D are zero-filled by the copy's src-size 0. A
//    D that is not a multiple of 4 (or an operand not 16-byte aligned)
//    takes the same kernel with 4-byte copies;
//  * shared tiles are row-major with a row of P floats (D rounded up to
//    64, 128 or 256) and 16-byte chunks XOR-swizzled by a permutation of
//    row % 8, so that the fragment loads, row-wise (8-byte pairs) and
//    column-wise (4 even or odd rows x 8 columns), are free of bank
//    conflicts; a thread's load offsets are computed once;
//  * forward: each warp computes S = (q scale) K^T for its 16 query rows
//    and the key tile. A row's scores then lie in the four threads of a
//    quad, which hold its max m and sum l after two shuffles each: the
//    online softmax of the TPU kernel (its dead-row rule included) forms
//    P = exp(S - m) in the accumulators and rescales the warp's output
//    rows by exp(m_old - m), and P V adds the tile's product, summed apart.
//    dq: each warp computes S = (q K^T) * scale and dP = dO V^T for its 16
//    query rows and the key tile, forms dS in its accumulators and adds
//    dS K into its dq rows. dk/dv: each warp computes S^T and dP^T for its
//    16 keys and the query tile, and adds P^T dO into dv and dS^T q into
//    dk. Every product permutes its reduction index in
//    A and B alike (slot t <-> 2t, slot t+4 <-> 2t+1): a thread's two
//    values of a row are then adjacent (one 8-byte load), and an
//    accumulator tile, whose thread holds columns 2t and 2t+1, is the A
//    operand of the next product as it stands, through no shared memory
//    and no shuffle;
//  * no atomics: a warp owns its output rows (above D = 128, the warps
//    that share rows split the forward's output columns, or add the
//    backward's partial sums through shared memory at the end, in a fixed
//    order), so two calls give bitwise equal results. A dead row gets
//    out = 0 and dq = 0 exactly, keys past kvalid dk = dv = 0;
//  * 128 KB (forward) or 192 KB (backward) of shared memory and one block
//    of 8 warps a SM at D <= 128 (64 or 96 KB at D <= 64). Above D = 128
//    the forward keeps 64 query rows and two warps share them, each with
//    half the output columns, repeating the scores; the backward's
//    resident tiles hold 32 rows, two warps share them by key or query,
//    and the output columns split across two more, which repeat the scores.
// What holds them back: mma.sync reaches only part of the tensor cores'
// TF32 rate, and 3xTF32 triples the products and adds the splits' integer
// work: each of the forward's 8 warps splits every K and V fragment of a
// tile, and q's fragments again for every key tile (they would not fit in
// registers beside the output rows); dq recomputes S and dP, which dk/dv
// computes too (seven products where one fused pass with atomics would
// need five); wgmma's TF32 wants both operands K-major in shared memory,
// which the transposed products are not; dk/dv runs at the 255-register
// limit.
//
// The (bf16, bf16) kernels, backward first. Bound: operations at the
// training shape, where
// its products take 0.17 ms (dq) + 0.28 ms (dk/dv) at the card's 989
// TFLOP/s of bf16 (one pass for two bf16 operands, three for P or dS:
// five passes for dq's three products, eight for dk/dv's four); bytes at
// BERT-base's (B H = 768, T = 128, D = 64, valid lengths 112-128), 0.019 +
// 0.022 ms at 3.35 TB/s. Design:
//  * every product on bf16 mma.sync m16n8k16 with f32 accumulators. S and
//    dP (dk/dv: their transposes) multiply two bf16 inputs: one pass, the
//    products exact, summed 32 (dq) or 16 (dk/dv) columns apart and joined
//    by f32 adds, as above. P and dS stay f32, as the TPU kernels keep them
//    (rounding them once to bf16, as cuDNN's and FlashAttention-2's
//    backward do, would move the gradients off the plain versions): dq +=
//    dS K, dv += P^T dO and dk += dS^T q take each of them in three bf16
//    pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), 24
//    significand bits within 2^-24 |x|, three passes against the bf16
//    operand, the small pieces first, each tile's product summed apart. Two
//    adjacent accumulator tiles of P or dS, packed into bf16x2, are the A
//    operand as they stand (FlashAttention-2's register reuse);
//  * the tiles stay bf16 in shared memory and arrive by 16-byte cp.async
//    (eight values) into two stages, the next tile in flight; a D that is
//    not a multiple of 8, or an operand not 16-byte aligned, takes the same
//    kernel with the threads copying one value each. Rows of P values (a
//    multiple of 128 bytes) with 16-byte chunks XOR-swizzled by row % 8 are
//    read by ldmatrix.x4, .trans where the reduction runs down the stored
//    rows (K in dS K, dO in P^T dO, q in dS^T q), free of bank conflicts;
//  * blocks of 4 warps; a warp owns 16 resident rows (dq: queries, dk/dv:
//    keys) across the whole streamed tile, so no two warps add into one
//    output and nothing is reduced through shared memory. dq keeps 64 query
//    rows and streams 32-key tiles, dk/dv keeps 64 keys and streams
//    32-query tiles (above D = 128: 32 resident rows, two warps splitting
//    the output columns and repeating the scores). Three dq blocks an SM at
//    D <= 128 (168 registers; at D = 128 a thread spills 24 bytes, and two
//    blocks without the spill ran 20% slower on an H100), three dk/dv
//    blocks at D = 64, two at D = 128 (244 registers) and above. Causal
//    grids take every head's longest tiles first; the others put a head's
//    tiles next to each other, so that the second read of the streamed
//    operand hits L2.
// What holds it back: at the training shape it reaches a quarter of its
// operation bound. mma.sync reaches only part of the rate wgmma gives;
// dq's score products wait on ldmatrix (six 512-byte reads for eight mma:
// each warp reads the whole K and V tile for its 16 rows); the splits and
// the softmax issue about as many instructions again; the output products
// take 43% of dk/dv's time. At BERT's shape the products are only a
// quarter to a third of the time: the loads, ldmatrix, barriers and the
// elementwise work of 12 warps an SM are the rest, and the two kernels
// read every input twice (seven products where one fused pass with
// atomics would need five).
//
// The (bf16, bf16) forward, flash_fwd_bf16_kernel: the backward's design
// turned round. Bound: bytes at BERT-base's shape (0.0147 ms), operations
// at the training shape (0.139 ms: one pass for S and three for P V at 989
// TFLOP/s). Design:
//  * S = q K^T in one bf16 mma.sync pass over the bf16 tiles (score16: the
//    exact products summed 32 columns apart, then f32 adds), scaled in f32
//    inside exp2's argument; the f32 forward's online softmax in f32, P by
//    ex2.approx; out = out alpha + P V with P in three bf16 pieces
//    against bf16 V, each tile's product summed apart (one fmaf joins it),
//    P's accumulator tiles the A operand as they stand; out / l at the end
//    rounded as the plain version's division rounds it. One bf16 rounding
//    of P, as cuDNN's and FlashAttention-2's forward take, would move out
//    off the plain version;
//  * q, K and V arrive by 16-byte cp.async into swizzled bf16 rows (one
//    value a thread for a narrow or misaligned operand) and are read by
//    ldmatrix.x4, .trans for V; K and V stream in 32-key tiles through
//    three stages, the next two in flight (3% faster than two stages at
//    BERT's shape);
//  * blocks of 4 warps over 64 query rows, a warp owning 16 rows across
//    the whole key tile (above D = 128: 32 rows, two warps splitting the
//    output columns and repeating the scores): four blocks an SM at D = 64
//    (128 registers; three for the narrow copies, which spilled at four),
//    three at D = 128 (168, a few bytes spilled; two blocks ran 9%
//    slower), two at D = 256. dq's grid order and the f32 forward's
//    whole-tile skip; no atomics.
// What holds it back (python -m mxnet_tpu_torch.flash_variants on an
// H100): at BERT's shape latency, not bytes or products. A warp's tile is
// one dependent chain (scores, max, exp, split, P V) and an SM holds 16
// warps; dropping the global copies saves 19% of the time, the score
// products 6%, the output products 8%, the splits 3%, the exponentials
// and ldmatrix 1% each (exp2f in place of ex2.approx costs 7%). Five
// blocks an SM (96 registers, a spill) ran no faster, three ran 8%
// slower; 64-key tiles were slower and 64-column score sums no faster.
// At the training shape it reaches a quarter of its operation bound, and
// the products are half of the time: mma.sync, and three passes for P V.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef MXTT_FLASH_QK
#define MXTT_FLASH_QK 0
#endif
#ifndef MXTT_FLASH_V
#define MXTT_FLASH_V 0
#endif

namespace {

// dtype code (0 f32, 1 bf16, 2 f16) -> element type
template <int C>
struct ElemOf;
template <>
struct ElemOf<0> {
  using T = float;
};
template <>
struct ElemOf<1> {
  using T = __nv_bfloat16;
};
template <>
struct ElemOf<2> {
  using T = __half;
};
using QkT = ElemOf<MXTT_FLASH_QK>::T;  // q, k, g, out, dq, dk
using VT = ElemOf<MXTT_FLASH_V>::T;    // v, dv

constexpr int kThreads = 256;        // 8 warps
constexpr float kNegInf = -1e30f;    // finite "minus infinity", as in the TPU kernels
constexpr float kAliveMin = -5e29f;  // a row is dead while its max stays below this
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool kept(int qpos, int kpos, int kv_len, int causal, int causal_off) {
  return kpos < kv_len && (!causal || kpos <= qpos + causal_off);
}

// The key tiles a query tile starting at q0 sees: [0, key_end(q0)).
template <int BM>
__device__ __forceinline__ int key_end(int q0, int kv_len, int causal, int causal_off) {
  return causal ? min(kv_len, q0 + BM + causal_off) : kv_len;
}

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core products over cp.async-fed shared tiles

// Tile shape of the backward kernels at row width P (D rounded up): R rows
// resident (dq: queries, dk/dv: keys), S rows a streamed tile (dq: keys,
// dk/dv: queries); WM x WN x WD warps, warp (wm, wn, wd) owning resident
// rows [16 wm, 16 wm + 16), streamed rows [wn S / WN, (wn + 1) S / WN) and
// output columns [wd P / WD, (wd + 1) P / WD).
template <int P_>
struct BwdTile {
  static constexpr int R = P_ <= 128 ? 128 : 32;
  static constexpr int S = 32;
  static constexpr int WM = R / 16;
  static constexpr int WD = P_ <= 128 ? 1 : 2;
  static constexpr int WN = kThreads / 32 / (WM * WD);
  static constexpr int P = P_;
  static constexpr int RP = P + 8;  // pitch of the reduction buffer
  static_assert(WM * WN * WD == kThreads / 32 && S % (8 * WN) == 0, "warp grid");
  static_assert(P / WD % 64 == 0, "dq's output columns go in groups of 64");
};

// Tile shape of the forward at row width P: R query rows resident, S keys a
// streamed tile; WM x WD warps, warp (wm, wd) owning query rows
// [16 wm, 16 wm + 16) across the whole key tile (so a row's softmax
// statistics stay in one warp) and output columns [wd P / WD, (wd + 1) P / WD).
template <int P_>
struct FwdTile {
  static constexpr int R = P_ <= 128 ? 128 : 64;
  static constexpr int S = 32;
  static constexpr int WM = R / 16;
  static constexpr int WD = kThreads / 32 / WM;
  static constexpr int P = P_;
  static_assert(WM * WD == kThreads / 32 && P / WD % 32 == 0, "warp grid");
};

// k-steps of a score product summed apart before they join the score: the
// tensor cores add into the accumulator with truncation, so a long chain of
// additions into one accumulator drifts; short chains joined by f32 adds
// (round to nearest) keep the scores, and through exp the gradients, within
// the port's f32 tolerance. The output products sum each tile apart, too.
// dq runs faster with 4, dk/dv with 2 (measured on an H100); the forward's
// score is dq's.
constexpr int kChunkDq = 4;
constexpr int kChunkDkv = 2;

// Element (r, c) of a swizzled (rows x P) tile: 16-byte chunk c / 4 of row r
// sits at chunk (c / 4) ^ h(r), where h permutes r % 8 = (r2 r1 r0) into
// (r1, r0 ^ r2, r0). That keeps the three fragment patterns free of bank
// conflicts: 8-byte pairs of 4 rows x 4 column pairs (a half-warp), and
// 4 even or 4 odd rows x 8 columns.
__host__ __device__ __forceinline__ int swz_key(int r) {
  return ((r & 2) << 1) | (((r ^ (r >> 2)) & 1) << 1) | (r & 1);
}

template <int P>
__device__ __forceinline__ int swz(int r, int c) {
  return r * P + ((((c >> 2) ^ swz_key(r)) << 2) | (c & 3));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a row-major (T, D) matrix into a swizzled
// (ROWS x P) tile, asynchronously; rows at or past T and columns at or past
// D are zero-filled. VEC: 16-byte copies (D % 4 == 0, src 16-byte aligned).
template <int ROWS, int P, bool VEC>
__device__ __forceinline__ void load_async(float* dst, const float* __restrict__ src, int r0,
                                           int T, int D) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int PER_ROW = P / W;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * W;
    const bool in = r0 + r < T && c < D;
    const float* s = in ? src + static_cast<size_t>(r0 + r) * D + c : src;
    if (VEC)
      cp_async16(dst + swz<P>(r, c), s, in);
    else
      cp_async4(dst + swz<P>(r, c), s, in);
  }
}

// Values [r0, r0 + ROWS) of a (T,) vector into shared memory, asynchronously;
// zeros at or past T.
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* __restrict__ src, int r0,
                                                int T) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const bool in = r0 + r < T;
    cp_async4(dst + r, in ? src + r0 + r : src, in);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <class E>
__device__ __forceinline__ E from_f32(float x) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value)
    return __float2bfloat16_rn(x);
  else if constexpr (std::is_same<E, __half>::value)
    return __float2half_rn(x);
  else
    return x;
}

// Values col and col + 1 of a row, rounded to E (col even: 2 E-aligned).
template <class E>
__device__ __forceinline__ void store2(E* p, float x, float y) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  else if constexpr (std::is_same<E, __half>::value)
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Four bf16 or f16 values (8 bytes) widened to f32.
template <class E>
__device__ __forceinline__ float4 widen4(uint2 raw) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  } else {
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

// Rows [r0, r0 + ROWS) of a row-major (T, D) matrix of E into a swizzled
// (ROWS x P) f32 tile; rows at or past T and columns at or past D are zero.
// f32: load_async's copies, in flight until the caller waits. bf16/f16:
// read, widened and stored by the threads (visible after the next
// barrier); VEC: 8-byte loads of four values (D % 4 == 0, src 8-byte
// aligned), all of a thread's loads issued before its first store.
template <int ROWS, int P, bool VEC, class E>
__device__ __forceinline__ void load_tile(float* dst, const E* __restrict__ src, int r0, int T,
                                          int D) {
  if constexpr (std::is_same<E, float>::value) {
    load_async<ROWS, P, VEC>(dst, src, r0, T, D);
  } else if constexpr (VEC) {
    constexpr int PER_ROW = P / 4;
    constexpr int N = ROWS * PER_ROW / kThreads;
    static_assert(ROWS * PER_ROW % kThreads == 0, "a thread's share of the tile");
    uint2 raw[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
      raw[j] = r0 + r < T && c < D
                   ? __ldg(reinterpret_cast<const uint2*>(src + static_cast<size_t>(r0 + r) * D + c))
                   : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
      *reinterpret_cast<float4*>(dst + swz<P>(r, c)) = widen4<E>(raw[j]);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * P; i += kThreads) {
      const int r = i / P, c = i % P;
      dst[swz<P>(r, c)] =
          r0 + r < T && c < D ? to_f32(src[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
    }
  }
}

// x rounded to TF32, to nearest with ties away from zero: the value
// cvt.rna.tf32.f32 gives, formed with an integer add and mask (adding half
// of the 13 dropped bits' range carries into the kept ones), which ran
// faster on an H100 than the cvt.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small cross terms, then the big one.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// The m16n8k8 fragments, lane = 4 g + t. A (16 x 8): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8): b0 (t, g), b1 (t + 4, g);
// C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// A product sums over its reduction index k in any order, so each product
// below permutes k the same way in A and B: slot t is k = 2t and slot t + 4
// is k = 2t + 1. A thread's two values of a row are then adjacent (one
// 8-byte load), and an accumulator tile is an A operand as it stands.

// A thread's offsets (floats) in a swizzled tile of pitch P for the
// fragments of a k-step, by its phase b = (c0 / 8) % 4, c0 being the first
// column (row: A and row-wise B) or the first output column (col:
// column-wise B); the rest of c0, a multiple of 32, adds to the tile
// pointer as it is. Computed once, so a fragment load is one address add.
template <int P>
struct FragOff {
  int row[4];     // (g, c0 + 2t), from the fragment's first row
  int col[2][4];  // (2t + o, c0 + g), from the fragment's first row
  __device__ FragOff(int g, int t) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      row[b] = g * P + (((((t >> 1) ^ swz_key(g)) << 2) | ((t & 1) << 1)) ^ (8 * b));
#pragma unroll
      for (int o = 0; o < 2; ++o)
        col[o][b] = (2 * t + o) * P +
                    (((((g >> 2) ^ swz_key(2 * t + o)) << 2) | (g & 3)) ^ (8 * b));
    }
  }
};

// A = 16 rows x 8 columns from p (the first row, at the k-step's columns
// rounded down to 32), off = FragOff::row of the phase.
template <int P>
__device__ __forceinline__ FragA frag_a(const float* p, int off) {
  FragA f;
  const float2 top = *reinterpret_cast<const float2*>(p + off);
  const float2 bot = *reinterpret_cast<const float2*>(p + off + 8 * P);
  split_tf32(top.x, f.hi[0], f.lo[0]);
  split_tf32(bot.x, f.hi[1], f.lo[1]);
  split_tf32(top.y, f.hi[2], f.lo[2]);
  split_tf32(bot.y, f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = X[n][k] over 8 rows of X from p: a product against the rows.
__device__ __forceinline__ FragB frag_b_rows(const float* p, int off) {
  FragB f;
  const float2 x = *reinterpret_cast<const float2*>(p + off);
  split_tf32(x.x, f.hi[0], f.lo[0]);
  split_tf32(x.y, f.hi[1], f.lo[1]);
  return f;
}

// A from a C accumulator tile (16 x 8) as it stands.
__device__ __forceinline__ FragA frag_a_acc(const float (&c)[4]) {
  FragA f;
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = X[k][n] over 8 rows of X from p: rows 2t and 2t + 1 (offsets
// FragOff::col[0] and col[1] of the phase).
__device__ __forceinline__ FragB frag_b_cols(const float* p, int off0, int off1) {
  FragB f;
  split_tf32(p[off0], f.hi[0], f.lo[0]);
  split_tf32(p[off1], f.hi[1], f.lo[1]);
  return f;
}

// Sum the partial (16 x P / WD) output tiles of the WN warps that share
// resident rows, through red (R x RP floats, over tiles that are no longer
// read), in the order wn = 0, 1, ...;
// the last of them hands each sum, with its tile row and column, to
// out(row, col, value).
template <class C, int NO, class Out>
__device__ __forceinline__ void reduce_rows(float* red, const float (&acc)[NO][4], int wm,
                                            int wn, int wd, int g, int t, Out out) {
  constexpr int P = C::P;
  for (int w = 0; w < C::WN; ++w) {
    if (wn == w) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = wd * (P / C::WD) + n * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 16 + g + 8 * h;
          float2* cell = reinterpret_cast<float2*>(red + row * C::RP + col);
          float2 v = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
          if (w > 0) {
            const float2 r = *cell;
            v = make_float2(r.x + v.x, r.y + v.y);
          }
          if (w + 1 < C::WN) {
            *cell = v;
          } else {
            out(row, col, v.x);
            out(row, col + 1, v.y);
          }
        }
      }
    }
    if (w + 1 < C::WN) __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (bh, query tile); grid (BH, ceil(Tq / R))
template <int P, bool VEC, class TQ, class TV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                     const TV* __restrict__ v, const int* __restrict__ kvalid,
                     TQ* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
                     int D, int causal, int causal_off, float scale) {
  using C = FwdTile<P>;
  constexpr int BM = C::R;             // query rows of the block
  constexpr int BN = C::S;             // keys of a streamed tile
  constexpr int NK = BN / 8;           // their n-tiles
  constexpr int NO = P / C::WD / 8;    // output n-tiles of a warp
  constexpr int STAGE = 2 * BN * P;    // K tile, then V tile
  extern __shared__ float4 smem_v4[];
  float* q_s = reinterpret_cast<float*>(smem_v4);  // BM x P, q * scale
  float* kv_s = q_s + BM * P;                      // two stages

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal rows first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int wm = warp % C::WM, wd = warp / C::WM;
  const int r0 = q0 + wm * 16;         // the warp's first query row
  const int c0 = wd * (P / C::WD);     // its first output column
  const FragOff<P> fo(gr, tc);
  const int kv_len = min(kvalid[bh / H], Tk);
  const int k_end = key_end<BM>(q0, kv_len, causal, causal_off);
  const int n_tiles = k_end > 0 ? (k_end + BN - 1) / BN : 0;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const TQ* kb = k + static_cast<size_t>(bh) * Tk * D;
  const TV* vb = v + static_cast<size_t>(bh) * Tk * D;

  // the output rows, their running max and sum (h = 0: row gr, h = 1: gr + 8)
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    load_tile<BM, P, VEC>(q_s, q + qoff * D, q0, Tq, D);
    cp_async_commit();
    load_tile<BN, P, VEC>(kv_s, kb, 0, Tk, D);
    load_tile<BN, P, VEC>(kv_s + BN * P, vb, 0, Tk, D);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // q landed: scale it in place, as the TPU kernel does
    for (int i = threadIdx.x; i < BM * P; i += kThreads) q_s[i] *= scale;
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<0>();
      __syncthreads();  // tile it landed; every warp is done with tile it - 1
      if (it + 1 < n_tiles) {
        float* nxt = kv_s + ((it + 1) & 1) * STAGE;
        load_tile<BN, P, VEC>(nxt, kb, (it + 1) * BN, Tk, D);
        load_tile<BN, P, VEC>(nxt + BN * P, vb, (it + 1) * BN, Tk, D);
        cp_async_commit();
      }
      const float* k_s = kv_s + (it & 1) * STAGE;
      const float* v_s = k_s + BN * P;
      const int k0 = it * BN;
      // a warp whose rows see no key of this tile leaves m, l and its rows
      // as they are, which is what the softmax of a dropped tile gives
      if (causal && k0 > r0 + 15 + causal_off) continue;

      // S = (q scale) K^T for the warp's rows and the tile's keys, all P
      // columns (past D they are zeros), as dq's
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int kc = 0; kc < P; kc += 8 * kChunkDq) {
        float ts[NK][4];
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) ts[j][c] = 0.f;
#pragma unroll
        for (int kk = kc; kk < kc + 8 * kChunkDq; kk += 8) {
          const int ph = (kk >> 3) & 3, c32 = kk & ~31;
          const FragA qa = frag_a<P>(q_s + wm * 16 * P + c32, fo.row[ph]);
#pragma unroll
          for (int j = 0; j < NK; ++j)
            mma3(ts[j], qa, frag_b_rows(k_s + j * 8 * P + c32, fo.row[ph]));
        }
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] += ts[j][c];
      }
      // the online softmax: dropped scores to -1e30, the rows' new max over
      // the quad, P = exp(S - m) on the alive rows (0 on a row whose every
      // score so far was dropped), l and the output rows rescaled by
      // alpha = exp(m_old - m); full: the mask keeps every pair of the tile
      const int k_last = k0 + BN - 1;
      const bool full = k_last < kv_len && (!causal || k_last <= r0 + causal_off);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          if (!full && !kept(r0 + gr + 8 * h, k0 + j * 8 + 2 * tc + (c & 1), kv_len, causal,
                             causal_off))
            s[j][c] = kNegInf;
          mx[h] = fmaxf(mx[h], s[j][c]);
        }
      float alpha[2], mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        mb[h] = m_new * kLog2e;
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          const float p = m[h] > kAliveMin ? exp2f(fmaf(s[j][c], kLog2e, -mb[h])) : 0.f;
          s[j][c] = p;
          sum[h] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }
      // out = out alpha + P V over the tile's keys, the tile's product
      // summed apart; all the warp's output tiles in one group, so that
      // their NO chains of dependent products overlap (faster on an H100
      // than groups of 8 under a guard each, as dq takes them)
      FragA pa[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) pa[j] = frag_a_acc(s[j]);
      float part[NO][4] = {};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float* vj = v_s + j * 8 * P + c0;
#pragma unroll
        for (int n = 0; n < NO; ++n)  // tile n: phase n % 4
          mma3(part[n], pa[j], frag_b_cols(vj + (n & ~3) * 8, fo.col[0][n & 3], fo.col[1][n & 3]));
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = fmaf(acc[n][c], alpha[c >> 1], part[n][c]);
    }
  }

  // out = acc / l (l = 0 on a dead row, whose acc is 0), lse = m + log l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gr + 8 * h;
    if (row >= Tq) continue;
    const float lsafe = l[h] == 0.f ? 1.f : l[h];
    TQ* orow = out + (qoff + row) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = c0 + n * 8 + 2 * tc;
      const float x = acc[n][2 * h] / lsafe, y = acc[n][2 * h + 1] / lsafe;
      if (VEC) {  // D % 4 == 0: col and col + 1 are both in or both out
        if (col < D) store2(orow + col, x, y);
      } else {
        if (col < D) orow[col] = from_f32<TQ>(x);
        if (col + 1 < D) orow[col + 1] = from_f32<TQ>(y);
      }
    }
    if (wd == 0 && tc == 0) lse[qoff + row] = l[h] == 0.f ? kNegInf : m[h] + logf(lsafe);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (bh, query tile); grid (BH, ceil(Tq / R))
template <int P, bool VEC, class TQ, class TV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                        const TV* __restrict__ v, const TQ* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kvalid, TQ* __restrict__ dq, int H, int Tq,
                        int Tk, int D, int causal, int causal_off, float scale) {
  using C = BwdTile<P>;
  constexpr int BM = C::R;               // query rows of the block
  constexpr int BN = C::S;               // keys of a streamed tile
  constexpr int KW = BN / C::WN;         // keys of a warp
  constexpr int NK = KW / 8;             // their n-tiles
  constexpr int NO = P / C::WD / 8;      // output n-tiles of a warp
  constexpr int STAGE = 2 * BN * P;      // K tile, then V tile
  extern __shared__ float4 smem_v4[];
  float* q_s = reinterpret_cast<float*>(smem_v4);  // BM x P, q
  float* g_s = q_s + BM * P;                       // BM x P, dO
  float* kv_s = g_s + BM * P;                      // two stages

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal rows first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int wm = warp % C::WM, wn = warp / C::WM % C::WN, wd = warp / (C::WM * C::WN);
  const FragOff<P> fo(gr, tc);
  const int kv_len = kvalid[bh / H];
  const int k_end = key_end<BM>(q0, kv_len, causal, causal_off);
  const int n_tiles = k_end > 0 ? (k_end + BN - 1) / BN : 0;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const TQ* kb = k + static_cast<size_t>(bh) * Tk * D;
  const TV* vb = v + static_cast<size_t>(bh) * Tk * D;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  if (n_tiles > 0) {
    load_tile<BM, P, VEC>(q_s, q + qoff * D, q0, Tq, D);
    load_tile<BM, P, VEC>(g_s, g + qoff * D, q0, Tq, D);
    load_tile<BN, P, VEC>(kv_s, kb, 0, Tk, D);
    load_tile<BN, P, VEC>(kv_s + BN * P, vb, 0, Tk, D);
    cp_async_commit();
    // lse and delta of the thread's two rows (h = 0: row g, h = 1: g + 8)
    float lr[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wm * 16 + gr + 8 * h;
      lr[h] = row < Tq ? lse[qoff + row] : kNegInf;
      dl[h] = row < Tq ? delta[qoff + row] : 0.f;
    }
    const int kw = wn * KW;
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<0>();
      __syncthreads();  // tile it landed; every warp is done with tile it - 1
      if (it + 1 < n_tiles) {
        float* nxt = kv_s + ((it + 1) & 1) * STAGE;
        load_tile<BN, P, VEC>(nxt, kb, (it + 1) * BN, Tk, D);
        load_tile<BN, P, VEC>(nxt + BN * P, vb, (it + 1) * BN, Tk, D);
        cp_async_commit();
      }
      const float* k_s = kv_s + (it & 1) * STAGE;
      const float* v_s = k_s + BN * P;
      const int k0 = it * BN;
      // a warp whose keys of this tile are all masked for its rows adds 0
      if (k0 + kw >= kv_len || (causal && k0 + kw > q0 + wm * 16 + 15 + causal_off)) continue;

      // S = q K^T and dP = dO V^T for rows wm, keys [kw, kw + KW)
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
      // all P columns, unguarded (past D they are zeros): one block of code
      // for the scheduler, which measured faster here than a guarded loop
#pragma unroll
      for (int kc = 0; kc < P; kc += 8 * kChunkDq) {
        float ts[NK][4], tp[NK][4];
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) ts[j][c] = tp[j][c] = 0.f;
#pragma unroll
        for (int kk = kc; kk < kc + 8 * kChunkDq; kk += 8) {
          const int ph = (kk >> 3) & 3, c32 = kk & ~31;
          const FragA qa = frag_a<P>(q_s + wm * 16 * P + c32, fo.row[ph]);
          const FragA ga = frag_a<P>(g_s + wm * 16 * P + c32, fo.row[ph]);
#pragma unroll
          for (int j = 0; j < NK; ++j) {
            mma3(ts[j], qa, frag_b_rows(k_s + (kw + j * 8) * P + c32, fo.row[ph]));
            mma3(tp[j], ga, frag_b_rows(v_s + (kw + j * 8) * P + c32, fo.row[ph]));
          }
        }
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[j][c] += ts[j][c];
            dp[j][c] += tp[j][c];
          }
      }
      // dS = P * (dP - delta), P = exp(S scale - lse) on the kept pairs;
      // full: the mask keeps every pair of the warp's tile
      const int k_last = k0 + kw + KW - 1;
      const bool full = k_last < kv_len && (!causal || k_last <= q0 + wm * 16 + causal_off);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          const int qpos = q0 + wm * 16 + gr + 8 * h;
          const int kpos = k0 + kw + j * 8 + 2 * tc + (c & 1);
          const bool keep =
              lr[h] > kAliveMin && (full || kept(qpos, kpos, kv_len, causal, causal_off));
          const float p = keep ? exp2f(fmaf(s[j][c], scale * kLog2e, -lr[h] * kLog2e)) : 0.f;
          s[j][c] = p * (dp[j][c] - dl[h]);
        }
      // dq += dS K over the warp's keys
      FragA da[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) da[j] = frag_a_acc(s[j]);
      // output tiles go in groups of G under one guard, so that the G
      // chains of dependent products of a group overlap on the tensor cores
      constexpr int G = 8;
#pragma unroll
      for (int ng = 0; ng < NO; ng += G) {
        if (wd * (P / C::WD) + ng * 8 >= D) break;
        float part[G][4] = {};
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float* kj = k_s + (kw + j * 8) * P + wd * (P / C::WD);
#pragma unroll
          for (int n = 0; n < G; ++n) {  // tile ng + n: phase (ng + n) % 4
            const int t = ng + n;
            mma3(part[n], da[j], frag_b_cols(kj + (t & ~3) * 8, fo.col[0][t & 3], fo.col[1][t & 3]));
          }
        }
#pragma unroll
        for (int n = 0; n < G; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[ng + n][c] += part[n][c];
      }
    }
    __syncthreads();
  }

  TQ* dqb = dq + qoff * D;
  reduce_rows<C, NO>(q_s, acc, wm, wn, wd, gr, tc, [&](int r, int c, float x) {
    if (q0 + r < Tq && c < D) dqb[static_cast<size_t>(q0 + r) * D + c] = from_f32<TQ>(x * scale);
  });
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (bh, key tile); grid (BH, ceil(Tk / R))
template <int P, bool VEC, class TQ, class TV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                         const TV* __restrict__ v, const TQ* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ kvalid, TQ* __restrict__ dk,
                         TV* __restrict__ dv, int H, int Tq, int Tk, int D, int causal,
                         int causal_off, float scale) {
  using C = BwdTile<P>;
  constexpr int BN = C::R;               // keys of the block
  constexpr int BM = C::S;               // queries of a streamed tile
  constexpr int QW = BM / C::WN;         // queries of a warp
  constexpr int NQ = QW / 8;             // their n-tiles
  constexpr int NO = P / C::WD / 8;      // output n-tiles of a warp
  constexpr int STAGE = 2 * BM * P + 2 * BM;  // q, dO, lse, delta
  extern __shared__ float4 smem_v4[];
  float* k_s = reinterpret_cast<float*>(smem_v4);  // BN x P
  float* v_s = k_s + BN * P;                       // BN x P
  float* st_s = v_s + BN * P;                      // two stages

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;  // the longest causal key tiles come first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int wm = warp % C::WM, wn = warp / C::WM % C::WN, wd = warp / (C::WM * C::WN);
  const FragOff<P> fo(gr, tc);
  const int kv_len = kvalid[bh / H];
  // the first query tile whose last row sees key k0; a tile past kvalid
  // gets no gradient
  const int q_first = causal ? max(0, k0 - causal_off) / BM * BM : 0;
  const int n_tiles = k0 < kv_len && q_first < Tq ? (Tq - q_first + BM - 1) / BM : 0;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const size_t koff = static_cast<size_t>(bh) * Tk;
  const TQ* qb = q + qoff * D;
  const TQ* gb = g + qoff * D;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  auto load_stage = [&](float* dst, int q0) {
    load_tile<BM, P, VEC>(dst, qb, q0, Tq, D);
    load_tile<BM, P, VEC>(dst + BM * P, gb, q0, Tq, D);
    load_rows_async<BM>(dst + 2 * BM * P, lse + qoff, q0, Tq);
    load_rows_async<BM>(dst + 2 * BM * P + BM, delta + qoff, q0, Tq);
  };

  if (n_tiles > 0) {
    load_tile<BN, P, VEC>(k_s, k + koff * D, k0, Tk, D);
    load_tile<BN, P, VEC>(v_s, v + koff * D, k0, Tk, D);
    load_stage(st_s, q_first);
    cp_async_commit();
    const int qw = wn * QW;
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = q_first + it * BM;
      cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < n_tiles) {
        load_stage(st_s + ((it + 1) & 1) * STAGE, q0 + BM);
        cp_async_commit();
      }
      const float* q_s = st_s + (it & 1) * STAGE;
      const float* g_s = q_s + BM * P;
      const float* lse_s = g_s + BM * P;
      const float* dl_s = lse_s + BM;
      // a warp whose queries of this tile are all masked for its keys adds 0
      if (q0 + qw >= Tq || k0 + wm * 16 >= kv_len ||
          (causal && k0 + wm * 16 > q0 + qw + QW - 1 + causal_off))
        continue;

      // S^T = K q^T and dP^T = V dO^T for keys wm, queries [qw, qw + QW)
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kc = 0; kc < P; kc += 8 * kChunkDkv) {
        if (kc >= D) break;
        float ts[NQ][4], tp[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) ts[j][c] = tp[j][c] = 0.f;
#pragma unroll
        for (int kk = kc; kk < kc + 8 * kChunkDkv; kk += 8) {
          const int ph = (kk >> 3) & 3, c32 = kk & ~31;
          const FragA ka = frag_a<P>(k_s + wm * 16 * P + c32, fo.row[ph]);
          const FragA va = frag_a<P>(v_s + wm * 16 * P + c32, fo.row[ph]);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            mma3(ts[j], ka, frag_b_rows(q_s + (qw + j * 8) * P + c32, fo.row[ph]));
            mma3(tp[j], va, frag_b_rows(g_s + (qw + j * 8) * P + c32, fo.row[ph]));
          }
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[j][c] += ts[j][c];
            dp[j][c] += tp[j][c];
          }
      }
      // P^T into s, dS^T into dp; a query's lse and delta are per column.
      // full: the mask keeps every pair of the warp's tile
      const int k_last = k0 + wm * 16 + 15;
      const bool full = k_last < kv_len && q0 + qw + QW <= Tq &&
                        (!causal || k_last <= q0 + qw + causal_off);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = qw + j * 8 + 2 * tc + (c & 1);
          const int qpos = q0 + col;
          const int kpos = k0 + wm * 16 + gr + 8 * (c >> 1);
          const float lq = lse_s[col];
          const bool keep = lq > kAliveMin && (full || (qpos < Tq && kept(qpos, kpos, kv_len,
                                                                          causal, causal_off)));
          const float p = keep ? exp2f(fmaf(s[j][c], scale * kLog2e, -lq * kLog2e)) : 0.f;
          s[j][c] = p;
          dp[j][c] = p * (dp[j][c] - dl_s[col]);
        }
      // dv += P^T dO, dk += dS^T q over the warp's queries
      FragA pa[NQ], da[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        pa[j] = frag_a_acc(s[j]);
        da[j] = frag_a_acc(dp[j]);
      }
      // output tiles in groups of G under one guard, as in dq (G chains
      // each for dv and dk; a larger G spills at 255 registers)
      constexpr int G = 2;
#pragma unroll
      for (int ng = 0; ng < NO; ng += G) {
        if (wd * (P / C::WD) + ng * 8 >= D) break;
        float pv[G][4] = {}, pk[G][4] = {};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int o = (qw + j * 8) * P + wd * (P / C::WD);
#pragma unroll
          for (int n = 0; n < G; ++n) {  // tile ng + n: phase (ng + n) % 4
            const int t = ng + n, on = o + (t & ~3) * 8;
            mma3(pv[n], pa[j], frag_b_cols(g_s + on, fo.col[0][t & 3], fo.col[1][t & 3]));
            mma3(pk[n], da[j], frag_b_cols(q_s + on, fo.col[0][t & 3], fo.col[1][t & 3]));
          }
        }
#pragma unroll
        for (int n = 0; n < G; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dv_acc[ng + n][c] += pv[n][c];
            dk_acc[ng + n][c] += pk[n][c];
          }
      }
    }
    __syncthreads();
  }

  TQ* dkb = dk + koff * D;
  TV* dvb = dv + koff * D;
  float* red = k_s;  // two R x RP buffers over K, V and the stages
  reduce_rows<C, NO>(red, dk_acc, wm, wn, wd, gr, tc, [&](int r, int c, float x) {
    if (k0 + r < Tk && c < D) dkb[static_cast<size_t>(k0 + r) * D + c] = from_f32<TQ>(x * scale);
  });
  reduce_rows<C, NO>(red + BN * C::RP, dv_acc, wm, wn, wd, gr, tc, [&](int r, int c, float x) {
    if (k0 + r < Tk && c < D) dvb[static_cast<size_t>(k0 + r) * D + c] = from_f32<TV>(x);
  });
}

// ---------------------------------------------------------------------------
// The (bf16, bf16) kernels: bf16 tiles and bf16 mma.sync m16n8k16 products

using bf16 = __nv_bfloat16;

// True in the library of the (bf16, bf16) pair, whose forward, dq and dk/dv
// kernels are the three below.
constexpr bool kBf16Pair =
    std::is_same<QkT, bf16>::value && std::is_same<VT, bf16>::value;

constexpr int kThreads16 = 128;  // 4 warps a block
// k16 steps of a score summed apart: 32 columns (dq) and 16 (dk/dv), the
// spans of kChunkDq and kChunkDkv
constexpr int kChunk16Dq = 2;
constexpr int kChunk16Dkv = 1;

// Tile shape of the bf16 kernels at row width P: 4 warps, WM x WD, warp
// (wm, wd) owning resident rows [16 wm, 16 wm + 16) and output columns
// [wd P / WD, (wd + 1) P / WD) across the whole streamed tile, so that no
// two warps add into one output. The forward and dq stream SFWD and SDQ
// keys a tile, dk/dv SDKV queries.
template <int P_>
struct Bf16Tile {
  static constexpr int P = P_;
  static constexpr int WD = P <= 128 ? 1 : 2;
  static constexpr int WM = kThreads16 / 32 / WD;
  static constexpr int R = 16 * WM;
  static constexpr int SFWD = 32;
  static constexpr int STAGES_FWD = 3;  // the forward's stages of K and V
  static constexpr int SDQ = 32;
  static constexpr int SDKV = 32;
};

// Element (r, c) of a swizzled (rows x P) bf16 tile: 16-byte chunk c / 8 of
// row r sits at chunk (c / 8) ^ (r % 8). The 8 rows that one 8 x 8 matrix
// of an ldmatrix reads at one chunk then lie in 8 distinct bank groups (a
// row is a multiple of 128 bytes), with or without .trans.
template <int P>
__device__ __forceinline__ int swz16(int r, int c) {
  return r * P + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// A lane's address in an ldmatrix.x4 over the 16 x 16 block at (rb, cb) of
// a swizzled tile (rb, cb multiples of 16): row rb + lane % 16, columns
// cb + 8 (lane / 16) onwards. The XOR touches only a chunk's low three
// bits, so the byte offset is 2 (rb P + cb & ~63) + off[(cb / 16) % 4],
// with off computed once.
template <int P>
struct LdsmOff {
  int off[4];
  __device__ explicit LdsmOff(int lane) {
    const int r = lane & 15, x = (lane >> 4) ^ (lane & 7);
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) off[ph] = 2 * (r * P + (((2 * ph) ^ x) << 3));
  }
  __device__ __forceinline__ uint32_t at(uint32_t base, int rb, int cb) const {
    return base + 2 * (rb * P + (cb & ~63)) + off[(cb >> 4) & 3];
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; register i holds row lane / 4, columns
// 2 (lane % 4) and 2 (lane % 4) + 1 of matrix i (of its transpose: .trans).
// Matrices 0-3 start at the addresses of lanes 0, 8, 16 and 24.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The m16n8k16 fragments, lane = 4 g + t: A (16 x 16) a0 (g, 2t..2t+1),
// a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); B (16 x 8)
// b0 (2t..2t+1, g), b1 (2t + 8.., g); C as m16n8k8's. An ldmatrix.x4 at
// LdsmOff's addresses gives A of a 16 x 16 block; B of two n-tiles of a
// block of rows X[n][k] (n0: r0, r2; n0 + 8: r1, r3); and with .trans B of
// two n-tiles of a block of rows X[k][n] (n0: r0, r1; n0 + 8: r2, r3).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to bf16 (to nearest), x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// An f32 A fragment as three bf16 pieces: x = hi + mid + lo + e with
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded
// to nearest; the subtractions are exact, and |e| <= 2^-24 |x|, f32's own
// rounding (each piece leaves at most 2^-8 of what it splits).
struct Frag3 {
  uint32_t hi[4], mid[4], lo[4];
};

__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack_bf16(x, y);
  x -= __uint_as_float(hi << 16);
  y -= __uint_as_float(hi & 0xffff0000u);
  mid = pack_bf16(x, y);
  x -= __uint_as_float(mid << 16);
  y -= __uint_as_float(mid & 0xffff0000u);
  lo = pack_bf16(x, y);
}

// A (16 x 16) from two adjacent C accumulator tiles, columns 0-7 (c0) and
// 8-15 (c1), as they stand: the register reuse of FlashAttention-2.
__device__ __forceinline__ Frag3 frag3_acc(const float (&c0)[4], const float (&c1)[4]) {
  Frag3 f;
  split3(c0[0], c0[1], f.hi[0], f.mid[0], f.lo[0]);
  split3(c0[2], c0[3], f.hi[1], f.mid[1], f.lo[1]);
  split3(c1[0], c1[1], f.hi[2], f.mid[2], f.lo[2]);
  split3(c1[2], c1[3], f.hi[3], f.mid[3], f.lo[3]);
  return f;
}

// d += a b in three bf16 passes, the small pieces first.
__device__ __forceinline__ void mma3_bf16(float (&d)[4], const Frag3& a, uint32_t b0,
                                          uint32_t b1) {
  mma_bf16(d, a.lo, b0, b1);
  mma_bf16(d, a.mid, b0, b1);
  mma_bf16(d, a.hi, b0, b1);
}

// Rows [r0, r0 + ROWS) of a row-major (T, D) bf16 matrix into a swizzled
// (ROWS x P) tile; rows at or past T and columns at or past D are zero.
// VEC: 16-byte cp.async copies of eight values (D % 8 == 0, src 16-byte
// aligned), in flight until the caller waits; else the threads copy one
// value each (visible after the next barrier).
template <int ROWS, int P, bool VEC>
__device__ __forceinline__ void load_tile16(bf16* dst, const bf16* __restrict__ src, int r0,
                                            int T, int D) {
  if constexpr (VEC) {
    constexpr int PER_ROW = P / 8;
    static_assert(ROWS * PER_ROW % kThreads16 == 0, "a thread's share of the tile");
#pragma unroll
    for (int j = 0; j < ROWS * PER_ROW / kThreads16; ++j) {
      const int i = threadIdx.x + j * kThreads16;
      const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
      const bool in = r0 + r < T && c < D;
      cp_async16(dst + swz16<P>(r, c), in ? src + static_cast<size_t>(r0 + r) * D + c : src, in);
    }
  } else {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
    uint16_t* d = reinterpret_cast<uint16_t*>(dst);
    for (int i = threadIdx.x; i < ROWS * P; i += kThreads16) {
      const int r = i / P, c = i % P;
      d[swz16<P>(r, c)] = r0 + r < T && c < D ? s[static_cast<size_t>(r0 + r) * D + c] : 0;
    }
  }
}

// Row `row` of a (T, D) bf16 output from a warp's accumulator tiles: values
// (acc[n][2h], acc[n][2h + 1]) * mul at columns c0 + 8 n + 2t, + 1.
template <int NO, bool VEC>
__device__ __forceinline__ void store_row16(bf16* orow, const float (&acc)[NO][4], int h, int c0,
                                            int t, int D, float mul) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = c0 + n * 8 + 2 * t;
    const float x = acc[n][2 * h] * mul, y = acc[n][2 * h + 1] * mul;
    if (VEC) {  // D % 8 == 0: col and col + 1 are both in or both out
      if (col < D) store2(orow + col, x, y);
    } else {
      if (col < D) orow[col] = __float2bfloat16_rn(x);
      if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(y);
    }
  }
}

// s = A1 X1^T and dp = A2 X2^T for a warp: A1, A2 the 16 rows of swizzled
// tiles at a1, a2; X1, X2 the N rows at x1, x2; over the columns below
// dmax, rounded up to 16 CHUNK (past D the tiles hold zeros). One bf16 pass
// a k16 step, the exact products summed CHUNK k16 steps apart, then joined
// by f32 adds; the two products interleaved.
template <int P, int N, int CHUNK>
__device__ __forceinline__ void scores16(float (&s)[N / 8][4], float (&dp)[N / 8][4],
                                         uint32_t a1, uint32_t x1, uint32_t a2, uint32_t x2,
                                         const LdsmOff<P>& lo, int dmax) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
  for (int kc = 0; kc < P; kc += 16 * CHUNK) {
    if (kc >= dmax) break;
    float ts[N / 8][4], tp[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) ts[j][c] = tp[j][c] = 0.f;
#pragma unroll
    for (int kk = kc; kk < kc + 16 * CHUNK; kk += 16) {
      uint32_t fa1[4], fa2[4];
      ldsm4(fa1, lo.at(a1, 0, kk));
      ldsm4(fa2, lo.at(a2, 0, kk));
#pragma unroll
      for (int j = 0; j < N / 8; j += 2) {
        uint32_t f1[4], f2[4];
        ldsm4(f1, lo.at(x1, j * 8, kk));
        ldsm4(f2, lo.at(x2, j * 8, kk));
        mma_bf16(ts[j], fa1, f1[0], f1[2]);
        mma_bf16(ts[j + 1], fa1, f1[1], f1[3]);
        mma_bf16(tp[j], fa2, f2[0], f2[2]);
        mma_bf16(tp[j + 1], fa2, f2[1], f2[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] += ts[j][c];
        dp[j][c] += tp[j][c];
      }
  }
}

// s = A X^T for a warp, scores16's sums for one product: A the 16 rows of a
// swizzled tile at a, X the N rows at x, over the columns below dmax.
template <int P, int N, int CHUNK>
__device__ __forceinline__ void score16(float (&s)[N / 8][4], uint32_t a, uint32_t x,
                                        const LdsmOff<P>& lo, int dmax) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int kc = 0; kc < P; kc += 16 * CHUNK) {
    if (kc >= dmax) break;
    float ts[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) ts[j][c] = 0.f;
#pragma unroll
    for (int kk = kc; kk < kc + 16 * CHUNK; kk += 16) {
      uint32_t fa[4];
      ldsm4(fa, lo.at(a, 0, kk));
#pragma unroll
      for (int j = 0; j < N / 8; j += 2) {
        uint32_t f[4];
        ldsm4(f, lo.at(x, j * 8, kk));
        mma_bf16(ts[j], fa, f[0], f[2]);
        mma_bf16(ts[j + 1], fa, f[1], f[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] += ts[j][c];
  }
}

// out += X Y for a warp's output columns [c0, c0 + 8 NO): X (16 x N, f32,
// accumulator tiles) in three bf16 pieces, Y the N rows of a swizzled tile
// at y (ldmatrix.trans), this tile's product summed apart; output tiles in
// groups of G under one guard (columns past D skipped), so that the G
// chains of dependent products of a group overlap. RESCALE: out = out
// alpha + X Y instead, alpha[h] the factor of rows g + 8 h (the forward's
// online softmax), in one fmaf.
template <int P, int N, int NO, int G, bool RESCALE = false>
__device__ __forceinline__ void add_product16(float (&out)[NO][4], const float (&x)[N / 8][4],
                                              uint32_t y, const LdsmOff<P>& lo, int c0, int D,
                                              const float* alpha = nullptr) {
  Frag3 xa[N / 16];
#pragma unroll
  for (int i = 0; i < N / 16; ++i) xa[i] = frag3_acc(x[2 * i], x[2 * i + 1]);
#pragma unroll
  for (int ng = 0; ng < NO; ng += G) {
    if (c0 + ng * 8 >= D) break;
    float part[G][4] = {};
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
#pragma unroll
      for (int n = 0; n < G; n += 2) {
        uint32_t b[4];
        ldsm4t(b, lo.at(y + 2 * c0, i * 16, (ng + n) * 8));
        mma3_bf16(part[n], xa[i], b[0], b[1]);
        mma3_bf16(part[n + 1], xa[i], b[2], b[3]);
      }
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[ng + n][c] = RESCALE ? fmaf(out[ng + n][c], alpha[c >> 1], part[n][c])
                                 : out[ng + n][c] + part[n][c];
  }
}

// 2^x by the multi-function unit's ex2.approx.ftz, on which exp2f is built:
// exp2f adds a rescaling step for results below 2^-126, which P does not
// need (a P flushed to 0 there is far below the rounding of its row's sum,
// which is at least 1). 6-7% faster than exp2f in the forward on an H100.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// forward, (bf16, bf16): one block per (bh, query tile); grid
// BH * ceil(Tq / R). S = q K^T is formed from the bf16 values and scaled in
// f32, where the TPU kernel scales q in f32 first: the two agree bit for
// bit when scale is a power of two (1/8 at D = 64) and otherwise differ in
// the last bit of a score.
template <int P, bool VEC>
__global__ void __launch_bounds__(kThreads16, P <= 64 && VEC ? 4 : P <= 128 ? 3 : 2)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ kvalid,
                          bf16* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
                          int D, int causal, int causal_off, float scale) {
  using C = Bf16Tile<P>;
  constexpr int BM = C::R;           // query rows of the block
  constexpr int BN = C::SFWD;        // keys of a streamed tile
  constexpr int NK = BN / 8;         // their n-tiles
  constexpr int PW = P / C::WD;      // output columns of a warp
  constexpr int NO = PW / 8;         // their n-tiles
  constexpr int STAGE = 2 * BN * P;  // K tile, then V tile
  constexpr int NS = C::STAGES_FWD;
  extern __shared__ float4 smem_v4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_v4);  // BM x P, q
  bf16* kv_s = q_s + BM * P;                     // NS stages

  // causal: every head's longest query tiles first; else a head's tiles
  // next to each other, as dq's
  const int n_qt = (Tq + BM - 1) / BM, n_bh = gridDim.x / n_qt;
  const int bh = causal ? blockIdx.x % n_bh : blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (causal ? blockIdx.x / n_bh : blockIdx.x % n_qt)) * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int wm = warp % C::WM, wd = warp / C::WM;
  const int r0 = q0 + wm * 16;  // the warp's first query row
  const int c0 = wd * PW;       // its first output column
  const LdsmOff<P> lo(lane);
  const int kv_len = min(kvalid[bh / H], Tk);
  const int k_end = key_end<BM>(q0, kv_len, causal, causal_off);
  const int n_tiles = k_end > 0 ? (k_end + BN - 1) / BN : 0;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const bf16* kb = k + static_cast<size_t>(bh) * Tk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float sl = scale * kLog2e;  // a score's factor in exp2

  // the output rows, their running max (of the unscaled scores) and sum
  // (h = 0: row gr, h = 1: gr + 8)
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // tile t's K and V into stage t % NS; one commit group a tile, empty
  // past the last, so that group t always holds tile t (and group 0 q)
  auto load_stage = [&](int t) {
    if (t < n_tiles) {
      bf16* st = kv_s + (t % NS) * STAGE;
      load_tile16<BN, P, VEC>(st, kb, t * BN, Tk, D);
      load_tile16<BN, P, VEC>(st + BN * P, vb, t * BN, Tk, D);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_tile16<BM, P, VEC>(q_s, q + qoff * D, q0, Tq, D);
#pragma unroll
    for (int t = 0; t < NS - 1; ++t) load_stage(t);
    const uint32_t qa_s = smem_u32(q_s + wm * 16 * P), kv_a = smem_u32(kv_s);
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // tile it landed; every warp is done with tile it - 1
      load_stage(it + NS - 1);  // into the stage of tile it - 1
      const int k0 = it * BN;
      // a warp whose rows see no key of this tile leaves m, l and its rows
      // as they are, which is what the softmax of a dropped tile gives
      if (causal && k0 > r0 + 15 + causal_off) continue;
      const uint32_t k_a = kv_a + 2 * (it % NS) * STAGE, v_a = k_a + 2 * BN * P;

      // S = q K^T for the warp's rows and the tile's keys, unscaled
      float s[NK][4];
      score16<P, BN, kChunk16Dq>(s, qa_s, k_a, lo, D);
      // the online softmax of the f32 forward, with scale folded into
      // exp2: dropped scores to -1e30, the rows' new max over the quad,
      // P = exp((S - m) scale) on the alive rows, l and the output rows
      // rescaled by alpha = exp((m_old - m) scale); full: the mask keeps
      // every pair of the tile
      const int k_last = k0 + BN - 1;
      const bool full = k_last < kv_len && (!causal || k_last <= r0 + causal_off);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          if (!full && !kept(r0 + gr + 8 * h, k0 + j * 8 + 2 * tc + (c & 1), kv_len, causal,
                             causal_off))
            s[j][c] = kNegInf;
          mx[h] = fmaxf(mx[h], s[j][c]);
        }
      float alpha[2], mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f((m[h] - m_new) * sl);
        m[h] = m_new;
        mb[h] = m_new * sl;
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          const float p = m[h] > kAliveMin ? ex2_ftz(fmaf(s[j][c], sl, -mb[h])) : 0.f;
          s[j][c] = p;
          sum[h] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }
      // out = out alpha + P V over the tile's keys, P in three bf16 pieces
      add_product16<P, BN, NO, (NO < 8 ? NO : 8), true>(acc, s, v_a, lo, c0, D, alpha);
    }
  }

  // out = acc / l (l = 0 on a dead row, whose acc is 0), lse = m scale + log
  // l. The quotient is rounded as a division rounds it, as the plain
  // version divides (a product by the rounded 1 / l alone would move every
  // bf16 rounding of a row the same way), by Markstein's correction of
  // that product: two fmaf, cheaper than a division
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gr + 8 * h;
    if (row >= Tq) continue;
    const float lsafe = l[h] == 0.f ? 1.f : l[h];
    const float rl = 1.f / lsafe;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = acc[n][2 * h + e], qt = x * rl;
        acc[n][2 * h + e] = fmaf(fmaf(-qt, lsafe, x), rl, qt);
      }
    store_row16<NO, VEC>(out + (qoff + row) * D, acc, h, c0, tc, D, 1.f);
    if (wd == 0 && tc == 0) lse[qoff + row] = l[h] == 0.f ? kNegInf : m[h] * scale + logf(lsafe);
  }
}

// dq, (bf16, bf16): one block per (bh, query tile); grid BH * ceil(Tq / R)
template <int P, bool VEC>
__global__ void __launch_bounds__(kThreads16, P <= 128 ? 3 : 2)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ g,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const int* __restrict__ kvalid, bf16* __restrict__ dq, int H,
                             int Tq, int Tk, int D, int causal, int causal_off, float scale) {
  using C = Bf16Tile<P>;
  constexpr int BM = C::R;           // query rows of the block
  constexpr int BN = C::SDQ;         // keys of a streamed tile
  constexpr int NK = BN / 8;         // their n-tiles
  constexpr int PW = P / C::WD;      // output columns of a warp
  constexpr int NO = PW / 8;         // their n-tiles
  constexpr int STAGE = 2 * BN * P;  // K tile, then V tile
  extern __shared__ float4 smem_v4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_v4);  // BM x P, q
  bf16* g_s = q_s + BM * P;                      // BM x P, dO
  bf16* kv_s = g_s + BM * P;                     // two stages

  // causal: every head's longest query tiles first, so that the shortest
  // end the grid; else a head's tiles next to each other, so that the
  // second read of its K and V hits L2
  const int n_qt = (Tq + BM - 1) / BM, n_bh = gridDim.x / n_qt;
  const int bh = causal ? blockIdx.x % n_bh : blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (causal ? blockIdx.x / n_bh : blockIdx.x % n_qt)) * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int wm = warp % C::WM, wd = warp / C::WM;
  const int r0 = q0 + wm * 16;  // the warp's first query row
  const int c0 = wd * PW;       // its first output column
  const LdsmOff<P> lo(lane);
  const int kv_len = kvalid[bh / H];
  const int k_end = key_end<BM>(q0, kv_len, causal, causal_off);
  const int n_tiles = k_end > 0 ? (k_end + BN - 1) / BN : 0;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const bf16* kb = k + static_cast<size_t>(bh) * Tk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * Tk * D;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  if (n_tiles > 0) {
    load_tile16<BM, P, VEC>(q_s, q + qoff * D, q0, Tq, D);
    load_tile16<BM, P, VEC>(g_s, g + qoff * D, q0, Tq, D);
    load_tile16<BN, P, VEC>(kv_s, kb, 0, Tk, D);
    load_tile16<BN, P, VEC>(kv_s + BN * P, vb, 0, Tk, D);
    cp_async_commit();
    // lse and delta of the thread's two rows (h = 0: row g, h = 1: g + 8)
    float lr[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + gr + 8 * h;
      lr[h] = row < Tq ? lse[qoff + row] : kNegInf;
      dl[h] = row < Tq ? delta[qoff + row] : 0.f;
    }
    const uint32_t qa_s = smem_u32(q_s + wm * 16 * P), ga_s = smem_u32(g_s + wm * 16 * P);
    const uint32_t kv_a = smem_u32(kv_s);
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<0>();
      __syncthreads();  // tile it landed; every warp is done with tile it - 1
      if (it + 1 < n_tiles) {
        bf16* nxt = kv_s + ((it + 1) & 1) * STAGE;
        load_tile16<BN, P, VEC>(nxt, kb, (it + 1) * BN, Tk, D);
        load_tile16<BN, P, VEC>(nxt + BN * P, vb, (it + 1) * BN, Tk, D);
        cp_async_commit();
      }
      const int k0 = it * BN;
      // a warp whose rows see no key of this tile adds 0
      if (k0 >= kv_len || (causal && k0 > r0 + 15 + causal_off)) continue;
      const uint32_t k_a = kv_a + 2 * (it & 1) * STAGE, v_a = k_a + 2 * BN * P;

      // S = q K^T and dP = dO V^T for the warp's rows and the tile's keys,
      // all P columns (past D they are zeros)
      float s[NK][4], dp[NK][4];
      scores16<P, BN, kChunk16Dq>(s, dp, qa_s, k_a, ga_s, v_a, lo, P);
      // dS = P * (dP - delta), P = exp(S scale - lse) on the kept pairs, as
      // the f32 kernel forms it; full: the mask keeps every pair of the tile
      const int k_last = k0 + BN - 1;
      const bool full = k_last < kv_len && (!causal || k_last <= r0 + causal_off);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          const int qpos = r0 + gr + 8 * h;
          const int kpos = k0 + j * 8 + 2 * tc + (c & 1);
          const bool keep =
              lr[h] > kAliveMin && (full || kept(qpos, kpos, kv_len, causal, causal_off));
          const float p = keep ? exp2f(fmaf(s[j][c], scale * kLog2e, -lr[h] * kLog2e)) : 0.f;
          s[j][c] = p * (dp[j][c] - dl[h]);
        }
      // dq += dS K over the tile's keys
      add_product16<P, BN, NO, (NO < 8 ? NO : 8)>(acc, s, k_a, lo, c0, D);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gr + 8 * h;
    if (row < Tq) store_row16<NO, VEC>(dq + (qoff + row) * D, acc, h, c0, tc, D, scale);
  }
}

// dk, dv, (bf16, bf16): one block per (bh, key tile); grid BH * ceil(Tk / R)
template <int P, bool VEC>
__global__ void __launch_bounds__(kThreads16, P <= 64 ? 3 : 2)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ g,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const int* __restrict__ kvalid, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int H, int Tq, int Tk, int D, int causal,
                              int causal_off, float scale) {
  using C = Bf16Tile<P>;
  constexpr int BN = C::R;           // keys of the block
  constexpr int BM = C::SDKV;        // queries of a streamed tile
  constexpr int NQ = BM / 8;         // their n-tiles
  constexpr int PW = P / C::WD;      // output columns of a warp
  constexpr int NO = PW / 8;         // their n-tiles
  constexpr int STAGE = 2 * BM * P;  // q tile, then dO tile
  extern __shared__ float4 smem_v4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_v4);  // BN x P
  bf16* v_s = k_s + BN * P;                      // BN x P
  bf16* st_s = v_s + BN * P;                     // two stages
  float* rows_s = reinterpret_cast<float*>(st_s + 2 * STAGE);  // two stages of lse, delta

  // causal: every head's first key tiles (which see the most queries)
  // first; else a head's tiles next to each other, as dq's
  const int n_kt = (Tk + BN - 1) / BN, n_bh = gridDim.x / n_kt;
  const int bh = causal ? blockIdx.x % n_bh : blockIdx.x / n_kt;
  const int k0 = (causal ? blockIdx.x / n_bh : blockIdx.x % n_kt) * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int wm = warp % C::WM, wd = warp / C::WM;
  const int kr = k0 + wm * 16;  // the warp's first key
  const int c0 = wd * PW;       // its first output column
  const LdsmOff<P> lo(lane);
  const int kv_len = kvalid[bh / H];
  // the first query tile whose last row sees key k0; a tile past kvalid
  // gets no gradient
  const int q_first = causal ? max(0, k0 - causal_off) / BM * BM : 0;
  const int n_tiles = k0 < kv_len && q_first < Tq ? (Tq - q_first + BM - 1) / BM : 0;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const size_t koff = static_cast<size_t>(bh) * Tk;
  const bf16* qb = q + qoff * D;
  const bf16* gb = g + qoff * D;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  auto load_stage = [&](int st, int q0) {
    load_tile16<BM, P, VEC>(st_s + st * STAGE, qb, q0, Tq, D);
    load_tile16<BM, P, VEC>(st_s + st * STAGE + BM * P, gb, q0, Tq, D);
    load_rows_async<BM>(rows_s + st * 2 * BM, lse + qoff, q0, Tq);
    load_rows_async<BM>(rows_s + st * 2 * BM + BM, delta + qoff, q0, Tq);
  };

  if (n_tiles > 0) {
    load_tile16<BN, P, VEC>(k_s, k + koff * D, k0, Tk, D);
    load_tile16<BN, P, VEC>(v_s, v + koff * D, k0, Tk, D);
    load_stage(0, q_first);
    cp_async_commit();
    const uint32_t ka_s = smem_u32(k_s + wm * 16 * P), va_s = smem_u32(v_s + wm * 16 * P);
    const uint32_t st_a = smem_u32(st_s);
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = q_first + it * BM;
      cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < n_tiles) {
        load_stage((it + 1) & 1, q0 + BM);
        cp_async_commit();
      }
      // a warp whose keys are all masked for this tile's queries adds 0
      if (kr >= kv_len || (causal && kr > q0 + BM - 1 + causal_off)) continue;
      const uint32_t q_a = st_a + 2 * (it & 1) * STAGE, g_a = q_a + 2 * BM * P;
      const float* lse_s = rows_s + (it & 1) * 2 * BM;
      const float* dl_s = lse_s + BM;

      // S^T = K q^T and dP^T = V dO^T for the warp's keys and the tile's
      // queries, over the columns below D
      float s[NQ][4], dp[NQ][4];
      scores16<P, BM, kChunk16Dkv>(s, dp, ka_s, q_a, va_s, g_a, lo, D);
      // P^T into s, dS^T into dp, as the f32 kernel forms them; a query's
      // lse and delta are per column. full: the mask keeps every pair of
      // the warp's tile
      const int k_last = kr + 15;
      const bool full =
          k_last < kv_len && q0 + BM <= Tq && (!causal || k_last <= q0 + causal_off);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = j * 8 + 2 * tc + (c & 1);
          const int qpos = q0 + col;
          const int kpos = kr + gr + 8 * (c >> 1);
          const float lq = lse_s[col];
          const bool keep = lq > kAliveMin && (full || (qpos < Tq && kept(qpos, kpos, kv_len,
                                                                          causal, causal_off)));
          const float p = keep ? exp2f(fmaf(s[j][c], scale * kLog2e, -lq * kLog2e)) : 0.f;
          s[j][c] = p;
          dp[j][c] = p * (dp[j][c] - dl_s[col]);
        }
      // dv += P^T dO, then dk += dS^T q, over the tile's queries
      constexpr int G = NO < 4 ? NO : 4;
      add_product16<P, BM, NO, G>(dv_acc, s, g_a, lo, c0, D);
      add_product16<P, BM, NO, G>(dk_acc, dp, q_a, lo, c0, D);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kr + gr + 8 * h;
    if (row >= Tk) continue;
    store_row16<NO, VEC>(dk + (koff + row) * D, dk_acc, h, c0, tc, D, scale);
    store_row16<NO, VEC>(dv + (koff + row) * D, dv_acc, h, c0, tc, D, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launch

enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

// Row width P of the tiles: D rounded up to 64, 128 or 256.
inline int tile_width(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

// Floats of shared memory of a block: the resident tiles and two stages
// (forward: q; K, V. dq: q, dO; K, V. dk/dv: K, V; q, dO, lse, delta).
template <int P>
constexpr size_t smem_floats(int kernel) {
  if (kernel == kFwd) return FwdTile<P>::R * P + 2 * (2 * FwdTile<P>::S * P);
  using C = BwdTile<P>;
  return 2 * C::R * P + 2 * (2 * C::S * P + (kernel == kDkv ? 2 * C::S : 0));
}

// Bytes of shared memory of a bf16 block: the resident bf16 tiles and the
// stages (forward: q; STAGES_FWD of K, V. dq: q, dO; two of K, V. dk/dv: K,
// V; two of q, dO, and lse, delta f32).
template <int P>
constexpr size_t smem_bytes_bf16(int kernel) {
  using C = Bf16Tile<P>;
  return kernel == kFwd ? 2 * (C::R * P + C::STAGES_FWD * 2 * C::SFWD * P)
         : kernel == kDq ? 2 * (2 * C::R * P + 2 * 2 * C::SDQ * P)
                         : 2 * (2 * C::R * P + 2 * 2 * C::SDKV * P) + 4 * 2 * 2 * C::SDKV;
}

template <int P>
constexpr size_t smem_bytes_of(int kernel) {
  return kBf16Pair ? smem_bytes_bf16<P>(kernel) : smem_floats<P>(kernel) * sizeof(float);
}

inline size_t smem_bytes(int kernel, int D) {
  const int p = tile_width(D);
  return p == 64 ? smem_bytes_of<64>(kernel)
                 : p == 128 ? smem_bytes_of<128>(kernel) : smem_bytes_of<256>(kernel);
}

struct Args {
  const void *q, *k, *v, *g;  // QkT, except v: VT
  const float *lse, *delta;
  const int* kvalid;
  void *o0, *o1;  // fwd: out (QkT), lse (f32); dq: dq (QkT); dkv: dk (QkT), dv (VT)
  int BH, H, Tq, Tk, D, causal, causal_off;
  float scale;
};

template <class F>
cudaError_t set_smem(F* fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The (bf16, bf16) kernels.
template <int P, bool VEC>
cudaError_t launch_bf16(int kernel, const Args& a, cudaStream_t st) {
  using C = Bf16Tile<P>;
  const size_t smem = smem_bytes(kernel, a.D);
  const int rows = kernel == kDkv ? a.Tk : a.Tq;
  const dim3 grid(a.BH * ((rows + C::R - 1) / C::R));
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* g = static_cast<const bf16*>(a.g);
  cudaError_t err;
  if (kernel == kFwd) {
    err = set_smem(flash_fwd_bf16_kernel<P, VEC>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<P, VEC><<<grid, kThreads16, smem, st>>>(
        q, k, v, a.kvalid, static_cast<bf16*>(a.o0), static_cast<float*>(a.o1), a.H, a.Tq, a.Tk,
        a.D, a.causal, a.causal_off, a.scale);
  } else if (kernel == kDq) {
    err = set_smem(flash_bwd_dq_bf16_kernel<P, VEC>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<P, VEC><<<grid, kThreads16, smem, st>>>(
        q, k, v, g, a.lse, a.delta, a.kvalid, static_cast<bf16*>(a.o0), a.H, a.Tq, a.Tk, a.D,
        a.causal, a.causal_off, a.scale);
  } else {
    err = set_smem(flash_bwd_dkv_bf16_kernel<P, VEC>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_bf16_kernel<P, VEC><<<grid, kThreads16, smem, st>>>(
        q, k, v, g, a.lse, a.delta, a.kvalid, static_cast<bf16*>(a.o0),
        static_cast<bf16*>(a.o1), a.H, a.Tq, a.Tk, a.D, a.causal, a.causal_off, a.scale);
  }
  return cudaGetLastError();
}

template <int P, bool VEC>
cudaError_t launch_tiles(int kernel, const Args& a, cudaStream_t st) {
  const size_t smem = smem_bytes(kernel, a.D);
  const int rows = kernel == kDkv ? a.Tk : a.Tq;
  const int tile = kernel == kFwd ? FwdTile<P>::R : BwdTile<P>::R;  // resident rows
  const dim3 grid(a.BH, (rows + tile - 1) / tile);
  const QkT* q = static_cast<const QkT*>(a.q);
  const QkT* k = static_cast<const QkT*>(a.k);
  const VT* v = static_cast<const VT*>(a.v);
  const QkT* g = static_cast<const QkT*>(a.g);
  cudaError_t err;
  if (kernel == kFwd) {
    err = set_smem(flash_fwd_kernel<P, VEC, QkT, VT>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<P, VEC, QkT, VT><<<grid, kThreads, smem, st>>>(
        q, k, v, a.kvalid, static_cast<QkT*>(a.o0), static_cast<float*>(a.o1), a.H, a.Tq, a.Tk,
        a.D, a.causal, a.causal_off, a.scale);
  } else if (kernel == kDq) {
    err = set_smem(flash_bwd_dq_kernel<P, VEC, QkT, VT>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<P, VEC, QkT, VT><<<grid, kThreads, smem, st>>>(
        q, k, v, g, a.lse, a.delta, a.kvalid, static_cast<QkT*>(a.o0), a.H, a.Tq, a.Tk, a.D,
        a.causal, a.causal_off, a.scale);
  } else {
    err = set_smem(flash_bwd_dkv_kernel<P, VEC, QkT, VT>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<P, VEC, QkT, VT><<<grid, kThreads, smem, st>>>(
        q, k, v, g, a.lse, a.delta, a.kvalid, static_cast<QkT*>(a.o0), static_cast<VT*>(a.o1),
        a.H, a.Tq, a.Tk, a.D, a.causal, a.causal_off, a.scale);
  }
  return cudaGetLastError();
}

// p starts on a multiple of four elements of E (f32: 16 bytes)
template <class E>
inline bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(E)) == 0;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Four values a copy (f32: 16-byte cp.async; bf16/f16: 8-byte loads) where
// every row of q, k, v, dO (and the forward's out, stored in pairs) starts
// on four elements, else the same kernel with one value a copy. The
// (bf16, bf16) kernels copy eight values (16 bytes) a copy where every row
// of q, k, v, dO (the forward has none: g is null) and of the bf16 outputs
// (stored in pairs) starts on 16 bytes.
inline bool vec_of(int kernel, const Args& a) {
  if (kBf16Pair)
    return a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
           aligned16(a.g) && aligned16(a.o0) && (kernel != kDkv || aligned16(a.o1));
  return a.D % 4 == 0 && aligned4<QkT>(a.q) && aligned4<QkT>(a.k) && aligned4<VT>(a.v) &&
         aligned4<QkT>(a.g) && (kernel != kFwd || aligned4<QkT>(a.o0));
}

template <int P>
cudaError_t launch_width(int kernel, const Args& a, cudaStream_t st) {
  const bool vec = vec_of(kernel, a);
  if constexpr (kBf16Pair)
    return vec ? launch_bf16<P, true>(kernel, a, st) : launch_bf16<P, false>(kernel, a, st);
  else
    return vec ? launch_tiles<P, true>(kernel, a, st) : launch_tiles<P, false>(kernel, a, st);
}

// out = {registers a thread, local (spill) bytes a thread, the most blocks
// an SM holds at the kernel's dynamic shared memory, threads a block, that
// shared memory in bytes} of a kernel function.
template <class F>
cudaError_t attributes_of(F* fn, size_t smem, int threads, int* out) {
  cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = blocks;
  out[3] = threads;
  out[4] = static_cast<int>(smem);
  return err;
}

template <int P, bool VEC>
cudaError_t attributes_tiles(int kernel, int D, int* out) {
  const size_t smem = smem_bytes(kernel, D);
  if constexpr (kBf16Pair) {
    return kernel == kFwd ? attributes_of(flash_fwd_bf16_kernel<P, VEC>, smem, kThreads16, out)
           : kernel == kDq
               ? attributes_of(flash_bwd_dq_bf16_kernel<P, VEC>, smem, kThreads16, out)
               : attributes_of(flash_bwd_dkv_bf16_kernel<P, VEC>, smem, kThreads16, out);
  } else {
    if (kernel == kFwd)
      return attributes_of(flash_fwd_kernel<P, VEC, QkT, VT>, smem, kThreads, out);
    return kernel == kDq
               ? attributes_of(flash_bwd_dq_kernel<P, VEC, QkT, VT>, smem, kThreads, out)
               : attributes_of(flash_bwd_dkv_kernel<P, VEC, QkT, VT>, smem, kThreads, out);
  }
}

template <int P>
cudaError_t attributes_width(int kernel, int D, bool vec, int* out) {
  return vec ? attributes_tiles<P, true>(kernel, D, out) : attributes_tiles<P, false>(kernel, D, out);
}

int launch(int kernel, const Args& a, void* stream) {
  if (a.D < 1 || a.D > 256 || a.BH < 1 || a.H < 1 || a.Tq < 1 || a.Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int p = tile_width(a.D);
  const cudaError_t err = p == 64    ? launch_width<64>(kernel, a, st)
                          : p == 128 ? launch_width<128>(kernel, a, st)
                                     : launch_width<256>(kernel, a, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// All tensors contiguous on the device, q, k and g of the library's q/k
// dtype and v of its v dtype (mxtt_flash_dtypes): q (BH, Tq, D); k, v
// (BH, Tk, D); g and the outputs shaped, and typed, as the tensor they
// differentiate; lse, delta (BH, Tq) f32; kvalid (B,) int32 with
// B = BH / H. Each function launches on `stream` without synchronising and
// returns cudaGetLastError() (cudaErrorInvalidValue for an empty shape or D
// outside 1..256).
int mxtt_flash_fwd(const void* q, const void* k, const void* v, const void* kvalid, void* out,
                   void* lse, int BH, int H, int Tq, int Tk, int D, int causal, int causal_off,
                   float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, static_cast<const int*>(kvalid), out, lse,
         BH, H, Tq, Tk, D, causal, causal_off, scale};
  return launch(kFwd, a, stream);
}

int mxtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                      const void* delta, const void* kvalid, void* dq, int BH, int H, int Tq,
                      int Tk, int D, int causal, int causal_off, float scale, void* stream) {
  Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(kvalid), dq, nullptr, BH, H, Tq, Tk, D, causal, causal_off,
         scale};
  return launch(kDq, a, stream);
}

int mxtt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                       const void* lse, const void* delta, const void* kvalid, void* dk, void* dv,
                       int BH, int H, int Tq, int Tk, int D, int causal, int causal_off,
                       float scale, void* stream) {
  Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(kvalid), dk, dv, BH, H, Tq, Tk, D, causal, causal_off, scale};
  return launch(kDkv, a, stream);
}

// The dtype pair the library was built for: 16 * (q/k code) + (v code),
// codes 0 f32, 1 bf16, 2 f16.
int mxtt_flash_dtypes() { return 16 * MXTT_FLASH_QK + MXTT_FLASH_V; }

// Dynamic shared memory of one block of `kernel` (0 fwd, 1 dq, 2 dk/dv) at D.
long long mxtt_flash_smem_bytes(int kernel, int D) {
  return static_cast<long long>(smem_bytes(kernel, D));
}

// The attributes of `kernel` (0 fwd, 1 dq, 2 dk/dv) as launched at D, its
// instantiation of 16-byte copies (vec != 0) or of narrow ones: out[0]
// registers a thread, out[1] local bytes a thread (spills), out[2] the most
// blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its
// dynamic shared memory), out[3] threads a block, out[4] dynamic shared
// bytes. Returns a cudaError_t.
int mxtt_flash_kernel_attributes(int kernel, int D, int vec, int* out) {
  if (kernel < kFwd || kernel > kDkv || D < 1 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int p = tile_width(D);
  const cudaError_t err = p == 64    ? attributes_width<64>(kernel, D, vec != 0, out)
                          : p == 128 ? attributes_width<128>(kernel, D, vec != 0, out)
                                     : attributes_width<256>(kernel, D, vec != 0, out);
  return static_cast<int>(err);
}

const char* mxtt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
