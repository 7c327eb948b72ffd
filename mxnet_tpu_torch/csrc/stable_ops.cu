// Shape-stable f32 kernels of the strict `baseline` serving rung, written by
// hand for Hopper (sm_90a).
//
// Replaces no pl.pallas_call. The JAX package runs this rung on XLA with
// mul+reduce formulations whose summation order does not depend on the
// leading shape (mxnet_tpu/ops/nn.py, stable_dense at :1053, the baseline
// branch of cached_attention at :1018-1033) and pins XLA's compiler options
// (mxnet_tpu/serve/engine.py:89-101). Its serving contract: the logits of a
// T = 1 decode step equal, bit for bit, those of a full prefill of the same
// prefix. On the card cuBLAS picks its kernel and split-K by the number of
// rows, and PyTorch's row reductions their block layout by the number of
// rows, so neither library call keeps that contract. These three kernels
// do:
//
//  S1 stable_dense_kernel:  out[m, o] = sum_u x[m, u] * w[o, u] (+ b[o]),
//     x (M, U), w (O, U) as Gluon keeps it (mxnet_tpu/ops/nn.py:1053);
//  S2 stable_attention_kernel: causal attention of q (B, H, T, D) at
//     positions start_pos[b] + t over unexpanded (B, KV, S, D) rings,
//     head h reading KV head h / (H / KV) (:1018-1033): s_j = (q . k_j) *
//     scale for j <= start_pos[b] + t, m = max_j s_j, e_j = exp(s_j - m),
//     p_j = e_j / sum_j e_j (a division, as in JAX), out = sum_j p_j v_j;
//  S3 stable_rms_norm_kernel: x * (1 / sqrt(mean(x^2) + eps)) * gamma
//     along the last axis (mxnet_tpu/ops/nn.py:497-508): the mean of
//     squares (square, then add), the reciprocal root, the product with x,
//     then with gamma, each rounded.
//
// THE ONE DESIGN RULE. The arithmetic that produces one output element is a
// function of the reduced length alone (U for S1; D and the row's live
// length for S2; the row length for S3), never of M, B or T, of the row's
// place in a tile, of the grid, or of the number of SMs. So there is no
// split-K, no split over S, no atomics, and every sum is written with
// __fmaf_rn / __fadd_rn / __fmul_rn / __fdiv_rn so that nvcc contracts
// nothing on its own. The canonical orders:
//
//  * S1 and S3, over a row of length U: lane l of a warp (32 lanes) owns the
//    positions u = 128 i + 4 l + j (i = 0, 1, ..., j = 0..3, u < U) and
//    chains them in increasing u into one f32 partial (S1: acc =
//    fma(x, w, acc); S3: acc = acc + x * x); the 32 partials are then
//    summed by one butterfly, p = p + shfl_xor(p, off) for off = 16, 8, 4,
//    2, 1, after which every lane holds the same total (IEEE addition
//    commutes). A float4 load covers one lane's j = 0..3 when the row is 16-
//    byte aligned and U % 4 == 0; otherwise the same positions load one by
//    one, in the same order, so both paths give the same bits;
//  * S2, for one query row with n = min(start_pos[b] + t + 1, S) live
//    positions: each score is one fma chain over d = 0..D-1, then times
//    scale; the max is exact; lane l sums e_j for j = l, l + 32, ... in
//    increasing j and the butterfly adds the 32 partials; each output
//    element d is one fma chain over j = 0..n-1. Positions past n are never
//    read: they are the ones the JAX formula masks, whose e_j and p_j v_j
//    are exact zeros there.
//
// The decode and prefill instantiations of S1 differ only in how many
// rows and output channels a warp carries and where its operands come
// from (global memory, or a ring of shared-memory stages at prefill rows);
// each output element's chain and butterfly are the same. S2's three kernels
// (the heads kernel, a block a query time; the rows kernel, a block of up
// to 32 query rows, for T > 1; the decode kernel, a cluster of up to 8
// blocks a query time and KV head, for T = 1) give each row the same
// arithmetic, and so do S3's two (a warp a row; rows staged in shared
// memory).
//
// Bound. S1 at decode rows (M = 4) is a weight stream (f32 weights, 30 GB
// for one Llama-3-8B forward, 8.96 ms at 3.35 TB/s); at prefill rows (M =
// 1024) f32 FMAs outside the tensor cores (14.29 TFLOP for a forward, 0.21 s
// at 67 TFLOP/s). The tensor cores do not round as an f32 FMA chain does,
// so they cannot take part. S2 and S3 read their inputs once and are bound
// by bytes, S2 at prefill by its f32 products. The design's answer: S1
// keeps every output's chain inside one warp and fills the card with warps
// (one or two output channels a warp at decode rows, several loads in
// flight a lane). At prefill rows the canonical order gives each operand
// element to one lane only, so nothing is broadcast: a lane's 8 x 8 tile
// reads 16 floats for 64 FMAs, from chunks of x and w that a block of 32 x
// 32 outputs stages by cp.async in a ring of shared memory, its 16 warps
// joined by per-stage mbarriers and not by a block barrier. S2 keeps K/V
// tiles in shared memory, each arriving by cp.async while the one before it
// is read, for the query heads of one KV head at T = 1 and for up to 32
// (query time, head) rows of one KV head above, so a staged tile serves
// them all. At T = 1 a cluster of blocks shares one KV head's work: each
// block stages a slice of the live K rows at once and scores it, the
// blocks exchange maxima and e_j through distributed shared memory, and
// each computes a slice of the output columns from its V columns, so K
// and V are read once with every byte of a block's slice in flight
// together (the heads kernel walked the ring a 32-position tile at a
// time, two round trips a tile). S3 stages each row (one bulk copy a row)
// and gamma in shared memory, so x is read once; a warp a row with 8
// loads a lane in flight (the first S3 kernel) takes rows too long to
// stage.
// Never build this file with --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The canonical sum of a warp's 32 lane partials; every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float part(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// S1: stable_dense
// ---------------------------------------------------------------------------

// One warp's tile: TM rows from m0, TO output channels from o0, over all of
// U. Rows past M and channels past O read row M - 1 / O - 1 (valid memory)
// and are never stored. UNR float4 groups a lane are loaded before any of
// their FMAs, to keep bytes in flight.
template <int TM, int TO, int UNR>
__device__ __forceinline__ void dense_tile(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int M, int O, int U, int m0,
                                           int o0, bool vec, int lane) {
  float acc[TM][TO];
  const float* xr[TM];
  const float* wr[TO];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    xr[i] = x + static_cast<size_t>(min(m0 + i, M - 1)) * U;
#pragma unroll
    for (int o = 0; o < TO; ++o) acc[i][o] = 0.0f;
  }
#pragma unroll
  for (int o = 0; o < TO; ++o) wr[o] = w + static_cast<size_t>(min(o0 + o, O - 1)) * U;

  if (vec) {
    const int n4 = U >> 2;  // float4 groups a row; group c covers u = 4c..4c+3
    int c = lane;
    for (; c + 32 * (UNR - 1) < n4; c += 32 * UNR) {
      float4 xv[UNR][TM], wv[UNR][TO];
#pragma unroll
      for (int r = 0; r < UNR; ++r) {
#pragma unroll
        for (int i = 0; i < TM; ++i) xv[r][i] = ldg4(xr[i] + 4 * (c + 32 * r));
#pragma unroll
        for (int o = 0; o < TO; ++o) wv[r][o] = ldg4(wr[o] + 4 * (c + 32 * r));
      }
#pragma unroll
      for (int r = 0; r < UNR; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int o = 0; o < TO; ++o)
              acc[i][o] = __fmaf_rn(part(xv[r][i], j), part(wv[r][o], j), acc[i][o]);
    }
    for (; c < n4; c += 32) {
      float4 xv[TM], wv[TO];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = ldg4(xr[i] + 4 * c);
#pragma unroll
      for (int o = 0; o < TO; ++o) wv[o] = ldg4(wr[o] + 4 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int o = 0; o < TO; ++o)
            acc[i][o] = __fmaf_rn(part(xv[i], j), part(wv[o], j), acc[i][o]);
    }
  } else {
    for (int base = 4 * lane; base < U; base += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = base + j;
        if (u < U) {
          float xs[TM], ws[TO];
#pragma unroll
          for (int i = 0; i < TM; ++i) xs[i] = __ldg(xr[i] + u);
#pragma unroll
          for (int o = 0; o < TO; ++o) ws[o] = __ldg(wr[o] + u);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int o = 0; o < TO; ++o) acc[i][o] = __fmaf_rn(xs[i], ws[o], acc[i][o]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int o = 0; o < TO; ++o) {
      float s = warp_sum(acc[i][o]);
      const int m = m0 + i, oc = o0 + o;
      if (lane == ((i * TO + o) & 31) && m < M && oc < O) {
        if (bias != nullptr) s = __fadd_rn(s, __ldg(bias + oc));
        out[static_cast<size_t>(m) * O + oc] = s;
      }
    }
}

// A block is WM x WO warps; blockIdx.x walks the row tiles (fastest, so the
// blocks that read the same weight rows run together), blockIdx.y the
// output-channel tiles.
template <int TM, int TO, int WM, int WO, int UNR>
__global__ void __launch_bounds__(WM* WO * 32)
    stable_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ out, int M, int O,
                        int U, int vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (blockIdx.x * WM + warp / WO) * TM;
  const int o0 = (blockIdx.y * WO + warp % WO) * TO;
  if (m0 >= M || o0 >= O) return;  // a whole warp; the kernel has no barrier
  dense_tile<TM, TO, UNR>(x, w, bias, out, M, O, U, m0, o0, vec != 0, lane);
}

template <int TM, int TO, int WM, int WO, int UNR>
cudaError_t launch_dense(const void* x, const void* w, const void* bias, void* out, int M, int O,
                         int U, int vec, cudaStream_t stream) {
  const dim3 grid((M + WM * TM - 1) / (WM * TM), (O + WO * TO - 1) / (WO * TO));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  stable_dense_kernel<TM, TO, WM, WO, UNR><<<grid, WM * WO * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), M, O, U, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// S1 at prefill rows: the same chains, fed from a shared-memory ring
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;
constexpr int kChunk = 128;  // positions a chunk: one lane-class period (32 lanes x 4)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most one of this thread's copy groups is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's expected count is not raised)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more of the bulk copies' before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completion counted on `bar` in bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until every one of this thread's copy groups has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of `p` in the shared memory of block `rank` of this cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float ld_cluster_f32(const float* p, unsigned rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(cluster_addr(p, rank)) : "memory");
  return v;
}

// four floats from 16-byte aligned `p` in block `rank`'s shared memory
__device__ __forceinline__ float4 ld_cluster_f32x4(const float* p, unsigned rank) {
  float x, y, z, w;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
               : "r"(cluster_addr(p, rank))
               : "memory");
  return make_float4(x, y, z, w);
}

// A block of WM x WO warps covers BM = WM * TM rows by BN = WO * TO output
// channels; each warp keeps dense_tile's TM x TO tile a lane, lane l owning
// the positions 128 i + 4 l + j, and chains each accumulator in increasing
// u, so every output has dense_tile's bits. The block's x and w rows arrive
// a chunk (128 positions, 512 bytes a row) at a time by cp.async (16-byte
// pieces when VEC, else 4-byte ones: VEC is a template argument, so the
// aligned kernel carries no path it does not run) into a ring of STAGES
// stages; each
// lane reads its float4 of a row from there (32 lanes, 512 contiguous
// bytes: no bank conflict). No barrier joins the block: a stage's `full`
// mbarrier completes once every thread's copies into it have landed, its
// `empty` one once every warp has read it, and a thread refills the stage
// of chunk c - LAG (with chunk c - LAG + STAGES) after it has read chunk c.
// So the warps drift up to LAG chunks apart, and one warp's shared-memory
// reads overlap another's FMAs (with a __syncthreads a chunk the reads and
// the FMAs ran one after the other). Rows past M and channels past O are
// not copied and their outputs not stored; positions past U are skipped.
template <int TM, int TO, int WM, int WO, int STAGES, int LAG, bool VEC>
__global__ void __launch_bounds__(WM* WO * 32, 1)
    stable_dense_ring_kernel(const float* __restrict__ x, const float* __restrict__ w,
                             const float* __restrict__ bias, float* __restrict__ out, int M,
                             int O, int U) {
  constexpr int BM = WM * TM, BN = WO * TO, kThreads = WM * WO * 32;
  constexpr int kStage = (BM + BN) * kChunk;  // floats a stage
  static_assert(((BM + BN) * 32) % kThreads == 0, "whole float4 copies a thread");
  static_assert(LAG >= 1 && LAG < STAGES, "a refill waits for an earlier chunk");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mb = blockIdx.x * BM, ob = blockIdx.y * BN;
  const int rw = (warp / WO) * TM, cw = (warp % WO) * TO;  // the warp's tile in the block
  const int chunks = (U + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], kThreads);  // every thread's copies
      mbar_init(&empty[i], WM * WO);  // every warp's reads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto fill = [&](int c) {  // this thread's share of chunk c, then its arrival
    float* dst = ring + (c % STAGES) * kStage;
    const int u0 = c * kChunk, len = min(kChunk, U - u0);
    if (VEC) {  // a warp copies one row's 512 bytes as 32 16-byte pieces
#pragma unroll
      for (int it = 0; it < (BM + BN) * 32 / kThreads; ++it) {
        const int idx = threadIdx.x + it * kThreads;
        const int r = idx >> 5, q = (idx & 31) * 4;
        const bool is_x = r < BM;
        const int row = is_x ? mb + r : ob + r - BM;
        if (q < len && row < (is_x ? M : O))
          cp_async16(dst + r * kChunk + q, (is_x ? x : w) + static_cast<size_t>(row) * U + u0 + q);
      }
    } else {
      for (int idx = threadIdx.x; idx < (BM + BN) * kChunk; idx += kThreads) {
        const int r = idx / kChunk, q = idx % kChunk;
        const bool is_x = r < BM;
        const int row = is_x ? mb + r : ob + r - BM;
        if (q < len && row < (is_x ? M : O))
          cp_async4(dst + r * kChunk + q, (is_x ? x : w) + static_cast<size_t>(row) * U + u0 + q);
      }
    }
    cp_async_arrive(&full[c % STAGES]);
  };

  for (int c = 0; c < STAGES - LAG && c < chunks; ++c) fill(c);
  float acc[TM][TO];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int o = 0; o < TO; ++o) acc[i][o] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int st = c % STAGES;
    mbar_wait(&full[st], (c / STAGES) & 1);
    const float4* xs = reinterpret_cast<const float4*>(ring + st * kStage + rw * kChunk);
    const float4* ws = reinterpret_cast<const float4*>(ring + st * kStage + (BM + cw) * kChunk);
    float4 xv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) xv[i] = xs[i * (kChunk / 4) + lane];
    const int live = U - (c * kChunk + 4 * lane);  // the lane's positions inside U
    if (live >= 4) {
#pragma unroll
      for (int o = 0; o < TO; ++o) {
        const float4 wv = ws[o * (kChunk / 4) + lane];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < TM; ++i)
            acc[i][o] = __fmaf_rn(part(xv[i], j), part(wv, j), acc[i][o]);
      }
    } else if (!VEC && live > 0) {  // U % 4 != 0: the row's last group
#pragma unroll
      for (int o = 0; o < TO; ++o) {
        const float4 wv = ws[o * (kChunk / 4) + lane];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (j < live)
#pragma unroll
            for (int i = 0; i < TM; ++i)
              acc[i][o] = __fmaf_rn(part(xv[i], j), part(wv, j), acc[i][o]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the warp has read chunk c
    const int r = c + STAGES - LAG;          // refills the stage of chunk c - LAG
    if (r < chunks) {
      if (c >= LAG) mbar_wait(&empty[(c - LAG) % STAGES], ((c - LAG) / STAGES) & 1);
      fill(r);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int o = 0; o < TO; ++o) {
      float s = warp_sum(acc[i][o]);
      const int m = mb + rw + i, oc = ob + cw + o;
      if (lane == ((i * TO + o) & 31) && m < M && oc < O) {
        if (bias != nullptr) s = __fadd_rn(s, __ldg(bias + oc));
        out[static_cast<size_t>(m) * O + oc] = s;
      }
    }
}

template <int TM, int TO, int WM, int WO, int STAGES, int LAG, bool VEC>
cudaError_t launch_dense_ring_as(const void* x, const void* w, const void* bias, void* out,
                                 int M, int O, int U, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * STAGES * (WM * TM + WO * TO) * kChunk;
  // raised once per instantiation and device, not again during a graph
  // capture that follows
  static bool raised[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !raised[device]) {
    err = cudaFuncSetAttribute(stable_dense_ring_kernel<TM, TO, WM, WO, STAGES, LAG, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) raised[device] = true;
  }
  const dim3 grid((M + WM * TM - 1) / (WM * TM), (O + WO * TO - 1) / (WO * TO));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  stable_dense_ring_kernel<TM, TO, WM, WO, STAGES, LAG, VEC>
      <<<grid, WM * WO * 32, smem, stream>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(w),
                                             static_cast<const float*>(bias),
                                             static_cast<float*>(out), M, O, U);
  return cudaGetLastError();
}

template <int TM, int TO, int WM, int WO, int STAGES, int LAG>
cudaError_t launch_dense_ring(const void* x, const void* w, const void* bias, void* out, int M,
                              int O, int U, int vec, cudaStream_t stream) {
  return vec ? launch_dense_ring_as<TM, TO, WM, WO, STAGES, LAG, true>(x, w, bias, out, M, O, U,
                                                                       stream)
             : launch_dense_ring_as<TM, TO, WM, WO, STAGES, LAG, false>(x, w, bias, out, M, O,
                                                                        U, stream);
}

// The instantiations, by the index the wrapper's dense_plan gives:
//   0..5 decode rows (one warp row, 8 warps of output channels):
//        (TM, TO) = (1, 1), (1, 2), (4, 1), (4, 2), (8, 1), (8, 2)
//   6    the first prefill tile (loads from global memory): an 8 x 8 tile
//        a lane, 2 x 4 warps; kept to hold the others to, no plan picks it
//   7    prefill rows: stable_dense_ring_kernel, an 8 x 8 tile a lane, 4 x 4
//        warps (32 x 32 a block), 6 stages, refills 3 chunks behind
constexpr int kDenseTiles = 8;

// ---------------------------------------------------------------------------
// S2: stable attention
// ---------------------------------------------------------------------------

constexpr int kTile = 32;      // positions a K/V tile
constexpr int kMaxWarps = 8;   // query heads a block (one warp each)
constexpr int kMaxD = 256;

// Dynamic shared memory of one block: two K tiles (rows padded to D + 1
// floats, so lane j's row starts on its own bank), two V tiles (a tile
// lands while the one before it is read), the warps' query rows and their
// S scores.
__host__ __device__ inline size_t attention_smem(int warps, int S, int D) {
  return sizeof(float) *
         (2 * static_cast<size_t>(kTile) * (D + 1) + 2 * static_cast<size_t>(kTile) * D +
          static_cast<size_t>(warps) * D + static_cast<size_t>(warps) * S);
}

// Copies of `rows` ring rows (contiguous, D floats each) into a K tile,
// rows padded to D + 1 floats: 4-byte copies.
__device__ __forceinline__ void copy_k_tile(float* tile, const float* src, int rows, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D;
    cp_async4(tile + r * (D + 1) + (idx - r * D), src + idx);
  }
}

// Copies of `rows` ring rows into a V tile (unpadded): 16-byte copies when
// the ring is 16-byte aligned and D % 4 == 0, else 4-byte ones.
__device__ __forceinline__ void copy_v_tile(float* tile, const float* src, int rows, int D,
                                        bool vec) {
  if (vec) {
    for (int i4 = threadIdx.x; i4 < (rows * D) >> 2; i4 += blockDim.x)
      cp_async16(tile + 4 * i4, src + 4 * i4);
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x)
      cp_async4(tile + idx, src + idx);
  }
}

// Grid (T, B * KV, ceil(G / warps)); warp w of a block is query head
// kvh * G + chunk * warps + w at time t of batch row b. Every warp of a
// block shares b and t, so all of them have the same live length n and
// run the same loop trip counts: the barriers are uniform. K and V tiles
// arrive by cp.async into two buffers each, the next tile's copies started
// before the current tile is read; the first V tile's copies start before
// the softmax pass.
template <int ND>
__global__ void __launch_bounds__(kMaxWarps * 32)
    stable_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ start_pos,
                            float* __restrict__ out, int H, int T, int KV, int S, int D, int G,
                            float scale, int vec) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int g = blockIdx.z * warps + warp;
  const bool live = g < G;
  const int h = kvh * G + min(g, G - 1);

  // buffer i of the K tiles at kt + i * kstride, of the V tiles at vt + i * vstride
  const int kstride = kTile * (D + 1), vstride = kTile * D;
  float* kt = smem;                                  // 2 x kTile x (D + 1)
  float* vt = kt + 2 * kstride;                      // 2 x kTile x D
  float* qs = vt + 2 * vstride;                      // warps x D
  float* ps = qs + warps * D;                                     // warps x S
  float* qw = qs + warp * D;
  float* pw = ps + static_cast<size_t>(warp) * S;

  const size_t qrow = ((static_cast<size_t>(b) * H + h) * T + t) * D;
  const float* kring = k + (static_cast<size_t>(b) * KV + kvh) * S * D;
  const float* vring = v + (static_cast<size_t>(b) * KV + kvh) * S * D;
  const int n = min(start_pos[b] + t + 1, S);

  if (n <= 0) {  // no live position: the JAX formula's max is -inf, its output NaN
    if (live)
      for (int d = lane; d < D; d += 32) out[qrow + d] = __int_as_float(0x7fffffff);
    return;
  }
  const int tiles = (n + kTile - 1) / kTile;
  copy_k_tile(kt, kring, min(kTile, n), D);
  cp_async_commit();
  for (int d = lane; d < D; d += 32) qw[d] = __ldg(q + qrow + d);

  // pass 1: the scores of the live positions, and their max
  float m_lane = -INFINITY;
  for (int c = 0; c < tiles; ++c) {
    if (c + 1 < tiles)
      copy_k_tile(kt + ((c + 1) & 1) * kstride,
                  kring + static_cast<size_t>(c + 1) * kTile * D, min(kTile, n - (c + 1) * kTile),
                  D);
    cp_async_commit();
    cp_async_wait_one();  // tile c has landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    const int rows = min(kTile, n - c * kTile);
    if (lane < rows) {
      const float* kr = kt + (c & 1) * kstride + lane * (D + 1);
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = __fmaf_rn(qw[d], kr[d], s);
      s = __fmul_rn(s, scale);
      pw[c * kTile + lane] = s;
      m_lane = fmaxf(m_lane, s);
    }
    __syncthreads();  // tile c is read before its buffer is refilled
  }
  copy_v_tile(vt, vring, min(kTile, n), D, vec != 0);
  cp_async_commit();
  const float m = warp_max(m_lane);

  // pass 2: e_j = exp(s_j - m) and their sum, lane l over j = l, l + 32, ...
  float l_lane = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(__fsub_rn(pw[j], m));
    pw[j] = e;
    l_lane = __fadd_rn(l_lane, e);
  }
  const float l = warp_sum(l_lane);
  for (int j = lane; j < n; j += 32) pw[j] = __fdiv_rn(pw[j], l);
  __syncwarp();

  // pass 3: out[d] = sum_j p_j v_j[d], one chain a d (lane owns d = lane + 32 i)
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.0f;
  for (int c = 0; c < tiles; ++c) {
    if (c + 1 < tiles)
      copy_v_tile(vt + ((c + 1) & 1) * vstride,
                  vring + static_cast<size_t>(c + 1) * kTile * D, min(kTile, n - (c + 1) * kTile),
                  D, vec != 0);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int rows = min(kTile, n - c * kTile);
    const float* vtile = vt + (c & 1) * vstride;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float p = pw[c * kTile + r];
      const float* vr = vtile + r * D;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = __fmaf_rn(p, vr[d], acc[i]);
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[qrow + d] = acc[i];
    }
  }
}

template <int ND>
cudaError_t launch_attention(const void* q, const void* k, const void* v, const void* sp,
                             void* out, int B, int H, int T, int KV, int S, int D, int warps,
                             float scale, int vec, cudaStream_t stream) {
  // raised once per instantiation and device, not again during a graph
  // capture that follows
  static size_t smem_allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const size_t smem = attention_smem(warps, S, D);
  if (device >= kMaxDevices || smem > smem_allowed[device]) {
    err = cudaFuncSetAttribute(stable_attention_kernel<ND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) smem_allowed[device] = smem;
  }
  const int G = H / KV;
  const dim3 grid(T, B * KV, (G + warps - 1) / warps);
  stable_attention_kernel<ND><<<grid, warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(sp), static_cast<float*>(out), H, T, KV, S, D, G, scale, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// S2 at T > 1: several query rows a block
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 8;                     // warps of a rows block
constexpr int kRowsMax = 32;                     // query rows a block
constexpr int kRowsPerWarp = kRowsMax / kRowWarps;

__host__ __device__ inline int ceil4(int v) { return (v + 3) & ~3; }

// Dynamic shared memory of one rows block of `rows` query rows: two K tiles
// (rows of ceil4(D) + 4 floats, so a lane's float4 of its own position
// meets no other lane's bank), two V tiles and the query rows (ceil4(D)
// floats a row), and the rows' scores (ceil4(S) a row).
__host__ __device__ inline size_t attention_rows_smem(int rows, int S, int D) {
  const size_t dk = ceil4(D) + 4, dv = ceil4(D);
  return sizeof(float) * (2 * kTile * dk + 2 * kTile * dv + static_cast<size_t>(rows) * dv +
                          static_cast<size_t>(rows) * ceil4(S));
}

// Copies of `n` ring rows (D floats each, contiguous) into a tile of rows
// `stride` floats apart: 16-byte copies when vec, else 4-byte ones.
__device__ __forceinline__ void copy_rows(float* tile, const float* src, int n, int D, int stride,
                                          bool vec) {
  if (vec) {
    const int d4 = D >> 2;
    for (int idx = threadIdx.x; idx < n * d4; idx += blockDim.x) {
      const int r = idx / d4, c = idx - r * d4;
      cp_async16(tile + r * stride + 4 * c, src + static_cast<size_t>(r) * D + 4 * c);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
      const int r = idx / D;
      cp_async4(tile + r * stride + (idx - r * D), src + idx);
    }
  }
}

// Grid (ceil(T / tq), B * KV, ceil(G / gb)); a block carries the rows r =
// ti * gb + gi (ti < tq, gi < gb): query head kvh * G + blockIdx.z * gb + gi
// at time t0 + ti of batch row b, each with its own live length n_r =
// min(start_pos[b] + t + 1, S). A K or V tile (32 positions) staged once
// serves all of them. Each row's arithmetic is stable_attention_kernel's:
//  pass 1: lane j of every warp owns position j of the tile and chains each
//          of its warp's rows' scores over d = 0..D-1 (q broadcast from
//          shared memory), then times scale;
//  pass 2: a warp a row: the exact max, lane l's sum of e_j over j = l,
//          l + 32, ... < n_r, the butterfly, p_j = e_j / sum;
//  pass 3: lane l owns d = 4 l .. 4 l + 3 (+ 128 h); each v[j, d] read once
//          serves the warp's rows, each chaining j = 0..n_r-1 in order.
// Positions at or past a row's n_r never enter its arithmetic (the block's
// tiles run to the largest n_r); the barriers are uniform. The row blocks
// with the longest rows start first.
template <int ND4>
__global__ void __launch_bounds__(kRowWarps * 32)
    stable_attention_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const int* __restrict__ start_pos,
                                 float* __restrict__ out, int H, int T, int KV, int S, int D,
                                 int G, int tq, int gb, float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * tq;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int g0 = blockIdx.z * gb;
  const int rows = tq * gb;
  const int dk = ceil4(D) + 4, dv = ceil4(D), sp4 = ceil4(S);
  const int kstride = kTile * dk, vstride = kTile * dv;
  float* kt = smem;                  // 2 x kTile x dk
  float* vt = kt + 2 * kstride;      // 2 x kTile x dv
  float* qs = vt + 2 * vstride;      // rows x dv
  float* ps = qs + rows * dv;        // rows x sp4
  const int spb = start_pos[b];
  const float* kring = k + (static_cast<size_t>(b) * KV + kvh) * S * D;
  const float* vring = v + (static_cast<size_t>(b) * KV + kvh) * S * D;

  // the warp's rows r = warp + kRowWarps * i: their live lengths (-1: not a
  // row of this call; 0: no live position, the output NaN as in the JAX
  // formula), output offsets, and the shared-memory row they read (row 0
  // for r past the block: computed, never stored)
  int nr[kRowsPerWarp], ro[kRowsPerWarp];
  size_t orow[kRowsPerWarp];
  const int n_max = min(spb + min(t0 + tq, T), S);  // the block's longest row
  int n_min = n_max;  // the warp's shortest real row (n_max if none)
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kRowWarps * i;
    const int t = t0 + r / gb, g = g0 + r % gb;
    const bool real = r < rows && t < T && g < G;
    nr[i] = real ? max(min(spb + t + 1, S), 0) : -1;
    orow[i] = real ? ((static_cast<size_t>(b) * H + kvh * G + g) * T + t) * D : 0;
    ro[i] = r < rows ? r : 0;
    if (nr[i] > 0) n_min = min(n_min, nr[i]);
  }
  const int tiles = n_max > 0 ? (n_max + kTile - 1) / kTile : 0;

  if (tiles > 0) copy_rows(kt, kring, min(kTile, n_max), D, dk, vec != 0);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    const int t = min(t0 + r / gb, T - 1), g = min(g0 + r % gb, G - 1);
    qs[r * dv + d] = __ldg(q + ((static_cast<size_t>(b) * H + kvh * G + g) * T + t) * D + d);
  }

  // pass 1: the scores of positions below n_max
  for (int c = 0; c < tiles; ++c) {
    if (c + 1 < tiles)
      copy_rows(kt + ((c + 1) & 1) * kstride, kring + static_cast<size_t>(c + 1) * kTile * D,
                min(kTile, n_max - (c + 1) * kTile), D, dk, vec != 0);
    cp_async_commit();
    cp_async_wait_one();  // tile c has landed (this thread's copies)
    __syncthreads();      // ... and every thread's (and the query rows)
    const int j = c * kTile + lane;
    const float* kr = kt + (c & 1) * kstride + lane * dk;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.0f;
    if ((D & 3) == 0) {
      for (int d = 0; d < D; d += 4) {
        const float4 kv4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 q4 = *reinterpret_cast<const float4*>(qs + ro[i] * dv + d);
          s[i] = __fmaf_rn(q4.x, kv4.x, s[i]);
          s[i] = __fmaf_rn(q4.y, kv4.y, s[i]);
          s[i] = __fmaf_rn(q4.z, kv4.z, s[i]);
          s[i] = __fmaf_rn(q4.w, kv4.w, s[i]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) s[i] = __fmaf_rn(qs[ro[i] * dv + d], kd, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      if (j < nr[i]) ps[ro[i] * sp4 + j] = __fmul_rn(s[i], scale);
    __syncthreads();  // tile c is read before its buffer is refilled
  }
  if (tiles > 0) copy_rows(vt, vring, min(kTile, n_max), D, dv, vec != 0);
  cp_async_commit();

  // pass 2: p_j = e_j / sum_j e_j, e_j = exp(s_j - max), a warp a row (its
  // own rows: the scores it wrote)
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int n = nr[i];
    if (n <= 0) continue;  // warp-uniform
    float* pr = ps + ro[i] * sp4;
    float m_lane = -INFINITY;
    for (int j = lane; j < n; j += 32) m_lane = fmaxf(m_lane, pr[j]);
    const float m = warp_max(m_lane);
    float l_lane = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(__fsub_rn(pr[j], m));
      pr[j] = e;
      l_lane = __fadd_rn(l_lane, e);
    }
    const float l = warp_sum(l_lane);
    for (int j = lane; j < n; j += 32) pr[j] = __fdiv_rn(pr[j], l);
  }
  __syncwarp();

  // pass 3: out[d] = sum_j p_j v_j[d], one chain a (row, d)
  float4 acc[kRowsPerWarp][ND4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int h = 0; h < ND4; ++h) acc[i][h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < tiles; ++c) {
    if (c + 1 < tiles)
      copy_rows(vt + ((c + 1) & 1) * vstride, vring + static_cast<size_t>(c + 1) * kTile * D,
                min(kTile, n_max - (c + 1) * kTile), D, dv, vec != 0);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int j0 = c * kTile, rows_c = min(kTile, n_max - j0);
    const float* vtile = vt + (c & 1) * vstride;
    for (int jj = 0; jj < rows_c; jj += 4) {
      float4 vv[4][ND4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int h = 0; h < ND4; ++h) {
          const int d = 4 * lane + 128 * h;
          vv[e][h] = d < dv ? *reinterpret_cast<const float4*>(vtile + (jj + e) * dv + d)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      if (j0 + jj + 4 <= n_min) {  // all four positions live for every real row
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 p4 = *reinterpret_cast<const float4*>(ps + ro[i] * sp4 + j0 + jj);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int h = 0; h < ND4; ++h) {
              const float p = part(p4, e);
              acc[i][h].x = __fmaf_rn(p, vv[e][h].x, acc[i][h].x);
              acc[i][h].y = __fmaf_rn(p, vv[e][h].y, acc[i][h].y);
              acc[i][h].z = __fmaf_rn(p, vv[e][h].z, acc[i][h].z);
              acc[i][h].w = __fmaf_rn(p, vv[e][h].w, acc[i][h].w);
            }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int live = nr[i] - (j0 + jj);  // this row's positions among the four
          const float4 p4 = *reinterpret_cast<const float4*>(ps + ro[i] * sp4 + j0 + jj);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int h = 0; h < ND4; ++h) {
              const float p = part(p4, e);
              if (e < live) {
                acc[i][h].x = __fmaf_rn(p, vv[e][h].x, acc[i][h].x);
                acc[i][h].y = __fmaf_rn(p, vv[e][h].y, acc[i][h].y);
                acc[i][h].z = __fmaf_rn(p, vv[e][h].z, acc[i][h].z);
                acc[i][h].w = __fmaf_rn(p, vv[e][h].w, acc[i][h].w);
              }
            }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (nr[i] < 0) continue;
#pragma unroll
    for (int h = 0; h < ND4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * lane + 128 * h + e;
        if (d < D)
          out[orow[i] + d] = nr[i] == 0 ? __int_as_float(0x7fffffff) : part(acc[i][h], e);
      }
  }
}

template <int ND4>
cudaError_t launch_attention_rows(const void* q, const void* k, const void* v, const void* sp,
                                  void* out, int B, int H, int T, int KV, int S, int D, int tq,
                                  int gb, float scale, int vec, cudaStream_t stream) {
  static size_t smem_allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const size_t smem = attention_rows_smem(tq * gb, S, D);
  if (device >= kMaxDevices || smem > smem_allowed[device]) {
    err = cudaFuncSetAttribute(stable_attention_rows_kernel<ND4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) smem_allowed[device] = smem;
  }
  const int G = H / KV;
  const dim3 grid((T + tq - 1) / tq, B * KV, (G + gb - 1) / gb);
  stable_attention_rows_kernel<ND4><<<grid, kRowWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(sp), static_cast<float*>(out), H, T, KV, S, D, G, tq, gb, scale,
      vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// S2 at T = 1: a cluster of blocks a (batch row, KV head, query time)
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 8;       // warps of a decode block
constexpr int kDecClusterMax = 8;  // blocks a cluster (the portable size)
constexpr int kDecHeads = 8;       // query heads a cluster carries, at most
constexpr int kDecChunk = 64;      // K rows region A holds (a chunk of a block's slice)
constexpr int kDecOuts = kDecHeads * kMaxD / (kDecWarps * 32);  // pass 3 outputs a thread

// Block `rank` of a cluster of C takes positions [rank s, rank s + s) of
// the n live ones and output columns [rank c, rank c + c) of D, each cut
// at n or D, with s = dec_pos_span(n, C), c = dec_col_span(D, C):
// multiples of 4, so every slice starts 16-byte aligned.
__host__ __device__ inline int dec_pos_span(int n, int C) { return ceil4((n + C - 1) / C); }
__host__ __device__ inline int dec_col_span(int D, int C) { return ceil4((D + C - 1) / C); }

// K rows region A holds: a chunk of up to kDecChunk rows of the block's
// slice (pitch ceil4(D) + 4 floats); in pass 3 it holds the V columns of
// dec_v_chunk(S, D, C) positions at a time (pitch dec_col_span, a multiple
// of 4 positions). Both are shapes only, so two or three blocks fit an SM.
__host__ __device__ inline int dec_k_chunk(int S, int C) {
  const int span = dec_pos_span(S, C);
  return span < kDecChunk ? span : kDecChunk;
}
__host__ __device__ inline size_t dec_region(int S, int D, int C) {
  return static_cast<size_t>(dec_k_chunk(S, C)) * (ceil4(D) + 4);
}
__host__ __device__ inline int dec_v_chunk(int S, int D, int C) {
  return static_cast<int>(dec_region(S, D, C) / dec_col_span(D, C)) & ~3;
}

// Dynamic shared memory of one decode block carrying gb query heads:
// region A, the heads' scores / e_j at every position (pitch ceil4(S) +
// 4), their query rows (ceil4(D)) and their p_j (pitch ceil4(S) + 4).
__host__ __device__ inline size_t attention_decode_smem(int S, int D, int C, int gb) {
  return sizeof(float) * (dec_region(S, D, C) + 2 * static_cast<size_t>(gb) * (ceil4(S) + 4) +
                          static_cast<size_t>(gb) * ceil4(D));
}

// Grid (C, B * KV, T * ceil(G / gb)), clusters of C blocks along x: the
// cluster carries query heads g0 .. g0 + gb - 1 of KV head kvh at time t of
// batch row b (gb <= kDecHeads), whose live length n = min(start_pos[b] + t + 1,
// S) every block reads. Each row's arithmetic is stable_attention_kernel's:
//  pass 1: block `rank` stages its slice of the live K rows by cp.async
//          (up to kDecChunk rows at a time, all in flight at once; one
//          chunk at the middle of a generate) and chains each score of its positions
//          over d = 0..D-1 (a warp 32 positions of one head, lane =
//          position, q broadcast), then times
//          scale; the block's max a head goes to the cluster, whose blocks
//          read each other's from shared memory (DSMEM): a max is exact in
//          any order;
//  softmax: e_j = exp(s_j - m) on the block's positions; behind a cluster
//          barrier every block gathers the others' e_j (DSMEM), so each
//          holds all n, and forms l in the canonical order (warp h: lane l
//          sums j = l, l + 32, ... in increasing j, then the butterfly):
//          every block holds the same bits; p_j = e_j / l;
//  pass 3: block `rank` takes its slice of the output columns; its V
//          columns of the live rows land in region A, dec_v_chunk positions
//          at a time (the first by cp.async issued once K's rows are read,
//          while the softmax runs), and each output element is one fma
//          chain over j = 0..n-1 in increasing j, carried across chunks.
// So K and V are read once, and every output has the heads kernel's bits.
// Positions past n are never read.
__global__ void __launch_bounds__(kDecWarps * 32, 2)
    stable_attention_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const int* __restrict__ start_pos,
                                   float* __restrict__ out, int H, int T, int KV, int S, int D,
                                   int G, int gb, float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* ka = reinterpret_cast<float*>(smem4);         // region A
  const int dk = ceil4(D) + 4, pp = ceil4(S) + 4, dq = ceil4(D);
  const int C = gridDim.x, rank = blockIdx.x;
  float* ps = ka + dec_region(S, D, C);                 // gb x pp: s_j, then e_j
  float* qs = ps + static_cast<size_t>(gb) * pp;        // gb x dq
  float* pd = qs + static_cast<size_t>(gb) * dq;        // gb x pp: p_j
  __shared__ float wmax[kDecWarps][kDecHeads];
  __shared__ float bmax[kDecHeads], mrow[kDecHeads];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int t = blockIdx.z % T, g0 = (blockIdx.z / T) * gb;
  const int nh = min(gb, G - g0);  // the cluster's heads
  const int cspan = dec_col_span(D, C);
  const int d0 = min(rank * cspan, D), nd = min(d0 + cspan, D) - d0;
  const size_t ostride = static_cast<size_t>(T) * D;  // from one head's row to the next's
  const size_t obase = ((static_cast<size_t>(b) * H + kvh * G + g0) * T + t) * D;
  const int n = min(start_pos[b] + t + 1, S);  // the same for every block of the cluster

  if (n <= 0) {  // no live position: the JAX formula's max is -inf, its output NaN
    for (int idx = threadIdx.x; idx < nh * nd; idx += blockDim.x) {
      const int i = idx / nd;
      out[obase + i * ostride + d0 + idx - i * nd] = __int_as_float(0x7fffffff);
    }
    return;
  }
  const int pspan = dec_pos_span(n, C);
  const int j0 = min(rank * pspan, n), L = min(j0 + pspan, n) - j0;
  const int kchunk = dec_k_chunk(S, C), vchunk = dec_v_chunk(S, D, C);
  const float* kring = k + (static_cast<size_t>(b) * KV + kvh) * S * D;
  const float* vring = v + (static_cast<size_t>(b) * KV + kvh) * S * D;
  // V's columns of positions [p0, p1) into region A (pitch cspan)
  auto copy_v = [&](int p0, int p1) {
    if (vec) {  // rows of the ring 16-byte aligned, d0 and nd multiples of 4
      const int c4 = nd >> 2;
      for (int idx = threadIdx.x; idx < (p1 - p0) * c4; idx += blockDim.x) {
        const int j = idx / c4, c = idx - j * c4;
        cp_async16(ka + j * cspan + 4 * c,
                   vring + static_cast<size_t>(p0 + j) * D + d0 + 4 * c);
      }
    } else {
      for (int idx = threadIdx.x; idx < (p1 - p0) * nd; idx += blockDim.x) {
        const int j = idx / nd, c = idx - j * nd;
        cp_async4(ka + j * cspan + c, vring + static_cast<size_t>(p0 + j) * D + d0 + c);
      }
    }
    cp_async_commit();
  };
  copy_rows(ka, kring + static_cast<size_t>(j0) * D, min(L, kchunk), D, dk, vec != 0);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < nh * D; idx += blockDim.x) {
    const int i = idx / D, d = idx - i * D;
    qs[i * dq + d] = __ldg(q + obase + i * ostride + d);
  }
  if (lane < kDecHeads) wmax[warp][lane] = -INFINITY;

  // pass 1: the scores of the block's positions, kchunk K rows at a time,
  // a task (32 positions of one head) a warp at a time; each warp keeps its
  // max a head
  for (int r0 = 0; r0 < L; r0 += kchunk) {
    const int rows = min(kchunk, L - r0);
    if (r0 > 0) {  // the chunk before is read: copy this one
      __syncthreads();
      copy_rows(ka, kring + static_cast<size_t>(j0 + r0) * D, rows, D, dk, vec != 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    const int pblocks = (rows + 31) >> 5;
    for (int task = warp; task < pblocks * nh; task += kDecWarps) {  // warp-uniform
      const int i = task / pblocks, jj = (task - i * pblocks) * 32 + lane;
      const float* kr = ka + min(jj, rows - 1) * dk;
      const float* qr = qs + i * dq;
      float s = 0.0f;
      if ((D & 3) == 0) {
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          const float4 q4 = *reinterpret_cast<const float4*>(qr + d);
          s = __fmaf_rn(q4.x, k4.x, s);
          s = __fmaf_rn(q4.y, k4.y, s);
          s = __fmaf_rn(q4.z, k4.z, s);
          s = __fmaf_rn(q4.w, k4.w, s);
        }
      } else {
        for (int d = 0; d < D; ++d) s = __fmaf_rn(qr[d], kr[d], s);
      }
      const float sc = __fmul_rn(s, scale);
      if (jj < rows) ps[i * pp + j0 + r0 + jj] = sc;
      const float m = warp_max(jj < rows ? sc : -INFINITY);
      if (lane == 0) wmax[warp][i] = fmaxf(wmax[warp][i], m);
    }
  }
  __syncthreads();  // every K row is read (region A takes V's columns); every warp's maxima
  copy_v(0, min(vchunk, n));  // V's first positions land while the softmax runs
  if (threadIdx.x < nh) {
    float m = wmax[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) m = fmaxf(m, wmax[w][threadIdx.x]);
    bmax[threadIdx.x] = m;
  }
  cluster_arrive_release();
  cluster_wait();  // every block's maxima
  if (warp < nh) {
    const float m = warp_max(lane < C ? ld_cluster_f32(&bmax[warp], lane) : -INFINITY);
    if (lane == 0) mrow[warp] = m;
  }
  __syncthreads();

  // e_j = exp(s_j - m) on the block's positions
  for (int idx = threadIdx.x; idx < nh * L; idx += blockDim.x) {
    const int i = idx / L;
    float* pj = ps + i * pp + j0 + idx - i * L;
    *pj = expf(__fsub_rn(*pj, mrow[i]));
  }
  cluster_arrive_release();
  cluster_wait();  // every block's e_j
  {  // the other blocks' e_j, 16 bytes a read, four reads in flight a thread
    const int nq = (n + 3) >> 2, items = nh * nq;
    for (int f0 = threadIdx.x; f0 < items; f0 += 4 * blockDim.x) {
      float4 got[4];
      int at[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = f0 + u * blockDim.x, i = f / nq, j = 4 * (f - i * nq);
        const int c = j / pspan;  // the block whose slice holds position j
        at[u] = f < items && c != rank ? i * pp + j : -1;
        if (at[u] >= 0) got[u] = ld_cluster_f32x4(ps + at[u], c);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (at[u] >= 0) *reinterpret_cast<float4*>(ps + at[u]) = got[u];
    }
  }
  __syncthreads();           // every position's e_j is here
  cluster_arrive_release();  // this block has read the others' e_j
  if (warp < nh) {           // warp h: head h's l in the canonical order, p_j = e_j / l
    const float* pr = ps + warp * pp;
    float l = 0.0f;
    for (int j = lane; j < n; j += 32) l = __fadd_rn(l, pr[j]);
    l = warp_sum(l);
    float* pw = pd + warp * pp;
    for (int j = lane; j < n; j += 32) pw[j] = __fdiv_rn(pr[j], l);
  }

  // pass 3: out[d] = sum_j p_j v_j[d], one chain an output element (a
  // thread's outputs o = threadIdx.x + u * blockDim.x), over vchunk
  // positions of V's columns at a time
  float acc[kDecOuts];
#pragma unroll
  for (int u = 0; u < kDecOuts; ++u) acc[u] = 0.0f;
  for (int p0 = 0; p0 < n; p0 += vchunk) {
    const int p1 = min(p0 + vchunk, n);
    if (p0 > 0) {  // the chunk before is read: copy this one
      __syncthreads();
      copy_v(p0, p1);
    }
    cp_async_wait_all();  // V's columns (this thread's copies)
    __syncthreads();      // ... and every thread's (and, first, the p_j)
#pragma unroll
    for (int u = 0; u < kDecOuts; ++u) {
      const int o = threadIdx.x + u * blockDim.x;
      if (o < nh * nd) {
        const int i = o / nd, dd = o - i * nd;
        const float* pr = pd + i * pp + p0;  // p_j of the chunk's positions
        const float* vc = ka + dd;              // position p0 + j at vc[j * cspan]
        float a = acc[u];
        int j = 0;
#pragma unroll 4
        for (; j + 4 <= p1 - p0; j += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
          const float v0 = vc[j * cspan], v1 = vc[(j + 1) * cspan];
          const float v2 = vc[(j + 2) * cspan], v3 = vc[(j + 3) * cspan];
          a = __fmaf_rn(p4.x, v0, a);
          a = __fmaf_rn(p4.y, v1, a);
          a = __fmaf_rn(p4.z, v2, a);
          a = __fmaf_rn(p4.w, v3, a);
        }
        for (; j < p1 - p0; ++j) a = __fmaf_rn(pr[j], vc[j * cspan], a);
        acc[u] = a;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kDecOuts; ++u) {
    const int o = threadIdx.x + u * blockDim.x;
    if (o < nh * nd) {
      const int i = o / nd;
      out[obase + i * ostride + d0 + o - i * nd] = acc[u];
    }
  }
  cluster_wait();  // no block leaves while another may read its e_j
}

cudaError_t launch_attention_decode(const void* q, const void* k, const void* v, const void* sp,
                                    void* out, int B, int H, int T, int KV, int S, int D, int C,
                                    int gb, float scale, int vec, cudaStream_t stream) {
  static size_t smem_allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const size_t smem = attention_decode_smem(S, D, C, gb);
  if (device >= kMaxDevices || smem > smem_allowed[device]) {
    err = cudaFuncSetAttribute(stable_attention_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    // the whole of L1 as shared memory, so two blocks fit an SM
    err = cudaFuncSetAttribute(stable_attention_decode_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) smem_allowed[device] = smem;
  }
  const int G = H / KV;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B * KV, T * ((G + gb - 1) / gb));
  cfg.blockDim = dim3(kDecWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, stable_attention_decode_kernel, static_cast<const float*>(q),
                           static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<const int*>(sp), static_cast<float*>(out), H, T, KV, S, D,
                           G, gb, scale, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// S3: stable row norm
// ---------------------------------------------------------------------------

constexpr int kNormWarps = 4;  // rows a block, one warp each

__global__ void __launch_bounds__(kNormWarps * 32)
    stable_rms_norm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                           float* __restrict__ out, int M, int N, float eps, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNormWarps + (threadIdx.x >> 5);
  if (row >= M) return;  // a whole warp; no barrier follows
  const float* xr = x + static_cast<size_t>(row) * N;
  float* yr = out + static_cast<size_t>(row) * N;
  float s = 0.0f;
  if (vec) {  // 8 float4 a lane in flight, then their squares in order
    const int n4 = N >> 2;
    int c = lane;
    for (; c + 32 * 7 < n4; c += 32 * 8) {
      float4 xv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) xv[r] = ldg4(xr + 4 * (c + 32 * r));
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s = __fadd_rn(s, __fmul_rn(part(xv[r], j), part(xv[r], j)));
    }
    for (; c < n4; c += 32) {
      const float4 xv = ldg4(xr + 4 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j) s = __fadd_rn(s, __fmul_rn(part(xv, j), part(xv, j)));
    }
  } else {
    for (int base = 4 * lane; base < N; base += 128)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (base + j < N) {
          const float xv = __ldg(xr + base + j);
          s = __fadd_rn(s, __fmul_rn(xv, xv));
        }
  }
  const float ms = __fdiv_rn(warp_sum(s), static_cast<float>(N));
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
  if (vec) {  // 4 float4 of x and of gamma a lane in flight
    const int n4 = N >> 2;
    for (int c0 = lane; c0 < n4; c0 += 32 * 4) {
      float4 xv[4], gv[4];
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const int c = c0 + 32 * r4;
        if (c < n4) {
          xv[r4] = ldg4(xr + 4 * c);
          gv[r4] = ldg4(gamma + 4 * c);
        }
      }
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const int c = c0 + 32 * r4;
        if (c < n4) {
          float4 y;
          y.x = __fmul_rn(__fmul_rn(xv[r4].x, r), gv[r4].x);
          y.y = __fmul_rn(__fmul_rn(xv[r4].y, r), gv[r4].y);
          y.z = __fmul_rn(__fmul_rn(xv[r4].z, r), gv[r4].z);
          y.w = __fmul_rn(__fmul_rn(xv[r4].w, r), gv[r4].w);
          reinterpret_cast<float4*>(yr)[c] = y;
        }
      }
    }
  } else {
    for (int u = lane; u < N; u += 32)
      yr[u] = __fmul_rn(__fmul_rn(__ldg(xr + u), r), __ldg(gamma + u));
  }
}

// S3 with its rows staged once in shared memory (the plan's kernel; the
// warp-a-row kernel above takes only rows too long to stage)
constexpr int kNormStagedWarps = 8;  // warps of a staged block
constexpr int kNormRowsMax = 8;      // rows a staged block: one summing warp each
// aligned rows arrive by one 1-D bulk copy a row (else by every thread's
// 16-byte cp.async)
constexpr bool kNormBulkCopy = true;

// Dynamic shared memory of a staged block of `rows` rows of N: gamma and
// the rows, ceil4(N) floats each.
__host__ __device__ inline size_t norm_staged_smem(int rows, int N) {
  return sizeof(float) * (static_cast<size_t>(rows) + 1) * ceil4(N);
}

// Grid ceil(M / rows). The block stages gamma and its rows of x (rows m0 =
// blockIdx.x * rows ..., M at most) with all their bytes in flight at once:
// `copy` 2 one bulk copy a row, each on its own mbarrier counted in bytes,
// 1 every thread's 16-byte cp.async (both: x and gamma 16-byte aligned and
// N % 4 == 0), 0 4-byte cp.async. Warps w, w + rows, ... take row w: the
// first forms the row's sum of squares from shared memory in the canonical
// order (lane l chains the float4 at index 32 i + l for i = 0, 1, ...,
// conflict-free, the partial group N / 4 last: it is lane (N / 4) % 32's;
// then the butterfly), so every row has stable_rms_norm_kernel's bits; the
// row's warps then write (x r) gamma from the staged row (float4 stores
// when vec). With bulk copies a row's warps start as soon as that row has
// landed, so one row's stores overlap the others' copies. x is read from
// global memory once.
__global__ void __launch_bounds__(kNormStagedWarps * 32)
    stable_rms_norm_staged_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                                  float* __restrict__ out, int M, int N, int rows, float eps,
                                  int copy, int vec) {
  extern __shared__ float4 smem4[];
  const int pitch = ceil4(N);
  float* gs = reinterpret_cast<float*>(smem4);  // gamma
  float* xs = gs + pitch;                       // rows x pitch
  __shared__ __align__(8) uint64_t full[kNormRowsMax + 1];  // gamma's, then each row's
  __shared__ float rs[kNormRowsMax];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * rows, nr = min(rows, M - m0);
  // staged row r: gamma (r = 0) or row m0 + r - 1 of x
  auto dst_row = [&](int r) { return r == 0 ? gs : xs + (r - 1) * pitch; };
  auto src_row = [&](int r) {
    return r == 0 ? gamma : x + static_cast<size_t>(m0 + r - 1) * N;
  };
  if (copy == 2) {
    if (threadIdx.x <= nr) mbar_init(&full[threadIdx.x], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x <= nr) {  // lane r of warp 0: staged row r on its own barrier
      const unsigned bytes = 4u * static_cast<unsigned>(N);
      mbar_expect_tx(&full[threadIdx.x], bytes);
      bulk_copy(dst_row(threadIdx.x), src_row(threadIdx.x), bytes, &full[threadIdx.x]);
    }
  } else {
    const int per = copy == 1 ? N >> 2 : N;  // copies a row
    for (int idx = threadIdx.x; idx < (nr + 1) * per; idx += blockDim.x) {
      const int r = idx / per, c = idx - r * per;
      if (copy == 1)
        cp_async16(dst_row(r) + 4 * c, src_row(r) + 4 * c);
      else
        cp_async4(dst_row(r) + c, src_row(r) + c);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }

  const int r = warp % rows;  // this warp's row
  if (r >= nr) return;        // a whole warp; only named barriers of live rows follow
  const int wi = warp / rows, wn = (kNormStagedWarps - 1 - r) / rows + 1;  // of wn warps
  const int n4 = N >> 2;
  const float* xr = xs + r * pitch;
  if (copy == 2) mbar_wait(&full[r + 1], 0);
  if (wi == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float s = 0.0f;
#pragma unroll 8
    for (int c = lane; c < n4; c += 32) {
      const float4 xv = x4[c];
      s = __fadd_rn(s, __fmul_rn(xv.x, xv.x));
      s = __fadd_rn(s, __fmul_rn(xv.y, xv.y));
      s = __fadd_rn(s, __fmul_rn(xv.z, xv.z));
      s = __fadd_rn(s, __fmul_rn(xv.w, xv.w));
    }
    if ((N & 3) && lane == (n4 & 31))
      for (int u = 4 * n4; u < N; ++u) s = __fadd_rn(s, __fmul_rn(xr[u], xr[u]));
    const float ms = __fdiv_rn(warp_sum(s), static_cast<float>(N));
    if (lane == 0) rs[r] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
  }
  if (wn > 1)  // the row's warps wait for its r (named barrier 1 + r)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + r), "r"(32 * wn) : "memory");
  else
    __syncwarp();
  if (copy == 2) mbar_wait(&full[0], 0);  // gamma
  const float rr = rs[r];
  float* yr = out + static_cast<size_t>(m0 + r) * N;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* g4 = reinterpret_cast<const float4*>(gs);
    for (int c = lane + 32 * wi; c < n4; c += 32 * wn) {
      const float4 xv = x4[c], gv = g4[c];
      float4 y;
      y.x = __fmul_rn(__fmul_rn(xv.x, rr), gv.x);
      y.y = __fmul_rn(__fmul_rn(xv.y, rr), gv.y);
      y.z = __fmul_rn(__fmul_rn(xv.z, rr), gv.z);
      y.w = __fmul_rn(__fmul_rn(xv.w, rr), gv.w);
      reinterpret_cast<float4*>(yr)[c] = y;
    }
  } else {
    for (int u = lane + 32 * wi; u < N; u += 32 * wn)
      yr[u] = __fmul_rn(__fmul_rn(xr[u], rr), gs[u]);
  }
}

cudaError_t launch_norm_staged(const void* x, const void* gamma, void* out, int M, int N, int rows,
                               float eps, int vec, cudaStream_t stream) {
  static size_t smem_allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const size_t smem = norm_staged_smem(rows, N);
  if (device >= kMaxDevices || smem > smem_allowed[device]) {
    err = cudaFuncSetAttribute(stable_rms_norm_staged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(stable_rms_norm_staged_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) smem_allowed[device] = smem;
  }
  const int copy = vec ? (kNormBulkCopy ? 2 : 1) : 0;
  stable_rms_norm_staged_kernel<<<(M + rows - 1) / rows, kNormStagedWarps * 32, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma), static_cast<float*>(out), M,
      N, rows, eps, copy, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, U), w (O, U), bias (O,) or null, out (M, O): f32, contiguous.
// vec = 1 needs U % 4 == 0 and x and w 16-byte aligned. tile names the
// instantiation (0..kDenseTiles-1, see above). Launches on `stream`
// without synchronising; returns cudaGetLastError().
int mxtt_stable_dense(const void* x, const void* w, const void* bias, void* out, int M, int O,
                      int U, int vec, int tile, void* stream) {
  if (M < 1 || O < 1 || U < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 0: err = launch_dense<1, 1, 1, 8, 4>(x, w, bias, out, M, O, U, vec, st); break;
    case 1: err = launch_dense<1, 2, 1, 8, 4>(x, w, bias, out, M, O, U, vec, st); break;
    case 2: err = launch_dense<4, 1, 1, 8, 4>(x, w, bias, out, M, O, U, vec, st); break;
    case 3: err = launch_dense<4, 2, 1, 8, 4>(x, w, bias, out, M, O, U, vec, st); break;
    case 4: err = launch_dense<8, 1, 1, 8, 2>(x, w, bias, out, M, O, U, vec, st); break;
    case 5: err = launch_dense<8, 2, 1, 8, 2>(x, w, bias, out, M, O, U, vec, st); break;
    case 6: err = launch_dense<8, 8, 2, 4, 1>(x, w, bias, out, M, O, U, vec, st); break;
    case 7: err = launch_dense_ring<8, 8, 4, 4, 6, 3>(x, w, bias, out, M, O, U, vec, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Rows, output channels and threads a block of instantiation `tile` covers
// (rows, cols, threads), for the wrapper's plan check.
int mxtt_stable_dense_tile(int tile, int* rows, int* cols, int* threads) {
  static const int kRows[kDenseTiles] = {1, 1, 4, 4, 8, 8, 16, 32};
  static const int kCols[kDenseTiles] = {8, 16, 8, 16, 8, 16, 32, 32};
  static const int kThreads[kDenseTiles] = {256, 256, 256, 256, 256, 256, 256, 512};
  if (tile < 0 || tile >= kDenseTiles) return static_cast<int>(cudaErrorInvalidValue);
  *rows = kRows[tile];
  *cols = kCols[tile];
  *threads = kThreads[tile];
  return 0;
}

// q (B, H, T, D), k and v (B, KV, S, D), out (B, H, T, D): f32, contiguous;
// start_pos (B,) int32 on the device. H % KV == 0, D <= 256; `warps` query
// heads a block (1..8), whose shared memory attention_smem must fit. vec = 1
// needs v 16-byte aligned and D % 4 == 0 (V tiles by 16-byte copies).
int mxtt_stable_attention(const void* q, const void* k, const void* v, const void* start_pos,
                          void* out, int B, int H, int T, int KV, int S, int D, int warps,
                          float scale, int vec, void* stream) {
  if (B < 1 || H < 1 || T < 1 || KV < 1 || S < 1 || D < 1 || D > kMaxD || H % KV ||
      warps < 1 || warps > kMaxWarps || B * KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nd = (D + 31) / 32;
  cudaError_t err;
  if (nd <= 1)
    err = launch_attention<1>(q, k, v, start_pos, out, B, H, T, KV, S, D, warps, scale, vec, st);
  else if (nd <= 2)
    err = launch_attention<2>(q, k, v, start_pos, out, B, H, T, KV, S, D, warps, scale, vec, st);
  else if (nd <= 4)
    err = launch_attention<4>(q, k, v, start_pos, out, B, H, T, KV, S, D, warps, scale, vec, st);
  else
    err = launch_attention<8>(q, k, v, start_pos, out, B, H, T, KV, S, D, warps, scale, vec, st);
  return static_cast<int>(err);
}

// Dynamic shared memory of one attention block, in bytes.
long long mxtt_stable_attention_smem_bytes(int warps, int S, int D) {
  return static_cast<long long>(attention_smem(warps, S, D));
}

// S2 with several query rows a block (for T > 1): the arguments of
// mxtt_stable_attention, with `tq` query times and `gb` query heads of one
// KV head a block (tq * gb <= 32, gb <= H / KV) in place of `warps`;
// attention_rows_smem must fit. vec = 1 needs k and v 16-byte aligned and
// D % 4 == 0 (K and V tiles by 16-byte copies).
int mxtt_stable_attention_rows(const void* q, const void* k, const void* v,
                               const void* start_pos, void* out, int B, int H, int T, int KV,
                               int S, int D, int tq, int gb, float scale, int vec, void* stream) {
  if (B < 1 || H < 1 || T < 1 || KV < 1 || S < 1 || D < 1 || D > kMaxD || H % KV || tq < 1 ||
      gb < 1 || gb > H / KV || tq * gb > kRowsMax || B * KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 128)
    err = launch_attention_rows<1>(q, k, v, start_pos, out, B, H, T, KV, S, D, tq, gb, scale, vec,
                                   st);
  else
    err = launch_attention_rows<2>(q, k, v, start_pos, out, B, H, T, KV, S, D, tq, gb, scale, vec,
                                   st);
  return static_cast<int>(err);
}

// Dynamic shared memory of one rows block of `rows` query rows, in bytes.
long long mxtt_stable_attention_rows_smem_bytes(int rows, int S, int D) {
  return static_cast<long long>(attention_rows_smem(rows, S, D));
}

// S2 on clusters of `cluster` blocks (1..kDecClusterMax) each carrying
// `gb` query heads of one KV head (gb <= min(H / KV, kDecHeads)) at one query time:
// the arguments of mxtt_stable_attention otherwise; attention_decode_smem
// must fit. vec = 1 needs k and v 16-byte aligned and D % 4 == 0 (16-byte
// copies).
int mxtt_stable_attention_decode(const void* q, const void* k, const void* v,
                                 const void* start_pos, void* out, int B, int H, int T, int KV,
                                 int S, int D, int cluster, int gb, float scale, int vec,
                                 void* stream) {
  if (B < 1 || H < 1 || T < 1 || KV < 1 || S < 1 || D < 1 || D > kMaxD || H % KV ||
      cluster < 1 || cluster > kDecClusterMax || gb < 1 || gb > kDecHeads || gb > H / KV ||
      B * KV > 65535 || T * ((H / KV + gb - 1) / gb) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_attention_decode(q, k, v, start_pos, out, B, H, T, KV, S, D,
                                                  cluster, gb, scale, vec, st));
}

// Dynamic shared memory of one decode block, in bytes.
long long mxtt_stable_attention_decode_smem_bytes(int S, int D, int cluster, int gb) {
  return static_cast<long long>(attention_decode_smem(S, D, cluster, gb));
}

// x (M, N), gamma (N,), out (M, N): f32, contiguous. vec = 1 needs N % 4 ==
// 0 and x, gamma and out 16-byte aligned.
int mxtt_stable_rms_norm(const void* x, const void* gamma, void* out, int M, int N, float eps,
                         int vec, void* stream) {
  if (M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kNormWarps - 1) / kNormWarps);
  stable_rms_norm_kernel<<<grid, kNormWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma), static_cast<float*>(out), M,
      N, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

// S3 on the staged kernel, `rows` rows a block (1..kNormRowsMax); the
// arguments of mxtt_stable_rms_norm otherwise. norm_staged_smem must fit.
int mxtt_stable_rms_norm_staged(const void* x, const void* gamma, void* out, int M, int N,
                                int rows, float eps, int vec, void* stream) {
  if (M < 1 || N < 1 || rows < 1 || rows > kNormRowsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_norm_staged(x, gamma, out, M, N, rows, eps, vec,
                                             static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of a staged norm block of `rows` rows of N, in bytes.
long long mxtt_stable_rms_norm_staged_smem_bytes(int rows, int N) {
  return static_cast<long long>(norm_staged_smem(rows, N));
}

// Registers, local (spilled) bytes a thread and the block limit of kernel
// `which`: 0..kDenseTiles-1 the stable_dense instantiations (7 its aligned
// kernel), then the attention kernels at ND = 1, 2, 4, 8, the rows kernels
// at ND4 = 1, 2, instantiation 7's unaligned kernel, the row norm, the
// decode attention kernel and the staged row norm.
int mxtt_stable_kernel_attributes(int which, int* regs, int* local_bytes, int* max_threads) {
  const void* fns[] = {
      reinterpret_cast<const void*>(stable_dense_kernel<1, 1, 1, 8, 4>),
      reinterpret_cast<const void*>(stable_dense_kernel<1, 2, 1, 8, 4>),
      reinterpret_cast<const void*>(stable_dense_kernel<4, 1, 1, 8, 4>),
      reinterpret_cast<const void*>(stable_dense_kernel<4, 2, 1, 8, 4>),
      reinterpret_cast<const void*>(stable_dense_kernel<8, 1, 1, 8, 2>),
      reinterpret_cast<const void*>(stable_dense_kernel<8, 2, 1, 8, 2>),
      reinterpret_cast<const void*>(stable_dense_kernel<8, 8, 2, 4, 1>),
      reinterpret_cast<const void*>(stable_dense_ring_kernel<8, 8, 4, 4, 6, 3, true>),
      reinterpret_cast<const void*>(stable_attention_kernel<1>),
      reinterpret_cast<const void*>(stable_attention_kernel<2>),
      reinterpret_cast<const void*>(stable_attention_kernel<4>),
      reinterpret_cast<const void*>(stable_attention_kernel<8>),
      reinterpret_cast<const void*>(stable_attention_rows_kernel<1>),
      reinterpret_cast<const void*>(stable_attention_rows_kernel<2>),
      reinterpret_cast<const void*>(stable_dense_ring_kernel<8, 8, 4, 4, 6, 3, false>),
      reinterpret_cast<const void*>(stable_rms_norm_kernel),
      reinterpret_cast<const void*>(stable_attention_decode_kernel),
      reinterpret_cast<const void*>(stable_rms_norm_staged_kernel)};
  if (which < 0 || which >= static_cast<int>(sizeof(fns) / sizeof(fns[0])))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return 0;
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
