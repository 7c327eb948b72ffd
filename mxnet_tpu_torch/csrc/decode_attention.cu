// One-query grouped-query decode attention over the KV ring, written by
// hand for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas/decode_attention.py, _decode_kernel (the
// TPU kernel that _pallas_decode launches through pl.pallas_call). It
// computes the same function as that kernel and as its fused-einsum
// fallback _xla_decode at T = 1:
//
//   out[b, kvh*G + g, :] = softmax_s(q[b, kvh*G + g] . K[b, kvh, s] * scale)
//                          @ V[b, kvh, :]          over s <= start_pos[b]
//
// with the G = H / KV query heads of a group sharing every K/V tile (K and
// V are never expanded), an online running max and sum with the finite
// -1e30 as minus infinity, zeros for a row whose sum stays 0, and, for int8
// rings, the per-position f32 scales applied as each element is widened to
// f32. All arithmetic is f32; only the order of the sums differs from the
// plain version.
//
// Bound: memory bytes. A launch reads sum_b KV * (sp_b + 1) * D * 2 ring
// elements (4 bytes each for f32, 1 for int8) plus, for int8, 8 bytes of
// scales per position and KV head, and does 4 * G * D flops per position
// and KV head: at G = 4, 2 flops a byte in f32 and 8 in int8, where the
// card needs about 20 before f32 arithmetic is the limit. At B = 4, KV = 8,
// D = 128 and 8192 live positions a row that is 268 MB of f32 ring, 80 us
// at 3.35 TB/s (21 us in int8). So the kernel is as fast as it keeps bytes
// in flight on every SM; the tensor cores, wgmma and TMA buy nothing here.
//
// Design (flash-decoding), against that bound:
//  * the ring is split across blocks: the grid is (B * KV * ceil(G / 4),
//    n_split). A block carries 4 query heads of one (batch row, KV head) and
//    one of n_split equal shares of that row's live positions
//    n = start_pos[b] + 1, in whole tiles of kTile positions (the last tile
//    of the row is ragged). The wrapper picks n_split from the shapes and
//    the SM count alone (split_plan), and each block reads start_pos[b]
//    from device memory, so one launch configuration serves every position
//    and a call can be captured in a CUDA graph. Short rows leave their
//    trailing shares empty; such a block writes an empty partial (m = -1e30,
//    l = 0) and returns;
//  * each block writes its partial (m, l, the unnormalised acc, f32) to a
//    workspace, and decode_attention_combine_kernel merges a row's splits
//    in split order, with no atomics, so two calls repeat bit for bit; it
//    applies the l == 0 -> zeros rule and writes out. It is launched as a
//    programmatic dependent of the split kernel (PDL), so its launch
//    overlaps the split kernel's tail; it waits for that grid before it
//    reads. At n_split = 1 the block writes out itself and no combine runs;
//  * K/V tiles arrive by 16-byte cp.async through a ring of kStages shared
//    buffers, issued two tiles ahead of the tile being computed: one
//    barrier a tile, with up to two tiles in flight behind it. int8 stays
//    int8 in shared memory and is widened and scaled in registers;
//  * within a tile each of the 8 warps owns kRows positions and keeps its
//    own online max, sum and accumulators, so the compute needs no barrier.
//    Lanes run over D in 4-element chunks (a float4 or one int8 word each):
//    a lane forms the partial dots of its chunk for the warp's 4 heads x
//    kRows positions, and one transposing butterfly (16 values, one shuffle
//    a score) leaves each score's total in two lanes. The probabilities
//    reach every lane through 80 bytes of shared memory, and P . V runs on
//    the lane's own chunks. At the end the block's 8 warps are merged in
//    warp order through shared memory;
//  * the VEC instantiation needs 16-byte aligned rings with D * element size
//    a multiple of 16; otherwise (misaligned rings) tiles load through
//    scalar loads into the same buffers, with no overlap.
// What still holds it back:
//  * short rings: below about one tile a SM the launch pair's fixed latency
//    (two kernels, the combine waiting on the first, the first tile's load)
//    sets the time, well above the byte bound;
//  * int8: each lane widens, scales and multiplies every element it owns on
//    the CUDA cores (32 FMAs, 16 conversion steps and 8 scalings a position
//    per lane), so the kernel is bound by instruction issue rather than
//    bytes; deeper load pipelines and wider tiles did not move it;
//  * f32 at long rings reaches about two thirds of the memory rate; G > 4
//    runs ceil(G / 4) blocks over the same K/V tiles, which then come from
//    L2; for D > 128 (NC = 2) ptxas holds some instantiations to 128
//    registers and spills a few bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;   // KV positions a block stages at a time: natural_block()
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;      // positions a warp scores per tile
constexpr int kGroup = 4;                  // query heads a block carries
constexpr int kScores = kGroup * kRows;    // (head, position) scores a warp per tile
constexpr int kStages = 3;                 // stage buffers: two tiles in flight
constexpr int kBcast = kScores + kGroup;   // a warp's probabilities and rescale factors
constexpr int kBcastBytes = kWarps * kBcast * 4;
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1e30f;  // finite: masked rows stay NaN-free
constexpr unsigned kFull = 0xffffffffu;

static_assert(kScores == 16, "warp_transpose_sum16 reduces 16 values");
static_assert((kBcast * 4) % 16 == 0, "each warp's broadcast area is float4 aligned");

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared memory of one K/V stage in bytes: K tile, V tile (kTile x Dp ring
// elements each, Dp = D rounded up to 4) and, for int8, their scales.
__host__ __device__ inline int stage_bytes(bool quant, int D) {
  return 2 * kTile * round4(D) * (quant ? 1 : 4) + (quant ? 2 * kTile * 4 : 0);
}

// Dynamic shared memory of a block: the warps' broadcast areas, then the
// stage ring, which the closing merge reuses for each warp's (m, l) and acc.
__host__ __device__ inline int smem_bytes(bool quant, int D) {
  const int ring = kStages * stage_bytes(quant, D);
  const int merge = (kWarps * kGroup * 2 + kWarps * kGroup * round4(D)) * 4;
  return kBcastBytes + (ring > merge ? ring : merge);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
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

// Four int8 (one 32-bit word) widened to f32 exactly: with the sign bit
// flipped, byte b + 128 becomes the low mantissa byte of 2^23.
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  const uint32_t x = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7443)) - 8388736.f;
}

// The lane's chunks (4 elements each, chunk c = lane + 32 * i) of one staged
// row as f32, scaled per position for int8; zeros past the row's Dc chunks.
template <typename T, int NC>
__device__ __forceinline__ void load_row(const T* row, int lane, int Dc, float s,
                                         float (&f)[NC][4]) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c < Dc) {
      if constexpr (std::is_same<T, float>::value) {
        const float4 x = *reinterpret_cast<const float4*>(row + 4 * c);
        f[i][0] = x.x;
        f[i][1] = x.y;
        f[i][2] = x.z;
        f[i][3] = x.w;
      } else {
        widen4(*reinterpret_cast<const uint32_t*>(row + 4 * c), f[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) f[i][e] *= s;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[i][e] = 0.f;
    }
  }
}

// One butterfly step: lanes with bit O set keep the upper H values, the
// others the lower H, each adding its partner's copy of what it keeps.
template <int H, int O>
__device__ __forceinline__ void halve(float (&v)[kScores], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// Each of 16 per-lane values summed over the warp's 32 lanes, in 16
// shuffles: lane L returns the total of value L >> 1.
__device__ __forceinline__ float warp_transpose_sum16(float (&v)[kScores], int lane) {
  halve<8, 16>(v, lane);
  halve<4, 8>(v, lane);
  halve<2, 4>(v, lane);
  halve<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// QUANT: int8 rings with (B, KV, S) f32 scales; VEC: D * sizeof(T) is a
// multiple of 16 and the rings are 16-byte aligned, so tiles stream by
// cp.async; NC: 4-element chunks a lane holds of a row (D <= 128 * NC).
// ws_ml == nullptr: the block is the row's only split and writes out.
template <bool QUANT, bool VEC, int NC>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const float* __restrict__ q, const void* __restrict__ k_ring,
                            const void* __restrict__ v_ring, const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale, const int* __restrict__ start_pos,
                            float* __restrict__ out, float* __restrict__ ws_ml,
                            float* __restrict__ ws_acc, int KV, int S, int D, int G,
                            float scale) {
  using T = typename std::conditional<QUANT, int8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = round4(D);
  const int Dc = Dp >> 2;
  const int sbytes = stage_bytes(QUANT, D);
  unsigned char* ring_s = smem + kBcastBytes;

  const int groups = (G + kGroup - 1) / kGroup;
  const int bk = blockIdx.x / groups;  // b * KV + kv head
  const int gg = blockIdx.x - bk * groups;
  const int b = bk / KV;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ng = min(kGroup, G - gg * kGroup);  // live heads of the block
  // (b, first head) row of q / out, (B, H, 1, D) with H = KV * G
  const size_t bh0 = static_cast<size_t>(b) * KV * G + (bk - b * KV) * G + gg * kGroup;

  // let the combine launch now: it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // this block's share of the row: tiles [t0, t1) of the live positions
  const int n = min(max(start_pos[b] + 1, 0), S);
  const int nt = (n + kTile - 1) / kTile;
  const int per = (nt + n_split - 1) / n_split;
  const int t0 = min(split * per, nt);
  const int t1 = min(t0 + per, nt);
  if (t0 >= t1) {
    if (ws_ml != nullptr) {
      if (tid < ng) {
        float* ml = ws_ml + ((bh0 + tid) * n_split + split) * 2;
        ml[0] = kNegInf;
        ml[1] = 0.f;
      }
    } else {
      for (int e = tid; e < ng * D; e += kThreads) out[bh0 * D + e] = 0.f;
    }
    return;
  }

  const size_t ring = static_cast<size_t>(bk) * S;  // the row's first position
  const T* kr = static_cast<const T*>(k_ring) + ring * D;
  const T* vr = static_cast<const T*>(v_ring) + ring * D;
  const float* ksr = QUANT ? k_scale + ring : nullptr;
  const float* vsr = QUANT ? v_scale + ring : nullptr;

  // stage tile t of the share (if it exists) into buffer t % kStages
  auto issue = [&](int t) {
    if (t0 + t >= t1) return;
    const int p0 = (t0 + t) * kTile;
    const int nj = min(kTile, n - p0);  // live rows; the rest are zero-filled
    T* kt = reinterpret_cast<T*>(ring_s + (t % kStages) * sbytes);
    T* vt = kt + kTile * Dp;
    if constexpr (VEC) {
      constexpr int W = 16 / static_cast<int>(sizeof(T));
      const int per_row = D / W;  // Dp == D here
      const T* ks = kr + static_cast<size_t>(p0) * D;
      const T* vs = vr + static_cast<size_t>(p0) * D;
      for (int i = tid; i < kTile * per_row; i += kThreads) {
        const bool in = i < nj * per_row;
        cp_async16(kt + i * W, in ? ks + i * W : kr, in);
        cp_async16(vt + i * W, in ? vs + i * W : vr, in);
      }
    } else {
      for (int i = tid; i < kTile * Dp; i += kThreads) {
        const int r = i / Dp;
        const int c = i - r * Dp;
        const bool in = r < nj && c < D;
        const size_t at = static_cast<size_t>(p0 + r) * D + c;
        kt[i] = in ? kr[at] : T(0);
        vt[i] = in ? vr[at] : T(0);
      }
    }
    if constexpr (QUANT) {
      float* st = reinterpret_cast<float*>(vt + kTile * Dp);  // k scales, then v scales
      if (tid < 2 * kTile) {
        const int r = tid & (kTile - 1);
        const float* src = tid < kTile ? ksr : vsr;
        const bool in = r < nj;
        if constexpr (VEC) {
          cp_async4(st + tid, in ? src + p0 + r : src, in);
        } else {
          st[tid] = in ? src[p0 + r] : 0.f;
        }
      }
    }
  };

  // the block's query rows, this lane's chunks, in registers
  float qr[kGroup][NC][4];
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (lane + 32 * i) + e;
        qr[g][i][e] = (g < ng && d < D) ? q[(bh0 + g) * D + d] : 0.f;
      }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s);
    cp_async_commit();
  }

  // running max and sum of head lane >> 3 (kept by its 8 lanes), and this
  // lane's chunks of every head's accumulator
  float m = kNegInf, l = 0.f;
  float acc[kGroup][NC][4];
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][i][e] = 0.f;
  float* bc = reinterpret_cast<float*>(smem) + warp * kBcast;
  const int r0 = warp * kRows;

  for (int t = 0; t < t1 - t0; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    issue(t + kStages - 1);
    cp_async_commit();
    const int nj = min(kTile, n - (t0 + t) * kTile);
    if (r0 >= nj) continue;  // the ragged last tile ends before this warp's rows
    const T* kt = reinterpret_cast<const T*>(ring_s + (t % kStages) * sbytes);
    const T* vt = kt + kTile * Dp;
    const float* kst = reinterpret_cast<const float*>(vt + kTile * Dp);
    const float* vst = kst + kTile;

    // scores of the warp's 4 heads x kRows positions
    float sv[kScores];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float kf[NC][4];
      load_row<T, NC>(kt + (r0 + j) * Dp, lane, Dc, QUANT ? kst[r0 + j] : 1.f, kf);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dot = fmaf(qr[g][i][e], kf[i][e], dot);
        sv[g * kRows + j] = dot;
      }
    }
    const float tot = warp_transpose_sum16(sv, lane);
    const int jl = (lane >> 1) & (kRows - 1);  // this lane's score: head lane >> 3
    const bool live = r0 + jl < nj;
    const float sc = live ? tot * scale : kNegInf;

    // online softmax of head lane >> 3 over its 8 lanes (pairs hold copies)
    float mx = fmaxf(sc, __shfl_xor_sync(kFull, sc, 2));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
    const float m_new = fmaxf(m, mx);
    const float p = live ? expf(sc - m_new) : 0.f;
    float ps = p + __shfl_xor_sync(kFull, p, 2);
    ps += __shfl_xor_sync(kFull, ps, 4);
    const float alpha = expf(m - m_new);
    l = l * alpha + ps;
    m = m_new;
    __syncwarp();  // the warp is done reading the last tile's broadcast
    if ((lane & 1) == 0) bc[lane >> 1] = p;
    if ((lane & 7) == 0) bc[kScores + (lane >> 3)] = alpha;
    __syncwarp();

    // acc = acc * alpha + P . V on the lane's chunks
    const float4 al = *reinterpret_cast<const float4*>(bc + kScores);
    const float alv[kGroup] = {al.x, al.y, al.z, al.w};
    float pg[kGroup][kRows];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float4 pv = *reinterpret_cast<const float4*>(bc + g * kRows);
      pg[g][0] = pv.x;
      pg[g][1] = pv.y;
      pg[g][2] = pv.z;
      pg[g][3] = pv.w;
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][i][e] *= alv[g];
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (r0 + j >= nj) break;
      float vf[NC][4];
      load_row<T, NC>(vt + (r0 + j) * Dp, lane, Dc, QUANT ? vst[r0 + j] : 1.f, vf);
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][i][e] = fmaf(pg[g][j], vf[i][e], acc[g][i][e]);
    }
  }

  // merge the 8 warps in warp order, through the idle stage ring
  cp_async_wait<0>();
  __syncthreads();
  float* wml = reinterpret_cast<float*>(ring_s);  // [warp][head] (m, l)
  float* wacc = wml + kWarps * kGroup * 2;        // [warp][head][Dp]
  if ((lane & 7) == 0) {
    wml[(warp * kGroup + (lane >> 3)) * 2] = m;
    wml[(warp * kGroup + (lane >> 3)) * 2 + 1] = l;
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < Dc)
        *reinterpret_cast<float4*>(wacc + (warp * kGroup + g) * Dp + 4 * c) =
            make_float4(acc[g][i][0], acc[g][i][1], acc[g][i][2], acc[g][i][3]);
    }
  __syncthreads();
  for (int e = tid; e < ng * D; e += kThreads) {
    const int g = e / D;
    const int d = e - g * D;
    float mb = kNegInf;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wml[(w * kGroup + g) * 2]);
    float lb = 0.f, ab = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(wml[(w * kGroup + g) * 2] - mb);
      lb += wt * wml[(w * kGroup + g) * 2 + 1];
      ab += wt * wacc[(w * kGroup + g) * Dp + d];
    }
    if (ws_ml != nullptr) {
      const size_t at = (bh0 + g) * n_split + split;
      ws_acc[at * D + d] = ab;
      if (d == 0) {
        ws_ml[at * 2] = mb;
        ws_ml[at * 2 + 1] = lb;
      }
    } else {
      out[bh0 * D + e] = lb == 0.f ? 0.f : ab / lb;
    }
  }
}

// One block per (batch row, head): the row's n_split partials merged in
// split order; empty partials (l == 0) are skipped, and a row with no live
// position gives zeros.
__global__ void __launch_bounds__(kCombineThreads)
    decode_attention_combine_kernel(const float* __restrict__ ws_ml,
                                    const float* __restrict__ ws_acc, float* __restrict__ out,
                                    int n_split, int D) {
  // launched as a programmatic dependent of the split kernel: wait until
  // that grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t bh = blockIdx.x;
  const float* ml = ws_ml + bh * n_split * 2;
  const float* acc = ws_acc + bh * n_split * D;
  float mb = kNegInf;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) mb = fmaxf(mb, ml[2 * s]);
  float lb = 0.f;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) lb += expf(ml[2 * s] - mb) * ml[2 * s + 1];
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float ab = 0.f;
    for (int s = 0; s < n_split; ++s)
      if (ml[2 * s + 1] > 0.f) ab += expf(ml[2 * s] - mb) * acc[static_cast<size_t>(s) * D + d];
    out[bh * D + d] = lb == 0.f ? 0.f : ab / lb;
  }
}

template <bool QUANT, bool VEC, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* sp, void* out, void* ws_ml, void* ws_acc, int B, int KV, int S,
                   int D, int G, int n_split, float scale, cudaStream_t stream) {
  // raised once per instantiation and device (the attribute lives in each
  // device's context), not again during a graph capture that follows
  constexpr int kMaxDevices = 64;
  static int smem_allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int smem = smem_bytes(QUANT, D);
  if (device >= kMaxDevices || smem > smem_allowed[device]) {
    err = cudaFuncSetAttribute(decode_attention_kernel<QUANT, VEC, NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) smem_allowed[device] = smem;
  }
  const dim3 grid(B * KV * ((G + kGroup - 1) / kGroup), n_split);
  decode_attention_kernel<QUANT, VEC, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(sp), static_cast<float*>(out),
      static_cast<float*>(ws_ml), static_cast<float*>(ws_acc), KV, S, D, G, scale);
  return cudaGetLastError();
}

template <bool QUANT, bool VEC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* sp, void* out, void* ws_ml, void* ws_acc,
                      int B, int KV, int S, int D, int G, int n_split, float scale,
                      cudaStream_t stream) {
  if (round4(D) <= 128)
    return launch<QUANT, VEC, 1>(q, k, v, ks, vs, sp, out, ws_ml, ws_acc, B, KV, S, D, G,
                                 n_split, scale, stream);
  return launch<QUANT, VEC, 2>(q, k, v, ks, vs, sp, out, ws_ml, ws_acc, B, KV, S, D, G,
                               n_split, scale, stream);
}

}  // namespace

extern "C" {

// q (B, KV*G, 1, D) f32; k, v (B, KV, S, D) f32 (quant = 0) or int8
// (quant = 1, with k_scale, v_scale (B, KV, S) f32); start_pos (B,) int32 on
// the device; out (B, KV*G, 1, D) f32. All contiguous, D <= 256. vec = 1
// requires 16-byte aligned rings with D * element size a multiple of 16.
// n_split = 1: ws_ml and ws_acc are null and the kernel writes out; n_split
// > 1: it writes the partials to ws_ml (B*H, n_split, 2) and ws_acc (B*H,
// n_split, D), f32, and mxtt_decode_attention_combine must follow. Launches
// on `stream` without synchronising; returns cudaGetLastError().
int mxtt_decode_attention(const void* q, const void* k, const void* v, const void* k_scale,
                          const void* v_scale, const void* start_pos, void* out, void* ws_ml,
                          void* ws_acc, int B, int KV, int S, int D, int G, int n_split,
                          float scale, int quant, int vec, void* stream) {
  if (D < 1 || D > 256 || n_split < 1 || n_split > 65535 ||
      (n_split > 1) != (ws_ml != nullptr && ws_acc != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (quant) {
    err = vec ? launch_nc<true, true>(q, k, v, k_scale, v_scale, start_pos, out, ws_ml, ws_acc,
                                      B, KV, S, D, G, n_split, scale, st)
              : launch_nc<true, false>(q, k, v, k_scale, v_scale, start_pos, out, ws_ml,
                                       ws_acc, B, KV, S, D, G, n_split, scale, st);
  } else {
    err = vec ? launch_nc<false, true>(q, k, v, nullptr, nullptr, start_pos, out, ws_ml,
                                       ws_acc, B, KV, S, D, G, n_split, scale, st)
              : launch_nc<false, false>(q, k, v, nullptr, nullptr, start_pos, out, ws_ml,
                                        ws_acc, B, KV, S, D, G, n_split, scale, st);
  }
  return static_cast<int>(err);
}

// The n_split partials of each of the BH = B * H rows merged into out.
// Launched with programmatic stream serialization, so its launch overlaps
// the split kernel's tail (the kernel waits for that grid itself).
int mxtt_decode_attention_combine(const void* ws_ml, const void* ws_acc, void* out, int BH,
                                  int n_split, int D, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_combine_kernel, static_cast<const float*>(ws_ml),
      static_cast<const float*>(ws_acc), static_cast<float*>(out), n_split, D);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The KV tile width, reported by the wrapper's natural_block().
int mxtt_decode_attention_block() { return kTile; }

// Query heads one block carries (the wrapper's split_plan groups G by it).
int mxtt_decode_attention_group() { return kGroup; }

// Dynamic shared memory one block takes at (D, quant), in bytes.
long long mxtt_decode_attention_smem_bytes(int D, int quant) {
  return static_cast<long long>(smem_bytes(quant != 0, D));
}

const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
