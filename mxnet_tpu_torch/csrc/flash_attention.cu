// Flash attention, forward and backward, written by hand for Hopper (sm_90a).
//
// Replaces the three TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py
// that _flash_core's custom_vjp launches through pl.pallas_call:
//
//   flash_fwd_kernel     <- _flash_fwd     (out and the per-row lse)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq  (dq)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv (dk, dv)
//
// Over (BH, T, D) f32 tensors, with kvalid (B,) int32 valid key counts
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
// Bound: operations. Per kept (query, key) pair the forward does 4 * D
// flops, dq 6 * D and dk/dv 8 * D. At the training shape (B = 2, H = 32,
// T = 2048, D = 128, causal: 134 M kept pairs) that is 68.8 GFLOP for the
// forward, about 1.03 ms at the card's 67 TFLOP/s of f32 outside the tensor
// cores, against 268 MB of inputs and outputs, 0.08 ms at 3.35 TB/s.
//
// Design, against that bound:
//  * f32 FMA on the CUDA cores, never TF32: the port computes in f32 as the
//    reference does;
//  * the TPU kernels carry m, l and the accumulators across a sequential
//    ("arbitrary") grid axis; here that axis is a loop inside one block: one
//    block of 256 threads per (bh, 64-row query tile) for fwd and dq, one per
//    (bh, 64-row key tile) for dk/dv. Nothing carries over between blocks
//    and there are no atomics;
//  * the whole-tile skip of the TPU kernels is kept: the key loop stops at
//    the last tile a row may see (kvalid, the causal diagonal), and dk/dv
//    starts at the first query tile that sees its keys;
//  * each thread owns a 4 x 4 patch of the 64 x 64 score tile and a
//    4 x (D / 16) patch of the output, reading both operands from shared
//    memory (rows padded to an odd pitch, so the 16 threads that read 16
//    rows hit 16 banks); the softmax statistics of a row live in the 16
//    threads of one half-warp and are reduced with shuffles;
//  * nothing is padded in device memory: the ragged edge of T is zero-filled
//    in shared memory and masked, and any D <= 256 is taken (64-row tiles up
//    to D = 128, 32-row tiles above, so the dk/dv block fits the 227 KB).
// Known weakness: operands come from shared memory at 2 FMAs per load in the
// score loop and tiles are loaded before they are used, with no overlap, so
// the kernels sit well below the f32 bound; wgmma (TF32 is not allowed, so
// a 3xTF32 split or bf16 inputs), TMA and GQA-native K/V are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16 threads
constexpr float kNegInf = -1e30f;    // finite "minus infinity", as in the TPU kernels
constexpr float kAliveMin = -5e29f;  // a row is dead while its max stays below this

__host__ __device__ inline int pitch_of(int D) { return D | 1; }  // odd: no bank conflicts

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + BM) of a row-major (T, D) matrix into a (BM, P) shared tile,
// times mul; rows at or past T are zeros. One warp per row, 32 columns a step.
template <int BM>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int T, int D, int P, float mul) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const bool in = r0 + r < T;
    const float* row = src + static_cast<size_t>(r0 + r) * D;
    for (int c = lane; c < D; c += 32) dst[r * P + c] = in ? __ldg(row + c) * mul : 0.f;
  }
}

// Per-row values [r0, r0 + BM) of a (T,) vector into shared memory; rows at
// or past T get `fill`.
template <int BM>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int T, float fill) {
  for (int r = threadIdx.x; r < BM; r += kThreads) dst[r] = r0 + r < T ? src[r0 + r] : fill;
}

// acc[i][j] += sum_d a[(ty + 16 i) * P + d] * b[(tx + 16 j) * P + d]: one
// thread's RM x RM patch of a (BM x BM) product of two row-major tiles.
template <int RM>
__device__ __forceinline__ void dot_patch(float (&acc)[RM][RM], const float* a, const float* b,
                                          int D, int P, int tx, int ty) {
  for (int d = 0; d < D; ++d) {
    float av[RM], bv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[(ty + 16 * i) * P + d];
#pragma unroll
    for (int j = 0; j < RM; ++j) bv[j] = b[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool kept(int qpos, int kpos, int kv_len, int causal, int causal_off) {
  return kpos < kv_len && (!causal || kpos <= qpos + causal_off);
}

// The key tiles a query tile starting at q0 sees: [0, key_end(q0)).
template <int BM>
__device__ __forceinline__ int key_end(int q0, int kv_len, int causal, int causal_off) {
  return causal ? min(kv_len, q0 + BM + causal_off) : kv_len;
}

// ---------------------------------------------------------------------------
// forward: one block per (bh, query tile); grid (BH, ceil(Tq / BM))
template <int BM, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ kvalid,
                     float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
                     int D, int causal, int causal_off, float scale) {
  constexpr int RM = BM / 16;
  constexpr int SP = BM + 1;  // pitch of the probability tile
  extern __shared__ float smem[];
  const int P = pitch_of(D);
  float* q_s = smem;            // BM x P, q * scale
  float* kv_s = q_s + BM * P;   // BM x P, the K tile, then the V tile
  float* p_s = kv_s + BM * P;   // BM x SP, probabilities of the tile

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal rows first
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kv_len = kvalid[bh / H];
  const int k_end = key_end<BM>(q0, kv_len, causal, causal_off);
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;

  load_tile<BM>(q_s, q + static_cast<size_t>(bh) * Tq * D, q0, Tq, D, P, scale);
  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BM) {
    __syncthreads();  // the previous tile's readers of kv_s and p_s are done
    load_tile<BM>(kv_s, kb, k0, Tk, D, P, 1.f);
    __syncthreads();
    float s[RM][RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) s[i][j] = 0.f;
    dot_patch<RM>(s, q_s, kv_s, D, P, tx, ty);

    // online softmax; row ty + 16 i lives in the 16 threads of a half-warp
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        if (!kept(qpos, k0 + tx + 16 * j, kv_len, causal, causal_off)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      // a row with every score dropped so far: exp(-1e30 - -1e30) would be
      // 1, so its probabilities are zeroed and l stays 0
      const bool alive = m_new > kAliveMin;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const float p = alive ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * SP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // done reading K; p_s complete
    load_tile<BM>(kv_s, vb, k0, Tk, D, P, 1.f);
    __syncthreads();
    const int kn = min(BM, Tk - k0);  // V rows past Tk are zeros with p = 0
    for (int kk = 0; kk < kn; ++kk) {
      float pv[RM], vv[NC];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? kv_s[kk * P + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    float* orow = out + (static_cast<size_t>(bh) * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = acc[i][c] / lsafe;
    }
    if (tx == 0)
      lse[static_cast<size_t>(bh) * Tq + row] = l[i] == 0.f ? kNegInf : m[i] + logf(lsafe);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (bh, query tile); grid (BH, ceil(Tq / BM))
template <int BM, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kvalid, float* __restrict__ dq, int H, int Tq,
                        int Tk, int D, int causal, int causal_off, float scale) {
  constexpr int RM = BM / 16;
  constexpr int SP = BM + 1;
  extern __shared__ float smem[];
  const int P = pitch_of(D);
  float* q_s = smem;            // BM x P, q * scale
  float* g_s = q_s + BM * P;    // BM x P, dO
  float* kv_s = g_s + BM * P;   // BM x P, the V tile, then the K tile
  float* ds_s = kv_s + BM * P;  // BM x SP
  float* lse_s = ds_s + BM * SP;
  float* dl_s = lse_s + BM;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kv_len = kvalid[bh / H];
  const int k_end = key_end<BM>(q0, kv_len, causal, causal_off);
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;

  load_tile<BM>(q_s, q + qoff * D, q0, Tq, D, P, scale);
  load_tile<BM>(g_s, g + qoff * D, q0, Tq, D, P, 1.f);
  load_rows<BM>(lse_s, lse + qoff, q0, Tq, kNegInf);
  load_rows<BM>(dl_s, delta + qoff, q0, Tq, 0.f);
  float acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BM) {
    __syncthreads();
    load_tile<BM>(kv_s, vb, k0, Tk, D, P, 1.f);
    __syncthreads();
    float dp[RM][RM], s[RM][RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) dp[i][j] = s[i][j] = 0.f;
    dot_patch<RM>(dp, g_s, kv_s, D, P, tx, ty);  // dP = dO . V^T
    __syncthreads();
    load_tile<BM>(kv_s, kb, k0, Tk, D, P, 1.f);
    __syncthreads();
    dot_patch<RM>(s, q_s, kv_s, D, P, tx, ty);  // S = (q * scale) . K^T
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      const float lr = lse_s[r];
      const float dl = dl_s[r];
      const bool alive = lr > kAliveMin;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const bool keep = alive && kept(q0 + r, k0 + tx + 16 * j, kv_len, causal, causal_off);
        const float p = keep ? expf(s[i][j] - lr) : 0.f;
        ds_s[r * SP + tx + 16 * j] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    const int kn = min(BM, Tk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float dv[RM], kv[NC];
#pragma unroll
      for (int i = 0; i < RM; ++i) dv[i] = ds_s[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        kv[c] = col < D ? kv_s[kk * P + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(dv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    float* drow = dq + (qoff + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) drow[col] = acc[i][c] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (bh, key tile); grid (BH, ceil(Tk / BM))
template <int BM, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ kvalid, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Tq, int Tk, int D, int causal,
                         int causal_off, float scale) {
  constexpr int RM = BM / 16;
  constexpr int SP = BM + 1;
  extern __shared__ float smem[];
  const int P = pitch_of(D);
  float* k_s = smem;            // BM x P
  float* v_s = k_s + BM * P;    // BM x P
  float* q_s = v_s + BM * P;    // BM x P, q * scale
  float* g_s = q_s + BM * P;    // BM x P, dO
  float* p_s = g_s + BM * P;    // BM (query) x SP (key)
  float* ds_s = p_s + BM * SP;  // BM (query) x SP (key)
  float* lse_s = ds_s + BM * SP;
  float* dl_s = lse_s + BM;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kv_len = kvalid[bh / H];
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const size_t koff = static_cast<size_t>(bh) * Tk;

  // rows of dk/dv: key ty + 16 i of the tile; columns tx + 16 c
  float dk_acc[RM][NC], dv_acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  if (k0 < kv_len) {  // a tile past kvalid gets no gradient
    load_tile<BM>(k_s, k + koff * D, k0, Tk, D, P, 1.f);
    load_tile<BM>(v_s, v + koff * D, k0, Tk, D, P, 1.f);
    // the first query tile whose last row sees key k0
    const int q_first = causal ? max(0, k0 - causal_off) / BM * BM : 0;
    for (int q0 = q_first; q0 < Tq; q0 += BM) {
      __syncthreads();
      load_tile<BM>(q_s, q + qoff * D, q0, Tq, D, P, scale);
      load_tile<BM>(g_s, g + qoff * D, q0, Tq, D, P, 1.f);
      load_rows<BM>(lse_s, lse + qoff, q0, Tq, kNegInf);
      load_rows<BM>(dl_s, delta + qoff, q0, Tq, 0.f);
      __syncthreads();
      // patch: query rows ty + 16 i, key columns tx + 16 j
      float s[RM][RM], dp[RM][RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) s[i][j] = dp[i][j] = 0.f;
      dot_patch<RM>(s, q_s, k_s, D, P, tx, ty);
      dot_patch<RM>(dp, g_s, v_s, D, P, tx, ty);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 16 * i;
        const float lr = lse_s[r];
        const float dl = dl_s[r];
        const bool alive = lr > kAliveMin;
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          const bool keep = alive && kept(q0 + r, k0 + tx + 16 * j, kv_len, causal, causal_off);
          const float p = keep ? expf(s[i][j] - lr) : 0.f;
          p_s[r * SP + tx + 16 * j] = p;
          ds_s[r * SP + tx + 16 * j] = p * (dp[i][j] - dl);
        }
      }
      __syncthreads();
      const int qn = min(BM, Tq - q0);  // query rows past Tq have p = ds = 0
      for (int qq = 0; qq < qn; ++qq) {
        float pv[RM], dsv[RM], gv[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pv[i] = p_s[qq * SP + ty + 16 * i];
          dsv[i] = ds_s[qq * SP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tx + 16 * c;
          gv[c] = col < D ? g_s[qq * P + col] : 0.f;
          qv[c] = col < D ? q_s[qq * P + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[i][c] = fmaf(pv[i], gv[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Tk) continue;
    float* dkr = dk + (koff + row) * D;
    float* dvr = dv + (koff + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dkr[col] = dk_acc[i][c];
        dvr[col] = dv_acc[i][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch

enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

// Tile rows at head dim D: 64 up to D = 128, 32 above (the dk/dv block's
// four (rows x D) tiles must fit in shared memory).
inline int block_rows(int D) { return D <= 128 ? 64 : 32; }

inline size_t smem_bytes(int kernel, int D) {
  const size_t bm = block_rows(D);
  const size_t tile = bm * pitch_of(D);
  const size_t prob = bm * (bm + 1);
  size_t floats = 0;
  if (kernel == kFwd) floats = 2 * tile + prob;
  if (kernel == kDq) floats = 3 * tile + prob + 2 * bm;
  if (kernel == kDkv) floats = 4 * tile + 2 * prob + 2 * bm;
  return floats * sizeof(float);
}

struct Args {
  const float *q, *k, *v, *g, *lse, *delta;
  const int* kvalid;
  float *o0, *o1;  // fwd: out, lse; dq: dq; dkv: dk, dv
  int BH, H, Tq, Tk, D, causal, causal_off;
  float scale;
};

template <int BM, int NC>
cudaError_t launch_cfg(int kernel, const Args& a, cudaStream_t st) {
  const size_t smem = smem_bytes(kernel, a.D);
  const int rows = kernel == kDkv ? a.Tk : a.Tq;
  const dim3 grid(a.BH, (rows + BM - 1) / BM);
  cudaError_t err;
  if (kernel == kFwd) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<BM, NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<BM, NC><<<grid, kThreads, smem, st>>>(a.q, a.k, a.v, a.kvalid, a.o0, a.o1,
                                                           a.H, a.Tq, a.Tk, a.D, a.causal,
                                                           a.causal_off, a.scale);
  } else if (kernel == kDq) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<BM, NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<BM, NC><<<grid, kThreads, smem, st>>>(
        a.q, a.k, a.v, a.g, a.lse, a.delta, a.kvalid, a.o0, a.H, a.Tq, a.Tk, a.D, a.causal,
        a.causal_off, a.scale);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<BM, NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<BM, NC><<<grid, kThreads, smem, st>>>(
        a.q, a.k, a.v, a.g, a.lse, a.delta, a.kvalid, a.o0, a.o1, a.H, a.Tq, a.Tk, a.D,
        a.causal, a.causal_off, a.scale);
  }
  return cudaGetLastError();
}

int launch(int kernel, const Args& a, void* stream) {
  if (a.D < 1 || a.D > 256 || a.BH < 1 || a.H < 1 || a.Tq < 1 || a.Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.D <= 64)
    err = launch_cfg<64, 4>(kernel, a, st);
  else if (a.D <= 128)
    err = launch_cfg<64, 8>(kernel, a, st);
  else
    err = launch_cfg<32, 16>(kernel, a, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// All tensors f32 and contiguous on the device: q (BH, Tq, D); k, v
// (BH, Tk, D); g and the outputs shaped as the tensor they differentiate;
// lse, delta (BH, Tq); kvalid (B,) int32 with B = BH / H. Each function
// launches on `stream` without synchronising and returns cudaGetLastError()
// (cudaErrorInvalidValue for an empty shape or D outside 1..256).
int mxtt_flash_fwd(const void* q, const void* k, const void* v, const void* kvalid, void* out,
                   void* lse, int BH, int H, int Tq, int Tk, int D, int causal, int causal_off,
                   float scale, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
         nullptr, nullptr, nullptr, static_cast<const int*>(kvalid), static_cast<float*>(out),
         static_cast<float*>(lse), BH, H, Tq, Tk, D, causal, causal_off, scale};
  return launch(kFwd, a, stream);
}

int mxtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                      const void* delta, const void* kvalid, void* dq, int BH, int H, int Tq,
                      int Tk, int D, int causal, int causal_off, float scale, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
         static_cast<const float*>(g), static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(kvalid),
         static_cast<float*>(dq), nullptr, BH, H, Tq, Tk, D, causal, causal_off, scale};
  return launch(kDq, a, stream);
}

int mxtt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                       const void* lse, const void* delta, const void* kvalid, void* dk, void* dv,
                       int BH, int H, int Tq, int Tk, int D, int causal, int causal_off,
                       float scale, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
         static_cast<const float*>(g), static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(kvalid),
         static_cast<float*>(dk), static_cast<float*>(dv), BH, H, Tq, Tk, D, causal, causal_off,
         scale};
  return launch(kDkv, a, stream);
}

// Dynamic shared memory of one block of `kernel` (0 fwd, 1 dq, 2 dk/dv) at D.
long long mxtt_flash_smem_bytes(int kernel, int D) {
  return static_cast<long long>(smem_bytes(kernel, D));
}

const char* mxtt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
