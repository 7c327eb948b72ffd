// Fused channels-last 1x1-conv pair, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxnet_tpu/ops/pallas/conv1x1.py (conv1x1_pair,
// launched through pl.pallas_call) and its three bodies:
//
//   variant 0  <- _kernel       y = relu((relu(x @ w1 * s1 + b1)) @ w2 * s2 + b2)
//   variant 1  <- _kernel_res   the same with a residual added before the first relu
//   variant 2  <- _kernel_res2  variant 1 that also writes the mid h
//
// Per row of x (M, C1), with w1 (C1, Cm), w2 (Cm, Cout) and f32 affines:
//
//   h   = relu(x @ w1 * s1 + b1 [+ res])   rounded to T (float or bf16)
//   mid = h                                (variant 2)
//   y   = relu(h @ w2 * s2 + b2)           rounded to T
//
// Both products accumulate in f32; the residual is a T tensor widened to
// f32. The affine and residual arithmetic is done op by op (__fmul_rn,
// __fadd_rn, no contraction into an FMA), as the plain version and the
// Pallas kernel write it, so the elementwise epilogues round the same way.
//
// Bound. One launch does 4 * M * C1 * Cm flops (two products) and moves
// x, res, mid and y once. At ResNet-50's block boundaries (batch 32, 224 x
// 224) that is 6.58 GFLOP a launch; in bf16 the bytes bound it at the first
// three stages (20-128 MB at 3.35 TB/s) and the tensor cores (989 TFLOP/s)
// at the last; in f32, outside the tensor cores (67 TFLOP/s; TF32 is not
// allowed), the flops bound every stage at 98 us.
//
// Design, against that bound:
//  * the TPU kernel keeps a (block_rows, Cm) mid tile in VMEM. At Cm = 2048
//    that does not fit a block's 227 KB of shared memory, so here one block
//    of 256 threads owns a tile of BM rows and loops over Cm in chunks of
//    BN = 64: h_chunk = x_tile @ w1[:, chunk] with its epilogue (affine,
//    residual, relu, rounding to T), written to `mid` if asked, then
//    y_tile += h_chunk @ w2[chunk, :] in f32 registers. The mid never reaches
//    device memory except as the `mid` output. The rounding of h is
//    elementwise, so chunking keeps it exact; only the order of the second
//    sum changes;
//  * every operand streams through shared memory in 32-deep slabs, zero-
//    filled past the edge of M, C1, Cm and Cout, so any shape is taken and
//    nothing is padded in device memory (the TPU kernel pads M to
//    block_rows; `block_rows` changes nothing here);
//  * each warp owns 16 rows of the tile: a 16 x 128 slab of y and a
//    16 x (64 / WN) slab of the h chunk. A thread thus holds 64 y and at
//    most 32 h accumulators whatever the shape: BM = 128 rows for
//    Cout <= 128, 64 for Cout <= 256, 32 above, and a second grid dimension
//    over 512-column slabs of Cout above 512 (which recomputes h);
//  * bf16 uses the tensor cores through mma.sync m16n8k16 with f32
//    accumulators (ldmatrix from shared memory, rows padded by 16 bytes so
//    the eight rows of a matrix hit eight bank groups); f32 uses CUDA-core
//    FMAs, each thread an 8-row patch, reading both operands from shared
//    memory;
//  * device loads are 16 bytes a thread when every pointer is 16-byte
//    aligned and every channel count a multiple of 16 bytes, else scalar.
// Known weaknesses: slabs are loaded before they are used, with no overlap
// (no cp.async, TMA or wgmma yet), and the last stages give fewer blocks
// than the card has SMs (M = 1568 at Cout = 512: 49 blocks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int KS = 32;         // depth of a shared-memory slab
constexpr int BN = 64;         // width of a Cm chunk
constexpr int kAccum = 16384;  // BM * NMAX: 64 y accumulators a thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// relu as jnp.maximum(v, 0) and torch.relu give it: NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

template <typename T> struct Pad { static constexpr int value = 16 / sizeof(T); };

// dst[r * dp + c] = src[r * sp + c] for r < rows, c < cols, zero where
// r >= rlim or c >= clim. cols is a multiple of V = 16 / sizeof(T); dst and
// dp keep 16-byte alignment. vec: device loads of 16 bytes are allowed.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dp, const T* __restrict__ src, size_t sp,
                                          int rows, int cols, int rlim, int clim, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * V;
    T* d = dst + r * dp + c;
    const T* s = src + static_cast<size_t>(r) * sp + c;
    if (vec && r < rlim && c + V <= clim) {
      *reinterpret_cast<uint4*>(d) = __ldg(reinterpret_cast<const uint4*>(s));
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) d[v] = (r < rlim && c + v < clim) ? s[v] : from_f<T>(0.f);
    }
  }
}

// dst[r * dp + c] = src[r * sp + c] for r < rlim, c < clim (within rows x cols).
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, size_t dp, const T* src, int sp,
                                           int rows, int cols, int rlim, int clim, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * V;
    if (r >= rlim || c >= clim) continue;
    T* d = dst + static_cast<size_t>(r) * dp + c;
    const T* s = src + r * sp + c;
    if (vec && c + V <= clim) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int v = 0; v < V && c + v < clim; ++v) d[v] = s[v];
    }
  }
}

// -- a warp's 16 x NC accumulator tile ----------------------------------------
// mma(): acc += A[16 x K] @ B[K x NC] with A row-major in shared memory at
// `a` (pitch ap) and B row-major at `b` (pitch bp); only the first `nvalid`
// columns are computed (the rest of B is zeros). each(f): f(row, col, v)
// over the thread's accumulators, row and col relative to the tile.
template <typename T, int NC> struct Frag;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: NC / 8 tiles of m16n8; lane (g = lane / 4, t = lane % 4) holds
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of each.
template <int NC> struct Frag<bf16, NC> {
  static constexpr int NT = NC / 8;
  static_assert(NT % 2 == 0, "tiles go in pairs through ldmatrix.x4");
  float v[NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] = 0.f;
  }

  __device__ __forceinline__ void mma(const bf16* a, int ap, const bf16* b, int bp, int K,
                                      int nvalid) {
    const int lane = threadIdx.x & 31;
    for (int k = 0; k < K; k += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (lane & 15) * ap + k + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j * 8 < nvalid) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, b + (k + (lane & 15)) * bp + (j + (lane >> 4)) * 8);
          mma_bf16(v[j], af, bf[0], bf[1]);
          mma_bf16(v[j + 1], af, bf[2], bf[3]);
        }
      }
    }
  }

  template <class F> __device__ __forceinline__ void each(F f) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) f(g + 8 * (q >> 1), j * 8 + 2 * t + (q & 1), v[j][q]);
  }
};

// f32: lane (ty = lane / 16, tx = lane % 16) holds rows ty + 2i (i < 8) at
// columns tx + 16j (j < NC / 16).
template <int NC> struct Frag<float, NC> {
  static constexpr int CJ = NC / 16;
  float v[8][CJ];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) v[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* a, int ap, const float* b, int bp, int K,
                                      int nvalid) {
    const int lane = threadIdx.x & 31;
    const int ty = lane >> 4, tx = lane & 15;
    if (nvalid <= 0) return;
    for (int k = 0; k < K; ++k) {
      float av[8], bv[CJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a[(ty + 2 * i) * ap + k];
#pragma unroll
      for (int j = 0; j < CJ; ++j) bv[j] = b[k * bp + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) v[i][j] = fmaf(av[i], bv[j], v[i][j]);
    }
  }

  template <class F> __device__ __forceinline__ void each(F f) {
    const int lane = threadIdx.x & 31;
    const int ty = lane >> 4, tx = lane & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) f(ty + 2 * i, tx + 16 * j, v[i][j]);
  }
};

template <typename T, int BM> struct Cfg {
  static constexpr int WM = BM / 16;          // warps along rows
  static constexpr int WN = 8 / WM;           // warps along columns
  static constexpr int NMAX = kAccum / BM;    // y columns of one block
  static constexpr int YC = NMAX / WN;        // y columns of one warp (128)
  static constexpr int HC = BN / WN;          // h columns of one warp
  static constexpr int P = Pad<T>::value;     // row padding, 16 bytes
  static constexpr int XP = KS + P, W1P = BN + P, HP = BN + P, W2P = NMAX + P;
  static constexpr int kElems = BM * XP + KS * W1P + BM * HP + KS * W2P;
  static constexpr size_t kSmem = kElems * sizeof(T);
  static_assert(YC == 128, "a warp holds a 16 x 128 slab of y");
};

// One block per (BM-row tile of x, NMAX-column slab of y).
template <typename T, int BM, bool RES, bool MID>
__global__ void __launch_bounds__(kThreads)
    conv1x1_pair_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const T* __restrict__ w1, const T* __restrict__ w2,
                        const float* __restrict__ s1, const float* __restrict__ b1,
                        const float* __restrict__ s2, const float* __restrict__ b2,
                        T* __restrict__ mid, T* __restrict__ out, int M, int C1, int Cm, int Cout,
                        int vec) {
  typedef Cfg<T, BM> C;
  extern __shared__ uint4 smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // BM x KS slab of x
  T* w1s = xs + BM * C::XP;                // KS x BN slab of w1
  T* hs = w1s + KS * C::W1P;               // BM x BN: the residual chunk, then h
  T* w2s = hs + BM * C::HP;                // KS x NMAX slab of w2

  const int warp = threadIdx.x >> 5;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * C::NMAX;
  const int rlim = M - r0;
  const int ycols = min(C::NMAX, Cout - n0) - wn * C::YC;  // this warp's real y columns
  const bool v = vec != 0;

  Frag<T, C::YC> y;
  y.zero();
  for (int c0 = 0; c0 < Cm; c0 += BN) {
    if (RES) load_tile(hs, C::HP, res + static_cast<size_t>(r0) * Cm + c0, Cm, BM, BN, rlim,
                       Cm - c0, v);
    Frag<T, C::HC> h;
    h.zero();
    for (int k0 = 0; k0 < C1; k0 += KS) {
      load_tile(xs, C::XP, x + static_cast<size_t>(r0) * C1 + k0, C1, BM, KS, rlim, C1 - k0, v);
      load_tile(w1s, C::W1P, w1 + static_cast<size_t>(k0) * Cm + c0, Cm, KS, BN, C1 - k0,
                Cm - c0, v);
      __syncthreads();
      h.mma(xs + wm * 16 * C::XP, C::XP, w1s + wn * C::HC, C::W1P, KS, C::HC);
      __syncthreads();
    }
    // epilogue of h: each element of hs is read and written by its owner only
    h.each([&](int r, int c, float acc) {
      const int row = wm * 16 + r, col = wn * C::HC + c, gc = c0 + col;
      const bool in = gc < Cm;
      float t = __fadd_rn(__fmul_rn(acc, in ? __ldg(s1 + gc) : 0.f), in ? __ldg(b1 + gc) : 0.f);
      if (RES) t = __fadd_rn(t, to_f(hs[row * C::HP + col]));
      hs[row * C::HP + col] = from_f<T>(relu(t));
    });
    __syncthreads();
    if (MID && blockIdx.y == 0)
      store_tile(mid + static_cast<size_t>(r0) * Cm + c0, Cm, hs, C::HP, BM, BN, rlim, Cm - c0,
                 v);
    for (int kk = 0; kk < BN && c0 + kk < Cm; kk += KS) {
      load_tile(w2s, C::W2P, w2 + static_cast<size_t>(c0 + kk) * Cout + n0, Cout, KS, C::NMAX,
                Cm - c0 - kk, Cout - n0, v);
      __syncthreads();
      y.mma(hs + wm * 16 * C::HP + kk, C::HP, w2s + wn * C::YC, C::W2P, KS, ycols);
      __syncthreads();
    }
  }
  y.each([&](int r, int c, float acc) {
    const int row = r0 + wm * 16 + r, col = n0 + wn * C::YC + c;
    if (row < M && col < Cout) {
      const float t = __fadd_rn(__fmul_rn(acc, __ldg(s2 + col)), __ldg(b2 + col));
      out[static_cast<size_t>(row) * Cout + col] = from_f<T>(relu(t));
    }
  });
}

struct Args {
  const void *x, *res, *w1, *w2;
  const float *s1, *b1, *s2, *b2;
  void *mid, *out;
  int M, C1, Cm, Cout;
};

inline bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int BM, bool RES, bool MID>
cudaError_t launch_one(const Args& a, cudaStream_t st) {
  typedef Cfg<T, BM> C;
  auto kern = conv1x1_pair_kernel<T, BM, RES, MID>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / sizeof(T);
  const int vec = aligned16(a.x) && aligned16(a.res) && aligned16(a.w1) && aligned16(a.w2) &&
                  aligned16(a.mid) && a.C1 % V == 0 && a.Cm % V == 0 && a.Cout % V == 0;
  const dim3 grid((a.M + BM - 1) / BM, (a.Cout + C::NMAX - 1) / C::NMAX);
  kern<<<grid, kThreads, C::kSmem, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res), static_cast<const T*>(a.w1),
      static_cast<const T*>(a.w2), a.s1, a.b1, a.s2, a.b2, static_cast<T*>(a.mid),
      static_cast<T*>(a.out), a.M, a.C1, a.Cm, a.Cout, vec);
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t launch_variant(int variant, const Args& a, cudaStream_t st) {
  if (variant == 0) return launch_one<T, BM, false, false>(a, st);
  if (variant == 1) return launch_one<T, BM, true, false>(a, st);
  return launch_one<T, BM, true, true>(a, st);
}

// Rows of a block's tile: as many as keep 64 y accumulators a thread.
int block_rows(int cout) { return cout <= 128 ? 128 : cout <= 256 ? 64 : 32; }

template <typename T>
cudaError_t launch_dtype(int variant, const Args& a, cudaStream_t st) {
  switch (block_rows(a.Cout)) {
    case 128: return launch_variant<T, 128>(variant, a, st);
    case 64: return launch_variant<T, 64>(variant, a, st);
    default: return launch_variant<T, 32>(variant, a, st);
  }
}

template <typename T> size_t smem_of(int bm) {
  return bm == 128 ? Cfg<T, 128>::kSmem : bm == 64 ? Cfg<T, 64>::kSmem : Cfg<T, 32>::kSmem;
}

}  // namespace

extern "C" {

// dtype 0: float, 1: bfloat16 (x, res, w1, w2, mid, out all of it); the
// affines are f32 (Cm,) and (Cout,). variant 0: no residual; 1: residual
// (M, Cm); 2: residual and mid (M, Cm) written. All contiguous row-major on
// the device. Launches on `stream` without synchronising and returns
// cudaGetLastError() (cudaErrorInvalidValue for a bad dtype, variant or an
// empty shape).
int mxtt_conv1x1_pair(int dtype, int variant, const void* x, const void* res, const void* w1,
                      const void* w2, const void* s1, const void* b1, const void* s2,
                      const void* b2, void* mid, void* out, int M, int C1, int Cm, int Cout,
                      void* stream) {
  if (dtype < 0 || dtype > 1 || variant < 0 || variant > 2 || M < 1 || C1 < 1 || Cm < 1 ||
      Cout < 1 || (variant > 0 && res == nullptr) || (variant == 2 && mid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, res, w1, w2,
               static_cast<const float*>(s1), static_cast<const float*>(b1),
               static_cast<const float*>(s2), static_cast<const float*>(b2),
               mid, out, M, C1, Cm, Cout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_dtype<float>(variant, a, st) : launch_dtype<bf16>(variant, a, st);
  return static_cast<int>(err);
}

// Rows of a block's tile for `cout` output channels.
int mxtt_conv1x1_block_rows(int cout) { return block_rows(cout); }

// Dynamic shared memory of one block (dtype 0 f32, 1 bf16) at `cout`.
long long mxtt_conv1x1_smem_bytes(int dtype, int cout) {
  const int bm = block_rows(cout);
  return static_cast<long long>(dtype == 0 ? smem_of<float>(bm) : smem_of<bf16>(bm));
}

const char* mxtt_conv1x1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
