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
//  * a block's tile of y is 64 rows by the narrowest of 64, 128 or 256
//    columns that covers Cout, else 32 rows by 512 columns, with a grid
//    dimension over 512-column slabs of Cout (which recomputes h). Each warp
//    owns 16 rows: a 16 x (columns / WN) slab of y and a 16 x (64 / WN) slab
//    of the h chunk, WN = 8 warps / (rows / 16). A thread thus holds at most
//    64 y and 16 h accumulators, which the 128 registers that two blocks an
//    SM allow hold without spilling (128-row tiles, whose warps hold 32 h
//    accumulators, spilled);
//  * the grid fills the card: where row tiles x Cout slabs give fewer
//    blocks than the card has SMs (ResNet-50's last two stages: 98 and 49),
//    a third grid dimension splits Cm into S slices of whole 64-wide chunks
//    (the last may be ragged; the wrapper picks S, `split_plan`). A block
//    computes h over the full C1 for its slice (and writes its slice of the
//    mid) and writes its partial y, in f32 before the affine, to a
//    workspace (S, M, Cout); conv1x1_pair_reduce_kernel then sums the S
//    partials in slice order and applies s2, b2, relu and the rounding. No
//    atomics, so two calls give bitwise equal outputs. At S = 1 the block
//    writes y itself;
//  * the block's x tile (BM x C1, zero-filled to a multiple of 16 columns)
//    is loaded once into shared memory and stays there wherever it fits
//    beside the other tiles; else x streams with w1 (layout_of);
//  * the weight slabs (w1: KS1 x 64; w2: KS2 x the tile's columns; 16 KB
//    each in bf16, KS1 = 128, and 8 KB in f32, KS1 = 32; with x streaming,
//    the x slab beside w1's) arrive by 16-byte cp.async through a ring of 3
//    stages (2 where only 2 let two blocks share an SM), issued two slabs
//    ahead of the products that use them: one barrier a slab, with loads in
//    flight behind it. bf16 takes the residual chunk the same way, into the
//    chunk's h buffer (two, by chunk parity, so the next chunk's residual
//    lands while this one's h is read); f32 reads it in the epilogue,
//    prefetched into L2, which saves the second buffer and keeps its tiles
//    small enough for two blocks an SM. Everything is zero-filled past the
//    edge of M, C1, Cm and Cout by the copy's src-size 0, so any shape is
//    taken and nothing is padded in device memory (the TPU kernel pads M to
//    block_rows; `block_rows` changes nothing here);
//  * bf16 uses the tensor cores through mma.sync m16n8k16 with f32
//    accumulators (ldmatrix from shared memory, rows padded by 16 bytes so
//    the eight rows of a matrix hit eight bank groups); f32 uses CUDA-core
//    FMAs, each thread an 8-row patch, reading both operands from shared
//    memory;
//  * device loads are 16-byte cp.async when every pointer is 16-byte
//    aligned and every channel count a multiple of 16 bytes, else scalar
//    loads stored to the same ring, with no overlap.
// Known weaknesses: f32 runs on CUDA-core FMAs, at most 67 TFLOP/s, where
// bf16 has the tensor cores (3xTF32 mma.sync would take it there); every
// row tile reads its slice of both weight matrices again from L2 (at stage
// 4, 49 row tiles read 4 MB each, 196 MB a launch), which a larger row tile
// or a cluster sharing the weight slabs would cut; mma.sync, not wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;          // 8 warps
constexpr int BN = 64;                 // width of a Cm chunk
constexpr size_t kSmemMax = 232448;    // dynamic shared memory a block may use
constexpr size_t kSmemHalf = 115712;   // the most that lets two blocks share an SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// relu as jnp.maximum(v, 0) and torch.relu give it: NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

template <typename T> struct Pad { static constexpr int value = 16 / sizeof(T); };

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[r * dp + c] = src[r * sp + c] for r < rows, c < cols, zero where
// r >= rlim or c >= clim. cols is a multiple of V = 16 / sizeof(T); dst and
// dp keep 16-byte alignment. vec (every channel count a multiple of V and
// every pointer 16-byte aligned): 16-byte cp.async, to be waited for;
// else scalar loads and stores.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dp, const T* __restrict__ src, size_t sp,
                                          int rows, int cols, int rlim, int clim, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
#pragma unroll 1
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * V;
    T* d = dst + r * dp + c;
    const T* s = src + static_cast<size_t>(r) * sp + c;
    if (vec) {
      const bool in = r < rlim && c < clim;  // clim is a multiple of V
      cp_async16(d, in ? s : src, in);
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

// A block's tile: BM rows of x and y, NMAX columns of y.
template <typename T, int BM, int NMAX_> struct Cfg {
  static constexpr int NMAX = NMAX_;
  static constexpr int WM = BM / 16;          // warps along rows
  static constexpr int WN = 8 / WM;           // warps along columns
  static constexpr int YC = NMAX / WN;        // y columns of one warp
  static constexpr int HC = BN / WN;          // h columns of one warp
  static constexpr int P = Pad<T>::value;     // row padding, 16 bytes
  // one weight slab: 16 KB in bf16; 8 KB in f32, whose products do more
  // work a slab and whose smaller tiles let two blocks share an SM
  static constexpr int E = (sizeof(T) == 2 ? 16384 : 8192) / sizeof(T);
  static constexpr int KS1 = E / BN;          // depth of a w1 (and streamed x) slab
  static constexpr int KS2 = E / NMAX < BN ? E / NMAX : BN;  // depth of a w2 slab
  static constexpr int W1P = BN + P, W2P = NMAX + P, HP = BN + P, XSP = KS1 + P;
  static constexpr int KW = KS1 * W1P > KS2 * W2P ? KS1 * W1P : KS2 * W2P;  // a weight slab
  static constexpr int KQ = sizeof(T) == 2 ? 16 : 1;  // depth granule of a product
  // h buffers: bf16 takes the residual chunk by cp.async into the chunk's
  // buffer, two by chunk parity (the next chunk's lands while this one's h
  // is read); f32 reads it in the epilogue, which keeps its larger tiles
  // small enough for two blocks an SM
  static constexpr int HB = sizeof(T) == 2 ? 2 : 1;
  static_assert(YC % 16 == 0 && YC <= 128, "a warp holds a 16 x YC slab of y");
  static_assert(KS2 % KQ == 0 && BN % KS2 == 0, "w2 slabs tile a chunk");

  // pitch of the resident x tile: C1 zero-filled to a multiple of 16
  __host__ __device__ static int xrp(int C1) { return round16(C1) + P; }
  // elements of one ring stage
  __host__ __device__ static int stage(bool xres) { return KW + (xres ? 0 : BM * XSP); }
  __host__ __device__ static size_t smem(int C1, bool xres, int stages) {
    return (HB * BM * HP + (xres ? static_cast<size_t>(BM) * xrp(C1) : 0) +
            static_cast<size_t>(stages) * stage(xres)) * sizeof(T);
  }
};

// Shared-memory layout of a launch: the first of (x resident, 3 ring
// stages), (resident, 2), (x streamed, 3), (streamed, 2) that lets two
// blocks share an SM, else the first that fits one block.
struct Layout {
  bool xres;
  int stages;
  size_t smem;
};

template <typename T, int BM, int NMAX>
Layout layout_of(int C1) {
  typedef Cfg<T, BM, NMAX> C;
  const Layout options[4] = {{true, 3, C::smem(C1, true, 3)},
                             {true, 2, C::smem(C1, true, 2)},
                             {false, 3, C::smem(C1, false, 3)},
                             {false, 2, C::smem(C1, false, 2)}};
  for (const size_t limit : {kSmemHalf, kSmemMax})
    for (const Layout& l : options)
      if (l.smem <= limit) return l;
  return options[3];  // too large: the launch refuses it
}

// One block per (BM-row tile of x, NMAX-column slab of y, slice of Cm).
// ws: null where the grid has one slice (y written here), else the
// (S, M, Cout) f32 workspace of partial y.
template <typename T, int BM, int NMAX, bool RES, bool MID>
__global__ void __launch_bounds__(kThreads, 2)
    conv1x1_pair_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const T* __restrict__ w1, const T* __restrict__ w2,
                        const float* __restrict__ s1, const float* __restrict__ b1,
                        const float* __restrict__ s2, const float* __restrict__ b2,
                        T* __restrict__ mid, T* __restrict__ out, float* __restrict__ ws, int M,
                        int C1, int Cm, int Cout, int slice_chunks, int xres, int stages,
                        int vec) {
  typedef Cfg<T, BM, NMAX> C;
  extern __shared__ uint4 smem_raw[];
  T* hbuf = reinterpret_cast<T*>(smem_raw);  // HB x (BM x BN): [a chunk's residual, then] its h
  T* ring = hbuf + C::HB * BM * C::HP;       // stages x (weight slab [, x slab])
  T* xr = ring + stages * C::stage(xres);    // BM x xrp: the resident x tile
  const int stage = C::stage(xres);
  const int xrp = C::xrp(C1);

  const int warp = threadIdx.x >> 5;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * C::NMAX;
  const int rlim = M - r0;
  const int ycols = min(C::NMAX, Cout - n0) - wn * C::YC;  // this warp's real y columns
  const bool v = vec != 0;
  const int cbeg = blockIdx.z * slice_chunks * BN;         // the slice's first Cm column
  const int nchunks = min(slice_chunks, (Cm - cbeg + BN - 1) / BN);
  const int n1 = (C1 + C::KS1 - 1) / C::KS1;               // w1 slabs a chunk
  const int per = n1 + BN / C::KS2;                        // and w2 slabs
  const int total = nchunks * per;

  // the loads of slab s into ring stage s % stages, one commit group each
  auto issue = [&](int s) {
    if (s < total) {
      const int c = s / per, j = s - c * per;
      const int c0 = cbeg + c * BN;
      T* st = ring + (s % stages) * stage;
      if (RES && j == 0 && C::HB == 2)  // the chunk's residual, into its h buffer
        load_tile(hbuf + (c & 1) * BM * C::HP, C::HP, res + static_cast<size_t>(r0) * Cm + c0,
                  Cm, BM, BN, rlim, Cm - c0, v);
      if (RES && j == 0 && C::HB == 1 && threadIdx.x < min(BM, rlim))  // into L2
        for (int e = 0; e < BN && c0 + e < Cm; e += 128 / sizeof(T))   // 128-byte lines
          prefetch_l2(res + static_cast<size_t>(r0 + threadIdx.x) * Cm + c0 + e);
      if (j < n1) {
        const int k0 = j * C::KS1;
        load_tile(st, C::W1P, w1 + static_cast<size_t>(k0) * Cm + c0, Cm, C::KS1, BN, C1 - k0,
                  Cm - c0, v);
        if (!xres)
          load_tile(st + C::KW, C::XSP, x + static_cast<size_t>(r0) * C1 + k0, C1, BM, C::KS1,
                    rlim, C1 - k0, v);
      } else {
        const int kk = (j - n1) * C::KS2;
        load_tile(st, C::W2P, w2 + static_cast<size_t>(c0 + kk) * Cout + n0, Cout, C::KS2,
                  C::NMAX, Cm - c0 - kk, Cout - n0, v);
      }
    }
    cp_async_commit();
  };

  if (xres)
    load_tile(xr, xrp, x + static_cast<size_t>(r0) * C1, C1, BM, round16(C1), rlim, C1, v);
  for (int s = 0; s < stages - 1; ++s) issue(s);

  // wait for slab s, then put slab s + stages - 1 in flight behind it
  auto next = [&](int s) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // slab s has landed; every warp is done with slab s - 1
    issue(s + stages - 1);
    return ring + (s % stages) * stage;
  };

  Frag<T, C::YC> y;
  y.zero();
  for (int c = 0, s = 0; c < nchunks; ++c) {
    const int c0 = cbeg + c * BN;
    T* hs = hbuf + (c & (C::HB - 1)) * BM * C::HP;
    Frag<T, C::HC> h;  // dead outside this chunk's w1 slabs
    h.zero();
    for (int k0 = 0; k0 < C1; k0 += C::KS1, ++s) {  // h += x[:, k0:] @ w1 slab
      const T* st = next(s);
      const T* xa = xres ? xr + wm * 16 * xrp + k0 : st + C::KW + wm * 16 * C::XSP;
      h.mma(xa, xres ? xrp : C::XSP, st + wn * C::HC, C::W1P,
            min(C::KS1, (C1 - k0 + C::KQ - 1) / C::KQ * C::KQ), C::HC);
    }
    // epilogue of h: each element of hs is read and written by its owner
    // only (with one buffer, the last chunk's h is no longer read: a
    // barrier has passed since its last w2 slab)
    h.each([&](int r, int cc, float acc) {
      const int row = wm * 16 + r, col = wn * C::HC + cc, gc = c0 + col;
      const bool in = gc < Cm;
      float t = __fadd_rn(__fmul_rn(acc, in ? __ldg(s1 + gc) : 0.f), in ? __ldg(b1 + gc) : 0.f);
      if (RES && C::HB == 2) t = __fadd_rn(t, to_f(hs[row * C::HP + col]));
      if (RES && C::HB == 1 && in && row < rlim)
        t = __fadd_rn(t, to_f(res[static_cast<size_t>(r0 + row) * Cm + gc]));
      hs[row * C::HP + col] = from_f<T>(relu(t));
    });
    for (int kk = 0; kk < BN; kk += C::KS2, ++s) {  // y += h[:, kk:] @ w2 slab
      const T* st = next(s);
      if (MID && blockIdx.y == 0 && kk == 0)
        store_tile(mid + static_cast<size_t>(r0) * Cm + c0, Cm, hs, C::HP, BM, BN, rlim,
                   Cm - c0, v);
      const int rem = Cm - c0 - kk;
      if (rem > 0)
        y.mma(hs + wm * 16 * C::HP + kk, C::HP, st + wn * C::YC, C::W2P,
              min(C::KS2, (rem + C::KQ - 1) / C::KQ * C::KQ), ycols);
    }
  }
  cp_async_wait<0>();
  y.each([&](int r, int cc, float acc) {
    const int row = r0 + wm * 16 + r, col = n0 + wn * C::YC + cc;
    if (row < M && col < Cout) {
      const size_t i = static_cast<size_t>(row) * Cout + col;
      if (ws != nullptr) {
        ws[static_cast<size_t>(blockIdx.z) * M * Cout + i] = acc;
      } else {
        const float t = __fadd_rn(__fmul_rn(acc, __ldg(s2 + col)), __ldg(b2 + col));
        out[i] = from_f<T>(relu(t));
      }
    }
  });
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// out = relu((ws[0] + ws[1] + ... + ws[S - 1]) * s2 + b2), rounded to T,
// summed in slice order. Four outputs a thread where Cout % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv1x1_pair_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ s2,
                               const float* __restrict__ b2, T* __restrict__ out, int M, int Cout,
                               int S) {
  const size_t n = static_cast<size_t>(M) * Cout;
  const size_t step = static_cast<size_t>(gridDim.x) * kThreads;
  if (Cout % 4 == 0) {
    for (size_t i = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * 4; i < n;
         i += step * 4) {
      float4 a = *reinterpret_cast<const float4*>(ws + i);
      for (int z = 1; z < S; ++z) {
        const float4 b = *reinterpret_cast<const float4*>(ws + z * n + i);
        a.x = __fadd_rn(a.x, b.x);
        a.y = __fadd_rn(a.y, b.y);
        a.z = __fadd_rn(a.z, b.z);
        a.w = __fadd_rn(a.w, b.w);
      }
      const int col = static_cast<int>(i % Cout);
      const float acc[4] = {a.x, a.y, a.z, a.w};
      float r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = relu(__fadd_rn(__fmul_rn(acc[q], __ldg(s2 + col + q)), __ldg(b2 + col + q)));
      store4(out + i, r);
    }
  } else {
    for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) {
      float a = ws[i];
      for (int z = 1; z < S; ++z) a = __fadd_rn(a, ws[z * n + i]);
      const int col = static_cast<int>(i % Cout);
      out[i] = from_f<T>(relu(__fadd_rn(__fmul_rn(a, __ldg(s2 + col)), __ldg(b2 + col))));
    }
  }
}

struct Args {
  const void *x, *res, *w1, *w2;
  const float *s1, *b1, *s2, *b2;
  void *mid, *out;
  float* ws;
  int M, C1, Cm, Cout, slices;
};

inline bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int BM, int NMAX, bool RES, bool MID>
cudaError_t launch_one(const Args& a, cudaStream_t st) {
  auto kern = conv1x1_pair_kernel<T, BM, NMAX, RES, MID>;
  const Layout l = layout_of<T, BM, NMAX>(a.C1);
  if (l.smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / sizeof(T);
  const int vec = aligned16(a.x) && aligned16(a.res) && aligned16(a.w1) && aligned16(a.w2) &&
                  aligned16(a.mid) && a.C1 % V == 0 && a.Cm % V == 0 && a.Cout % V == 0;
  const int chunks = (a.Cm + BN - 1) / BN;
  const int slice_chunks = (chunks + a.slices - 1) / a.slices;
  // every slice holds at least one chunk, and one slice writes y itself
  if ((a.slices - 1) * slice_chunks >= chunks || (a.slices > 1) != (a.ws != nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((a.M + BM - 1) / BM, (a.Cout + NMAX - 1) / NMAX, a.slices);
  kern<<<grid, kThreads, l.smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res), static_cast<const T*>(a.w1),
      static_cast<const T*>(a.w2), a.s1, a.b1, a.s2, a.b2, static_cast<T*>(a.mid),
      static_cast<T*>(a.out), a.ws, a.M, a.C1, a.Cm, a.Cout, slice_chunks, l.xres, l.stages,
      vec);
  return cudaGetLastError();
}

template <typename T, int BM, int NMAX>
cudaError_t launch_variant(int variant, const Args& a, cudaStream_t st) {
  if (variant == 0) return launch_one<T, BM, NMAX, false, false>(a, st);
  if (variant == 1) return launch_one<T, BM, NMAX, true, false>(a, st);
  return launch_one<T, BM, NMAX, true, true>(a, st);
}

// The block tiles (rows x columns): 64 x 64, 64 x 128, 64 x 256, 32 x 512.
// A warp then holds at most 16 x 32 of h and 16 x 128 of y (80
// accumulators), which the 128 registers of two blocks an SM leave room for
// without spilling; 128-row tiles (a warp's h 16 x 64) spilled.
bool valid_tile(int rows, int cols) {
  return (rows == 64 && (cols == 64 || cols == 128 || cols == 256)) ||
         (rows == 32 && cols == 512);
}

template <typename T>
cudaError_t launch_dtype(int variant, int cols, const Args& a, cudaStream_t st) {
  switch (cols) {
    case 64: return launch_variant<T, 64, 64>(variant, a, st);
    case 128: return launch_variant<T, 64, 128>(variant, a, st);
    case 256: return launch_variant<T, 64, 256>(variant, a, st);
    default: return launch_variant<T, 32, 512>(variant, a, st);
  }
}

template <typename T> Layout layout_tile(int cols, int c1) {
  return cols == 64    ? layout_of<T, 64, 64>(c1)
         : cols == 128 ? layout_of<T, 64, 128>(c1)
         : cols == 256 ? layout_of<T, 64, 256>(c1)
                       : layout_of<T, 32, 512>(c1);
}

}  // namespace

extern "C" {

// dtype 0: float, 1: bfloat16 (x, res, w1, w2, mid, out all of it); the
// affines are f32 (Cm,) and (Cout,). variant 0: no residual; 1: residual
// (M, Cm); 2: residual and mid (M, Cm) written. All contiguous row-major on
// the device. block_rows x block_cols: a block's tile of y, one of
// valid_tile's; slices: S, the Cm slices of the grid, each a whole
// number of 64-wide chunks and none empty; ws: null at S = 1, else an f32
// (S, M, Cout) workspace that mxtt_conv1x1_pair_reduce then turns into out.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad dtype, variant, tile, split or an empty
// shape).
int mxtt_conv1x1_pair(int dtype, int variant, const void* x, const void* res, const void* w1,
                      const void* w2, const void* s1, const void* b1, const void* s2,
                      const void* b2, void* mid, void* out, void* ws, int M, int C1, int Cm,
                      int Cout, int block_rows, int block_cols, int slices, void* stream) {
  if (dtype < 0 || dtype > 1 || variant < 0 || variant > 2 || M < 1 || C1 < 1 || Cm < 1 ||
      Cout < 1 || slices < 1 || !valid_tile(block_rows, block_cols) ||
      (variant > 0 && res == nullptr) || (variant == 2 && mid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, res, w1, w2,
               static_cast<const float*>(s1), static_cast<const float*>(b1),
               static_cast<const float*>(s2), static_cast<const float*>(b2),
               mid, out, static_cast<float*>(ws), M, C1, Cm, Cout, slices};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_dtype<float>(variant, block_cols, a, st)
                                     : launch_dtype<bf16>(variant, block_cols, a, st);
  return static_cast<int>(err);
}

// out (M, Cout) of dtype 0 f32 or 1 bf16 from the (S, M, Cout) partial y
// of mxtt_conv1x1_pair: summed in slice order, then the affine, relu and
// the rounding. Same conventions.
int mxtt_conv1x1_pair_reduce(int dtype, const void* ws, const void* s2, const void* b2, void* out,
                             int M, int Cout, int slices, void* stream) {
  if (dtype < 0 || dtype > 1 || M < 1 || Cout < 1 || slices < 2 || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t items = static_cast<size_t>(M) * Cout / (Cout % 4 == 0 ? 4 : 1);
  const unsigned blocks =
      static_cast<unsigned>(items / kThreads + 1 < 8192 ? items / kThreads + 1 : 8192);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  const float* sc = static_cast<const float*>(s2);
  const float* bi = static_cast<const float*>(b2);
  if (dtype == 0)
    conv1x1_pair_reduce_kernel<float><<<blocks, kThreads, 0, st>>>(
        w, sc, bi, static_cast<float*>(out), M, Cout, slices);
  else
    conv1x1_pair_reduce_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        w, sc, bi, static_cast<bf16*>(out), M, Cout, slices);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block (dtype 0 f32, 1 bf16) of the tile
// block_rows x block_cols at C1 input channels; x_resident and stages get
// the layout's choice.
long long mxtt_conv1x1_smem_bytes(int dtype, int block_rows, int block_cols, int c1,
                                  int* x_resident, int* stages) {
  if (!valid_tile(block_rows, block_cols) || c1 < 1) return -1;
  const Layout l =
      dtype == 0 ? layout_tile<float>(block_cols, c1) : layout_tile<bf16>(block_cols, c1);
  if (x_resident) *x_resident = l.xres;
  if (stages) *stages = l.stages;
  return static_cast<long long>(l.smem);
}

const char* mxtt_conv1x1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
