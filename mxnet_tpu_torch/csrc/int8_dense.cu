// int8 x int8 -> int32 fully-connected layer, written by hand for Hopper (sm_90a).
//
// Replaces the accelerator branch of mxnet_tpu/ops/nn.py's quantized_dense
// (lines 944-953, `int8_dot`), which the TPU ran as XLA's int8 dot on its
// matrix unit. It answers no pl.pallas_call: the JAX package has no Pallas
// kernel for this product. Per row of x (M, U) f32, against a pre-quantized
// weight w (O, U) int8 with per-output-channel scales s (O,) f32:
//
//   sx[m]    = max(max_u |x[m, u]| / 127, 1e-8)              (IEEE division)
//   xq[m, u] = clamp(round_half_even(x[m, u] / sx[m]), -127, 127)   int8
//   acc[m,o] = sum_u xq[m, u] * w[o, u]                       int32, exact
//   out[m,o] = ((float)acc * sx[m]) * s[o] (+ bias[o])
//
// The epilogue is done op by op (__fmul_rn, __fadd_rn: no contraction into
// an FMA) and the divisions with __fdiv_rn, so with exact int32 sums the
// result equals the plain version's (ops/hopper/int8_dense.py) bit for bit.
// Never build this file with --use_fast_math.
//
// Three kernels, one call of the wrapper:
//  K1 int8_quantize_rows_kernel: one block a row of x; the row's max |x| by
//     a block reduction, then xq, zero-filled from U to Up = U rounded up
//     to 64 bytes, so the product reads whole 64-byte chunks of xq;
//  K2 int8_dense_kernel: a block's tile is BM rows x BN output channels over
//     one slice of U, in 64-byte chunks through a ring of STAGES shared
//     memory stages filled by 16-byte cp.async (the weight's ragged edge,
//     and rows past M, zero-filled by the copy's src-size 0). Each chunk is
//     two mma.sync.m16n8k32 s8 x s8 -> s32 products a warp tile. The weight
//     (O, U) row-major is already the .col B operand. A thread reads its
//     fragments as one 16-byte shared load a row: thread t of a quad takes
//     bytes [16 t, 16 t + 16) of the chunk, the first 8 for the first
//     product and the last 8 for the second. That permutes the k index
//     inside a chunk, the same way for xq and w, which leaves every dot
//     product as it is. Rows are 64 bytes apart, so the 8 lanes of a
//     quarter warp read 128 contiguous bytes: no bank conflict;
//  K3 int8_dense_reduce_kernel: where the tiles alone leave SMs idle (the
//     decode projections at M <= 20, k/v at O = 1024) the wrapper splits U
//     into S slices of whole chunks; each block writes its int32 partial to
//     a workspace (S, M, O) and K3 sums the slices in order and applies the
//     epilogue. int32 sums are exact in any order, so a split changes no
//     bit, and with no atomics nothing needs zeroing.
// Nothing is allocated and nothing is read back to the host: a call can be
// captured in a CUDA graph.
//
// Bound. At decode (M <= 20) the call is a weight stream, O x U bytes at
// 3.35 TB/s; the grid (split_plan in the wrapper) aims at 2 blocks of
// BM = 16 an SM, each with up to 3 stages of copies in flight. At
// prefill (M = 256-1024) the product is bound by int8 operations (1,979
// TOP/s dense on an H100 SXM), of which mma.sync reaches a part: a wgmma
// kernel is later work.
//
// Tiles: BM = 16 (decode and the verify pass), 64 (M <= 256) and 128.
//  16 x 64,   4 warps as 1 x 4, 4 stages: a warp 16 x 16 (2 n-tiles);
//  64 x 128,  4 warps as 2 x 2, 3 stages: a warp 32 x 64 (2 x 8 tiles);
//  128 x 128, 8 warps as 4 x 2, 3 stages: a warp 32 x 64.
// A warp of the larger tiles holds 64 int32 accumulators.
//
// Loads: the weight streams by 16-byte cp.async when U is a multiple of 16
// and the weight's pointer 16-byte aligned (wvec), else by byte loads stored
// to the same ring (a ragged or misaligned weight: correct, not fast). x is
// read as float4 when U is a multiple of 4 and its pointer 16-byte aligned,
// else as floats; xq is the wrapper's own padded buffer, always aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;          // bytes of U a chunk
constexpr int kQThreads = 256;   // K1's block
constexpr int kRThreads = 256;   // K3's block

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += A (16 x 32, row) . B (32 x 8, col), s8 x s8 -> s32
__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ signed char quantize(float v, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(r));
}

// ((float)acc * sx) * s (+ bias), rounded after each operation
__device__ __forceinline__ float rescale(int acc, float sxm, float so, const float* bias, int o) {
  const float r = __fmul_rn(__fmul_rn(__int2float_rn(acc), sxm), so);
  return bias ? __fadd_rn(r, bias[o]) : r;
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// K1: one block a row of x (M, U); xq (M, Up), sx (M,)
__global__ void __launch_bounds__(kQThreads)
    int8_quantize_rows_kernel(const float* __restrict__ x, signed char* __restrict__ xq,
                              float* __restrict__ sx, int U, int Up, int vec) {
  const int m = blockIdx.x;
  const float* row = x + static_cast<size_t>(m) * U;
  const float4* row4 = reinterpret_cast<const float4*>(row);
  float amax = 0.f;
  if (vec) {
    for (int i = threadIdx.x; i < U / 4; i += kQThreads) amax = fmaxf(amax, abs_max4(row4[i]));
  } else {
    for (int i = threadIdx.x; i < U; i += kQThreads) amax = fmaxf(amax, fabsf(row[i]));
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float part[kQThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int i = 1; i < kQThreads / 32; ++i) amax = fmaxf(amax, part[i]);
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  if (threadIdx.x == 0) sx[m] = scale;
  signed char* q = xq + static_cast<size_t>(m) * Up;
  if (vec) {  // U and Up multiples of 4: a group of 4 lies wholly inside or past U
    for (int i = threadIdx.x; i < Up / 4; i += kQThreads) {
      char4 c = make_char4(0, 0, 0, 0);
      if (4 * i < U) {
        const float4 v = row4[i];
        c = make_char4(quantize(v.x, scale), quantize(v.y, scale), quantize(v.z, scale),
                       quantize(v.w, scale));
      }
      reinterpret_cast<char4*>(q)[i] = c;
    }
  } else {
    for (int i = threadIdx.x; i < Up; i += kQThreads) q[i] = i < U ? quantize(row[i], scale) : 0;
  }
}

template <int BM, int BN, int WM, int WN, int STAGES>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kTM = BM / WM, kTN = BN / WN;  // a warp's tile
  static constexpr int kMT = kTM / 16, kNT = kTN / 8;  // its mma tiles
  static constexpr int kStage = (BM + BN) * kBK;
  static constexpr int kSmem = STAGES * kStage;
  static_assert(kTM % 16 == 0 && kTN % 8 == 0, "warp tile");
  static_assert(kSmem <= 48 * 1024, "no opt-in shared memory");
};

// K2: out (or the slice's int32 partial in ws) of the block's BM x BN tile
template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM* WN * 32)
    int8_dense_kernel(const signed char* __restrict__ xq, const float* __restrict__ sx,
                      const signed char* __restrict__ w, const float* __restrict__ s,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int* __restrict__ ws, int M, int O, int U, int Up, int cps, int wvec) {
  using T = Tile<BM, BN, WM, WN, STAGES>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int o0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int kbeg = z * cps;
  const int kend = min(kbeg + cps, Up / kBK);
  const int n = kend - kbeg;

  auto load = [&](int st, int chunk) {
    unsigned char* a = smem + st * T::kStage;
    unsigned char* b = a + BM * kBK;
    const int k0 = chunk * kBK;
    for (int i = threadIdx.x; i < BM * 4; i += T::kThreads) {
      const int r = i >> 2, c = (i & 3) * 16;
      const bool in = m0 + r < M;
      cp_async16(a + r * kBK + c, in ? xq + static_cast<size_t>(m0 + r) * Up + k0 + c : xq, in);
    }
    for (int i = threadIdx.x; i < BN * 4; i += T::kThreads) {
      const int r = i >> 2, c = (i & 3) * 16;
      const int o = o0 + r, k = k0 + c;
      const signed char* src = w + static_cast<size_t>(o) * U + k;
      if (wvec) {  // U % 16 == 0: a 16-byte piece lies wholly inside or past U
        const bool in = o < O && k < U;
        cp_async16(b + r * kBK + c, in ? src : w, in);
      } else {
        unsigned v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          unsigned word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = k + 4 * q + j;
            const unsigned byte =
                (o < O && kk < U) ? static_cast<unsigned char>(src[4 * q + j]) : 0u;
            word |= byte << (8 * j);
          }
          v[q] = word;
        }
        *reinterpret_cast<uint4*>(b + r * kBK + c) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  int acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n) load(st, kbeg + st);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk j landed; every warp is done with chunk j - 1's stage
    if (j + STAGES - 1 < n) load((j + STAGES - 1) % STAGES, kbeg + j + STAGES - 1);
    cp_async_commit();
    const unsigned char* a =
        smem + (j % STAGES) * T::kStage + (wm * T::kTM + g) * kBK + t * 16;
    const unsigned char* b = smem + (j % STAGES) * T::kStage + BM * kBK +
                             (wn * T::kTN + g) * kBK + t * 16;
    uint4 af[T::kMT][2];
#pragma unroll
    for (int i = 0; i < T::kMT; ++i) {
      af[i][0] = *reinterpret_cast<const uint4*>(a + (16 * i) * kBK);
      af[i][1] = *reinterpret_cast<const uint4*>(a + (16 * i + 8) * kBK);
    }
#pragma unroll
    for (int jn = 0; jn < T::kNT; ++jn) {
      const uint4 bf = *reinterpret_cast<const uint4*>(b + (8 * jn) * kBK);
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        mma_s8(acc[i][jn], af[i][0].x, af[i][1].x, af[i][0].y, af[i][1].y, bf.x, bf.y);
        mma_s8(acc[i][jn], af[i][0].z, af[i][1].z, af[i][0].w, af[i][1].w, bf.z, bf.w);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int jn = 0; jn < T::kNT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * T::kTM + 16 * i + g + (e >> 1) * 8;
        const int o = o0 + wn * T::kTN + 8 * jn + 2 * t + (e & 1);
        if (m >= M || o >= O) continue;
        if (ws)
          ws[(static_cast<size_t>(z) * M + m) * O + o] = acc[i][jn][e];
        else
          out[static_cast<size_t>(m) * O + o] = rescale(acc[i][jn][e], sx[m], s[o], bias, o);
      }
}

// K3: out = the rescaled sum of the S int32 partials, in slice order
__global__ void __launch_bounds__(kRThreads)
    int8_dense_reduce_kernel(const int* __restrict__ ws, const float* __restrict__ sx,
                             const float* __restrict__ s, const float* __restrict__ bias,
                             float* __restrict__ out, int M, int O, int S) {
  const size_t items = static_cast<size_t>(M) * O;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kRThreads + threadIdx.x; i < items;
       i += static_cast<size_t>(gridDim.x) * kRThreads) {
    int v = 0;
    for (int z = 0; z < S; ++z) v += ws[z * items + i];
    const int m = static_cast<int>(i / O), o = static_cast<int>(i % O);
    out[i] = rescale(v, sx[m], s[o], bias, o);
  }
}

template <int BM, int BN, int WM, int WN, int STAGES>
cudaError_t launch_tile(const signed char* xq, const float* sx, const signed char* w,
                        const float* s, const float* bias, float* out, int* ws, int M, int O,
                        int U, int Up, int cps, int slices, int wvec, cudaStream_t st) {
  using T = Tile<BM, BN, WM, WN, STAGES>;
  const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, slices);
  int8_dense_kernel<BM, BN, WM, WN, STAGES><<<grid, T::kThreads, T::kSmem, st>>>(
      xq, sx, w, s, bias, out, slices > 1 ? ws : nullptr, M, O, U, Up, cps, wvec);
  return cudaGetLastError();
}

int block_cols(int block_rows) {
  return block_rows == 16 ? 64 : (block_rows == 64 || block_rows == 128) ? 128 : -1;
}

int smem_bytes(int block_rows) {
  switch (block_rows) {
    case 16: return Tile<16, 64, 1, 4, 4>::kSmem;
    case 64: return Tile<64, 128, 2, 2, 3>::kSmem;
    case 128: return Tile<128, 128, 4, 2, 3>::kSmem;
    default: return -1;
  }
}

cudaError_t quantize_rows(const float* x, signed char* xq, float* sx, int M, int U, int Up,
                          int xvec, cudaStream_t st) {
  int8_quantize_rows_kernel<<<M, kQThreads, 0, st>>>(x, xq, sx, U, Up, xvec);
  return cudaGetLastError();
}

cudaError_t product(const signed char* xq, const float* sx, const signed char* w, const float* s,
                    const float* bias, float* out, int* ws, int M, int O, int U, int Up,
                    int block_rows, int cps, int slices, int wvec, cudaStream_t st) {
  cudaError_t err;
  switch (block_rows) {
    case 16:
      err = launch_tile<16, 64, 1, 4, 4>(xq, sx, w, s, bias, out, ws, M, O, U, Up, cps, slices,
                                         wvec, st);
      break;
    case 64:
      err = launch_tile<64, 128, 2, 2, 3>(xq, sx, w, s, bias, out, ws, M, O, U, Up, cps, slices,
                                          wvec, st);
      break;
    default:
      err = launch_tile<128, 128, 4, 2, 3>(xq, sx, w, s, bias, out, ws, M, O, U, Up, cps,
                                           slices, wvec, st);
  }
  if (err != cudaSuccess || slices == 1) return err;
  const size_t items = static_cast<size_t>(M) * O;
  const size_t want = (items + kRThreads - 1) / kRThreads;
  const unsigned blocks = static_cast<unsigned>(want < 8192 ? want : 8192);
  int8_dense_reduce_kernel<<<blocks, kRThreads, 0, st>>>(ws, sx, s, bias, out, M, O, slices);
  return cudaGetLastError();
}

bool valid(int M, int O, int U, int Up, int block_rows, int cps, int slices) {
  const int chunks = Up / kBK;
  return M >= 1 && O >= 1 && U >= 1 && Up % kBK == 0 && Up >= U && Up - U < kBK &&
         block_cols(block_rows) > 0 && cps >= 1 && slices >= 1 &&
         (slices - 1) * cps < chunks && slices * cps >= chunks;
}

}  // namespace

extern "C" {

// Bytes of U a chunk of the product (the wrapper pads xq rows to it).
int mxtt_int8_dense_chunk() { return kBK; }

// Output channels of a block of block_rows rows (16, 64 or 128), or -1.
int mxtt_int8_dense_block_cols(int block_rows) { return block_cols(block_rows); }

// Dynamic shared memory of a block of block_rows rows, or -1.
int mxtt_int8_dense_smem_bytes(int block_rows) { return smem_bytes(block_rows); }

// K1 alone: xq (M, Up) int8 and sx (M,) f32 from x (M, U) f32, all
// contiguous on the device; xvec: x 16-byte aligned and U % 4 == 0.
int mxtt_int8_quantize_rows(const void* x, void* xq, void* sx, int M, int U, int Up, int xvec,
                            void* stream) {
  if (M < 1 || U < 1 || Up % kBK != 0 || Up < U || Up - U >= kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(quantize_rows(static_cast<const float*>(x),
                                        static_cast<signed char*>(xq), static_cast<float*>(sx),
                                        M, U, Up, xvec, static_cast<cudaStream_t>(stream)));
}

// K2 (and K3 at slices > 1) alone: out (M, O) f32 from K1's xq and sx, the
// weight w (O, U) int8, its scales s (O,) f32 and bias (O,) f32 or null.
// block_rows: 16, 64 or 128; the U chunks (Up / 64 of them) split into
// `slices` slices of cps chunks, none empty; ws: an int32 (slices, M, O)
// workspace, null at one slice. wvec: w 16-byte aligned and U % 16 == 0.
int mxtt_int8_dense_product(const void* xq, const void* sx, const void* w, const void* s,
                            const void* bias, void* out, void* ws, int M, int O, int U, int Up,
                            int block_rows, int cps, int slices, int wvec, void* stream) {
  if (!valid(M, O, U, Up, block_rows, cps, slices) || (slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(product(
      static_cast<const signed char*>(xq), static_cast<const float*>(sx),
      static_cast<const signed char*>(w), static_cast<const float*>(s),
      static_cast<const float*>(bias), static_cast<float*>(out), static_cast<int*>(ws), M, O, U,
      Up, block_rows, cps, slices, wvec, static_cast<cudaStream_t>(stream)));
}

// The whole call: K1 into xq and sx, then the product. Launches on `stream`
// without synchronising and returns cudaGetLastError() of the first launch
// that failed (cudaErrorInvalidValue for a bad shape, tile or split).
int mxtt_int8_dense(const void* x, void* xq, void* sx, const void* w, const void* s,
                    const void* bias, void* out, void* ws, int M, int O, int U, int Up,
                    int block_rows, int cps, int slices, int xvec, int wvec, void* stream) {
  if (!valid(M, O, U, Up, block_rows, cps, slices) || (slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = quantize_rows(static_cast<const float*>(x),
                                        static_cast<signed char*>(xq), static_cast<float*>(sx),
                                        M, U, Up, xvec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(product(
      static_cast<const signed char*>(xq), static_cast<const float*>(sx),
      static_cast<const signed char*>(w), static_cast<const float*>(s),
      static_cast<const float*>(bias), static_cast<float*>(out), static_cast<int*>(ws), M, O, U,
      Up, block_rows, cps, slices, wvec, st));
}

// Registers, local (spilled or stack) bytes a thread and the most threads a
// block of kernel `which`: 0 K1, 1-3 K2 at 16, 64 and 128 rows, 4 K3.
int mxtt_int8_dense_attributes(int which, int* regs, int* local_bytes, int* max_threads) {
  const void* fns[] = {
      reinterpret_cast<const void*>(int8_quantize_rows_kernel),
      reinterpret_cast<const void*>(int8_dense_kernel<16, 64, 1, 4, 4>),
      reinterpret_cast<const void*>(int8_dense_kernel<64, 128, 2, 2, 3>),
      reinterpret_cast<const void*>(int8_dense_kernel<128, 128, 4, 2, 3>),
      reinterpret_cast<const void*>(int8_dense_reduce_kernel)};
  if (which < 0 || which > 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return 0;
}

const char* mxtt_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
