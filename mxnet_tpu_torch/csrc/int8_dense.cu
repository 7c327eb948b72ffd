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
// result equals the plain version's (ops/hopper/int8_dense.py) bit for bit,
// whichever product kernel ran and however U was split.
// Never build this file with --use_fast_math.
//
// One call of the wrapper is K1, one product kernel (K2d, K2w or K2) and,
// where the plan splits U, K3:
//  K1 int8_quantize_rows_kernel: a cluster of `cluster` blocks a row of x
//     (1 to 8, the wrapper's quantize_cluster: enough blocks that a few
//     decode rows spread over many SMs). Each block reads its span of the
//     row once into registers (8 float4 a thread; past 8 blocks of 8,192
//     values a row reads the rest twice), takes its max |x| by a block reduction, and the
//     blocks of the cluster read each other's maxima from shared memory
//     (DSMEM); fmaxf is exact, so the order of the max moves no bit. It
//     then writes xq from the registers, zero-filled from U to Up = U
//     rounded up to 64 bytes, so the products read whole chunks of xq;
//  K2d int8_dense_decode_kernel, for decode and verify rows (M <= 32) on a
//     weight whose rows are a multiple of 16 bytes and which starts 16-byte
//     aligned (the wrapper's routing): a weight stream, not a GEMM tile. A
//     block takes 64 output channels over one slice of U. One producer
//     warp keeps a ring of kDStages stages full with 1-D bulk copies
//     (cp.async.bulk, one a channel row of 1 KB, completion counted by an
//     mbarrier in bytes: no tensor map, so no host encoding), and issues
//     its first stages before the grid-dependency wait, since the weight
//     does not depend on K1. A stage is 16 channels x 1,024 bytes of U: on
//     an H100 the bulk copies' count, not the bytes in flight, set the
//     stream's rate (64 x 256 ran 1.6 times slower at the head). Four
//     consumer warps wait for K1 (griddepcontrol.wait), copy the block's
//     M x slice bytes of xq into shared memory once, and split each stage's
//     bytes four ways, each keeping its own sums for the block's 64
//     channels; the block adds the four in shared memory at the end, in
//     a fixed order. The products are mma.sync.m16n8k32 with the weight as
//     the A operand: the (O, U) row-major weight is already a .row A (16
//     channels x 32 bytes) and xq (M, Up) row-major a .col B (32 bytes x 8
//     rows), so M <= 8 fills one n-tile with no padding and M <= 32 takes
//     four (the template's NT). A thread reads 32 bytes of a row at
//     [32 t, 32 t + 32) of each 128-byte chunk, as two 16-byte shared
//     loads, and feeds 8 of them to each of the chunk's four products: the
//     k index is permuted alike in w and xq, which leaves every dot
//     product as it is. Rows lie 16 bytes past a multiple of 128 apart, so
//     the 8 lanes of a quarter warp hit 8 distinct bank groups. A consumer
//     warp hands a stage back with one mbarrier arrival: no __syncthreads
//     a chunk. The epilogue is K2's, with neighbouring threads on
//     neighbouring output channels;
//  K2w int8_dense_wgmma_kernel, for prefill rows (M > 32) on a weight whose
//     rows are a multiple of 16 bytes and which starts 16-byte aligned (the
//     wrapper's routing predicate): a block's tile is 128 rows x BN = 128 or
//     256 output channels over one slice of U. One producer warpgroup (one
//     thread of it, 40 registers by setmaxnreg) keeps a ring of 3 (BN = 256)
//     or 5 (BN = 128) stages full with TMA: a stage is 128 bytes of U of xq
//     (128 rows) and of w (BN rows), copied as two boxes of 2-D tensor maps
//     with the 128-byte swizzle, completion counted by an mbarrier in bytes.
//     TMA zero-fills rows past M and O and bytes past U, so no thread masks
//     an edge. Two consumer warpgroups (232 registers each) take 64 rows
//     each and run wgmma.mma_async m64nBNk32 s8 x s8 -> s32 straight from
//     the swizzled stage (xq and w are both K-major, the only layout wgmma
//     takes for 8-bit operands), four a stage, and hand the stage back to
//     the producer as soon as its products are done. The int32 sums stay in
//     registers (BN / 2 a thread) until the epilogue, which is K2's
//     rescale. The tensor maps are encoded on the host for each call
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     nothing links libcuda) and passed as __grid_constant__ parameters, so
//     a call can be captured in a CUDA graph;
//  K2 int8_dense_kernel, for a ragged or misaligned weight at any M (and
//     the yardstick the other two are timed against): a block's tile is
//     BM rows x BN output channels over one slice of U, in 64-byte chunks
//     through a ring of STAGES shared memory stages filled by 16-byte
//     cp.async (the weight's ragged edge, and rows past M, zero-filled by
//     the copy's src-size 0). Each chunk is two mma.sync.m16n8k32 s8 x s8
//     -> s32 products a warp tile. The weight (O, U) row-major is already
//     the .col B operand. A thread reads its fragments as one 16-byte
//     shared load a row: thread t of a quad takes bytes [16 t, 16 t + 16)
//     of the chunk, the first 8 for the first product and the last 8 for
//     the second. That permutes the k index inside a chunk, the same way
//     for xq and w, which leaves every dot product as it is. Rows are 64
//     bytes apart, so the 8 lanes of a quarter warp read 128 contiguous
//     bytes: no bank conflict;
//  K3 int8_dense_reduce_kernel: where the tiles alone leave SMs idle the
//     wrapper splits U into S slices of whole chunks; each block writes its
//     int32 partial to a workspace (S, M, O) and K3 sums the slices in
//     order and applies the epilogue. int32 sums are exact in any order, so
//     a split changes no bit, and with no atomics nothing needs zeroing.
// On the decode route K1, K2d and K3 are launched with programmatic
// dependent launch (the programmatic-stream-serialization attribute): K1
// and K2d signal griddepcontrol.launch_dependents as they start, and each
// kernel waits (griddepcontrol.wait) before it reads what the kernel
// before it wrote; K2d's producer never waits, since only the weight,
// which no kernel writes, is read before the wait. So K1, the launch
// ramps and K3's launch hide behind the weight stream, and a call whose
// product signals early lets the next call's quantization and stream start
// while it ends. Graph capture keeps the programmatic edges on an H100;
// where a capture turns one into a full dependency the result is the same.
// Nothing is allocated and nothing is read back to the host: a call can be
// captured in a CUDA graph.
//
// Bound. At decode (M <= 32) the call is a weight stream, O x U bytes at
// 3.35 TB/s: Little's law at ~1 us of latency asks for ~25 KB in flight an
// SM. K2d's grid (decode_plan in the wrapper) gives every SM blocks, each
// with up to kDStages x 16 KB of copies in flight, and two blocks fit an
// SM. At prefill the product is bound by int8 operations (1,979 TOP/s
// dense on an H100 SXM) at M = 1024 and by the weight's bytes at M = 256.
// mma.sync cannot reach that rate, so prefill rows take K2w: wgmma is the
// only way to the int8 tensor-core rate, TMA spends no thread's registers
// or instructions on the copies, and 128-byte stages of 128 x 256 tiles
// halve the shared memory and L2 traffic of K2's 64-byte stages of
// 128 x 128. Its grid (wgmma_plan in the wrapper) runs the row tiles
// fastest, so the blocks in flight share their weight boxes in L2, takes
// BN = 256 where those tiles alone give half the SMs a block and splits U
// where even BN = 128 falls short of that.
//
// K2's tiles: BM = 16 (M <= 32), 64 (M <= 256) and 128.
//  16 x 64,   4 warps as 1 x 4, 4 stages: a warp 16 x 16 (2 n-tiles);
//  64 x 128,  4 warps as 2 x 2, 3 stages: a warp 32 x 64 (2 x 8 tiles);
//  128 x 128, 8 warps as 4 x 2, 3 stages: a warp 32 x 64.
// A warp of the larger tiles holds 64 int32 accumulators.
//
// K2's loads: the weight streams by 16-byte cp.async when U is a multiple of
// 16 and the weight's pointer 16-byte aligned (wvec), else by byte loads
// stored to the same ring (a ragged or misaligned weight: correct, not
// fast). x is read as float4 when U is a multiple of 4 and its pointer
// 16-byte aligned, else as floats; xq is the wrapper's own padded buffer,
// always aligned.
#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBK = 64;          // bytes of U a chunk
constexpr int kQThreads = 256;   // K1's block
constexpr int kQKeep = 8;        // groups of 4 values a K1 thread keeps in registers
constexpr int kQClusterMax = 8;  // K1's blocks a row (the portable cluster size)
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// arrive, and expect `bytes` more of TMA's before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// programmatic dependent launch: let the next kernel of the stream start
// its blocks, and wait until the kernel before has completed and its writes
// are visible (a no-op where this kernel was launched without the
// attribute)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float at `p` in the shared memory of block `rank` of this cluster
__device__ __forceinline__ float ld_cluster_f32(const float* p, unsigned rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// elements [4 g, 4 g + 4) of a row of U floats, zeros past U
__device__ __forceinline__ float4 load_group(const float* row, int g, int U, int vec) {
  if (vec) return 4 * g < U ? reinterpret_cast<const float4*>(row)[g] : make_float4(0, 0, 0, 0);
  const int e = 4 * g;
  return make_float4(e < U ? row[e] : 0.f, e + 1 < U ? row[e + 1] : 0.f,
                     e + 2 < U ? row[e + 2] : 0.f, e + 3 < U ? row[e + 3] : 0.f);
}

__device__ __forceinline__ char4 quantize4(float4 v, float scale) {
  return make_char4(quantize(v.x, scale), quantize(v.y, scale), quantize(v.z, scale),
                    quantize(v.w, scale));
}

// K1: a cluster of `cluster` blocks a row of x (M, U); block r of the
// cluster takes bytes [r span, (r + 1) span) of the row's Up of xq (the
// same elements of x); xq (M, Up), sx (M,). vec: x 16-byte aligned and
// U % 4 == 0 (a group of 4 lies wholly inside or past U). A thread keeps
// kQKeep groups of 4 in registers.
__global__ void __launch_bounds__(kQThreads)
    int8_quantize_rows_kernel(const float* __restrict__ x, signed char* __restrict__ xq,
                              float* __restrict__ sx, int U, int Up, int span, int cluster,
                              int vec) {
  launch_dependents();     // the product's blocks may start streaming the weight
  grid_dependency_wait();  // x is written (where K1 starts early itself)
  const int m = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const float* row = x + static_cast<size_t>(m) * U;
  const int g0 = rank * span / 4, g1 = min((rank + 1) * span, Up) / 4;  // groups of 4
  float4 v[kQKeep];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kQKeep; ++i) {
    const int g = g0 + threadIdx.x + i * kQThreads;
    v[i] = g < g1 ? load_group(row, g, U, vec) : make_float4(0, 0, 0, 0);
    amax = fmaxf(amax, abs_max4(v[i]));
  }
  // past what the registers keep (a span over kQKeep groups a thread): read twice
  for (int g = g0 + threadIdx.x + kQKeep * kQThreads; g < g1; g += kQThreads)
    amax = fmaxf(amax, abs_max4(load_group(row, g, U, vec)));
#pragma unroll
  for (int off = 16; off; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float part[kQThreads / 32];
  __shared__ float block_max, row_max;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int i = 1; i < kQThreads / 32; ++i) amax = fmaxf(amax, part[i]);
  if (cluster > 1) {  // the row's max over the cluster's blocks, read from their shared memory
    if (threadIdx.x == 0) block_max = amax;
    cluster_arrive_release();
    cluster_wait();
    if (warp == 0) {
      float r = lane < cluster ? ld_cluster_f32(&block_max, lane) : 0.f;
#pragma unroll
      for (int off = 16; off; off >>= 1) r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, off));
      if (lane == 0) row_max = r;
    }
    cluster_arrive_relaxed();  // done reading the others' shared memory
    __syncthreads();
    amax = row_max;
  }
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  if (rank == 0 && threadIdx.x == 0) sx[m] = scale;
  char4* q = reinterpret_cast<char4*>(xq + static_cast<size_t>(m) * Up);
#pragma unroll
  for (int i = 0; i < kQKeep; ++i) {
    const int g = g0 + threadIdx.x + i * kQThreads;
    if (g < g1) q[g] = quantize4(v[i], scale);  // zeros past U quantize to 0
  }
  for (int g = g0 + threadIdx.x + kQKeep * kQThreads; g < g1; g += kQThreads)
    q[g] = quantize4(load_group(row, g, U, vec), scale);
  if (cluster > 1) cluster_wait();  // no block leaves while another reads its block_max
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
  grid_dependency_wait();  // the product's partials (and K1's sx) are written
  const size_t items = static_cast<size_t>(M) * O;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kRThreads + threadIdx.x; i < items;
       i += static_cast<size_t>(gridDim.x) * kRThreads) {
    int v = 0;
    for (int z = 0; z < S; ++z) v += __ldcg(ws + z * items + i);
    const int m = static_cast<int>(i / O), o = static_cast<int>(i % O);
    out[i] = rescale(v, __ldcg(sx + m), s[o], bias, o);
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

// the launch attribute that lets a kernel start while the one before it in
// the stream runs (programmatic dependent launch); returns the attributes set
int pdl_attribute(cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr->val.programmaticStreamSerializationAllowed = 1;
  return 1;
}

// K1 on a cluster of `cluster` blocks a row (1 to kQClusterMax); chained
// (the decode route): K1 starts while the kernel before it runs and waits
// for it on the card
cudaError_t quantize_rows(const float* x, signed char* xq, float* sx, int M, int U, int Up,
                          int cluster, int xvec, cudaStream_t st, bool chained = false) {
  const int span = ((Up + cluster - 1) / cluster + kBK - 1) / kBK * kBK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(M) * cluster);
  cfg.blockDim = dim3(kQThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  cfg.attrs = attr;
  cfg.numAttrs = chained ? pdl_attribute(attr) : 0;
  if (cluster > 1) {
    cudaLaunchAttribute& a = attr[cfg.numAttrs++];
    a.id = cudaLaunchAttributeClusterDimension;
    a.val.clusterDim.x = cluster;
    a.val.clusterDim.y = 1;
    a.val.clusterDim.z = 1;
  }
  return cudaLaunchKernelEx(&cfg, int8_quantize_rows_kernel, x, xq, sx, U, Up, span, cluster,
                            xvec);
}

bool valid_quantize(int M, int U, int Up, int cluster) {
  return M >= 1 && U >= 1 && Up % kBK == 0 && Up >= U && Up - U < kBK && cluster >= 1 &&
         cluster <= kQClusterMax;
}

// K3 over the slices' partials in ws, where a product split U; chained
// (the decode route): K3 starts while the product runs and waits for it on
// the card
cudaError_t reduce_slices(const int* ws, const float* sx, const float* s, const float* bias,
                          float* out, int M, int O, int slices, cudaStream_t st,
                          bool chained = false) {
  const size_t items = static_cast<size_t>(M) * O;
  const size_t want = (items + kRThreads - 1) / kRThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(want < 8192 ? want : 8192));
  cfg.blockDim = dim3(kRThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = chained ? pdl_attribute(attr) : 0;
  return cudaLaunchKernelEx(&cfg, int8_dense_reduce_kernel, ws, sx, s, bias, out, M, O, slices);
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
  return reduce_slices(ws, sx, s, bias, out, M, O, slices, st);
}

bool valid(int M, int O, int U, int Up, int block_rows, int cps, int slices) {
  const int chunks = Up / kBK;
  return M >= 1 && O >= 1 && U >= 1 && Up % kBK == 0 && Up >= U && Up - U < kBK &&
         block_cols(block_rows) > 0 && cps >= 1 && slices >= 1 &&
         (slices - 1) * cps < chunks && slices * cps >= chunks;
}

// -- K2d: the weight stream for decode and verify rows -----------------------

constexpr int kDCols = 64;        // output channels a block
constexpr int kDChunk = 128;      // bytes of U of one k-step group (four k32 products)
constexpr int kDStageRows = 16;   // channel rows a stage (16, 32 or 64)
constexpr int kDStage = 1024;     // bytes of U a stage row: one bulk copy
constexpr int kDStages = 4;       // the ring
constexpr int kDThreads = 160;    // four consumer warps and the producer warp
constexpr int kDMaxRows = 32;     // M at most: four n-tiles of 8 rows
constexpr int kDPitch = kDStage + 16;               // a channel row in a stage
constexpr int kDStageBytes = kDStageRows * kDPitch;  // a stage's shared memory
constexpr int kDGroups = kDStageRows / 16;   // 16-channel groups a stage
constexpr int kDParts = 4 / kDGroups;        // consumer warps a group: they split the bytes
constexpr int kDSubs = kDCols / kDStageRows;  // stages a block takes for a piece of U
constexpr int kDWarpChunks = kDStage / kDChunk / kDParts;  // chunks a warp takes a stage
constexpr int kDMaxSmem = 227 * 1024 - 1024;      // dynamic shared memory a block, at most
static_assert(kDGroups * kDParts == 4 && kDSubs * kDStageRows == kDCols && kDWarpChunks >= 1 &&
                  kDWarpChunks * kDChunk * kDParts == kDStage,
              "stage shape");

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completion counted on `bar` in bytes. The weight is read once a forward
// and is far larger than L2, so its lines go first (evict_first): on an
// H100 a forward's decode products took 5.02 ms with the hint and 5.62
// without, after a flush that left L2 dirty (int8_variants'
// decode_no_evict_first).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// the dynamic shared memory of a K2d block of `rows` (8 NT) rows whose
// slices hold cps 128-byte chunks: the ring, then xq's slice
int decode_smem_bytes(int rows, int cps) {
  return kDStages * kDStageBytes + rows * (cps * kDChunk + 16);
}

// K2d: out (or the slice's int32 partial in ws) of the block's 64 output
// channels over slice z of U: 128-byte chunks [z cps, min((z + 1) cps,
// chunks)), chunks = ceil(U / 128). NT n-tiles of 8 rows cover M. The
// block takes the slice kDStage bytes at a time, and each such piece in
// kDSubs stages of kDStageRows channels; consumer warp w takes channel
// group w % kDGroups of every stage and its bytes' part w / kDGroups.
template <int NT>
__global__ void __launch_bounds__(kDThreads)
    int8_dense_decode_kernel(const signed char* __restrict__ xq, const float* __restrict__ sx,
                             const signed char* __restrict__ w, const float* __restrict__ s,
                             const float* __restrict__ bias, float* __restrict__ out,
                             int* __restrict__ ws, int M, int O, int U, int Up, int cps) {
  // the warps' int32 partials, summed in the epilogue, reuse the ring and
  // the xq slice (at least a chunk a row) once every stage is consumed
  static_assert(kDParts * kDCols * (8 * NT + 1) * 4 <=
                    kDStages * kDStageBytes + 8 * NT * (kDChunk + 16),
                "partials");
  extern __shared__ __align__(16) unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[kDStages], empty[kDStages];
  const int o0 = blockIdx.x * kDCols, z = blockIdx.y;
  const int chunks = (U + kDChunk - 1) / kDChunk;
  const int kb = z * cps * kDChunk;                     // the slice's bytes of U:
  const int ke = min((z + 1) * cps, chunks) * kDChunk;  // [kb, ke), ke up to 112 past U
  const int len = ke - kb;
  const int n = (len + kDStage - 1) / kDStage * kDSubs;  // stages of the block
  const int xpitch = cps * kDChunk + 16;                 // an xq row in shared memory
  unsigned char* ring = dsmem;
  unsigned char* xs = dsmem + kDStages * kDStageBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kDStages; ++i) {
      mbar_init(&full[i], 1);   // the producer's arrival, then the copies' bytes
      mbar_init(&empty[i], 4);  // one arrival of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  launch_dependents();  // K3 may start; it waits for this grid before it reads

  if (warp == 4) {  // the producer: the weight does not depend on K1, so no wait
    const int kvalid = min(ke, U);
    for (int j = 0; j < n; ++j) {
      const int st = j % kDStages;
      // a fresh barrier counts as having completed the phase before its
      // first, so the first round over the ring does not wait
      mbar_wait(&empty[st], ((j / kDStages) & 1) ^ 1);
      const int k0 = kb + (j / kDSubs) * kDStage, c0 = o0 + (j % kDSubs) * kDStageRows;
      const int rows = max(0, min(kDStageRows, O - c0));
      const int bytes = min(kDStage, kvalid - k0);  // a multiple of 16: U % 16 == 0
      unsigned char* dst = ring + st * kDStageBytes;
      if (lane == 0) mbar_expect_tx(&full[st], static_cast<unsigned>(rows * bytes));
      __syncwarp();
      for (int r = lane; r < rows; r += 32)
        bulk_load(dst + r * kDPitch, w + static_cast<size_t>(c0 + r) * U + k0, bytes, &full[st]);
    }
    return;
  }

  grid_dependency_wait();  // K1's xq and sx are written
  {  // xq's slice, rows [0, 8 NT), once: zeros past M and past Up. Every
     // piece is in flight at once
    const int pieces = len / 16;
    for (int i = threadIdx.x; i < 8 * NT * pieces; i += 128) {
      const int r = i / pieces, c = (i - r * pieces) * 16;
      const bool in = r < M && kb + c < Up;
      cp_async16(xs + r * xpitch + c, in ? xq + static_cast<size_t>(r) * Up + kb + c : xq, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the four consumer warps only

  const int g = lane >> 2, t = lane & 3;
  const int group = warp % kDGroups, part = warp / kDGroups;
  int acc[kDSubs][NT][4];
#pragma unroll
  for (int q = 0; q < kDSubs; ++q)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][i][e] = 0;
  for (int j0 = 0; j0 < n; j0 += kDSubs) {
    const int kp = j0 / kDSubs * kDStage;  // the piece's first byte in the slice
#pragma unroll
    for (int q = 0; q < kDSubs; ++q) {
      const int j = j0 + q, st = j % kDStages;
      mbar_wait(&full[st], (j / kDStages) & 1);
      // rows g and g + 8 of the warp's 16 channels, bytes [32 t, 32 t + 32)
      // of each 128-byte chunk of its part
      const int k = part * kDWarpChunks * kDChunk + 32 * t;
      const unsigned char* a = ring + st * kDStageBytes + (16 * group + g) * kDPitch + k;
      const unsigned char* b = xs + g * xpitch + kp + k;
#pragma unroll
      for (int c = 0; c < kDWarpChunks; ++c) {
        if (kp + (part * kDWarpChunks + c) * kDChunk >= len) break;
        const uint4 a0 = lds128(a + c * kDChunk), a0b = lds128(a + c * kDChunk + 16);
        const uint4 a1 = lds128(a + 8 * kDPitch + c * kDChunk);
        const uint4 a1b = lds128(a + 8 * kDPitch + c * kDChunk + 16);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const unsigned char* bi = b + 8 * i * xpitch + c * kDChunk;
          const uint4 b0 = lds128(bi), b1 = lds128(bi + 16);
          mma_s8(acc[q][i], a0.x, a1.x, a0.y, a1.y, b0.x, b0.y);
          mma_s8(acc[q][i], a0.z, a1.z, a0.w, a1.w, b0.z, b0.w);
          mma_s8(acc[q][i], a0b.x, a1b.x, a0b.y, a1b.y, b1.x, b1.y);
          mma_s8(acc[q][i], a0b.z, a1b.z, a0b.w, a1b.w, b1.z, b1.w);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // the stage goes back to the producer
    }
  }

  // every stage is consumed (the producer issues no more): the ring and
  // the xq slice after it hold the warps' partials, red[part][channel][row],
  // 8 NT + 1 rows apart
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  int* red = reinterpret_cast<int*>(ring);
  constexpr int kRP = 8 * NT + 1;
  // accumulator fragment of stage q, n-tile i: acc[q][i][e] is channel
  // 16 group + g + 8 (e >> 1) of that stage's rows and row 8 i + 2 t + (e & 1)
#pragma unroll
  for (int q = 0; q < kDSubs; ++q)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = q * kDStageRows + 16 * group + g + (e >> 1) * 8;
        red[(part * kDCols + ch) * kRP + 8 * i + 2 * t + (e & 1)] = acc[q][i][e];
      }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  // the parts' sum of each (row, channel), neighbouring threads on
  // neighbouring channels
  for (int i = threadIdx.x; i < 8 * NT * kDCols; i += 128) {
    const int m = i / kDCols, ch = i % kDCols, o = o0 + ch;
    if (m >= M || o >= O) continue;
    int v = 0;
#pragma unroll
    for (int p = 0; p < kDParts; ++p) v += red[(p * kDCols + ch) * kRP + m];
    if (ws)
      ws[(static_cast<size_t>(z) * M + m) * O + o] = v;
    else
      out[static_cast<size_t>(m) * O + o] = rescale(v, __ldcg(sx + m), s[o], bias, o);
  }
}

template <int NT>
cudaError_t launch_decode(const signed char* xq, const float* sx, const signed char* w,
                          const float* s, const float* bias, float* out, int* ws, int M, int O,
                          int U, int Up, int cps, int slices, cudaStream_t st) {
  const int smem = decode_smem_bytes(8 * NT, cps);
  // opt in to kDMaxSmem once a device (the ring alone is above 48 KB)
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(int8_dense_decode_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDMaxSmem);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + kDCols - 1) / kDCols, slices);
  cfg.blockDim = dim3(kDThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = pdl_attribute(attr);
  return cudaLaunchKernelEx(&cfg, int8_dense_decode_kernel<NT>, xq, sx, w, s, bias, out,
                            slices > 1 ? ws : nullptr, M, O, U, Up, cps);
}

// K2d, then K3 where U is split, each chained to the kernel before it
cudaError_t product_decode(const signed char* xq, const float* sx, const signed char* w,
                           const float* s, const float* bias, float* out, int* ws, int M, int O,
                           int U, int Up, int cps, int slices, cudaStream_t st) {
  cudaError_t err;
  switch ((M + 7) / 8) {
    case 1:
      err = launch_decode<1>(xq, sx, w, s, bias, out, ws, M, O, U, Up, cps, slices, st);
      break;
    case 2:
      err = launch_decode<2>(xq, sx, w, s, bias, out, ws, M, O, U, Up, cps, slices, st);
      break;
    case 3:
      err = launch_decode<3>(xq, sx, w, s, bias, out, ws, M, O, U, Up, cps, slices, st);
      break;
    default:
      err = launch_decode<4>(xq, sx, w, s, bias, out, ws, M, O, U, Up, cps, slices, st);
  }
  if (err != cudaSuccess || slices == 1) return err;
  return reduce_slices(ws, sx, s, bias, out, M, O, slices, st, true);
}

bool valid_decode(const void* w, int M, int O, int U, int Up, int cps, int slices) {
  const int chunks = (U + kDChunk - 1) / kDChunk;
  return M >= 1 && M <= kDMaxRows && O >= 1 && U >= 16 && U % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && Up % kBK == 0 && Up >= U && Up - U < kBK &&
         cps >= 1 && slices >= 1 && (slices - 1) * cps < chunks && slices * cps >= chunks &&
         decode_smem_bytes(8 * ((M + 7) / 8), cps) <= kDMaxSmem;
}

// -- K2w: the wgmma product for prefill rows ----------------------------------

constexpr int kWRows = 128;     // rows of a block: two consumer warpgroups of 64
constexpr int kWChunk = 128;    // bytes of U a stage: one 128-byte swizzled row
constexpr int kWThreads = 384;  // two consumer warpgroups and the producer's
// error codes beside cudaError_t's: a tensor map the driver refused
// (kEncodeFailed + its CUresult), or no cuTensorMapEncodeTiled at all
constexpr int kEncodeFailed = 100000;
constexpr int kNoEncoder = 200000;

template <int BN>
struct WTile {
  static constexpr int kStages = BN == 256 ? 3 : 5;
  static constexpr int kA = kWRows * kWChunk;                // xq's box, 16 KB
  static constexpr int kStage = (kWRows + BN) * kWChunk;     // the bytes TMA lands a stage
  static constexpr int kSmem = kStages * kStage + 1024;      // + room to align to 1024
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

// the box of `map` at (c0 bytes of U, c1 rows) into shared memory at dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's descriptor of a K-major tile as TMA lays it with the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart (the stride
// offset), the leading offset unused; the tile starts 1024-byte aligned.
// Adding 2 (32 bytes) steps one k32 product along U inside the row.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of v across the wgmma
// instructions, which update it asynchronously
__device__ __forceinline__ void fence_reg(int& v) { asm volatile("" : "+r"(v)::"memory"); }

// acc += A (64 x 32 bytes) . B (128 x 32 bytes)^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_n128(int* acc, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p;\n}\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15]),
        "+r"(acc[16]), "+r"(acc[17]), "+r"(acc[18]), "+r"(acc[19]),
        "+r"(acc[20]), "+r"(acc[21]), "+r"(acc[22]), "+r"(acc[23]),
        "+r"(acc[24]), "+r"(acc[25]), "+r"(acc[26]), "+r"(acc[27]),
        "+r"(acc[28]), "+r"(acc[29]), "+r"(acc[30]), "+r"(acc[31]),
        "+r"(acc[32]), "+r"(acc[33]), "+r"(acc[34]), "+r"(acc[35]),
        "+r"(acc[36]), "+r"(acc[37]), "+r"(acc[38]), "+r"(acc[39]),
        "+r"(acc[40]), "+r"(acc[41]), "+r"(acc[42]), "+r"(acc[43]),
        "+r"(acc[44]), "+r"(acc[45]), "+r"(acc[46]), "+r"(acc[47]),
        "+r"(acc[48]), "+r"(acc[49]), "+r"(acc[50]), "+r"(acc[51]),
        "+r"(acc[52]), "+r"(acc[53]), "+r"(acc[54]), "+r"(acc[55]),
        "+r"(acc[56]), "+r"(acc[57]), "+r"(acc[58]), "+r"(acc[59]),
        "+r"(acc[60]), "+r"(acc[61]), "+r"(acc[62]), "+r"(acc[63])
      : "l"(da), "l"(db), "r"(1));
}

// acc += A (64 x 32 bytes) . B (256 x 32 bytes)^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_n256(int* acc, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p;\n}\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15]),
        "+r"(acc[16]), "+r"(acc[17]), "+r"(acc[18]), "+r"(acc[19]),
        "+r"(acc[20]), "+r"(acc[21]), "+r"(acc[22]), "+r"(acc[23]),
        "+r"(acc[24]), "+r"(acc[25]), "+r"(acc[26]), "+r"(acc[27]),
        "+r"(acc[28]), "+r"(acc[29]), "+r"(acc[30]), "+r"(acc[31]),
        "+r"(acc[32]), "+r"(acc[33]), "+r"(acc[34]), "+r"(acc[35]),
        "+r"(acc[36]), "+r"(acc[37]), "+r"(acc[38]), "+r"(acc[39]),
        "+r"(acc[40]), "+r"(acc[41]), "+r"(acc[42]), "+r"(acc[43]),
        "+r"(acc[44]), "+r"(acc[45]), "+r"(acc[46]), "+r"(acc[47]),
        "+r"(acc[48]), "+r"(acc[49]), "+r"(acc[50]), "+r"(acc[51]),
        "+r"(acc[52]), "+r"(acc[53]), "+r"(acc[54]), "+r"(acc[55]),
        "+r"(acc[56]), "+r"(acc[57]), "+r"(acc[58]), "+r"(acc[59]),
        "+r"(acc[60]), "+r"(acc[61]), "+r"(acc[62]), "+r"(acc[63]),
        "+r"(acc[64]), "+r"(acc[65]), "+r"(acc[66]), "+r"(acc[67]),
        "+r"(acc[68]), "+r"(acc[69]), "+r"(acc[70]), "+r"(acc[71]),
        "+r"(acc[72]), "+r"(acc[73]), "+r"(acc[74]), "+r"(acc[75]),
        "+r"(acc[76]), "+r"(acc[77]), "+r"(acc[78]), "+r"(acc[79]),
        "+r"(acc[80]), "+r"(acc[81]), "+r"(acc[82]), "+r"(acc[83]),
        "+r"(acc[84]), "+r"(acc[85]), "+r"(acc[86]), "+r"(acc[87]),
        "+r"(acc[88]), "+r"(acc[89]), "+r"(acc[90]), "+r"(acc[91]),
        "+r"(acc[92]), "+r"(acc[93]), "+r"(acc[94]), "+r"(acc[95]),
        "+r"(acc[96]), "+r"(acc[97]), "+r"(acc[98]), "+r"(acc[99]),
        "+r"(acc[100]), "+r"(acc[101]), "+r"(acc[102]), "+r"(acc[103]),
        "+r"(acc[104]), "+r"(acc[105]), "+r"(acc[106]), "+r"(acc[107]),
        "+r"(acc[108]), "+r"(acc[109]), "+r"(acc[110]), "+r"(acc[111]),
        "+r"(acc[112]), "+r"(acc[113]), "+r"(acc[114]), "+r"(acc[115]),
        "+r"(acc[116]), "+r"(acc[117]), "+r"(acc[118]), "+r"(acc[119]),
        "+r"(acc[120]), "+r"(acc[121]), "+r"(acc[122]), "+r"(acc[123]),
        "+r"(acc[124]), "+r"(acc[125]), "+r"(acc[126]), "+r"(acc[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int* acc, uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256(acc, da, db);
  else
    wgmma_n128(acc, da, db);
}

// K2w: out (or the slice's int32 partial in ws) of the block's 128 x BN tile.
// ta: xq (M rows of U bytes, Up apart) in boxes of 128 rows x 128 bytes; tb:
// w (O rows of U bytes) in boxes of BN rows x 128 bytes. chunks = ceil(U /
// 128); slice z takes chunks [z cps, min((z + 1) cps, chunks)), none empty.
// Row tiles run fastest in the grid, so the blocks in flight together share
// their weight boxes in L2: Llama-3-8B's gate/up weight (58.7 MB) is more
// than L2 holds, and there column tiles fastest ran 20% slower at M = 1024
// on an H100 (int8_variants' columns_fast).
template <int BN>
__global__ void __launch_bounds__(kWThreads, 1)
    int8_dense_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tb, const float* __restrict__ sx,
                            const float* __restrict__ s, const float* __restrict__ bias,
                            float* __restrict__ out, int* __restrict__ ws, int M, int O,
                            int chunks, int cps) {
  using T = WTile<BN>;
  extern __shared__ unsigned char wsmem[];
  __shared__ __align__(8) uint64_t full[T::kStages], empty[T::kStages];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on it
  unsigned char* smem = wsmem + ((1024u - (smem_u32(wsmem) & 1023u)) & 1023u);
  const int m0 = blockIdx.x * kWRows, o0 = blockIdx.y * BN, z = blockIdx.z;
  const int kbeg = z * cps;
  const int n = min(cps, chunks - kbeg);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(&full[i], 1);   // the producer's arrival, then TMA's bytes
      mbar_init(&empty[i], 2);  // one arrival of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      for (int j = 0; j < n; ++j) {
        const int st = j % T::kStages;
        // a fresh barrier counts as having completed the phase before its
        // first, so the first round over the ring does not wait
        mbar_wait(&empty[st], ((j / T::kStages) & 1) ^ 1);
        unsigned char* a = smem + st * T::kStage;
        mbar_expect_tx(&full[st], T::kStage);
        const int k0 = (kbeg + j) * kWChunk;
        tma_load(a, &ta, &full[st], k0, m0);
        tma_load(a + T::kA, &tb, &full[st], k0, o0);
      }
    }
  } else {  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int j = 0; j < n; ++j) {
      const int st = j % T::kStages;
      mbar_wait(&full[st], (j / T::kStages) & 1);
      const unsigned char* a = smem + st * T::kStage + wg * 64 * kWChunk;
      const uint64_t da = sw128_desc(a), db = sw128_desc(smem + st * T::kStage + T::kA);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWChunk / 32; ++kk) wgmma<BN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      // hand the stage back as soon as its products are done (the other
      // warpgroup keeps the tensor cores busy meanwhile): keeping one
      // stage's products in flight and handing back the one before ran no
      // faster on an H100 (int8_variants' hand_back_late)
      wgmma_wait_all();
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);

    // accumulator fragment: warp w of the group holds rows 16 w + g and
    // 16 w + g + 8; in each 8-column block j, acc[4 j + 2 h + e] is column
    // 8 j + 2 t + e of row 16 w + g + 8 h (g = lane / 4, t = lane % 4)
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row = m0 + wg * 64 + warp * 16 + g;
    const bool pairs = (O & 1) == 0;  // two neighbours 8-byte aligned
    float sxm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) sxm[h] = ws || row + 8 * h >= M ? 0.f : sx[row + 8 * h];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int o = o0 + 8 * j + 2 * t;
      // loads clamped in bounds, so that none waits on a guard: the guards
      // below skip stores only, and the compiler can issue every load of
      // the tile ahead of them (a guarded load a column serialised the
      // epilogue on their latency)
      const int o1 = min(o + 1, O - 1), oc = min(o, O - 1);
      const float s0 = s[oc], s1 = s[o1];
      const float b0 = bias ? bias[oc] : 0.f, b1 = bias ? bias[o1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (m >= M || o >= O) continue;
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (ws) {
          int* dst = ws + (static_cast<size_t>(z) * M + m) * O + o;
          if (pairs) {
            *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
          } else {
            dst[0] = v0;
            if (o + 1 < O) dst[1] = v1;
          }
        } else {
          // rescale's operations, with the scales and bias loaded above
          float r0 = __fmul_rn(__fmul_rn(__int2float_rn(v0), sxm[h]), s0);
          float r1 = __fmul_rn(__fmul_rn(__int2float_rn(v1), sxm[h]), s1);
          if (bias) {
            r0 = __fadd_rn(r0, b0);
            r1 = __fadd_rn(r1, b1);
          }
          float* dst = out + static_cast<size_t>(m) * O + o;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(r0, r1);
          } else {
            dst[0] = r0;
            if (o + 1 < O) dst[1] = r1;
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or null
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &got);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return err == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// map: `rows` rows of `cols` int8, `pitch` bytes apart, read in boxes of
// box_rows rows x 128 bytes with the 128-byte swizzle; reads past either
// edge give zeros. Returns 0, kNoEncoder or kEncodeFailed + the CUresult.
int encode_rows(CUtensorMap* map, const void* base, int rows, int cols, int pitch,
                int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return kNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kWChunk), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

int wgmma_smem_bytes(int block_cols) {
  return block_cols == 128 ? WTile<128>::kSmem : block_cols == 256 ? WTile<256>::kSmem : -1;
}

template <int BN>
int launch_wgmma(const signed char* xq, const float* sx, const signed char* w, const float* s,
                 const float* bias, float* out, int* ws, int M, int O, int U, int Up, int cps,
                 int slices, cudaStream_t st) {
  using T = WTile<BN>;
  CUtensorMap ta, tb;
  int e = encode_rows(&ta, xq, M, U, Up, kWRows);
  if (e == 0) e = encode_rows(&tb, w, O, U, U, BN);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(int8_dense_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (M + kWRows - 1) / kWRows;
  const dim3 grid(rows, (O + BN - 1) / BN, slices);
  int8_dense_wgmma_kernel<BN><<<grid, kWThreads, T::kSmem, st>>>(
      ta, tb, sx, s, bias, out, slices > 1 ? ws : nullptr, M, O, (U + kWChunk - 1) / kWChunk,
      cps);
  return static_cast<int>(cudaGetLastError());
}

int product_wgmma(const signed char* xq, const float* sx, const signed char* w, const float* s,
                  const float* bias, float* out, int* ws, int M, int O, int U, int Up,
                  int block_cols, int cps, int slices, cudaStream_t st) {
  const int err =
      block_cols == 256
          ? launch_wgmma<256>(xq, sx, w, s, bias, out, ws, M, O, U, Up, cps, slices, st)
          : launch_wgmma<128>(xq, sx, w, s, bias, out, ws, M, O, U, Up, cps, slices, st);
  if (err != 0 || slices == 1) return err;
  return static_cast<int>(reduce_slices(ws, sx, s, bias, out, M, O, slices, st));
}

bool valid_wgmma(const void* w, int M, int O, int U, int Up, int block_cols, int cps,
                 int slices) {
  const int chunks = (U + kWChunk - 1) / kWChunk;
  return M >= 1 && O >= 1 && U >= 16 && U % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
         Up % kBK == 0 && Up >= U && Up - U < kBK && wgmma_smem_bytes(block_cols) > 0 &&
         cps >= 1 && slices >= 1 && (slices - 1) * cps < chunks && slices * cps >= chunks;
}

}  // namespace

extern "C" {

// Bytes of U a chunk of the product (the wrapper pads xq rows to it).
int mxtt_int8_dense_chunk() { return kBK; }

// Output channels of a block of block_rows rows (16, 64 or 128), or -1.
int mxtt_int8_dense_block_cols(int block_rows) { return block_cols(block_rows); }

// Dynamic shared memory of a block of block_rows rows, or -1.
int mxtt_int8_dense_smem_bytes(int block_rows) { return smem_bytes(block_rows); }

// K1's block threads, the values a thread keeps in registers, the most
// blocks a row.
int mxtt_int8_quantize_config(int* threads, int* keep, int* cluster_max) {
  *threads = kQThreads;
  *keep = 4 * kQKeep;
  *cluster_max = kQClusterMax;
  return 0;
}

// K1 alone: xq (M, Up) int8 and sx (M,) f32 from x (M, U) f32, all
// contiguous on the device, on `cluster` blocks a row (1 to 8); xvec: x
// 16-byte aligned and U % 4 == 0.
int mxtt_int8_quantize_rows(const void* x, void* xq, void* sx, int M, int U, int Up, int cluster,
                            int xvec, void* stream) {
  if (!valid_quantize(M, U, Up, cluster)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(quantize_rows(static_cast<const float*>(x),
                                        static_cast<signed char*>(xq), static_cast<float*>(sx),
                                        M, U, Up, cluster, xvec,
                                        static_cast<cudaStream_t>(stream)));
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

// The whole call on K2: K1 into xq and sx (on `cluster` blocks a row), then
// the product. Launches on `stream` without synchronising and returns
// cudaGetLastError() of the first launch that failed (cudaErrorInvalidValue
// for a bad shape, tile or split).
int mxtt_int8_dense(const void* x, void* xq, void* sx, const void* w, const void* s,
                    const void* bias, void* out, void* ws, int M, int O, int U, int Up,
                    int block_rows, int cps, int slices, int cluster, int xvec, int wvec,
                    void* stream) {
  if (!valid(M, O, U, Up, block_rows, cps, slices) || !valid_quantize(M, U, Up, cluster) ||
      (slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = quantize_rows(static_cast<const float*>(x),
                                        static_cast<signed char*>(xq), static_cast<float*>(sx),
                                        M, U, Up, cluster, xvec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(product(
      static_cast<const signed char*>(xq), static_cast<const float*>(sx),
      static_cast<const signed char*>(w), static_cast<const float*>(s),
      static_cast<const float*>(bias), static_cast<float*>(out), static_cast<int*>(ws), M, O, U,
      Up, block_rows, cps, slices, wvec, st));
}

// K2d's output channels a block, bytes of U a chunk (the unit of its U
// slices), channel rows and bytes of U a stage, stages, threads and most
// rows.
int mxtt_int8_dense_decode_config(int* cols, int* chunk, int* stage_rows, int* stage,
                                  int* stages, int* threads, int* max_rows) {
  *cols = kDCols;
  *chunk = kDChunk;
  *stage_rows = kDStageRows;
  *stage = kDStage;
  *stages = kDStages;
  *threads = kDThreads;
  *max_rows = kDMaxRows;
  return 0;
}

// Dynamic shared memory of a K2d block of `rows` rows (rounded up to 8)
// whose slices hold cps 128-byte chunks: the ring and xq's slice.
int mxtt_int8_dense_decode_smem_bytes(int rows, int cps) {
  return decode_smem_bytes(8 * ((rows + 7) / 8), cps);
}

// K2d (and K3 at slices > 1) alone, as mxtt_int8_dense_product: M <= 32;
// the U bytes split into `slices` slices of cps 128-byte chunks (ceil(U /
// 128) of them), none empty; w 16-byte aligned, U % 16 == 0. K2d and K3
// are launched with programmatic dependent launch.
int mxtt_int8_dense_decode_product(const void* xq, const void* sx, const void* w, const void* s,
                                   const void* bias, void* out, void* ws, int M, int O, int U,
                                   int Up, int cps, int slices, void* stream) {
  if (!valid_decode(w, M, O, U, Up, cps, slices) || (slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(product_decode(
      static_cast<const signed char*>(xq), static_cast<const float*>(sx),
      static_cast<const signed char*>(w), static_cast<const float*>(s),
      static_cast<const float*>(bias), static_cast<float*>(out), static_cast<int*>(ws), M, O, U,
      Up, cps, slices, static_cast<cudaStream_t>(stream)));
}

// The whole call on K2d: K1, K2d (and K3), each launched with programmatic
// dependent launch (K1 on the kernel before the call).
int mxtt_int8_dense_decode(const void* x, void* xq, void* sx, const void* w, const void* s,
                           const void* bias, void* out, void* ws, int M, int O, int U, int Up,
                           int cps, int slices, int cluster, int xvec, void* stream) {
  if (!valid_decode(w, M, O, U, Up, cps, slices) || !valid_quantize(M, U, Up, cluster) ||
      (slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = quantize_rows(static_cast<const float*>(x),
                                        static_cast<signed char*>(xq), static_cast<float*>(sx),
                                        M, U, Up, cluster, xvec, st, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(product_decode(
      static_cast<const signed char*>(xq), static_cast<const float*>(sx),
      static_cast<const signed char*>(w), static_cast<const float*>(s),
      static_cast<const float*>(bias), static_cast<float*>(out), static_cast<int*>(ws), M, O, U,
      Up, cps, slices, st));
}

// Bytes of U a stage of K2w, its rows a block, and the dynamic shared
// memory of a block of block_cols (128 or 256) output channels, or -1.
int mxtt_int8_dense_wgmma_chunk() { return kWChunk; }
int mxtt_int8_dense_wgmma_rows() { return kWRows; }
int mxtt_int8_dense_wgmma_smem_bytes(int block_cols) { return wgmma_smem_bytes(block_cols); }

// K2w (and K3 at slices > 1) alone, as mxtt_int8_dense_product: block_cols
// 128 or 256; the U bytes split into `slices` slices of cps 128-byte chunks
// (ceil(U / 128) of them), none empty. w 16-byte aligned, U % 16 == 0.
// Returns a cudaError_t, or kEncodeFailed + the CUresult of a tensor map the
// driver refused, or kNoEncoder.
int mxtt_int8_dense_wgmma_product(const void* xq, const void* sx, const void* w, const void* s,
                                  const void* bias, void* out, void* ws, int M, int O, int U,
                                  int Up, int block_cols, int cps, int slices, void* stream) {
  if (!valid_wgmma(w, M, O, U, Up, block_cols, cps, slices) || (slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return product_wgmma(static_cast<const signed char*>(xq), static_cast<const float*>(sx),
                       static_cast<const signed char*>(w), static_cast<const float*>(s),
                       static_cast<const float*>(bias), static_cast<float*>(out),
                       static_cast<int*>(ws), M, O, U, Up, block_cols, cps, slices,
                       static_cast<cudaStream_t>(stream));
}

// The whole call on K2w: K1 into xq and sx, then K2w (and K3).
int mxtt_int8_dense_wgmma(const void* x, void* xq, void* sx, const void* w, const void* s,
                          const void* bias, void* out, void* ws, int M, int O, int U, int Up,
                          int block_cols, int cps, int slices, int cluster, int xvec,
                          void* stream) {
  if (!valid_wgmma(w, M, O, U, Up, block_cols, cps, slices) ||
      !valid_quantize(M, U, Up, cluster) || (slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = quantize_rows(static_cast<const float*>(x),
                                        static_cast<signed char*>(xq), static_cast<float*>(sx),
                                        M, U, Up, cluster, xvec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return product_wgmma(static_cast<const signed char*>(xq), static_cast<const float*>(sx),
                       static_cast<const signed char*>(w), static_cast<const float*>(s),
                       static_cast<const float*>(bias), static_cast<float*>(out),
                       static_cast<int*>(ws), M, O, U, Up, block_cols, cps, slices, st);
}

// Registers, local (spilled or stack) bytes a thread and the most threads a
// block of kernel `which`: 0 K1, 1-3 K2 at 16, 64 and 128 rows, 4 K3, 5-6
// K2w at 128 and 256 output channels, 7-10 K2d at 8, 16, 24 and 32 rows.
// K2w's registers are those it is launched with, before setmaxnreg moves
// them between its warpgroups.
int mxtt_int8_dense_attributes(int which, int* regs, int* local_bytes, int* max_threads) {
  const void* fns[] = {
      reinterpret_cast<const void*>(int8_quantize_rows_kernel),
      reinterpret_cast<const void*>(int8_dense_kernel<16, 64, 1, 4, 4>),
      reinterpret_cast<const void*>(int8_dense_kernel<64, 128, 2, 2, 3>),
      reinterpret_cast<const void*>(int8_dense_kernel<128, 128, 4, 2, 3>),
      reinterpret_cast<const void*>(int8_dense_reduce_kernel),
      reinterpret_cast<const void*>(int8_dense_wgmma_kernel<128>),
      reinterpret_cast<const void*>(int8_dense_wgmma_kernel<256>),
      reinterpret_cast<const void*>(int8_dense_decode_kernel<1>),
      reinterpret_cast<const void*>(int8_dense_decode_kernel<2>),
      reinterpret_cast<const void*>(int8_dense_decode_kernel<3>),
      reinterpret_cast<const void*>(int8_dense_decode_kernel<4>)};
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

const char* mxtt_int8_error_string(int err) {
  if (err == kNoEncoder) return "the driver has no cuTensorMapEncodeTiled";
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
