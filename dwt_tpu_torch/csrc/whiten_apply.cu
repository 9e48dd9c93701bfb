// Whitening apply for Hopper (sm_90a): per domain, y = (x − m) · W_bdᵀ, f32
// or bf16 x, in ONE launch for all D domains of a whitened site.  The
// kernels below take the reference's group size 4; every other group
// size g that divides C takes the general body at the end of this file
// ("any group size"), w [D, G, g, g].
//
// Replaces the TPU kernel dwt_tpu/ops/pallas_whitening.py::_apply_kernel
// (line 143, launched by _apply_call at line 176): the apply of every
// whitened site of ResNet-DWT (the stem dn1 and every stage-1 norm site) and
// LeNet-DWT (dn1, dn2), in train mode with each domain's batch moments, in
// eval and serving with the frozen ones.  The TPU path calls it once per
// domain branch; here one launch takes all D domains of a train site (11
// launches per ResNet50 train step, not 33) and D = 1 in eval and serving.
//
// What it computes: x [D, M, C] channels-last f32, m [D, C] f32, w [D, G, 4,
// 4] f32 with C = 4G; for domain d, row r and group g,
//     y[d, r, 4g + k] = Σ_c w[d, g, k, c] · (x[d, r, 4g + c] − m[d, 4g + c]).
// The TPU kernel expands w to a dense [C, C] block-diagonal matrix because
// Mosaic lowers only 2-D dots, which costs C/4 wasted FLOPs per useful one.
// This kernel computes the per-group 4×4 mat-vec directly.
//
// What bounds it: HBM bytes.  Each element is read once and written once,
// 2·D·M·C·4 bytes, against 9 FLOPs per element: ~1 FLOP per byte, far
// below the H100's ridge point.  At the ResNet50 train and serve shapes a
// site moves 29–822 MB (9–245 µs at 3.35 TB/s), at the LeNet-DWT train
// shapes 5–13 MB (1.4–3.8 µs), at serve bucket 1 under 0.2 MB.  Its first
// Hopper design (one launch per domain, w and m staged in shared memory
// behind a barrier, one float4 load in flight per thread) lost time in
// three places, and this design answers each:
//  * A fixed cost per launch (~2 µs measured on the H100), paid once per
//    domain.  The domains are in the grid now: the persistent grid (as many
//    blocks as the occupancy query says fit on the card at once, no more
//    than the site has tiles) is split evenly over the domains, each block
//    in one domain, so one launch's fixed cost covers D times the bytes.
//  * A serialized prologue: every block staged all of w and m and waited
//    at a barrier before its first read of x.  Now one thread of each
//    block starts the block's first reads of x at once, and each thread
//    reads its own group's 16 + 4 floats through the read-only path
//    (__ldg) into registers, where they stay for the whole loop.
//  * Too few bytes in flight: one 16-byte load per thread.  The reads are
//    TMA bulk copies now: block b of a domain walks over the domain's
//    tiles b, b + B, b + 2B, … (a tile is kPer · blockDim.x consecutive
//    float4 chunks, 16 KB at 256 threads); one thread issues a 1-D
//    cp.async.bulk of each tile into one of kStages shared-memory stages,
//    completing on that stage's mbarrier, kStages tiles ahead of the
//    block's compute, so up to 48 KB per block (192 KB per SM) are in
//    flight with no register holding a load.  The threads wait on the
//    stage's mbarrier, apply the group matrix to it from shared memory,
//    store with coalesced float4 writes, and a block barrier frees the
//    stage for its next tile.
// One thread owns one group of one row at a time, neighbouring threads on
// neighbouring chunks.  The block size is a multiple of G (252 threads for
// G = 12) and every tile starts at a multiple of G chunks, so each
// thread's group never changes.  A design without TMA (the same grid, 4
// float4 __ldg loads in flight per thread, no shared memory) was measured
// against this one on the H100: 1–2% slower at the large shapes, faster at
// the bucket-1 shapes (tools/whiten_apply_ldg.cu; both times are in
// PERF.md).
//
// The bf16 variant (whiten_apply_bf16_kernel) is the same kernel over
// 16-byte chunks that hold 8 bf16 channels, two groups: one thread owns a
// pair of groups (blocks are multiples of G/2 threads; C must be a
// multiple of 8).  It computes what _apply_kernel computes for a bf16 x:
// xn = bf16(f32(x) − m) with the f32 mean, w (f32 in memory) rounded to
// bf16 once per thread, y = Σ_c bf16(w)·xn in f32 and one rounding to bf16
// on the store.  The products of two bf16 values are exact in f32, so the
// result depends only on the order of the 4-term sum (c = 0, 1, 2, 3), the
// order of its plain version in cuda_whitening.py.  It moves half the f32
// kernel's bytes.
//
// No float atomics, no shared state between launches, nothing allocated or
// synchronised here: two launches give bitwise equal results, and the
// launch can be captured in a CUDA graph.
//
// Plain C interface for ctypes (dwt_tpu_torch/ops/cuda_whitening.py): the
// caller asks dwt_whiten_apply_blocks for the blocks per domain (once per
// shape), allocates y, passes device pointers and the stream, and checks
// the returned cudaError_t.

#include <algorithm>
#include <atomic>
#include <mutex>
#include <type_traits>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 4;         // channels per whitening group
constexpr int kMaxThreads = 256;  // block size ceiling (for G ≤ 256)
constexpr int kMaxGroups = 512;   // G ≤ 512: a block of G threads at most
constexpr int kPer = 4;           // chunks per thread per tile
constexpr int kStages = 3;        // tiles in flight per block
constexpr int kMaxDevices = 64;

inline int block_threads(int groups) {
  return groups <= kMaxThreads ? groups * (kMaxThreads / groups) : groups;
}

inline size_t smem_bytes(int threads) {
  return static_cast<size_t>(kStages) * kPer * threads * sizeof(float4);
}

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ inline bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// One thread: expect `bytes` on `bar`, then bulk-copy them from `src` into
// `dst` (both 16-byte aligned, bytes a multiple of 16).
__device__ inline void bulk_load(void* dst, const void* src, unsigned bytes,
                                 unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ inline float4 apply_group(const float4 v, const float4 m,
                                     const float4 w0, const float4 w1,
                                     const float4 w2, const float4 w3) {
  const float a0 = v.x - m.x, a1 = v.y - m.y, a2 = v.z - m.z, a3 = v.w - m.w;
  float4 o;
  o.x = w0.x * a0 + w0.y * a1 + w0.z * a2 + w0.w * a3;
  o.y = w1.x * a0 + w1.y * a1 + w1.z * a2 + w1.w * a3;
  o.z = w2.x * a0 + w2.y * a1 + w2.z * a2 + w2.w * a3;
  o.w = w3.x * a0 + w3.y * a1 + w3.z * a2 + w3.w * a3;
  return o;
}

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ inline float4 round_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

// The bf16 channels of a 32-bit word (little-endian: the lower channel in
// the low half), widened exactly to f32, and two f32 rounded to bf16
// (round to nearest even) into one word.
__device__ inline float bf16_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ inline float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ inline unsigned pack_bf16(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// The bf16 apply of one group, its 4 channels in words a (0, 1) and b
// (2, 3): xn = bf16(x − m) with the f32 mean, then the bf16-rounded matrix
// rows in f32; returns the 4 outputs rounded to bf16 in two words.
__device__ inline uint2 apply_group_bf16(const unsigned a, const unsigned b,
                                         const float4 m, const float4 w0,
                                         const float4 w1, const float4 w2,
                                         const float4 w3) {
  const float4 xn = round_bf16(make_float4(
      bf16_lo(a) - m.x, bf16_hi(a) - m.y, bf16_lo(b) - m.z, bf16_hi(b) - m.w));
  const float4 o =
      apply_group(xn, make_float4(0.f, 0.f, 0.f, 0.f), w0, w1, w2, w3);
  return make_uint2(pack_bf16(o.x, o.y), pack_bf16(o.z, o.w));
}

// Grid: domains · blocks_per_domain blocks of block_threads(units)
// threads and smem_bytes(threads) of dynamic shared memory; block b serves
// domain b / blocks_per_domain.  x, y: [domains, chunks] 16-byte chunks
// (chunks = rows · units; a chunk is one f32 group, or two bf16 groups);
// mean: [domains, groups] float4; w: [domains, groups, 4] float4 (row k of
// group g's matrix).
template <bool kBf16>
__device__ __forceinline__ void apply_body(
    float4* stage, unsigned long long* full, const float4* __restrict__ x,
    const float4* __restrict__ mean, const float4* __restrict__ w,
    float4* __restrict__ y, long long chunks, int units,
    int blocks_per_domain) {
  constexpr int kPerChunk = kBf16 ? 2 : 1;  // groups per 16-byte chunk
  const int groups = units * kPerChunk;
  const int tile = kPer * blockDim.x;
  const int d = blockIdx.x / blocks_per_domain;
  const long long local = blockIdx.x - d * blocks_per_domain;
  const long long tiles = (chunks + tile - 1) / tile;
  const float4* xd = x + d * chunks;
  float4* yd = y + d * chunks;

  // Tile j of the domain into stage s (one thread).
  auto issue = [&](long long j, int s) {
    const long long base = j * tile;
    const long long n = chunks - base < tile ? chunks - base : tile;
    bulk_load(stage + s * tile, xd + base, static_cast<unsigned>(n * 16),
              full + s);
  };
  // 1. The block's first kStages tiles, before anything else.
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages; ++s)
      if (local + s * blocks_per_domain < tiles)
        issue(local + s * blocks_per_domain, s);
  }
  // 2. This thread's groups (fixed: blockDim.x and every tile start are
  //    multiples of units), their means and matrix rows into registers;
  //    the bf16 variant rounds the rows to bf16 here, once.
  float4 m[kPerChunk], w0[kPerChunk], w1[kPerChunk], w2[kPerChunk],
      w3[kPerChunk];
#pragma unroll
  for (int i = 0; i < kPerChunk; ++i) {
    const long long dg = static_cast<long long>(d) * groups +
                         (threadIdx.x % units) * kPerChunk + i;
    m[i] = __ldg(mean + dg);
    w0[i] = __ldg(w + dg * kGroup);
    w1[i] = __ldg(w + dg * kGroup + 1);
    w2[i] = __ldg(w + dg * kGroup + 2);
    w3[i] = __ldg(w + dg * kGroup + 3);
    if constexpr (kBf16) {
      w0[i] = round_bf16(w0[i]);
      w1[i] = round_bf16(w1[i]);
      w2[i] = round_bf16(w2[i]);
      w3[i] = round_bf16(w3[i]);
    }
  }
  __syncthreads();  // the barriers are initialised

  // 3. Per tile: wait for its stage, apply and store, free the stage for
  //    the tile kStages ahead.
  int s = 0;
  unsigned parity = 0;
  for (long long j = local; j < tiles; j += blocks_per_domain) {
    while (!mbar_try_wait(full + s, parity)) {
    }
    const long long base = j * tile;
    const float4* st = stage + s * tile;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int idx = threadIdx.x + k * blockDim.x;
      if (base + idx < chunks) {
        if constexpr (kBf16) {
          // Channels 0–3 (group 0) in words x, y; 4–7 (group 1) in z, w.
          const float4 v = st[idx];
          const uint2 g0 = apply_group_bf16(
              __float_as_uint(v.x), __float_as_uint(v.y), m[0], w0[0], w1[0],
              w2[0], w3[0]);
          const uint2 g1 = apply_group_bf16(
              __float_as_uint(v.z), __float_as_uint(v.w), m[kPerChunk - 1],
              w0[kPerChunk - 1], w1[kPerChunk - 1], w2[kPerChunk - 1],
              w3[kPerChunk - 1]);
          yd[base + idx] =
              make_float4(__uint_as_float(g0.x), __uint_as_float(g0.y),
                          __uint_as_float(g1.x), __uint_as_float(g1.y));
        } else {
          yd[base + idx] = apply_group(st[idx], m[0], w0[0], w1[0], w2[0],
                                       w3[0]);
        }
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && j + kStages * blocks_per_domain < tiles)
      issue(j + kStages * blocks_per_domain, s);
    if (++s == kStages) {
      s = 0;
      parity ^= 1;
    }
  }
}

// The f32 kernel: x, y [domains, rows · G] float4, units = G.
__global__ void __launch_bounds__(kMaxGroups)
whiten_apply_f32_kernel(const float4* __restrict__ x,
                        const float4* __restrict__ mean,
                        const float4* __restrict__ w, float4* __restrict__ y,
                        long long chunks, int units, int blocks_per_domain) {
  extern __shared__ __align__(128) float4 stage[];  // [kStages][tile]
  __shared__ __align__(8) unsigned long long full[kStages];
  apply_body<false>(stage, full, x, mean, w, y, chunks, units,
                    blocks_per_domain);
}

// The bf16 kernel: x, y [domains, rows · G/2] chunks of 8 bf16, units = G/2.
__global__ void __launch_bounds__(kMaxGroups)
whiten_apply_bf16_kernel(const float4* __restrict__ x,
                         const float4* __restrict__ mean,
                         const float4* __restrict__ w, float4* __restrict__ y,
                         long long chunks, int units, int blocks_per_domain) {
  extern __shared__ __align__(128) float4 stage[];  // [kStages][tile]
  __shared__ __align__(8) unsigned long long full[kStages];
  apply_body<true>(stage, full, x, mean, w, y, chunks, units,
                   blocks_per_domain);
}

// Allows both kernels the dynamic shared memory of their largest block on
// the current device, once per device; returns the device's error, if any.
cudaError_t prepare_device(int* device) {
  static std::atomic<bool> prepared[kMaxDevices];
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  const bool cached = *device < kMaxDevices;
  if (cached && prepared[*device].load()) return cudaSuccess;
  for (const void* kernel :
       {reinterpret_cast<const void*>(whiten_apply_f32_kernel),
        reinterpret_cast<const void*>(whiten_apply_bf16_kernel)}) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxGroups)));
    if (err != cudaSuccess) return err;
  }
  if (cached) prepared[*device].store(true);
  return err;
}

// 16-byte chunks per row: C/4 for f32, C/8 for bf16 (0: C not a whole
// number of chunks, or beyond the launcher's limit).
int row_units(int channels, bool bf16) {
  const int per_chunk = bf16 ? 8 : kGroup;
  if (channels <= 0 || channels % per_chunk != 0 ||
      channels > kGroup * kMaxGroups)
    return 0;
  return channels / per_chunk;
}

int apply_blocks(long long domains, long long rows, int channels, bool bf16) {
  const int units = row_units(channels, bf16);
  if (domains <= 0 || rows <= 0 || units <= 0) return 1;
  const int threads = block_threads(units);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = prepare_device(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm,
        reinterpret_cast<const void*>(bf16 ? whiten_apply_bf16_kernel
                                           : whiten_apply_f32_kernel),
        threads, smem_bytes(threads));
  if (err != cudaSuccess) return -static_cast<int>(err);
  long long per_domain = static_cast<long long>(sms) * per_sm / domains;
  const long long tile = static_cast<long long>(kPer) * threads;
  const long long tiles = (rows * units + tile - 1) / tile;
  if (per_domain > tiles) per_domain = tiles;
  return per_domain < 1 ? 1 : static_cast<int>(per_domain);
}

int apply_launch(const void* x, const void* mean, const void* w, void* y,
                 long long domains, long long rows, int channels,
                 int blocks_per_domain, void* stream, bool bf16) {
  const int units = row_units(channels, bf16);
  if (domains <= 0 || rows <= 0 || units <= 0 || blocks_per_domain < 1 ||
      domains * blocks_per_domain > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  const cudaError_t err = prepare_device(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = block_threads(units);
  void (*kernel)(const float4*, const float4*, const float4*, float4*,
                 long long, int, int) =
      bf16 ? whiten_apply_bf16_kernel : whiten_apply_f32_kernel;
  kernel<<<static_cast<unsigned>(domains * blocks_per_domain), threads,
           smem_bytes(threads), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(mean),
      static_cast<const float4*>(w), static_cast<float4*>(y), rows * units,
      units, blocks_per_domain);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------ any group size
//
// The general bodies, for every group size g ≠ 4 that divides C (g = 4
// keeps the TMA kernels above).  y[d, r, g·i + k] = Σ_c w[d, i, k, c] ·
// (x[d, r, g·i + c] − m[d, g·i + c]), summed in the order c = 0, 1, …,
// g − 1: per group a [rows, g] × [g, g] product.  What bounds it moves with
// g: g FMAs per element against 8 bytes (f32) or 4 (bf16), so on the H100
// (67 TFLOP/s of f32 FMA outside the tensor cores, 3.35 TB/s) bytes below
// g ≈ 80 in f32 and g ≈ 40 in bf16, the FMAs above; and what feeds the
// FMAs: a product read from shared memory costs a load per operand.
//
// Each output is one f32 accumulator, started at −0 (x + (−0) = x, so the
// first FMA gives the exact first product) and updated by FMAs in c order:
// the bf16 products are exact in f32, so each FMA rounds as the add of
// the plain version's running sum does and the bf16 variant is bitwise
// equal to it.  A bf16 x is centred with the f32 mean and rounded to bf16
// (xn = bf16(f32(x) − m), as _apply_kernel rounds it) and w rounded to
// bf16.  No atomics, nothing allocated: two launches are bitwise equal and
// a launch can be captured in a CUDA graph.
//
// Every g that is a multiple of 4 from 8 up takes the tiled body
// (whiten_apply_group_tiled_kernel), built as a GEMM per group.  What held
// the scalar body (below), which took every g before it, at 17% (f32) and
// 9% (bf16) of its bytes bound at g = 64: each thread computed 8 rows of
// one output channel, and
// for every c waited on a __ldg of w whose lanes were g floats apart (32
// L1 lines a warp load) to feed 8 FMAs.  The tiled body:
//  * A block owns one (domain, column tile) and walks row tiles of
//    kTileRows = 128 rows; the grid is persistent (the blocks that fit on
//    the card at once, split over the domain × column-tile pairs).  A
//    column tile is nt ≤ 64 output channels: whole groups where g ≤ 64 (8
//    at g = 8, 1 at g = 64), else an nt-slice of one group.
//  * Its w goes into shared memory transposed, wT[c][n], rounded to bf16
//    there by the bf16 variant: once per block where g ≤ 64 (at most 64 ×
//    64 floats), else one chunk of c at a time.
//  * x moves in chunks of 128 rows × kc input channels (kc = nt where a
//    tile holds several groups, else at most 16 (f32) or 32 (bf16), so
//    that g = 64 streams 4 or 2 chunks and g = 2048 128 or 64) by 16-byte
//    cp.async copies shared by the block's threads (8 bytes where a bf16
//    chunk is not 16-byte aligned) into a ring of 2–4 stages.
//  * A thread owns 8 rows × 8 output channels (× 4 where g is not a
//    multiple of 8) in registers; each output keeps one accumulator across
//    a row tile's chunks, so c still ascends.  The store is two 16-byte
//    writes a row (f32), one (bf16).
//  * One group a tile (g ≥ 32): a landed chunk is centred (and rounded)
//    once into xnT[c][r] (f32, two buffers), one phase centring chunk
//    u + 1 while chunk u is computed, one barrier a phase.  Per c, two
//    16-byte reads of xnT (rows r0..r0+3 and r0+64..r0+67, shared by the 8
//    threads of a row group) and two of wT (w is stored permuted so that a
//    thread's 8 channels are two float4 nt/2 apart: one 128-byte run a
//    quarter warp) feed 64 FMAs.
//  * Several groups a tile (g ≤ 16, and 32 where C ≥ 64): the chunk is
//    centred in place (the bf16 variant rounds it to bf16, which holds it
//    exactly) and each thread reads its rows straight from it, 2 (f32) or
//    4 (bf16) channels a read.
//  * At most 128 registers a thread, no spills (__launch_bounds__(256,
//    2)), and about 56 KB of shared memory a block (the ring takes what w
//    and xnT leave): four blocks of 128 threads an SM.
// What bounds it now: at g = 64 the shared-memory reads.  A thread reads
// 64 bytes of operands per c for 64 FMAs; a warp's 16-byte reads go in
// four quarter-warp passes, so a c costs a warp 16 passes of the SM's one
// per clock against 64 FMA issues on one of its four schedulers: both at
// their limit together, the FMAs at ~40% in practice.  Larger register
// tiles would cut the reads per FMA but need more than 128 registers.
// A g that is not a multiple of 4 (1, 2, 3, 6, …) keeps the scalar body
// (whiten_apply_group_kernel): its groups straddle 16-byte chunks, and no
// model of the repo runs one.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// group_timing, a flagship train step's 11 sites; PERF.md's kernel table):
// device ms a step at g = 8/16/64, f32 0.989/1.035/1.707 (the scalar body
// 1.106/1.286/3.898; bytes bound 0.673), bf16 0.529/0.620/1.493
// (0.767/0.998/3.671; bytes bound 0.337, ordered f32 FMAs 0.54 at g = 64);
// torch.baddbmm 3.75 (f32) and 1.21 ms (bf16) at g = 64.

// ---- the scalar body: g not a multiple of 4

constexpr int kGroupThreads = 256;
constexpr int kGroupRows = 8;            // rows per thread (one channel)
constexpr int kGroupTileFloats = 8192;   // staged tile budget (32 KB)
constexpr int kGroupMaxTileRows = 64;
constexpr int kGroupMaxChannels = 2048;

// Rows per block for C channels: a multiple of kGroupRows, at most
// kGroupTileFloats / C of them (kGroupRows at the least: 64 KB at C = 2048).
int group_tile_rows(int channels) {
  int rows = kGroupTileFloats / channels / kGroupRows * kGroupRows;
  if (rows < kGroupRows) rows = kGroupRows;
  return rows > kGroupMaxTileRows ? kGroupMaxTileRows : rows;
}

// One block per tile of rows of one domain (blockIdx.y), staged centred in
// shared memory; each thread computes kGroupRows rows of one output
// channel, reading w[d, i, k, c] through __ldg, one c at a time.
template <bool kBf16>
__global__ void __launch_bounds__(kGroupThreads)
whiten_apply_group_kernel(const void* __restrict__ xv,
                          const float* __restrict__ mean,
                          const float* __restrict__ w, void* __restrict__ yv,
                          long long rows, int channels, int group,
                          int tile_rows) {
  extern __shared__ __align__(16) float xs[];  // [tile_rows, channels]
  const int d = blockIdx.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int n_rows = static_cast<int>(
      rows - r0 < tile_rows ? rows - r0 : static_cast<long long>(tile_rows));
  const int groups = channels / group;
  const float* md = mean + static_cast<long long>(d) * channels;
  const float* wd = w + static_cast<long long>(d) * groups * group * group;
  const long long base = (static_cast<long long>(d) * rows + r0) * channels;

  // 1. Stage the tile's centred rows.
  const int n = n_rows * channels;
  if constexpr (kBf16) {
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(xv) + base);
    for (int q = threadIdx.x; q < n / 8; q += blockDim.x) {
      const uint4 v = __ldg(src + q);
      const int c = (q * 8) % channels;
      const float4 m0 = __ldg(reinterpret_cast<const float4*>(md + c));
      const float4 m1 = __ldg(reinterpret_cast<const float4*>(md + c + 4));
      float4* dst = reinterpret_cast<float4*>(xs + q * 8);
      dst[0] = round_bf16(make_float4(bf16_lo(v.x) - m0.x, bf16_hi(v.x) - m0.y,
                                      bf16_lo(v.y) - m0.z, bf16_hi(v.y) - m0.w));
      dst[1] = round_bf16(make_float4(bf16_lo(v.z) - m1.x, bf16_hi(v.z) - m1.y,
                                      bf16_lo(v.w) - m1.z, bf16_hi(v.w) - m1.w));
    }
  } else {
    const float4* src =
        reinterpret_cast<const float4*>(static_cast<const float*>(xv) + base);
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x) {
      const float4 v = __ldg(src + q);
      const float4 m =
          __ldg(reinterpret_cast<const float4*>(md + (q * 4) % channels));
      reinterpret_cast<float4*>(xs)[q] =
          make_float4(v.x - m.x, v.y - m.y, v.z - m.z, v.w - m.w);
    }
  }
  __syncthreads();

  // 2. kGroupRows rows × one channel per item; consecutive threads take
  //    consecutive channels.
  const int row_blocks = (n_rows + kGroupRows - 1) / kGroupRows;
  for (int item = threadIdx.x; item < row_blocks * channels;
       item += blockDim.x) {
    const int rb = item / channels, ch = item - rb * channels;
    const int gi = ch / group, k = ch - gi * group;
    const float* wr = wd + (static_cast<long long>(gi) * group + k) * group;
    const float* xb = xs + rb * kGroupRows * channels + gi * group;
    float acc[kGroupRows];
#pragma unroll
    for (int j = 0; j < kGroupRows; ++j) acc[j] = -0.f;
    for (int c = 0; c < group; ++c) {
      float wv = __ldg(wr + c);
      if constexpr (kBf16) wv = round_bf16(wv);
#pragma unroll
      for (int j = 0; j < kGroupRows; ++j)
        acc[j] = fmaf(wv, xb[j * channels + c], acc[j]);
    }
    const int valid = min(kGroupRows, n_rows - rb * kGroupRows);
    const long long out = base + static_cast<long long>(rb) * kGroupRows *
                                     channels + ch;
#pragma unroll
    for (int j = 0; j < kGroupRows; ++j) {
      if (j < valid) {
        if constexpr (kBf16) {
          static_cast<__nv_bfloat16*>(yv)[out + j * channels] =
              __float2bfloat16_rn(acc[j]);
        } else {
          static_cast<float*>(yv)[out + j * channels] = acc[j];
        }
      }
    }
  }
}

// ---- the tiled body: g a multiple of 4, from 8 up


constexpr int kTileRows = 128;             // rows of a row tile
constexpr int kHalfRows = kTileRows / 2;
constexpr int kRowGroups = kTileRows / 8;  // threads along the rows
constexpr int kMaxTileCols = 64;           // output channels of a column tile
constexpr int kTiledThreads = 256;         // most threads of a block
constexpr int kTiledSmem = 56 * 1024;      // aimed at: four blocks an SM
constexpr int kTiledSmemMost = 113 * 1024; // two blocks an SM, at least
constexpr int kMaxRing = 4;
constexpr int kF32Cv = 2;       // input channels an f32 row read covers (in place)
constexpr int kChunkF32 = 16;   // most input channels of one group's chunk, f32
constexpr int kChunkBf16 = 32;  // and bf16

// A launch's geometry, filled on the host (make_apply_plan).
struct ApplyPlan {
  long long rows;     // rows per domain
  int channels, group, groups;
  int nt;             // output channels of a column tile
  int gpt;            // whole groups per column tile (0: nt-slices of one group)
  int tpg;            // column tiles per group (gpt = 0)
  int col_tiles;      // column tiles per domain
  int kc;             // input channels of a staged chunk
  int chunks;         // chunks per row tile
  long long row_tiles;
  int transposed;     // chunks centred into xnT (one group a tile), else in place
  int resident;       // the column tile's w staged once per block
  int stages;         // ring of x chunks
  int ncg;            // threads along the output channels: nt / kK
  int vec;            // bytes per cp.async copy: 16, or 8
  int threads;
  int blocks_per;     // blocks per (domain, column tile)
  int ldr, ldw, ldx;  // row pitches of a stage (x's elements), wT and xnT
  int w_rows;         // rows of one wT: g (resident) or kc
  int nmean;          // means staged: the tile's channels, or the group's
  int off_w, off_x, off_raw, stage_bytes, smem;  // shared-memory layout, bytes
};

// The largest divisor of n that is a multiple of `step` and at most
// `most` (step divides n).
inline int divisor_at_most(int n, int step, int most) {
  for (int v = most / step * step; v > step; v -= step)
    if (n % v == 0) return v;
  return step;
}

// False for a shape the tiled body does not take.
bool make_apply_plan(long long rows, int channels, int group, bool bf16,
                     ApplyPlan* p) {
  if (rows <= 0 || channels <= 0 || channels > kGroupMaxChannels ||
      group < 8 || group % 4 != 0 || channels % group != 0)
    return false;
  const int esize = bf16 ? 2 : 4;
  const int kk = group % 8 == 0 ? 8 : 4;
  const int most_chunk = bf16 ? kChunkBf16 : kChunkF32;
  p->rows = rows;
  p->channels = channels;
  p->group = group;
  p->groups = channels / group;
  if (group <= kMaxTileCols) {
    p->gpt = std::min(p->groups, kMaxTileCols / group);
    p->nt = p->gpt * group;
    p->tpg = 1;
    p->col_tiles = (p->groups + p->gpt - 1) / p->gpt;
    p->kc = p->gpt > 1 ? p->nt : divisor_at_most(group, 4, most_chunk);
    p->resident = 1;
  } else {
    p->gpt = 0;
    p->nt = divisor_at_most(group, kk, kMaxTileCols);
    p->tpg = group / p->nt;
    p->col_tiles = p->groups * p->tpg;
    p->kc = divisor_at_most(group, 4, most_chunk);
    p->resident = 0;
  }
  p->transposed = p->gpt <= 1;
  p->w_rows = p->resident ? group : p->kc;
  p->chunks = p->gpt > 1 ? 1 : group / p->kc;
  p->row_tiles = (rows + kTileRows - 1) / kTileRows;
  p->ncg = p->nt / kk;
  p->threads = kRowGroups * p->ncg;
  // Every chunk starts and ends at a multiple of g (several groups) or of
  // kc (one group's): that unit's bytes decide the copies' width.
  p->vec = (p->gpt > 1 ? group : p->kc) * esize % 16 == 0 ? 16 : 8;
  p->ldr = p->kc + 16 / esize;
  p->ldw = p->nt + 4;
  p->ldx = kTileRows + 4;
  p->nmean = p->gpt > 1 ? p->nt : group;
  p->off_w = (p->nmean + 3) / 4 * 16;
  p->off_x = p->off_w + (p->resident ? 1 : 2) * p->w_rows * p->ldw * 4;
  p->off_raw = p->off_x + (p->transposed ? 2 * p->kc * p->ldx * 4 : 0);
  p->stage_bytes = kTileRows * p->ldr * esize;
  p->stages = 2;
  for (int s = kMaxRing; s > 2; --s)
    if (p->off_raw + s * p->stage_bytes <= kTiledSmem) {
      p->stages = s;
      break;
    }
  p->smem = p->off_raw + p->stages * p->stage_bytes;
  if (p->smem > kTiledSmemMost || p->threads > kTiledThreads) return false;
  p->blocks_per = 1;
  return true;
}

__device__ inline void cp_async(void* dst, const void* src, int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most `pending` (< kMaxRing) of this thread's commit groups are
// in flight.
__device__ inline void cp_async_wait(int pending) {
  if (pending <= 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (pending == 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// Position in wT of the tile's output channel n: a thread's 8 channels
// (kK = 8) sit as two float4, at cg·4 and nt/2 + cg·4.
template <int kK>
__device__ inline int w_position(int n, int nt) {
  if constexpr (kK == 8)
    return ((n >> 2) & 1) * (nt >> 1) + (n >> 3) * 4 + (n & 3);
  return n;
}

// Grid: (domains · col_tiles) · blocks_per blocks of p.threads threads,
// p.smem bytes of shared memory: the means, wT [1 or 2][w_rows][ldw] f32,
// xnT [2][kc][ldx] f32 (kT), then the ring
// [stages][kTileRows][ldr] of x's type.
template <bool kBf16, int kK, bool kT>
__global__ void __launch_bounds__(kTiledThreads, 2)
whiten_apply_group_tiled_kernel(const void* __restrict__ xv,
                                const float* __restrict__ mean,
                                const float* __restrict__ w,
                                void* __restrict__ yv, const ApplyPlan p) {
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  constexpr int kE = sizeof(T);
  constexpr int kCv = kBf16 ? 4 : kF32Cv;  // input channels per row read
  extern __shared__ __align__(128) unsigned char smem[];
  float* ms = reinterpret_cast<float*>(smem);
  float* wT = reinterpret_cast<float*>(smem + p.off_w);
  float* xnT = reinterpret_cast<float*>(smem + p.off_x);
  unsigned char* ring = smem + p.off_raw;
  const int t = threadIdx.x, threads = blockDim.x;

  const int pair = blockIdx.x / p.blocks_per;
  const long long local = blockIdx.x - static_cast<long long>(pair) * p.blocks_per;
  const int d = pair / p.col_tiles, e = pair - d * p.col_tiles;
  // This column tile: groups gi0 … gi0 + ng − 1 (gpt > 0), or the slice
  // [n0, n0 + nt) of group gi0; its first output channel col0 and the
  // width kw of its chunks.
  int gi0, ng, n0;
  if (p.gpt > 0) {
    gi0 = e * p.gpt;
    ng = min(p.gpt, p.groups - gi0);
    n0 = 0;
  } else {
    gi0 = e / p.tpg;
    ng = 1;
    n0 = (e - gi0 * p.tpg) * p.nt;
  }
  const int col0 = gi0 * p.group + n0;
  const int kw = p.gpt > 1 ? ng * p.group : p.kc;
  const long long C = p.channels;
  const T* xd = static_cast<const T*>(xv) + static_cast<long long>(d) * p.rows * C +
                gi0 * p.group;
  const float* wd = w + (static_cast<long long>(d) * p.groups + gi0) * p.group * p.group;

  // This thread: output channels cg·kK + j of the column tile; rows
  // rg·4 + i and 64 + rg·4 + i (kT) or rg + 16·i (in place) of a row
  // tile; consecutive threads on consecutive column slices.
  const int cg = t % p.ncg, rg = t / p.ncg;
  const int grp = p.gpt > 1 ? cg * kK / p.group : 0;  // its group in the tile
  const bool active = grp < ng;
  const int xo = p.gpt > 1 ? grp * p.group : 0;      // its first column
  const int kt = p.gpt > 1 ? p.group : p.kc;          // c per chunk

  // wT[c][position of n] = w of output channel n, input channel c0 + c.
  auto stage_w = [&](float* wdst, int c0, int rows_c, int cols) {
    for (int i = t; i < rows_c * cols; i += threads) {
      const int c = i % rows_c, n = i / rows_c;
      // Row n0 + n of the tile's first group's matrix is output channel n.
      const float v = __ldg(wd + static_cast<long long>(n0 + n) * p.group + c0 + c);
      wdst[c * p.ldw + w_position<kK>(n, p.nt)] = kBf16 ? round_bf16(v) : v;
    }
  };

  const long long mine =
      p.row_tiles > local ? (p.row_tiles - local + p.blocks_per - 1) / p.blocks_per : 0;
  const long long units = mine * p.chunks;
  const unsigned row_bytes = static_cast<unsigned>(kw * kE);
  // Unit u: row tile local + (u / chunks)·blocks_per, chunk u % chunks.
  auto unit_rows = [&](long long u, long long* r0) {
    *r0 = (local + (u / p.chunks) * p.blocks_per) * kTileRows;
    return static_cast<int>(min(static_cast<long long>(kTileRows), p.rows - *r0));
  };
  auto unit_src = [&](long long u, long long r0) {
    return xd + r0 * C + (p.gpt > 1 ? 0 : static_cast<int>(u % p.chunks) * p.kc);
  };
  // Unit u's rows into its stage: copies of p.vec bytes shared by the
  // block's threads (item i = t + k · threads is row i / per_row, piece
  // i % per_row), one commit group per call (empty past the end).
  const int per_row = static_cast<int>(row_bytes) / p.vec;
  const int dr = threads / per_row, dv = threads % per_row;
  auto issue = [&](long long u) {
    if (u < units) {
      long long r0;
      const int nr = unit_rows(u, &r0);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(unit_src(u, r0));
      unsigned char* dst = ring + static_cast<int>(u % p.stages) * p.stage_bytes;
      int r = t / per_row, v = t % per_row;
      while (r < nr) {
        cp_async(dst + r * p.ldr * kE + v * p.vec, src + r * C * kE + v * p.vec, p.vec);
        r += dr;
        v += dv;
        if (v >= per_row) {
          v -= per_row;
          ++r;
        }
      }
    }
    cp_async_commit();
  };

  {
    const float* md = mean + static_cast<long long>(d) * C + gi0 * p.group;
    for (int c = t; c < (p.gpt > 1 ? ng * p.group : p.group); c += threads) ms[c] = __ldg(md + c);
  }
  for (int s = 0; s < p.stages; ++s) issue(s);
  if (p.resident) stage_w(wT, 0, p.group, p.gpt > 1 ? ng * p.group : p.nt);

  float acc[8][kK];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kK; ++j) acc[i][j] = -0.f;

  auto store = [&](long long r0, int nr) {
    const long long ch = col0 + cg * kK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = kT ? (i < 4 ? 0 : kHalfRows) + rg * 4 + (i & 3) : rg + i * kRowGroups;
      if (r < nr) {
        const long long o = (static_cast<long long>(d) * p.rows + r0 + r) * C + ch;
        if constexpr (kBf16) {
          if constexpr (kK == 8) {
            *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(yv) + o) =
                make_uint4(pack_bf16(acc[i][0], acc[i][1]), pack_bf16(acc[i][2], acc[i][3]),
                           pack_bf16(acc[i][4], acc[i][5]), pack_bf16(acc[i][6], acc[i][7]));
          } else {
            *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(yv) + o) =
                make_uint2(pack_bf16(acc[i][0], acc[i][1]), pack_bf16(acc[i][2], acc[i][3]));
          }
        } else {
          float* yo = static_cast<float*>(yv) + o;
          *reinterpret_cast<float4*>(yo) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if constexpr (kK == 8)
            *reinterpret_cast<float4*>(yo + 4) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
#pragma unroll
      for (int j = 0; j < kK; ++j) acc[i][j] = -0.f;
    }
  };

  if constexpr (kT) {
    // One group a tile.  Phase u: unit u + 1 is centred (and rounded) into
    // xnT[(u + 1) & 1] while unit u is computed from xnT[u & 1]; unit
    // u + stages moves into the stage that unit u left.  One barrier a
    // phase.  A thread's items of the centring: item i = t + k · threads
    // is row i % kTileRows, 4-channel column i / kTileRows (consecutive
    // threads on consecutive rows).
    auto centre = [&](long long u) {
      if (u >= units) return;
      long long r0;
      const int nr = unit_rows(u, &r0);
      const int q = static_cast<int>(u % p.chunks);
      const T* raw = reinterpret_cast<const T*>(ring + static_cast<int>(u % p.stages) * p.stage_bytes);
      float* x_t = xnT + (u & 1) * p.kc * p.ldx;
      const float* mc = ms + q * p.kc;
      int r = t % kTileRows, c = (t / kTileRows) * 4;
      const int dr = threads % kTileRows, dc = (threads / kTileRows) * 4;
      for (; c < p.kc; r += dr, c += dc) {
        if (r >= kTileRows) {
          r -= kTileRows;
          c += 4;
          if (c >= p.kc) break;
        }
        if (r < nr) {
          const float4 m = *reinterpret_cast<const float4*>(mc + c);
          float4 v;
          if constexpr (kBf16) {
            const uint2 h = *reinterpret_cast<const uint2*>(raw + r * p.ldr + c);
            v = round_bf16(make_float4(bf16_lo(h.x) - m.x, bf16_hi(h.x) - m.y,
                                       bf16_lo(h.y) - m.z, bf16_hi(h.y) - m.w));
          } else {
            const float4 h = *reinterpret_cast<const float4*>(raw + r * p.ldr + c);
            v = make_float4(h.x - m.x, h.y - m.y, h.z - m.z, h.w - m.w);
          }
          x_t[(c + 0) * p.ldx + r] = v.x;
          x_t[(c + 1) * p.ldx + r] = v.y;
          x_t[(c + 2) * p.ldx + r] = v.z;
          x_t[(c + 3) * p.ldx + r] = v.w;
        }
      }
      if (!p.resident) stage_w(wT + (u & 1) * p.w_rows * p.ldw, q * p.kc, p.kc, p.nt);
    };
    cp_async_wait(p.stages - 1);
    __syncthreads();  // unit 0 in; the means and w in place
    centre(0);
    for (long long u = 0; u < units; ++u) {
      cp_async_wait(p.stages - 2);
      __syncthreads();  // unit u centred, unit u + 1 in, unit u − 1 computed
      issue(u + p.stages);
      centre(u + 1);
      if (active) {
        const int q = static_cast<int>(u % p.chunks);
        const float* xb = xnT + (u & 1) * p.kc * p.ldx + rg * 4;
        const float* wb = (p.resident ? wT + q * p.kc * p.ldw
                                      : wT + (u & 1) * p.w_rows * p.ldw) + cg * 4;
        // Input channel c's 8 rows of xn and kK matrix entries.
        auto load = [&](int c, float* xv8, float* wv) {
          const float4 a0 = *reinterpret_cast<const float4*>(xb + c * p.ldx);
          const float4 a1 = *reinterpret_cast<const float4*>(xb + c * p.ldx + kHalfRows);
          xv8[0] = a0.x; xv8[1] = a0.y; xv8[2] = a0.z; xv8[3] = a0.w;
          xv8[4] = a1.x; xv8[5] = a1.y; xv8[6] = a1.z; xv8[7] = a1.w;
          const float4 b0 = *reinterpret_cast<const float4*>(wb + c * p.ldw);
          wv[0] = b0.x; wv[1] = b0.y; wv[2] = b0.z; wv[3] = b0.w;
          if constexpr (kK == 8) {
            const float4 b1 = *reinterpret_cast<const float4*>(wb + c * p.ldw + (p.nt >> 1));
            wv[4] = b1.x; wv[5] = b1.y; wv[6] = b1.z; wv[7] = b1.w;
          }
        };
#pragma unroll 2
        for (int c = 0; c < kt; ++c) {
          float xv8[8], wv[kK];
          load(c, xv8, wv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < kK; ++j) acc[i][j] = fmaf(xv8[i], wv[j], acc[i][j]);
        }
        if (q == p.chunks - 1) {
          long long r0;
          const int nr = unit_rows(u, &r0);
          store(r0, nr);
        }
      }
    }
  } else {
    // Several groups a tile, one chunk a row tile, centred in place (the
    // bf16 variant rounds it to bf16, which holds it exactly).  A thread's
    // items of the centring: item i = t + k · threads is row i / qpr,
    // 4-channel column i % qpr.
    const int qpr = kw / 4;
    const int dr = threads / qpr, dq = threads % qpr;
    for (long long u = 0; u < units; ++u) {
      const int slot = static_cast<int>(u % p.stages);
      long long r0;
      const int nr = unit_rows(u, &r0);
      T* st = reinterpret_cast<T*>(ring + slot * p.stage_bytes);
      // Commit group k holds unit k: unit u is in once at most stages − 1
      // (u = 0) or stages − 2 groups are still in flight.
      cp_async_wait(u == 0 ? p.stages - 1 : p.stages - 2);
      __syncthreads();  // unit u in; every thread is done with unit u − 1
      if (u > 0) issue(u - 1 + p.stages);  // into unit u − 1's stage
      {
        int r = t / qpr, c = (t % qpr) * 4;
        while (r < nr) {
          const float4 m = *reinterpret_cast<const float4*>(ms + c);
          T* cell = st + r * p.ldr + c;
          if constexpr (kBf16) {
            const uint2 h = *reinterpret_cast<const uint2*>(cell);
            const float4 v = round_bf16(make_float4(bf16_lo(h.x) - m.x, bf16_hi(h.x) - m.y,
                                                    bf16_lo(h.y) - m.z, bf16_hi(h.y) - m.w));
            *reinterpret_cast<uint2*>(cell) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
          } else {
            const float4 v = *reinterpret_cast<const float4*>(cell);
            *reinterpret_cast<float4*>(cell) = make_float4(v.x - m.x, v.y - m.y, v.z - m.z, v.w - m.w);
          }
          r += dr;
          c += dq * 4;
          if (c >= kw) {
            c -= kw;
            ++r;
          }
        }
      }
      __syncthreads();  // the chunk is centred
      if (active) {
        const T* xb = st + rg * p.ldr + xo;
        const float* wb = wT + cg * 4;
        for (int c = 0; c < kt; c += kCv) {
          // The thread's 8 rows at kCv input channels: f32 values, or bf16
          // pairs widened where they are used.
          float xr[8][kBf16 ? 1 : kCv];
          uint2 xh[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const T* cell = xb + i * kRowGroups * p.ldr + c;
            if constexpr (kBf16) {
              xh[i] = *reinterpret_cast<const uint2*>(cell);
            } else if constexpr (kCv == 4) {
              const float4 v = *reinterpret_cast<const float4*>(cell);
              xr[i][0] = v.x;
              xr[i][1] = v.y;
              xr[i][2] = v.z;
              xr[i][3] = v.w;
            } else {
              const float2 v = *reinterpret_cast<const float2*>(cell);
              xr[i][0] = v.x;
              xr[i][1] = v.y;
            }
          }
#pragma unroll
          for (int cc = 0; cc < kCv; ++cc) {
            float wv[kK];
            const float4 b0 = *reinterpret_cast<const float4*>(wb + (c + cc) * p.ldw);
            wv[0] = b0.x; wv[1] = b0.y; wv[2] = b0.z; wv[3] = b0.w;
            if constexpr (kK == 8) {
              const float4 b1 =
                  *reinterpret_cast<const float4*>(wb + (c + cc) * p.ldw + (p.nt >> 1));
              wv[4] = b1.x; wv[5] = b1.y; wv[6] = b1.z; wv[7] = b1.w;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              float xv;
              if constexpr (kBf16) {
                const unsigned word = cc < 2 ? xh[i].x : xh[i].y;
                xv = (cc & 1) ? bf16_hi(word) : bf16_lo(word);
              } else {
                xv = xr[i][cc];
              }
#pragma unroll
              for (int j = 0; j < kK; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
            }
          }
        }
        store(r0, nr);
      }
    }
  }
}

using TiledApplyKernel = void (*)(const void*, const float*, const float*,
                                  void*, const ApplyPlan);

template <bool kT>
TiledApplyKernel tiled_apply_kernel_of(bool bf16, int group) {
  if (group % 8 == 0)
    return bf16 ? whiten_apply_group_tiled_kernel<true, 8, kT>
                : whiten_apply_group_tiled_kernel<false, 8, kT>;
  return bf16 ? whiten_apply_group_tiled_kernel<true, 4, kT>
              : whiten_apply_group_tiled_kernel<false, 4, kT>;
}

// The tiled kernel for a plan: the transposed path where a column tile is
// one group's, the in-place one where it holds several.
TiledApplyKernel tiled_apply_kernel(bool bf16, int group, bool transposed) {
  return transposed ? tiled_apply_kernel_of<true>(bf16, group)
                    : tiled_apply_kernel_of<false>(bf16, group);
}

// Allows the general kernels the shared memory of their largest tile (64
// KB for the scalar body at C = 2048, kTiledSmemMost for the tiled one), once
// per device.
cudaError_t prepare_group_device() {
  static std::atomic<bool> prepared[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && prepared[device].load()) return cudaSuccess;
  const int bytes = static_cast<int>(
      group_tile_rows(kGroupMaxChannels) * kGroupMaxChannels * sizeof(float));
  for (const void* kernel :
       {reinterpret_cast<const void*>(whiten_apply_group_kernel<false>),
        reinterpret_cast<const void*>(whiten_apply_group_kernel<true>)}) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
  }
  for (int bf16 = 0; bf16 < 2; ++bf16) {
    for (int group : {8, 12}) {
      for (bool transposed : {false, true}) {
        err = cudaFuncSetAttribute(
            reinterpret_cast<const void*>(tiled_apply_kernel(bf16, group, transposed)),
            cudaFuncAttributeMaxDynamicSharedMemorySize, kTiledSmemMost);
        if (err != cudaSuccess) return err;
      }
    }
  }
  if (cached) prepared[device].store(true);
  return cudaSuccess;
}

// The tiled body's plan of x [domains, rows, C] at group size g on the
// current device, its blocks per (domain, column tile) from an occupancy
// query (kept per device and shape); 0 or a CUDA error.
int apply_plan(long long domains, long long rows, int channels, int group,
               bool bf16, ApplyPlan* p) {
  if (domains <= 0 || !make_apply_plan(rows, channels, group, bf16, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare_group_device();
  if (err != cudaSuccess) return static_cast<int>(err);
  struct Fit {
    int device, bf16, channels, group, per_sm, sms;
  };
  static std::mutex lock;
  static std::vector<Fit> fits;
  int device = 0, per_sm = -1, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  {
    std::lock_guard<std::mutex> hold(lock);
    for (const Fit& f : fits)
      if (f.device == device && f.bf16 == bf16 && f.channels == channels &&
          f.group == group) {
        per_sm = f.per_sm;
        sms = f.sms;
      }
  }
  if (per_sm < 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm,
          reinterpret_cast<const void*>(tiled_apply_kernel(bf16, group, p->transposed)),
          p->threads, p->smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    std::lock_guard<std::mutex> hold(lock);
    fits.push_back({device, bf16, channels, group, per_sm, sms});
  }
  const long long pairs = domains * p->col_tiles;
  long long per = static_cast<long long>(sms) * std::max(per_sm, 1) / pairs;
  if (per > p->row_tiles) per = p->row_tiles;
  p->blocks_per = per < 1 ? 1 : static_cast<int>(per);
  if (pairs * p->blocks_per > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int apply_group_launch(const void* x, const void* mean, const void* w, void* y,
                       long long domains, long long rows, int channels,
                       int group, void* stream, bool bf16) {
  if (domains <= 0 || domains > 65535 || rows <= 0 || channels <= 0 ||
      channels > kGroupMaxChannels || channels % (bf16 ? 8 : 4) != 0 ||
      group <= 0 || group > channels || channels % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (group % 4 == 0) {
    ApplyPlan p;
    const int rc = apply_plan(domains, rows, channels, group, bf16, &p);
    if (rc != 0) return rc;
    tiled_apply_kernel(bf16, group, p.transposed)<<<
        static_cast<unsigned>(domains * p.col_tiles * p.blocks_per), p.threads,
        p.smem, static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const float*>(mean), static_cast<const float*>(w), y, p);
    return static_cast<int>(cudaGetLastError());
  }
  const int tile_rows = group_tile_rows(channels);
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare_group_device();
  if (err != cudaSuccess) return static_cast<int>(err);
  (bf16 ? whiten_apply_group_kernel<true> : whiten_apply_group_kernel<false>)<<<
      dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(domains), 1),
      kGroupThreads, static_cast<size_t>(tile_rows) * channels * sizeof(float),
      static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float*>(mean), static_cast<const float*>(w), y,
      rows, channels, group, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest C the launcher accepts: G ≤ 512 keeps a block a multiple of G
// within 512 threads (and its stages within 96 KB of shared memory).
int dwt_whiten_apply_max_channels() { return kGroup * kMaxGroups; }

// Blocks per domain for x [domains, rows, channels] on the current device:
// the blocks that fit on the card at once, split over the domains, no more
// than the domain has tiles, at least 1.  Returns the count, or
// −cudaError_t on a failed query.  The _bf16 entry: the bf16 kernel's.
int dwt_whiten_apply_blocks(long long domains, long long rows, int channels) {
  return apply_blocks(domains, rows, channels, false);
}

int dwt_whiten_apply_blocks_bf16(long long domains, long long rows,
                                 int channels) {
  return apply_blocks(domains, rows, channels, true);
}

// y[d] = (x[d] − mean[d]) · blockdiag(w[d])ᵀ for each of the `domains`
// domains of x [domains, rows, C], mean [domains, C], w [domains, C/4, 4,
// 4], y like x, all 16-byte aligned, on `stream`, in one launch of
// domains · blocks_per_domain blocks; x and y f32, mean and w f32.
// Returns cudaSuccess, cudaErrorInvalidValue for shapes the kernel does
// not take, or the launch's error.
int dwt_whiten_apply_f32(const void* x, const void* mean, const void* w,
                         void* y, long long domains, long long rows,
                         int channels, int blocks_per_domain, void* stream) {
  return apply_launch(x, mean, w, y, domains, rows, channels,
                      blocks_per_domain, stream, false);
}

// The same with x and y bf16 (C a multiple of 8), mean and w f32.
int dwt_whiten_apply_bf16(const void* x, const void* mean, const void* w,
                          void* y, long long domains, long long rows,
                          int channels, int blocks_per_domain, void* stream) {
  return apply_launch(x, mean, w, y, domains, rows, channels,
                      blocks_per_domain, stream, true);
}

// Any group size g that divides C (g ≠ 4: the entries above): y[d] = (x[d]
// − mean[d]) · blockdiag(w[d])ᵀ for x [domains, rows, C] (C a multiple of
// 4; of 8 for bf16), mean [domains, C], w [domains, C/g, g, g], y like x,
// all 16-byte aligned, on `stream`, in one launch (the tiled body's
// persistent grid where g is a multiple of 4, else one block per tile of
// rows and domain).  Returns cudaSuccess, cudaErrorInvalidValue for shapes
// the kernel does not take, or the launch's error.
int dwt_whiten_apply_group_f32(const void* x, const void* mean, const void* w,
                               void* y, long long domains, long long rows,
                               int channels, int group, void* stream) {
  return apply_group_launch(x, mean, w, y, domains, rows, channels, group,
                            stream, false);
}

int dwt_whiten_apply_group_bf16(const void* x, const void* mean, const void* w,
                                void* y, long long domains, long long rows,
                                int channels, int group, void* stream) {
  return apply_group_launch(x, mean, w, y, domains, rows, channels, group,
                            stream, true);
}

// The tiled body's geometry for x [domains, rows, C] at group size g on
// the current device (g a multiple of 4 from 8 up; the _bf16 flag: the
// bf16 kernel's): out = {threads, shared-memory bytes, blocks, output
// channels per column tile, input channels per chunk, ring stages, 1 for
// the transposed path, bytes per copy}.
// Returns 0, cudaErrorInvalidValue for a shape it does not take, or a
// failed query's error.
int dwt_whiten_apply_group_plan(long long domains, long long rows,
                                int channels, int group, int bf16,
                                long long* out) {
  ApplyPlan p;
  const int rc = apply_plan(domains, rows, channels, group, bf16 != 0, &p);
  if (rc != 0) return rc;
  out[0] = p.threads;
  out[1] = p.smem;
  out[2] = domains * p.col_tiles * p.blocks_per;
  out[3] = p.nt;
  out[4] = p.kc;
  out[5] = p.stages;
  out[6] = p.transposed;
  out[7] = p.vec;
  return 0;
}

const char* dwt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
