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

#include <atomic>

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
// The general body, for every group size g ≠ 4 that divides C (g = 4 keeps
// the TMA kernels above).  y[d, r, g·i + k] = Σ_c w[d, i, k, c] ·
// (x[d, r, g·i + c] − m[d, g·i + c]), summed in the order c = 0, 1, …,
// g − 1.  What bounds it moves with g: g FMAs per element against 8 bytes
// (f32) or 4 (bf16), so on the H100 (67 TFLOP/s of f32 FMA outside the
// tensor cores, 3.35 TB/s) bytes below g ≈ 80 in f32 and g ≈ 40 in bf16,
// the FMAs above.
// Design, simple first:
//  * One block per tile of rows of one domain (blockIdx.y; up to 64 rows,
//    a multiple of kGroupRows, at most kGroupTileFloats floats): the tile
//    is one contiguous span of x, read with 16-byte loads, centred with the
//    f32 mean (the bf16 variant rounds the centred value to bf16, as
//    _apply_kernel rounds xn) and staged in shared memory as f32.
//  * Each thread computes kGroupRows rows of one output channel: per c, one
//    read of w[d, i, k, c] through the read-only path (__ldg; the bf16
//    variant rounds it to bf16) serves kGroupRows FMAs, and the staged
//    xn[r, g·i + c] reads are broadcasts (the threads of a warp are
//    consecutive channels).  w is never staged: at g = C = 2048 it is 16 MB
//    a domain, far over a block's shared memory, and L1/L2 hold the rows a
//    block re-reads.
//  * Vector reads of 4 consecutive c where g is a multiple of 4 (kVec = 4),
//    else one at a time.
// Measured on the H100 (PERF.md): ~60% of the bytes bound at g = 8 and
// ~17% at g = 64, behind torch.baddbmm there; the lanes of a warp read w
// rows g floats apart, 32 cache lines a warp load, so the FMAs wait on L1.
// A register-tiled body (rows × output channels per thread, w staged per
// chunk of c) is the redesign.
// Each output is one f32 accumulator, started at −0 (x + (−0) = x, so the
// first FMA gives the exact first product) and updated by FMAs in c order:
// the bf16 products are exact in f32, so each FMA rounds as the add of
// the plain version's running sum does and the bf16 variant is bitwise
// equal to it.  No atomics, nothing allocated: two launches are bitwise
// equal and a launch can be captured in a CUDA graph.

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

template <bool kBf16, int kVec>
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
    for (int c = 0; c < group; c += kVec) {
      float wv[kVec];
      if constexpr (kVec == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(wr + c));
        wv[0] = t.x; wv[1] = t.y; wv[2] = t.z; wv[3] = t.w;
      } else {
        wv[0] = __ldg(wr + c);
      }
      if constexpr (kBf16) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) wv[v] = round_bf16(wv[v]);
      }
#pragma unroll
      for (int j = 0; j < kGroupRows; ++j) {
        const float* xr = xb + j * channels + c;
        if constexpr (kVec == 4) {
          const float4 t = *reinterpret_cast<const float4*>(xr);
          acc[j] = fmaf(wv[0], t.x, acc[j]);
          acc[j] = fmaf(wv[1], t.y, acc[j]);
          acc[j] = fmaf(wv[2], t.z, acc[j]);
          acc[j] = fmaf(wv[3], t.w, acc[j]);
        } else {
          acc[j] = fmaf(wv[0], xr[0], acc[j]);
        }
      }
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

using GroupApplyKernel = void (*)(const void*, const float*, const float*,
                                  void*, long long, int, int, int);

GroupApplyKernel group_apply_kernel(bool bf16, int group) {
  if (group % 4 == 0)
    return bf16 ? whiten_apply_group_kernel<true, 4>
                : whiten_apply_group_kernel<false, 4>;
  return bf16 ? whiten_apply_group_kernel<true, 1>
              : whiten_apply_group_kernel<false, 1>;
}

// Allows the four general kernels the shared memory of their largest tile
// (64 KB at C = 2048), once per device.
cudaError_t prepare_group_device() {
  static std::atomic<bool> prepared[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && prepared[device].load()) return cudaSuccess;
  const int bytes = static_cast<int>(
      group_tile_rows(kGroupMaxChannels) * kGroupMaxChannels * sizeof(float));
  for (int bf16 = 0; bf16 < 2; ++bf16) {
    for (int group : {4, 1}) {
      err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(group_apply_kernel(bf16, group)),
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
  }
  if (cached) prepared[device].store(true);
  return cudaSuccess;
}

int apply_group_launch(const void* x, const void* mean, const void* w, void* y,
                       long long domains, long long rows, int channels,
                       int group, void* stream, bool bf16) {
  if (domains <= 0 || domains > 65535 || rows <= 0 || channels <= 0 ||
      channels > kGroupMaxChannels || channels % (bf16 ? 8 : 4) != 0 ||
      group <= 0 || group > channels || channels % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile_rows = group_tile_rows(channels);
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare_group_device();
  if (err != cudaSuccess) return static_cast<int>(err);
  group_apply_kernel(bf16, group)<<<
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
// all 16-byte aligned, on `stream`, in one launch of domains · ⌈rows /
// tile rows⌉ blocks.  Returns cudaSuccess, cudaErrorInvalidValue for
// shapes the kernel does not take, or the launch's error.
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

const char* dwt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
