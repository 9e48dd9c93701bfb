// Whitening apply for Hopper (sm_90a): per domain, y = (x − m) · W_bdᵀ, f32,
// in ONE launch for all D domains of a whitened site.
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
// No float atomics, no shared state between launches, nothing allocated or
// synchronised here: two launches give bitwise equal results, and the
// launch can be captured in a CUDA graph.
//
// Plain C interface for ctypes (dwt_tpu_torch/ops/cuda_whitening.py): the
// caller asks dwt_whiten_apply_blocks for the blocks per domain (once per
// shape), allocates y, passes device pointers and the stream, and checks
// the returned cudaError_t.

#include <atomic>

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

// Grid: domains · blocks_per_domain blocks of block_threads(groups)
// threads and smem_bytes(threads) of dynamic shared memory; block b serves
// domain b / blocks_per_domain.  x, y: [domains, chunks] float4 (chunks =
// rows · groups); mean: [domains, groups] float4; w: [domains, groups, 4]
// float4 (row k of group g's matrix).
__global__ void __launch_bounds__(kMaxGroups)
whiten_apply_f32_kernel(const float4* __restrict__ x,
                        const float4* __restrict__ mean,
                        const float4* __restrict__ w, float4* __restrict__ y,
                        long long chunks, int groups, int blocks_per_domain) {
  extern __shared__ __align__(128) float4 stage[];  // [kStages][tile]
  __shared__ __align__(8) unsigned long long full[kStages];
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
  // 2. This thread's group (fixed: blockDim.x and every tile start are
  //    multiples of groups), its mean and matrix rows into registers.
  const long long dg = static_cast<long long>(d) * groups + threadIdx.x % groups;
  const float4 m = __ldg(mean + dg);
  const float4 w0 = __ldg(w + dg * kGroup), w1 = __ldg(w + dg * kGroup + 1);
  const float4 w2 = __ldg(w + dg * kGroup + 2), w3 = __ldg(w + dg * kGroup + 3);
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
      if (base + idx < chunks)
        yd[base + idx] = apply_group(st[idx], m, w0, w1, w2, w3);
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

// Allows the kernel the dynamic shared memory of its largest block on the
// current device, once per device; returns the device's error, if any.
cudaError_t prepare_device(int* device) {
  static std::atomic<bool> prepared[kMaxDevices];
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  const bool cached = *device < kMaxDevices;
  if (cached && prepared[*device].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(whiten_apply_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxGroups)));
  if (err == cudaSuccess && cached) prepared[*device].store(true);
  return err;
}

}  // namespace

extern "C" {

// Largest C the launcher accepts: G ≤ 512 keeps a block a multiple of G
// within 512 threads (and its stages within 96 KB of shared memory).
int dwt_whiten_apply_max_channels() { return kGroup * kMaxGroups; }

// Blocks per domain for x [domains, rows, channels] on the current device:
// the blocks that fit on the card at once, split over the domains, no more
// than the domain has tiles, at least 1.  Returns the count, or
// −cudaError_t on a failed query.
int dwt_whiten_apply_blocks(long long domains, long long rows, int channels) {
  const int groups = channels / kGroup;
  if (domains <= 0 || rows <= 0 || groups <= 0 || groups > kMaxGroups) return 1;
  const int threads = block_threads(groups);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = prepare_device(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, whiten_apply_f32_kernel, threads, smem_bytes(threads));
  if (err != cudaSuccess) return -static_cast<int>(err);
  long long per_domain = static_cast<long long>(sms) * per_sm / domains;
  const long long tile = static_cast<long long>(kPer) * threads;
  const long long tiles = (rows * groups + tile - 1) / tile;
  if (per_domain > tiles) per_domain = tiles;
  return per_domain < 1 ? 1 : static_cast<int>(per_domain);
}

// y[d] = (x[d] − mean[d]) · blockdiag(w[d])ᵀ for each of the `domains`
// domains of x [domains, rows, C], mean [domains, C], w [domains, C/4, 4,
// 4], y like x, all 16-byte aligned, on `stream`, in one launch of
// domains · blocks_per_domain blocks.  Returns cudaSuccess,
// cudaErrorInvalidValue for shapes the kernel does not take, or the
// launch's error.
int dwt_whiten_apply_f32(const void* x, const void* mean, const void* w,
                         void* y, long long domains, long long rows,
                         int channels, int blocks_per_domain, void* stream) {
  if (domains <= 0 || rows <= 0 || channels <= 0 || channels % kGroup != 0 ||
      channels > dwt_whiten_apply_max_channels() || blocks_per_domain < 1 ||
      domains * blocks_per_domain > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  const cudaError_t err = prepare_device(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = channels / kGroup;
  const int threads = block_threads(groups);
  whiten_apply_f32_kernel<<<static_cast<unsigned>(domains * blocks_per_domain),
                            threads, smem_bytes(threads),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(mean),
      static_cast<const float4*>(w), static_cast<float4*>(y), rows * groups,
      groups, blocks_per_domain);
  return static_cast<int>(cudaGetLastError());
}

const char* dwt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
