// Whitening moments for Hopper (sm_90a): mean [C] and per-group covariance
// [G, 4, 4] of x [M, C], f32 in and out.
//
// Replaces the TPU kernel dwt_tpu/ops/pallas_whitening.py::_moments_kernel
// (launched by _moments_call), the batch statistics of every whitened site
// of ResNet-DWT in train mode: the stem dn1 and every stage-1 norm site,
// once per domain branch (33 launches per train step).
//
// What it computes: x [M, C] channels-last f32 with C = 4G;
//     mean[c]       = (1/M) Σ_r x[r, c]
//     cov[g, c, d]  = (1/M) Σ_r x[r, 4g + c] · x[r, 4g + d] − mean[4g + c] · mean[4g + d]
// (biased), the same function as _moments_call.  The TPU kernel forms the
// full [C, C] Gram matrix because Mosaic lowers only 2-D dots, so C/4 of
// its products are discarded; this kernel accumulates only the per-group
// 4×4 blocks (10 unique products) and the channel sums.
//
// What bounds it: HBM bytes.  One read of x, M·C·4 bytes, against ~6 FLOPs
// per element.  At the train shapes a launch moves 14–58 MB, 4–17 µs at
// 3.35 TB/s, so the launch latency and the second (reduction) pass below
// are of the same order as the read itself; batching the three domains of
// a site into one launch is the lever for that, in a later change.
//
// What the design does about it:
//  * Pass 1 (moments_partial_kernel) reads x exactly once.  One thread owns
//    one (row, group) chunk at a time: a 16-byte float4 load of the group's
//    4 channels, neighbouring threads on neighbouring chunks (coalesced).
//    A grid-stride loop over the M·G chunks; the block size and hence the
//    stride are multiples of G, so each thread's group never changes and
//    its 4 sums and 10 products stay in f32 registers.  The block then
//    reduces each group's threads through shared memory, in thread order,
//    and writes one partial [G, 14] per block to a scratch buffer.
//  * Blocks run in any order on 132 SMs, so the TPU's grid-carried
//    accumulator becomes a second pass (moments_final_kernel): one block
//    per group sums the partials in a fixed order in float64 and forms
//    mean and cov.  The order of every sum is fixed, so the result is
//    deterministic; there are no atomics.
//  * E[xxᵀ] − m mᵀ cancels leading bits when a channel's mean is large
//    against its spread (post-ReLU inputs).  Every thread subtracts the
//    group's values in row 0 before accumulating: the covariance does not
//    change under a shift, and the shifted sums are small.  The shift is
//    added back to the mean in float64.
//  * Ragged M needs no mask: the loop bound stops at the last row.
//
// Plain C interface for ctypes (dwt_tpu_torch/ops/cuda_whitening.py): the
// caller asks dwt_whiten_moments_blocks for the grid size, allocates the
// outputs and the [blocks, G, 14] f32 scratch, passes device pointers and
// the stream, and checks the returned cudaError_t.  Nothing is allocated
// or synchronised here.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 4;          // channels per whitening group
constexpr int kStats = 14;         // 4 sums + 10 unique products per group
constexpr int kMaxThreads = 256;   // pass-1 block size ceiling
constexpr int kReduceThreads = 128;  // pass-2 block size (a power of two)

__host__ __device__ inline int pass1_threads(int groups) {
  return groups <= kMaxThreads ? groups * (kMaxThreads / groups) : groups;
}

__global__ void moments_partial_kernel(const float4* __restrict__ x,
                                       long long chunks,  // M · G
                                       int groups,
                                       float* __restrict__ partial) {
  extern __shared__ float smem[];  // [blockDim.x, kStats]
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // blockDim.x is a multiple of groups: this thread's group for every
  // iteration, and threadIdx.x = j · groups + g within the block.
  const int g = static_cast<int>(start % groups);
  const float4 k = x[g];  // the group's row-0 values: the shift

  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  float p00 = 0.f, p01 = 0.f, p02 = 0.f, p03 = 0.f, p11 = 0.f;
  float p12 = 0.f, p13 = 0.f, p22 = 0.f, p23 = 0.f, p33 = 0.f;
#pragma unroll 4
  for (long long i = start; i < chunks; i += stride) {
    const float4 v = x[i];
    const float a0 = v.x - k.x, a1 = v.y - k.y, a2 = v.z - k.z, a3 = v.w - k.w;
    s0 += a0; s1 += a1; s2 += a2; s3 += a3;
    p00 = fmaf(a0, a0, p00); p01 = fmaf(a0, a1, p01);
    p02 = fmaf(a0, a2, p02); p03 = fmaf(a0, a3, p03);
    p11 = fmaf(a1, a1, p11); p12 = fmaf(a1, a2, p12);
    p13 = fmaf(a1, a3, p13); p22 = fmaf(a2, a2, p22);
    p23 = fmaf(a2, a3, p23); p33 = fmaf(a3, a3, p33);
  }

  float* mine = smem + threadIdx.x * kStats;
  mine[0] = s0; mine[1] = s1; mine[2] = s2; mine[3] = s3;
  mine[4] = p00; mine[5] = p01; mine[6] = p02; mine[7] = p03;
  mine[8] = p11; mine[9] = p12; mine[10] = p13;
  mine[11] = p22; mine[12] = p23; mine[13] = p33;
  __syncthreads();

  // Each (group, statistic) of the block: its threads j = 0, 1, … in order.
  const int per_group = blockDim.x / groups;
  for (int idx = threadIdx.x; idx < groups * kStats; idx += blockDim.x) {
    const int grp = idx / kStats, s = idx % kStats;
    float acc = 0.f;
    for (int j = 0; j < per_group; ++j)
      acc += smem[(j * groups + grp) * kStats + s];
    partial[(static_cast<long long>(blockIdx.x) * groups + grp) * kStats + s] =
        acc;
  }
}

// Index of the product (c, d), c <= d, in the order pass 1 stores them.
__device__ inline int product_index(int c, int d) {
  const int lo = c < d ? c : d, hi = c < d ? d : c;
  // Row offsets of the upper triangle of a 4×4: 0, 4, 7, 9.
  const int row_start[kGroup] = {0, 4, 7, 9};
  return kGroup + row_start[lo] + (hi - lo);
}

__global__ void moments_final_kernel(const float* __restrict__ partial,
                                     int blocks, int groups,
                                     const float* __restrict__ x,
                                     long long rows,
                                     float* __restrict__ mean,
                                     float* __restrict__ cov) {
  __shared__ double red[kReduceThreads][kStats];
  const int grp = blockIdx.x;
  double acc[kStats];
#pragma unroll
  for (int s = 0; s < kStats; ++s) acc[s] = 0.0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    const float* p = partial + (static_cast<long long>(b) * groups + grp) * kStats;
#pragma unroll
    for (int s = 0; s < kStats; ++s) acc[s] += static_cast<double>(p[s]);
  }
#pragma unroll
  for (int s = 0; s < kStats; ++s) red[threadIdx.x][s] = acc[s];
  __syncthreads();
  for (int width = blockDim.x / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) {
#pragma unroll
      for (int s = 0; s < kStats; ++s)
        red[threadIdx.x][s] += red[threadIdx.x + width][s];
    }
    __syncthreads();
  }

  if (threadIdx.x < kGroup * kGroup) {
    const int c = threadIdx.x / kGroup, d = threadIdx.x % kGroup;
    const double inv = 1.0 / static_cast<double>(rows);
    const double mc = red[0][c] * inv, md = red[0][d] * inv;  // shifted means
    cov[grp * kGroup * kGroup + threadIdx.x] =
        static_cast<float>(red[0][product_index(c, d)] * inv - mc * md);
    if (d == 0) {
      const int ch = grp * kGroup + c;
      mean[ch] = static_cast<float>(static_cast<double>(x[ch]) + mc);
    }
  }
}

}  // namespace

extern "C" {

// Largest C the launcher accepts (G ≤ 512 threads keep a block a multiple
// of G; pass 1's shared memory is then at most 512 · 14 · 4 bytes).
int dwt_whiten_moments_max_channels() { return 2048; }

// Pass-1 grid size for x [rows, channels] on the current device: enough
// blocks to cover the chunks, at most as many as fit on the card at once.
// Returns the count (≥ 1), or −cudaError_t on a failed query.
int dwt_whiten_moments_blocks(long long rows, int channels) {
  const int groups = channels / kGroup;
  if (rows <= 0 || groups <= 0) return 1;
  const int threads = pass1_threads(groups);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, moments_partial_kernel, threads,
      static_cast<size_t>(threads) * kStats * sizeof(float));
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const long long chunks = rows * groups;
  const long long needed = (chunks + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(needed < cap ? needed : cap);
}

// mean[C], cov[C/4, 4, 4] of x[rows, C] on `stream`, through `partial`
// ([blocks, C/4, 14] f32 scratch).  Returns cudaSuccess,
// cudaErrorInvalidValue for shapes the kernel does not take, or the
// launches' cudaGetLastError().
int dwt_whiten_moments_f32(const void* x, void* mean, void* cov,
                           void* partial, long long rows, int channels,
                           int blocks, void* stream) {
  if (rows <= 0 || channels <= 0 || channels % kGroup != 0 ||
      channels > dwt_whiten_moments_max_channels() || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = channels / kGroup;
  const int threads = pass1_threads(groups);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  moments_partial_kernel<<<blocks, threads,
                           static_cast<size_t>(threads) * kStats *
                               sizeof(float),
                           s>>>(static_cast<const float4*>(x),
                                rows * groups, groups,
                                static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_final_kernel<<<groups, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), blocks, groups,
      static_cast<const float*>(x), rows, static_cast<float*>(mean),
      static_cast<float*>(cov));
  return static_cast<int>(cudaGetLastError());
}

const char* dwt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
