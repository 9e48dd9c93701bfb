// A second design of the whitening apply for Hopper (sm_90a), kept only to
// be measured against dwt_tpu_torch/csrc/whiten_apply.cu, whose function,
// grid and interface it shares (names prefixed dwt_whiten_apply_ldg_): per
// domain of x [D, M, C], y = (x − m) · W_bdᵀ in f32, one launch for all D
// domains.  tools/torch_apply_probe.py builds it into a library of its own
// and times both at every site; the port does not call it.
//
// The design: no TMA and no shared memory.  Each block of the persistent
// grid (split evenly over the domains) walks grid-stride over its domain's
// float4 chunks; each thread issues kLoads float4 loads of x (predicated on
// the ragged end) before it computes or stores any, then reads its group's
// mean and matrix rows through __ldg into registers, and keeps kLoads loads
// in flight per round.  On the H100 it measured 1–2% slower than the TMA
// ring at the large shapes and ~0.2 µs faster a launch at the bucket-1
// shapes (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 4;         // channels per whitening group
constexpr int kMaxThreads = 256;  // block size ceiling (for G ≤ 256)
constexpr int kLoads = 4;         // float4 loads in flight per thread

inline int block_threads(int groups) {
  return groups <= kMaxThreads ? groups * (kMaxThreads / groups) : groups;
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
// threads; block b serves domain b / blocks_per_domain.  x, y: [domains,
// chunks] float4 (chunks = rows · groups); mean: [domains, groups] float4;
// w: [domains, groups, 4] float4 (row k of group g's matrix).
__global__ void __launch_bounds__(512)
whiten_apply_ldg_kernel(const float4* __restrict__ x,
                        const float4* __restrict__ mean,
                        const float4* __restrict__ w,
                        float4* __restrict__ y, long long chunks, int groups,
                        int blocks_per_domain) {
  const int d = blockIdx.x / blocks_per_domain;
  const long long local = blockIdx.x - d * blocks_per_domain;
  const long long stride = static_cast<long long>(blocks_per_domain) * blockDim.x;
  const float4* xd = x + d * chunks;
  float4* yd = y + d * chunks;
  long long i = local * blockDim.x + threadIdx.x;

  // 1. The first loads of x, before anything else.
  float4 v[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k)
    if (i + k * stride < chunks) v[k] = __ldg(xd + i + k * stride);

  // 2. This thread's group (fixed: blockDim.x and stride are multiples of
  //    groups), its mean and matrix rows into registers.
  const long long dg = static_cast<long long>(d) * groups + threadIdx.x % groups;
  const float4 m = __ldg(mean + dg);
  const float4 w0 = __ldg(w + dg * kGroup), w1 = __ldg(w + dg * kGroup + 1);
  const float4 w2 = __ldg(w + dg * kGroup + 2), w3 = __ldg(w + dg * kGroup + 3);

  // 3. Apply and store kLoads chunks, load the next kLoads, until the
  //    domain's chunks run out.
  while (i < chunks) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (i + k * stride < chunks)
        yd[i + k * stride] = apply_group(v[k], m, w0, w1, w2, w3);
    i += kLoads * stride;
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (i + k * stride < chunks) v[k] = __ldg(xd + i + k * stride);
  }
}

}  // namespace

extern "C" {

// Blocks per domain for x [domains, rows, channels] on the current device:
// the blocks that fit on the card at once, split over the domains, no more
// than one per block_threads chunks of a domain, at least 1.  Returns the
// count, or −cudaError_t on a failed query.
int dwt_whiten_apply_ldg_blocks(long long domains, long long rows,
                                int channels) {
  const int groups = channels / kGroup;
  if (domains <= 0 || rows <= 0 || groups <= 0) return 1;
  const int threads = block_threads(groups);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, whiten_apply_ldg_kernel, threads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  long long per_domain = static_cast<long long>(sms) * per_sm / domains;
  const long long useful = (rows * groups + threads - 1) / threads;
  if (per_domain > useful) per_domain = useful;
  return per_domain < 1 ? 1 : static_cast<int>(per_domain);
}

// y[d] = (x[d] − mean[d]) · blockdiag(w[d])ᵀ for each of the `domains`
// domains of x [domains, rows, C], mean [domains, C], w [domains, C/4, 4,
// 4], y like x, all 16-byte aligned, on `stream`, in one launch of
// domains · blocks_per_domain blocks.  Returns cudaSuccess,
// cudaErrorInvalidValue for shapes the kernel does not take, or the
// launch's error.
int dwt_whiten_apply_ldg_f32(const void* x, const void* mean, const void* w,
                             void* y, long long domains, long long rows,
                             int channels, int blocks_per_domain, void* stream) {
  if (domains <= 0 || rows <= 0 || channels <= 0 || channels % kGroup != 0 ||
      channels > 2048 || blocks_per_domain < 1 ||
      domains * blocks_per_domain > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = channels / kGroup;
  whiten_apply_ldg_kernel<<<static_cast<unsigned>(domains * blocks_per_domain),
                            block_threads(groups), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(mean),
      static_cast<const float4*>(w), static_cast<float4*>(y), rows * groups,
      groups, blocks_per_domain);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
