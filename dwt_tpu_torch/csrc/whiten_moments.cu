// Whitening moments for Hopper (sm_90a): per domain, mean [C] and per-group
// covariance [G, 4, 4] of x [D, M, C], f32 or bf16 in, f32 out, in ONE
// launch.  That is the group size 4 of the reference; every other group
// size g that divides C takes the general body at the end of this file
// ("any group size"): cov [G, g, g], the same reductions.
//
// Replaces the TPU kernel dwt_tpu/ops/pallas_whitening.py::_moments_kernel
// (line 68, launched by _moments_call), the batch statistics of every
// whitened site of ResNet-DWT in train mode: the stem dn1 and every
// stage-1 norm site.  The TPU path calls it once per domain branch; here
// one launch takes all D domain branches of a site (11 launches per train
// step, not 33).
//
// What it computes, for each domain d, x[d] [M, C] channels-last with
// C = 4G:
//     mean[d, c]      = (1/M) Σ_r x[d, r, c]
//     cov[d, g, c, e] = (1/M) Σ_r x[d, r, 4g + c] · x[d, r, 4g + e]
//                       − mean[d, 4g + c] · mean[d, 4g + e]
// (biased), the same function as _moments_call on x[d].  The TPU kernel
// forms the full [C, C] Gram matrix because Mosaic lowers only 2-D dots;
// this kernel accumulates only the per-group 4×4 blocks (10 unique
// products) and the channel sums.
//
// What bounds it: HBM bytes.  One read of x, D·M·C·4 bytes, against ~6
// FLOPs per element.  At the train shapes a site reads 43–173 MB, 13–52 µs
// at 3.35 TB/s.  Its first Hopper design (one launch per domain, then a
// second kernel reducing the per-block partials) lost most of that to
// three things, and this design answers each:
//  * A second launch.  The cross-block reduction now happens inside the
//    one launch.  Blocks form clusters of 8 (the portable cluster size).
//    Each block reduces its threads' sums through shared memory; the
//    cluster sums its 8 block partials through distributed shared memory
//    in rank order (float64) and writes one cluster partial; an arrival
//    counter per domain picks the domain's last cluster to finish, whose 8
//    blocks each take a share of the domain's groups, sum the cluster
//    partials of each in float64 in a fixed order (several threads per
//    statistic, each on a fixed slice of the clusters, 8 loads in flight),
//    and write mean and cov from shared memory.  One last cluster per
//    domain, not one for the site, splits that final work D ways and lets
//    a domain that ends early finish while the others still read.
//    Writers fence (__threadfence) before the cluster barrier that
//    precedes the arrival, and the last cluster reads the partials with
//    L1-bypassing loads (ld.global.cg).  The counters are kMaxDomains
//    int32 per device that the caller zeroes once; each domain's last
//    cluster sets its counter back to 0, so the next launch, or a
//    CUDA-graph replay, finds them zeroed.  Two launches that share the
//    counters must not run at once (one stream).
//  * Launches too small to fill the card.  One launch covers all D·M·G
//    (row, group) chunks of the site.  The grid is persistent: as many
//    clusters as the occupancy query (cudaOccupancyMaxActiveClusters)
//    says fit on the card at once, split evenly over the domains, so every
//    cluster lies in one domain and every block streams one contiguous
//    span of that domain's rows; no partial mixes two domains.
//  * Host time per call.  One C call per site (the wrapper caches the
//    grid per shape), and the occupancy query is made once per shape.
// The streaming read: one thread owns one group of one row at a time, a
// 16-byte float4 load of the group's 4 channels, neighbouring threads on
// neighbouring chunks (coalesced).  The block size is a multiple of G, so
// each thread's group never changes and its 4 sums and 10 products stay in
// f32 registers; the loop issues 4 independent float4 loads before it
// accumulates any, to keep enough bytes in flight per SM.
//
// E[xxᵀ] − m mᵀ cancels leading bits when a channel's mean is large
// against its spread (post-ReLU inputs).  Every thread subtracts its
// domain's row-0 values of the group before accumulating: the covariance
// does not change under a shift, and the shifted sums are small.  The
// shift is added back to the mean in float64.
//
// The bf16 variant (whiten_moments_bf16_kernel) is the same kernel over a
// bf16 x: a thread's group is one 8-byte load of 4 bf16 channels, widened
// to f32 (exactly), and from there it accumulates as the f32 kernel does
// (row-0 shift, f32 partials, float64 cluster and final sums), into f32
// mean and cov.  It computes _moments_kernel's function on a bf16 x, which
// that kernel reads as f32, and reads half the f32 kernel's bytes.
//
// The order of every sum is fixed by the grid, which is fixed per shape:
// two launches give bitwise equal results.  No float atomics; nothing is
// allocated or synchronised here, so the launch can be captured in a CUDA
// graph.
//
// Plain C interface for ctypes (dwt_tpu_torch/ops/cuda_whitening.py): the
// caller asks dwt_whiten_moments_clusters for the clusters per domain,
// allocates the outputs and a float64 scratch of D · clusters · G · 14
// elements, passes device pointers, the counters and the stream, and
// checks the returned cudaError_t.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// MOMENTS_PHASE(k) marks the k-th boundary between the kernel's phases and
// compiles to nothing.  tools/torch_moments_probe.py includes this file
// with it defined to stamp %globaltimer, into a library of its own.
#ifndef MOMENTS_PHASE
#define MOMENTS_PHASE(k)
#endif

namespace {

constexpr int kGroup = 4;         // channels per whitening group
constexpr int kStats = 14;        // 4 sums + 10 unique products per group
constexpr int kMaxThreads = 256;  // block size ceiling (for G ≤ 256)
constexpr int kCluster = 8;       // blocks per cluster (portable size)
constexpr int kLoads = 4;         // float4 loads in flight per thread
constexpr int kMaxDomains = 64;   // arrival counters per device

__host__ __device__ inline int block_threads(int groups) {
  return groups <= kMaxThreads ? groups * (kMaxThreads / groups) : groups;
}

__host__ __device__ inline size_t smem_bytes(int threads) {
  return static_cast<size_t>(threads) * kStats * sizeof(float);
}

// Index of the product (c, e), c <= e, in the order the sums are kept.
__device__ inline int product_index(int c, int e) {
  const int lo = c < e ? c : e, hi = c < e ? e : c;
  // Row offsets of the upper triangle of a 4×4: 0, 4, 7, 9.
  return kGroup + (lo == 0 ? 0 : lo == 1 ? 4 : lo == 2 ? 7 : 9) + (hi - lo);
}

struct Sums {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  float p00 = 0.f, p01 = 0.f, p02 = 0.f, p03 = 0.f, p11 = 0.f;
  float p12 = 0.f, p13 = 0.f, p22 = 0.f, p23 = 0.f, p33 = 0.f;

  __device__ inline void add(const float4 v, const float4 k) {
    const float a0 = v.x - k.x, a1 = v.y - k.y, a2 = v.z - k.z, a3 = v.w - k.w;
    s0 += a0; s1 += a1; s2 += a2; s3 += a3;
    p00 = fmaf(a0, a0, p00); p01 = fmaf(a0, a1, p01);
    p02 = fmaf(a0, a2, p02); p03 = fmaf(a0, a3, p03);
    p11 = fmaf(a1, a1, p11); p12 = fmaf(a1, a2, p12);
    p13 = fmaf(a1, a3, p13); p22 = fmaf(a2, a2, p22);
    p23 = fmaf(a2, a3, p23); p33 = fmaf(a3, a3, p33);
  }

  __device__ inline void store(float* out) const {
    out[0] = s0; out[1] = s1; out[2] = s2; out[3] = s3;
    out[4] = p00; out[5] = p01; out[6] = p02; out[7] = p03;
    out[8] = p11; out[9] = p12; out[10] = p13;
    out[11] = p22; out[12] = p23; out[13] = p33;
  }
};

// A thread's group of 4 channels, widened to f32: one float4 load of an
// f32 x, one 8-byte load of a bf16 x (little-endian: channel 0 in the low
// half of the first word).
__device__ inline float4 load_group(const float4* p) { return __ldg(p); }
__device__ inline float4 load_group(const uint2* p) {
  const uint2 v = __ldg(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// Channel ch of row 0 of a domain's x, as f32.
__device__ inline float row0_value(const float4* xd, int ch) {
  return reinterpret_cast<const float*>(xd)[ch];
}
__device__ inline float row0_value(const uint2* xd, int ch) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(xd)[ch]);
}

// Grid: domains · clusters_per_domain clusters of kCluster blocks, each of
// block_threads(groups) threads and smem_bytes(threads) of shared memory.
// scratch (float64): [domains · clusters_per_domain, groups, kStats], the
// cluster partials.
// In: float4 (f32 x) or uint2 (bf16 x), one group of one row.
template <typename In>
__device__ __forceinline__ void moments_body(
    float* smem, int& last_cluster, const In* __restrict__ x, long long rows,
    int groups, int clusters_per_domain, float* __restrict__ mean,
    float* __restrict__ cov, double* __restrict__ scratch,
    int* __restrict__ counters) {
  // smem: [blockDim.x, kStats] per-thread sums; then its first groups ·
  // kStats floats hold the block's partial.
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, threads = blockDim.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cluster_id = blockIdx.x / kCluster;
  const int d = cluster_id / clusters_per_domain;
  const long long span_blocks =
      static_cast<long long>(clusters_per_domain) * kCluster;
  const long long local_block =
      static_cast<long long>(cluster_id % clusters_per_domain) * kCluster + rank;
  const int per_block = groups * kStats;

  MOMENTS_PHASE(0);
  // 1. Stream this block's rows [r0, r1) of domain d.
  {
    const int g = t % groups;
    const int rows_per_pass = threads / groups;
    const In* xd = x + static_cast<long long>(d) * rows * groups;
    const float4 k = load_group(xd + g);  // the domain's row-0 values: the shift
    const long long r0 = local_block * rows / span_blocks;
    const long long r1 = (local_block + 1) * rows / span_blocks;
    long long row = r0 + t / groups;
    const In* p = xd + row * groups + g;
    Sums acc;
    for (; row + (kLoads - 1) * rows_per_pass < r1;
         row += kLoads * rows_per_pass) {
      float4 v[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) v[i] = load_group(p + i * threads);
#pragma unroll
      for (int i = 0; i < kLoads; ++i) acc.add(v[i], k);
      p += kLoads * threads;
    }
    for (; row < r1; row += rows_per_pass) {
      acc.add(load_group(p), k);
      p += threads;
    }
    acc.store(smem + t * kStats);
  }
  MOMENTS_PHASE(1);
  __syncthreads();

  // 2. The block's partial [groups, kStats]: each (group, statistic) over
  //    its threads j = 0, 1, … in order.  Thread t handles entries
  //    t + i·threads (at most kStats of them, since threads ≥ groups).
  {
    float part[kStats];
    const int per_group = threads / groups;
#pragma unroll
    for (int i = 0; i < kStats; ++i) {
      const int idx = t + i * threads;
      float s = 0.f;
      if (idx < per_block) {
        const int grp = idx / kStats, st = idx % kStats;
        for (int j = 0; j < per_group; ++j)
          s += smem[(j * groups + grp) * kStats + st];
      }
      part[i] = s;
    }
    __syncthreads();  // every read of the per-thread sums is done
#pragma unroll
    for (int i = 0; i < kStats; ++i) {
      const int idx = t + i * threads;
      if (idx < per_block) smem[idx] = part[i];
    }
  }
  MOMENTS_PHASE(2);
  cluster.sync();  // every block's partial is visible to the cluster

  // 3. The cluster's partial: each entry over the 8 blocks in rank order,
  //    in float64, shared out over the cluster's threads.
  double* cluster_partial = scratch;
  for (int idx = rank * threads + t; idx < per_block;
       idx += kCluster * threads) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      s += static_cast<double>(*cluster.map_shared_rank(smem + idx, q));
    cluster_partial[static_cast<long long>(cluster_id) * per_block + idx] = s;
  }
  __threadfence();  // release this cluster's partial before its arrival
  cluster.sync();   // the partial is written; no block reads a peer's smem

  MOMENTS_PHASE(3);
  // 4. Arrival: rank 0 counts the cluster in to its domain and tells its
  //    peers whether it was the domain's last one.
  if (rank == 0 && t == 0) {
    const int last = atomicAdd(counters + d, 1) == clusters_per_domain - 1;
    if (last) {
      __threadfence();    // acquire the domain's other cluster partials
      atomicExch(counters + d, 0);  // reset for the next launch or replay
    }
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      *cluster.map_shared_rank(&last_cluster, q) = last;
  }
  cluster.sync();
  if (!last_cluster) return;
  MOMENTS_PHASE(4);

  // 5. Domain d's last cluster: rank r owns the groups [p_begin, p_end)
  //    and finishes them in shared memory, a chunk of groups at a time.
  //    Each (group, statistic) is the float64 sum over the domain's
  //    cluster partials in cluster order, cut into `splits` consecutive
  //    slices that separate threads sum (8 loads in flight each) and that
  //    are then added in slice order.  The cut depends only on the shape,
  //    so the order of every sum is fixed.
  const int per_rank = (groups + kCluster - 1) / kCluster;
  const int p_begin = rank * per_rank;
  const int p_end = min(groups, p_begin + per_rank);
  // The per-thread sums' room holds 7 · threads doubles: a chunk's slice
  // sums (at most max(threads, items)) and its totals (items ≤ 3 · threads).
  double* stage = reinterpret_cast<double*>(smem);
  const int chunk = (3 * threads) / kStats;
  const double inv = 1.0 / static_cast<double>(rows);
  for (int q0 = p_begin; q0 < p_end; q0 += chunk) {
    const int n = min(chunk, p_end - q0), items = n * kStats;
    const int splits = max(1, min(threads / items, clusters_per_domain));
    double* totals = stage + items * splits;
    for (int w = t; w < items * splits; w += threads) {
      const int item = w / splits, k = w % splits;
      const int grp = q0 + item / kStats, st = item % kStats;
      const int c_end = (k + 1) * clusters_per_domain / splits;
      int c = k * clusters_per_domain / splits;
      const double* src = cluster_partial +
          static_cast<long long>(d) * clusters_per_domain * per_block +
          grp * kStats + st;
      double sum = 0.0;
      for (; c + 7 < c_end; c += 8) {
        double v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = __ldcg(src + static_cast<long long>(c + i) * per_block);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[i];
      }
      for (; c < c_end; ++c)
        sum += __ldcg(src + static_cast<long long>(c) * per_block);
      stage[w] = sum;
    }
    __syncthreads();
    for (int item = t; item < items; item += threads) {
      double sum = 0.0;
      for (int k = 0; k < splits; ++k) sum += stage[item * splits + k];
      totals[item] = sum;
    }
    __syncthreads();

    MOMENTS_PHASE(5);
    // 6. mean and cov of the chunk's groups, one output element per
    //    thread.
    for (int o = t; o < n * kGroup * kGroup; o += threads) {
      const int gl = o / (kGroup * kGroup), ce = o % (kGroup * kGroup);
      const int c = ce / kGroup, e = ce % kGroup;
      const int grp = q0 + gl;
      const double* tot = totals + gl * kStats;
      const double mc = tot[c] * inv, me = tot[e] * inv;
      cov[(static_cast<long long>(d) * groups + grp) * kGroup * kGroup + ce] =
          static_cast<float>(tot[product_index(c, e)] * inv - mc * me);
      if (e == 0) {
        const int ch = grp * kGroup + c;
        const float row0 =
            row0_value(x + static_cast<long long>(d) * rows * groups, ch);
        mean[static_cast<long long>(d) * groups * kGroup + ch] =
            static_cast<float>(static_cast<double>(row0) + mc);
      }
    }
    __syncthreads();  // the next chunk reuses the stage
  }
  MOMENTS_PHASE(6);
}

__global__ void whiten_moments_f32_kernel(const float4* __restrict__ x,
                                          long long rows, int groups,
                                          int clusters_per_domain,
                                          float* __restrict__ mean,
                                          float* __restrict__ cov,
                                          double* __restrict__ scratch,
                                          int* __restrict__ counters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_cluster;
  moments_body(smem, last_cluster, x, rows, groups, clusters_per_domain, mean,
               cov, scratch, counters);
}

// x: [domains, rows, C] bf16, as uint2 groups of 4 channels.
__global__ void whiten_moments_bf16_kernel(const uint2* __restrict__ x,
                                           long long rows, int groups,
                                           int clusters_per_domain,
                                           float* __restrict__ mean,
                                           float* __restrict__ cov,
                                           double* __restrict__ scratch,
                                           int* __restrict__ counters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_cluster;
  moments_body(smem, last_cluster, x, rows, groups, clusters_per_domain, mean,
               cov, scratch, counters);
}

cudaLaunchConfig_t launch_config(long long clusters, int groups,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int threads = block_threads(groups);
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(threads);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters per domain for one of the two kernels (see the C entry).
template <typename In>
int moments_clusters(void (*kernel)(const In*, long long, int, int, float*,
                                    float*, double*, int*),
                     long long domains, long long rows, int channels) {
  const int groups = channels / kGroup;
  if (domains <= 0 || rows <= 0 || groups <= 0) return 1;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(1, groups, nullptr, &attr);
  int fit = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  long long per_domain = fit / domains;
  const long long rows_per_cluster =
      static_cast<long long>(kCluster) * (cfg.blockDim.x / groups);
  const long long useful = (rows + rows_per_cluster - 1) / rows_per_cluster;
  if (per_domain > useful) per_domain = useful;
  return per_domain < 1 ? 1 : static_cast<int>(per_domain);
}

// One launch of one of the two kernels (see the C entries).
template <typename In>
int moments_launch(void (*kernel)(const In*, long long, int, int, float*,
                                  float*, double*, int*),
                   const void* x, void* mean, void* cov, void* scratch,
                   void* counters, long long domains, long long rows,
                   int channels, int clusters_per_domain, void* stream) {
  if (domains <= 0 || domains > kMaxDomains || rows <= 0 || channels <= 0 ||
      channels % kGroup != 0 || channels > 2048 || clusters_per_domain < 1 ||
      domains * clusters_per_domain * kCluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = channels / kGroup;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(domains * clusters_per_domain, groups,
                    static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const In*>(x), rows, groups,
      clusters_per_domain, static_cast<float*>(mean),
      static_cast<float*>(cov), static_cast<double*>(scratch),
      static_cast<int*>(counters));
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}


// ------------------------------------------------------------ any group size
//
// The general body, for every group size g ≠ 4 that divides C (g = 4 keeps
// the kernels above): the same mean and biased cov [G, g, g] per domain.
// Per group it is the Gram product of a [rows, g] slab, g(g + 1)/2 unique
// FMAs per row, about g + 2 FLOPs per element, so what bounds it moves with
// g: bytes below g ≈ 80 in f32 (4 bytes per element) and g ≈ 40 in bf16,
// the FMAs above (H100: 67 TFLOP/s of f32 FMA outside the tensor cores,
// 3.35 TB/s).
//
// A group's g × g output is cut into units of kVec × kVec (kVec = 4 where
// g is a multiple of 4, else 1): the T(T + 1)/2 units (a, b), a ≤ b, of the
// upper triangle of the T × T grid of units, T = g / kVec.  A unit keeps
// kVec² products and the kVec sums of its row channels and of its column
// channels (24 or 3 f32 statistics), so each unit finishes on its own.  A
// thread owns one unit: per row, two reads of staged x (kVec floats each)
// feed kVec² FMAs.  An entry tile is at most kUnitThreads units: whole
// groups where a group has that few units, else a slice of one group's
// units (at g = 256 a group has 2,080 units: the output is tiled over
// blocks, never refused).  A tile with fewer units than threads runs
// copies of its units on disjoint rows (replicas).
//
// A thread's f32 sums cover one staged tile of rows (at most kMaxTileRows)
// and are then added to its float64 totals in shared memory.  Unlike the
// g = 4 kernel, which spreads a block's rows over all its threads, a unit
// here sees every row of its block (thousands at the train sites), and
// one f32 sum over them drifts: with bf16 x, whose shifted values share
// the low bits of the shift, every addition rounds the same way (one f32
// sum per thread put the mean 3.4e-5 and the cov 1.6e-4 from float64 at
// 3 × 56,448 rows, C = 256, g = 64; the tile sums 6.0e-8 and 4.5e-6;
// chip_smoke.py's group_site_parity on an NVIDIA H100).
//
// Everything else is the g = 4 kernel's: f32 FMA accumulation with no
// TF32 or tensor-core reduced precision (the precision rule; the
// statistic feeds a Cholesky), each thread's values shifted by its
// domain's row 0 against cancellation (the shift added back to the mean
// in float64), clusters of 8 blocks per (domain, entry tile) streaming
// contiguous spans of the domain's rows, each block's partial summed over
// its replicas in float64 in order, the cluster's over its 8 blocks in rank
// order in float64 through distributed shared memory, then an arrival
// counter per (domain, entry tile): its last cluster sums the cluster
// partials in float64 in cluster order and writes mean and cov.  One
// launch per site for all D domains; the counters are left zero for the
// next launch or a CUDA-graph replay; the order of every sum is fixed by
// the shape, so two launches are bitwise equal.  Rows are staged in
// shared memory a tile at a time (kTileFloats floats): where g is a
// multiple of 4 in chunks of 4 channels, loaded into registers a tile
// ahead so that the next tile's reads are in flight during this one's
// FMAs; else one element at a time (an entry tile's channels need not
// start at a 16-byte boundary then).

constexpr int kUnitThreads = 256;  // most units of an entry tile
constexpr int kMaxTiles = 4096;    // entry tiles per domain (C ≤ 2048)
constexpr int kTileFloats = 4096;  // staged rows of an entry tile (16 KB)
constexpr int kMaxTileRows = 64;
// 16-byte chunks of a tile per thread: kTileFloats / 4 chunks over a
// block's threads, of which there are at least 129 (units_tile ·
// ⌊256 / units_tile⌋).
constexpr int kStageChunks = 8;

// An entry tile's geometry; the host fills it (make_group_shape) and the
// kernel derives each tile's groups, channels and units from it.
struct GroupShape {
  long long rows;   // rows per domain
  int channels, group, groups;
  int t;            // units per side of a group: group / kVec
  int upg;          // units per group: t (t + 1) / 2
  int gpt;          // whole groups per entry tile (0: a group spans tiles)
  int tpg;          // entry tiles per group (1 when gpt > 0)
  int tiles;        // entry tiles per domain
  int units_tile;   // most units in an entry tile
  int nch_max;      // most channels an entry tile stages
  int tile_rows;    // rows staged at a time
  int clusters;     // clusters per (domain, entry tile)
  int threads;      // block size: units_tile times its replicas
};

__host__ __device__ inline int group_vec(int group) {
  return group % 4 == 0 ? 4 : 1;
}

__host__ __device__ inline int group_stats(int vec) {
  return vec * vec + 2 * vec;
}

// False for a shape the kernel does not take.
bool make_group_shape(long long rows, int channels, int group, int clusters,
                      GroupShape* s) {
  if (rows <= 0 || channels <= 0 || channels > 2048 || group <= 0 ||
      group > channels || channels % group != 0)
    return false;
  const int vec = group_vec(group);
  s->rows = rows;
  s->channels = channels;
  s->group = group;
  s->groups = channels / group;
  s->t = group / vec;
  s->upg = s->t * (s->t + 1) / 2;
  if (s->upg <= kUnitThreads) {
    s->gpt = std::min(s->groups, kUnitThreads / s->upg);
    s->tpg = 1;
    s->tiles = (s->groups + s->gpt - 1) / s->gpt;
    s->units_tile = s->gpt * s->upg;
    s->nch_max = s->gpt * group;
  } else {
    s->gpt = 0;
    s->tpg = (s->upg + kUnitThreads - 1) / kUnitThreads;
    s->tiles = s->groups * s->tpg;
    s->units_tile = kUnitThreads;
    s->nch_max = group;
  }
  if (s->tiles > kMaxTiles) return false;
  s->clusters = clusters;
  s->threads = s->units_tile * std::max(1, kUnitThreads / s->units_tile);
  s->tile_rows = std::max(1, std::min(kMaxTileRows, kTileFloats / s->nch_max));
  // The chunked staging's registers hold a whole tile.
  if (s->tile_rows * s->nch_max > kStageChunks * 4 * s->threads) return false;
  return true;
}

// Floats of a block's shared memory before its float64 totals: the row-0
// shift and the staged rows, rounded up to 16 bytes.
__host__ __device__ inline int group_staged_floats(const GroupShape& s) {
  return ((s.nch_max + 3) / 4 * 4 + s.tile_rows * s.nch_max + 3) / 4 * 4;
}

// Shared memory of a block: the staged floats, then the per-thread float64
// totals [stats, threads] (reused for the block's partial after the rows).
size_t group_smem_bytes(const GroupShape& s) {
  return static_cast<size_t>(group_staged_floats(s)) * sizeof(float) +
         static_cast<size_t>(s.threads) * group_stats(group_vec(s.group)) *
             sizeof(double);
}

// The most any shape asks for: 6,144 staged floats (C ≤ 2048, a tile of at
// most 4,096) and 256 threads × 24 float64 totals.  Above the 48 KB a
// launch gets by default, so each kernel is allowed this much first.
constexpr int kGroupSmemMax = 6144 * 4 + kUnitThreads * 24 * 8;

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Channels p[0..3] as f32: one 16-byte load of f32, one 8-byte load of
// bf16 (p 4-channel aligned).
__device__ inline float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ inline float4 load4(const __nv_bfloat16* p) {
  return load_group(reinterpret_cast<const uint2*>(p));
}

// Unit `tri` of a group's upper triangle (row-major over a ≤ b) → (a, b).
__device__ inline void unit_ab(int tri, int t, int* a, int* b) {
  int row = 0;
  while (tri >= t - row) {
    tri -= t - row;
    ++row;
  }
  *a = row;
  *b = row + tri;
}

// Grid: domains · tiles · clusters clusters of kCluster blocks, s.threads
// threads each; cluster id = (d · tiles + e) · clusters + cluster.
// scratch (float64): [domains · tiles · clusters, units_tile, stats].
// counters: [domains · tiles].
template <typename T, int kVec>
__global__ void __launch_bounds__(kUnitThreads)
whiten_moments_group_kernel(const T* __restrict__ x, const GroupShape s,
                            float* __restrict__ mean, float* __restrict__ cov,
                            double* __restrict__ scratch,
                            int* __restrict__ counters) {
  constexpr int kS = kVec * kVec + 2 * kVec;  // products, row sums, col sums
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_cluster;
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, threads = blockDim.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cluster_id = blockIdx.x / kCluster;
  const int de = cluster_id / s.clusters;
  const int d = de / s.tiles, e = de % s.tiles;

  // This entry tile: its groups, staged channels [c0, c0 + nch), units.
  int gi0, units, tri0, nch;
  if (s.gpt > 0) {
    gi0 = e * s.gpt;
    const int ng = min(s.gpt, s.groups - gi0);
    units = ng * s.upg;
    tri0 = 0;
    nch = ng * s.group;
  } else {
    gi0 = e / s.tpg;
    tri0 = (e % s.tpg) * kUnitThreads;
    units = min(kUnitThreads, s.upg - tri0);
    nch = s.group;
  }
  const int c0 = gi0 * s.group;
  const int reps = threads / units;      // copies of each unit
  const int u = t % units, rep = t / units;
  const bool active = rep < reps;
  int a, b;
  unit_ab(s.gpt > 0 ? u % s.upg : tri0 + u, s.t, &a, &b);
  const int base = (s.gpt > 0 ? u / s.upg : 0) * s.group;
  const int off_a = base + a * kVec, off_b = base + b * kVec;

  const T* xd = x + static_cast<long long>(d) * s.rows * s.channels + c0;
  float* shift = smem;                         // [nch]: the domain's row 0
  float* xs = smem + (s.nch_max + 3) / 4 * 4;  // [tile_rows, nch]
  // [kS, threads]: thread t's float64 totals at acc[i · threads + t].
  double* acc = reinterpret_cast<double*>(smem + group_staged_floats(s));
  for (int c = t; c < nch; c += threads) shift[c] = widen(xd[c]);
#pragma unroll
  for (int i = 0; i < kS; ++i) acc[i * threads + t] = 0.0;
  __syncthreads();

  // 1. Stream this block's rows [r0, r1) of domain d, a tile at a time.
  const long long span_blocks = static_cast<long long>(s.clusters) * kCluster;
  const long long local_block =
      static_cast<long long>(cluster_id % s.clusters) * kCluster + rank;
  const long long r0 = local_block * s.rows / span_blocks;
  const long long r1 = (local_block + 1) * s.rows / span_blocks;
  float prod[kVec * kVec], sum_a[kVec], sum_b[kVec];
#pragma unroll
  for (int i = 0; i < kVec * kVec; ++i) prod[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) sum_a[i] = sum_b[i] = 0.f;
  auto tile_of = [&](long long rt) {
    return static_cast<int>(r1 - rt < s.tile_rows ? r1 - rt
                                                  : static_cast<long long>(s.tile_rows));
  };
  // kVec = 4: every staged row segment starts at a multiple of 4 channels,
  // so the tile moves in chunks of 4 (16 bytes of f32, 8 of bf16), at most
  // kStageChunks a thread, loaded into registers one tile ahead: the next
  // tile's loads are in flight while this one is computed.
  const int per_row = nch / 4;
  float4 ahead[kStageChunks];
  auto fetch = [&](long long rt) {
    const int n = tile_of(rt) * per_row;
#pragma unroll
    for (int i = 0; i < kStageChunks; ++i) {
      const int q = t + i * threads;
      if (q < n)
        ahead[i] = load4(xd + (rt + q / per_row) * s.channels + (q % per_row) * 4);
    }
  };
  if constexpr (kVec == 4) {
    if (r0 < r1) fetch(r0);
  }
  for (long long rt = r0; rt < r1; rt += s.tile_rows) {
    const int nr = tile_of(rt);
    if constexpr (kVec == 4) {
      const int n = nr * per_row;
#pragma unroll
      for (int i = 0; i < kStageChunks; ++i) {
        const int q = t + i * threads;
        if (q < n) {
          const int r = q / per_row, c = (q % per_row) * 4;
          const float4 k = *reinterpret_cast<const float4*>(shift + c);
          *reinterpret_cast<float4*>(xs + r * nch + c) = make_float4(
              ahead[i].x - k.x, ahead[i].y - k.y, ahead[i].z - k.z, ahead[i].w - k.w);
        }
      }
      __syncthreads();
      if (rt + s.tile_rows < r1) fetch(rt + s.tile_rows);
    } else {
      const T* src = xd + rt * s.channels;
      for (int i = t; i < nr * nch; i += threads) {
        const int r = i / nch, c = i - r * nch;
        xs[i] = widen(src[static_cast<long long>(r) * s.channels + c]) - shift[c];
      }
      __syncthreads();
    }
    if (active) {
      for (int r = rep; r < nr; r += reps) {
        float va[kVec], vb[kVec];
        if constexpr (kVec == 4) {
          const float4 pa = *reinterpret_cast<const float4*>(xs + r * nch + off_a);
          const float4 pb = *reinterpret_cast<const float4*>(xs + r * nch + off_b);
          va[0] = pa.x; va[1] = pa.y; va[2] = pa.z; va[3] = pa.w;
          vb[0] = pb.x; vb[1] = pb.y; vb[2] = pb.z; vb[3] = pb.w;
        } else {
          va[0] = xs[r * nch + off_a];
          vb[0] = xs[r * nch + off_b];
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          sum_a[i] += va[i];
          sum_b[i] += vb[i];
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            prod[i * kVec + j] = fmaf(va[i], vb[j], prod[i * kVec + j]);
        }
      }
      // This tile's f32 sums into the thread's float64 totals.
#pragma unroll
      for (int i = 0; i < kVec * kVec; ++i) {
        acc[i * threads + t] += prod[i];
        prod[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[(kVec * kVec + i) * threads + t] += sum_a[i];
        acc[(kVec * kVec + kVec + i) * threads + t] += sum_b[i];
        sum_a[i] = sum_b[i] = 0.f;
      }
    }
    __syncthreads();  // the stage is free for the next tile
  }

  // 2. The block's partial [units, kS] (entry u · kS + i): each statistic
  //    over its replicas in order, in float64, written over the totals.
  const int per_block = units * kS;
  {
    double part[kS];  // per_block ≤ threads · kS
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int idx = t + i * threads;
      double v = 0.0;
      if (idx < per_block) {
        const int uu = idx / kS, st = idx - uu * kS;
        for (int j = 0; j < reps; ++j) v += acc[st * threads + j * units + uu];
      }
      part[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int idx = t + i * threads;
      if (idx < per_block) acc[idx] = part[i];
    }
  }
  cluster.sync();  // every block's partial is visible to the cluster

  // 3. The cluster's partial: each entry over the 8 blocks in rank order,
  //    in float64.
  const long long stride = static_cast<long long>(s.units_tile) * kS;
  for (int idx = rank * threads + t; idx < per_block;
       idx += kCluster * threads) {
    double v = 0.0;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) v += *cluster.map_shared_rank(acc + idx, q);
    scratch[cluster_id * stride + idx] = v;
  }
  __threadfence();  // release this cluster's partial before its arrival
  cluster.sync();

  // 4. Arrival on the (domain, entry tile) counter.
  if (rank == 0 && t == 0) {
    const int last = atomicAdd(counters + de, 1) == s.clusters - 1;
    if (last) {
      __threadfence();  // acquire the other clusters' partials
      atomicExch(counters + de, 0);  // reset for the next launch or replay
    }
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      *cluster.map_shared_rank(&last_cluster, q) = last;
  }
  cluster.sync();
  if (!last_cluster) return;

  // 5. The last cluster: rank r finishes units [r · per_rank, …), one per
  //    thread, each statistic the float64 sum of the cluster partials in
  //    cluster order; then its mean (diagonal units) and cov entries (both
  //    triangles).
  const int per_rank = (units + kCluster - 1) / kCluster;
  const int u_end = min(units, (rank + 1) * per_rank);
  const double inv = 1.0 / static_cast<double>(s.rows);
  const double* partials =
      scratch + static_cast<long long>(de) * s.clusters * stride;
  for (int uu = rank * per_rank + t; uu < u_end; uu += threads) {
    double tot[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      double v = 0.0;
      for (int c = 0; c < s.clusters; ++c)
        v += __ldcg(partials + c * stride + uu * kS + i);
      tot[i] = v;
    }
    int ua, ub;
    unit_ab(s.gpt > 0 ? uu % s.upg : tri0 + uu, s.t, &ua, &ub);
    const int gi = gi0 + (s.gpt > 0 ? uu / s.upg : 0);
    float* cg_out = cov + (static_cast<long long>(d) * s.groups + gi) *
                              s.group * s.group;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const double mi = tot[kVec * kVec + i] * inv;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const double mj = tot[kVec * kVec + kVec + j] * inv;
        const float v = static_cast<float>(tot[i * kVec + j] * inv - mi * mj);
        const int p = ua * kVec + i, q = ub * kVec + j;
        cg_out[p * s.group + q] = v;
        if (ua != ub) cg_out[q * s.group + p] = v;
      }
      if (ua == ub) {
        const int ch = gi * s.group + ua * kVec + i;
        const float row0 = widen(
            x[static_cast<long long>(d) * s.rows * s.channels + ch]);
        mean[static_cast<long long>(d) * s.channels + ch] =
            static_cast<float>(static_cast<double>(row0) + mi);
      }
    }
  }
}

template <typename T>
void* group_moments_kernel(int group) {
  return group_vec(group) == 4
             ? reinterpret_cast<void*>(whiten_moments_group_kernel<T, 4>)
             : reinterpret_cast<void*>(whiten_moments_group_kernel<T, 1>);
}

// Let the kernel for `group` take kGroupSmemMax bytes of shared memory on
// the current device (asked before each query and launch: the attribute
// is per device).
template <typename T>
cudaError_t allow_group_smem(int group) {
  return cudaFuncSetAttribute(group_moments_kernel<T>(group),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kGroupSmemMax);
}

cudaLaunchConfig_t group_launch_config(const GroupShape& s, long long clusters,
                                       cudaStream_t stream,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster), 1, 1);
  cfg.blockDim = dim3(s.threads, 1, 1);
  cfg.dynamicSmemBytes = group_smem_bytes(s);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters per (domain, entry tile): those that fit on the card at once,
// split over the domain's tiles, at most one per kCluster tiles of rows, at
// least 1; or −cudaError_t.
template <typename T>
int group_clusters(long long domains, long long rows, int channels,
                   int group) {
  GroupShape s;
  if (domains <= 0 || !make_group_shape(rows, channels, group, 1, &s))
    return 1;
  cudaError_t err = allow_group_smem<T>(group);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = group_launch_config(s, 1, nullptr, &attr);
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, group_moments_kernel<T>(group), &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  long long per = fit / (domains * s.tiles);
  const long long rows_per_cluster =
      static_cast<long long>(kCluster) * s.tile_rows;
  const long long useful = (rows + rows_per_cluster - 1) / rows_per_cluster;
  if (per > useful) per = useful;
  return per < 1 ? 1 : static_cast<int>(per);
}

template <typename T>
int group_launch(const void* x, void* mean, void* cov, void* scratch,
                 void* counters, long long domains, long long rows,
                 int channels, int group, int clusters, void* stream) {
  GroupShape s;
  if (domains <= 0 || domains > kMaxDomains || clusters < 1 ||
      !make_group_shape(rows, channels, group, clusters, &s) ||
      domains * s.tiles * clusters * kCluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t allowed = allow_group_smem<T>(group);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      group_launch_config(s, domains * s.tiles * clusters,
                          static_cast<cudaStream_t>(stream), &attr);
  const T* xt = static_cast<const T*>(x);
  float* m = static_cast<float*>(mean);
  float* c = static_cast<float*>(cov);
  double* sc = static_cast<double*>(scratch);
  int* ct = static_cast<int*>(counters);
  cudaError_t err =
      group_vec(group) == 4
          ? cudaLaunchKernelEx(&cfg, whiten_moments_group_kernel<T, 4>, xt, s,
                               m, c, sc, ct)
          : cudaLaunchKernelEx(&cfg, whiten_moments_group_kernel<T, 1>, xt, s,
                               m, c, sc, ct);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Largest C the launcher accepts (G ≤ 512 keeps a block a multiple of G
// within 512 threads and its shared memory at most 512 · 14 · 4 bytes).
int dwt_whiten_moments_max_channels() { return 2048; }

// Largest D the launcher accepts: the int32 arrival counters the caller
// keeps per device.
int dwt_whiten_moments_max_domains() { return kMaxDomains; }

// Clusters per domain for x [domains, rows, channels] on the current
// device: the clusters that fit on the card at once, split over the
// domains, at most one per kCluster passes of rows, at least 1.  Returns
// the count, or −cudaError_t on a failed query.  The _bf16 entry: the
// bf16 kernel's.
int dwt_whiten_moments_clusters(long long domains, long long rows,
                                int channels) {
  return moments_clusters(whiten_moments_f32_kernel, domains, rows, channels);
}

int dwt_whiten_moments_clusters_bf16(long long domains, long long rows,
                                     int channels) {
  return moments_clusters(whiten_moments_bf16_kernel, domains, rows,
                          channels);
}

// mean [domains, C], cov [domains, C/4, 4, 4] (f32) of x [domains, rows, C]
// (f32; bf16 for the _bf16 entry) on `stream`, through `scratch` (float64,
// domains · clusters_per_domain · C/4 · 14 elements) and `counters`
// (kMaxDomains int32, zero before the first launch; every launch leaves
// them zero).  Returns cudaSuccess, cudaErrorInvalidValue for shapes the
// kernel does not take, or the launch's error.
int dwt_whiten_moments_f32(const void* x, void* mean, void* cov,
                           void* scratch, void* counters, long long domains,
                           long long rows, int channels,
                           int clusters_per_domain, void* stream) {
  return moments_launch(whiten_moments_f32_kernel, x, mean, cov, scratch,
                        counters, domains, rows, channels, clusters_per_domain,
                        stream);
}

int dwt_whiten_moments_bf16(const void* x, void* mean, void* cov,
                            void* scratch, void* counters, long long domains,
                            long long rows, int channels,
                            int clusters_per_domain, void* stream) {
  return moments_launch(whiten_moments_bf16_kernel, x, mean, cov, scratch,
                        counters, domains, rows, channels, clusters_per_domain,
                        stream);
}

// Any group size g that divides C (g ≠ 4: the entries above).  The plan of
// x [domains, rows, C] on the current device: out[0] = clusters per
// (domain, entry tile), out[1] = the float64 scratch's elements, out[2] =
// the arrival counters' elements.  Returns 0, cudaErrorInvalidValue for a
// shape the kernel does not take, or a failed query's error.
int dwt_whiten_moments_group_plan(long long domains, long long rows,
                                  int channels, int group, int bf16,
                                  long long* out) {
  GroupShape s;
  if (domains <= 0 || domains > kMaxDomains ||
      !make_group_shape(rows, channels, group, 1, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  const int clusters =
      bf16 ? group_clusters<__nv_bfloat16>(domains, rows, channels, group)
           : group_clusters<float>(domains, rows, channels, group);
  if (clusters < 0) return -clusters;
  out[0] = clusters;
  out[1] = domains * s.tiles * clusters * static_cast<long long>(s.units_tile) *
           group_stats(group_vec(group));
  out[2] = domains * s.tiles;
  return 0;
}

// Arrival counters the general kernels may need for one launch (C ≤ 2048,
// D ≤ kMaxDomains): the caller keeps this many int32 per device, zeroed
// once.
int dwt_whiten_moments_group_max_counters() { return kMaxDomains * kMaxTiles; }

// mean [domains, C], cov [domains, C/g, g, g] (f32) of x [domains, rows, C]
// (f32; bf16 for the _bf16 entry) with the plan's clusters, scratch and
// counters (zero before the first launch; every launch leaves them zero).
// Returns cudaSuccess, cudaErrorInvalidValue for shapes the kernel does not
// take, or the launch's error.
int dwt_whiten_moments_group_f32(const void* x, void* mean, void* cov,
                                 void* scratch, void* counters,
                                 long long domains, long long rows,
                                 int channels, int group, int clusters,
                                 void* stream) {
  return group_launch<float>(x, mean, cov, scratch, counters, domains, rows,
                             channels, group, clusters, stream);
}

int dwt_whiten_moments_group_bf16(const void* x, void* mean, void* cov,
                                  void* scratch, void* counters,
                                  long long domains, long long rows,
                                  int channels, int group, int clusters,
                                  void* stream) {
  return group_launch<__nv_bfloat16>(x, mean, cov, scratch, counters, domains,
                                     rows, channels, group, clusters, stream);
}

const char* dwt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
