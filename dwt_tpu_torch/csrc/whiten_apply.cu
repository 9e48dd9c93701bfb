// Whitening apply for Hopper (sm_90a): y = (x - m) · W_bdᵀ, f32.
//
// Replaces the TPU kernel dwt_tpu/ops/pallas_whitening.py::_apply_kernel
// (launched by _apply_call), the eval-mode apply at every whitened site of
// ResNet-DWT: the stem dn1 and every stage-1 norm site.
//
// What it computes: x [M, C] channels-last f32, m [C] f32, w [G, 4, 4] f32
// with C = 4G; for row r and group g,
//     y[r, 4g + d] = Σ_c w[g, d, c] · (x[r, 4g + c] − m[4g + c]).
// The TPU kernel expands w to a dense [C, C] block-diagonal matrix because
// Mosaic lowers only 2-D dots, which costs C/4 wasted FLOPs per useful one.
// This kernel computes the per-group 4×4 mat-vec directly.
//
// What bounds it: HBM bytes.  Each element is read once and written once,
// 2·M·C·4 bytes, against 8 FLOPs per element (a 4×4 mat-vec per 4
// channels): ~1 FLOP per byte, far below the H100's ridge point.
//
// What the design does about it: it moves those bytes and nothing else.
//  * One thread owns one (row, group) at a time: a 16-byte float4 load of
//    the group's 4 channels, subtract the mean, the 4×4 mat-vec in
//    registers, a 16-byte float4 store.  Neighbouring threads touch
//    neighbouring 16-byte chunks, so every warp access is fully coalesced.
//  * A grid-stride loop over the M·G chunks.  The block size and hence the
//    grid stride are multiples of G, so each thread's group never changes:
//    the block stages w and m (at most C·20 bytes) in shared memory once,
//    each thread then copies its group's 16 + 4 floats into registers, and
//    the loop reads nothing but x.
//  * The launch fills the card: up to 8 blocks of ≤256 threads per SM.
//
// Plain C interface for ctypes (dwt_tpu_torch/ops/cuda_whitening.py): the
// caller passes device pointers and the stream, allocates y, and checks
// the returned cudaError_t.  Nothing is allocated or synchronised here.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 4;           // channels per whitening group
constexpr int kMaxThreads = 256;    // block size ceiling
constexpr int kBlocksPerSm = 8;     // 8 × 256 = 2048 threads = a full SM

__global__ void whiten_apply_f32_kernel(const float4* __restrict__ x,
                                        const float* __restrict__ mean,
                                        const float* __restrict__ w,
                                        float4* __restrict__ y,
                                        long long chunks,  // M · G
                                        int groups) {
  extern __shared__ float smem[];
  float* s_w = smem;                        // [G, 4, 4]
  float* s_m = smem + groups * kGroup * kGroup;  // [C]
  for (int i = threadIdx.x; i < groups * kGroup * kGroup; i += blockDim.x)
    s_w[i] = w[i];
  for (int i = threadIdx.x; i < groups * kGroup; i += blockDim.x)
    s_m[i] = mean[i];
  __syncthreads();

  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // blockDim.x is a multiple of groups, so start % groups is this
  // thread's group for every iteration of the loop below.
  const int g = static_cast<int>(start % groups);
  const float* wg = s_w + g * kGroup * kGroup;  // wg[d * 4 + c]
  const float* mg = s_m + g * kGroup;
  const float m0 = mg[0], m1 = mg[1], m2 = mg[2], m3 = mg[3];
  const float w00 = wg[0], w01 = wg[1], w02 = wg[2], w03 = wg[3];
  const float w10 = wg[4], w11 = wg[5], w12 = wg[6], w13 = wg[7];
  const float w20 = wg[8], w21 = wg[9], w22 = wg[10], w23 = wg[11];
  const float w30 = wg[12], w31 = wg[13], w32 = wg[14], w33 = wg[15];

  for (long long i = start; i < chunks; i += stride) {
    const float4 v = x[i];
    const float a0 = v.x - m0, a1 = v.y - m1, a2 = v.z - m2, a3 = v.w - m3;
    float4 o;
    o.x = w00 * a0 + w01 * a1 + w02 * a2 + w03 * a3;
    o.y = w10 * a0 + w11 * a1 + w12 * a2 + w13 * a3;
    o.z = w20 * a0 + w21 * a1 + w22 * a2 + w23 * a3;
    o.w = w30 * a0 + w31 * a1 + w32 * a2 + w33 * a3;
    y[i] = o;
  }
}

}  // namespace

extern "C" {

// Largest C the launcher accepts: w and m staged in shared memory take
// C·20 bytes, kept under the 48 KB static limit; the block holds G ≤ 512
// threads so that a block is always a multiple of G.
int dwt_whiten_apply_max_channels() { return 2048; }

// y[M, C] = (x[M, C] − mean[C]) · blockdiag(w[C/4, 4, 4])ᵀ on `stream`.
// Returns cudaSuccess, cudaErrorInvalidValue for shapes the kernel does
// not take, or the launch's cudaGetLastError().
int dwt_whiten_apply_f32(const void* x, const void* mean, const void* w,
                         void* y, long long rows, int channels,
                         void* stream) {
  if (rows < 0 || channels <= 0 || channels % kGroup != 0 ||
      channels > dwt_whiten_apply_max_channels())
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int groups = channels / kGroup;
  const int threads =
      groups <= kMaxThreads ? groups * (kMaxThreads / groups) : groups;
  const long long chunks = rows * groups;

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long needed = (chunks + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  const size_t smem = static_cast<size_t>(channels) * (kGroup + 1) *
                      sizeof(float);
  whiten_apply_f32_kernel<<<blocks, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(w), static_cast<float4*>(y), chunks, groups);
  return static_cast<int>(cudaGetLastError());
}

const char* dwt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
