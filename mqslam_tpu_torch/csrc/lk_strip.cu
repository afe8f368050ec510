// One pyramid level of Lucas-Kanade for T tracks in ANY order, each reading
// its own template and search region from the whole level image.
//
// Replaces the TPU kernel mqslam_tpu/ops/lk_fused_pallas.py::lk_level_fused
// (body `_kernel`).  That kernel copies, per track, a 48-row template strip
// and a 64-row search strip of 128 lanes from device memory into on-chip
// memory, and its contract carries what those copies need on that machine:
// two 64-column-shifted stacked copies of every level, 16-row / 128-lane
// aligned strip origins with residuals, a per-track clip base, tracks padded
// to groups of 8 with a group early exit.  None of that crosses over.  Here
// the images stay plain row-major [R, Wp] in device memory (R = all rows of
// the level, atlas tiles stacked), float or bf16; corners are ABSOLUTE
// (row, col) in that image; reads are clamped to the whole image.
//
// On this card the per-track function is the tiled kernel's (lk_track.cuh:
// one warp per track, what bounds it and what the design does about it are
// written there) with absolute corners, whole-image clamps, any track order
// and two storage types.  bf16 pixels are widened to float as they are
// staged into shared memory; all arithmetic is float.  4 warps per block.

#include "lk_track.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void lk_strip_kernel(
    const T* __restrict__ imgJ, const T* __restrict__ imgI,
    const int* __restrict__ cJ, const int* __restrict__ cI,
    const float* __restrict__ aJ, const float* __restrict__ a0,
    const unsigned char* __restrict__ valid,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out,
    int n_tracks, int R, int Wp, int win, int P, int iters,
    float eps, float hiX, int want_err, int warp_floats) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  if (t >= n_tracks) return;
  lk::track_level(imgJ, imgI, R, Wp, t, cJ, cI, aJ, a0, valid,
                 a_out, eig_out, err_out, smem + (size_t)warp * warp_floats,
                 win, P, iters, eps, hiX, want_err);
}

template <typename T>
int launch(const void* imgJ, const void* imgI, const int* cJ, const int* cI,
           const float* aJ, const float* a0, const unsigned char* valid,
           float* a_out, float* eig_out, float* err_out,
           int n_tracks, int R, int Wp, int win, int P, int iters,
           float eps, float hiX, int want_err, void* stream) {
  const int warp_floats = lk::warp_floats(win, P);
  const size_t smem = (size_t)kWarpsPerBlock * warp_floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        lk_strip_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int blocks = (n_tracks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lk_strip_kernel<T><<<blocks, kWarpsPerBlock * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(imgJ), static_cast<const T*>(imgI), cJ, cI, aJ,
      a0, valid, a_out, eig_out, err_out, n_tracks, R, Wp, win, P, iters,
      eps, hiX, want_err, warp_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  `bf16`
// says whether imgJ / imgI hold __nv_bfloat16 (else float).  Returns
// cudaGetLastError() (0 on success) so a refused launch is reported.
extern "C" int lk_strip_launch(
    const void* imgJ, const void* imgI, const int* cJ, const int* cI,
    const float* aJ, const float* a0, const unsigned char* valid,
    float* a_out, float* eig_out, float* err_out,
    int n_tracks, int R, int Wp, int win, int P, int iters,
    float eps, float hiX, int want_err, int bf16, void* stream) {
  if (n_tracks <= 0) return 0;
  if (R <= 0 || Wp <= 0 || !lk::launch_args_ok(win, P, hiX))
    return (int)cudaErrorInvalidValue;
  auto fn = bf16 ? launch<__nv_bfloat16> : launch<float>;
  return fn(imgJ, imgI, cJ, cI, aJ, a0, valid, a_out, eig_out, err_out,
            n_tracks, R, Wp, win, P, iters, eps, hiX, want_err, stream);
}
