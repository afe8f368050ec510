// The Lucas-Kanade Newton loop of one pyramid level for T tracks, each on its
// own pre-extracted patches: a [PJ, PJ] template patch and a [P, P] search
// patch.
//
// Replaces the TPU kernel mqslam_tpu/ops/lk_pallas.py::lk_iterate_pallas
// (body `_kernel`).  That kernel runs one grid step per track with both
// patches in on-chip memory, slices window rows dynamically and interpolates
// columns with a banded matrix product built in registers (the TPU cannot
// slice along lanes).  Its gradients are lerped windows at +-1, which are the
// central differences of one lerped grid (same weights, the cell shifted by
// an integer), and with the template anchor in [1, 2) the (win+3)^2 staging
// region of the shared per-track function is exactly the 24x24 template
// patch.  So on this card K4 IS that function (lk_track.cuh::track_warp, one
// warp per track; what bounds it and what the design does about it are
// written there) with each track's own two patches as its images, corners 0,
// reads clamped to each patch.  What differs from the level kernels: there
// is no `valid` input (every track iterates; the driver gates status), `err`
// is always computed, hiX = P - 2 - win comes from the search patch's side,
// and the template anchor is not clipped.  4 warps per block.

#include "lk_track.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void lk_iterate_kernel(
    const float* __restrict__ pJ, const float* __restrict__ pI,
    const float* __restrict__ aJ, const float* __restrict__ a0,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out, int T, int PJ, int P, int win, int iters,
    float eps, float hiX, int warp_floats) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  if (t >= T) return;
  lk::track_warp(pJ + (size_t)t * PJ * PJ, PJ, PJ, 0, 0, aJ[2 * t],
                 aJ[2 * t + 1], pI + (size_t)t * P * P, P, P, 0, 0,
                 a0[2 * t], a0[2 * t + 1], a_out + 2 * t, eig_out + t,
                 err_out + t, smem + (size_t)warp * warp_floats, win, P,
                 iters, eps, hiX, 1);
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() (0 on success) so a refused launch is reported.
extern "C" int lk_iterate_launch(
    const float* pJ, const float* pI, const float* aJ, const float* a0,
    float* a_out, float* eig_out, float* err_out, int T, int PJ, int P,
    int win, int iters, float eps, float hiX, void* stream) {
  if (T <= 0) return 0;
  if (PJ <= 0 || !lk::launch_args_ok(win, P, hiX))
    return (int)cudaErrorInvalidValue;
  const int warp_floats = lk::warp_floats(win, P);
  const size_t smem = (size_t)kWarpsPerBlock * warp_floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        lk_iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lk_iterate_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      pJ, pI, aJ, a0, a_out, eig_out, err_out, T, PJ, P, win, iters, eps,
      hiX, warp_floats);
  return (int)cudaGetLastError();
}
