// One pyramid level of Lucas-Kanade for T agent-contiguous tracks.
//
// Replaces the TPU kernel mqslam_tpu/ops/lk_tile_pallas.py::lk_level_tiled
// (body `_kernel`).  That kernel keeps each agent's whole image tile
// resident in on-chip memory and slices per-track patches out of it with
// lane rolls; its lane-tile-major layout, guard tile and 8-row padding exist
// only for that machine and are not carried over.  Here the images stay
// plain row-major [A*Hp, Wp] float in device memory; track t belongs to tile
// t / (T / A), its corners are local to that tile and its reads are clamped
// to that tile.
//
// The per-track function, what bounds it on an H100 and what the design does
// about it are in lk_track.cuh (one warp per track); 4 warps per block.

#include "lk_track.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void lk_level_kernel(
    const float* __restrict__ imgJ, const float* __restrict__ imgI,
    const int* __restrict__ cJ, const int* __restrict__ cI,
    const float* __restrict__ aJ, const float* __restrict__ a0,
    const unsigned char* __restrict__ valid,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out,
    int T, int A, int Hp, int Wp, int win, int P, int iters,
    float eps, float hiX, int want_err, int warp_floats) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  if (t >= T) return;
  const size_t tile = (size_t)(t / (T / A)) * Hp * Wp;
  lk::track_level(imgJ + tile, imgI + tile, Hp, Wp, t, cJ, cI, aJ, a0, valid,
                 a_out, eig_out, err_out, smem + (size_t)warp * warp_floats,
                 win, P, iters, eps, hiX, want_err);
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() (0 on success) so a refused launch is reported.
extern "C" int lk_level_launch(
    const float* imgJ, const float* imgI, const int* cJ, const int* cI,
    const float* aJ, const float* a0, const unsigned char* valid,
    float* a_out, float* eig_out, float* err_out,
    int T, int A, int Hp, int Wp, int win, int P, int iters,
    float eps, float hiX, int want_err, void* stream) {
  if (T <= 0) return 0;
  if (A <= 0 || T % A != 0 || !lk::launch_args_ok(win, P, hiX))
    return (int)cudaErrorInvalidValue;
  const int warp_floats = lk::warp_floats(win, P);
  const size_t smem = (size_t)kWarpsPerBlock * warp_floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lk_level_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      imgJ, imgI, cJ, cI, aJ, a0, valid, a_out, eig_out, err_out,
      T, A, Hp, Wp, win, P, iters, eps, hiX, want_err, warp_floats);
  return (int)cudaGetLastError();
}
