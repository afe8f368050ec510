// K1: one pyramid level of Lucas-Kanade for T agent-contiguous tracks.
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
// What bounds it on an H100, and what the design does about it, is written
// in lk_track.cuh.  In short: not bytes (0.017 ms for the fleet's T = 6144)
// but each track's chain of latencies and the instructions around it; so
// the window is compiled in (21, 36), a track's two regions arrive in one
// asynchronous round trip, its window elements live in registers, and a
// persistent grid of 32- or 128-thread groups takes tracks as it frees up.
// The wrapper (ops/lk_tile.py) picks the threads a track from T and the SM
// count; any other window runs the generic one-warp-a-track kernel.

#include "lk_track.cuh"

namespace {

// The compile-time window, LANES threads a track, a persistent grid.
template <int LANES>
__global__ void __launch_bounds__(lk::kBlockThreads, lk::min_blocks(LANES))
lk_level_fixed(const float* __restrict__ imgJ, const float* __restrict__ imgI,
               const int* __restrict__ cJ, const int* __restrict__ cI,
               const float* __restrict__ aJ, const float* __restrict__ a0,
               const unsigned char* __restrict__ valid,
               float* __restrict__ a_out, float* __restrict__ eig_out,
               float* __restrict__ err_out, int T, int A, int Hp, int Wp,
               int iters, float eps, float hiX, int want_err, int* next) {
  extern __shared__ float smem[];
  const int per_tile = T / A;
  lk::for_each_track<lk::kWin, lk::kP, LANES>(
      T, next, smem, [&](int t, int tid, int bar_id, float* mine) {
        const size_t tile = (size_t)(t / per_tile) * Hp * Wp;
        lk::track_level_fixed<lk::kWin, lk::kP, LANES>(
            imgJ + tile, imgI + tile, Hp, Wp, t, cJ, cI, aJ, a0, valid,
            a_out, eig_out, err_out, mine, tid, bar_id, iters, eps, hiX,
            want_err);
      });
}

// Any other window: one warp a track, runtime win and P.
__global__ void lk_level_generic(
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
  const int t = blockIdx.x * (lk::kBlockThreads / 32) + warp;
  if (t >= T) return;
  const size_t tile = (size_t)(t / (T / A)) * Hp * Wp;
  lk::track_level(imgJ + tile, imgI + tile, Hp, Wp, t, cJ, cI, aJ, a0, valid,
                  a_out, eig_out, err_out, smem + (size_t)warp * warp_floats,
                  win, P, iters, eps, hiX, want_err);
}

template <int LANES>
constexpr size_t fixed_smem() {
  using S = lk::Shape<lk::kWin, lk::kP, LANES>;
  return (size_t)S::GROUPS * S::FLOATS * sizeof(float);
}

size_t generic_smem(int win, int P) {
  return (size_t)(lk::kBlockThreads / 32) * lk::warp_floats(win, P) *
         sizeof(float);
}

bool fixed_window(int win, int P) { return win == lk::kWin && P == lk::kP; }

template <int LANES>
int launch_fixed(const float* imgJ, const float* imgI, const int* cJ,
                 const int* cI, const float* aJ, const float* a0,
                 const unsigned char* valid, float* a_out, float* eig_out,
                 float* err_out, int T, int A, int Hp, int Wp, int iters,
                 float eps, float hiX, int want_err, int* next,
                 cudaStream_t stream) {
  constexpr size_t smem = fixed_smem<LANES>();
  static lk::Resident resident;
  int blocks = 0;
  cudaError_t rc = lk::persistent_blocks(
      lk_level_fixed<LANES>, smem, T,
      lk::Shape<lk::kWin, lk::kP, LANES>::GROUPS, resident, &blocks);
  if (rc == cudaSuccess && LANES == 32)
    rc = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return (int)rc;
  lk_level_fixed<LANES><<<blocks, lk::kBlockThreads, smem, stream>>>(
      imgJ, imgI, cJ, cI, aJ, a0, valid, a_out, eig_out, err_out, T, A, Hp,
      Wp, iters, eps, hiX, want_err, next);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  `lanes`
// (32 or 128) is the threads a track for the compile-time window (21, 36);
// any other window takes 32 (one warp a track).  `next` is one int of device
// scratch (the 32-lane grid's track counter, zeroed here).  Returns
// cudaGetLastError() (0 on success) so a refused launch is reported.
extern "C" int lk_level_launch(
    const float* imgJ, const float* imgI, const int* cJ, const int* cI,
    const float* aJ, const float* a0, const unsigned char* valid,
    float* a_out, float* eig_out, float* err_out,
    int T, int A, int Hp, int Wp, int win, int P, int iters,
    float eps, float hiX, int want_err, int lanes, int* next, void* stream) {
  if (T <= 0) return 0;
  if (A <= 0 || T % A != 0 || !lk::launch_args_ok(win, P, hiX))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed_window(win, P)) {
    if (lanes == 32)
      return launch_fixed<32>(imgJ, imgI, cJ, cI, aJ, a0, valid, a_out,
                              eig_out, err_out, T, A, Hp, Wp, iters, eps, hiX,
                              want_err, next, s);
    if (lanes == 128)
      return launch_fixed<128>(imgJ, imgI, cJ, cI, aJ, a0, valid, a_out,
                               eig_out, err_out, T, A, Hp, Wp, iters, eps,
                               hiX, want_err, next, s);
    return (int)cudaErrorInvalidValue;
  }
  if (lanes != 32) return (int)cudaErrorInvalidValue;
  const size_t smem = generic_smem(win, P);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        lk_level_generic, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int per_block = lk::kBlockThreads / 32;
  lk_level_generic<<<(T + per_block - 1) / per_block, lk::kBlockThreads, smem,
                     s>>>(imgJ, imgI, cJ, cI, aJ, a0, valid, a_out, eig_out,
                          err_out, T, A, Hp, Wp, win, P, iters, eps, hiX,
                          want_err, lk::warp_floats(win, P));
  return (int)cudaGetLastError();
}

// out[0..3] = registers a thread, shared bytes a track, resident warps a SM
// (occupancy API), 1 if (win, P) is the compile-time window else 0, for the
// kernel lk_level_launch runs with these arguments.  Returns a CUDA error.
extern "C" int lk_level_info(int win, int P, int lanes, int* out) {
  cudaError_t rc;
  if (fixed_window(win, P) && lanes == 32) {
    rc = lk::kernel_info(lk_level_fixed<32>, fixed_smem<32>(),
                         lk::Shape<lk::kWin, lk::kP, 32>::GROUPS, out);
  } else if (fixed_window(win, P) && lanes == 128) {
    rc = lk::kernel_info(lk_level_fixed<128>, fixed_smem<128>(),
                         lk::Shape<lk::kWin, lk::kP, 128>::GROUPS, out);
  } else if (!fixed_window(win, P) && lanes == 32 && win >= 1 &&
             P >= win + 2) {
    rc = lk::kernel_info(lk_level_generic, generic_smem(win, P),
                         lk::kBlockThreads / 32, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  out[3] = fixed_window(win, P) ? 1 : 0;
  return (int)rc;
}
