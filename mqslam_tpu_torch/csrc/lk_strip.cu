// K2: one pyramid level of Lucas-Kanade for T tracks in ANY order, each
// reading its own template and search region from the whole level image.
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
// The per-track function is K1's (lk_track.cuh, where what bounds it on an
// H100 and what the design does about it are written) with absolute
// corners, whole-image clamps, any track order and two storage types.  On
// the single-agent path (T = 384 on 1280x720) one warp a track would leave
// three-quarters of the card empty, each SM running about three long chains;
// the wrapper (ops/lk_fused.py) then gives a track 128 threads, so the launch
// covers every SM and a track's chain is about a quarter as long.  Float
// regions arrive by cp.async in one round trip; bf16 pixels are loaded,
// widened to float and stored, four rows in flight; all arithmetic is float.

#include "lk_track.cuh"

namespace {

// The compile-time window, LANES threads a track, a persistent grid.
template <typename T, int LANES>
__global__ void __launch_bounds__(lk::kBlockThreads, lk::min_blocks(LANES))
lk_strip_fixed(const T* __restrict__ imgJ, const T* __restrict__ imgI,
               const int* __restrict__ cJ, const int* __restrict__ cI,
               const float* __restrict__ aJ, const float* __restrict__ a0,
               const unsigned char* __restrict__ valid,
               float* __restrict__ a_out, float* __restrict__ eig_out,
               float* __restrict__ err_out, int n_tracks, int R, int Wp,
               int iters, float eps, float hiX, int want_err, int* next) {
  extern __shared__ float smem[];
  lk::for_each_track<lk::kWin, lk::kP, LANES>(
      n_tracks, next, smem, [&](int t, int tid, int bar_id, float* mine) {
        lk::track_level_fixed<lk::kWin, lk::kP, LANES>(
            imgJ, imgI, R, Wp, t, cJ, cI, aJ, a0, valid, a_out, eig_out,
            err_out, mine, tid, bar_id, iters, eps, hiX, want_err);
      });
}

// Any other window: one warp a track, runtime win and P.
template <typename T>
__global__ void lk_strip_generic(
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
  const int t = blockIdx.x * (lk::kBlockThreads / 32) + warp;
  if (t >= n_tracks) return;
  lk::track_level(imgJ, imgI, R, Wp, t, cJ, cI, aJ, a0, valid,
                  a_out, eig_out, err_out, smem + (size_t)warp * warp_floats,
                  win, P, iters, eps, hiX, want_err);
}

template <int LANES>
constexpr int groups() {
  return lk::Shape<lk::kWin, lk::kP, LANES>::GROUPS;
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

template <typename T, int LANES>
int launch_fixed(const void* imgJ, const void* imgI, const int* cJ,
                 const int* cI, const float* aJ, const float* a0,
                 const unsigned char* valid, float* a_out, float* eig_out,
                 float* err_out, int n_tracks, int R, int Wp, int iters,
                 float eps, float hiX, int want_err, int* next,
                 cudaStream_t stream) {
  constexpr size_t smem = fixed_smem<LANES>();
  static lk::Resident resident;
  int blocks = 0;
  cudaError_t rc = lk::persistent_blocks(
      lk_strip_fixed<T, LANES>, smem, n_tracks,
      lk::Shape<lk::kWin, lk::kP, LANES>::GROUPS, resident, &blocks);
  if (rc == cudaSuccess && LANES == 32)
    rc = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return (int)rc;
  lk_strip_fixed<T, LANES><<<blocks, lk::kBlockThreads, smem, stream>>>(
      static_cast<const T*>(imgJ), static_cast<const T*>(imgI), cJ, cI, aJ,
      a0, valid, a_out, eig_out, err_out, n_tracks, R, Wp, iters, eps, hiX,
      want_err, next);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* imgJ, const void* imgI, const int* cJ, const int* cI,
           const float* aJ, const float* a0, const unsigned char* valid,
           float* a_out, float* eig_out, float* err_out,
           int n_tracks, int R, int Wp, int win, int P, int iters,
           float eps, float hiX, int want_err, int lanes, int* next,
           cudaStream_t stream) {
  if (fixed_window(win, P)) {
    if (lanes == 32)
      return launch_fixed<T, 32>(imgJ, imgI, cJ, cI, aJ, a0, valid, a_out,
                                 eig_out, err_out, n_tracks, R, Wp, iters,
                                 eps, hiX, want_err, next, stream);
    if (lanes == 128)
      return launch_fixed<T, 128>(imgJ, imgI, cJ, cI, aJ, a0, valid, a_out,
                                  eig_out, err_out, n_tracks, R, Wp, iters,
                                  eps, hiX, want_err, next, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (lanes != 32) return (int)cudaErrorInvalidValue;
  const size_t smem = generic_smem(win, P);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        lk_strip_generic<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int per_block = lk::kBlockThreads / 32;
  lk_strip_generic<T><<<(n_tracks + per_block - 1) / per_block,
                        lk::kBlockThreads, smem, stream>>>(
      static_cast<const T*>(imgJ), static_cast<const T*>(imgI), cJ, cI, aJ,
      a0, valid, a_out, eig_out, err_out, n_tracks, R, Wp, win, P, iters,
      eps, hiX, want_err, lk::warp_floats(win, P));
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  `bf16`
// says whether imgJ / imgI hold __nv_bfloat16 (else float).  `lanes` (32 or
// 128) is the threads a track for the compile-time window (21, 36); any
// other window takes 32 (one warp a track).  `next` is one int of device
// scratch (the 32-lane grid's track counter, zeroed here).  Returns
// cudaGetLastError() (0 on success) so a refused launch is reported.
extern "C" int lk_strip_launch(
    const void* imgJ, const void* imgI, const int* cJ, const int* cI,
    const float* aJ, const float* a0, const unsigned char* valid,
    float* a_out, float* eig_out, float* err_out,
    int n_tracks, int R, int Wp, int win, int P, int iters,
    float eps, float hiX, int want_err, int bf16, int lanes, int* next,
    void* stream) {
  if (n_tracks <= 0) return 0;
  if (R <= 0 || Wp <= 0 || !lk::launch_args_ok(win, P, hiX))
    return (int)cudaErrorInvalidValue;
  auto fn = bf16 ? launch<__nv_bfloat16> : launch<float>;
  return fn(imgJ, imgI, cJ, cI, aJ, a0, valid, a_out, eig_out, err_out,
            n_tracks, R, Wp, win, P, iters, eps, hiX, want_err, lanes, next,
            static_cast<cudaStream_t>(stream));
}

// out[0..3] = registers a thread, shared bytes a track, resident warps a SM
// (occupancy API), 1 if (win, P) is the compile-time window else 0, for the
// kernel lk_strip_launch runs with these arguments.  Returns a CUDA error.
extern "C" int lk_strip_info(int win, int P, int lanes, int bf16, int* out) {
  cudaError_t rc;
  const bool fixed = fixed_window(win, P);
  if (fixed && lanes == 32) {
    rc = bf16 ? lk::kernel_info(lk_strip_fixed<__nv_bfloat16, 32>,
                                fixed_smem<32>(), groups<32>(), out)
              : lk::kernel_info(lk_strip_fixed<float, 32>, fixed_smem<32>(),
                                groups<32>(), out);
  } else if (fixed && lanes == 128) {
    rc = bf16 ? lk::kernel_info(lk_strip_fixed<__nv_bfloat16, 128>,
                                fixed_smem<128>(), groups<128>(), out)
              : lk::kernel_info(lk_strip_fixed<float, 128>,
                                fixed_smem<128>(), groups<128>(), out);
  } else if (!fixed && lanes == 32 && win >= 1 && P >= win + 2) {
    rc = bf16 ? lk::kernel_info(lk_strip_generic<__nv_bfloat16>,
                                generic_smem(win, P), groups<32>(), out)
              : lk::kernel_info(lk_strip_generic<float>,
                                generic_smem(win, P), groups<32>(), out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  out[3] = fixed ? 1 : 0;
  return (int)rc;
}
