// K4: the Lucas-Kanade Newton loop of one pyramid level for T tracks, each on
// its own pre-extracted patches: a [PJ, PJ] template patch and a [P, P]
// search patch.
//
// Replaces the TPU kernel mqslam_tpu/ops/lk_pallas.py::lk_iterate_pallas
// (body `_kernel`).  That kernel runs one grid step per track with both
// patches in on-chip memory, slices window rows dynamically and interpolates
// columns with a banded matrix product built in registers (the TPU cannot
// slice along lanes).  Its gradients are lerped windows at +-1, which are the
// central differences of one lerped grid (same weights, the cell shifted by
// an integer), and with the template anchor in [1, 2) the (win+3)^2 staging
// region of the shared per-track function is exactly the 24x24 template
// patch.  So on this card K4 IS that function (lk_track.cuh) with each
// track's own two patches as its images, corners 0, every read clamped to
// the track's own patch.
//
// What bounds it on an H100: not bytes (a track moves 7.5 KB once: 0.0026 ms
// for 384 tracks at 3.35 TB/s) but each track's dependent chain of up to 30
// Newton steps.  The first design, one warp a track with the window known
// only at run time (`track_warp`), stood 16x / 5.7x above the bound at
// T = 384 / 6144 for the reasons lk_track.cuh lists.  This one runs K1's and
// K2's redesign for the main paths' window (21, 36): the per-track function
// of `track_fixed` (window elements in registers, one copy round trip a
// track, one barrier a Newton step) by 32 or 128 threads a track on a
// persistent grid, the lane shape chosen in Python (ops/lk_iterate.py, the
// level kernels' rule: 128 while T <= 4 x SMs).  Any other window keeps the
// generic one-warp function.
//
// Staging.  K1 and K2 stage regions at arbitrary columns by 4-byte
// `cp.async` into a bank-conflict-free search pitch (53).  K4's two patches
// are contiguous and 16-byte aligned per track (2,304 and 5,184 bytes), so
// here they are copied by 16-byte `cp.async` (a quarter of the copy
// instructions) into a search pitch of 36, a multiple of 4, at the price of
// 2-way bank conflicts on the Newton taps.  Timed against the 4-byte staging
// into pitch 53 on every call lk_track_pyr(impl="pallas") makes over the
// fleet run's 32 frame-groups and the single agent's 48 frames, the 16-byte
// copies were faster at both lane shapes (8 % on the fleet at 32 lanes, 1 %
// on the single agent at 128); only on an input where most tracks take all
// 30 Newton steps did the taps outweigh the copies (PERF.md).
//
// What differs from the level kernels: there is no `valid` input (every track
// iterates; the driver gates status after the call), `err` is always
// computed, hiX = P - 2 - win comes from the search patch's side, and the
// template anchor is not clipped.  A NaN template anchor makes every output
// of its track NaN; every index formed from it is clamped first.

#include "lk_track.cuh"

namespace {

// the search row pitch: whole 16-byte units
constexpr int kSP = (lk::kP + 3) / 4 * 4;

template <int LANES>
using FixedShape = lk::Shape<lk::kWin, lk::kP, LANES, kSP>;

// N4 float4s from src to dst (both 16-byte aligned), the group's threads in
// turn; waited for by the caller.
template <int N4, int LANES>
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int tid) {
#pragma unroll
  for (int k = 0; k < (N4 + LANES - 1) / LANES; ++k) {
    const int i = tid + k * LANES;
    if (i < N4) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + 4 * i)
                   : "memory");
    }
  }
}

// track_fixed's contract for one track's own patches, both requested
// together and waited for once: the search patch is the search region; the
// template patch is the template region when it is RJ wide and the anchor
// lies in [1, 2) (every in-image track), else the region is staged clamped
// as track_fixed does.
template <int LANES>
__device__ __forceinline__ void track_patches16(
    const float* __restrict__ J, int PJ, float ayJ, float axJ,
    const float* __restrict__ I, float ay, float ax,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out, float* smem, int tid, int bar_id,
    int iters, float eps, float hiX) {
  using S = FixedShape<LANES>;
  constexpr int RJ = S::RJ;
  const int iyJ = lk::floor_clamped(ayJ, 0, 1 << 20);
  const int ixJ = lk::floor_clamped(axJ, 0, 1 << 20);
  if (PJ == RJ && iyJ == 1 && ixJ == 1)
    copy16<RJ * RJ / 4, LANES>(smem, J, tid);
  else
    lk::stage_region<RJ, RJ, LANES>(smem, J, PJ, PJ, iyJ - 1, ixJ - 1, tid);
  copy16<lk::kP * lk::kP / 4, LANES>(smem + RJ * RJ, I, tid);
  lk::stage_wait();
  lk::group_sync<LANES>(bar_id);
  lk::track_staged<lk::kWin, lk::kP, LANES, kSP>(
      smem, ayJ - (float)iyJ, axJ - (float)ixJ, ay, ax, a_out, eig_out,
      err_out, tid, bar_id, iters, eps, hiX, 1);
}

// The compile-time window (21, 36), LANES threads a track, a persistent grid.
template <int LANES>
__global__ void __launch_bounds__(lk::kBlockThreads, lk::min_blocks(LANES))
lk_iterate_fixed(const float* __restrict__ pJ, const float* __restrict__ pI,
                 const float* __restrict__ aJ, const float* __restrict__ a0,
                 float* __restrict__ a_out, float* __restrict__ eig_out,
                 float* __restrict__ err_out, int T, int PJ, int iters,
                 float eps, float hiX, int* next) {
  extern __shared__ float smem[];
  lk::for_each_track<lk::kWin, lk::kP, LANES, kSP>(
      T, next, smem, [&](int t, int tid, int bar_id, float* mine) {
        const float* J = pJ + (size_t)t * PJ * PJ;
        const float* I = pI + (size_t)t * lk::kP * lk::kP;
        track_patches16<LANES>(J, PJ, aJ[2 * t], aJ[2 * t + 1], I, a0[2 * t],
                               a0[2 * t + 1], a_out + 2 * t, eig_out + t,
                               err_out + t, mine, tid, bar_id, iters, eps,
                               hiX);
      });
}

// Any other window: one warp a track, runtime win and P.
__global__ void lk_iterate_generic(
    const float* __restrict__ pJ, const float* __restrict__ pI,
    const float* __restrict__ aJ, const float* __restrict__ a0,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out, int T, int PJ, int P, int win, int iters,
    float eps, float hiX, int warp_floats) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * (lk::kBlockThreads / 32) + warp;
  if (t >= T) return;
  lk::track_warp(pJ + (size_t)t * PJ * PJ, PJ, PJ, 0, 0, aJ[2 * t],
                 aJ[2 * t + 1], pI + (size_t)t * P * P, P, P, 0, 0,
                 a0[2 * t], a0[2 * t + 1], a_out + 2 * t, eig_out + t,
                 err_out + t, smem + (size_t)warp * warp_floats, win, P,
                 iters, eps, hiX, 1);
}

template <int LANES>
constexpr size_t fixed_smem() {
  using S = FixedShape<LANES>;
  return (size_t)S::GROUPS * S::FLOATS * sizeof(float);
}

size_t generic_smem(int win, int P) {
  return (size_t)(lk::kBlockThreads / 32) * lk::warp_floats(win, P) *
         sizeof(float);
}

bool fixed_window(int win, int P) { return win == lk::kWin && P == lk::kP; }

template <int LANES>
int launch_fixed(const float* pJ, const float* pI, const float* aJ,
                 const float* a0, float* a_out, float* eig_out,
                 float* err_out, int T, int PJ, int iters, float eps,
                 float hiX, int* next, cudaStream_t stream) {
  constexpr size_t smem = fixed_smem<LANES>();
  static lk::Resident resident;
  int blocks = 0;
  cudaError_t rc = lk::persistent_blocks(lk_iterate_fixed<LANES>, smem, T,
                                         FixedShape<LANES>::GROUPS, resident,
                                         &blocks);
  if (rc == cudaSuccess && LANES == 32)
    rc = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return (int)rc;
  lk_iterate_fixed<LANES><<<blocks, lk::kBlockThreads, smem, stream>>>(
      pJ, pI, aJ, a0, a_out, eig_out, err_out, T, PJ, iters, eps, hiX, next);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  `lanes`
// (32 or 128) is the threads a track for the compile-time window (21, 36);
// any other window takes 32 (one warp a track).  `next` is one int of device
// scratch (the 32-lane grid's track counter, zeroed here).  Returns
// cudaGetLastError() (0 on success) so a refused launch is reported.
extern "C" int lk_iterate_launch(
    const float* pJ, const float* pI, const float* aJ, const float* a0,
    float* a_out, float* eig_out, float* err_out, int T, int PJ, int P,
    int win, int iters, float eps, float hiX, int lanes, int* next,
    void* stream) {
  if (T <= 0) return 0;
  if (PJ <= 0 || !lk::launch_args_ok(win, P, hiX))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed_window(win, P)) {
    if (((size_t)pJ | (size_t)pI) % 16 != 0) return (int)cudaErrorInvalidValue;
    if (lanes == 32)
      return launch_fixed<32>(pJ, pI, aJ, a0, a_out, eig_out, err_out, T, PJ,
                              iters, eps, hiX, next, s);
    if (lanes == 128)
      return launch_fixed<128>(pJ, pI, aJ, a0, a_out, eig_out, err_out, T,
                               PJ, iters, eps, hiX, next, s);
    return (int)cudaErrorInvalidValue;
  }
  if (lanes != 32) return (int)cudaErrorInvalidValue;
  const size_t smem = generic_smem(win, P);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        lk_iterate_generic, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int per_block = lk::kBlockThreads / 32;
  lk_iterate_generic<<<(T + per_block - 1) / per_block, lk::kBlockThreads,
                       smem, s>>>(pJ, pI, aJ, a0, a_out, eig_out, err_out, T,
                                  PJ, P, win, iters, eps, hiX,
                                  lk::warp_floats(win, P));
  return (int)cudaGetLastError();
}

// out[0..3] = registers a thread, shared bytes a track, resident warps a SM
// (occupancy API), 1 if (win, P) is the compile-time window else 0, for the
// kernel lk_iterate_launch runs with these arguments.  Returns a CUDA error.
extern "C" int lk_iterate_info(int win, int P, int lanes, int* out) {
  cudaError_t rc;
  const bool fixed = fixed_window(win, P);
  if (fixed && lanes == 32) {
    rc = lk::kernel_info(lk_iterate_fixed<32>, fixed_smem<32>(),
                         FixedShape<32>::GROUPS, out);
  } else if (fixed && lanes == 128) {
    rc = lk::kernel_info(lk_iterate_fixed<128>, fixed_smem<128>(),
                         FixedShape<128>::GROUPS, out);
  } else if (!fixed && lanes == 32 && win >= 1 && P >= win + 2) {
    rc = lk::kernel_info(lk_iterate_generic, generic_smem(win, P),
                         lk::kBlockThreads / 32, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  out[3] = fixed ? 1 : 0;
  return (int)rc;
}
