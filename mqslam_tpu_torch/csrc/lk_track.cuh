// One Lucas-Kanade track of one pyramid level: the per-track function the
// three LK kernels share.  lk_level.cu (K1, agent-contiguous tracks against
// per-agent tiles; replaces mqslam_tpu/ops/lk_tile_pallas.py::lk_level_tiled)
// and lk_strip.cu (K2, tracks in any order against the whole level image;
// replaces mqslam_tpu/ops/lk_fused_pallas.py::lk_level_fused) run it through
// `track_level_fixed` (the window of the main paths) or `track_level` (any
// other window); lk_iterate.cu (K4, each track on its own pre-extracted
// patches; replaces mqslam_tpu/ops/lk_pallas.py::lk_iterate_pallas) runs
// `track_fixed` for the main paths' window and `track_warp` for any other.
// The caller gives the images a track reads (`J`, `I`: row-major, float or
// bf16, each with its own extent) and corners in THOSE images' coordinates;
// every global read is clamped to its image.
//
// Per track: stage a (win+3)^2 template region and a P^2 search region, form
// the lerped template window, its central-difference gradients and the 2x2
// structure tensor G, then up to `iters` Newton steps of win^2 bilinear taps
// each, the anchor clipped to [0, hiX], with an exit once |step| < eps.
//
// What bounds it on an H100.  Not bytes: a track moves 7.5 KB of float once
// (0.017 ms for the fleet's 6144 tracks at 3.35 TB/s) and the FMAs are a few
// hundred per tap row.  What held the first design (one warp per track,
// 10.8 KB of shared memory per warp, everything runtime-sized) 11-36x above
// that bound was latency and instruction overhead: two dependent device-memory
// round trips per track (template, then search, 18 + 41 strided loads per
// lane in loops the compiler could not unroll), integer division by runtime
// window sides in every inner loop, seven shared loads per tap of which
// three were loop-invariant, 20 resident warps per SM held by a block's
// slowest warp, and at T = 384 a card three-quarters empty running one long
// chain per warp.
//
// What this design does (the compile-time path, `track_fixed`):
//  - WIN and P are template arguments; (21, 36) is the one instantiation the
//    main paths use (TrackerConfig.lk_win = 21, margin 7).  Every loop has a
//    fixed trip count per thread and unrolls; every (row, column) split is a
//    constant division.  Any other (win, P) runs the runtime-sized warp
//    function below (`track_level`), the generic instantiation.
//  - A group of LANES threads (32 = one warp, or 128 = four warps) takes a
//    track.  Each thread owns window elements e = tid + k*LANES (NE of them:
//    14 at 32 lanes, 4 at 128) for the whole track and keeps, in registers,
//    their template value, dx, dy and tap offset.  dx and dy come straight
//    from the staged template region (12 shared loads and 13 lerps per
//    element, the same arithmetic as the lerped grid), so no grid and no
//    gradient arrays live in shared memory, and one Newton tap is four shared
//    loads at an immediate offset from one register and four FMAs (the
//    bilinear weights, formed once a step, folded into the difference).
//  - Both regions are requested at once with 4-byte `cp.async` copies into
//    two buffers, a warp a row and a lane a column (its clamped column
//    computed once); one wait, one round trip per track.  bf16 pixels cannot
//    be copied asynchronously at 2 bytes: they are loaded, widened and
//    stored, four rows in flight at a time.
//    TMA is not the tool: the regions are 24-36 floats wide at arbitrary
//    column offsets (not 16-byte aligned), and the reads must clamp to the
//    tile or image (edge replication), while TMA fills out-of-bounds boxes
//    with zeros.  Tensor cores are not the tool either: the window sums must
//    stay in exact f32 (parity needs 2e-3 px and min_eig to 1e-4 relative;
//    TF32 keeps about three digits), and a tap is four FMAs, not a product.
//  - The search region's row pitch is SP = 53 floats, not 36: SP = 21 mod 32
//    puts any 32 consecutive window elements on 32 distinct banks, so the
//    Newton taps are free of bank conflicts (at pitch 36 half the tap loads
//    were 2-way).  Shared memory per track: 24*24 + 36*53 = 2484 floats
//    (9.7 KB), plus 128 B of partial sums for a 128-lane group.
//  - Scheduling is persistent.  A launch has what the card holds resident
//    (occupancy API x SM count) and no more blocks than the tracks need; a
//    32-lane group takes its next track from an atomic counter when it is
//    done with one (tracks take 1 to 30 Newton steps, so no block waits for
//    its slowest warp and there is no wave tail), a 128-lane group strides.
//  - A 128-lane group reduces across its four warps through shared memory
//    with one named barrier (`bar.sync id, 128`) per reduction and
//    double-buffered partials, so a Newton step costs one barrier.  All
//    threads sum the partials in one fixed order, so they hold bit-identical
//    anchors and leave the loop together.
//  - Registers (`min_blocks` below): 128 a thread at 32 lanes (16 resident
//    warps a SM), 64 at 128 lanes (32 warps), no spill; chip_smoke.py reads
//    them and the resident warps from the occupancy API (`lk_*_info`).
//  - Not done: prefetching the next track's regions while the current one
//    iterates.  An L2 prefetch of them (no shared-memory cost) measured no
//    faster, warm or L2-flushed; a doubled shared buffer would halve the
//    resident warps.
//
// Skipped tracks (valid == 0) return a0 with min_eig = err = 0 before any
// address is formed from their (possibly NaN) anchors or corners.  All
// indices derived from float anchors are clamped to their ranges (NaN to the
// low end), so a NaN anchor of a track that does run, or one that appears in
// flight, cannot index out of bounds; NaN survives the anchor clip.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 128;   // every LK level launch: 4 warps a block

// The one compile-time window the main paths use.
constexpr int kWin = 21;
constexpr int kP = 36;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// floor of a float as an int clamped to [lo, hi]; NaN maps to lo.
__device__ __forceinline__ int floor_clamped(float v, int lo, int hi) {
  float f = floorf(v);
  f = fminf(fmaxf(f, (float)lo), (float)hi);   // fmaxf/fminf drop NaN
  return (int)f;
}

__device__ __forceinline__ float px(const float* p) { return *p; }
__device__ __forceinline__ float px(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// False for arguments no launch may take.
inline bool launch_args_ok(int win, int P, float hiX) {
  return win >= 1 && P >= win + 2 && (int)hiX == P - 2 - win;
}

// A float anchor in the staged search region, split into its clamped integer
// cell and the fractional weights.
struct Anchor {
  int iy, ix;
  float fy, fx;
};

__device__ __forceinline__ Anchor split_anchor(float ay, float ax, int hi_i) {
  Anchor a;
  a.iy = floor_clamped(ay, 0, hi_i);
  a.ix = floor_clamped(ax, 0, hi_i);
  a.fy = ay - (float)a.iy;
  a.fx = ax - (float)a.ix;
  return a;
}

// One Newton update of (ay, ax) from the reduced b; true once converged.
// The clip is jnp.clip's: NaN stays NaN.
__device__ __forceinline__ bool newton_update(
    float b0, float b1, float g00, float g01, float g11, float det,
    float hiX, float eps2, float& ay, float& ax) {
  const float sx = (g11 * b0 - g01 * b1) / det;
  const float sy = (g00 * b1 - g01 * b0) / det;
  const float ax2 = ax + sx, ay2 = ay + sy;
  ax = ax2 != ax2 ? ax2 : fminf(fmaxf(ax2, 0.0f), hiX);
  ay = ay2 != ay2 ? ay2 : fminf(fmaxf(ay2, 0.0f), hiX);
  return sx * sx + sy * sy < eps2;
}

// det clamped away from 0 and min_eig = lambda_min(G) / n.
__device__ __forceinline__ void structure(float g00, float g01, float g11,
                                          int n, float& det, float& min_eig) {
  det = g00 * g11 - g01 * g01;
  det = fabsf(det) > 1e-20f ? det : 1e-20f;
  const float tr = 0.5f * (g00 + g11);
  const float dg = g00 - g11;
  min_eig =
      (tr - sqrtf(fmaxf(0.25f * dg * dg + g01 * g01, 0.0f))) / (float)n;
}

// ===================================================== generic: any window ==
//
// One warp per track with runtime win and P: the template region is staged,
// the lerped (win+2)^2 grid C and the gradients are kept in shared memory,
// then the search region is staged over the template area and the Newton
// loop runs out of shared memory.  All three LK kernels take it for a window
// other than (kWin, kP).

// Floats of shared memory one warp needs.
__host__ __device__ inline int warp_floats(int win, int P) {
  const int RJ = win + 3, W2 = win + 2;
  const int stage = RJ * RJ > P * P ? RJ * RJ : P * P;
  return stage + W2 * W2 + 2 * win * win;
}

// Bilinear sample of window element (i, c) at anchor `a`: rows first, then
// columns.
__device__ __forceinline__ float tap(const float* stage, int P,
                                     const Anchor& a, int i, int c) {
  const float* p = stage + (a.iy + i) * P + (a.ix + c);
  const float r0 = (1.0f - a.fy) * p[0] + a.fy * p[P];
  const float r1 = (1.0f - a.fy) * p[1] + a.fy * p[P + 1];
  return (1.0f - a.fx) * r0 + a.fx * r1;
}

// One track, by the calling warp: the template region at integer corner
// (cyJ, cxJ) of J (rowsJ x colsJ) with anchor (ayJ, axJ), the search region
// at (cyI, cxI) of I (rowsI x colsI) with initial anchor (ay, ax).  Every
// read is clamped to its own image.  Lane 0 writes (ay, ax) to a_out[0..1],
// min_eig to *eig_out and err to *err_out.  `stage` is the warp's own
// warp_floats(win, P) floats of shared memory.
template <typename T>
__device__ void track_warp(
    const T* __restrict__ J, int rowsJ, int colsJ, int cyJ, int cxJ,
    float ayJ, float axJ,
    const T* __restrict__ I, int rowsI, int colsI, int cyI, int cxI,
    float ay, float ax,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out, float* stage,
    int win, int P, int iters, float eps, float hiX, int want_err) {
  const int lane = threadIdx.x & 31;
  const int W2 = win + 2;          // lerped grid side
  const int RJ = win + 3;          // template staging side
  const int n_win = win * win;
  const int stage_floats = max(RJ * RJ, P * P);
  float* Cg = stage + stage_floats;                   // [W2][W2]
  float* dxs = Cg + W2 * W2;                          // [win][win]
  float* dys = dxs + n_win;                           // [win][win]

  // ---- template region -> shared ----
  const int iyJ = floor_clamped(ayJ, 0, 1 << 20);
  const int ixJ = floor_clamped(axJ, 0, 1 << 20);
  const float fyJ = ayJ - (float)iyJ;
  const float fxJ = axJ - (float)ixJ;
  // corners are clamped before they meet the anchor or a row stride
  const int rowJ = clampi(cyJ, 0, rowsJ - 1) + iyJ - 1;
  const int colJ = clampi(cxJ, 0, colsJ - 1) + ixJ - 1;
  for (int e = lane; e < RJ * RJ; e += 32) {
    const int k = e / RJ, m = e - k * RJ;
    const int r = clampi(rowJ + k, 0, rowsJ - 1);
    const int c = clampi(colJ + m, 0, colsJ - 1);
    stage[e] = px(J + (size_t)r * colsJ + c);
  }
  __syncwarp();

  // lerped grid: C[k][m] = image at (cJ + aJ - 1 + (k, m)); rows first,
  // then columns, as the reference does
  for (int e = lane; e < W2 * W2; e += 32) {
    const int k = e / W2, m = e - k * W2;
    const float* p = stage + k * RJ + m;
    const float s0 = (1.0f - fyJ) * p[0] + fyJ * p[RJ];
    const float s1 = (1.0f - fyJ) * p[1] + fyJ * p[RJ + 1];
    Cg[e] = (1.0f - fxJ) * s0 + fxJ * s1;
  }
  __syncwarp();

  // gradients + structure tensor
  float g00 = 0.0f, g01 = 0.0f, g11 = 0.0f;
  for (int e = lane; e < n_win; e += 32) {
    const int i = e / win, c = e - i * win;
    const float* p = Cg + (i + 1) * W2 + (c + 1);
    const float dx = 0.5f * (p[1] - p[-1]);
    const float dy = 0.5f * (p[W2] - p[-W2]);
    dxs[e] = dx;
    dys[e] = dy;
    g00 += dx * dx;
    g01 += dx * dy;
    g11 += dy * dy;
  }
  g00 = warp_sum(g00);
  g01 = warp_sum(g01);
  g11 = warp_sum(g11);
  float det, min_eig;
  structure(g00, g01, g11, n_win, det, min_eig);
  __syncwarp();   // everyone is done reading the template staging area

  // ---- search region -> shared (over the template staging area) ----
  const int rowI = clampi(cyI, 0, rowsI - 1);
  const int colI = clampi(cxI, 0, colsI - 1);
  for (int e = lane; e < P * P; e += 32) {
    const int k = e / P, m = e - k * P;
    const int r = clampi(rowI + k, 0, rowsI - 1);
    const int c = clampi(colI + m, 0, colsI - 1);
    stage[e] = px(I + (size_t)r * colsI + c);
  }
  __syncwarp();

  // ---- Newton loop (all lanes hold identical ay, ax) ----
  const int hi_i = (int)hiX;
  const float eps2 = eps * eps;
  for (int it = 0; it < iters; ++it) {
    const Anchor a = split_anchor(ay, ax, hi_i);
    float b0 = 0.0f, b1 = 0.0f;
    for (int e = lane; e < n_win; e += 32) {
      const int i = e / win, c = e - i * win;
      const float diff = Cg[(i + 1) * W2 + (c + 1)] - tap(stage, P, a, i, c);
      b0 += diff * dxs[e];
      b1 += diff * dys[e];
    }
    b0 = warp_sum(b0);
    b1 = warp_sum(b1);
    if (newton_update(b0, b1, g00, g01, g11, det, hiX, eps2, ay, ax)) break;
  }

  float err = 0.0f;
  if (want_err) {
    const Anchor a = split_anchor(ay, ax, hi_i);
    for (int e = lane; e < n_win; e += 32) {
      const int i = e / win, c = e - i * win;
      err += fabsf(Cg[(i + 1) * W2 + (c + 1)] - tap(stage, P, a, i, c));
    }
    err = warp_sum(err) / (float)n_win;
  }
  if (lane == 0) {
    a_out[0] = ay;
    a_out[1] = ax;
    *eig_out = min_eig;
    *err_out = err;
  }
}

// Track t of a level whose tracks all read one pair of images (rows x
// cols), with corners cJ / cI [T][2], anchors aJ / a0 [T][2] and valid [T]:
// what the two level kernels share.  A skipped track (valid == 0) returns
// a0 with min_eig = err = 0 before any address is formed from its (possibly
// NaN) anchors or corners.
template <typename T>
__device__ void track_level(
    const T* __restrict__ J, const T* __restrict__ I, int rows, int cols,
    int t, const int* __restrict__ cJ, const int* __restrict__ cI,
    const float* __restrict__ aJ, const float* __restrict__ a0,
    const unsigned char* __restrict__ valid,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out, float* stage,
    int win, int P, int iters, float eps, float hiX, int want_err) {
  if (valid[t] == 0) {
    if ((threadIdx.x & 31) == 0) {
      a_out[2 * t] = a0[2 * t];
      a_out[2 * t + 1] = a0[2 * t + 1];
      eig_out[t] = 0.0f;
      err_out[t] = 0.0f;
    }
    return;
  }
  track_warp(J, rows, cols, cJ[2 * t], cJ[2 * t + 1], aJ[2 * t],
             aJ[2 * t + 1], I, rows, cols, cI[2 * t], cI[2 * t + 1],
             a0[2 * t], a0[2 * t + 1], a_out + 2 * t, eig_out + t,
             err_out + t, stage, win, P, iters, eps, hiX, want_err);
}

// ========================================= compile-time window, LANES a track

// The smallest row pitch >= P that is congruent to WIN mod 32: any 32
// consecutive elements of a WIN-wide window then fall on 32 distinct banks.
__host__ __device__ constexpr int search_pitch(int win, int P) {
  return P + (((win - P) % 32) + 32) % 32;
}

// SP, the search row pitch, is search_pitch's unless a kernel stages its
// search region another way (K4's 16-byte copies, lk_iterate.cu).
template <int WIN, int P, int LANES, int SP_ = search_pitch(WIN, P)>
struct Shape {
  static_assert(LANES == 32 || LANES == 128, "32 or 128 threads a track");
  static_assert(SP_ >= P, "the search pitch holds a row");
  static constexpr int RJ = WIN + 3;                  // template region side
  static constexpr int SP = SP_;                      // search row pitch
  static constexpr int NWIN = WIN * WIN;
  static constexpr int NE = (NWIN + LANES - 1) / LANES;  // elements a thread
  static constexpr int WARPS = LANES / 32;
  static constexpr int RED = WARPS > 1 ? 2 * WARPS * 4 : 0;  // partials
  static constexpr int FLOATS = RJ * RJ + P * SP + RED;     // a group's smem
  static constexpr int GROUPS = kBlockThreads / LANES;      // a block's
};

// Blocks a SM the specialised kernels are compiled for (`__launch_bounds__`).
// 32 lanes: 4, so a thread may use 128 registers: its 14 window elements
// (J, dx, dy, offset: 56 registers through the Newton loop) and the loop's
// loads in flight fit with no spill, for 16 resident warps a SM.  (At 5
// blocks, 96 registers, ptxas spilled and the kernel ran 13 % slower on the
// fleet's level calls than at 4.)  128 lanes: 8, so 64 registers, 4 elements
// a thread, 32 resident warps a SM.
constexpr int min_blocks(int lanes) { return lanes == 32 ? 4 : 8; }

template <int LANES>
__device__ __forceinline__ void group_sync(int bar_id) {
  if constexpr (LANES == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(bar_id), "r"(LANES) : "memory");
  }
}

// v[n] summed over the group; every thread gets the same sums (warp trees,
// then the warps' partials added in one fixed order).  `red` holds two
// buffers of partials, used in turn: a buffer is written again only after
// the next barrier, which every thread passes after reading it.
template <int LANES, int N>
__device__ __forceinline__ void group_sum(float (&v)[N], float* red,
                                          int& parity, int tid, int bar_id) {
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
  if constexpr (LANES > 32) {
    constexpr int W = LANES / 32;
    float* buf = red + parity * (W * 4);
    if ((tid & 31) == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) buf[(tid >> 5) * 4 + n] = v[n];
    }
    group_sync<LANES>(bar_id);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float s = buf[n];
#pragma unroll
      for (int w = 1; w < W; ++w) s += buf[w * 4 + n];
      v[n] = s;
    }
    parity ^= 1;
  }
}

// One pixel into shared memory: an asynchronous 4-byte copy for float, a
// load widened to float for bf16 (cp.async moves 4, 8 or 16 bytes).
__device__ __forceinline__ void stage_px(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void stage_px(float* dst,
                                         const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The SIDE x SIDE region at (row0, col0) of img (rows x cols), every read
// clamped to the image, into dst with row pitch PITCH.  Row by row: a warp
// copies one row a step, lane l its columns l and l + 32, so one copy
// instruction covers one contiguous run of the row; the warps of a group
// take rows in turn.  The column clamps are computed once.  Float rows are
// all requested before any wait; bf16 rows go four at a time (each load lands
// in a register before it is widened and stored, and a fully unrolled pass
// would hold every pixel of both regions in registers at once).
template <int SIDE, int PITCH, int LANES, typename T>
__device__ __forceinline__ void stage_region(
    float* dst, const T* __restrict__ img, int rows, int cols, int row0,
    int col0, int tid) {
  constexpr int W = LANES / 32, CH = (SIDE + 31) / 32;
  constexpr int PER = (SIDE + W - 1) / W;
  const int lane = tid & 31, w = tid >> 5;
  int c[CH];
#pragma unroll
  for (int h = 0; h < CH; ++h)
    c[h] = clampi(col0 + lane + 32 * h, 0, cols - 1);
  auto row = [&](int j) {
    const int k = w + j * W;
    if (j + 1 < PER || k < SIDE) {
      const T* src = img + (size_t)clampi(row0 + k, 0, rows - 1) * cols;
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        const int m = lane + 32 * h;
        if (h + 1 < CH || m < SIDE) stage_px(dst + k * PITCH + m, src + c[h]);
      }
    }
  };
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < PER; ++j) row(j);
  } else {
#pragma unroll 4
    for (int j = 0; j < PER; ++j) row(j);
  }
}

// The bilinear weights of an anchor's cell, negated: (0, 0), (0, 1), (1, 0),
// (1, 1).
__device__ __forceinline__ void neg_weights(const Anchor& a, float (&w)[4]) {
  w[0] = -(1.0f - a.fy) * (1.0f - a.fx);
  w[1] = -(1.0f - a.fy) * a.fx;
  w[2] = -a.fy * (1.0f - a.fx);
  w[3] = -a.fy * a.fx;
}

// j minus the bilinear sample at p (row pitch SP): the weights folded into
// four FMAs.  (The reference lerps rows, then columns; the two differ in the
// last bits.)
template <int SP>
__device__ __forceinline__ float tap_diff(const float* p, const float (&w)[4],
                                          float j) {
  float d = fmaf(w[0], p[0], j);
  d = fmaf(w[1], p[1], d);
  d = fmaf(w[2], p[SP], d);
  return fmaf(w[3], p[SP + 1], d);
}

// The rest of a track once both regions are in the group's shared memory
// (`smem` as Shape<WIN, P, LANES, SP> lays it out: the template region
// [RJ][RJ] at the region corner's anchor fractions (fyJ, fxJ), the search
// region [P][SP], then the partials; staged, waited for and synced): the
// window elements, G, the Newton loop from (ay, ax) and the error, with the
// contract of track_warp.
template <int WIN, int P, int LANES, int SP>
__device__ __forceinline__ void track_staged(
    float* smem, float fyJ, float fxJ, float ay, float ax,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out, int tid, int bar_id, int iters, float eps,
    float hiX, int want_err) {
  using S = Shape<WIN, P, LANES, SP>;
  constexpr int RJ = S::RJ, NE = S::NE;
  const float* tmpl = smem;               // [RJ][RJ]
  const float* srch = smem + RJ * RJ;     // [P][SP]
  float* red = smem + RJ * RJ + P * SP;   // [2][WARPS][4] (LANES > 32)
  int parity = 0;

  // ---- this thread's window elements: J, dx, dy, tap offset ----
  // C[k][m] is the template lerped at (k, m) of the region, rows first, then
  // columns, as the reference does; element (i, c) is C[i+1][c+1], dx and dy
  // its central differences.  An element past the window (the last k of
  // some threads) holds zeros and is left out of every sum.
  float Jv[NE], dx[NE], dy[NE];
  int off[NE];
  const bool last_in = tid + (NE - 1) * LANES < S::NWIN;
  float g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const bool in = k + 1 < NE || last_in;
    const int e = in ? tid + k * LANES : 0;
    const int i = e / WIN, c = e - i * WIN;
    off[k] = i * SP + c;
    const float* q = tmpl + i * RJ + c;
    auto row = [&](const float* p) {
      return (1.0f - fyJ) * p[0] + fyJ * p[RJ];
    };
    auto col = [&](float s0, float s1) {
      return (1.0f - fxJ) * s0 + fxJ * s1;
    };
    const float s10 = row(q + RJ), s11 = row(q + RJ + 1),
                s12 = row(q + RJ + 2), s13 = row(q + RJ + 3);
    const float s01 = row(q + 1), s02 = row(q + 2);
    const float s21 = row(q + 2 * RJ + 1), s22 = row(q + 2 * RJ + 2);
    const float gx = 0.5f * (col(s12, s13) - col(s10, s11));
    const float gy = 0.5f * (col(s21, s22) - col(s01, s02));
    Jv[k] = in ? col(s11, s12) : 0.0f;
    dx[k] = in ? gx : 0.0f;
    dy[k] = in ? gy : 0.0f;
    if (in) {
      g[0] += dx[k] * dx[k];
      g[1] += dx[k] * dy[k];
      g[2] += dy[k] * dy[k];
    }
  }
  group_sum<LANES>(g, red, parity, tid, bar_id);
  float det, min_eig;
  structure(g[0], g[1], g[2], S::NWIN, det, min_eig);

  // ---- Newton loop (every thread holds identical ay, ax) ----
  const int hi_i = (int)hiX;
  const float eps2 = eps * eps;
  for (int it = 0; it < iters; ++it) {
    const Anchor a = split_anchor(ay, ax, hi_i);
    const float* base = srch + a.iy * SP + a.ix;
    float w[4];
    neg_weights(a, w);
    float b[2] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      if (k + 1 < NE || last_in) {
        const float d = tap_diff<SP>(base + off[k], w, Jv[k]);
        b[0] = fmaf(d, dx[k], b[0]);
        b[1] = fmaf(d, dy[k], b[1]);
      }
    }
    group_sum<LANES>(b, red, parity, tid, bar_id);
    if (newton_update(b[0], b[1], g[0], g[1], g[2], det, hiX, eps2, ay, ax))
      break;
  }

  float err = 0.0f;
  if (want_err) {
    const Anchor a = split_anchor(ay, ax, hi_i);
    const float* base = srch + a.iy * SP + a.ix;
    float w[4];
    neg_weights(a, w);
    float s[1] = {0.0f};
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      if (k + 1 < NE || last_in)
        s[0] += fabsf(tap_diff<SP>(base + off[k], w, Jv[k]));
    }
    group_sum<LANES>(s, red, parity, tid, bar_id);
    err = s[0] / (float)S::NWIN;
  }
  if (tid == 0) {
    a_out[0] = ay;
    a_out[1] = ax;
    *eig_out = min_eig;
    *err_out = err;
  }
}

// One track by a group of LANES threads (thread `tid` of the group, named
// barrier `bar_id`), with the contract of track_warp; `smem` is the group's
// Shape<WIN, P, LANES>::FLOATS floats.  Both regions are requested together
// and waited for once.
template <int WIN, int P, int LANES, typename T>
__device__ void track_fixed(
    const T* __restrict__ J, int rowsJ, int colsJ, int cyJ, int cxJ,
    float ayJ, float axJ,
    const T* __restrict__ I, int rowsI, int colsI, int cyI, int cxI,
    float ay, float ax,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out, float* smem, int tid, int bar_id,
    int iters, float eps, float hiX, int want_err) {
  using S = Shape<WIN, P, LANES>;
  constexpr int RJ = S::RJ, SP = S::SP;
  const int iyJ = floor_clamped(ayJ, 0, 1 << 20);
  const int ixJ = floor_clamped(axJ, 0, 1 << 20);
  // corners are clamped before they meet the anchor or a row stride
  stage_region<RJ, RJ, LANES>(smem, J, rowsJ, colsJ,
                              clampi(cyJ, 0, rowsJ - 1) + iyJ - 1,
                              clampi(cxJ, 0, colsJ - 1) + ixJ - 1, tid);
  stage_region<P, SP, LANES>(smem + RJ * RJ, I, rowsI, colsI,
                             clampi(cyI, 0, rowsI - 1),
                             clampi(cxI, 0, colsI - 1), tid);
  stage_wait();
  group_sync<LANES>(bar_id);
  track_staged<WIN, P, LANES, SP>(smem, ayJ - (float)iyJ, axJ - (float)ixJ,
                                  ay, ax, a_out, eig_out, err_out, tid,
                                  bar_id, iters, eps, hiX, want_err);
}

// track_level's contract for the compile-time window.
template <int WIN, int P, int LANES, typename T>
__device__ __forceinline__ void track_level_fixed(
    const T* __restrict__ J, const T* __restrict__ I, int rows, int cols,
    int t, const int* __restrict__ cJ, const int* __restrict__ cI,
    const float* __restrict__ aJ, const float* __restrict__ a0,
    const unsigned char* __restrict__ valid,
    float* __restrict__ a_out, float* __restrict__ eig_out,
    float* __restrict__ err_out, float* smem, int tid, int bar_id,
    int iters, float eps, float hiX, int want_err) {
  if (valid[t] == 0) {
    if (tid == 0) {
      a_out[2 * t] = a0[2 * t];
      a_out[2 * t + 1] = a0[2 * t + 1];
      eig_out[t] = 0.0f;
      err_out[t] = 0.0f;
    }
    return;
  }
  track_fixed<WIN, P, LANES>(
      J, rows, cols, cJ[2 * t], cJ[2 * t + 1], aJ[2 * t], aJ[2 * t + 1], I,
      rows, cols, cI[2 * t], cI[2 * t + 1], a0[2 * t], a0[2 * t + 1],
      a_out + 2 * t, eig_out + t, err_out + t, smem, tid, bar_id, iters, eps,
      hiX, want_err);
}

// fn(t, tid, bar_id, smem) for every track t < T, each by one group of LANES
// threads of a persistent grid.  A 32-lane group takes its next track from
// the counter `next` (zeroed before the launch) when it is done with one; a
// 128-lane group (one a block) strides by the grid.  The group syncs before
// its shared memory is staged again.  A group's shared memory is
// Shape<WIN, P, LANES, SP>::FLOATS floats.
template <int WIN, int P, int LANES, int SP = search_pitch(WIN, P),
          typename F>
__device__ __forceinline__ void for_each_track(int T, int* next, float* smem,
                                               F&& fn) {
  using S = Shape<WIN, P, LANES, SP>;
  const int g = threadIdx.x / LANES, tid = threadIdx.x % LANES;
  // barrier 0 is __syncthreads'; one group a block names barrier 1 as a
  // constant, so ptxas reserves no other (a runtime id reserves all 16 and
  // halves the resident blocks)
  const int bar_id = S::GROUPS == 1 ? 1 : 1 + g;
  float* mine = smem + g * S::FLOATS;
  const int n_groups = gridDim.x * S::GROUPS;
  int t = blockIdx.x * S::GROUPS + g;
  while (t < T) {
    fn(t, tid, bar_id, mine);
    if constexpr (LANES == 32) {
      int n = 0;
      if (tid == 0) n = atomicAdd(next, 1) + n_groups;
      t = __shfl_sync(kFull, n, 0);
    } else {
      t += n_groups;
    }
    group_sync<LANES>(bar_id);
  }
}

// ------------------------------------------------------------ host side --

// What a kernel holds resident on the device last launched on: blocks a SM
// (occupancy API) times SMs.  One per kernel instantiation, so the
// occupancy query runs once, not at every launch.
struct Resident {
  int dev = -1, blocks = 0;
};

// Blocks of a persistent launch of `kernel` (kBlockThreads threads, `smem`
// bytes): what the card holds resident, no more than T tracks in groups of
// `groups` a block need.  0 blocks is an error: the kernel cannot run.
template <typename K>
inline cudaError_t persistent_blocks(K kernel, size_t smem, int T, int groups,
                                     Resident& cache, int* blocks) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev != cache.dev) {
    int n_sm = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kBlockThreads, smem);
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache.dev = dev;
    cache.blocks = per_sm * n_sm;
  }
  const int need = (T + groups - 1) / groups;
  *blocks = need < cache.blocks ? need : cache.blocks;
  return cudaSuccess;
}

// {registers a thread, shared bytes a track, resident warps a SM} of a level
// kernel launched with kBlockThreads threads and `smem` bytes, `groups`
// tracks a block.
template <typename K>
inline cudaError_t kernel_info(K kernel, size_t smem, int groups, int* out) {
  cudaFuncAttributes attr;
  int per_sm = 0;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kBlockThreads, smem);
  if (rc != cudaSuccess) return rc;
  out[0] = attr.numRegs;
  out[1] = (int)(smem / groups);
  out[2] = per_sm * (kBlockThreads / 32);
  return cudaSuccess;
}

}  // namespace lk
