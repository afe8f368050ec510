// One Lucas-Kanade track of one pyramid level, computed by one warp.
//
// The per-track function the three LK kernels share: lk_level.cu (agent-
// contiguous tracks against per-agent tiles) and lk_strip.cu (tracks in any
// order against the whole level image) through `track_level`, lk_iterate.cu
// (each track against its own pre-extracted template and search patches)
// through `track_warp`.  The caller gives the images the track reads (`J`,
// `I`: row-major, float or bf16, each with its own extent) and corners in
// THOSE images' coordinates; every global read is clamped to its image.
//
// What bounds it on an H100: bytes.  A track touches a (win+3)^2 template
// region and a P^2 search region (about 7.5 KB of float at win=21, P=36),
// each read from device memory once; the Newton loop then re-reads them tens
// of times.  The arithmetic per byte moved from device memory is small (a
// few hundred FMAs per track and iteration), so the least time is the time
// to move the regions (or each image once, when tracks are dense).
//
// What the design does about it: ONE WARP PER TRACK.  The warp stages the
// template region into shared memory with row-contiguous reads (bf16 pixels
// are loaded as scalars and widened to float on the way in, so every sum is
// float), builds the lerped (win+2)^2 grid C (the template window is C's
// interior; dx, dy are its central differences) and the 2x2 structure
// tensor, then stages the search region over the template staging area and
// runs the Newton loop entirely out of shared memory: every iteration is
// win^2 bilinear taps spread over the 32 lanes and two warp-shuffle
// reductions, with a per-warp early exit (converged tracks are frozen in the
// reference, so leaving the loop gives identical results).  No block-level
// barrier is needed: warps of a block share nothing.  No tensor cores, TMA
// or clusters: a simple kernel that is right comes first.
//
// Shared memory per warp: max((win+3)^2, P^2) + (win+2)^2 + 2 win^2 floats
// (10.6 KB at the defaults).
//
// Skipped tracks (valid == 0, `track_level`) return a0 with min_eig = err
// = 0 before any address is formed from their (possibly NaN) anchors or
// corners.  All indices derived from float anchors are clamped to their
// ranges (NaN to the low end), so a NaN anchor of a track that does run, or
// one that appears in flight, cannot index out of bounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lk {

constexpr unsigned kFull = 0xffffffffu;

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

// Floats of shared memory one warp needs.
__host__ __device__ inline int warp_floats(int win, int P) {
  const int RJ = win + 3, W2 = win + 2;
  const int stage = RJ * RJ > P * P ? RJ * RJ : P * P;
  return stage + W2 * W2 + 2 * win * win;
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
  float det = g00 * g11 - g01 * g01;
  det = fabsf(det) > 1e-20f ? det : 1e-20f;
  const float tr = 0.5f * (g00 + g11);
  const float dg = g00 - g11;
  const float min_eig =
      (tr - sqrtf(fmaxf(0.25f * dg * dg + g01 * g01, 0.0f))) / (float)n_win;
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
    const float sx = (g11 * b0 - g01 * b1) / det;
    const float sy = (g00 * b1 - g01 * b0) / det;
    // clip as the reference's jnp.clip does: NaN stays NaN
    const float ax2 = ax + sx, ay2 = ay + sy;
    ax = ax2 != ax2 ? ax2 : fminf(fmaxf(ax2, 0.0f), hiX);
    ay = ay2 != ay2 ? ay2 : fminf(fmaxf(ay2, 0.0f), hiX);
    if (sx * sx + sy * sy < eps2) break;
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

}  // namespace lk
