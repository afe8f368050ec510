// One pyramid level of Lucas-Kanade for T agent-contiguous tracks.
//
// Replaces the TPU kernel mqslam_tpu/ops/lk_tile_pallas.py::lk_level_tiled
// (body `_kernel`).  That kernel keeps each agent's whole image tile
// resident in on-chip memory and slices per-track patches out of it with
// lane rolls; its lane-tile-major layout, guard tile and 8-row padding exist
// only for that machine and are not carried over.  Here the images stay
// plain row-major [A*Hp, Wp] in device memory.
//
// What bounds it on an H100: bytes.  A track touches a (win+3)^2 template
// region and a P^2 search region (about 7.5 KB at win=21, P=36), each read
// from device memory once; the Newton loop then re-reads them tens of times.
// The arithmetic per byte moved from device memory is small (a few hundred
// FMAs per track and iteration), so the least time is the time to move the
// regions (or each image once, when tracks are dense).
//
// What the design does about it: ONE WARP PER TRACK.  The warp stages the
// template region into shared memory with row-contiguous reads, builds the
// lerped (win+2)^2 grid C (the template window is C's interior; dx, dy are
// its central differences) and the 2x2 structure tensor, then stages the
// search region over the template staging area and runs the Newton loop
// entirely out of shared memory: every iteration is win^2 bilinear taps
// spread over the 32 lanes and two warp-shuffle reductions, with a per-warp
// early exit (converged tracks are frozen in the reference, so leaving the
// loop gives identical results).  No block-level barrier is needed: warps
// of a block share nothing.  No tensor cores, TMA or clusters: a simple
// kernel that is right comes first.
//
// Shared memory per warp: max((win+3)^2, P^2) + (win+2)^2 + 2 win^2 floats
// (10.6 KB at the defaults); 4 warps per block.
//
// Skipped tracks (valid == 0) return a0 with min_eig = err = 0 before any
// address is formed from their (possibly NaN) anchors or corners.  All
// global reads are clamped to the track's tile and all shared-memory
// indices derived from float anchors are clamped to their ranges, so a NaN
// that appears in flight cannot index out of bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
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
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  if (t >= T) return;

  if (valid[t] == 0) {
    if (lane == 0) {
      a_out[2 * t] = a0[2 * t];
      a_out[2 * t + 1] = a0[2 * t + 1];
      eig_out[t] = 0.0f;
      err_out[t] = 0.0f;
    }
    return;
  }

  const int W2 = win + 2;          // lerped grid side
  const int RJ = win + 3;          // template staging side
  const int n_win = win * win;
  const int stage_floats = max(RJ * RJ, P * P);
  float* stage = smem + (size_t)warp * warp_floats;   // template, then search
  float* Cg = stage + stage_floats;                   // [W2][W2]
  float* dxs = Cg + W2 * W2;                          // [win][win]
  float* dys = dxs + n_win;                           // [win][win]

  const int tile = t / (T / A);
  const float* tJ = imgJ + (size_t)tile * Hp * Wp;
  const float* tI = imgI + (size_t)tile * Hp * Wp;

  // ---- template region -> shared ----
  const float ayJ = aJ[2 * t], axJ = aJ[2 * t + 1];
  const int iyJ = floor_clamped(ayJ, 0, 1 << 20);
  const int ixJ = floor_clamped(axJ, 0, 1 << 20);
  const float fyJ = ayJ - (float)iyJ;
  const float fxJ = axJ - (float)ixJ;
  const int rowJ = cJ[2 * t] + iyJ - 1;
  const int colJ = cJ[2 * t + 1] + ixJ - 1;
  for (int e = lane; e < RJ * RJ; e += 32) {
    const int k = e / RJ, m = e - k * RJ;
    const int r = clampi(rowJ + k, 0, Hp - 1);
    const int c = clampi(colJ + m, 0, Wp - 1);
    stage[e] = tJ[(size_t)r * Wp + c];
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
  const int rowI = cI[2 * t], colI = cI[2 * t + 1];
  for (int e = lane; e < P * P; e += 32) {
    const int k = e / P, m = e - k * P;
    const int r = clampi(rowI + k, 0, Hp - 1);
    const int c = clampi(colI + m, 0, Wp - 1);
    stage[e] = tI[(size_t)r * Wp + c];
  }
  __syncwarp();

  // ---- Newton loop (all lanes hold identical ay, ax, done) ----
  const int hi_i = (int)hiX;
  float ay = a0[2 * t], ax = a0[2 * t + 1];
  const float eps2 = eps * eps;
  for (int it = 0; it < iters; ++it) {
    const int iy = floor_clamped(ay, 0, hi_i);
    const int ix = floor_clamped(ax, 0, hi_i);
    const float fy = ay - (float)iy, fx = ax - (float)ix;
    float b0 = 0.0f, b1 = 0.0f;
    for (int e = lane; e < n_win; e += 32) {
      const int i = e / win, c = e - i * win;
      const float* p = stage + (iy + i) * P + (ix + c);
      const float r0 = (1.0f - fy) * p[0] + fy * p[P];
      const float r1 = (1.0f - fy) * p[1] + fy * p[P + 1];
      const float Iw = (1.0f - fx) * r0 + fx * r1;
      const float diff = Cg[(i + 1) * W2 + (c + 1)] - Iw;
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
    const int iy = floor_clamped(ay, 0, hi_i);
    const int ix = floor_clamped(ax, 0, hi_i);
    const float fy = ay - (float)iy, fx = ax - (float)ix;
    for (int e = lane; e < n_win; e += 32) {
      const int i = e / win, c = e - i * win;
      const float* p = stage + (iy + i) * P + (ix + c);
      const float r0 = (1.0f - fy) * p[0] + fy * p[P];
      const float r1 = (1.0f - fy) * p[1] + fy * p[P + 1];
      const float Iw = (1.0f - fx) * r0 + fx * r1;
      err += fabsf(Cg[(i + 1) * W2 + (c + 1)] - Iw);
    }
    err = warp_sum(err) / (float)n_win;
  }
  if (lane == 0) {
    a_out[2 * t] = ay;
    a_out[2 * t + 1] = ax;
    eig_out[t] = min_eig;
    err_out[t] = err;
  }
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
  if (A <= 0 || T % A != 0 || win < 1 || P < win + 2 ||
      (int)hiX != P - 2 - win)
    return (int)cudaErrorInvalidValue;
  const int RJ = win + 3, W2 = win + 2;
  const int stage_floats = RJ * RJ > P * P ? RJ * RJ : P * P;
  const int warp_floats = stage_floats + W2 * W2 + 2 * win * win;
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
