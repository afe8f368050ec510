// K3: per-track patch extraction.  For each of T integer (row, col) corners,
// the [48, P] block of the image starting at the 8-aligned row at or above
// the clamped corner row, and at the clamped corner column.
//
// Replaces the TPU kernel mqslam_tpu/ops/extract_pallas.py::
// extract_patches_dma (body `_kernel`).  That kernel copies, per track, an
// aligned [48, 256] strip from device memory into on-chip memory (Mosaic's
// DMA wants 8-row / 128-lane aligned origins) and compacts its columns with
// a lane roll.  The strip and the roll are transport and do not cross over.
// What does is the contract the LK driver consumes: the 48-row patch from
// the 8-aligned row y0 (the driver folds corner - y0 into the row anchor),
// and the clamp caps, which are up to 7 rows / 127 columns tighter than
// H - P / W - P (`_clamped_corners`, reproduced below in integers).
//
// What bounds it on an H100: bytes.  It is an exact copy, 48 P floats read
// and written per track and no arithmetic, so the work is latency (at
// T = 384 a launch moves 2-5 MB, a few microseconds at 3.35 TB/s) and the
// memory rate (at T = 6144).  The first design, one warp a track and a lane
// a column, ran one dependent chain of 48 rows per lane, left 28 of 32 lanes
// idle on the second pass over P = 36 columns and filled a third of the
// card at T = 384.  This one has two paths; the wrapper chooses
// (ops/extract.py::kernel_path) "vec4" for P % 4 == 0, which covers both
// sides of the main paths' window (24 and 36), and "element" for any other
// P.  Both flatten the work over the card: every SM busy at T = 384.
//
//  - "element" (any P, 1..48): a track's 48 P elements flattened over all
//    threads, so a warp's stores are one contiguous run and no lane idles
//    on a ragged pass; eight independent loads in flight a thread.
//  - "vec4" (P % 4 == 0): the same four floats at a time: a thread copies
//    four consecutive output floats (one row of the image, as P % 4 == 0)
//    by four loads and one 16-byte store, four such groups in flight.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W, in a CUDA graph, the six
// launches of one impl="xla" LK call): vec4 0.020 ms at T = 384 and 0.109 at
// T = 6144 (the byte bound 0.084), element 0.028 / 0.198; the
// one-warp-a-track design 0.040 / 0.214.  A third path that had the Tensor
// Memory Accelerator bring each track's rows into shared memory (1-D bulk
// copies; 2-D tensor-map copies stopped with an illegal instruction under
// driver 580.159.03) was slower than vec4 at every input, 0.027 / 0.134,
// and was taken out (PERF.md).
//
// Every path writes y0 and cx once per track.  Both are bit-equal to the
// plain version: a copy.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kRows = 48;         // ROWS_CAP
constexpr int kStripCols = 256;   // the TPU strip width the column cap keeps

enum Path { kVec4 = 0, kElement = 1 };

// The clamp of `_clamped_corners`: H >= 48, W >= 256 and P <= 48 keep every
// bound >= 0.
struct Caps {
  int y0_max, cy_hi, cx_hi;
};

Caps caps(int H, int W, int P) {
  const int y0_max = ((H - kRows) / 8) * 8;
  const int x0_max = ((W - kStripCols) / 128) * 128;
  return {y0_max, std::min(H - P, y0_max + kRows - P),
          std::min(W - P, x0_max + kStripCols - P)};
}

__device__ __forceinline__ void corner(const int* __restrict__ corners,
                                       int t, const Caps& k, int& y0,
                                       int& cx) {
  const int cy = min(max(__ldg(corners + 2 * t), 0), k.cy_hi);
  cx = min(max(__ldg(corners + 2 * t + 1), 0), k.cx_hi);
  y0 = min((cy / 8) * 8, k.y0_max);
}

constexpr int kThreads = 128;

// Units of VEC floats a thread copies, all loads in flight before a store:
// 8 floats (element) or 16 (vec4) a thread.
__host__ __device__ constexpr int in_flight(int vec) {
  return vec == 4 ? 4 : 8;
}

// Output unit u (VEC floats) of the flattened [T, 48, P] output, VEC | P:
// track t = u / (units a track), and within it row r, column c.  A block's
// threads take consecutive units, so a warp's stores are one run.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
extract_simt(const float* __restrict__ img, const int* __restrict__ corners,
             float* __restrict__ out, int* __restrict__ y0_out,
             int* __restrict__ cx_out, int T, int W, Caps k, int P) {
  const int row_units = P / VEC;
  const int track_units = kRows * row_units;
  constexpr int kInFlight = in_flight(VEC);
  const long long n = (long long)T * track_units;
  const long long first =
      (long long)blockIdx.x * (kThreads * kInFlight) + threadIdx.x;
  float v[kInFlight][VEC];
#pragma unroll
  for (int j = 0; j < kInFlight; ++j) {
    const long long u = first + j * kThreads;
    if (u < n) {
      const int t = (int)(u / track_units);
      const int e = (int)(u - (long long)t * track_units);
      const int r = e / row_units;
      const int c = (e - r * row_units) * VEC;
      int y0, cx;
      corner(corners, t, k, y0, cx);
      const float* src = img + (size_t)(y0 + r) * W + cx + c;
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[j][q] = __ldg(src + q);
      if (e == 0) {
        y0_out[t] = y0;
        cx_out[t] = cx;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kInFlight; ++j) {
    const long long u = first + j * kThreads;
    if (u < n) {
      if constexpr (VEC == 4) {
        reinterpret_cast<float4*>(out)[u] =
            make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
      } else {
        out[u] = v[j][0];
      }
    }
  }
}

template <int VEC>
int launch_simt(const float* img, const int* corners, float* out, int* y0,
                int* cx, int T, int H, int W, int P, cudaStream_t stream) {
  if (P % VEC != 0 || (VEC > 1 && reinterpret_cast<uintptr_t>(out) % 16))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)T * kRows * (P / VEC);
  const long long per_block = (long long)kThreads * in_flight(VEC);
  extract_simt<VEC><<<(unsigned)((units + per_block - 1) / per_block),
                      kThreads, 0, stream>>>(img, corners, out, y0, cx, T, W,
                                             caps(H, W, P), P);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches `path` (0 "vec4", which needs P % 4 == 0, or 1 "element") on
// `stream`; does not synchronise, allocates nothing.  Returns
// cudaGetLastError() (0 on success), or an error for arguments no path
// takes, so a refused launch is reported.
extern "C" int extract_launch(const float* img, const int* corners,
                              float* out, int* y0, int* cx, int T, int H,
                              int W, int P, int path, void* stream) {
  if (T <= 0) return 0;
  if (H < kRows || W < kStripCols || P < 1 || P > kRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (path) {
    case kVec4:
      return launch_simt<4>(img, corners, out, y0, cx, T, H, W, P, s);
    case kElement:
      return launch_simt<1>(img, corners, out, y0, cx, T, H, W, P, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
