// Per-track patch extraction: for each of T integer (row, col) corners, the
// [48, P] block of the image starting at the 8-aligned row at or above the
// clamped corner row, and at the clamped corner column.
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
// What bounds it on an H100: bytes.  It is an exact copy: 48 P floats read
// and written per track, no arithmetic.  What the design does about it: ONE
// WARP PER TRACK, lanes across a patch row (two passes of the warp for
// P > 32), so reads are contiguous along each image row and writes are
// contiguous in the output; the corner clamp is computed in the warp, so the
// wrapper launches nothing else.  No shared memory, no TMA: a simple kernel
// that is right comes first.  8 warps per block.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 48;         // ROWS_CAP
constexpr int kStripCols = 256;   // the TPU strip width the column cap keeps
constexpr int kWarpsPerBlock = 8;

__global__ void extract_kernel(
    const float* __restrict__ img, const int* __restrict__ corners,
    float* __restrict__ out, int* __restrict__ y0_out,
    int* __restrict__ cx_out, int T, int H, int W, int P) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;
  // _clamped_corners: H >= 48, W >= 256 and P <= 48 keep every bound >= 0
  const int y0_max = ((H - kRows) / 8) * 8;
  const int x0_max = ((W - kStripCols) / 128) * 128;
  const int cy = min(max(corners[2 * t], 0), min(H - P, y0_max + kRows - P));
  const int cx = min(max(corners[2 * t + 1], 0),
                     min(W - P, x0_max + kStripCols - P));
  const int y0 = min((cy / 8) * 8, y0_max);
  const float* src = img + (size_t)y0 * W + cx;
  float* dst = out + (size_t)t * kRows * P;
  for (int c = lane; c < P; c += 32) {
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) dst[r * P + c] = src[(size_t)r * W + c];
  }
  if (lane == 0) {
    y0_out[t] = y0;
    cx_out[t] = cx;
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() (0 on success) so a refused launch is reported.
extern "C" int extract_launch(const float* img, const int* corners,
                              float* out, int* y0, int* cx, int T, int H,
                              int W, int P, void* stream) {
  if (T <= 0) return 0;
  if (H < kRows || W < kStripCols || P < 1 || P > kRows)
    return (int)cudaErrorInvalidValue;
  const int blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
  extract_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      img, corners, out, y0, cx, T, H, W, P);
  return (int)cudaGetLastError();
}
