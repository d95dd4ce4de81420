// K4 binary_closing: the 7x7-disc closing of the eval label chain's
// in-threshold mask, confined to each patch's non-boundary bbox.
//
// Replaces crimac_unet_tpu/ops/pallas_morphology.py binary_closing_pallas
// (:60, body _closing_kernel :33): per (H, W) mask, dilate with the 37 set
// offsets of the 7x7 disc (zero border, scipy's border_value=0), AND with
// the clip mask, erode with the same disc.  The intermediate
// dilate(mask) & clip is ZERO outside [0, H) x [0, W) for the erosion (the
// Pallas kernel's zero dil_scratch border), which is what makes pixels at
// the image edge erode.
//
// Bound: about even.  Each pixel reads two bytes and writes one (3 bytes
// over 3.35 TB/s) and does 2 x 37 neighbour tests (over 67 T/s): ~2 us for
// a (32, 256, 256) sub-batch either way.
//
// Design (simple, correct first): one block per (mask, 32 x 32 output
// tile).  The block stages the tile's mask with a 6-pixel halo and its
// clip with a 3-pixel halo in shared memory, zeros outside the image;
// computes dilate & clip over the tile plus a 3-pixel halo as an OR over
// the 37 offsets (the clip being zero outside the image zeroes that halo
// there, as the erosion needs); syncs; and erodes the tile as an AND over
// the 37 offsets.  OR/AND on 0/1 bytes replaces the reference's float
// counts (count > 0.5, count > 36.5) and is exact.  Any B, H, W is taken,
// H or W below 7 included.  Bit-packed rows (a 256-wide row is eight
// 32-bit words, dilation a few shifts and ORs) are the way to the bound.

#include "common.cuh"

namespace {

constexpr int kTile = 32;                // output tile edge
constexpr int kR = 3;                    // disc radius
constexpr int kDil = kTile + 2 * kR;     // 38: dilated + clipped region
constexpr int kMsk = kTile + 4 * kR;     // 44: mask region
constexpr int kThreads = 256;

// half width of the disc's row at vertical offset dy (|dy| = 0..3): the
// set columns of DISC_7X7 rows are 3, 5, 7, 7, 7, 5, 3 wide
__device__ __forceinline__ int half_width(int dy) {
  const int a = dy < 0 ? -dy : dy;
  return a == 3 ? 1 : (a == 2 ? 2 : 3);
}

__global__ void __launch_bounds__(kThreads)
    closing_kernel(const uint8_t* __restrict__ mask,
                   const uint8_t* __restrict__ clip,
                   uint8_t* __restrict__ out, int H, int W) {
  __shared__ uint8_t m_s[kMsk][kMsk];    // image (y0 - 6 + i, x0 - 6 + j)
  __shared__ uint8_t c_s[kDil][kDil];    // image (y0 - 3 + i, x0 - 3 + j)
  __shared__ uint8_t d_s[kDil][kDil];    // same frame as c_s
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.z) * H * W;

  for (int k = threadIdx.x; k < kMsk * kMsk; k += kThreads) {
    const int i = k / kMsk, j = k % kMsk;
    const int y = y0 - 2 * kR + i, x = x0 - 2 * kR + j;
    m_s[i][j] = (y >= 0 && y < H && x >= 0 && x < W)
                    ? (mask[base + static_cast<size_t>(y) * W + x] != 0)
                    : 0;
  }
  for (int k = threadIdx.x; k < kDil * kDil; k += kThreads) {
    const int i = k / kDil, j = k % kDil;
    const int y = y0 - kR + i, x = x0 - kR + j;
    c_s[i][j] = (y >= 0 && y < H && x >= 0 && x < W)
                    ? (clip[base + static_cast<size_t>(y) * W + x] != 0)
                    : 0;
  }
  __syncthreads();

  // dilate & clip; c_s is 0 outside the image, so is d_s
  for (int k = threadIdx.x; k < kDil * kDil; k += kThreads) {
    const int i = k / kDil, j = k % kDil;
    uint8_t v = 0;
    if (c_s[i][j]) {
#pragma unroll
      for (int dy = -kR; dy <= kR; ++dy) {
        const int w = half_width(dy);
#pragma unroll
        for (int dx = -kR; dx <= kR; ++dx) {
          if (dx >= -w && dx <= w) v |= m_s[i + kR + dy][j + kR + dx];
        }
      }
    }
    d_s[i][j] = v;
  }
  __syncthreads();

  // erode the tile
  for (int k = threadIdx.x; k < kTile * kTile; k += kThreads) {
    const int i = k / kTile, j = k % kTile;
    const int y = y0 + i, x = x0 + j;
    if (y >= H || x >= W) continue;
    uint8_t v = 1;
#pragma unroll
    for (int dy = -kR; dy <= kR; ++dy) {
      const int w = half_width(dy);
#pragma unroll
      for (int dx = -kR; dx <= kR; ++dx) {
        if (dx >= -w && dx <= w) v &= d_s[i + kR + dy][j + kR + dx];
      }
    }
    out[base + static_cast<size_t>(y) * W + x] = v;
  }
}

}  // namespace

// mask, clip, out: (B, H, W) bool (one byte, 0 or 1), contiguous
extern "C" int crimac_binary_closing(const void* mask, const void* clip,
                                     void* out, int B, int H, int W,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      (H + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  closing_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(clip),
      static_cast<uint8_t*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
