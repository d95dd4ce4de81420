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
// Bound: bytes.  Each pixel reads two bytes and writes one: 4.7 MB for the
// eval path's (24, 256, 256) sub-batch, 1.4 us at 3.35 TB/s.  On 32-pixel
// words the closing is ~60 integer operations per word (below), ~0.1 us
// of the card's integer rate.  At this size the launch and the ramp of a
// few hundred blocks set the floor, not either bound.
//
// Design: the closing is a 1-bit function, so it runs on bit-packed rows.
//   * Pack: bit j of word k of a row is column 32k + j.  Bits at or beyond
//     W, words outside the row and rows outside [0, H) are 0: the
//     reference's zero border.  Rows whose byte address is 16-aligned
//     (W % 16 == 0) load 16 bytes a thread and gather the bits by
//     multiply; other widths gather byte by byte.
//   * The disc is separable by rows: its rows have half-widths 1, 2, 3, 3,
//     3, 2, 1.  A horizontal dilation by r is r funnel shifts each way,
//     the carry taken from the neighbouring word, and
//       D[y] = h1[y-3] | h2[y-2] | h3[y-1] | h3[y] | h3[y+1] | h2[y+2]
//              | h1[y+3],   I = D & C,
//     the erosion the same with AND over I.  Shifts bring in zeros from
//     beyond the loaded words, which is the zero border for the erosion
//     at the image edge.
//   * Layout: one block per (mask, band of kBand rows, window of kWin
//     words).  The block packs the mask over the band plus a 6-row halo
//     and the clip over a 3-row halo, each kWin words plus one halo word
//     a side (the radius-6 halo fits in one word), into 3.3 KB of shared
//     memory whatever W is; D & C over band + 3 rows, then the erosion of
//     the band, unpacked to bool bytes with one 16-byte store per half
//     word.  The halo words are computed with zero beyond them: only
//     their 3 bits next to the window feed the window, and those see
//     every mask bit they need.
// Tensor cores, TMA and cp.async do not serve it: there is no product,
// and each block's tile (~3 KB) is read once and used at once.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): closing_kernel<true> and <false>
// each 30 registers, 3280 bytes of shared memory, no spills.

#include "common.cuh"

namespace {

constexpr int kBand = 32;                // output rows per block
constexpr int kWin = 8;                  // output words (256 px) per block
constexpr int kR = 3;                    // disc radius
constexpr int kCols = kWin + 2;          // words with one halo word a side
constexpr int kIRows = kBand + 2 * kR;   // 38: rows of I = D & C
constexpr int kMRows = kBand + 4 * kR;   // 44: rows of the mask
constexpr int kThreads = 256;
constexpr int kMWords = kMRows * kCols;  // 440
constexpr int kIWords = kIRows * kCols;  // 380
constexpr int kPerThread = (kMWords + kThreads - 1) / kThreads;  // 2
static_assert(kIWords <= kPerThread * kThreads, "clip words per thread");
static_assert(kBand * kWin == kThreads, "one output word per thread");

// half width of the disc's row at vertical offset dy (|dy| = 0..3): the
// set columns of DISC_7X7 rows are 3, 5, 7, 7, 7, 5, 3 wide
__device__ __forceinline__ int half_width(int dy) {
  const int a = dy < 0 ? -dy : dy;
  return a == 3 ? 1 : (a == 2 ? 2 : 3);
}

// 8 bytes that are each 0 or nonzero -> 8 bits, bit i = byte i != 0
__device__ __forceinline__ uint32_t pack8(uint64_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  x &= 0x0101010101010101ull;                         // byte i: 0 or 1
  return static_cast<uint32_t>((x * 0x0102040810204080ull) >> 56);
}

// 8 bits -> 8 bytes of 0 or 1, byte i = bit i
__device__ __forceinline__ uint64_t unpack8(uint32_t b) {
  const uint64_t t = (static_cast<uint64_t>(b & 0xffu) *
                      0x0101010101010101ull) & 0x8040201008040201ull;
  return ((t + 0x7f7f7f7f7f7f7f7full) >> 7) & 0x0101010101010101ull;
}

// word k of row y of one (H, W) image, 0 outside it
template <bool kVec>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ img,
                                              int y, int k, int H, int W) {
  const int x0 = 32 * k;
  if (y < 0 || y >= H || k < 0 || x0 >= W) return 0;
  const uint8_t* row = img + static_cast<size_t>(y) * W;
  uint32_t w = 0;
  if (kVec) {  // W % 16 == 0: each 16-byte half is wholly in or out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (x0 + 16 * h < W) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + x0 + 16 * h);
        const uint64_t lo = (static_cast<uint64_t>(v.y) << 32) | v.x;
        const uint64_t hi = (static_cast<uint64_t>(v.w) << 32) | v.z;
        w |= (pack8(lo) | (pack8(hi) << 8)) << (16 * h);
      }
    }
  } else {
    const int n = W - x0 < 32 ? W - x0 : 32;
    for (int j = 0; j < n; ++j) w |= static_cast<uint32_t>(row[x0 + j] != 0)
                                     << j;
  }
  return w;
}

// horizontal dilation (kOr) or erosion of word w by rad pixels, with the
// words to its left (lower columns) and right as the carries
template <bool kOr>
__device__ __forceinline__ uint32_t hmorph(uint32_t l, uint32_t w,
                                           uint32_t r, int rad) {
  uint32_t v = w;
#pragma unroll
  for (int d = 1; d <= kR; ++d) {
    if (d <= rad) {
      const uint32_t a = __funnelshift_l(l, w, d);   // pixel x - d
      const uint32_t b = __funnelshift_r(w, r, d);   // pixel x + d
      v = kOr ? (v | a | b) : (v & a & b);
    }
  }
  return v;
}

// the disc over rows [i, i + 7) of a row-major (rows, kCols) word grid
// at column j: OR (dilation) or AND (erosion) of the rows' horizontal
// morphs
template <bool kOr>
__device__ __forceinline__ uint32_t disc(const uint32_t* g, int i, int j) {
  uint32_t v = kOr ? 0u : ~0u;
#pragma unroll
  for (int dy = -kR; dy <= kR; ++dy) {
    const uint32_t* row = g + (i + kR + dy) * kCols;
    const uint32_t l = j > 0 ? row[j - 1] : 0u;
    const uint32_t r = j < kCols - 1 ? row[j + 1] : 0u;
    const uint32_t h = hmorph<kOr>(l, row[j], r, half_width(dy));
    v = kOr ? (v | h) : (v & h);
  }
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    closing_kernel(const uint8_t* __restrict__ mask,
                   const uint8_t* __restrict__ clip,
                   uint8_t* __restrict__ out, int H, int W) {
  __shared__ uint32_t m_s[kMWords];   // (kMRows, kCols): rows y0 - 6 + i
  __shared__ uint32_t i_s[kIWords];   // (kIRows, kCols): rows y0 - 3 + i
  const int y0 = blockIdx.y * kBand;
  const int k0 = blockIdx.x * kWin - 1;     // word of column 0 of the grid
  const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
  const uint8_t* m_img = mask + base;
  const uint8_t* c_img = clip + base;
  const int t = threadIdx.x;

  // pack: the mask grid, and each thread's clip words of the I grid
  // (held in registers until the same thread computes D & C there)
  uint32_t c_reg[kPerThread];
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int k = t + p * kThreads;
    if (k < kMWords) {
      m_s[k] = load_word<kVec>(
          m_img, y0 - 2 * kR + k / kCols, k0 + k % kCols, H, W);
    }
    c_reg[p] = k < kIWords ? load_word<kVec>(c_img, y0 - kR + k / kCols,
                                             k0 + k % kCols, H, W)
                           : 0u;
  }
  __syncthreads();

  // I = dilate(mask) & clip over the band and a 3-row halo (0 outside
  // the image, where the clip is 0)
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int k = t + p * kThreads;
    if (k < kIWords) {
      i_s[k] = disc<true>(m_s, k / kCols, k % kCols) & c_reg[p];
    }
  }
  __syncthreads();

  // erode the band: one output word per thread
  const int i = t / kWin, j = 1 + t % kWin;
  const int y = y0 + i, kw = k0 + j, x0 = 32 * kw;
  if (y >= H || x0 >= W) return;
  const uint32_t e = disc<false>(i_s, i, j);
  uint8_t* dst = out + base + static_cast<size_t>(y) * W + x0;
  if (kVec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (x0 + 16 * h < W) {
        const uint32_t bits = e >> (16 * h);
        const uint64_t lo = unpack8(bits), hi = unpack8(bits >> 8);
        *reinterpret_cast<uint4*>(dst + 16 * h) = make_uint4(
            static_cast<uint32_t>(lo), static_cast<uint32_t>(lo >> 32),
            static_cast<uint32_t>(hi), static_cast<uint32_t>(hi >> 32));
      }
    }
  } else {
    const int n = W - x0 < 32 ? W - x0 : 32;
    for (int b = 0; b < n; ++b) dst[b] = (e >> b) & 1u;
  }
}

}  // namespace

// mask, clip, out: (B, H, W) bool (one byte, 0 or 1), contiguous
extern "C" int crimac_binary_closing(const void* mask, const void* clip,
                                     void* out, int B, int H, int W,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      (H + kBand - 1) / kBand > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (W + 31) / 32;
  const dim3 grid((words + kWin - 1) / kWin, (H + kBand - 1) / kBand, B);
  const bool vec = W % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(mask) |
                     reinterpret_cast<uintptr_t>(clip) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const auto m = static_cast<const uint8_t*>(mask);
  const auto c = static_cast<const uint8_t*>(clip);
  const auto o = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    closing_kernel<true><<<grid, kThreads, 0, s>>>(m, c, o, H, W);
  } else {
    closing_kernel<false><<<grid, kThreads, 0, s>>>(m, c, o, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
