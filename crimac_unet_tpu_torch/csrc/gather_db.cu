// K1 gather_db: fused patch gather + non-finite scrub + dB + clip + border
// zero, the front end of the predict path.
//
// Replaces crimac_unet_tpu/ops/pallas_gather.py gather_db_pallas (:98, body
// _gather_db_kernel :47) and the XLA gather front end of the JAX runner
// (crimac_unet_tpu/pipeline/runner.py:345-358).  Per patch n it fetches the
// (wh, ww, Cf) window at (y0s[n], x0s[n]) of the HWC slab and
//   * float32 / bfloat16 slabs (raw sv): scrubs non-finite values to 0, then
//     10*log10(x + 1e-10) clipped to [-75, 0], or the [0, 1]-scaled variant
//     1 + min(d, 0) / 75;
//   * uint8 slabs (host-computed dB codes): dequantizes code / (255/75) - 75,
//     or code / 255 when scaled;
// then writes 0.0 outside the data rectangle [by0, by1) x [bx0, bx1) (the dB
// of 0 sv is -75, so the border is not the same as a zero input) and stores
// NHWC in the compute dtype.
//
// Bound: bytes, with float issue just below.  The main path's sub-batch
// reads the 9.1 MB bf16 slab once and writes 16.8 MB of bf16 patches:
// 7.7 us at 3.35 TB/s.  Each element inside the data rectangle (7.4 M of
// 8.4 M) takes the full-precision log10f, the scrub, the clip and the
// conversions: ~31 float instructions in the SASS (chip_smoke.py counts
// them), 6.9 us at 33.5 T float instructions/s.
//
// Design: in HWC each patch row is one contiguous run of ww*Cf elements in
// the slab and in the output, and the transform is the same for every
// channel, so a row is handled as a flat run, cut into runs of kVec = 8
// elements.  A block covers a few rows of one patch: it reads y0s[n],
// x0s[n] and the column tests once, the row tests once per row.  A thread
// fetches kBatch = 2 runs, every load in flight before any arithmetic,
// then transforms them straight-line (8 independent log10f chains
// interleave) and stores each with 16-byte stores where the output row is
// 16-byte aligned (narrower where not).  A run whose pixels all lie in the
// slab and inside the data rectangle is loaded with the widest loads its
// address allows (16 down to 2 bytes: rows of a patch may start at any
// element); a run in a border row stores zeros with no load and no
// arithmetic; a run that straddles the slab or rectangle edge, or the
// row's end, gathers element by element.  Pixels outside the shipped slab
// (rows at or beyond Hs in practice) read as raw zeros, which re-grows the
// zero pad of the JAX runner's _pad_slab without a copy.  uint8 codes map
// through a 256-entry table in shared memory, built by the block with the
// same arithmetic (one code, one float: exact).  The arithmetic is float32
// with IEEE division and the full-precision log10f (never built with fast
// math), sequenced with _rn intrinsics so nothing is contracted, and
// rounded once to the output dtype: the result equals the plain float32
// version cast once.
// On the card the memory traffic and the arithmetic add rather than
// overlap: a copy-only variant of this kernel takes ~12 us (an empty
// kernel on the same grid ~3 us), and the scrub, log10f and clip add
// ~7.6 us on top (ops/gather_db_study.py; PERF.md).  Pipelining the
// next runs' loads behind the transform, more or fewer runs a thread,
// 128-thread blocks and fewer registers did not move it.
// TMA and cp.async do not pay here: the ~9 MB slab stays in the 50 MB L2,
// overlapping patches re-read it from there, and each run is used at once
// (nothing to stage).  There is no product for the tensor cores.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): bf16 -> bf16 (the main path) 55
// registers; bf16 -> f32 and f32 -> bf16 63-64; f32 -> f32 78, scaled 64
// with 32 bytes spilled; uint8 codes 47 (bf16 out) and 62 (f32 out) with
// the 1 KB table; no other spills.

#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;      // consecutive elements of one run
constexpr int kBatch = 2;    // runs a thread loads before it computes any
constexpr unsigned kAllZero = (1u << kVec) - 1;

__device__ __forceinline__ float clip_nan(float d, float lo, float hi) {
  // jnp.clip / torch.clamp propagate NaN; fminf/fmaxf would drop it
  return d != d ? d : fminf(fmaxf(d, lo), hi);
}

template <bool kCodes, bool kScaled>
__device__ __forceinline__ float net_db(float x) {
  if (kCodes) {
    // pipeline/infer_common.py _quantize_db_u8 codes
    return kScaled
               ? __fdiv_rn(x, 255.0f)
               : __fsub_rn(__fdiv_rn(x, static_cast<float>(255.0 / 75.0)),
                           75.0f);
  }
  if (!isfinite(x)) x = 0.0f;
  float d = __fmul_rn(10.0f, log10f(__fadd_rn(x, 1e-10f)));
  if (kScaled) {
    d = d != d ? d : fminf(d, 0.0f);
    d = clip_nan(d, -75.0f, 0.0f);
    return __fadd_rn(1.0f, __fdiv_rn(d, 75.0f));
  }
  return clip_nan(d, -75.0f, 0.0f);
}

// an unsigned integer of kBytes bytes (uint4 / uint2 for 16 / 8)
template <int kBytes> struct Chunk;
template <> struct Chunk<16> { using T = uint4; };
template <> struct Chunk<8> { using T = uint2; };
template <> struct Chunk<4> { using T = uint32_t; };
template <> struct Chunk<2> { using T = uint16_t; };
template <> struct Chunk<1> { using T = uint8_t; };

// one slab element's bits as float32
__device__ __forceinline__ float bits_to_f32(uint32_t b, float*) {
  return __uint_as_float(b);
}
__device__ __forceinline__ float bits_to_f32(uint16_t b, __nv_bfloat16*) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// raw[0..kVec) = the bits of p[0..kVec), kBytes at a time (p aligned)
template <int kBytes, typename Bits>
__device__ __forceinline__ void load_run(const Bits* p, Bits (&raw)[kVec]) {
  constexpr int kPer = kBytes / sizeof(Bits);
#pragma unroll
  for (int c = 0; c < kVec / kPer; ++c) {
    const auto ch = *reinterpret_cast<const typename Chunk<kBytes>::T*>(
        p + c * kPer);
    memcpy(raw + c * kPer, &ch, kBytes);
  }
}

// the same with the widest loads p's alignment allows, from kBytes down
// to one element
template <int kBytes, typename Bits>
__device__ __forceinline__ void load_vec(const Bits* p, Bits (&raw)[kVec]) {
  if constexpr (kBytes == sizeof(Bits)) {
    load_run<kBytes>(p, raw);
  } else {
    if ((reinterpret_cast<uintptr_t>(p) & (kBytes - 1)) == 0) {
      load_run<kBytes>(p, raw);
    } else {
      load_vec<kBytes / 2>(p, raw);
    }
  }
}

// d[0..kVec) stored to p[0..kVec) kBytes at a time (p aligned)
template <int kBytes, typename Out>
__device__ __forceinline__ void store_run(Out* p, const float (&d)[kVec]) {
  constexpr int kPer = kBytes / sizeof(Out);
#pragma unroll
  for (int c = 0; c < kVec / kPer; ++c) {
    Out e[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) store_f32(&e[i], d[c * kPer + i]);
    typename Chunk<kBytes>::T ch;
    memcpy(&ch, e, kBytes);
    *reinterpret_cast<typename Chunk<kBytes>::T*>(p + c * kPer) = ch;
  }
}

// the same with the widest stores p's alignment allows
template <int kBytes, typename Out>
__device__ __forceinline__ void store_vec(Out* p, const float (&d)[kVec]) {
  if constexpr (kBytes == sizeof(Out)) {
    store_run<kBytes>(p, d);
  } else {
    if ((reinterpret_cast<uintptr_t>(p) & (kBytes - 1)) == 0) {
      store_run<kBytes>(p, d);
    } else {
      store_vec<kBytes / 2>(p, d);
    }
  }
}

// What every row of the block's patch shares for gathering its runs.
struct Row {
  int L;           // elements per patch row (ww * Cf)
  int Cf, x0, Wp;  // channels, the patch's first column, slab width
  int e_lo, e_hi;  // elements whose pixels lie in the slab and the rectangle
  int has_border, bx0, bx1;
};

// Loads run e0 of a patch row into raw and returns the elements that are
// 0.0 (bit i: border pixel or past the row's end).  Pixels outside the
// slab read as raw zeros.
template <int kLoad, typename Bits>
__device__ __forceinline__ unsigned gather_run(const Bits* __restrict__ src,
                                               const Row& w, bool row_in,
                                               bool row_zero, int e0,
                                               Bits (&raw)[kVec]) {
  if (row_zero) return kAllZero;
  if (row_in && e0 >= w.e_lo && e0 + kVec <= w.e_hi) {
    load_vec<kLoad>(src + e0, raw);
    return 0u;
  }
  // straddles the slab / rectangle edge or the row's end
  unsigned zero = 0u;
  int p = e0 / w.Cf, c = e0 - p * w.Cf;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int x = w.x0 + p;
    const bool inside = row_in && x >= 0 && x < w.Wp && e0 + i < w.L;
    raw[i] = inside ? src[e0 + i] : Bits(0);
    if (e0 + i >= w.L || (w.has_border && (x < w.bx0 || x >= w.bx1))) {
      zero |= 1u << i;
    }
    if (++c == w.Cf) {
      c = 0;
      ++p;
    }
  }
  return zero;
}

template <typename In, typename Out, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    gather_db_kernel(const In* __restrict__ slab, int Hs, int Wp, int Cf,
                     const int* __restrict__ y0s, const int* __restrict__ x0s,
                     int wh, int ww, int rows_per_block, int has_border,
                     int by0, int by1, int bx0, int bx1,
                     Out* __restrict__ out) {
  using Bits = typename Chunk<sizeof(In)>::T;
  constexpr bool kCodes = sizeof(In) == 1;
  constexpr int kRunBytes = kVec * static_cast<int>(sizeof(In));
  constexpr int kLoad = kRunBytes < 16 ? kRunBytes : 16;  // widest load
  __shared__ float table[kCodes ? 256 : 1];
  if (kCodes) {  // one float per code: exact
    for (int c = threadIdx.x; c < 256; c += kThreads) {
      table[c] = net_db<true, kScaled>(static_cast<float>(c));
    }
    __syncthreads();
  }
  const int n = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, wh - r0);
  Row w;
  w.L = ww * Cf;
  w.Cf = Cf;
  w.x0 = x0s[n];
  w.Wp = Wp;
  w.has_border = has_border;
  w.bx0 = bx0;
  w.bx1 = bx1;
  // patch columns [c_lo, c_hi) lie in the slab and inside the rectangle
  int c_lo = max(0, -w.x0), c_hi = min(ww, Wp - w.x0);
  if (has_border) {
    c_lo = max(c_lo, bx0 - w.x0);
    c_hi = min(c_hi, bx1 - w.x0);
  }
  w.e_lo = c_lo * Cf;
  w.e_hi = c_hi > c_lo ? c_hi * Cf : w.e_lo;
  const int y0 = y0s[n] + r0;
  const int runs = (w.L + kVec - 1) / kVec;
  // thread -> (row of a pass, run); rows_pass rows run side by side
  const int per_row = runs < kThreads ? runs : kThreads;
  const int rows_pass = kThreads / per_row;
  const int t_row = threadIdx.x / per_row, t_run = threadIdx.x % per_row;
  if (t_row >= rows_pass) return;
  // this thread's runs: rows t_row + q * rows_pass, runs t_run + p * per_row
  const int n_q = (rows - t_row + rows_pass - 1) / rows_pass;
  const int n_p = (runs - t_run + per_row - 1) / per_row;
  const Bits* bits = reinterpret_cast<const Bits*>(slab);
  // one element's bits -> the network's input value
  auto transform = [&](Bits raw) -> float {
    if constexpr (kCodes) {
      return table[raw];
    } else {
      return net_db<false, kScaled>(
          bits_to_f32(raw, static_cast<In*>(nullptr)));
    }
  };
  int q = 0, p = 0;   // the next run to fetch
  for (;;) {
    // fetch kBatch runs: every load is in flight before any arithmetic
    Bits raw[kBatch][kVec];
    unsigned zero[kBatch];
    int rr[kBatch], e0[kBatch];   // patch row (-1: none), first element
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      rr[b] = q < n_q ? t_row + q * rows_pass : -1;
      e0[b] = (t_run + p * per_row) * kVec;
      zero[b] = kAllZero;
      if (rr[b] < 0) continue;
      if (++p == n_p) {
        p = 0;
        ++q;
      }
      const int y = y0 + rr[b];
      const bool row_zero = has_border && (y < by0 || y >= by1);
      // the row's first element in the slab (only dereferenced in it)
      const Bits* src = bits + (static_cast<long long>(y) * Wp + w.x0) * Cf;
      zero[b] = gather_run<kLoad>(src, w, y >= 0 && y < Hs, row_zero, e0[b],
                                  raw[b]);
    }
    if (rr[0] < 0) break;
    // transform and store them
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (rr[b] < 0) break;
      // straight-line over the run, so its 8 dependent chains interleave;
      // in a run that straddles an edge, the border and past-the-end
      // elements are selected to 0.0 after
      float d[kVec];
      if (zero[b] == kAllZero) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) d[i] = 0.0f;
      } else if (zero[b] == 0u) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) d[i] = transform(raw[b][i]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float v = transform(raw[b][i]);
          d[i] = (zero[b] >> i) & 1u ? 0.0f : v;
        }
      }
      Out* dst = out + (static_cast<size_t>(n) * wh + r0 + rr[b]) * w.L +
                 e0[b];
      if (e0[b] + kVec <= w.L) {
        store_vec<16>(dst, d);
      } else {
        for (int i = 0; i < w.L - e0[b]; ++i) store_f32(dst + i, d[i]);
      }
    }
  }
}

template <typename In, typename Out, bool kScaled>
int launch(const void* slab, int Hs, int Wp, int Cf, const void* y0s,
           const void* x0s, int N, int wh, int ww, int has_border, int by0,
           int by1, int bx0, int bx1, void* out, cudaStream_t stream) {
  const long long runs = (static_cast<long long>(ww) * Cf + kVec - 1) / kVec;
  // kBatch runs per thread: rows of one patch per block
  const long long want = kBatch * kThreads / runs;
  const int rows = want < 1 ? 1 : (want > wh ? wh : static_cast<int>(want));
  const dim3 grid((wh + rows - 1) / rows, N);
  gather_db_kernel<In, Out, kScaled><<<grid, kThreads, 0, stream>>>(
      static_cast<const In*>(slab), Hs, Wp, Cf, static_cast<const int*>(y0s),
      static_cast<const int*>(x0s), wh, ww, rows, has_border, by0, by1, bx0,
      bx1, static_cast<Out*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename Out>
int launch_scaled(int scaled, const void* slab, int Hs, int Wp, int Cf,
                  const void* y0s, const void* x0s, int N, int wh, int ww,
                  int has_border, int by0, int by1, int bx0, int bx1,
                  void* out, cudaStream_t stream) {
  return scaled ? launch<In, Out, true>(slab, Hs, Wp, Cf, y0s, x0s, N, wh, ww,
                                        has_border, by0, by1, bx0, bx1, out,
                                        stream)
                : launch<In, Out, false>(slab, Hs, Wp, Cf, y0s, x0s, N, wh,
                                         ww, has_border, by0, by1, bx0, bx1,
                                         out, stream);
}

template <typename In>
int launch_in(int out_dtype, int scaled, const void* slab, int Hs, int Wp,
              int Cf, const void* y0s, const void* x0s, int N, int wh,
              int ww, int has_border, int by0, int by1, int bx0, int bx1,
              void* out, cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch_scaled<In, float>(scaled, slab, Hs, Wp, Cf, y0s, x0s, N,
                                    wh, ww, has_border, by0, by1, bx0, bx1,
                                    out, stream);
  if (out_dtype == kBF16)
    return launch_scaled<In, __nv_bfloat16>(scaled, slab, Hs, Wp, Cf, y0s,
                                            x0s, N, wh, ww, has_border, by0,
                                            by1, bx0, bx1, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int crimac_gather_db(const void* slab, int slab_dtype, int Hs,
                                int Wp, int Cf, const void* y0s,
                                const void* x0s, int N, int wh, int ww,
                                int has_border, int by0, int by1, int bx0,
                                int bx1, int scaled, void* out, int out_dtype,
                                void* stream) {
  if (static_cast<long long>(ww) * Cf >= (1ll << 31) - kVec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slab_dtype) {
    case kF32:
      return launch_in<float>(out_dtype, scaled, slab, Hs, Wp, Cf, y0s, x0s,
                              N, wh, ww, has_border, by0, by1, bx0, bx1, out,
                              s);
    case kBF16:
      return launch_in<__nv_bfloat16>(out_dtype, scaled, slab, Hs, Wp, Cf,
                                      y0s, x0s, N, wh, ww, has_border, by0,
                                      by1, bx0, bx1, out, s);
    case kU8:
      return launch_in<uint8_t>(out_dtype, scaled, slab, Hs, Wp, Cf, y0s,
                                x0s, N, wh, ww, has_border, by0, by1, bx0,
                                bx1, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
