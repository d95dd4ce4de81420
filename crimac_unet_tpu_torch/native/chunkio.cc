// chunkio: native (C++) chunk codec for the zarrlite data plane.
//
// The reference framework's survey stores are Blosc-compressed zarr v2
// directories (reference pipeline_train_predict/save_predict.py:124-134
// writes Blosc zstd-3 BITSHUFFLE; the xarray-written _sv/_labels/_bottom
// triplets opened at data_reader.py:516-575 default to Blosc).  This
// library gives the Python data plane a GIL-free, multi-threaded
// decompress/compress path on top of the system libblosc: one call decodes
// a whole slab's worth of chunks in parallel into caller-provided
// destinations.
//
// The PyTorch port's copy of crimac_unet_tpu/native/chunkio.cc (same C
// ABI and semantics).
//
// Exposed C ABI (consumed via ctypes from
// crimac_unet_tpu_torch/data/blosc_codec.py):
//   cio_version()                 -> libblosc version string
//   cio_decompress(...)           -> one buffer
//   cio_compress(...)             -> one buffer
//   cio_batch_decompress(...)     -> N buffers, std::thread fan-out
//   cio_batch_decompress_scatter[_cvt](...) -> N chunks scattered into a
//                                    strided slab (optionally f32 -> bf16)
//
// Build: blosc_codec.py runs g++ -O3 -fPIC -shared -std=c++17 at first
// use into .kernel_build/ beside the package, linking -l:libblosc.so.1
// -lpthread.  Without libblosc the codec falls back to a pure-numpy
// decoder (and new stores are written with zlib).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// libblosc 1.x C ABI (the system ships libblosc.so.1 without headers;
// these signatures are the stable public API of c-blosc 1.x).
extern "C" {
const char* blosc_get_version_string(void);
void blosc_cbuffer_sizes(const void* cbuffer, size_t* nbytes, size_t* cbytes,
                         size_t* blocksize);
int blosc_decompress_ctx(const void* src, void* dest, size_t destsize,
                         int numinternalthreads);
int blosc_compress_ctx(int clevel, int doshuffle, size_t typesize,
                       size_t nbytes, const void* src, void* dest,
                       size_t destsize, const char* compressor,
                       size_t blocksize, int numinternalthreads);
}
#define BLOSC_MIN_HEADER_LENGTH 16

extern "C" {

const char* cio_version() { return blosc_get_version_string(); }

// Decompress one blosc frame. Returns decompressed byte count or <0 on
// error (mirrors blosc_decompress_ctx).
int64_t cio_decompress(const void* src, int64_t src_size, void* dst,
                       int64_t dst_size) {
  if (src_size < BLOSC_MIN_HEADER_LENGTH) return -1;
  size_t nbytes = 0, cbytes = 0, blocksize = 0;
  blosc_cbuffer_sizes(src, &nbytes, &cbytes, &blocksize);
  if ((int64_t)cbytes > src_size || (int64_t)nbytes > dst_size) return -2;
  return blosc_decompress_ctx(src, dst, dst_size, /*numinternalthreads=*/1);
}

// Compress one buffer. Returns compressed byte count, 0 if dst too small,
// <0 on error.
int64_t cio_compress(int clevel, int shuffle, int64_t typesize,
                     const void* src, int64_t src_size, void* dst,
                     int64_t dst_size, const char* cname, int nthreads) {
  return blosc_compress_ctx(clevel, shuffle, (size_t)typesize,
                            (size_t)src_size, src, dst, (size_t)dst_size,
                            cname, /*blocksize=*/0, nthreads);
}

// Decompress n frames in parallel (one std::thread per hardware thread,
// work-stealing over an atomic counter).  srcs/dsts are arrays of
// pointers; results[i] receives the per-frame return code.  Returns 0 when
// every frame decoded, else the count of failed frames.
int64_t cio_batch_decompress(int64_t n, const void* const* srcs,
                             const int64_t* src_sizes, void* const* dsts,
                             const int64_t* dst_sizes, int64_t* results,
                             int max_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int64_t rc = cio_decompress(srcs[i], src_sizes[i], dsts[i],
                                  dst_sizes[i]);
      if (results) results[i] = rc;
      if (rc < 0) failed.fetch_add(1);
    }
  };
  int hw = (int)std::thread::hardware_concurrency();
  if (hw <= 0) hw = 4;
  if (max_threads > 0 && max_threads < hw) hw = max_threads;
  if ((int64_t)hw > n) hw = (int)n;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(hw);
    for (int t = 0; t < hw; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failed.load();
}

// Decompress n frames and scatter each directly into a strided
// destination (the HWC inference slab): chunk i decodes into
// thread-local scratch, then its sub-box [box_start, box_stop) is copied
// to dst_base + dst_offsets[i] with per-axis byte strides dst_strides.
// A NULL/empty frame (missing chunk) fills its box with the `fill`
// pattern instead.  This replaces the Python-side decode -> place ->
// transpose triple pass with decode -> one strided pass, with no
// intermediate (n, *chunks) buffer (crimac_unet_tpu_torch/data/zarrlite.py
// read_into).
//
// ndim <= CIO_MAX_DIMS; chunk_shape is the logical chunk shape in
// elements; all strides/offsets in BYTES.
#define CIO_MAX_DIMS 4

}  // extern "C" — the scatter helpers below are C++ (templates)

// Cache-blocked 2-D strided copy: src (n0, n1) with strides (ss0, ss1),
// dst strides (ds0, ds1).  32x32 element tiles keep both the read and
// the write side within a few cache lines per tile — the scatter's hot
// case is a (ping, range) -> (range, ping) transpose where one side is
// always a large stride.
template <typename T>
static void tiled_copy_2d(const char* src, char* dst, int64_t n0,
                          int64_t n1, int64_t ss0, int64_t ss1,
                          int64_t ds0, int64_t ds1) {
  const int64_t B = 32;
  for (int64_t i0 = 0; i0 < n0; i0 += B) {
    const int64_t m0 = (i0 + B < n0) ? i0 + B : n0;
    for (int64_t j0 = 0; j0 < n1; j0 += B) {
      const int64_t m1 = (j0 + B < n1) ? j0 + B : n1;
      for (int64_t i = i0; i < m0; ++i) {
        const char* s = src + i * ss0 + j0 * ss1;
        char* p = dst + i * ds0 + j0 * ds1;
        for (int64_t j = j0; j < m1; ++j) {
          *(T*)p = *(const T*)s;
          s += ss1;
          p += ds1;
        }
      }
    }
  }
}

static void cio_scatter_box(const char* src, char* dst, int ndim,
                            const int64_t* chunk_shape, int64_t itemsize,
                            const int64_t* b0, const int64_t* b1,
                            const int64_t* dst_strides) {
  // src strides (contiguous, row-major)
  int64_t sstr[CIO_MAX_DIMS];
  int64_t acc = itemsize;
  for (int d = ndim - 1; d >= 0; --d) {
    sstr[d] = acc;
    acc *= chunk_shape[d];
  }
  const int last = ndim - 1;
  const int64_t n_last = b1[last] - b0[last];
  if (n_last <= 0) return;

  // 2-D specialization: exactly two dims with extent > 1 and a
  // word-sized element -> cache-blocked transpose copy
  int wide[CIO_MAX_DIMS];
  int n_wide = 0;
  for (int d = 0; d < ndim; ++d) {
    if (b1[d] - b0[d] > 1) {
      if (n_wide < CIO_MAX_DIMS) wide[n_wide] = d;
      ++n_wide;
    }
    if (b1[d] - b0[d] <= 0) return;
  }
  if (n_wide == 2 && dst_strides[last] != itemsize &&
      (itemsize == 4 || itemsize == 8 || itemsize == 2 ||
       itemsize == 1)) {
    const int d0 = wide[0], d1 = wide[1];
    const char* s = src;
    char* p = dst;  // dst points at the box's first element already
    for (int d = 0; d < ndim; ++d) s += b0[d] * sstr[d];
    const int64_t n0 = b1[d0] - b0[d0], n1 = b1[d1] - b0[d1];
    switch (itemsize) {
      case 4:
        tiled_copy_2d<uint32_t>(s, p, n0, n1, sstr[d0], sstr[d1],
                                dst_strides[d0], dst_strides[d1]);
        return;
      case 8:
        tiled_copy_2d<uint64_t>(s, p, n0, n1, sstr[d0], sstr[d1],
                                dst_strides[d0], dst_strides[d1]);
        return;
      case 2:
        tiled_copy_2d<uint16_t>(s, p, n0, n1, sstr[d0], sstr[d1],
                                dst_strides[d0], dst_strides[d1]);
        return;
      case 1:
        tiled_copy_2d<uint8_t>(s, p, n0, n1, sstr[d0], sstr[d1],
                               dst_strides[d0], dst_strides[d1]);
        return;
    }
  }

  int64_t idx[CIO_MAX_DIMS];
  for (int d = 0; d < ndim; ++d) idx[d] = b0[d];
  for (;;) {
    const char* s = src;
    char* p = dst;
    for (int d = 0; d < ndim; ++d) {
      s += idx[d] * sstr[d];
      p += (idx[d] - b0[d]) * dst_strides[d];
    }
    if (dst_strides[last] == itemsize) {
      memcpy(p, s, (size_t)(n_last * itemsize));
    } else {
      for (int64_t i = 0; i < n_last; ++i)
        memcpy(p + i * dst_strides[last], s + i * itemsize,
               (size_t)itemsize);
    }
    // advance the outer dims (last dim handled as a run above)
    int d = last - 1;
    for (; d >= 0; --d) {
      if (++idx[d] < b1[d]) break;
      idx[d] = b0[d];
    }
    if (d < 0) break;
  }
}

static void cio_fill_box(char* dst, int ndim, int64_t itemsize,
                         const int64_t* b0, const int64_t* b1,
                         const int64_t* dst_strides, const char* fill) {
  int64_t idx[CIO_MAX_DIMS];
  for (int d = 0; d < ndim; ++d) {
    if (b1[d] - b0[d] <= 0) return;  // any empty dim: empty box (the
    idx[d] = b0[d];                  // do-style loop below would other-
  }                                  // wise fill one spurious inner run)
  const int last = ndim - 1;
  const int64_t n_last = b1[last] - b0[last];
  for (;;) {
    char* p = dst;
    for (int d = 0; d < ndim; ++d)
      p += (idx[d] - b0[d]) * dst_strides[d];
    for (int64_t i = 0; i < n_last; ++i)
      memcpy(p + i * dst_strides[last], fill, (size_t)itemsize);
    int d = last - 1;
    for (; d >= 0; --d) {
      if (++idx[d] < b1[d]) break;
      idx[d] = b0[d];
    }
    if (d < 0) break;
  }
}

// ------------------------------------------------------------------ cvt
// Converting scatter: decode float32 chunks, write a converted dtype.
// cvt codes exposed on the C ABI:
//   1: float32 -> bfloat16, round-to-nearest-even, NaN/Inf preserved
//      (bit-equal to torch's float32 -> bfloat16 for all finite values;
//      NaNs quieted with payload truncated — only NaN-ness is consumed
//      downstream, by the device-side isfinite scrub/write mask).
// Saves the separate float32 slab pass + cast on the predict hot path,
// whose host work bounds the end-to-end rate.

static inline uint16_t f32_bits_to_bf16(uint32_t u) {
  if ((u & 0x7FFFFFFFu) > 0x7F800000u)          // NaN: quiet, keep sign
    return (uint16_t)((u >> 16) | 0x0040u);
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// Cache-blocked 2-D strided transpose-copy with f32 -> bf16 conversion
// (the conversion twin of tiled_copy_2d; the scatter's hot case is the
// (ping, range) -> (range, ping) relayout where the destination stride
// of the inner run is a whole slab row — untiled, every element is a
// cache miss).
static void tiled_copy_2d_f32_bf16(const char* src, char* dst, int64_t n0,
                                   int64_t n1, int64_t ss0, int64_t ss1,
                                   int64_t ds0, int64_t ds1) {
  const int64_t B = 32;
  for (int64_t i0 = 0; i0 < n0; i0 += B) {
    const int64_t m0 = (i0 + B < n0) ? i0 + B : n0;
    for (int64_t j0 = 0; j0 < n1; j0 += B) {
      const int64_t m1 = (j0 + B < n1) ? j0 + B : n1;
      for (int64_t i = i0; i < m0; ++i) {
        const char* s = src + i * ss0 + j0 * ss1;
        char* p = dst + i * ds0 + j0 * ds1;
        for (int64_t j = j0; j < m1; ++j) {
          *(uint16_t*)p = f32_bits_to_bf16(*(const uint32_t*)s);
          s += ss1;
          p += ds1;
        }
      }
    }
  }
}

static void cio_scatter_box_f32_bf16(const char* src, char* dst, int ndim,
                                     const int64_t* chunk_shape,
                                     const int64_t* b0, const int64_t* b1,
                                     const int64_t* dst_strides) {
  int64_t sstr[CIO_MAX_DIMS];
  int64_t acc = 4;
  for (int d = ndim - 1; d >= 0; --d) {
    sstr[d] = acc;
    acc *= chunk_shape[d];
  }
  const int last = ndim - 1;
  const int64_t n_last = b1[last] - b0[last];
  if (n_last <= 0) return;
  for (int d = 0; d < ndim; ++d)
    if (b1[d] - b0[d] <= 0) return;

  // 2-D specialization (mirrors cio_scatter_box): exactly two dims with
  // extent > 1 and a strided destination -> cache-blocked tiles
  {
    int wide[CIO_MAX_DIMS];
    int n_wide = 0;
    for (int d = 0; d < ndim; ++d)
      if (b1[d] - b0[d] > 1) {
        if (n_wide < CIO_MAX_DIMS) wide[n_wide] = d;
        ++n_wide;
      }
    if (n_wide == 2) {
      const int d0 = wide[0], d1 = wide[1];
      const char* s = src;
      for (int d = 0; d < ndim; ++d) s += b0[d] * sstr[d];
      tiled_copy_2d_f32_bf16(s, dst, b1[d0] - b0[d0], b1[d1] - b0[d1],
                             sstr[d0], sstr[d1], dst_strides[d0],
                             dst_strides[d1]);
      return;
    }
  }

  int64_t idx[CIO_MAX_DIMS];
  for (int d = 0; d < ndim; ++d) idx[d] = b0[d];
  const int64_t ds_last = dst_strides[last];
  for (;;) {
    const char* s = src;
    char* p = dst;
    for (int d = 0; d < ndim; ++d) {
      s += idx[d] * sstr[d];
      p += (idx[d] - b0[d]) * dst_strides[d];
    }
    const uint32_t* sp = (const uint32_t*)s;
    if (ds_last == 2) {
      uint16_t* pp = (uint16_t*)p;
      for (int64_t i = 0; i < n_last; ++i) pp[i] = f32_bits_to_bf16(sp[i]);
    } else {
      for (int64_t i = 0; i < n_last; ++i)
        *(uint16_t*)(p + i * ds_last) = f32_bits_to_bf16(sp[i]);
    }
    int d = last - 1;
    for (; d >= 0; --d) {
      if (++idx[d] < b1[d]) break;
      idx[d] = b0[d];
    }
    if (d < 0) break;
  }
}

extern "C" {

// Converting variant of cio_batch_decompress_scatter: source chunks are
// float32, destination is the converted dtype selected by `cvt` (see
// table above; only cvt=1 / bf16 currently).  `fill` points at
// dst_itemsize bytes of the converted fill pattern.  Returns failed
// chunk count; -1 on bad arguments (unsupported cvt code or ndim out of
// range) so callers can distinguish API misuse from decode failures.
int64_t cio_batch_decompress_scatter_cvt(
    int64_t n, const void* const* srcs, const int64_t* src_sizes,
    int ndim, const int64_t* chunk_shape, int cvt,
    const int64_t* box_start, const int64_t* box_stop,
    void* dst_base, const int64_t* dst_offsets,
    const int64_t* dst_strides, const void* fill, int max_threads) {
  if (ndim <= 0 || ndim > CIO_MAX_DIMS || cvt != 1) return -1;
  const int64_t dst_itemsize = 2;
  int64_t chunk_bytes = 4;
  for (int d = 0; d < ndim; ++d) chunk_bytes *= chunk_shape[d];

  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(0);
  auto worker = [&]() {
    std::vector<char> scratch((size_t)chunk_bytes);
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      char* dst = (char*)dst_base + dst_offsets[i];
      const int64_t* b0 = box_start + i * ndim;
      const int64_t* b1 = box_stop + i * ndim;
      if (srcs[i] == nullptr || src_sizes[i] == 0) {
        cio_fill_box(dst, ndim, dst_itemsize, b0, b1, dst_strides,
                     (const char*)fill);
        continue;
      }
      int64_t rc = cio_decompress(srcs[i], src_sizes[i], scratch.data(),
                                  chunk_bytes);
      if (rc != chunk_bytes) {
        failed.fetch_add(1);
        continue;
      }
      cio_scatter_box_f32_bf16(scratch.data(), dst, ndim, chunk_shape,
                               b0, b1, dst_strides);
    }
  };
  int hw = (int)std::thread::hardware_concurrency();
  if (hw <= 0) hw = 4;
  if (max_threads > 0 && max_threads < hw) hw = max_threads;
  if ((int64_t)hw > n) hw = (int)n;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(hw);
    for (int t = 0; t < hw; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failed.load();
}

// Returns 0 on full success, the count of failed chunks on decode
// errors, or -1 on bad arguments (ndim out of range).
int64_t cio_batch_decompress_scatter(
    int64_t n, const void* const* srcs, const int64_t* src_sizes,
    int ndim, const int64_t* chunk_shape, int64_t itemsize,
    const int64_t* box_start,    // n * ndim
    const int64_t* box_stop,     // n * ndim
    void* dst_base, const int64_t* dst_offsets,  // n (bytes)
    const int64_t* dst_strides,  // ndim (bytes), in CHUNK axis order
    const void* fill,            // itemsize bytes
    int max_threads) {
  if (ndim <= 0 || ndim > CIO_MAX_DIMS) return -1;
  int64_t chunk_bytes = itemsize;
  for (int d = 0; d < ndim; ++d) chunk_bytes *= chunk_shape[d];

  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(0);
  auto worker = [&]() {
    std::vector<char> scratch((size_t)chunk_bytes);
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      char* dst = (char*)dst_base + dst_offsets[i];
      const int64_t* b0 = box_start + i * ndim;
      const int64_t* b1 = box_stop + i * ndim;
      if (srcs[i] == nullptr || src_sizes[i] == 0) {
        cio_fill_box(dst, ndim, itemsize, b0, b1, dst_strides,
                     (const char*)fill);
        continue;
      }
      int64_t rc = cio_decompress(srcs[i], src_sizes[i], scratch.data(),
                                  chunk_bytes);
      if (rc != chunk_bytes) {  // error or short frame: never scatter a
        failed.fetch_add(1);    // partially-initialized scratch buffer
        continue;
      }
      cio_scatter_box(scratch.data(), dst, ndim, chunk_shape, itemsize,
                      b0, b1, dst_strides);
    }
  };
  int hw = (int)std::thread::hardware_concurrency();
  if (hw <= 0) hw = 4;
  if (max_threads > 0 && max_threads < hw) hw = max_threads;
  if ((int64_t)hw > n) hw = (int)n;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(hw);
    for (int t = 0; t < hw; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failed.load();
}

}  // extern "C"
