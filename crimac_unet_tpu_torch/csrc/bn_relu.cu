// Train-mode BatchNorm + ReLU of the U-Net's training step, forward and
// backward (ops/bn_relu.py), on a channels_last activation viewed as an
// (M, C) row-major matrix, M = N * H * W rows of C channels.
//
// Replaces no TPU kernel: the JAX package leaves flax's BatchNorm and the
// ReLU after it to XLA, which fuses them.  Run as plain PyTorch they took
// about twenty elementwise and reduction launches a layer forward, more
// backward, and a float32 copy of every activation.
//
// The law is flax's (models/unet.py _bn_train): float32 statistics
// mean = sum(z) / M and sq = sum(z^2) / M a channel; var = max(0, sq -
// mean^2) (biased, NaN kept); mul = rsqrt(var + eps) * gamma; the output
// relu(T((float(z) - mean) * mul + beta)), each operation rounded on its
// own (the __f*_rn intrinsics: never contracted into an FMA), so that given
// the same mean and mul the output is bit-equal to PyTorch's ops; running
// statistics keep * running + take * batch.  Backward, with g = dout where
// the output is > 0 (or NaN) and 0 elsewhere, xhat = (z - mean) * rstd:
//   sums   [sum(g), rstd * sum(g * (z - mean))]   = [dbeta, dgamma]
//   dz     = T(mul * ((g - a) - xhat * b)),  a = sum(g) / M,
//            b = sum(g * xhat) / M, or 0 where the clamp is active
// with the sums and M those of the global batch under a data mesh (the
// wrapper all-reduces between the kernels).
//
// Bound: bytes.  A few flops an element against 295 a byte at the ridge.
// Forward reads z twice and writes y once, backward reads dout and z twice
// and writes dz once: 8 passes over the activation.
//
// Design.  Each thread owns V consecutive channels (V = 8: 16-byte bfloat16
// accesses, where C % 8 == 0 and the pointers allow; else V = 1) and walks
// rows; a block of R * gt threads covers gt channel groups of R rows at a
// time, so a warp reads whole 128-byte lines.  The grid is (row blocks,
// channel tiles), its row blocks chosen by the wrapper from (M, C) and the
// card's SM count, so a level-0 map (1 M rows x 64) and a level-4 map (4096
// x 1024) both fill the card.  Reductions accumulate in float32 and are
// deterministic: each block reduces its row threads in a fixed order into
// its own partial, and the last block of a channel tile to finish (an
// integer atomic counter, reset by that block) sums the row blocks'
// partials in an order fixed by the shape, with several loads in flight.
// No float atomics: the same inputs give the same bits.  Means and the
// gradient's a and b are sums times 1/M, the float the wrapper passes.  The apply kernels compute each channel's mean, rstd, mul
// (and the running update, by row block 0) in their prologue, so a layer
// takes two launches forward and two backward.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 256;  // channels of a tile: gt * V
constexpr int kUnroll = 4;     // rows a thread loads before it sums them
constexpr int kTailAcc = 8;    // partials the last block has in flight

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// the float value of v rounded to T (round to nearest even)
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One channel's normalisation from its batch statistics, in flax's order
// of operations.
struct Channel {
  float mean, var, rstd, mul, beta;
  bool clamped;  // sq - mean^2 < 0 (or NaN): torch.clamp passes no gradient
};

__device__ __forceinline__ Channel channel_of(const float* stats,
                                              const float* weight,
                                              const float* bias, int C, int c,
                                              float eps) {
  Channel ch;
  ch.mean = stats[c];
  const float d = __fsub_rn(stats[C + c], __fmul_rn(ch.mean, ch.mean));
  ch.clamped = !(d >= 0.0f);
  ch.var = d < 0.0f ? 0.0f : d;  // torch.clamp(d, min=0) keeps NaN
  ch.rstd = rsqrtf(__fadd_rn(ch.var, eps));
  ch.mul = __fmul_rn(ch.rstd, weight[c]);
  ch.beta = bias[c];
  return ch;
}

// (z - mean) * mul + beta, each operation rounded on its own
__device__ __forceinline__ float affine(float centred, const Channel& ch) {
  return __fadd_rn(__fmul_rn(centred, ch.mul), ch.beta);
}

// The block's place: channel group g of tile blockIdx.y, row thread r,
// rows [start, end) of row block blockIdx.x.
struct Place {
  int gi, r, R, g, tile_c, width;
  long long start, end;
};

__device__ __forceinline__ Place place_of(long long M, int C, int V, int gt,
                                          long long rpb) {
  Place p;
  p.R = blockDim.x / gt;
  p.gi = threadIdx.x % gt;
  p.r = threadIdx.x / gt;
  p.g = blockIdx.y * gt + p.gi;
  p.tile_c = blockIdx.y * gt * V;
  p.width = min(gt * V, C - p.tile_c);
  p.start = blockIdx.x * rpb;
  p.end = min(M, p.start + rpb);
  return p;
}

// One row's V channels into the two sums: z and z^2 forward; backward g
// and g * (z - mean), with g the output's gradient where the recomputed
// output is > 0 (or NaN).
template <typename T, int V, bool kGrad>
__device__ __forceinline__ void accumulate(const Vec<T, V>& x,
                                           const Vec<T, V>& d,
                                           const Channel* ch, float* a,
                                           float* b) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (kGrad) {
      const float c = __fsub_rn(to_f32(x.v[j]), ch[j].mean);
      const float y = round_to<T>(affine(c, ch[j]));
      const float g = y <= 0.0f ? 0.0f : to_f32(d.v[j]);
      a[j] += g;
      b[j] += g * c;
    } else {
      const float v = to_f32(x.v[j]);
      a[j] += v;
      b[j] += v * v;
    }
  }
}

// Two sums a channel over the block's rows (z and z^2 forward; g and
// g * (z - mean) backward) into partial[blockIdx.x] (2, C); the last block
// of the tile sums all row blocks' partials in order into out (2, C):
// forward [s0 * inv_m, s1 * inv_m], backward [s0, s1 * rstd].
template <typename T, int V, bool kGrad>
__device__ __forceinline__ void reduce_body(
    const T* __restrict__ dout, const T* __restrict__ z,
    const float* __restrict__ stats, const float* __restrict__ weight,
    const float* __restrict__ bias, float* __restrict__ partial,
    unsigned* __restrict__ counter, float* __restrict__ out, long long M,
    int C, int gt, long long rpb, float eps, float inv_m) {
  using P = Vec<T, V>;
  __shared__ float s_acc[2 * kThreads * 8];
  __shared__ Channel s_ch[kMaxTile];
  __shared__ bool s_last;
  const Place p = place_of(M, C, V, gt, rpb);
  if (kGrad) {
    for (int k = threadIdx.x; k < p.width; k += blockDim.x)
      s_ch[k] = channel_of(stats, weight, bias, C, p.tile_c + k, eps);
    __syncthreads();
  }
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.0f;
  if (p.g < C / V) {
    const Channel* ch = s_ch + p.gi * V;
    const size_t col = static_cast<size_t>(p.g) * V;
    // kUnroll rows' loads in flight before their sums, then the rest
    long long row = p.start + p.r;
    for (; row + (kUnroll - 1) * p.R < p.end; row += kUnroll * p.R) {
      P x[kUnroll], d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t o = static_cast<size_t>(row + u * p.R) * C + col;
        x[u] = *reinterpret_cast<const P*>(z + o);
        if (kGrad) d[u] = *reinterpret_cast<const P*>(dout + o);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        accumulate<T, V, kGrad>(x[u], d[u], ch, a, b);
    }
    for (; row < p.end; row += p.R) {
      const size_t o = static_cast<size_t>(row) * C + col;
      const P x = *reinterpret_cast<const P*>(z + o);
      P d;
      if (kGrad) d = *reinterpret_cast<const P*>(dout + o);
      accumulate<T, V, kGrad>(x, d, ch, a, b);
    }
  }
  // the block's row threads, in row-thread order
  const int tw = gt * V;
  float* s0 = s_acc;
  float* s1 = s_acc + kThreads * 8;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s0[p.r * tw + p.gi * V + j] = a[j];
    s1[p.r * tw + p.gi * V + j] = b[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < p.width; k += blockDim.x) {
    float x0 = 0.0f, x1 = 0.0f;
    for (int q = 0; q < p.R; ++q) {
      x0 += s0[q * tw + k];
      x1 += s1[q * tw + k];
    }
    const size_t base = static_cast<size_t>(blockIdx.x) * 2 * C + p.tile_c + k;
    partial[base] = x0;
    partial[base + C] = x1;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(counter + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: K lanes a column split the row blocks, each summing
  // into kTailAcc accumulators in turn (as many loads in flight), then
  // the accumulators and the lanes are summed in order
  const int ncol = 2 * tw;
  const int K = max(1, static_cast<int>(blockDim.x) / ncol);
  for (int idx = threadIdx.x; idx < K * ncol; idx += blockDim.x) {
    const int lane = idx / ncol, k = idx % ncol;
    const int which = k / tw, kc = k % tw;
    float acc[kTailAcc] = {};
    if (kc < p.width) {
      const float* col = partial + static_cast<size_t>(which) * C +
                         p.tile_c + kc;
      const size_t step = static_cast<size_t>(2) * C;
      unsigned q = lane;
      for (; q + (kTailAcc - 1) * K < gridDim.x; q += kTailAcc * K) {
#pragma unroll
        for (int u = 0; u < kTailAcc; ++u)
          acc[u] += __ldcg(col + (q + u * K) * step);
      }
      for (; q < gridDim.x; q += K) acc[0] += __ldcg(col + q * step);
    }
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < kTailAcc; ++u) s += acc[u];
    s_acc[idx] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ncol; k += blockDim.x) {
    const int which = k / tw, kc = k % tw;
    if (kc >= p.width) continue;
    float s = 0.0f;
    for (int lane = 0; lane < K; ++lane) s += s_acc[lane * ncol + k];
    const float scale = !kGrad ? inv_m : which ? s_ch[kc].rstd : 1.0f;
    out[which * C + p.tile_c + kc] = s * scale;
  }
  if (threadIdx.x == 0) counter[blockIdx.y] = 0u;
}

template <typename T, int V>
__global__ void bn_relu_stats_kernel(const T* __restrict__ z,
                                     float* __restrict__ partial,
                                     unsigned* __restrict__ counter,
                                     float* __restrict__ stats, long long M,
                                     int C, int gt, long long rpb,
                                     float inv_m) {
  reduce_body<T, V, false>(nullptr, z, nullptr, nullptr, nullptr, partial,
                           counter, stats, M, C, gt, rpb, 0.0f, inv_m);
}

template <typename T, int V>
__global__ void bn_relu_grad_stats_kernel(
    const T* __restrict__ dout, const T* __restrict__ z,
    const float* __restrict__ stats, const float* __restrict__ weight,
    const float* __restrict__ bias, float* __restrict__ partial,
    unsigned* __restrict__ counter, float* __restrict__ sums, long long M,
    int C, int gt, long long rpb, float eps) {
  reduce_body<T, V, true>(dout, z, stats, weight, bias, partial, counter,
                          sums, M, C, gt, rpb, eps, 1.0f);
}

template <typename T, int V>
__global__ void bn_relu_apply_kernel(
    const T* __restrict__ z, const float* __restrict__ stats,
    const float* __restrict__ weight, const float* __restrict__ bias,
    float* __restrict__ running_mean, float* __restrict__ running_var,
    T* __restrict__ y, long long M, int C, int gt, long long rpb, float eps,
    float keep, float take) {
  using P = Vec<T, V>;
  __shared__ Channel s_ch[kMaxTile];
  const Place p = place_of(M, C, V, gt, rpb);
  for (int k = threadIdx.x; k < p.width; k += blockDim.x) {
    const int c = p.tile_c + k;
    const Channel ch = channel_of(stats, weight, bias, C, c, eps);
    s_ch[k] = ch;
    if (blockIdx.x == 0) {
      running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep),
                                  __fmul_rn(ch.mean, take));
      running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep),
                                 __fmul_rn(ch.var, take));
    }
  }
  __syncthreads();
  if (p.g >= C / V) return;
  const Channel* ch = s_ch + p.gi * V;
#pragma unroll 4
  for (long long row = p.start + p.r; row < p.end; row += p.R) {
    const size_t o = static_cast<size_t>(row) * C +
                     static_cast<size_t>(p.g) * V;
    const P x = *reinterpret_cast<const P*>(z + o);
    P out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float c = __fsub_rn(to_f32(x.v[j]), ch[j].mean);
      out.v[j] = relu_nan(from_f32<T>(affine(c, ch[j])));
    }
    *reinterpret_cast<P*>(y + o) = out;
  }
}

template <typename T, int V>
__global__ void bn_relu_grad_apply_kernel(
    const T* __restrict__ dout, const T* __restrict__ z,
    const float* __restrict__ stats, const float* __restrict__ weight,
    const float* __restrict__ bias, const float* __restrict__ sums,
    T* __restrict__ dz, long long M, int C, int gt, long long rpb, float eps,
    float inv_m) {
  using P = Vec<T, V>;
  __shared__ Channel s_ch[kMaxTile];
  __shared__ float s_a[kMaxTile], s_b[kMaxTile];
  const Place p = place_of(M, C, V, gt, rpb);
  for (int k = threadIdx.x; k < p.width; k += blockDim.x) {
    const int c = p.tile_c + k;
    const Channel ch = channel_of(stats, weight, bias, C, c, eps);
    s_ch[k] = ch;
    s_a[k] = __fmul_rn(sums[c], inv_m);
    s_b[k] = ch.clamped ? 0.0f : __fmul_rn(sums[C + c], inv_m);
  }
  __syncthreads();
  if (p.g >= C / V) return;
  const int k0 = p.gi * V;
#pragma unroll 4
  for (long long row = p.start + p.r; row < p.end; row += p.R) {
    const size_t o = static_cast<size_t>(row) * C +
                     static_cast<size_t>(p.g) * V;
    const P x = *reinterpret_cast<const P*>(z + o);
    const P d = *reinterpret_cast<const P*>(dout + o);
    P out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const Channel& ch = s_ch[k0 + j];
      const float c = __fsub_rn(to_f32(x.v[j]), ch.mean);
      const float yv = round_to<T>(affine(c, ch));
      const float g = yv <= 0.0f ? 0.0f : to_f32(d.v[j]);
      const float xhat = __fmul_rn(c, ch.rstd);
      const float t = __fsub_rn(__fsub_rn(g, s_a[k0 + j]),
                                __fmul_rn(xhat, s_b[k0 + j]));
      out.v[j] = from_f32<T>(__fmul_rn(ch.mul, t));
    }
    *reinterpret_cast<P*>(dz + o) = out;
  }
}

struct Grid {
  dim3 blocks;
  int threads, gt;
  long long rpb;
  bool ok;
};

// (row blocks, channel tiles) blocks of R * gt threads, gt channel groups
// of V channels a tile, kThreads / gt rows at a time
Grid grid_of(long long M, int C, int vec, int gt, int row_blocks) {
  Grid g{};
  g.ok = M > 0 && C > 0 && (vec == 1 || vec == 8) && C % vec == 0 &&
         gt >= 1 && gt * vec <= kMaxTile && row_blocks >= 1 &&
         (C / vec + gt - 1) / gt <= 65535;
  if (!g.ok) return g;
  g.blocks = dim3(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>((C / vec + gt - 1) / gt));
  g.threads = (kThreads / gt) * gt;
  g.gt = gt;
  g.rpb = (M + row_blocks - 1) / row_blocks;
  return g;
}

}  // namespace

// T and V from the dtype code and the vector width, then the launch
#define CRIMAC_BN_DISPATCH(dtype, vec, ...)  \
  do {                                       \
    if ((dtype) == kBF16) {                  \
      using T = __nv_bfloat16;               \
      if ((vec) == 8) {                      \
        constexpr int V = 8;                 \
        __VA_ARGS__;                         \
      } else {                               \
        constexpr int V = 1;                 \
        __VA_ARGS__;                         \
      }                                      \
    } else if ((dtype) == kF32) {            \
      using T = float;                       \
      if ((vec) == 8) {                      \
        constexpr int V = 8;                 \
        __VA_ARGS__;                         \
      } else {                               \
        constexpr int V = 1;                 \
        __VA_ARGS__;                         \
      }                                      \
    } else {                                 \
      return static_cast<int>(cudaErrorInvalidValue); \
    }                                        \
  } while (0)

// z (M, C) -> stats (2, C) float32 [sum(z) / M, sum(z^2) / M].  partial:
// (row_blocks, 2, C) float32 scratch; counter: a tile's int32 counters,
// zero before the launch and zero after it.
extern "C" int crimac_bn_relu_stats(const void* z, void* partial,
                                    void* counter, void* stats, int dtype,
                                    long long M, int C, int vec, int gt,
                                    int row_blocks, float inv_m,
                                    void* stream) {
  const Grid g = grid_of(M, C, vec, gt, row_blocks);
  if (!g.ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRIMAC_BN_DISPATCH(dtype, vec,
                     bn_relu_stats_kernel<T, V><<<g.blocks, g.threads, 0, s>>>(
                         static_cast<const T*>(z),
                         static_cast<float*>(partial),
                         static_cast<unsigned*>(counter),
                         static_cast<float*>(stats), M, C, g.gt, g.rpb,
                         inv_m));
  return static_cast<int>(cudaGetLastError());
}

// y = relu(T((z - mean) * mul + beta)) from stats (2, C); row block 0
// updates running_mean / running_var in place.
extern "C" int crimac_bn_relu_apply(const void* z, const void* stats,
                                    const void* weight, const void* bias,
                                    void* running_mean, void* running_var,
                                    void* y, int dtype, long long M, int C,
                                    int vec, int gt, int row_blocks,
                                    float eps, float keep, float take,
                                    void* stream) {
  const Grid g = grid_of(M, C, vec, gt, row_blocks);
  if (!g.ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRIMAC_BN_DISPATCH(dtype, vec,
                     bn_relu_apply_kernel<T, V><<<g.blocks, g.threads, 0, s>>>(
                         static_cast<const T*>(z),
                         static_cast<const float*>(stats),
                         static_cast<const float*>(weight),
                         static_cast<const float*>(bias),
                         static_cast<float*>(running_mean),
                         static_cast<float*>(running_var),
                         static_cast<T*>(y), M, C, g.gt, g.rpb, eps, keep,
                         take));
  return static_cast<int>(cudaGetLastError());
}

// sums (2, C) float32 [sum(g), rstd * sum(g * (z - mean))] of this
// batch; partial and counter as for crimac_bn_relu_stats.
extern "C" int crimac_bn_relu_grad_stats(
    const void* dout, const void* z, const void* stats, const void* weight,
    const void* bias, void* partial, void* counter, void* sums, int dtype,
    long long M, int C, int vec, int gt, int row_blocks, float eps,
    void* stream) {
  const Grid g = grid_of(M, C, vec, gt, row_blocks);
  if (!g.ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRIMAC_BN_DISPATCH(
      dtype, vec,
      bn_relu_grad_stats_kernel<T, V><<<g.blocks, g.threads, 0, s>>>(
          static_cast<const T*>(dout), static_cast<const T*>(z),
          static_cast<const float*>(stats), static_cast<const float*>(weight),
          static_cast<const float*>(bias), static_cast<float*>(partial),
          static_cast<unsigned*>(counter), static_cast<float*>(sums), M, C,
          g.gt, g.rpb, eps));
  return static_cast<int>(cudaGetLastError());
}

// dz = T(mul * ((g - sums[0] * inv_m) - xhat * sums[1] * inv_m)), the
// second term 0 where the variance's clamp is active; sums and inv_m = 1 /
// M of the global batch.
extern "C" int crimac_bn_relu_grad_apply(
    const void* dout, const void* z, const void* stats, const void* weight,
    const void* bias, const void* sums, void* dz, int dtype, long long M,
    int C, int vec, int gt, int row_blocks, float eps, float inv_m,
    void* stream) {
  const Grid g = grid_of(M, C, vec, gt, row_blocks);
  if (!g.ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRIMAC_BN_DISPATCH(
      dtype, vec,
      bn_relu_grad_apply_kernel<T, V><<<g.blocks, g.threads, 0, s>>>(
          static_cast<const T*>(dout), static_cast<const T*>(z),
          static_cast<const float*>(stats), static_cast<const float*>(weight),
          static_cast<const float*>(bias), static_cast<const float*>(sums),
          static_cast<T*>(dz), M, C, g.gt, g.rpb, eps, inv_m));
  return static_cast<int>(cudaGetLastError());
}
