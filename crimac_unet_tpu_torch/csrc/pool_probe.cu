// P1-P3: the pool probe's three layouts of the level-0 2x2 stride-2 max
// pool, (B, H, W, C) bfloat16 -> (B, H/2, W/2, C), NaN propagated as
// jnp.max, F.max_pool2d and K2 (csrc/pool.cu) propagate it.
//
// Replace scripts/pallas_pool_probe.py's Pallas kernels, which ask whether
// a hand-written kernel closes the level-0 pool's gap to its byte bound:
//   P1 pool_pallas_nhwc (:67, body _pool_kernel_nhwc :60): a row block of
//      the NHWC tensor staged in fast memory and reduced there;
//   P2 pool_pallas_lane128 (:97, body _pool_kernel_lane128 :84): the flat
//      (B, H, W*C) view with C = 64, each 2C = 128-element group one W-pair,
//      the W-max the max of the group's two halves, then the row-pair max;
//   P3 pool_pallas_packed (:126, body _pool_kernel_packed :116): the flat
//      view reshaped (TH, W/2, 2, C), any C.
// On Hopper the three stop being one design: P1 stages through shared
// memory, P2 meets its halves across lanes (a warp shuffle), P3 is a packed
// pair max on 4-byte words.
//
// Bound: bytes.  Each reads the input once and writes a quarter of it:
// 1.25 x 2 bytes an input element, 0.1002 ms at (32, 256, 256, 64) and
// 3.35 TB/s; one compare an input element is far below any compute rate.
//
// Designs (simple and right first; K2 is the yardstick of speed):
//   P1  one block per (b, output row).  Its two input rows are contiguous
//       in NHWC, 2 W C bfloat16 (64 KiB at W = 256, C = 64): the block
//       copies them into dynamic shared memory with 16-byte cp.async, waits,
//       then each thread reduces 8-channel groups from shared memory with
//       __hmax2_nan and writes 16 bytes.  The tile is the smallest that
//       holds whole windows of one output row (the JAX tile (1, 32, 256, 64)
//       is 1 MiB, past an SM's 227 KB); 64 KiB leaves room for three blocks
//       on an SM, so the copies of some overlap the reductions of others.
//       Needs C % 8 == 0, 16-byte aligned pointers, 4 W C bytes <= 227 KB.
//   P2  one warp per W-pair group of a row pair (C = 64): the group is 256
//       contiguous bytes a row, so lane l loads 8 bytes (two bfloat16x2
//       words) at 8 l from each of the two rows and takes the row max in
//       place; lanes 0-15 then hold the even pixel's 64 channels and lanes
//       16-31 the odd one's, so one __shfl_down_sync(..., 16) brings each
//       lane its partner and lanes 0-15 write the 128-byte output.
//   P3  one thread per output bfloat16x2 word: four 4-byte loads (even and
//       odd pixel, two rows), three __hmax2_nan.  Any even C; a warp reads
//       32 consecutive words of each of the four positions.

#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

struct alignas(16) Bf16x8 {
  __nv_bfloat162 h[4];
};
struct alignas(8) Bf16x4 {
  __nv_bfloat162 h[2];
};

__device__ __forceinline__ Bf16x8 max8(Bf16x8 a, const Bf16x8& b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a.h[j] = __hmax2_nan(a.h[j], b.h[j]);
  return a;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(unsigned v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// P1: grid (B * H/2), one output row a block; 2 W C bfloat16 of shared.
__global__ void pool_nhwc_kernel(const __nv_bfloat16* __restrict__ x,
                                 __nv_bfloat16* __restrict__ out, int H,
                                 int W, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Bf16x8* tile = reinterpret_cast<Bf16x8*>(smem_raw);
  const int Ho = H / 2, Wo = W / 2;
  const long long b = blockIdx.x / Ho;
  const int ho = blockIdx.x % Ho;
  const size_t row = static_cast<size_t>(W) * C;
  const Bf16x8* src = reinterpret_cast<const Bf16x8*>(
      x + (static_cast<size_t>(b) * H + 2 * ho) * row);
  const int n16 = static_cast<int>(2 * row / 8);   // 16-byte chunks
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    cp_async16(tile + i, src + i);
  cp_async_wait_all();
  __syncthreads();
  const int g8 = C / 8;
  const int row8 = static_cast<int>(row / 8);
  Bf16x8* dst = reinterpret_cast<Bf16x8*>(
      out + (static_cast<size_t>(b) * Ho + ho) * Wo * C);
  for (int v = threadIdx.x; v < Wo * g8; v += blockDim.x) {
    const int wo = v / g8, g = v % g8;
    const int p = 2 * wo * g8 + g;
    Bf16x8 m = max8(tile[p], tile[p + g8]);
    m = max8(m, tile[p + row8]);
    m = max8(m, tile[p + row8 + g8]);
    dst[v] = m;
  }
}

// P2: one warp a W-pair group; C = 64, so a group is 32 lanes x 8 bytes.
__global__ void pool_lane128_kernel(const __nv_bfloat16* __restrict__ x,
                                    __nv_bfloat16* __restrict__ out,
                                    long long groups, int H, int W) {
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  const int Ho = H / 2, Wo = W / 2;
  const size_t row = static_cast<size_t>(W) * 64;
  for (long long gid = (static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x) / 32;
       gid < groups; gid += warps) {
    const int wo = static_cast<int>(gid % Wo);
    const long long t = gid / Wo;
    const int ho = static_cast<int>(t % Ho);
    const long long b = t / Ho;
    const __nv_bfloat16* r0 =
        x + (static_cast<size_t>(b) * H + 2 * ho) * row +
        static_cast<size_t>(2 * wo) * 64 + 4 * lane;
    const Bf16x4 a = *reinterpret_cast<const Bf16x4*>(r0);
    const Bf16x4 c = *reinterpret_cast<const Bf16x4*>(r0 + row);
    const __nv_bfloat162 h0 = __hmax2_nan(a.h[0], c.h[0]);
    const __nv_bfloat162 h1 = __hmax2_nan(a.h[1], c.h[1]);
    const unsigned o0 = __shfl_down_sync(0xffffffffu, as_u32(h0), 16);
    const unsigned o1 = __shfl_down_sync(0xffffffffu, as_u32(h1), 16);
    if (lane < 16) {
      Bf16x4 m;
      m.h[0] = __hmax2_nan(h0, as_bf2(o0));
      m.h[1] = __hmax2_nan(h1, as_bf2(o1));
      *reinterpret_cast<Bf16x4*>(
          out + ((static_cast<size_t>(b) * Ho + ho) * Wo + wo) * 64 +
          4 * lane) = m;
    }
  }
}

// P3: one thread an output bfloat16x2 word; C even.
__global__ void pool_packed_kernel(const __nv_bfloat162* __restrict__ x,
                                   __nv_bfloat162* __restrict__ out,
                                   long long total, int H, int W, int C2) {
  const int Ho = H / 2, Wo = W / 2;
  const size_t row = static_cast<size_t>(W) * C2;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int cw = static_cast<int>(i % C2);
    long long t = i / C2;
    const int wo = static_cast<int>(t % Wo);
    t /= Wo;
    const int ho = static_cast<int>(t % Ho);
    const long long b = t / Ho;
    const size_t p = (static_cast<size_t>(b) * H + 2 * ho) * row +
                     static_cast<size_t>(2 * wo) * C2 + cw;
    const __nv_bfloat162 m0 = __hmax2_nan(x[p], x[p + C2]);
    const __nv_bfloat162 m1 = __hmax2_nan(x[p + row], x[p + row + C2]);
    out[i] = __hmax2_nan(m0, m1);
  }
}

unsigned grid_for(long long items, int per_block) {
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" int crimac_pool_probe_nhwc(const void* x, void* out, int B, int H,
                                      int W, int C, void* stream) {
  const long long smem = 4LL * W * C;   // two bfloat16 rows
  if (C % 8 || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pool_nhwc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pool_nhwc_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * (H / 2)),
                     256, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      H, W, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crimac_pool_probe_lane128(const void* x, void* out, int B,
                                         int H, int W, void* stream) {
  const long long groups = static_cast<long long>(B) * (H / 2) * (W / 2);
  pool_lane128_kernel<<<grid_for(groups, 8), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      groups, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crimac_pool_probe_packed(const void* x, void* out, int B,
                                        int H, int W, int C, void* stream) {
  if (C % 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long total =
      static_cast<long long>(B) * (H / 2) * (W / 2) * (C / 2);
  pool_packed_kernel<<<grid_for(total, 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat162*>(x),
      static_cast<__nv_bfloat162*>(out), total, H, W, C / 2);
  return static_cast<int>(cudaGetLastError());
}
