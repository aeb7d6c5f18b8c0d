// Fused spatial-softmax expectation ("feature points") for Hopper (sm_90a).
//
// Replaces the TPU kernel tensor2robot_tpu/ops/spatial_softmax.py::_kernel.
// For each (b, c) of a (B, H, W, C) map: a softmax over the H*W grid at
// 1/temperature, then the expected x and the expected y on linspace(-1, 1).
// out[b, c] is the x of channel c and out[b, C + c] its y (all x, then all
// y), in the input dtype; sums are taken in float32.
//
// What bounds it on this card: bytes. The work is one pass over the
// B*H*W*C input elements and a (B, 2C) write, with about ten operations per
// element, far below the H100's 295 operations per byte. At the serving
// path's sizes ((1..64, 16, 16, 64) bf16, at most 2 MiB) launch latency
// dominates even that bound.
//
// What the designs do about it: every input element is read once and
// nothing else touches device memory. Each thread streams its share of the
// grid with an online softmax, keeping four running values per channel
// (max m, s = sum e, sx = sum e*x, sy = sum e*y, rescaled whenever m
// grows), and the shares merge with the same rescale. No attention tensor
// is materialised and no block of the grid has to fit on chip, so any H*W
// streams. Both kernels take element strides, so a view needs no copy.
//
// Two kernels, one per layout, each reading whole 128-byte lines:
// - spatial_softmax_channels_kernel, for maps whose channels are
//   contiguous (stride_c = 1: the served tower's NHWC output). Each lane
//   owns two adjacent channels of a group of 64 and reads them in one
//   4-byte (bf16) or 8-byte (f32) load, so a warp reads one pixel's 128 or
//   256 contiguous bytes at once. A block of 8 warps would hold all 16K
//   elements of a 16 x 16 x 64 map on one SM, where the exps and the
//   address arithmetic, not the bytes, set the time. So a cluster of up
//   to 8 blocks (on 8 SMs) splits each (b, group)'s pixels, and the
//   blocks' partials merge through distributed shared memory. Each warp
//   issues eight pixels' loads before it folds them in (one rescale to
//   their max, then independent exps), with the pixel's (h, w) from a
//   multiply-high in place of a division and every exp one exp2 (the
//   values are scaled by log2(e) / temperature as they load). A block's
//   warps merge in a register tree in the group's 64 threads, which then
//   write the group's outputs in one coalesced store.
// - spatial_softmax_kernel, for every other layout (the NCHW output of a
//   convolution viewed as (B, H, W, C), where stride_w = 1). One warp per
//   (b, c); its lanes read consecutive pixels of a row and merge through
//   warp shuffles.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsPerBlock = 8;
// The channel-group kernel: a block's channels (two a lane), its warps,
// the pixels a warp loads at once, and the most blocks of a cluster.
constexpr int kGroup = 64;
constexpr int kChannelWarps = 8;
constexpr int kBatch = 8;
constexpr int kMaxSplit = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Online-softmax partial state of one lane (or one merged group of lanes).
struct Partial {
  float m, s, sx, sy;
};

// Two partials as one; kBase2: their values are in the base-2 domain.
template <bool kBase2 = false>
__device__ __forceinline__ Partial merge(const Partial& a, const Partial& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;  // neither side has seen an element
  // 0 for an empty side (m = -inf)
  const float ca = kBase2 ? exp2f(a.m - m) : expf(a.m - m);
  const float cb = kBase2 ? exp2f(b.m - m) : expf(b.m - m);
  return {m, a.s * ca + b.s * cb, a.sx * ca + b.sx * cb,
          a.sy * ca + b.sy * cb};
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spatial_softmax_kernel(const T* __restrict__ x, T* __restrict__ out,
                       int64_t rows, int64_t channels, int height, int width,
                       int64_t stride_b, int64_t stride_h, int64_t stride_w,
                       int64_t stride_c, float inv_temperature, float x_step,
                       float y_step) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int64_t b = row / channels;
  const int64_t c = row - b * channels;
  const T* base = x + b * stride_b + c * stride_c;

  Partial p{-INFINITY, 0.f, 0.f, 0.f};
  const int grid = height * width;
#pragma unroll 4
  for (int i = lane; i < grid; i += 32) {
    const int h = i / width;
    const int w = i - h * width;
    const float v = load_float(base + h * stride_h + w * stride_w) *
                    inv_temperature;
    const float xc = -1.f + x_step * static_cast<float>(w);
    const float yc = -1.f + y_step * static_cast<float>(h);
    if (v > p.m) {
      const float scale = expf(p.m - v);
      p.s = p.s * scale + 1.f;
      p.sx = p.sx * scale + xc;
      p.sy = p.sy * scale + yc;
      p.m = v;
    } else if (v > -INFINITY) {  // an element at -inf adds nothing
      const float e = expf(v - p.m);
      p.s += e;
      p.sx += e * xc;
      p.sy += e * yc;
    } else if (v != v) {  // NaN poisons the row, as in the plain version
      p.s = v;
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    Partial other;
    other.m = __shfl_xor_sync(kFullMask, p.m, offset);
    other.s = __shfl_xor_sync(kFullMask, p.s, offset);
    other.sx = __shfl_xor_sync(kFullMask, p.sx, offset);
    other.sy = __shfl_xor_sync(kFullMask, p.sy, offset);
    p = merge(p, other);
  }
  if (lane == 0) {
    const float inv_s = 1.f / p.s;
    T* out_row = out + b * 2 * channels;
    store_float(out_row + c, p.sx * inv_s);
    store_float(out_row + channels + c, p.sy * inv_s);
  }
}

// Two adjacent channels from one aligned 8-byte (f32) or 4-byte (bf16)
// load.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift
// (Granlund and Montgomery): shift = ceil(log2 d), magic = floor(2^32
// (2^shift - d) / d) + 1, so magic < 2^32 and the add cannot overflow.
struct Divider {
  uint32_t magic, shift;
  __device__ __forceinline__ int operator()(int n) const {
    const uint32_t u = static_cast<uint32_t>(n);
    return static_cast<int>((__umulhi(u, magic) + u) >> shift);
  }
};

Divider make_divider(int d) {
  uint32_t shift = 0;
  while ((uint64_t{1} << shift) < static_cast<uint64_t>(d)) ++shift;
  const uint64_t magic =
      (uint64_t{1} << 32) * ((uint64_t{1} << shift) - d) / d + 1;
  return {static_cast<uint32_t>(magic), shift};
}

// kBatch elements v (in the base-2 domain) at grid points (xc, yc) folded
// into p at once: one rescale to the batch's new max, then independent
// exps. An element at -inf adds nothing; a NaN poisons the row, and so
// does +inf, as in the plain version.
__device__ __forceinline__ void fold(Partial& p, const float (&v)[kBatch],
                                     const float (&xc)[kBatch],
                                     const float (&yc)[kBatch]) {
  float m = p.m;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) m = fmaxf(m, v[u]);  // NaN is skipped
  // A partial that has seen only -inf keeps max -inf: shift by 0 so
  // exp2(-inf - shift) is 0, never NaN.
  const float shift = m == -INFINITY ? 0.f : m;
  const float rescale = exp2f(p.m - shift);
  float s = p.s * rescale, sx = p.sx * rescale, sy = p.sy * rescale;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const float e = exp2f(v[u] - shift);
    s += e;
    sx = fmaf(e, xc[u], sx);
    sy = fmaf(e, yc[u], sy);
  }
  p = {m, s, sx, sy};
}

// One cluster of `split` blocks per (b, group of kGroup channels) of a map
// with stride_c = 1. Warp w of the cluster's block r takes pixels
// r * kChannelWarps + w + k * split * kChannelWarps. `scale` is
// log2(e) / temperature. kPairs: every pair of channels a lane loads is
// aligned for load_pair.
template <typename T, bool kPairs>
__global__ void __launch_bounds__(kChannelWarps * 32)
spatial_softmax_channels_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int64_t channels, int64_t groups, int height,
                                int width, Divider by_width, int64_t stride_b,
                                int64_t stride_h, int64_t stride_w,
                                float scale, float x_step, float y_step) {
  __shared__ Partial parts[kChannelWarps][kGroup];
  __shared__ Partial block_parts[kGroup];
  const cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t unit = blockIdx.x / split;  // (b, group)
  const int64_t b = unit / groups;
  const int64_t c0 = (unit - b * groups) * kGroup;
  const int64_t c = c0 + 2 * lane;  // and c + 1
  Partial p0{-INFINITY, 0.f, 0.f, 0.f};
  Partial p1 = p0;
  if (c < channels) {
    const bool pair = c + 1 < channels;  // the last lane of an odd C: one
    const T* base = x + b * stride_b + c;
    const int grid = height * width;
    const int step = split * kChannelWarps;  // between a warp's pixels
    for (int i0 = rank * kChannelWarps + warp; i0 < grid;
         i0 += kBatch * step) {
      // kBatch pixels' loads, all issued before any is folded in, so their
      // latencies overlap. A pixel past the grid reloads pixel i0 and
      // counts as -inf.
      float v0[kBatch], v1[kBatch], xc[kBatch], yc[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * step;
        const bool valid = i < grid;
        const int pixel = valid ? i : i0;
        const int h = by_width(pixel);
        const int w = pixel - h * width;
        const T* at = base + h * stride_h + w * stride_w;
        float2 v;
        if (kPairs && pair) {
          v = load_pair(at);
        } else {
          v.x = load_float(at);
          v.y = pair ? load_float(at + 1) : -INFINITY;
        }
        v0[u] = valid ? v.x * scale : -INFINITY;
        v1[u] = valid ? v.y * scale : -INFINITY;
        xc[u] = -1.f + x_step * static_cast<float>(w);
        yc[u] = -1.f + y_step * static_cast<float>(h);
      }
      fold(p0, v0, xc, yc);
      fold(p1, v1, xc, yc);
    }
  }
  parts[warp][2 * lane] = p0;
  parts[warp][2 * lane + 1] = p1;
  __syncthreads();
  // Thread t < kGroup owns channel c0 + t: it merges the block's warps in
  // a register tree, and in the cluster's first block the blocks' merged
  // partials, read from their shared memory.
  const int t = threadIdx.x;
  if (t < kGroup) {
    Partial q[kChannelWarps];
#pragma unroll
    for (int w = 0; w < kChannelWarps; ++w) q[w] = parts[w][t];
#pragma unroll
    for (int n = kChannelWarps / 2; n > 0; n /= 2) {
#pragma unroll
      for (int w = 0; w < n; ++w) q[w] = merge<true>(q[w], q[w + n]);
    }
    block_parts[t] = q[0];
  }
  cluster.sync();  // every block's partials are written
  if (rank == 0 && t < kGroup && c0 + t < channels) {
    Partial q[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      q[r] = r < split ? *cluster.map_shared_rank(&block_parts[t], r)
                       : Partial{-INFINITY, 0.f, 0.f, 0.f};
    }
#pragma unroll
    for (int n = kMaxSplit / 2; n > 0; n /= 2) {
#pragma unroll
      for (int r = 0; r < n; ++r) q[r] = merge<true>(q[r], q[r + n]);
    }
    const float inv_s = 1.f / q[0].s;
    T* out_row = out + b * 2 * channels;
    store_float(out_row + c0 + t, q[0].sx * inv_s);
    store_float(out_row + channels + c0 + t, q[0].sy * inv_s);
  }
  cluster.sync();  // no block leaves while the first reads its partials
}

struct Map {
  const void* x;
  void* out;
  int64_t batch, channels;
  int height, width;
  int64_t sb, sh, sw, sc;
  float inv_temperature, x_step, y_step;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_warps(const Map& m) {
  const int64_t rows = m.batch * m.channels;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spatial_softmax_kernel<T><<<static_cast<unsigned>(blocks),
                              kWarpsPerBlock * 32, 0, m.stream>>>(
      static_cast<const T*>(m.x), static_cast<T*>(m.out), rows, m.channels,
      m.height, m.width, m.sb, m.sh, m.sw, m.sc, m.inv_temperature, m.x_step,
      m.y_step);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_channels(const Map& m) {
  const int64_t groups = (m.channels + kGroup - 1) / kGroup;
  const int64_t units = m.batch * groups;
  const int grid = m.height * m.width;
  // Split each (b, group)'s pixels over twice the blocks of a cluster while
  // the launch still fits one block an SM and each block keeps at least one
  // batch of pixels a warp: (64, 16, 16, 64) takes clusters of 2, batch 1
  // clusters of 4.
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return err;
  int split = 1;
  while (split < kMaxSplit && 2 * split * units <= sms &&
         2 * split * kChannelWarps * kBatch <= grid) {
    split *= 2;
  }
  // Pairs start at even channels: aligned when the base is and every
  // stride of a dim that moves is even.
  const bool pairs =
      reinterpret_cast<uintptr_t>(m.x) % (2 * sizeof(T)) == 0 &&
      (m.batch == 1 || m.sb % 2 == 0) && (m.height == 1 || m.sh % 2 == 0) &&
      (m.width == 1 || m.sw % 2 == 0);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(split);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(units * split));
  config.blockDim = dim3(kChannelWarps * 32);
  config.stream = m.stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(
      &config,
      pairs ? spatial_softmax_channels_kernel<T, true>
            : spatial_softmax_channels_kernel<T, false>,
      static_cast<const T*>(m.x), static_cast<T*>(m.out), m.channels, groups,
      m.height, m.width, make_divider(m.width), m.sb, m.sh, m.sw,
      m.inv_temperature * kLog2e, m.x_step, m.y_step);
}

int run(bool channels_kernel, int dtype, const Map& m) {
  if (m.batch * m.channels == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  if (dtype == 0) {
    err = channels_kernel ? launch_channels<float>(m) : launch_warps<float>(m);
  } else if (dtype == 1) {
    err = channels_kernel ? launch_channels<__nv_bfloat16>(m)
                          : launch_warps<__nv_bfloat16>(m);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

Map make_map(const void* x, void* out, int64_t batch, int64_t height,
             int64_t width, int64_t channels, int64_t stride_b,
             int64_t stride_h, int64_t stride_w, int64_t stride_c,
             float inv_temperature, void* stream) {
  const int h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  return {x, out, batch, channels, h, w, stride_b, stride_h, stride_w,
          stride_c, inv_temperature,
          2.f / static_cast<float>(w > 1 ? w - 1 : 1),
          2.f / static_cast<float>(h > 1 ? h - 1 : 1),
          static_cast<cudaStream_t>(stream)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. The caller
// checks shapes (H*W < 2^31, the blocks within the grid limit) and
// allocates `out` as a contiguous (B, 2C) tensor. Each returns its
// launch's CUDA error code (0 on success).
// The warp-per-(b, c) kernel: any strides.
extern "C" int t2r_spatial_softmax(const void* x, void* out, int dtype,
                                   int64_t batch, int64_t height,
                                   int64_t width, int64_t channels,
                                   int64_t stride_b, int64_t stride_h,
                                   int64_t stride_w, int64_t stride_c,
                                   float inv_temperature, void* stream) {
  return run(false, dtype,
             make_map(x, out, batch, height, width, channels, stride_b,
                      stride_h, stride_w, stride_c, inv_temperature, stream));
}

// The channel-group kernel: stride_c must be 1, else cudaErrorInvalidValue.
extern "C" int t2r_spatial_softmax_channels(
    const void* x, void* out, int dtype, int64_t batch, int64_t height,
    int64_t width, int64_t channels, int64_t stride_b, int64_t stride_h,
    int64_t stride_w, int64_t stride_c, float inv_temperature, void* stream) {
  if (stride_c != 1) return static_cast<int>(cudaErrorInvalidValue);
  return run(true, dtype,
             make_map(x, out, batch, height, width, channels, stride_b,
                      stride_h, stride_w, stride_c, inv_temperature, stream));
}
