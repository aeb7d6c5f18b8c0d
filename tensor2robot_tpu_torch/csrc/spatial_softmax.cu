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
// What the design does about it: every input element is read once and
// nothing else touches device memory. One warp owns one (b, c); each lane
// streams its share of the grid with an online softmax, keeping four
// running values (max m, s = sum e, sx = sum e*x, sy = sum e*y, rescaled
// whenever m grows), and the lanes merge with the same rescale through
// warp shuffles. No attention tensor is materialised, no block of the grid
// has to fit on chip, so any H*W streams. The kernel takes element strides,
// so the NCHW output of a convolution viewed as (B, H, W, C) needs no copy.
// Making it fast (channel-contiguous tiles, several warps per (b, c) for
// large grids) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
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

__device__ __forceinline__ Partial merge(const Partial& a, const Partial& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;  // neither side has seen an element
  const float ca = expf(a.m - m);  // 0 for an empty side (m = -inf)
  const float cb = expf(b.m - m);
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

template <typename T>
void launch(const void* x, void* out, int64_t rows, int64_t channels,
            int height, int width, int64_t sb, int64_t sh, int64_t sw,
            int64_t sc, float inv_temperature, cudaStream_t stream) {
  const float x_step = 2.f / static_cast<float>(width > 1 ? width - 1 : 1);
  const float y_step = 2.f / static_cast<float>(height > 1 ? height - 1 : 1);
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spatial_softmax_kernel<T><<<static_cast<unsigned>(blocks),
                              kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, channels, height,
      width, sb, sh, sw, sc, inv_temperature, x_step, y_step);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. The caller
// checks shapes (H*W < 2^31, B*C/8 blocks within the grid limit) and
// allocates `out` as a contiguous (B, 2C) tensor. Returns cudaGetLastError().
extern "C" int t2r_spatial_softmax(const void* x, void* out, int dtype,
                                   int64_t batch, int64_t height,
                                   int64_t width, int64_t channels,
                                   int64_t stride_b, int64_t stride_h,
                                   int64_t stride_w, int64_t stride_c,
                                   float inv_temperature, void* stream) {
  const int64_t rows = batch * channels;
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  if (dtype == 0) {
    launch<float>(x, out, rows, channels, h, w, stride_b, stride_h, stride_w,
                  stride_c, inv_temperature, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, out, rows, channels, h, w, stride_b, stride_h,
                          stride_w, stride_c, inv_temperature, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
