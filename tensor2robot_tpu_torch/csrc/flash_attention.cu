// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of tensor2robot_tpu/ops/flash_attention.py:
//   K2 _kernel      (out and the per-row logsumexp):
//        flash_forward_tc_kernel (bfloat16, tensor cores),
//        flash_forward_kernel    (float32, CUDA cores)
//   K3 _kernel_dq   (dq):
//        flash_dq_tc_kernel      (bfloat16, tensor cores),
//        flash_dq_kernel         (float32, CUDA cores)
//   K4 _kernel_dkv  (dk and dv):
//        flash_dkv_tc_kernel     (bfloat16, tensor cores),
//        flash_dkv_kernel        (float32, CUDA cores)
// q, k, v, out, dout, dq, dk and dv are (B, T, H, D) tensors addressed by
// element strides, so a (B, T, 1, D) view of a (B, T, D) activation needs
// no copy. lse and delta are contiguous (B*H, T) float32 rows. All sums
// are taken in float32; outputs are written in the input dtype.
//
// What bounds them on this card: operations. At the training path's
// shape, (8, 2048, 1, 64) bf16 causal, the forward does 4.3 GFLOP against
// 8.4 MB of traffic (about 500 operations a byte, above the H100's 295),
// and the backward passes more still. Only the tensor cores (989 TFLOP/s
// bf16) reach that bound.
//
// What the designs share: nothing of size T x T touches device memory.
// Each block owns one 64-row tile of one (b, h) row and loops over the
// 64-row tiles of the other side, staged in shared memory, with the online
// softmax (forward) or the saved logsumexp (backward) rebuilding the
// probabilities tile by tile; causal loops stop at (or start from) the
// diagonal. K3 gives every query tile and K4 every key tile to one block,
// so dq, dk and dv need no atomics and are deterministic. Rows past T and
// head dims past D are zero-filled in shared memory and masked, so any
// T >= 1 and any D that is a multiple of 8 up to 128 runs (D pads to 64 or
// 128 in shared memory).
//
// The bfloat16 kernels (K2, K3, K4) run every product on the tensor
// cores: one warpgroup (128 threads) per 64-row tile issues
// wgmma.mma_async m64nNk16 bf16 -> f32, with operands in shared memory in
// wgmma's 128-byte-swizzled layout, or, for the product that follows a
// score tile (P V in K2, dS K in K3, P^T dO and dS^T Q in K4), the bf16
// probabilities straight from the accumulator registers. The softmax, its
// rescaling and dS stay in registers. Tiles move as bf16 by 16-byte
// cp.async into a ring of two stages, the next tile loading while this one
// is multiplied, so the operands need a last-dim stride of 1 and
// 16-byte-aligned rows (the wrapper copies any other layout first). K2 and
// K3 launch the longest causal rows first and K4 the longest key columns
// first, so the 32-tile blocks do not form the last wave. They round P
// (and dS) to bf16 before that product, where the plain versions keep
// float32.
//
// The float32 kernels use the CUDA cores: each of 256 threads owns a
// 4 x 4 patch of a score tile and multiplies with float32 FMAs, with tiles
// staged as float32. A TF32 tensor-core product would miss the 1e-4
// float32 tolerance. They still take bfloat16, but only as the yardstick
// chip_smoke.py times the tensor-core kernels against; the wrappers never
// send bfloat16 there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Outside the anonymous namespace: the C entry points take these, and a
// type of internal linkage would hide their symbols.
struct Operand {
  void* ptr;
  int64_t sb, st, sh, sd;  // element strides of (B, T, H, D)
};

// Mirrored by ctypes in ops/flash_attention.py: keep the field order.
struct FlashParams {
  Operand q, k, v, o, dout, dq, dk, dv;
  float* lse;           // (B*H, T): written by the forward, read backward
  const float* delta;   // (B*H, T): rowsum(dout * out), read backward
  int64_t batch, seq, heads, dim;
  float scale;
  int causal;
};

namespace {

constexpr int kBlock = 64;        // rows of a query tile and of a key tile
constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr int kRows = kBlock / 16;  // tile rows (and score columns) a thread owns
constexpr int kPS = kBlock + 4;   // row stride of score tiles in shared memory
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Reductions over the 16 lanes that share a tile row (a half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, offset));
  }
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

// Rows [row0, row0 + kBlock) of one (b, h) into a kBlock x DP float tile
// with row stride DP + 1 (odd, so a column read hits 16 distinct banks),
// times `scale`; zeros past T and past D.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const Operand& x,
                                          int64_t b, int64_t h, int row0,
                                          int seq, int dim, float scale) {
  const T* base = static_cast<const T*>(x.ptr) + b * x.sb + h * x.sh;
  for (int idx = threadIdx.x; idx < kBlock * DP; idx += kThreads) {
    const int r = idx / DP;
    const int d = idx % DP;
    const int t = row0 + r;
    float value = 0.f;
    if (t < seq && d < dim) {
      value = load_float(base + t * x.st + d * x.sd) * scale;
    }
    dst[r * (DP + 1) + d] = value;
  }
}

// K2. One block per (b*h, query tile): out = softmax(q k^T * scale) v and
// lse = logsumexp of each score row, by the online softmax over key tiles.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const FlashParams p) {
  constexpr int KS = DP + 1;
  constexpr int kCols = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;                // query tile, pre-scaled
  float* ks = qs + kBlock * KS;    // key tile
  float* vs = ks + kBlock * KS;    // value tile
  float* ps = vs + kBlock * KS;    // probabilities of the score tile
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.heads;
  const int64_t h = bh - b * p.heads;
  const int seq = static_cast<int>(p.seq);
  const int dim = static_cast<int>(p.dim);
  const int q0 = blockIdx.y * kBlock;

  load_tile<T, DP>(qs, p.q, b, h, q0, seq, dim, p.scale);
  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // Causal: only the key tiles that reach this query tile's last row.
  const int k_end = p.causal ? min(seq, q0 + kBlock) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();  // the last tile's readers are done with ks, vs, ps
    load_tile<T, DP>(ks, p.k, b, h, k0, seq, dim, 1.f);
    load_tile<T, DP>(vs, p.v, b, h, k0, seq, dim, 1.f);
    __syncthreads();

    float s[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[kRows], kv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * KS + d];
#pragma unroll
      for (int j = 0; j < kRows; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= seq || (p.causal && kj > qi)) s[i][j] = -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tile_max));
      // A row that has seen only masked scores keeps max -inf: shift by 0
      // so exp(-inf - shift) is 0, never NaN.
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float correction = expf(m[i] - shift);
      float row = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float e = expf(s[i][j] - shift);
        ps[(ty * kRows + i) * kPS + tx + 16 * j] = e;
        row += e;
      }
      l[i] = l[i] * correction + row_sum(row);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= correction;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vs[c * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }

  T* out = static_cast<T*>(p.o.ptr) + b * p.o.sb + h * p.o.sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= seq) continue;
    const float shift = m[i] == -INFINITY ? 0.f : m[i];
    // A fully masked row (l = 0) gets a large negative finite lse.
    if (tx == 0) p.lse[bh * seq + qi] = shift + logf(fmaxf(l[i], 1e-37f));
    const float denominator = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < dim) {
        store_float(out + qi * p.o.st + d * p.o.sd, acc[i][j] / denominator);
      }
    }
  }
}

// K3 on the CUDA cores. One block per (b*h, query tile): dq = sum over key
// tiles of (P * (dout v^T - delta)) k * scale, with P = exp(q k^T * scale
// - lse).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const FlashParams p) {
  constexpr int KS = DP + 1;
  constexpr int kCols = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBlock * KS;
  float* ks = dos + kBlock * KS;
  float* vs = ks + kBlock * KS;
  float* dss = vs + kBlock * KS;  // dS of the score tile
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.heads;
  const int64_t h = bh - b * p.heads;
  const int seq = static_cast<int>(p.seq);
  const int dim = static_cast<int>(p.dim);
  const int q0 = blockIdx.y * kBlock;
  const float scale = p.scale;

  load_tile<T, DP>(qs, p.q, b, h, q0, seq, dim, 1.f);
  load_tile<T, DP>(dos, p.dout, b, h, q0, seq, dim, 1.f);
  float lse[kRows], delta[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    lse[i] = qi < seq ? p.lse[bh * seq + qi] : 0.f;
    delta[i] = qi < seq ? p.delta[bh * seq + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int k_end = p.causal ? min(seq, q0 + kBlock) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();
    load_tile<T, DP>(ks, p.k, b, h, k0, seq, dim, 1.f);
    load_tile<T, DP>(vs, p.v, b, h, k0, seq, dim, 1.f);
    __syncthreads();

    float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[kRows], dov[kRows], kv[kRows], vv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = qs[(ty * kRows + i) * KS + d];
        dov[i] = dos[(ty * kRows + i) * KS + d];
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        kv[j] = ks[(tx + 16 * j) * KS + d];
        vv[j] = vs[(tx + 16 * j) * KS + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int kj = k0 + tx + 16 * j;
        float ds = 0.f;
        if (kj < seq && !(p.causal && kj > qi)) {
          ds = expf(s[i][j] * scale - lse[i]) * (dp[i][j] - delta[i]);
        }
        dss[(ty * kRows + i) * kPS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float dsv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = dss[(ty * kRows + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[c * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq.ptr) + b * p.dq.sb + h * p.dq.sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= seq) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < dim) store_float(dq + qi * p.dq.st + d * p.dq.sd, acc[i][j] * scale);
    }
  }
}

// K4. One block per (b*h, key tile), looping over the query tiles from the
// causal start: dv = sum P^T dout and dk = sum (P * (dout v^T - delta))^T
// q * scale. Each key tile belongs to one block: no atomics.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const FlashParams p) {
  constexpr int KS = DP + 1;
  constexpr int kCols = DP / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlock * KS;
  float* qs = vs + kBlock * KS;
  float* dos = qs + kBlock * KS;
  float* pts = dos + kBlock * KS;  // P^T of the score tile: [key][query]
  float* dsts = pts + kBlock * kPS;  // dS^T
  float* lses = dsts + kBlock * kPS;
  float* deltas = lses + kBlock;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.heads;
  const int64_t h = bh - b * p.heads;
  const int seq = static_cast<int>(p.seq);
  const int dim = static_cast<int>(p.dim);
  const int k0 = blockIdx.y * kBlock;
  const float scale = p.scale;

  load_tile<T, DP>(ks, p.k, b, h, k0, seq, dim, 1.f);
  load_tile<T, DP>(vs, p.v, b, h, k0, seq, dim, 1.f);
  float dk[kRows][kCols], dv[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  // Causal: query tiles before this key tile's own see none of its keys.
  for (int q0 = p.causal ? k0 : 0; q0 < seq; q0 += kBlock) {
    __syncthreads();
    load_tile<T, DP>(qs, p.q, b, h, q0, seq, dim, 1.f);
    load_tile<T, DP>(dos, p.dout, b, h, q0, seq, dim, 1.f);
    if (threadIdx.x < kBlock) {
      const int qi = q0 + threadIdx.x;
      lses[threadIdx.x] = qi < seq ? p.lse[bh * seq + qi] : 0.f;
      deltas[threadIdx.x] = qi < seq ? p.delta[bh * seq + qi] : 0.f;
    }
    __syncthreads();

    // Transposed score patch: rows are this thread's keys, columns queries.
    float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float kv[kRows], vv[kRows], qv[kRows], dov[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = ks[(ty * kRows + i) * KS + d];
        vv[i] = vs[(ty * kRows + i) * KS + d];
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        qv[j] = qs[(tx + 16 * j) * KS + d];
        dov[j] = dos[(tx + 16 * j) * KS + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kj = k0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = tx + 16 * j;
        const int qi = q0 + r;
        float prob = 0.f;
        if (qi < seq && kj < seq && !(p.causal && kj > qi)) {
          prob = expf(s[i][j] * scale - lses[r]);
        }
        pts[(ty * kRows + i) * kPS + r] = prob;
        dsts[(ty * kRows + i) * kPS + r] = prob * (dp[i][j] - deltas[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBlock; ++r) {
      float pv[kRows], dsv[kRows], dov[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = pts[(ty * kRows + i) * kPS + r];
        dsv[i] = dsts[(ty * kRows + i) * kPS + r];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        dov[j] = dos[r * KS + tx + 16 * j];
        qv[j] = qs[r * KS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk.ptr) + b * p.dk.sb + h * p.dk.sh;
  T* dv_out = static_cast<T*>(p.dv.ptr) + b * p.dv.sb + h * p.dv.sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + ty * kRows + i;
    if (kj >= seq) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < dim) {
        store_float(dk_out + kj * p.dk.st + d * p.dk.sd, dk[i][j] * scale);
        store_float(dv_out + kj * p.dv.st + d * p.dv.sd, dv[i][j]);
      }
    }
  }
}

// --- the tensor-core kernels (bfloat16) ------------------------------------

constexpr int kWarpgroup = 128;   // threads of a tensor-core block
constexpr int kSwizzleRow = 128;  // bytes of a swizzled tile row: 64 bf16
constexpr int kColumnBlock = kBlock * kSwizzleRow;  // a 64 x 64 bf16 block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device to shared memory, asynchronously; zeros
// when !valid (src is then not read).
__device__ __forceinline__ void copy16_async(uint32_t dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void copy4_async(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits for this thread's copies but the newest group, then makes them
// visible to wgmma, which reads shared memory through the async proxy.
__device__ __forceinline__ void wait_copies_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of one (b, h) as a bf16 64 x DP tile in the
// layout wgmma reads with 128-byte swizzling: DP / 64 column blocks of 64
// rows x 128 bytes, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8) of its row. Zeros past T and past D.
template <int DP>
__device__ __forceinline__ void stage_tile(uint32_t dst, const Operand& x,
                                           int64_t b, int64_t h, int row0,
                                           int seq, int dim) {
  const __nv_bfloat16* base =
      static_cast<const __nv_bfloat16*>(x.ptr) + b * x.sb + h * x.sh;
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kBlock * kChunks / kWarpgroup; ++i) {
    const int idx = threadIdx.x + i * kWarpgroup;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int t = row0 + r;
    const bool valid = t < seq && c * 8 < dim;
    const uint32_t offset = (c / 8) * kColumnBlock + r * kSwizzleRow +
                            (((c % 8) ^ (r % 8)) << 4);
    copy16_async(dst + offset, valid ? base + t * x.st + c * 8 : base, valid);
  }
}

// lse then delta of the 64 query rows from q0: 128 floats, one a thread.
__device__ __forceinline__ void stage_rows(uint32_t dst, const FlashParams& p,
                                           int64_t bh, int q0, int seq) {
  const int i = threadIdx.x;
  const int qi = q0 + i % kBlock;
  const float* src = (i < kBlock ? p.lse : p.delta) + bh * seq;
  copy4_async(dst + 4 * i, qi < seq ? src + qi : src, qi < seq);
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (in 16-byte units), 128-byte swizzling (mode 1).
__device__ __forceinline__ uint64_t smem_desc(uint32_t address,
                                              uint32_t leading,
                                              uint32_t stride) {
  return static_cast<uint64_t>((address & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(leading >> 4) << 16 |
         static_cast<uint64_t>(stride >> 4) << 32 | 1ull << 62;
}
// A staged tile read K-major (the product sums over its DP columns):
// 8-row groups 1024 bytes apart; k-step kk (16 columns) starts 32 bytes
// further into a 128-byte row, or in the next column block.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kColumnBlock + (kk % 4) * 32, 16,
                   8 * kSwizzleRow);
}
// A staged tile read MN-major (the product sums over its 64 rows): k-step
// kk is rows 16 kk to 16 kk + 15; column blocks kColumnBlock apart.
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * kSwizzleRow, kColumnBlock,
                   8 * kSwizzleRow);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers that wgmma reads or writes asynchronously in program
// order against the fence and the wait: the compiler may not move their
// other reads and writes across it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

#define T2R_ACC8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) = A B (+ d if accumulate): A 64 x 16 and B 16 x 64 in
// shared memory, both K-major.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : T2R_ACC8(0), T2R_ACC8(8), T2R_ACC8(16), T2R_ACC8(24)
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)));
}

// d (64 x N, f32) += A B: A 64 x 16 bf16 in registers (the accumulator
// layout of a 64 x 64 product, packed in pairs), B 16 x N in shared memory,
// MN-major. N = 64 or 128.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : T2R_ACC8(0), T2R_ACC8(8), T2R_ACC8(16), T2R_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : T2R_ACC8(0), T2R_ACC8(8), T2R_ACC8(16), T2R_ACC8(24), T2R_ACC8(32),
        T2R_ACC8(40), T2R_ACC8(48), T2R_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef T2R_ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 f32 accumulator as the bf16 A operand of the next product,
// whose k runs along the accumulator's columns: thread element 4 j + 2 b + a
// sits at row 16 warp + lane / 4 + 8 b, column 8 j + 2 (lane % 4) + a, and
// k-step kk takes elements 8 kk to 8 kk + 7 in pairs.
__device__ __forceinline__ void to_operand(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    }
  }
}

// Writes a thread's part of a 64 x DP accumulator, times `scale_rows[b]`
// for its row b, as bf16 pairs: rows row0 and row0 + 8 of the tile.
template <int DP>
__device__ __forceinline__ void store_tile(const Operand& x, int64_t b,
                                           int64_t h, int row0, int seq,
                                           int dim, const float (&d)[DP / 2],
                                           const float (&scale_rows)[2]) {
  __nv_bfloat16* base =
      static_cast<__nv_bfloat16*>(x.ptr) + b * x.sb + h * x.sh;
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int half = i / 2 % 2;
    const int row = row0 + 8 * half;
    const int col = 8 * (i / 4) + 2 * t4;
    if (row < seq && col < dim) {
      *reinterpret_cast<__nv_bfloat162*>(base + row * x.st + col) =
          __floats2bfloat162_rn(d[i] * scale_rows[half],
                                d[i + 1] * scale_rows[half]);
    }
  }
}

// K2 on the tensor cores. One warpgroup per (b*h, query tile), longest
// causal rows first: S = Q K^T by wgmma from shared memory; the online
// max, sum and rescale in the accumulator registers; P rounded to bf16 in
// registers as the A operand of O += P V, V read MN-major. The next key
// and value tiles load while this one is multiplied.
template <int DP>
__global__ void __launch_bounds__(kWarpgroup)
flash_forward_tc_kernel(const FlashParams p) {
  constexpr int kTile = kBlock * DP * 2;  // bytes of a staged bf16 tile
  extern __shared__ uint8_t tc_smem[];
  // The swizzle pattern repeats every 1024 bytes: align the tiles to it.
  const uint32_t qs = (smem_address(tc_smem) + 1023) & ~1023u;
  const uint32_t ks = qs + kTile;      // two stages
  const uint32_t vs = ks + 2 * kTile;  // two stages
  const int warp = threadIdx.x / 32;
  const int t4 = threadIdx.x % 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.heads;
  const int64_t h = bh - b * p.heads;
  const int seq = static_cast<int>(p.seq);
  const int dim = static_cast<int>(p.dim);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const int row0 = q0 + 16 * warp + threadIdx.x % 32 / 4;  // and row0 + 8
  const float scale = p.scale * kLog2e;  // scores in the log2 domain
  const int k_end = p.causal ? min(seq, q0 + kBlock) : seq;
  const int tiles = (k_end + kBlock - 1) / kBlock;

  stage_tile<DP>(qs, p.q, b, h, q0, seq, dim);
  stage_tile<DP>(ks, p.k, b, h, 0, seq, dim);
  stage_tile<DP>(vs, p.v, b, h, 0, seq, dim);
  commit_copies();

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum
  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * kBlock;
    const uint32_t stage = (j % 2) * kTile;
    if (j + 1 < tiles) {
      stage_tile<DP>(ks + kTile - stage, p.k, b, h, k0 + kBlock, seq, dim);
      stage_tile<DP>(vs + kTile - stage, p.v, b, h, k0 + kBlock, seq, dim);
    }
    commit_copies();
    wait_copies_but_newest();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss(s, k_major(qs, kk), k_major(ks + stage, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin(s);

    // Only the diagonal tile and the ragged tail need a mask.
    const bool masked = (p.causal && k0 + kBlock - 1 > q0) ||
                        k0 + kBlock > seq;
    float tile_max[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * t4 + i % 2;
      const int row = row0 + 8 * (i / 2 % 2);
      s[i] *= scale;
      if (masked && (key >= seq || (p.causal && key > row))) s[i] = -INFINITY;
      tile_max[i / 2 % 2] = fmaxf(tile_max[i / 2 % 2], s[i]);
    }
    float shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // The four lanes of a quad share a row.
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(kFullMask, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(kFullMask, tile_max[r], 2));
      // A row that has seen only masked scores keeps max -inf: shift by 0
      // so exp2(-inf - shift) is 0, never NaN.
      shift[r] = tile_max[r] == -INFINITY ? 0.f : tile_max[r];
      const float correction = exp2f(m[r] - shift[r]);
      m[r] = tile_max[r];
      l[r] *= correction;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) {
        if (i / 2 % 2 == r) o[i] *= correction;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - shift[i / 2 % 2]);
      l[i / 2 % 2] += s[i];
    }
    uint32_t a[4][4];
    to_operand(s, a);
    pin(a);
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(o, a[kk], mn_major(vs + stage, kk));
    wgmma_commit();
    wgmma_wait();
    pin(o);
    __syncthreads();  // every read of this stage is done before its refill
  }

  float inverse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
    const int row = row0 + 8 * r;
    const float shift = m[r] == -INFINITY ? 0.f : m[r];
    // A fully masked row (l = 0) gets a large negative finite lse.
    if (t4 == 0 && row < seq) {
      p.lse[bh * seq + row] = shift * kLn2 + logf(fmaxf(l[r], 1e-37f));
    }
    inverse[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
  }
  store_tile<DP>(p.o, b, h, row0, seq, dim, o, inverse);
}

// K4 on the tensor cores. One warpgroup per (b*h, key tile), longest key
// columns first (the natural order), looping over the query tiles from
// the causal start with everything in the transposed frame, so that every
// product has its 64-row side on this block's keys:
//   S^T = K Q^T;  P^T = exp(S^T scale - lse);  dV += P^T dO;
//   dP^T = V dO^T;  dS^T = P^T (dP^T - delta);  dK += dS^T Q.
// P^T and dS^T are rounded to bf16 in registers as the A operands; the
// staged Q and dO tiles serve both as K-major and as MN-major operands.
// The next query tile, its dO tile and its lse and delta rows load while
// this one is multiplied. Each key tile belongs to one block: no atomics.
template <int DP>
__global__ void __launch_bounds__(kWarpgroup)
flash_dkv_tc_kernel(const FlashParams p) {
  constexpr int kTile = kBlock * DP * 2;
  constexpr int kRowBytes = 2 * kBlock * sizeof(float);  // lse and delta
  extern __shared__ uint8_t tc_smem[];
  const uint32_t ks = (smem_address(tc_smem) + 1023) & ~1023u;
  const uint32_t vs = ks + kTile;
  const uint32_t qs = vs + kTile;       // two stages
  const uint32_t dos = qs + 2 * kTile;  // two stages
  const uint32_t rows = dos + 2 * kTile;  // two stages
  const float* rows_at = reinterpret_cast<const float*>(
      tc_smem + (rows - smem_address(tc_smem)));
  const int warp = threadIdx.x / 32;
  const int t4 = threadIdx.x % 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.heads;
  const int64_t h = bh - b * p.heads;
  const int seq = static_cast<int>(p.seq);
  const int dim = static_cast<int>(p.dim);
  const int k0 = blockIdx.y * kBlock;
  const int key0 = k0 + 16 * warp + threadIdx.x % 32 / 4;  // and key0 + 8
  const float scale = p.scale * kLog2e;
  // Causal: query tiles before this key tile's own see none of its keys.
  const int first = p.causal ? static_cast<int>(blockIdx.y) : 0;
  const int tiles = (seq + kBlock - 1) / kBlock - first;

  stage_tile<DP>(ks, p.k, b, h, k0, seq, dim);
  stage_tile<DP>(vs, p.v, b, h, k0, seq, dim);
  stage_tile<DP>(qs, p.q, b, h, first * kBlock, seq, dim);
  stage_tile<DP>(dos, p.dout, b, h, first * kBlock, seq, dim);
  stage_rows(rows, p, bh, first * kBlock, seq);
  commit_copies();

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int q0 = (first + j) * kBlock;
    const int stage = j % 2;
    if (j + 1 < tiles) {
      const int other = 1 - stage;
      stage_tile<DP>(qs + other * kTile, p.q, b, h, q0 + kBlock, seq, dim);
      stage_tile<DP>(dos + other * kTile, p.dout, b, h, q0 + kBlock, seq,
                     dim);
      stage_rows(rows + other * kRowBytes, p, bh, q0 + kBlock, seq);
    }
    commit_copies();
    wait_copies_but_newest();
    __syncthreads();
    const uint32_t qt = qs + stage * kTile;
    const uint32_t dot = dos + stage * kTile;
    const float* lse = rows_at + stage * 2 * kBlock;
    const float* delta = lse + kBlock;

    float pt[32];  // S^T, then P^T
#pragma unroll
    for (int i = 0; i < 32; ++i) pt[i] = 0.f;
    pin(pt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss(pt, k_major(ks, kk), k_major(qt, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin(pt);

    const bool masked = (p.causal && q0 < k0 + kBlock - 1) ||
                        q0 + kBlock > seq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * t4 + i % 2;  // query in the tile
      const int qi = q0 + col;
      const int kj = key0 + 8 * (i / 2 % 2);
      const float prob = exp2f(fmaf(pt[i], scale, -lse[col] * kLog2e));
      pt[i] = masked && (qi >= seq || (p.causal && kj > qi)) ? 0.f : prob;
    }
    uint32_t a[4][4];
    to_operand(pt, a);
    float dp[32];  // dP^T, then dS^T
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    pin(a);
    pin(dv);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(dv, a[kk], mn_major(dot, kk));
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss(dp, k_major(vs, kk), k_major(dot, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin(dv);
    pin(dp);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dp[i] = pt[i] * (dp[i] - delta[8 * (i / 4) + 2 * t4 + i % 2]);
    }
    to_operand(dp, a);
    pin(a);
    pin(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(dk, a[kk], mn_major(qt, kk));
    wgmma_commit();
    wgmma_wait();
    pin(dk);
    __syncthreads();  // every read of this stage is done before its refill
  }

  const float dk_scale[2] = {p.scale, p.scale};
  const float one[2] = {1.f, 1.f};
  store_tile<DP>(p.dk, b, h, key0, seq, dim, dk, dk_scale);
  store_tile<DP>(p.dv, b, h, key0, seq, dim, dv, one);
}

// K3 on the tensor cores. One warpgroup per (b*h, query tile), longest
// causal rows first (as K2). The Q and dO tiles stage once; per key tile,
//   S = Q K^T and dP = dO V^T by wgmma from shared memory, both K-major,
//   in one commit group;  P = exp2(S scale - lse);  dS = P (dP - delta)
//   in the accumulator registers;  dQ += dS K,
// dS rounded to bf16 in registers as the A operand and K read MN-major.
// Each thread keeps the lse and delta of its two rows in registers. The
// next key and value tiles load while this one is multiplied.
template <int DP>
__global__ void __launch_bounds__(kWarpgroup)
flash_dq_tc_kernel(const FlashParams p) {
  constexpr int kTile = kBlock * DP * 2;
  extern __shared__ uint8_t tc_smem[];
  const uint32_t qs = (smem_address(tc_smem) + 1023) & ~1023u;
  const uint32_t dos = qs + kTile;
  const uint32_t ks = dos + kTile;     // two stages
  const uint32_t vs = ks + 2 * kTile;  // two stages
  const int warp = threadIdx.x / 32;
  const int t4 = threadIdx.x % 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.heads;
  const int64_t h = bh - b * p.heads;
  const int seq = static_cast<int>(p.seq);
  const int dim = static_cast<int>(p.dim);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const int row0 = q0 + 16 * warp + threadIdx.x % 32 / 4;  // and row0 + 8
  const float scale = p.scale * kLog2e;  // scores in the log2 domain
  const int k_end = p.causal ? min(seq, q0 + kBlock) : seq;
  const int tiles = (k_end + kBlock - 1) / kBlock;

  stage_tile<DP>(qs, p.q, b, h, q0, seq, dim);
  stage_tile<DP>(dos, p.dout, b, h, q0, seq, dim);
  stage_tile<DP>(ks, p.k, b, h, 0, seq, dim);
  stage_tile<DP>(vs, p.v, b, h, 0, seq, dim);
  commit_copies();
  // Rows past T have zero Q and dO, so their dS is 0 whatever lse is.
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < seq ? p.lse[bh * seq + row] * kLog2e : 0.f;
    delta[r] = row < seq ? p.delta[bh * seq + row] : 0.f;
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * kBlock;
    const uint32_t stage = (j % 2) * kTile;
    if (j + 1 < tiles) {
      stage_tile<DP>(ks + kTile - stage, p.k, b, h, k0 + kBlock, seq, dim);
      stage_tile<DP>(vs + kTile - stage, p.v, b, h, k0 + kBlock, seq, dim);
    }
    commit_copies();
    wait_copies_but_newest();
    __syncthreads();

    float s[32], ds[32];  // S, and dP, then dS
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ds[i] = 0.f;
    pin(s);
    pin(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss(s, k_major(qs, kk), k_major(ks + stage, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss(ds, k_major(dos, kk), k_major(vs + stage, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin(s);
    pin(ds);

    // Only the diagonal tile and the ragged tail need a mask.
    const bool masked = (p.causal && k0 + kBlock - 1 > q0) ||
                        k0 + kBlock > seq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = i / 2 % 2;
      const int key = k0 + 8 * (i / 4) + 2 * t4 + i % 2;
      const float prob = exp2f(fmaf(s[i], scale, -lse[r]));
      const bool dropped =
          masked && (key >= seq || (p.causal && key > row0 + 8 * r));
      ds[i] = dropped ? 0.f : prob * (ds[i] - delta[r]);
    }
    uint32_t a[4][4];
    to_operand(ds, a);
    pin(a);
    pin(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(dq, a[kk], mn_major(ks + stage, kk));
    wgmma_commit();
    wgmma_wait();
    pin(dq);
    __syncthreads();  // every read of this stage is done before its refill
  }

  const float dq_scale[2] = {p.scale, p.scale};
  store_tile<DP>(p.dq, b, h, row0, seq, dim, dq, dq_scale);
}

// --- launching ---------------------------------------------------------------

enum Pass { kForward = 0, kDq = 1, kDkv = 2 };

// The tensor-core kernels read 16-byte pieces of each row.
bool tensor_core_layout(const Operand& x, const FlashParams& p) {
  return x.sd == 1 && reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0 &&
         (p.batch == 1 || x.sb % 8 == 0) && (p.seq == 1 || x.st % 8 == 0) &&
         (p.heads == 1 || x.sh % 8 == 0);
}

template <int DP>
cudaError_t run_tensor_cores(Pass pass, const FlashParams& p,
                             cudaStream_t stream) {
  constexpr size_t tile = kBlock * DP * sizeof(__nv_bfloat16);
  void (*kernel)(const FlashParams);
  size_t smem = 1024;  // to align the tiles to the swizzle's period
  switch (pass) {
    case kForward:  // Q + two stages of K and V
      kernel = flash_forward_tc_kernel<DP>;
      smem += 5 * tile;
      break;
    case kDq:  // Q, dO + two stages of K and V
      kernel = flash_dq_tc_kernel<DP>;
      smem += 6 * tile;
      break;
    default:  // K, V + two stages of Q, dO and the lse and delta rows
      kernel = flash_dkv_tc_kernel<DP>;
      smem += 6 * tile + 4 * kBlock * sizeof(float);
      break;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.batch * p.heads),
                  static_cast<unsigned>((p.seq + kBlock - 1) / kBlock));
  kernel<<<grid, kWarpgroup, smem, stream>>>(p);
  return cudaGetLastError();
}

int dispatch_tensor_cores(Pass pass, const FlashParams* p, int dtype,
                          void* stream) {
  if (dtype != 1 || p->dim < 8 || p->dim > 128 || p->dim % 8 != 0 ||
      p->seq < 1 || p->batch * p->heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The operands the pass reads and writes; the others may be empty.
  const bool backward = pass != kForward;
  const Operand* used[] = {&p->q, &p->k, &p->v,
                           backward ? &p->dout : &p->o,
                           pass == kDq ? &p->dq : backward ? &p->dk : &p->o,
                           pass == kDq ? &p->dq : backward ? &p->dv : &p->o};
  for (const Operand* x : used) {
    if (!tensor_core_layout(*x, *p)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p->dim <= 64 ? run_tensor_cores<64>(pass, *p, s)
                                       : run_tensor_cores<128>(pass, *p, s));
}

template <typename T, int DP>
cudaError_t run(Pass pass, const FlashParams& p, cudaStream_t stream) {
  const size_t tile = kBlock * (DP + 1) * sizeof(float);
  const size_t scores = kBlock * kPS * sizeof(float);
  void (*kernel)(const FlashParams);
  size_t smem;
  switch (pass) {
    case kForward:
      kernel = flash_forward_kernel<T, DP>;
      smem = 3 * tile + scores;
      break;
    case kDq:
      kernel = flash_dq_kernel<T, DP>;
      smem = 4 * tile + scores;
      break;
    default:
      kernel = flash_dkv_kernel<T, DP>;
      smem = 4 * tile + 2 * scores + 2 * kBlock * sizeof(float);
      break;
  }
  // Above 48 KB a block's shared memory must be asked for explicitly.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.batch * p.heads),
                  static_cast<unsigned>((p.seq + kBlock - 1) / kBlock));
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int dispatch(Pass pass, const FlashParams* p, int dtype, void* stream) {
  if (p->dim < 8 || p->dim > 128 || p->dim % 8 != 0 || p->seq < 1 ||
      p->batch * p->heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = p->dim <= 64;
  if (dtype == 0) {
    return static_cast<int>(narrow ? run<float, 64>(pass, *p, s)
                                   : run<float, 128>(pass, *p, s));
  }
  if (dtype == 1) {
    return static_cast<int>(narrow ? run<__nv_bfloat16, 64>(pass, *p, s)
                                   : run<__nv_bfloat16, 128>(pass, *p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs alike).
// The caller checks shapes (T < 2^31 and (T + 63) / 64 <= 65535 tiles,
// B*H < 2^31), allocates every output and the lse/delta rows, and passes
// PyTorch's current stream. Each returns cudaGetLastError() of its launch.
// The CUDA-core kernels take both dtypes and any element strides.
extern "C" int t2r_flash_forward(const FlashParams* p, int dtype,
                                 void* stream) {
  return dispatch(kForward, p, dtype, stream);
}

extern "C" int t2r_flash_dq(const FlashParams* p, int dtype, void* stream) {
  return dispatch(kDq, p, dtype, stream);
}

extern "C" int t2r_flash_dkv(const FlashParams* p, int dtype, void* stream) {
  return dispatch(kDkv, p, dtype, stream);
}

// The tensor-core kernels take bfloat16 only, with every operand in
// tensor_core_layout; anything else returns cudaErrorInvalidValue.
extern "C" int t2r_flash_forward_tc(const FlashParams* p, int dtype,
                                    void* stream) {
  return dispatch_tensor_cores(kForward, p, dtype, stream);
}

extern "C" int t2r_flash_dq_tc(const FlashParams* p, int dtype,
                               void* stream) {
  return dispatch_tensor_cores(kDq, p, dtype, stream);
}

extern "C" int t2r_flash_dkv_tc(const FlashParams* p, int dtype,
                                void* stream) {
  return dispatch_tensor_cores(kDkv, p, dtype, stream);
}
