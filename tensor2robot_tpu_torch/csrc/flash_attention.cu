// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of tensor2robot_tpu/ops/flash_attention.py:
//   flash_forward_kernel  <- _kernel      (K2: out and the per-row logsumexp)
//   flash_dq_kernel       <- _kernel_dq   (K3: dq)
//   flash_dkv_kernel      <- _kernel_dkv  (K4: dk and dv)
// q, k, v, out, dout, dq, dk and dv are (B, T, H, D) tensors addressed by
// element strides, so a (B, T, 1, D) view of a (B, T, D) activation needs
// no copy. lse and delta are contiguous (B*H, T) float32 rows. All sums
// are taken in float32; outputs are written in the input dtype.
//
// What bounds it on this card: operations. At the training path's shape,
// (8, 2048, 1, 64) bf16 causal, the forward does 4.3 GFLOP against 8.4 MB
// of traffic (about 500 operations a byte, above the H100's 295), and the
// backward passes more still. Only the tensor cores (989 TFLOP/s bf16)
// reach that bound.
//
// What the design does about it: nothing of size T x T touches device
// memory. Each block owns one 64-row tile of one (b, h) row and loops over
// the 64-row tiles of the other side, staged in shared memory, with the
// online softmax (forward) or the saved logsumexp (backward) rebuilding
// the probabilities tile by tile; causal loops stop at (or start from) the
// diagonal. Each of the 256 threads owns a 4 x 4 patch of a score tile and
// a 4 x (D/16) patch of the output tile, and multiplies with float32 FMAs
// on the CUDA cores: a simple kernel that is right first. Its ceiling is
// the 67 TFLOP/s float32 rate, about 15x below the bf16 tensor-core bound;
// wgmma fragments fed by TMA are the next step. K4 gives every key tile to
// one block, so dk and dv need no atomics and are deterministic. Rows and
// columns past T and head dims past D are zero-filled in shared memory and
// masked, so any T >= 1 and any D that is a multiple of 8 up to 128 runs
// (D pads to 64 or 128 in shared memory).

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

// K3. One block per (b*h, query tile): dq = sum over key tiles of
// (P * (dout v^T - delta)) k * scale, with P = exp(q k^T * scale - lse).
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

enum Pass { kForward = 0, kDq = 1, kDkv = 2 };

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
