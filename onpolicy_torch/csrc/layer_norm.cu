// LayerNorm over the last axis of an [N, D] float32 tensor: forward and
// backward, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes its LayerNorm as array
// ops (onpolicy_tpu/models/common.py: layer_norm_apply) and XLA fuses
// them. Written as separate PyTorch ops (models/common.py) the port's
// LayerNorm took about 10 kernels forward and 20 more in autograd's
// backward, most of them a full pass over the tensor. Here:
//   ln_fwd_rows / ln_fwd_loop  y = (x - mean) * rstd * scale + bias; mean
//                              and rstd ([N] f32) kept for the backward
//   ln_bwd_rows / ln_bwd_loop  dx = rstd * (g - mean(g) - xhat * mean(g *
//                              xhat)), g = dy * scale, xhat = (x - mean) *
//                              rstd; and each block's partial sums of
//                              dy * xhat (dscale) and dy (dbias)
//   ln_bwd_reduce              the partial sums of all blocks, in a fixed
//                              order
// rstd = 1 / sqrt(mean((x - mean)^2) + eps): the biased variance, taken
// after the mean from the row as it was read (not E[x^2] - mean^2), as the
// decomposed form takes it.
//
// What bounds them on an H100: bytes. The forward reads x and writes y (8
// bytes an element, 8 more a row); the backward reads x and dy and writes
// dx (12 bytes an element, 8 more a row). Both do a few flops an element.
//
// Design. The `_rows` kernels hold a row in registers, so it is read once
// from device memory: `L` lanes a row (8 or 16 for D <= 64, a warp for
// 64 < D <= 1024), each lane `C` loads of `V` floats (V = 4: 16-byte loads,
// where D % 4 == 0 and every pointer is 16-byte aligned), neighbouring
// lanes on neighbouring addresses; a row's sums are shuffles among its
// lanes. The `_loop` kernels take any D: one warp a row, walking it in
// chunks over device memory (three passes forward, two backward). The
// scale and bias gradients use no atomics: each block adds up its own
// rows in registers and then its row groups in shared memory into one [2,
// D] partial row, and ln_bwd_reduce sums the partial rows in a fixed
// order, so a card gives the same bits on every run. Which kernel runs,
// with which L, V, C and grid, is chosen in Python before launch
// (ops/cuda_layer_norm.py: plan, fwd_grid, bwd_grid).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // threads a block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStaticSmem = 48 * 1024;

// The sum over the L lanes of a row (L a power of two, L <= 32). Every lane
// of the warp takes part.
template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, L);
  return v;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[k];
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

// A block holds kThreads / L rows at a time and walks the rows in steps of
// gridDim.x * kThreads / L; every thread of the block runs every step, so
// the shuffles see all lanes. Lane `lane` of a row holds its units
// u = c * L + lane (c < C), each V floats at columns u * V ... u * V + V - 1.
template <int L, int V, int C>
__global__ void __launch_bounds__(kThreads)
ln_fwd_rows(const float* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, float* __restrict__ y,
            float* __restrict__ mean, float* __restrict__ rstd, int64_t N,
            int D, float eps) {
  constexpr int G = kThreads / L;
  const int lane = threadIdx.x % L;
  const int units = D / V;
  const float inv_d = 1.0f / D;
  for (int64_t base = (int64_t)blockIdx.x * G; base < N;
       base += (int64_t)gridDim.x * G) {
    const int64_t row = base + threadIdx.x / L;
    const bool ok = row < N;
    float v[C][V];
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int u = c * L + lane;
      if (ok && u < units) {
        load<V>(x + row * D + u * V, v[c]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[c][k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) s += v[c][k];
    }
    const float m = row_sum<L>(s) * inv_d;
    float q = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c * L + lane < units) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = v[c][k] - m;
          q += d * d;
        }
      }
    }
    const float r = rsqrtf(row_sum<L>(q) * inv_d + eps);
    if (ok) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int u = c * L + lane;
        if (u < units) {
          float sc[V], bi[V], o[V];
          load<V>(scale + u * V, sc);
          load<V>(bias + u * V, bi);
#pragma unroll
          for (int k = 0; k < V; ++k) o[k] = (v[c][k] - m) * r * sc[k] + bi[k];
          store<V>(y + row * D + u * V, o);
        }
      }
      if (lane == 0) {
        mean[row] = m;
        rstd[row] = r;
      }
    }
  }
}

// dx (skipped where dx is null: an input that needs no gradient) and the
// block's partial row partial[blockIdx.x] = [sum dy * xhat, sum dy] over
// its rows, each [D]. Dynamic shared memory: (kThreads / L) * D floats.
template <int L, int V, int C>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows(const float* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ dy, const float* __restrict__ mean,
            const float* __restrict__ rstd, float* __restrict__ dx,
            float* __restrict__ partial, int64_t N, int D) {
  extern __shared__ float red[];   // [G][D]
  constexpr int G = kThreads / L;
  const int lane = threadIdx.x % L;
  const int group = threadIdx.x / L;
  const int units = D / V;
  const float inv_d = 1.0f / D;
  float ds[C][V], db[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < V; ++k) ds[c][k] = db[c][k] = 0.0f;

  for (int64_t base = (int64_t)blockIdx.x * G; base < N;
       base += (int64_t)gridDim.x * G) {
    const int64_t row = base + group;
    const bool ok = row < N;
    const float m = ok ? mean[row] : 0.0f;
    const float r = ok ? rstd[row] : 0.0f;
    float xh[C][V], g[C][V];   // xhat; dy, then g = dy * scale
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int u = c * L + lane;
      if (ok && u < units) {
        load<V>(x + row * D + u * V, xh[c]);
        load<V>(dy + row * D + u * V, g[c]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) xh[c][k] = g[c][k] = 0.0f;
      }
      float sc[V];
      if (u < units) {
        load<V>(scale + u * V, sc);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) sc[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xh[c][k] = (xh[c][k] - m) * r;
        ds[c][k] += g[c][k] * xh[c][k];
        db[c][k] += g[c][k];
        g[c][k] *= sc[k];
        sg += g[c][k];
        sgx += g[c][k] * xh[c][k];
      }
    }
    if (dx != nullptr) {
      const float mg = row_sum<L>(sg) * inv_d;
      const float mgx = row_sum<L>(sgx) * inv_d;
      if (ok) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int u = c * L + lane;
          if (u < units) {
            float o[V];
#pragma unroll
            for (int k = 0; k < V; ++k)
              o[k] = r * (g[c][k] - mg - xh[c][k] * mgx);
            store<V>(dx + row * D + u * V, o);
          }
        }
      }
    }
  }

  // the block's row groups, summed in group order
  float* out = partial + (int64_t)blockIdx.x * 2 * D;
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int u = c * L + lane;
      if (u < units) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          red[group * D + u * V + k] = which == 0 ? ds[c][k] : db[c][k];
      }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < D; col += kThreads) {
      float s = 0.0f;
      for (int i = 0; i < G; ++i) s += red[i * D + col];
      out[which * D + col] = s;
    }
    __syncthreads();
  }
}

// Any D: one warp a row, three passes over the row (mean, variance, y).
__global__ void __launch_bounds__(kThreads)
ln_fwd_loop(const float* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, float* __restrict__ y,
            float* __restrict__ mean, float* __restrict__ rstd, int64_t N,
            int D, float eps) {
  const int lane = threadIdx.x % 32;
  const float inv_d = 1.0f / D;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
       row < N; row += (int64_t)gridDim.x * kWarps) {
    const float* xr = x + row * D;
    float s = 0.0f;
    for (int i = lane; i < D; i += 32) s += xr[i];
    const float m = row_sum<32>(s) * inv_d;
    float q = 0.0f;
    for (int i = lane; i < D; i += 32) {
      const float d = xr[i] - m;
      q += d * d;
    }
    const float r = rsqrtf(row_sum<32>(q) * inv_d + eps);
    for (int i = lane; i < D; i += 32)
      y[row * D + i] = (xr[i] - m) * r * scale[i] + bias[i];
    if (lane == 0) {
      mean[row] = m;
      rstd[row] = r;
    }
  }
}

// Any D: one warp a row, two passes (the row's sums, then dx). Warp w of
// block b adds its rows into its own partial row partial[b * kWarps + w];
// lane l owns columns l, l + 32, ..., so no two threads touch one address.
__global__ void __launch_bounds__(kThreads)
ln_bwd_loop(const float* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ dy, const float* __restrict__ mean,
            const float* __restrict__ rstd, float* __restrict__ dx,
            float* __restrict__ partial, int64_t N, int D) {
  const int lane = threadIdx.x % 32;
  const float inv_d = 1.0f / D;
  float* out =
      partial + ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) * 2 * D;
  for (int i = lane; i < D; i += 32) out[i] = out[D + i] = 0.0f;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
       row < N; row += (int64_t)gridDim.x * kWarps) {
    const float* xr = x + row * D;
    const float* dyr = dy + row * D;
    const float m = mean[row], r = rstd[row];
    float mg = 0.0f, mgx = 0.0f;
    if (dx != nullptr) {
      float sg = 0.0f, sgx = 0.0f;
      for (int i = lane; i < D; i += 32) {
        const float g = dyr[i] * scale[i];
        sg += g;
        sgx += g * ((xr[i] - m) * r);
      }
      mg = row_sum<32>(sg) * inv_d;
      mgx = row_sum<32>(sgx) * inv_d;
    }
    for (int i = lane; i < D; i += 32) {
      const float xh = (xr[i] - m) * r;
      out[i] += dyr[i] * xh;
      out[D + i] += dyr[i];
      if (dx != nullptr) dx[row * D + i] = r * (dyr[i] * scale[i] - mg - xh * mgx);
    }
  }
}

// dscale[col] and dbias[col] from the P partial rows [P][2][D]: one warp a
// column, lane l adding rows l, l + 32, ... in order, then a fixed tree.
__global__ void __launch_bounds__(kThreads)
ln_bwd_reduce(const float* __restrict__ partial, int P, int D,
              float* __restrict__ dscale, float* __restrict__ dbias) {
  const int64_t w = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= 2 * (int64_t)D) return;   // the whole warp
  const int which = (int)(w / D), col = (int)(w % D);
  float s = 0.0f;
  for (int p = lane; p < P; p += 32)
    s += partial[((int64_t)p * 2 + which) * D + col];
  s = row_sum<32>(s);
  if (lane == 0) (which == 0 ? dscale : dbias)[col] = s;
}

// The (L, V, C) of the `_rows` kernels, as ops/cuda_layer_norm.py's
// ROW_PLANS lists them: L = 8 (D <= 64, at most 32 units), 16 (D <= 64,
// more units), 32 (64 < D <= 1024); C the power of two that covers the row.
#define LN_ROW_PLANS(X)                                                    \
  X(8, 1, 1) X(8, 1, 2) X(8, 1, 4) X(8, 4, 1) X(8, 4, 2) X(16, 1, 4)       \
  X(32, 1, 4) X(32, 1, 8) X(32, 1, 16) X(32, 1, 32)                        \
  X(32, 4, 1) X(32, 4, 2) X(32, 4, 4) X(32, 4, 8)

enum { kRows = 0, kLoop = 1 };

bool row_plan_fits(int lanes, int vec, int chunks, int D) {
  return D % vec == 0 && D <= lanes * vec * chunks &&
         (size_t)(kThreads / lanes) * D * sizeof(float) <= kMaxStaticSmem;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok);
// 1 (cudaErrorInvalidValue) for a shape or plan the kernels do not take.
// `variant` is kRows (with lanes, vec and chunks one of LN_ROW_PLANS) or
// kLoop (lanes, vec and chunks unread). Every pointer is to f32; with
// vec = 4, x, scale, bias, y, dy and dx start on 16-byte boundaries.

// y [N, D], mean [N], rstd [N] from x [N, D], scale [D], bias [D], on
// `grid` blocks.
int ln_fwd(const float* x, const float* scale, const float* bias, float* y,
           float* mean, float* rstd, long long N, int D, float eps,
           int variant, int lanes, int vec, int chunks, int grid,
           void* stream) {
  if (N <= 0 || D <= 0 || grid <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == kLoop) {
    ln_fwd_loop<<<grid, kThreads, 0, s>>>(x, scale, bias, y, mean, rstd, N,
                                          D, eps);
    return cudaGetLastError();
  }
  if (variant != kRows || !row_plan_fits(lanes, vec, chunks, D))
    return cudaErrorInvalidValue;
#define X(L, V, C)                                                        \
  if (lanes == L && vec == V && chunks == C) {                            \
    ln_fwd_rows<L, V, C><<<grid, kThreads, 0, s>>>(x, scale, bias, y,     \
                                                   mean, rstd, N, D, eps); \
    return cudaGetLastError();                                            \
  }
  LN_ROW_PLANS(X)
#undef X
  return cudaErrorInvalidValue;
}

// dx [N, D] (none where dx is null), dscale [D] and dbias [D] from x, scale,
// dy and the forward's mean and rstd, on `grid` blocks, then their
// reduction. `partial` holds P * 2 * D floats of scratch, P = grid (kRows)
// or grid * 8 (kLoop: a partial row a warp).
int ln_bwd(const float* x, const float* scale, const float* dy,
           const float* mean, const float* rstd, float* dx, float* partial,
           float* dscale, float* dbias, long long N, int D, int variant,
           int lanes, int vec, int chunks, int grid, void* stream) {
  if (N <= 0 || D <= 0 || grid <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int P = grid;
  if (variant == kLoop) {
    ln_bwd_loop<<<grid, kThreads, 0, s>>>(x, scale, dy, mean, rstd, dx,
                                          partial, N, D);
    P = grid * kWarps;
  } else {
    if (variant != kRows || !row_plan_fits(lanes, vec, chunks, D))
      return cudaErrorInvalidValue;
    const size_t smem = (size_t)(kThreads / lanes) * D * sizeof(float);
    bool launched = false;
#define X(L, V, C)                                                        \
  if (!launched && lanes == L && vec == V && chunks == C) {               \
    ln_bwd_rows<L, V, C><<<grid, kThreads, smem, s>>>(                    \
        x, scale, dy, mean, rstd, dx, partial, N, D);                     \
    launched = true;                                                      \
  }
    LN_ROW_PLANS(X)
#undef X
    if (!launched) return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (int)((2 * (int64_t)D + kWarps - 1) / kWarps);
  ln_bwd_reduce<<<blocks, kThreads, 0, s>>>(partial, P, D, dscale, dbias);
  return cudaGetLastError();
}

// Blocks of the backward `variant` that one SM holds at once at width D
// (its registers and shared memory), for the grid; 0 for a plan it does
// not take.
int ln_bwd_blocks_per_sm(int variant, int lanes, int vec, int chunks, int D) {
  int n = 0;
  if (variant == kLoop) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ln_bwd_loop,
                                                      kThreads, 0))
      return 0;
    return n;
  }
  if (variant != kRows || D <= 0 || !row_plan_fits(lanes, vec, chunks, D))
    return 0;
  const size_t smem = (size_t)(kThreads / lanes) * D * sizeof(float);
#define X(L, V, C)                                                        \
  if (lanes == L && vec == V && chunks == C) {                            \
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
            &n, ln_bwd_rows<L, V, C>, kThreads, smem))                    \
      return 0;                                                           \
    return n;                                                             \
  }
  LN_ROW_PLANS(X)
#undef X
  return 0;
}

}  // extern "C"
