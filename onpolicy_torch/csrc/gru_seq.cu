// Mask-gated GRU layer over a [T, B, H] sequence: forward and
// rematerializing backward, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of onpolicy_tpu/ops/pallas_gru.py:
//   gru_fwd_kernel  <- _fwd_call / _fwd_kernel   (pallas_gru.py:103-153)
//   gru_bwd_kernel  <- _bwd_call / _bwd_kernel   (pallas_gru.py:160-251)
//   gru_bwd_reduce  <- the grid-wide dW_hh / db_hh accumulation of
//                      _bwd_kernel (pallas_gru.py:169-179, 204-213)
//
// Per step t, for each row b of the batch (gate order r, z, n):
//   hm = h * m_t
//   r  = sigmoid(gir_t + (hm @ Wr + br))
//   z  = sigmoid(giz_t + (hm @ Wz + bz))
//   n  = tanh(gin_t + r * (hm @ Wn + bn))
//   h  = (1 - z) * n + z * hm
// The input projections gi = x @ W_ih + b_ih are computed outside, as in
// the JAX package. W_hh is passed as the packed [H, 3H] matrix of the
// parameter tree (column c = gate * H + unit).
//
// What bounds these kernels on an H100: the work is three [B,H]x[H,H]
// products per step (6*B*H^2 flops forward, three times that backward)
// against 4 (forward) or 8 (backward) [T,B,H] f32 streams. At H=64 the
// flops term (67 TFLOP/s f32) and the bytes term (3.35 TB/s) are of the
// same size, so the kernels are bound by operations on the CUDA cores
// (no tensor cores: everything stays f32 to match the reference).
//
// Design, kept simple and right first:
//   * One block per tile of `bt` batch rows; the block loops over T
//     itself. Blocks carry nothing between each other, which takes the
//     place of the TPU's sequential grid axis. The ragged last tile is
//     masked in-kernel: rows >= B read zeros and write nothing.
//   * h, h*m and (backward) the carried dh and the three gate cotangents
//     of the tile stay in shared memory for the whole sequence, so the
//     recurrence never round-trips device memory.
//   * W_hh sits in shared memory with an odd row stride (3H | 1) when it
//     fits, which makes both the row-wise reads of the gate products and
//     the column-wise reads of the transposed product in the backward
//     free of bank conflicts. When it does not fit beside the tile in
//     the 227 KB a block may use (the backward, which also keeps its dW
//     accumulator there, above H = 72 with 64-row tiles and H = 92 with
//     8-row tiles; the forward above H = 116 and H = 136) the same kernel
//     reads it from global memory, where it stays in L2.
//   * A work item is one hidden unit for kRows rows of the tile: the
//     weight value is loaded once and used for kRows rows.
//   * Backward: each block accumulates its own partial dW_hh / db_hh over
//     its rows and all of T (in shared memory when it fits, else in its
//     own slice of the global scratch). A second small kernel sums the
//     partials in a fixed order: the result is deterministic, with no
//     float atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows of the tile covered by one work item

__device__ __forceinline__ float sigmoid_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <bool kSmemW>
__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const float* __restrict__ gir, const float* __restrict__ giz,
               const float* __restrict__ gin,
               const float* __restrict__ masks,  // [T, B]
               const float* __restrict__ h0,     // [B, H]
               const float* __restrict__ w_hh,   // [H, 3H]
               const float* __restrict__ b_hh,   // [3H]
               float* __restrict__ outs,         // [T, B, H]
               float* __restrict__ hT,           // [B, H]
               int T, int B, int H, int bt) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  const int ws = kSmemW ? (H3 | 1) : H3;  // row stride of W
  float* p = smem;
  float* sW = p;
  if (kSmemW) p += H * ws;
  float* sHm = p;  p += bt * H;  // h * m_t of the tile
  float* sH = p;   p += bt * H;  // h of the tile
  float* sM = p;                 // m_t of the tile
  const float* W = kSmemW ? sW : w_hh;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * bt;
  const int groups = bt / kRows;

  if (kSmemW) {
    for (int e = tid; e < H * H3; e += blockDim.x) {
      const int k = e / H3;
      sW[k * ws + (e - k * H3)] = w_hh[e];
    }
  }
  for (int e = tid; e < bt * H; e += blockDim.x) {
    const int r = e / H;
    const int row = row0 + r;
    sH[e] = row < B ? h0[(size_t)row * H + (e - r * H)] : 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    const size_t tb = (size_t)t * B;
    for (int r = tid; r < bt; r += blockDim.x) {
      const int row = row0 + r;
      sM[r] = row < B ? masks[tb + row] : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < bt * H; e += blockDim.x) sHm[e] = sH[e] * sM[e / H];
    __syncthreads();
    for (int w = tid; w < groups * H; w += blockDim.x) {
      const int g = w / H;
      const int j = w - g * H;
      const float* hm = sHm + g * kRows * H;
      float ar[kRows], az[kRows], an[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) ar[rr] = az[rr] = an[rr] = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float* wk = W + k * ws + j;
        const float wr = wk[0], wz = wk[H], wn = wk[2 * H];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const float h = hm[rr * H + k];
          ar[rr] = fmaf(h, wr, ar[rr]);
          az[rr] = fmaf(h, wz, az[rr]);
          an[rr] = fmaf(h, wn, an[rr]);
        }
      }
      const float br = b_hh[j], bz = b_hh[H + j], bn = b_hh[2 * H + j];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = g * kRows + rr;
        const int row = row0 + r;
        if (row >= B) continue;
        const size_t o = (tb + row) * H + j;
        const float rg = sigmoid_(gir[o] + (ar[rr] + br));
        const float zg = sigmoid_(giz[o] + (az[rr] + bz));
        const float ng = tanhf(gin[o] + rg * (an[rr] + bn));
        const float h = (1.0f - zg) * ng + zg * hm[rr * H + j];
        sH[r * H + j] = h;
        outs[o] = h;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < bt * H; e += blockDim.x) {
    const int r = e / H;
    const int row = row0 + r;
    if (row < B) hT[(size_t)row * H + (e - r * H)] = sH[e];
  }
}

// ---------------------------------------------------------------------------
// backward: reverse time, gates recomputed from gi and hprev = [h0, outs[:-1]]
// ---------------------------------------------------------------------------
template <bool kSmemW>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const float* __restrict__ gir, const float* __restrict__ giz,
               const float* __restrict__ gin,
               const float* __restrict__ outs,   // [T, B, H]
               const float* __restrict__ masks,  // [T, B]
               const float* __restrict__ h0,     // [B, H]
               const float* __restrict__ douts,  // [T, B, H]
               const float* __restrict__ dhT,    // [B, H]
               const float* __restrict__ w_hh,   // [H, 3H]
               const float* __restrict__ b_hh,   // [3H]
               float* __restrict__ dgir, float* __restrict__ dgiz,
               float* __restrict__ dgin,
               float* __restrict__ dh0,          // [B, H]
               float* __restrict__ partial,      // [gridDim.x, (H+1)*3H]
               int T, int B, int H, int bt) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  const int nacc = (H + 1) * H3;  // dW rows 0..H-1, db in row H
  const int ws = kSmemW ? (H3 | 1) : H3;
  float* p = smem;
  float* sW = p;
  float* sAcc = p;
  if (kSmemW) { sAcc = p + H * ws; p += H * ws + nacc; }
  float* sHm = p;  p += bt * H;      // hprev * m_t
  float* sD = p;   p += bt * H;      // carried dh, then dh * z, then d_hm * m
  float* sG = p;   p += 3 * bt * H;  // [3][bt][H]: dr, dz, dghn
  float* sM = p;                     // [2][bt], double-buffered over t
  const float* W = kSmemW ? sW : w_hh;
  float* acc = kSmemW ? sAcc : partial + (size_t)blockIdx.x * nacc;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * bt;
  const int groups = bt / kRows;
  const int tile = bt * H;

  if (kSmemW) {
    for (int e = tid; e < H * H3; e += blockDim.x) {
      const int k = e / H3;
      sW[k * ws + (e - k * H3)] = w_hh[e];
    }
  }
  for (int e = tid; e < nacc; e += blockDim.x) acc[e] = 0.0f;
  for (int e = tid; e < tile; e += blockDim.x) {
    const int r = e / H;
    const int row = row0 + r;
    sD[e] = row < B ? dhT[(size_t)row * H + (e - r * H)] : 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B;
    float* m = sM + (t & 1) * bt;
    for (int r = tid; r < bt; r += blockDim.x) {
      const int row = row0 + r;
      m[r] = row < B ? masks[tb + row] : 0.0f;
    }
    __syncthreads();
    // hm = hprev * m_t
    const float* hp = t > 0 ? outs + (tb - B) * H : h0;
    for (int e = tid; e < tile; e += blockDim.x) {
      const int r = e / H;
      const int row = row0 + r;
      sHm[e] = row < B ? hp[(size_t)row * H + (e - r * H)] * m[r] : 0.0f;
    }
    __syncthreads();
    // gate cotangents for (row, unit j)
    for (int w = tid; w < groups * H; w += blockDim.x) {
      const int g = w / H;
      const int j = w - g * H;
      const float* hm = sHm + g * kRows * H;
      float ar[kRows], az[kRows], an[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) ar[rr] = az[rr] = an[rr] = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float* wk = W + k * ws + j;
        const float wr = wk[0], wz = wk[H], wn = wk[2 * H];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const float h = hm[rr * H + k];
          ar[rr] = fmaf(h, wr, ar[rr]);
          az[rr] = fmaf(h, wz, az[rr]);
          an[rr] = fmaf(h, wn, an[rr]);
        }
      }
      const float br = b_hh[j], bz = b_hh[H + j], bn = b_hh[2 * H + j];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = g * kRows + rr;
        const int row = row0 + r;
        const int s = r * H + j;
        if (row >= B) {
          sG[s] = 0.0f;
          sG[tile + s] = 0.0f;
          sG[2 * tile + s] = 0.0f;
          sD[s] = 0.0f;
          continue;
        }
        const size_t o = (tb + row) * H + j;
        const float ghn = an[rr] + bn;
        const float rg = sigmoid_(gir[o] + (ar[rr] + br));
        const float zg = sigmoid_(giz[o] + (az[rr] + bz));
        const float ng = tanhf(gin[o] + rg * ghn);
        const float dh = sD[s] + douts[o];
        const float dz = dh * (hm[rr * H + j] - ng) * zg * (1.0f - zg);
        const float dn = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float dr = dn * ghn * rg * (1.0f - rg);
        const float dghn = dn * rg;
        dgir[o] = dr;
        dgiz[o] = dz;
        dgin[o] = dn;
        sG[s] = dr;
        sG[tile + s] = dz;
        sG[2 * tile + s] = dghn;
        sD[s] = dh * zg;
      }
    }
    __syncthreads();
    // d_hm = dh*z + dr @ Wr^T + dz @ Wz^T + dghn @ Wn^T ; carry d_hm * m_t
    for (int w = tid; w < groups * H; w += blockDim.x) {
      const int g = w / H;
      const int k = w - g * H;
      float d[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) d[rr] = sD[(g * kRows + rr) * H + k];
      for (int gate = 0; gate < 3; ++gate) {
        const float* wk = W + k * ws + gate * H;
        const float* G = sG + gate * tile + g * kRows * H;
        for (int j = 0; j < H; ++j) {
          const float wv = wk[j];
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) d[rr] = fmaf(G[rr * H + j], wv, d[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = g * kRows + rr;
        sD[r * H + k] = d[rr] * m[r];
      }
    }
    // this tile's share of dW_hh[k, c] += sum_r hm[r,k] * dgate_c[r], db
    for (int e = tid; e < nacc; e += blockDim.x) {
      const int k = e / H3;
      const int c = e - k * H3;
      const int gate = c / H;
      const float* G = sG + gate * tile + (c - gate * H);
      float s = 0.0f;
      if (k < H) {
        for (int r = 0; r < bt; ++r) s = fmaf(sHm[r * H + k], G[r * H], s);
      } else {
        for (int r = 0; r < bt; ++r) s += G[r * H];
      }
      acc[e] += s;
    }
  }
  __syncthreads();
  for (int e = tid; e < tile; e += blockDim.x) {
    const int r = e / H;
    const int row = row0 + r;
    if (row < B) dh0[(size_t)row * H + (e - r * H)] = sD[e];
  }
  if (kSmemW) {
    float* out = partial + (size_t)blockIdx.x * nacc;
    for (int e = tid; e < nacc; e += blockDim.x) out[e] = acc[e];
  }
}

// Sums the per-block partials in block order: dW_hh [H, 3H] and db_hh [3H].
__global__ void __launch_bounds__(kThreads)
gru_bwd_reduce(const float* __restrict__ partial, int nblocks, int H,
               float* __restrict__ dw, float* __restrict__ db) {
  const int H3 = 3 * H;
  const int nacc = (H + 1) * H3;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nacc;
       e += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * nacc + e];
    if (e < H * H3) dw[e] = s;
    else db[e - H * H3] = s;
  }
}

int max_dynamic_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

bool bad_shape(int T, int B, int H, int bt) {
  return T <= 0 || B <= 0 || H <= 0 || bt <= 0 || bt % kRows != 0;
}

template <bool kSmemW>
cudaError_t launch_fwd(const float* gir, const float* giz, const float* gin,
                       const float* masks, const float* h0, const float* w_hh,
                       const float* b_hh, float* outs, float* hT, int T,
                       int B, int H, int bt, size_t bytes,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<kSmemW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int grid = (B + bt - 1) / bt;
  gru_fwd_kernel<kSmemW><<<grid, kThreads, bytes, stream>>>(
      gir, giz, gin, masks, h0, w_hh, b_hh, outs, hT, T, B, H, bt);
  return cudaGetLastError();
}

template <bool kSmemW>
cudaError_t launch_bwd(const float* gir, const float* giz, const float* gin,
                       const float* outs, const float* masks, const float* h0,
                       const float* douts, const float* dhT,
                       const float* w_hh, const float* b_hh, float* dgir,
                       float* dgiz, float* dgin, float* dh0, float* partial,
                       int T, int B, int H, int bt, size_t bytes,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<kSmemW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int grid = (B + bt - 1) / bt;
  gru_bwd_kernel<kSmemW><<<grid, kThreads, bytes, stream>>>(
      gir, giz, gin, outs, masks, h0, douts, dhT, w_hh, b_hh, dgir, dgiz,
      dgin, dh0, partial, T, B, H, bt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok);
// 1 (cudaErrorInvalidValue) for a shape the kernels do not take.
int gru_seq_fwd(const float* gir, const float* giz, const float* gin,
                const float* masks, const float* h0, const float* w_hh,
                const float* b_hh, float* outs, float* hT, int T, int B,
                int H, int bt, void* stream) {
  if (bad_shape(T, B, H, bt)) return cudaErrorInvalidValue;
  const size_t tile_bytes = (size_t)(2 * bt * H + bt) * sizeof(float);
  const size_t w_bytes = (size_t)H * ((3 * H) | 1) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (w_bytes + tile_bytes <= (size_t)max_dynamic_smem())
    return launch_fwd<true>(gir, giz, gin, masks, h0, w_hh, b_hh, outs, hT,
                            T, B, H, bt, tile_bytes + w_bytes, s);
  return launch_fwd<false>(gir, giz, gin, masks, h0, w_hh, b_hh, outs, hT,
                           T, B, H, bt, tile_bytes, s);
}

// `partial` holds ceil(B / bt) * (H + 1) * 3H floats of scratch.
int gru_seq_bwd(const float* gir, const float* giz, const float* gin,
                const float* outs, const float* masks, const float* h0,
                const float* douts, const float* dhT, const float* w_hh,
                const float* b_hh, float* dgir, float* dgiz, float* dgin,
                float* dh0, float* dw_hh, float* db_hh, float* partial,
                int T, int B, int H, int bt, void* stream) {
  if (bad_shape(T, B, H, bt)) return cudaErrorInvalidValue;
  const size_t tile_bytes = (size_t)(5 * bt * H + 2 * bt) * sizeof(float);
  const size_t w_bytes =
      ((size_t)H * ((3 * H) | 1) + (size_t)(H + 1) * 3 * H) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (w_bytes + tile_bytes <= (size_t)max_dynamic_smem())
    err = launch_bwd<true>(gir, giz, gin, outs, masks, h0, douts, dhT, w_hh,
                           b_hh, dgir, dgiz, dgin, dh0, partial, T, B, H, bt,
                           tile_bytes + w_bytes, s);
  else
    err = launch_bwd<false>(gir, giz, gin, outs, masks, h0, douts, dhT, w_hh,
                            b_hh, dgir, dgiz, dgin, dh0, partial, T, B, H, bt,
                            tile_bytes, s);
  if (err != cudaSuccess) return err;
  const int nacc = (H + 1) * 3 * H;
  const int rgrid = (nacc + kThreads - 1) / kThreads;
  gru_bwd_reduce<<<rgrid, kThreads, 0, s>>>(partial, (B + bt - 1) / bt, H,
                                            dw_hh, db_hh);
  return cudaGetLastError();
}

}  // extern "C"
