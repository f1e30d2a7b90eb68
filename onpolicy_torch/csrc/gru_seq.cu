// Mask-gated GRU layer over a [T, B, H] sequence: forward and
// rematerializing backward, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of onpolicy_tpu/ops/pallas_gru.py:
//   gru_fwd_kernel_mma  <- _fwd_call / _fwd_kernel   (pallas_gru.py:103-153)
//                          for H % 16 == 0 and H <= 64, on the tensor cores
//   gru_fwd_wide_step   <- the same, for 64 < H <= 512 and H % 32 == 0, on
//                          the tensor cores: one GEMM a time step, launched
//                          T times, with the gate math in its epilogue
//   gru_fwd_kernel      <- the same, for every other H, on the CUDA cores
//   gru_bwd_kernel_mma  <- _bwd_call / _bwd_kernel   (pallas_gru.py:160-251)
//                          for H % 16 == 0 and H <= 64, on the tensor cores
//   gru_bwd_gates_gemm, <- the same, for 64 < H <= 512 and H % 32 == 0, on
//   gru_bwd_carry,         the tensor cores: the gate product and dW as
//   gru_bwd_dw_gemm        GEMMs over all T * B rows, around a kernel that
//                          runs only the recurrent carry
//   gru_bwd_kernel      <- the same, for every other H, on the CUDA cores
//   gru_bwd_reduce      <- the grid-wide dW_hh / db_hh accumulation of
//                          _bwd_kernel (pallas_gru.py:169-179, 204-213)
// Which kernel runs is chosen by shape before launch, in Python
// (ops/cuda_gru.py:fwd_plan, bwd_plan); the C entries launch what they
// are told.
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
// same size, so the CUDA-core kernels are bound by operations. The
// tensor-core kernels keep f32 accuracy with 3xTF32 products and are bound
// by bytes.
//
// Stream type. Every kernel takes its [T, B, H] sequence streams (gi,
// outs, and in the backward douts and dgi) as `S`, float or __nv_bfloat16:
// the JAX package's bf16 mode (pallas_gru.py:310-320) moves only these in
// bf16. h, h0, hT, dh0, dhT, W_hh, b_hh, the masks, dW/db and all gate math
// stay f32; a bf16 stream is widened with __bfloat162float as it is read
// and rounded to nearest even with __float2bfloat16_rn as it is written, as
// XLA's astype does. The backward's hprev at t = 0 is h0 in the stream type
// (pallas_gru.py:279-280): the caller passes it rounded, so its `h0` is an
// S stream. bf16 halves the stream bytes; the products stay 3xTF32 (JAX's
// are f32 products of f32 h and W), so at T=10, B=122,880, H=64 the
// forward stays bound by bytes and the backward becomes bound by its
// products.
//
// Design of the CUDA-core forward and backward (gru_fwd_kernel,
// gru_bwd_kernel), kept simple and right first:
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows of the tile covered by one work item

__device__ __forceinline__ float sigmoid_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A stream element widened to f32, and an f32 value stored as one.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename S>
__device__ __forceinline__ S from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive stream elements as f32 (16-byte aligned for float,
// 8-byte aligned for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(p)[0];
  const __nv_bfloat162 b = reinterpret_cast<const __nv_bfloat162*>(p)[1];
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <bool kSmemW, typename S>
__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const S* __restrict__ gir, const S* __restrict__ giz,
               const S* __restrict__ gin,
               const float* __restrict__ masks,  // [T, B]
               const float* __restrict__ h0,     // [B, H]
               const float* __restrict__ w_hh,   // [H, 3H]
               const float* __restrict__ b_hh,   // [3H]
               S* __restrict__ outs,             // [T, B, H]
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
        const float rg = sigmoid_(to_f32(gir[o]) + (ar[rr] + br));
        const float zg = sigmoid_(to_f32(giz[o]) + (az[rr] + bz));
        const float ng = tanhf(to_f32(gin[o]) + rg * (an[rr] + bn));
        const float h = (1.0f - zg) * ng + zg * hm[rr * H + j];
        sH[r * H + j] = h;
        outs[o] = from_f32<S>(h);
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
template <bool kSmemW, typename S>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const S* __restrict__ gir, const S* __restrict__ giz,
               const S* __restrict__ gin,
               const S* __restrict__ outs,       // [T, B, H]
               const float* __restrict__ masks,  // [T, B]
               const S* __restrict__ h0,         // [B, H], hprev at t = 0
               const S* __restrict__ douts,      // [T, B, H]
               const float* __restrict__ dhT,    // [B, H]
               const float* __restrict__ w_hh,   // [H, 3H]
               const float* __restrict__ b_hh,   // [3H]
               S* __restrict__ dgir, S* __restrict__ dgiz,
               S* __restrict__ dgin,
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
    const S* hp = t > 0 ? outs + (tb - B) * H : h0;
    for (int e = tid; e < tile; e += blockDim.x) {
      const int r = e / H;
      const int row = row0 + r;
      sHm[e] = row < B ? to_f32(hp[(size_t)row * H + (e - r * H)]) * m[r] : 0.0f;
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
        const float rg = sigmoid_(to_f32(gir[o]) + (ar[rr] + br));
        const float zg = sigmoid_(to_f32(giz[o]) + (az[rr] + bz));
        const float ng = tanhf(to_f32(gin[o]) + rg * ghn);
        const float dh = sD[s] + to_f32(douts[o]);
        const float dz = dh * (hm[rr * H + j] - ng) * zg * (1.0f - zg);
        const float dn = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float dr = dn * ghn * rg * (1.0f - rg);
        const float dghn = dn * rg;
        dgir[o] = from_f32<S>(dr);
        dgiz[o] = from_f32<S>(dz);
        dgin[o] = from_f32<S>(dn);
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

// ---------------------------------------------------------------------------
// backward on the tensor cores: gru_bwd_kernel_mma<H, BT>, H in {16,32,48,64}
// ---------------------------------------------------------------------------
// The same function as gru_bwd_kernel. By its count that kernel is bound by
// shared-memory load issue (about 1.3 loads per FMA, half of them in the
// read-modify-write of its dW accumulator) with one 8-warp block per SM at
// large B. Here the
// three products of a step run as mma.sync m16n8k8 TF32 on the tensor
// cores, written transposed so that the tile's BT batch rows are the MMA's
// N (8) or K (BT):
//   gates    gh^T [3H x BT]  = W_hh^T [3H x H] . hm^T [H x BT]
//   carry    d_hm^T [H x BT] = W_hh [H x 3H]   . dG^T [3H x BT]
//   weights  dW [H x 3H]    += hm^T [H x BT]   . dG [BT x 3H]
// with dG = [dr, dz, dn * r]. The least time on an H100 is then set by the
// bytes of its eight [T, B, H] streams, not by the products; what keeps it
// above that is instruction issue and latency around the mma.sync (fragment
// loads, hi/lo splits) at 16 warps an SM, as diagnostics/ablate_gru_bwd.py
// shows part by part. The gate math is that of gru_fwd_kernel (sigmoid_,
// tanhf), so the backward differentiates the gates the forward produced.
//  * f32 accuracy by 3xTF32: each operand x splits into a TF32 hi and the
//    rest lo = x - hi as its fragment is loaded (see split), and a * b is
//    taken as a_lo * b_hi + a_hi * b_lo + a_hi * b_hi in the f32
//    accumulator.
//  * dW stays in the MMA accumulators for the block's whole run (3H^2/256
//    registers a thread: 48 at H = 64, which is why H <= 64), db in one
//    register of each of the first 3H threads. A warp holds whole columns
//    of dW tiles, so it loads each dG fragment once a step. The block
//    writes its partial once; gru_bwd_reduce sums the partials in block
//    order.
//  * A block walks the batch tiles blockIdx.x, + gridDim.x, ... with the
//    grid fixed by (B, H, SM count), so every call gives the same bits.
//    A warp owns one (16 units, 8 rows) item of the gate and carry
//    products; the thread that holds a (unit, row) pair's accumulators
//    also does its gate math and keeps its carried dh in registers.
//  * cp.async brings the next step's gir, giz, gin, douts, hprev tiles and
//    masks (at a tile's last step, the next tile's first) into the other
//    of two shared-memory stages while this step computes.
//  * The shared matrices have row strides of 8 or 24 (mod 32) words and
//    their column index XORed with (row & 4): every fragment load of the
//    three products, whether it walks W, hm or dG by rows or by columns,
//    is free of bank conflicts.
// Shared memory: W [H][3H+8], hm [BT][H+8] and dG [BT][3H+8] in f32; 2
// stages of 5 x [BT][SS] stream elements and BT f32 masks, SS = H + one
// 16-byte chunk (H + 4 floats, H + 8 bf16). At H = 64 that is 112,256
// bytes for BT = 16 (two 256-thread blocks on an SM, 128 registers a
// thread) and 81,728 for BT = 8 (one block on an SM, up to 255 registers)
// with f32 streams; 91,776 and 71,488 with bf16 streams.
//  * Staged bf16 rows: a row of SS = H + 8 elements is 2H + 16 bytes, a
//    whole number of 16-byte cp.async chunks. The gate math reads element
//    (n0 + 2q + p % 2, u0 + g + 8 (p / 2)) of a stage: the eight g of one
//    row lie in four consecutive words (g, g + 1 share one), and row 2q
//    starts q (H + 8) words on, that is 8q (mod 32) at H = 32, 64 and
//    24q = 0, 24, 16, 8 (mod 32) at H = 16, 48: 16 distinct banks, no
//    conflict. With f32 streams the stride H + 4 words puts row 2q at
//    8q (mod 32) words, followed by the eight words of its g.
// Rows >= B of the ragged tile are copied in as zeros; their dh, and so
// their dG, is zero, and they add nothing to dW through K = BT.

template <int N>
struct Split {  // an MMA fragment as hi + lo TF32 parts
  uint32_t hi[N], lo[N];
};

// hi = x with its 13 low mantissa bits cleared, lo = x - hi (exact in
// f32). lo is passed whole: the tensor cores read the top 19 bits of a
// TF32 operand, so it enters truncated to 11 significant bits and x is
// kept to about 2^-21 of itself. One LOP and one FADD an element, where
// cvt.rna.tf32.f32 goes through the slower conversion pipe.
template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.hi[i] = __float_as_uint(x[i]) & 0xffffe000u;
    s.lo[i] = __float_as_uint(x[i] - __uint_as_float(s.hi[i]));
  }
  return s;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b to about f32 accuracy (3xTF32; the lo * lo term is dropped)
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// d += a . b as mma3 computes it, but summed from zero on the tensor cores
// and added to d with an ordinary f32 add. The tensor cores truncate as
// they add into their accumulator, so a chain of thousands of k-steps in
// one accumulator drifts toward zero. On an H100, with the GEMMs' chains
// left in the accumulator, dW over 1,606-row ranges missed the f32 sum by
// 6.7e-5 in an entry below 0.25 (T=10, B=803, H=512), and over 2048-row
// ranges at T=10, B=20,000 read 1.5e-5 of its largest entry, against
// 2.5e-6 here; the gate GEMM's chains (K = H) quadrupled GH's error, and
// the carry's (K = 3H) took dW and db 3-7 times as far from an f64 sum as
// the plain f32 version (diagnostics/ablate_gru_wide_gemm.py). Here each
// chain is one k-step (three products) long.
__device__ __forceinline__ void mma3_add(float (&d)[4], const Split<4>& a,
                                         const Split<2>& b) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma3(s, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

// Fragment maps of m16n8k8 (g = lane / 4, q = lane % 4):
//   A [16 x 8]: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B [8 x 8]:  b0 (q, g), b1 (q + 4, g)
//   C [16 x 8]: c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)

// Word offset of (r, c) in a swizzled shared matrix with row stride `ld`.
__device__ __forceinline__ int swz(int r, int c, int ld) {
  return r * ld + (c ^ (r & 4));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Waits until at most N of this thread's latest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int H, int BT, typename S>
struct MmaLayout {  // shared memory of gru_bwd_kernel_mma; offsets in bytes
  static constexpr int H3 = 3 * H;
  static constexpr int WS = H3 + 8;  // W [H][3H] f32 words, swizzled
  static constexpr int EPC = 16 / sizeof(S);  // stream elements a chunk
  static constexpr int SS = H + EPC; // a staged [BT][H] stream, elements
  static constexpr int HS = H + 8;   // hm [BT][H] f32 words, swizzled
  static constexpr int GS = H3 + 8;  // dG [BT][3H] f32 words, swizzled
  static constexpr int STREAM = BT * SS;  // elements
  static constexpr int STREAM_BYTES = STREAM * sizeof(S);
  // gir giz gin douts hprev, then the masks
  static constexpr int STAGE_BYTES = 5 * STREAM_BYTES + 4 * BT;
  static constexpr int STAGE_OFF = 4 * H * WS;
  static constexpr int HM_OFF = STAGE_OFF + 2 * STAGE_BYTES;
  static constexpr int G_OFF = HM_OFF + 4 * BT * HS;
  static constexpr int BYTES = G_OFF + 4 * BT * GS;
  static constexpr int ITEMS = (H / 16) * (BT / 8);  // of the gate/carry products
  // dW [H x 3H] as MT x NT tiles of 16 x 8: a warp keeps NW column tiles
  // (all MT row tiles of each), so it loads a fragment of hm or dG once
  static constexpr int MT = H / 16;
  static constexpr int NT = H3 / 8;
  static constexpr int NW = (NT + kThreads / 32 - 1) / (kThreads / 32);
  // blocks per SM: two at 16-row tiles; one at 8-row tiles, which are
  // taken when B is too small to fill the card, and then 255 registers
  // shorten the serial chain of each step
  static constexpr int MIN_BLOCKS = BT == 16 ? 2 : 1;
  static_assert(H % 16 == 0 && BT % 8 == 0, "tile shapes of m16n8k8");
  static_assert(ITEMS <= kThreads / 32, "one gate/carry item per warp");
  static_assert(H3 <= kThreads, "one db entry per thread");
  static_assert(STREAM_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0,
                "16-byte cp.async targets");
};

// Starts the copies of step t of the tile at row0 into `stage`.
template <int H, int BT, typename S>
__device__ __forceinline__ void stage_step(
    char* stage, const S* gir, const S* giz, const S* gin, const S* douts,
    const S* outs, const S* h0, const float* masks, int t, int row0, int B) {
  using L = MmaLayout<H, BT, S>;
  constexpr int CH = H / L::EPC;  // 16-byte chunks in a row
  const size_t tb = (size_t)t * B;
  const S* hprev = t > 0 ? outs + (tb - B) * H : h0;
  for (int e = threadIdx.x; e < 5 * BT * CH; e += kThreads) {
    const int i = e / (BT * CH);  // gir, giz, gin, douts, hprev
    const int r = (e - i * BT * CH) / CH;
    const int c = (e % CH) * L::EPC;
    const int row = row0 + r;
    const bool ok = row < B;
    const S* src = i == 4 ? hprev
                 : (i == 0 ? gir : i == 1 ? giz : i == 2 ? gin : douts) + tb * H;
    cp_async16(reinterpret_cast<S*>(stage + i * L::STREAM_BYTES) + r * L::SS + c,
               src + (size_t)(ok ? row : 0) * H + c, ok);
  }
  float* m = reinterpret_cast<float*>(stage + 5 * L::STREAM_BYTES);
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const int row = row0 + r;
    cp_async4(m + r, masks + tb + (row < B ? row : 0), row < B);
  }
}

template <int H, int BT, typename S>
__global__ void __launch_bounds__(kThreads, MmaLayout<H, BT, S>::MIN_BLOCKS)
gru_bwd_kernel_mma(const S* __restrict__ gir, const S* __restrict__ giz,
                   const S* __restrict__ gin,
                   const S* __restrict__ outs,       // [T, B, H]
                   const float* __restrict__ masks,  // [T, B]
                   const S* __restrict__ h0,         // [B, H], hprev at t = 0
                   const S* __restrict__ douts,      // [T, B, H]
                   const float* __restrict__ dhT,    // [B, H]
                   const float* __restrict__ w_hh,   // [H, 3H]
                   const float* __restrict__ b_hh,   // [3H]
                   S* __restrict__ dgir, S* __restrict__ dgiz,
                   S* __restrict__ dgin,
                   float* __restrict__ dh0,          // [B, H]
                   float* __restrict__ partial,      // [gridDim.x, (H+1)*3H]
                   int T, int B) {
  using L = MmaLayout<H, BT, S>;
  constexpr int H3 = L::H3, WS = L::WS, SS = L::SS, HS = L::HS, GS = L::GS;
  // k-steps of the gate and carry products in flight: more spills at 128
  // registers (BT = 16); all of them at 8-row tiles
  constexpr int kUnroll = BT == 16 ? 2 : H / 8;
  extern __shared__ __align__(16) float mma_smem[];
  char* const base = reinterpret_cast<char*>(mma_smem);
  float* sW = mma_smem;
  char* sStage = base + L::STAGE_OFF;
  float* sHm = reinterpret_cast<float*>(base + L::HM_OFF);
  float* sG = reinterpret_cast<float*>(base + L::G_OFF);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int ntiles = (B + BT - 1) / BT;

  for (int e = tid; e < H * H3 / 4; e += kThreads) {
    const int r = e / (H3 / 4);
    const int c = (e - r * (H3 / 4)) * 4;
    cp_async16(sW + swz(r, c, WS), w_hh + (size_t)r * H3 + c, true);
  }
  int tile = blockIdx.x;
  stage_step<H, BT, S>(sStage, gir, giz, gin, douts, outs, h0, masks, T - 1,
                       tile * BT, B);
  cp_async_commit();

  // this warp's item of the gate/carry products: units u0.., rows n0..;
  // accumulator element p holds unit u0 + g + 8 (p / 2), row n0 + 2q + p % 2
  const bool has_item = warp < L::ITEMS;
  const int u0 = (warp / (BT / 8)) * 16;
  const int n0 = (warp % (BT / 8)) * 8;
  float bias[3][2];
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      bias[gate][hh] = has_item ? b_hh[gate * H + u0 + g + 8 * hh] : 0.0f;

  // dW tiles (mt, warp * NW + j) of this warp, for those that exist
  float acc_w[L::MT][L::NW][4] = {};
  float acc_b = 0.0f;  // db[tid], tid < 3H
  float carry[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int s = 0;

  for (; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * BT;
    if (has_item) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int row = row0 + n0 + 2 * q + (p & 1);
        carry[p] = row < B ? dhT[(size_t)row * H + u0 + g + 8 * (p >> 1)] : 0.0f;
      }
    }
    for (int t = T - 1; t >= 0; --t) {
      cp_async_wait_all();
      __syncthreads();  // stage s has landed; the last step's reads are done
      {
        int nt = t - 1, ntile = tile;
        if (nt < 0) { nt = T - 1; ntile += gridDim.x; }
        if (ntile < ntiles)
          stage_step<H, BT, S>(sStage + (s ^ 1) * L::STAGE_BYTES, gir, giz,
                               gin, douts, outs, h0, masks, nt, ntile * BT, B);
        cp_async_commit();
      }
      const char* stb = sStage + s * L::STAGE_BYTES;
      const S* st = reinterpret_cast<const S*>(stb);
      const float* sM = reinterpret_cast<const float*>(stb + 5 * L::STREAM_BYTES);

      // hm = hprev * m_t
      for (int e = tid; e < BT * H / 4; e += kThreads) {
        const int r = e / (H / 4);
        const int c = (e - r * (H / 4)) * 4;
        float4 v = load4(st + 4 * L::STREAM + r * SS + c);
        const float m = sM[r];
        v.x *= m; v.y *= m; v.z *= m; v.w *= m;
        *reinterpret_cast<float4*>(sHm + swz(r, c, HS)) = v;
      }
      __syncthreads();

      // gates: gh^T = W^T . hm^T, then the cotangents of this item's pairs
      float dhz[4];
      if (has_item) {
        float gh[3][4] = {};
#pragma unroll(kUnroll)
        for (int k0 = 0; k0 < H; k0 += 8) {
          const float bf[2] = {sHm[swz(n0 + g, k0 + q, HS)],
                               sHm[swz(n0 + g, k0 + q + 4, HS)]};
          const Split<2> b = split(bf);
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) {
            const int m0 = gate * H + u0;
            const float af[4] = {sW[swz(k0 + q, m0 + g, WS)],
                                 sW[swz(k0 + q, m0 + g + 8, WS)],
                                 sW[swz(k0 + q + 4, m0 + g, WS)],
                                 sW[swz(k0 + q + 4, m0 + g + 8, WS)]};
            mma3(gh[gate], split(af), b);
          }
        }
        const size_t tb = (size_t)t * B;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int hh = p >> 1;
          const int j = u0 + g + 8 * hh;
          const int n = n0 + 2 * q + (p & 1);
          const int o = n * SS + j;
          const float ghn = gh[2][p] + bias[2][hh];
          const float rg = sigmoid_(to_f32(st[o]) + (gh[0][p] + bias[0][hh]));
          const float zg = sigmoid_(to_f32(st[L::STREAM + o])
                                    + (gh[1][p] + bias[1][hh]));
          const float ng = tanhf(to_f32(st[2 * L::STREAM + o]) + rg * ghn);
          const float dh = carry[p] + to_f32(st[3 * L::STREAM + o]);
          const float dz = dh * (sHm[swz(n, j, HS)] - ng) * zg * (1.0f - zg);
          const float dn = dh * (1.0f - zg) * (1.0f - ng * ng);
          const float dr = dn * ghn * rg * (1.0f - rg);
          const int row = row0 + n;
          if (row < B) {
            const size_t go = (tb + row) * H + j;
            dgir[go] = from_f32<S>(dr);
            dgiz[go] = from_f32<S>(dz);
            dgin[go] = from_f32<S>(dn);
          }
          sG[swz(n, j, GS)] = dr;
          sG[swz(n, H + j, GS)] = dz;
          sG[swz(n, 2 * H + j, GS)] = dn * rg;
          dhz[p] = dh * zg;
        }
      }
      __syncthreads();

      // carry: d_hm^T = W . dG^T;  dh <- (dh * z + d_hm) * m_t
      if (has_item) {
        float d[3][4] = {};  // one chain per gate's block of K
#pragma unroll(kUnroll)
        for (int k0 = 0; k0 < H; k0 += 8) {
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) {
            const int k = gate * H + k0;
            const float af[4] = {sW[swz(u0 + g, k + q, WS)],
                                 sW[swz(u0 + g + 8, k + q, WS)],
                                 sW[swz(u0 + g, k + q + 4, WS)],
                                 sW[swz(u0 + g + 8, k + q + 4, WS)]};
            const float bf[2] = {sG[swz(n0 + g, k + q, GS)],
                                 sG[swz(n0 + g, k + q + 4, GS)]};
            mma3(d[gate], split(af), split(bf));
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
          carry[p] = (dhz[p] + (d[0][p] + d[1][p] + d[2][p]))
                   * sM[n0 + 2 * q + (p & 1)];
      }

      // weights: dW += hm^T . dG over the tile's rows; db += column sums
      if (warp * L::NW < L::NT) {
#pragma unroll
        for (int k0 = 0; k0 < BT; k0 += 8) {
          Split<2> b[L::NW];
#pragma unroll
          for (int j = 0; j < L::NW; ++j) {
            const int c0 = min(warp * L::NW + j, L::NT - 1) * 8;
            const float bf[2] = {sG[swz(k0 + q, c0 + g, GS)],
                                 sG[swz(k0 + q + 4, c0 + g, GS)]};
            b[j] = split(bf);
          }
#pragma unroll
          for (int mt = 0; mt < L::MT; ++mt) {
            const int m0 = mt * 16;
            const float af[4] = {sHm[swz(k0 + q, m0 + g, HS)],
                                 sHm[swz(k0 + q, m0 + g + 8, HS)],
                                 sHm[swz(k0 + q + 4, m0 + g, HS)],
                                 sHm[swz(k0 + q + 4, m0 + g + 8, HS)]};
            const Split<4> a = split(af);
#pragma unroll
            for (int j = 0; j < L::NW; ++j)
              if (warp * L::NW + j < L::NT) mma3(acc_w[mt][j], a, b[j]);
          }
        }
      }
      if (tid < H3) {
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < BT; ++n) sum += sG[swz(n, tid, GS)];
        acc_b += sum;
      }
      s ^= 1;
    }
    if (has_item) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int row = row0 + n0 + 2 * q + (p & 1);
        if (row < B) dh0[(size_t)row * H + u0 + g + 8 * (p >> 1)] = carry[p];
      }
    }
  }

  float* out = partial + (size_t)blockIdx.x * (H + 1) * H3;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int j = 0; j < L::NW; ++j) {
      if (warp * L::NW + j >= L::NT) continue;
      const int r = mt * 16 + g;
      const int c = (warp * L::NW + j) * 8 + 2 * q;
      out[r * H3 + c] = acc_w[mt][j][0];
      out[r * H3 + c + 1] = acc_w[mt][j][1];
      out[(r + 8) * H3 + c] = acc_w[mt][j][2];
      out[(r + 8) * H3 + c + 1] = acc_w[mt][j][3];
    }
  if (tid < H3) out[H * H3 + tid] = acc_b;
}

// ---------------------------------------------------------------------------
// forward on the tensor cores: gru_fwd_kernel_mma<H, BT>, H in {16,32,48,64}
// ---------------------------------------------------------------------------
// The same function as gru_fwd_kernel, which runs the step's three products
// as scalar FMAs with three shared-memory loads of W per k. Here they run
// as the backward's gate product (3xTF32 mma.sync m16n8k8, see split and
// mma_tf32), written transposed so that the tile's BT batch rows are the
// MMA's N:
//   gh^T [3H x BT] = W_hh^T [3H x H] . hm^T [H x BT],   hm = h * m_t
// Its least time on an H100 is set by the bytes of its four [T, B, H]
// streams (three in, one out); the products, at three TF32 terms each, take
// less than half of that at the dense TF32 rate. What keeps it above the
// bound is instruction issue around the mma.sync (fragment loads, hi/lo
// splits) and the gate math, as diagnostics/ablate_gru_fwd.py shows. At
// small B the ten steps are a serial chain, and what counts is each step's
// latency.
//  * A warp owns one item of 16 units and 8 rows: for each gate one 16 x 8
//    accumulator tile. The thread that holds a (unit, row) pair's r, z and
//    n accumulators also does its gate math and keeps its h in a register
//    across the T steps; blocks have one warp per item (128 threads at
//    H = 64 with 8-row tiles, 256 with 16-row tiles).
//  * Each gate's product runs two accumulator chains, one for hi * hi and
//    one for the two small terms, so a chain is KT or 2 KT mma deep.
//  * W^T sits in shared memory in fragment order: lane l's a0..a3 of
//    fragment (m-tile, k-tile) are four consecutive words, one 16-byte load
//    a lane, split into hi/lo as it is loaded. It is copied in once per
//    block: a block walks the batch tiles blockIdx.x, + gridDim.x, ...
//  * h of the tile goes to shared memory after each step as the next
//    step's B operand, double-buffered so that a step needs one barrier;
//    the B fragment is multiplied by the step's mask as it is loaded. It
//    stays f32 whatever the stream type, and its row stride H + 4 makes
//    both the B-fragment loads and the stores from the accumulator layout
//    free of bank conflicts.
//  * cp.async brings the gir, giz, gin tiles and masks of the next step
//    (across tile boundaries) into a ring of STAGES shared-memory stages
//    while this step computes. Two stages are as fast as three or four
//    (diagnostics/ablate_gru_fwd.py), so the ring keeps one step ahead.
//  * outs is written from the accumulator layout: a warp's store covers
//    four rows of 32 bytes (f32), whole sectors, or of 16 bytes (bf16).
// Shared memory: W^T 3H * H and h 2 x [BT][H+4] in f32; STAGES = 2 stages
// of 3 x [BT][SS] stream elements and BT f32 masks, SS = H + one 16-byte
// chunk (H + 4 floats, H + 8 bf16; the bank argument is the backward's).
// At H = 64 that is 84,096 bytes for
// BT = 16 and 66,624 for BT = 8; two blocks fit an SM. With bf16 streams
// it is 71,808 and 60,480.
// Rows >= B of the ragged tile are copied in as zeros and never written.

template <int H, int BT, typename S>
struct FwdLayout {  // shared memory of gru_fwd_kernel_mma; offsets in bytes
  static constexpr int H3 = 3 * H;
  static constexpr int KT = H / 8;   // k-steps of the gate product
  static constexpr int EPC = 16 / sizeof(S);  // stream elements a chunk
  static constexpr int SS = H + EPC; // row stride of a staged [BT][H] stream
  static constexpr int HSS = H + 4;  // row stride of the f32 h tile, words
  static constexpr int STREAM = BT * SS;    // elements
  static constexpr int STREAM_BYTES = STREAM * sizeof(S);
  static constexpr int STAGE_BYTES = 3 * STREAM_BYTES + 4 * BT;  // gir giz gin m
  static constexpr int STAGES = 2;
  static constexpr int STAGE_OFF = 4 * H3 * H;   // after W^T
  static constexpr int H_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int HTILE = BT * HSS;   // words of one h buffer
  static constexpr int BYTES = H_OFF + 4 * 2 * HTILE;
  static constexpr int THREADS = 32 * (H / 16) * (BT / 8);  // a warp an item
  static constexpr int MIN_BLOCKS = 2;
  static_assert(H % 16 == 0 && BT % 8 == 0, "tile shapes of m16n8k8");
  static_assert(3 * H % BT == 0, "W's copy: 3H / BT float4 a thread");
  static_assert(STREAM_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0,
                "16-byte cp.async targets");
};

// Starts the copies of step t of the tile at row0 into `stage`.
template <int H, int BT, typename S>
__device__ __forceinline__ void stage_fwd(char* stage, const S* gir,
                                          const S* giz, const S* gin,
                                          const float* masks, int t, int row0,
                                          int B) {
  using L = FwdLayout<H, BT, S>;
  constexpr int CH = H / L::EPC;  // 16-byte chunks in a row
  const size_t tb = (size_t)t * B;
  for (int e = threadIdx.x; e < 3 * BT * CH; e += L::THREADS) {
    const int i = e / (BT * CH);  // gir, giz, gin
    const int r = (e - i * BT * CH) / CH;
    const int c = (e % CH) * L::EPC;
    const int row = row0 + r;
    const bool ok = row < B;
    const S* src = i == 0 ? gir : i == 1 ? giz : gin;
    cp_async16(reinterpret_cast<S*>(stage + i * L::STREAM_BYTES) + r * L::SS + c,
               src + (tb + (ok ? row : 0)) * H + c, ok);
  }
  float* m = reinterpret_cast<float*>(stage + 3 * L::STREAM_BYTES);
  for (int r = threadIdx.x; r < BT; r += L::THREADS) {
    const int row = row0 + r;
    cp_async4(m + r, masks + tb + (row < B ? row : 0), row < B);
  }
}

template <int H, int BT, typename S>
__global__ void __launch_bounds__(FwdLayout<H, BT, S>::THREADS,
                                  FwdLayout<H, BT, S>::MIN_BLOCKS)
gru_fwd_kernel_mma(const S* __restrict__ gir, const S* __restrict__ giz,
                   const S* __restrict__ gin,
                   const float* __restrict__ masks,  // [T, B]
                   const float* __restrict__ h0,     // [B, H]
                   const float* __restrict__ w_hh,   // [H, 3H]
                   const float* __restrict__ b_hh,   // [3H]
                   S* __restrict__ outs,             // [T, B, H]
                   float* __restrict__ hT,           // [B, H]
                   int T, int B) {
  using L = FwdLayout<H, BT, S>;
  constexpr int H3 = L::H3, KT = L::KT, SS = L::SS, HSS = L::HSS, MT = H / 16;
  extern __shared__ __align__(16) float fwd_smem[];
  char* const base = reinterpret_cast<char*>(fwd_smem);
  float* sW = fwd_smem;
  char* sStage = base + L::STAGE_OFF;
  float* sH = reinterpret_cast<float*>(base + L::H_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ntiles = (B + BT - 1) / BT;

  // the copies run STAGES - 1 steps ahead of the compute, through the
  // block's tiles: step pt of tile ptile goes to stage ps
  int pt = 0, ptile = blockIdx.x, ps = 0;
  auto issue = [&]() {
    if (ptile < ntiles)
      stage_fwd<H, BT, S>(sStage + ps * L::STAGE_BYTES, gir, giz, gin, masks,
                          pt, ptile * BT, B);
    cp_async_commit();  // one group a step, empty past the last tile
    if (++pt == T) { pt = 0; ptile += gridDim.x; }
    ps = ps + 1 == L::STAGES ? 0 : ps + 1;
  };
#pragma unroll
  for (int i = 0; i < L::STAGES - 1; ++i) issue();

  // W^T as A fragments: a_i of lane l of fragment f = (m-tile, k-tile) is
  // word (f * 32 + l) * 4 + i. W is read in rows, four columns at a time,
  // with all of a thread's loads in flight together.
#pragma unroll
  for (int i = 0; i < 3 * H / BT; ++i) {
    const int e = tid + i * L::THREADS;
    const int k = e / (H3 / 4), m = (e - k * (H3 / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(w_hh + (size_t)k * H3 + m);
    const int f = (m / 16) * KT + k / 8, kk = k & 7;
    float* dst = sW + f * 128 + (kk & 3) * 4 + 2 * (kk >> 2) + ((m >> 3) & 1);
    dst[(m & 7) * 16] = v.x;
    dst[((m + 1) & 7) * 16] = v.y;
    dst[((m + 2) & 7) * 16] = v.z;
    dst[((m + 3) & 7) * 16] = v.w;
  }

  // this warp's item: units u0.., rows n0..; accumulator element p holds
  // unit u0 + g + 8 (p / 2), row n0 + 2q + p % 2
  const int u0 = (warp / (BT / 8)) * 16;
  const int n0 = (warp % (BT / 8)) * 8;
  float bias[3][2];
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      bias[gate][hh] = b_hh[gate * H + u0 + g + 8 * hh];
  // this lane's word of the warp's fragment (gate, k-tile) is wf[(gate * MT
  // * KT + kt) * 32]
  const float4* wf =
      reinterpret_cast<const float4*>(sW) + (u0 / 16) * KT * 32 + lane;

  float h[4];
  int s = 0, hb = 0;  // the stage and the h buffer of this step
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * BT;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int n = n0 + 2 * q + (p & 1), j = u0 + g + 8 * (p >> 1);
      h[p] = row0 + n < B ? h0[(size_t)(row0 + n) * H + j] : 0.0f;
      sH[hb * L::HTILE + n * HSS + j] = h[p];
    }
    for (int t = 0; t < T; ++t) {
      cp_async_wait<L::STAGES - 2>();
      __syncthreads();  // stage s and h have landed; last step's reads done
      issue();          // into the stage that the last step read
      const char* stb = sStage + s * L::STAGE_BYTES;
      const S* stg = reinterpret_cast<const S*>(stb);
      const float* sM = reinterpret_cast<const float*>(stb + 3 * L::STREAM_BYTES);

      // gates: gh^T = W^T . hm^T
      float big[3][4] = {}, small[3][4] = {};
      const float* hr = sH + hb * L::HTILE + (n0 + g) * HSS + q;
      const float mb = sM[n0 + g];  // the mask of this lane's B column
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const float bf[2] = {hr[kt * 8] * mb, hr[kt * 8 + 4] * mb};
        const Split<2> b = split(bf);
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const float4 w = wf[(gate * MT * KT + kt) * 32];
          const float af[4] = {w.x, w.y, w.z, w.w};
          const Split<4> a = split(af);
          mma_tf32(small[gate], a.lo, b.hi);
          mma_tf32(small[gate], a.hi, b.lo);
          mma_tf32(big[gate], a.hi, b.hi);
        }
      }

      // gate math of this thread's pairs; h to registers, shared, outs
      float* hn = sH + (hb ^ 1) * L::HTILE;
      const size_t tb = (size_t)t * B;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int hh = p >> 1;
        const int n = n0 + 2 * q + (p & 1), j = u0 + g + 8 * hh;
        const int o = n * SS + j;
        const float hm = h[p] * sM[n];
        const float rg = sigmoid_(to_f32(stg[o])
                                  + ((big[0][p] + small[0][p]) + bias[0][hh]));
        const float zg = sigmoid_(to_f32(stg[L::STREAM + o])
                                  + ((big[1][p] + small[1][p]) + bias[1][hh]));
        const float ghn = (big[2][p] + small[2][p]) + bias[2][hh];
        const float ng = tanhf(to_f32(stg[2 * L::STREAM + o]) + rg * ghn);
        h[p] = (1.0f - zg) * ng + zg * hm;
        hn[n * HSS + j] = h[p];
        if (row0 + n < B) outs[(tb + row0 + n) * H + j] = from_f32<S>(h[p]);
      }
      s = s + 1 == L::STAGES ? 0 : s + 1;
      hb ^= 1;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int row = row0 + n0 + 2 * q + (p & 1);
      if (row < B) hT[(size_t)row * H + u0 + g + 8 * (p >> 1)] = h[p];
    }
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// forward at 64 < H <= 512, H % 32 == 0, on the tensor cores: one GEMM a
// time step, the gate math in its epilogue
// ---------------------------------------------------------------------------
// The same function as gru_fwd_kernel, which at H = 512 runs the gate
// product on the CUDA cores at 16-row tiles, every block walking all of
// W_hh (3.15 MB, no SM's shared memory holds it) from L2 every step. The
// recurrence runs along T only: within a step the B rows are independent,
// so a step is one GEMM
//   GH_t [B x 3H] = HM_t [B x H] . W_hh [H x 3H],  HM_t = h_{t-1} * m_t,
// and its gate math needs GH_t, gi_t and hm_t of the same row and unit
// only. gru_fwd_wide_step runs that GEMM for one step in 3xTF32 mma.sync
// (each k-step's products added in plain f32, mma3_add) and the gate math
// in its epilogue; the C entry launches it T times on the caller's
// stream, so each launch reads the h the one before wrote. No block
// carries anything across steps and none sums with another, so every call
// gives the same bits.
//  * A block covers BM rows and U units of all three gates: the columns
//    [u0, u0 + U), H + [u0, u0 + U) and 2H + [u0, u0 + U) of W. Each
//    thread's accumulators hold r, z and n of the same (row, unit).
//  * h is carried in f32 through two [B, H] scratch buffers: step t reads
//    the one step t - 1 wrote (h0 at t = 0) and writes the other (hT at
//    the last step). It is never read back from outs, which holds h in the
//    stream type (pallas_gru.py:113-118 carries h in f32).
//  * The mask is applied as A's fragments load (h * m_t, as the plain
//    version forms hm); rows past B are copied in as zeros and not written.
// What bounds it on an H100: the product, 6 * B * H^2 flops a step in
// three TF32 passes (1.91 ms over T=10 at B=20,000, H=512 at 495 TFLOP/s),
// against the streams' bytes (0.75 ms). Each block reads its A rows and
// its columns of W from L2: A H / U times over (16 at H = 512), W once for
// every BM rows.
// Tiles: BM x (3 x U) outputs, BK deep, 8 warps as 2 (M) x 4 (units) warp
// tiles of 64 rows x 8 units of each gate, a ring of STAGES cp.async
// stages: A [BM][BK + 4] f32 (lane (g, q) of a fragment load on bank
// 4g + q), B [BK][3U + 8] f32 (bank 8q + g + a warp's unit offset). 95,232
// bytes: two blocks an SM.
struct WideFwd {
  static constexpr int BM = 128, U = 32, BN = 3 * U, BK = 32;
  static constexpr int THREADS = 256, STAGES = 3, MIN_BLOCKS = 2;
  static constexpr int WM = 64, WU = 8;  // a warp's rows and units
  static constexpr int MT = WM / 16;
  static constexpr int AS = BK + 4;      // A row stride, f32 words
  static constexpr int BS = BN + 8;      // B row stride, f32 words
  static constexpr int A_BYTES = BM * AS * 4;
  static constexpr int B_BYTES = BK * BS * 4;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BYTES = STAGES * STAGE_BYTES;
  static_assert(WU == 8 && (BM / WM) * (U / WU) * 32 == THREADS, "warp tiles");
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0, "16-byte cp.async targets");
};

// Two consecutive stream elements as f32, and two f32 values stored as two.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One step: gir, giz, gin, masks and outs point at step t's rows.
template <typename S>
__global__ void __launch_bounds__(WideFwd::THREADS, WideFwd::MIN_BLOCKS)
gru_fwd_wide_step(const S* __restrict__ gir, const S* __restrict__ giz,
                  const S* __restrict__ gin,        // [B, H]
                  const float* __restrict__ masks,  // [B]
                  const float* __restrict__ hprev,  // [B, H] f32, h_{t-1}
                  const float* __restrict__ w_hh,   // [H, 3H]
                  const float* __restrict__ b_hh,   // [3H]
                  S* __restrict__ outs,             // [B, H]
                  float* __restrict__ hnext,        // [B, H] f32, h_t
                  int B, int H) {
  using F = WideFwd;
  extern __shared__ __align__(16) float wide_fwd_smem[];
  char* const base = reinterpret_cast<char*>(wide_fwd_smem);
  const int H3 = 3 * H, ntn = H / F::U;
  const int u0 = (blockIdx.x % ntn) * F::U;
  const int m0 = (blockIdx.x / ntn) * F::BM;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int wm = (warp >> 2) * F::WM, wu = (warp & 3) * F::WU;
  const int nk = H / F::BK;

  auto load = [&](int kt, int st) {
    char* stage = base + st * F::STAGE_BYTES;
    float* sA = reinterpret_cast<float*>(stage);
    float* sB = reinterpret_cast<float*>(stage + F::A_BYTES);
    const int k0 = kt * F::BK;
    constexpr int ACH = F::BK / 4;  // chunks of an A row
    for (int e = tid; e < F::BM * ACH; e += F::THREADS) {
      const int r = e / ACH, c = (e % ACH) * 4, i = m0 + r;
      const bool ok = i < B;
      cp_async16(sA + r * F::AS + c, hprev + (size_t)(ok ? i : 0) * H + k0 + c, ok);
    }
    constexpr int BCH = F::BN / 4;  // chunks of a B row, U / 4 a gate
    for (int e = tid; e < F::BK * BCH; e += F::THREADS) {
      const int r = e / BCH, c = (e % BCH) * 4, gate = c / F::U;
      cp_async16(sB + r * F::BS + c,
                 w_hh + (size_t)(k0 + r) * H3 + gate * H + u0 + (c - gate * F::U),
                 true);
    }
  };

  // the masks of this lane's rows (wm + 16 mt + g + 8 h)
  float mrow[F::MT][2];
#pragma unroll
  for (int mt = 0; mt < F::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = m0 + wm + mt * 16 + g + 8 * h;
      mrow[mt][h] = i < B ? masks[i] : 0.0f;
    }

  float acc[F::MT][3][4] = {};  // [row tile][gate r, z, n][fragment]
#pragma unroll
  for (int s = 0; s < F::STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<F::STAGES - 2>();
    __syncthreads();  // step kt has landed; step kt - 1's reads are done
    {
      const int nx = kt + F::STAGES - 1;
      if (nx < nk) load(nx, nx % F::STAGES);
      cp_async_commit();
    }
    const char* stage = base + (kt % F::STAGES) * F::STAGE_BYTES;
    const float* sA = reinterpret_cast<const float*>(stage);
    const float* sB = reinterpret_cast<const float*>(stage + F::A_BYTES);
#pragma unroll
    for (int kk = 0; kk < F::BK; kk += 8) {
      Split<2> w[3];
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        const float* p = sB + (kk + q) * F::BS + gate * F::U + wu + g;
        const float bf[2] = {p[0], p[4 * F::BS]};
        w[gate] = split(bf);
      }
#pragma unroll
      for (int mt = 0; mt < F::MT; ++mt) {
        const float* a = sA + (wm + mt * 16 + g) * F::AS + kk + q;
        const float af[4] = {a[0] * mrow[mt][0], a[8 * F::AS] * mrow[mt][1],
                             a[4] * mrow[mt][0], a[8 * F::AS + 4] * mrow[mt][1]};
        const Split<4> hm = split(af);
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) mma3_add(acc[mt][gate], hm, w[gate]);
      }
    }
  }
  cp_async_wait_all();

  // the gate math of this lane's rows and units u, u + 1
  const int u = u0 + wu + 2 * q;
  const float br[2] = {b_hh[u], b_hh[u + 1]};
  const float bz[2] = {b_hh[H + u], b_hh[H + u + 1]};
  const float bn[2] = {b_hh[2 * H + u], b_hh[2 * H + u + 1]};
#pragma unroll
  for (int mt = 0; mt < F::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = m0 + wm + mt * 16 + g + 8 * h;
      if (i >= B) continue;
      const size_t o = (size_t)i * H + u;
      const float2 xr = load2(gir + o), xz = load2(giz + o), xn = load2(gin + o);
      const float2 hp = load2(hprev + o);
      const float x[3][2] = {{xr.x, xr.y}, {xz.x, xz.y}, {xn.x, xn.y}};
      const float hps[2] = {hp.x, hp.y};
      float hv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float hm = hps[e] * mrow[mt][h];
        const float rg = sigmoid_(x[0][e] + (acc[mt][0][2 * h + e] + br[e]));
        const float zg = sigmoid_(x[1][e] + (acc[mt][1][2 * h + e] + bz[e]));
        const float ng = tanhf(x[2][e] + rg * (acc[mt][2][2 * h + e] + bn[e]));
        hv[e] = (1.0f - zg) * ng + zg * hm;
      }
      store2(hnext + o, hv[0], hv[1]);
      store2(outs + o, hv[0], hv[1]);
    }
}

// ---------------------------------------------------------------------------
// backward at 64 < H <= 512, H % 32 == 0, on the tensor cores: two GEMMs
// around a carry-only recurrent kernel
// ---------------------------------------------------------------------------
// The same function as gru_bwd_kernel, which at H = 512 runs its three
// products on the CUDA cores inside the time loop at 16-row tiles, with W
// (3.15 MB, no SM's shared memory holds it) read from L2 and each block's
// 3.15 MB dW partial read and written in device memory every step. Here
// only what is recurrent stays in the time loop:
//  * The gates of step t depend on hprev_t = outs[t-1] (h0 at t = 0) and
//    gi, not on the carried dh. So their hidden product is one GEMM over
//    all M = T*B rows (gru_bwd_gates_gemm):
//      GH [M x 3H] = HM [M x H] . W_hh [H x 3H] + b_hh,  HM = hprev * m
//  * The carry is the only recurrence (gru_bwd_carry): per step, the gate
//    cotangents of a batch tile from GH_t, then
//      d_hm^T [H x BT] = W_hh [H x 3H] . dG_t^T [3H x BT],
//      dh <- (dh * z + d_hm) * m_t,   dG_t = [dr, dz, dn * r].
//    dG_t overwrites GH_t in place (same thread, same entries), so one
//    [M x 3H] f32 scratch holds GH, then dG.
//  * dW = HM^T . DG over K = M rows does not feed the recurrence either:
//    one split-K GEMM (gru_bwd_dw_gemm) whose partials gru_bwd_reduce sums
//    in split order; db = the column sums of DG, in the same pass.
// All three products are 3xTF32 mma.sync m16n8k8 (split, mma3), each
// k-step's products added to the accumulators in plain f32 (mma3_add),
// not in the tensor cores' truncating accumulator, so they keep f32
// accuracy. dW is summed from the f32 dG, never from the dgi
// streams, whatever their type (pallas_gru.py:204-206). Every grid and the
// split count follow from (T, B, H, SM count), so every call gives the
// same bits of dW; no float atomics.
//
// What bounds it on an H100: the three products, 2 * M * H * 3H flops each
// in three TF32 passes (5.7 ms for all three at 495 TFLOP/s at the Hanabi
// shape T=10, B=20,000, H=512) against the streams' bytes (1.9 ms). The
// GEMMs see whole tiles; the carry kernel reads W from L2 once a step for
// each 32-row tile (19.7 GB of L2 reads) and its steps are serial.

// Tiles of both GEMMs: BM x BN outputs, BK deep, 8 warps as 2 (M) x 4 (N)
// warp tiles of 64 x 32, a ring of STAGES cp.async stages. The M and N
// edges are ragged (M = T*B; N = 3H and, in dW, M = H need not be whole
// tiles): rows and columns past them are copied in as zeros and not
// written.
struct WideGemm {
  static constexpr int BM = 128, BN = 128, BK = 32;
  static constexpr int THREADS = 256, STAGES = 3, MIN_BLOCKS = 2;
  static constexpr int WM = 64, WN = 32;  // a warp's tile
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int BS = BN + 8;       // B tile row stride, f32 words
};

// Shared memory of a GEMM stage, in bytes. A holds hprev in the stream
// type: [BM][BK + one 16-byte chunk] rows of HM (gates), or [BK][BM + 8]
// as HM is stored, for HM^T (dW). Every fragment load is free of bank
// conflicts: row strides of 36 words (f32) or 20 words (bf16, two
// elements a word) put lane (g, q) of an A fragment on bank 4g + q or
// 20g + q/2; the [BK][*] tiles' strides of 136 words (f32 B and dW's
// f32 A) and 68 words (dW's bf16 A) on 8q + g and 4q + g/2. dW stages the
// masks of its BK rows beside them. 107,520 bytes (gates) and 104,832
// (dW) with f32 streams, 82,944 and 78,720 with bf16: two blocks an SM.
template <bool kTransA, typename S>
struct WideGemmLayout {
  using G = WideGemm;
  static constexpr int EPC = 16 / sizeof(S);  // stream elements a chunk
  static constexpr int AS = kTransA ? G::BM + 8 : G::BK + EPC;
  static constexpr int A_BYTES = (kTransA ? G::BK : G::BM) * AS * (int)sizeof(S);
  static constexpr int B_BYTES = G::BK * G::BS * 4;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES + (kTransA ? 4 * G::BK : 0);
  static constexpr int BYTES = G::STAGES * STAGE_BYTES;
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0,
                "16-byte cp.async targets");
};

// Row i of HM's unmasked rows: h0 (hprev at t = 0, in the stream type) for
// the first B rows, outs[t - 1] after them.
template <typename S>
__device__ __forceinline__ const S* hprev_row(const S* outs, const S* h0,
                                              size_t i, int B, int H) {
  return i < (size_t)B ? h0 + i * H : outs + (i - B) * H;
}

// GH [M x 3H] = HM . W_hh + b_hh, in f32. Blocks walk the output tiles
// with the N tile fastest, so the blocks in flight share their rows of HM
// and read them from device memory about once.
template <typename S>
__global__ void __launch_bounds__(WideGemm::THREADS, WideGemm::MIN_BLOCKS)
gru_bwd_gates_gemm(const S* __restrict__ outs,       // [T, B, H]
                   const S* __restrict__ h0,         // [B, H], hprev at t = 0
                   const float* __restrict__ masks,  // [T, B]
                   const float* __restrict__ w_hh,   // [H, 3H]
                   const float* __restrict__ b_hh,   // [3H]
                   float* __restrict__ gh,           // [T * B, 3H]
                   int M, int B, int H) {
  using G = WideGemm;
  using L = WideGemmLayout<false, S>;
  extern __shared__ __align__(16) float gemm_smem[];
  char* const base = reinterpret_cast<char*>(gemm_smem);
  const int N = 3 * H;
  const int ntn = (N + G::BN - 1) / G::BN;
  const int n0 = (blockIdx.x % ntn) * G::BN;
  const size_t m0 = (size_t)(blockIdx.x / ntn) * G::BM;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int wm = (warp >> 2) * G::WM, wn = (warp & 3) * G::WN;
  const int nk = H / G::BK;

  auto load = [&](int kt, int st) {
    char* stage = base + st * L::STAGE_BYTES;
    S* sA = reinterpret_cast<S*>(stage);
    float* sB = reinterpret_cast<float*>(stage + L::A_BYTES);
    const int k0 = kt * G::BK;
    constexpr int ACH = G::BK / L::EPC;  // chunks of an A row
    for (int e = threadIdx.x; e < G::BM * ACH; e += G::THREADS) {
      const int r = e / ACH, c = (e % ACH) * L::EPC;
      const size_t i = m0 + r;
      const bool ok = i < (size_t)M;
      cp_async16(sA + r * L::AS + c, hprev_row(outs, h0, ok ? i : 0, B, H) + k0 + c,
                 ok);
    }
    constexpr int BCH = G::BN / 4;
    for (int e = threadIdx.x; e < G::BK * BCH; e += G::THREADS) {
      const int r = e / BCH, c = (e % BCH) * 4;
      const bool ok = n0 + c < N;
      cp_async16(sB + r * G::BS + c, w_hh + (size_t)(k0 + r) * N + (ok ? n0 + c : 0),
                 ok);
    }
  };

  // the masks of this lane's A rows (wm + 16 mt + g + 8 h)
  float mrow[G::MT][2];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t i = m0 + wm + mt * 16 + g + 8 * h;
      mrow[mt][h] = i < (size_t)M ? masks[i] : 0.0f;
    }

  float acc[G::MT][G::NT][4] = {};
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // step kt has landed; step kt - 1's reads are done
    {
      const int nx = kt + G::STAGES - 1;
      if (nx < nk) load(nx, nx % G::STAGES);
      cp_async_commit();
    }
    const char* stage = base + (kt % G::STAGES) * L::STAGE_BYTES;
    const S* sA = reinterpret_cast<const S*>(stage);
    const float* sB = reinterpret_cast<const float*>(stage + L::A_BYTES);
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 8) {
      Split<2> b[G::NT];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const float* p = sB + (kk + q) * G::BS + wn + nt * 8 + g;
        const float bf[2] = {p[0], p[4 * G::BS]};
        b[nt] = split(bf);
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        const S* a = sA + (wm + mt * 16 + g) * L::AS + kk + q;
        const float af[4] = {to_f32(a[0]) * mrow[mt][0],
                             to_f32(a[8 * L::AS]) * mrow[mt][1],
                             to_f32(a[4]) * mrow[mt][0],
                             to_f32(a[8 * L::AS + 4]) * mrow[mt][1]};
        const Split<4> as = split(af);
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) mma3_add(acc[mt][nt], as, b[nt]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
    const int c = n0 + wn + nt * 8 + 2 * q;
    if (c >= N) continue;
    const float b0 = b_hh[c], b1 = b_hh[c + 1];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t i = m0 + wm + mt * 16 + g + 8 * h;
        if (i < (size_t)M)
          *reinterpret_cast<float2*>(gh + i * N + c) =
              make_float2(acc[mt][nt][2 * h] + b0, acc[mt][nt][2 * h + 1] + b1);
      }
  }
}

// dW [H x 3H] = HM^T . DG over this block's share of the K = M rows, and
// (blocks of the first M tile) db = the column sums of DG over it. The
// rows split into `splits` ranges of whole BK steps; block (n tile, m
// tile, split), N tile fastest, writes its split's slice of `partial`,
// [splits][(H + 1) x 3H] with db in row H, and gru_bwd_reduce sums the
// slices in split order.
template <typename S>
__global__ void __launch_bounds__(WideGemm::THREADS, WideGemm::MIN_BLOCKS)
gru_bwd_dw_gemm(const S* __restrict__ outs,       // [T, B, H]
                const S* __restrict__ h0,         // [B, H], hprev at t = 0
                const float* __restrict__ masks,  // [T, B]
                const float* __restrict__ dg,     // [T * B, 3H]
                float* __restrict__ partial,      // [splits, (H + 1) * 3H]
                int K, int B, int H, int splits) {
  using G = WideGemm;
  using L = WideGemmLayout<true, S>;
  extern __shared__ __align__(16) float gemm_smem[];
  char* const base = reinterpret_cast<char*>(gemm_smem);
  const int N = 3 * H;
  const int ntn = (N + G::BN - 1) / G::BN, ntm = (H + G::BM - 1) / G::BM;
  int bid = blockIdx.x;
  const int n0 = (bid % ntn) * G::BN;
  bid /= ntn;
  const int m0 = (bid % ntm) * G::BM;
  const int split_i = bid / ntm;
  const int steps = (K + G::BK - 1) / G::BK;
  const int per = (steps + splits - 1) / splits;
  const int kt0 = min(steps, split_i * per);
  const int nk = min(steps, kt0 + per) - kt0;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int wm = (warp >> 2) * G::WM, wn = (warp & 3) * G::WN;
  const bool db_block = m0 == 0;

  auto load = [&](int kt, int st) {
    char* stage = base + st * L::STAGE_BYTES;
    S* sA = reinterpret_cast<S*>(stage);
    float* sB = reinterpret_cast<float*>(stage + L::A_BYTES);
    float* sMk = reinterpret_cast<float*>(stage + L::A_BYTES + L::B_BYTES);
    const size_t k0 = (size_t)(kt0 + kt) * G::BK;
    constexpr int ACH = G::BM / L::EPC;  // chunks of an A row
    for (int e = threadIdx.x; e < G::BK * ACH; e += G::THREADS) {
      const int r = e / ACH, c = (e % ACH) * L::EPC;
      const size_t i = k0 + r;
      const bool ok = i < (size_t)K && m0 + c < H;
      cp_async16(sA + r * L::AS + c,
                 hprev_row(outs, h0, ok ? i : 0, B, H) + (ok ? m0 + c : 0), ok);
    }
    constexpr int BCH = G::BN / 4;
    for (int e = threadIdx.x; e < G::BK * BCH; e += G::THREADS) {
      const int r = e / BCH, c = (e % BCH) * 4;
      const size_t i = k0 + r;
      const bool ok = i < (size_t)K && n0 + c < N;
      cp_async16(sB + r * G::BS + c, dg + (ok ? i * N + n0 + c : 0), ok);
    }
    if (threadIdx.x < G::BK) {
      const size_t i = k0 + threadIdx.x;
      cp_async4(sMk + threadIdx.x, masks + (i < (size_t)K ? i : 0), i < (size_t)K);
    }
  };

  float acc[G::MT][G::NT][4] = {};
  float colsum = 0.0f;  // db of column n0 + tid, tid < BN, in db blocks
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // step kt has landed; step kt - 1's reads are done
    {
      const int nx = kt + G::STAGES - 1;
      if (nx < nk) load(nx, nx % G::STAGES);
      cp_async_commit();
    }
    const char* stage = base + (kt % G::STAGES) * L::STAGE_BYTES;
    const S* sA = reinterpret_cast<const S*>(stage);
    const float* sB = reinterpret_cast<const float*>(stage + L::A_BYTES);
    const float* sMk = reinterpret_cast<const float*>(stage + L::A_BYTES + L::B_BYTES);
    if (db_block && tid < G::BN) {
      float s = 0.0f;
#pragma unroll 8
      for (int r = 0; r < G::BK; ++r) s += sB[r * G::BS + tid];
      colsum += s;
    }
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 8) {
      Split<2> b[G::NT];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const float* p = sB + (kk + q) * G::BS + wn + nt * 8 + g;
        const float bf[2] = {p[0], p[4 * G::BS]};
        b[nt] = split(bf);
      }
      const float mk0 = sMk[kk + q], mk1 = sMk[kk + q + 4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        // A (m, k) = HM[k][m]: the tile as stored, read down its columns
        const S* a = sA + (kk + q) * L::AS + wm + mt * 16 + g;
        const float af[4] = {to_f32(a[0]) * mk0, to_f32(a[8]) * mk0,
                             to_f32(a[4 * L::AS]) * mk1,
                             to_f32(a[4 * L::AS + 8]) * mk1};
        const Split<4> as = split(af);
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) mma3_add(acc[mt][nt], as, b[nt]);
      }
    }
  }
  cp_async_wait_all();

  float* out = partial + (size_t)split_i * (H + 1) * N;
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
    const int c = n0 + wn + nt * 8 + 2 * q;
    if (c >= N) continue;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = m0 + wm + mt * 16 + g + 8 * h;
        if (u < H)
          *reinterpret_cast<float2*>(out + (size_t)u * N + c) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  }
  if (db_block && tid < G::BN && n0 + tid < N) out[(size_t)H * N + n0 + tid] = colsum;
}

// The carry kernel: one thread a hidden unit (H threads, a warp for each
// 32 units of d_hm^T), one block per batch tile of BT = 32 rows at a time; a
// persistent grid walks the tiles blockIdx.x, + gridDim.x, ..., and each
// block loops t = T-1 .. 0 itself. The carried dh lives in dh0 (read from
// dhT at t = T-1), which stays in L2 and holds dh0 when the loop ends.
// Per step:
//  (a) gate math, in coalesced row-major float4 order: from GH_t, gi_t,
//      hprev_t, douts_t, m_t and the carried dh, the cotangents dgir,
//      dgiz, dgin (stream type), dG_t = [dr, dz, dn * r] in f32 over GH_t,
//      and dh * z over the carried dh.
//  (b) d_hm^T = W_hh . dG_t^T in 3xTF32 (mma3_add), the tile's rows as
//      the MMA's N: W (K-chunks of all H rows) and the tile's dG_t
//      (K-chunks of BT rows) stream from L2 through a ring of two
//      shared-memory stages. A warp
//      holds its 32 units x BT rows (2 x 4 accumulator tiles) and loads
//      each dG fragment once for both of its unit tiles.
//  (c) dh <- (dh * z + d_hm) * m_t, from the accumulator layout.
// Writes to global memory before __syncthreads() are visible to the
// block's later reads, so (b) reads the dG_t that (a) wrote and (c) the
// dh * z. Rows >= B of the ragged tile are neither read nor written; their
// dG rows are copied into shared memory as zeros.
// Shared memory: 2 stages of [H + BT][BK + 4] f32; row stride 36 words
// puts lane (g, q) of every A (W) and B (dG) fragment load on bank
// 4g + q. At H = 512 that is 156,672 bytes: one block an SM; at 512
// threads a thread has 128 registers, 32 of them the accumulators (the
// compiler spills 32 bytes a thread).
struct CarryLayout {
  static constexpr int BT = 32;           // batch rows of a tile
  static constexpr int BK = 32;           // K-chunk of the carry product
  static constexpr int LDK = BK + 4;      // row stride, f32 words
  static constexpr int STAGES = 2;
  static constexpr int NT = BT / 8;       // accumulator tiles along the rows
  static constexpr int MAX_THREADS = 512; // H <= 512
  static_assert(BT % 8 == 0 && (LDK * 4) % 16 == 0, "tile shapes");
  __host__ __device__ static size_t bytes(int H) {
    return (size_t)STAGES * (H + BT) * LDK * 4;
  }
};

__device__ __forceinline__ void ld4(float (&d)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
template <typename S>
__device__ __forceinline__ void ld4s(float (&d)[4], const S* p) {
  const float4 v = load4(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v[0], v[1]);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v[2], v[3]);
}

template <typename S>
__global__ void __launch_bounds__(CarryLayout::MAX_THREADS, 1)
gru_bwd_carry(const S* __restrict__ gir, const S* __restrict__ giz,
              const S* __restrict__ gin,
              const S* __restrict__ outs,       // [T, B, H]
              const float* __restrict__ masks,  // [T, B]
              const S* __restrict__ h0,         // [B, H], hprev at t = 0
              const S* __restrict__ douts,      // [T, B, H]
              const float* __restrict__ dhT,    // [B, H]
              const float* __restrict__ w_hh,   // [H, 3H]
              float* g_io,                      // [T * B, 3H]: GH in, dG out
              S* __restrict__ dgir, S* __restrict__ dgiz,
              S* __restrict__ dgin,
              float* dh0,                       // [B, H]: the carry, then dh0
              int T, int B, int H) {
  using L = CarryLayout;
  constexpr int BT = L::BT;
  extern __shared__ __align__(16) float carry_smem[];
  const int H3 = 3 * H, HV = H / 4, nthr = blockDim.x;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int u0 = warp * 32;  // this warp's units of d_hm^T
  const int stage_floats = (H + BT) * L::LDK;
  const int ntiles = (B + BT - 1) / BT, nchunks = H3 / L::BK;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * BT;
    for (int t = T - 1; t >= 0; --t) {
      const size_t tb = (size_t)t * B;
      const float* carry = t == T - 1 ? dhT : dh0;

      // (a) gate cotangents
      for (int e = tid; e < BT * HV; e += nthr) {
        const int r = e / HV, c = (e - r * HV) * 4, row = row0 + r;
        if (row >= B) continue;
        const size_t i = tb + row, o = i * H + c;
        const float m = masks[i];
        float* gr = g_io + i * H3 + c;
        float hp[4], ghr[4], ghz[4], ghn[4], xr[4], xz[4], xn[4], dy[4], dc[4];
        ld4s(hp, (t > 0 ? outs + (i - B) * H : h0 + (size_t)row * H) + c);
        ld4(ghr, gr);
        ld4(ghz, gr + H);
        ld4(ghn, gr + 2 * H);
        ld4s(xr, gir + o);
        ld4s(xz, giz + o);
        ld4s(xn, gin + o);
        ld4s(dy, douts + o);
        ld4(dc, carry + (size_t)row * H + c);
        float dr[4], dz[4], dn[4], dnr[4], dhz[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float rg = sigmoid_(xr[k] + ghr[k]);
          const float zg = sigmoid_(xz[k] + ghz[k]);
          const float ng = tanhf(xn[k] + rg * ghn[k]);
          const float dh = dc[k] + dy[k];
          dz[k] = dh * (hp[k] * m - ng) * zg * (1.0f - zg);
          dn[k] = dh * (1.0f - zg) * (1.0f - ng * ng);
          dr[k] = dn[k] * ghn[k] * rg * (1.0f - rg);
          dnr[k] = dn[k] * rg;
          dhz[k] = dh * zg;
        }
        st4(dgir + o, dr);
        st4(dgiz + o, dz);
        st4(dgin + o, dn);
        st4(gr, dr);
        st4(gr + H, dz);
        st4(gr + 2 * H, dnr);
        st4(dh0 + (size_t)row * H + c, dhz);
      }
      __syncthreads();

      // (b) d_hm^T = W . dG_t^T over K-chunks of 3H
      auto issue = [&](int ch, int st) {
        float* sw = carry_smem + st * stage_floats;
        float* sg = sw + H * L::LDK;
        const int k0 = ch * L::BK;
        for (int e = tid; e < H * (L::BK / 4); e += nthr) {
          const int r = e / (L::BK / 4), c = (e % (L::BK / 4)) * 4;
          cp_async16(sw + r * L::LDK + c, w_hh + (size_t)r * H3 + k0 + c, true);
        }
        for (int e = tid; e < BT * (L::BK / 4); e += nthr) {
          const int r = e / (L::BK / 4), c = (e % (L::BK / 4)) * 4;
          const bool ok = row0 + r < B;
          cp_async16(sg + r * L::LDK + c,
                     g_io + (tb + (ok ? row0 + r : 0)) * H3 + k0 + c, ok);
        }
        cp_async_commit();
      };
      float acc[2][L::NT][4] = {};
      issue(0, 0);
      for (int ch = 0; ch < nchunks; ++ch) {
        cp_async_wait_all();
        __syncthreads();  // chunk ch has landed; chunk ch - 1's reads are done
        if (ch + 1 < nchunks) issue(ch + 1, (ch + 1) & 1);
        const float* sw = carry_smem + (ch & 1) * stage_floats;
        const float* sg = sw + H * L::LDK;
#pragma unroll
        for (int kk = 0; kk < L::BK; kk += 8) {
          Split<4> a[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* w = sw + (u0 + mt * 16 + g) * L::LDK + kk + q;
            const float af[4] = {w[0], w[8 * L::LDK], w[4], w[8 * L::LDK + 4]};
            a[mt] = split(af);
          }
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt) {
            const float* p = sg + (nt * 8 + g) * L::LDK + kk + q;
            const float bf[2] = {p[0], p[4]};
            const Split<2> b = split(bf);
            mma3_add(acc[0][nt], a[0], b);
            mma3_add(acc[1][nt], a[1], b);
          }
        }
      }

      // (c) dh <- (dh * z + d_hm) * m_t
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int row = row0 + nt * 8 + 2 * q + (p & 1);
            if (row >= B) continue;
            float* d = dh0 + (size_t)row * H + u0 + mt * 16 + g + 8 * (p >> 1);
            *d = (*d + acc[mt][nt][p]) * masks[tb + row];
          }
      __syncthreads();
    }
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
#pragma unroll 8  // loads in flight; the sum keeps block order
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

// Dynamic shared memory of gru_fwd_kernel: h and hm of the tile and its
// mask row, plus (kSmemW) W with odd row stride.
size_t simt_fwd_bytes(int H, int bt, bool smem_w) {
  size_t floats = (size_t)2 * bt * H + bt;
  if (smem_w) floats += (size_t)H * ((3 * H) | 1);
  return floats * sizeof(float);
}

// Dynamic shared memory of gru_bwd_kernel: its five [bt, H] tiles and
// two mask rows, plus (kSmemW) W with odd row stride and the dW/db sums.
size_t simt_bwd_bytes(int H, int bt, bool smem_w) {
  size_t floats = (size_t)5 * bt * H + 2 * bt;
  if (smem_w) floats += (size_t)H * ((3 * H) | 1) + (size_t)(H + 1) * 3 * H;
  return floats * sizeof(float);
}

// True when every pointer is 16-byte aligned (cp.async and float4 sources).
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <bool kSmemW, typename S>
cudaError_t launch_fwd(const S* gir, const S* giz, const S* gin,
                       const float* masks, const float* h0, const float* w_hh,
                       const float* b_hh, S* outs, float* hT, int T, int B,
                       int H, int bt, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<kSmemW, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int grid = (B + bt - 1) / bt;
  gru_fwd_kernel<kSmemW, S><<<grid, kThreads, bytes, stream>>>(
      gir, giz, gin, masks, h0, w_hh, b_hh, outs, hT, T, B, H, bt);
  return cudaGetLastError();
}

template <int H, int BT, typename S>
cudaError_t launch_fwd_mma(const S* gir, const S* giz, const S* gin,
                           const float* masks, const float* h0,
                           const float* w_hh, const float* b_hh, S* outs,
                           float* hT, int T, int B, int grid, size_t bytes,
                           cudaStream_t stream) {
  using L = FwdLayout<H, BT, S>;
  if (bytes != (size_t)L::BYTES || grid > (B + BT - 1) / BT)
    return cudaErrorInvalidValue;
  // cp.async and the copy of W move 16-byte chunks of these; refuse before
  // a misaligned access faults the context
  if (!aligned16({gir, giz, gin, w_hh})) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel_mma<H, BT, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  gru_fwd_kernel_mma<H, BT, S><<<grid, L::THREADS, bytes, stream>>>(
      gir, giz, gin, masks, h0, w_hh, b_hh, outs, hT, T, B);
  return cudaGetLastError();
}

template <bool kSmemW, typename S>
cudaError_t launch_bwd(const S* gir, const S* giz, const S* gin,
                       const S* outs, const float* masks, const S* h0,
                       const S* douts, const float* dhT, const float* w_hh,
                       const float* b_hh, S* dgir, S* dgiz, S* dgin,
                       float* dh0, float* partial, int T, int B, int H,
                       int bt, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<kSmemW, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  gru_bwd_kernel<kSmemW, S><<<(B + bt - 1) / bt, kThreads, bytes, stream>>>(
      gir, giz, gin, outs, masks, h0, douts, dhT, w_hh, b_hh, dgir, dgiz,
      dgin, dh0, partial, T, B, H, bt);
  return cudaGetLastError();
}

template <int H, int BT, typename S>
cudaError_t launch_bwd_mma(const S* gir, const S* giz, const S* gin,
                           const S* outs, const float* masks, const S* h0,
                           const S* douts, const float* dhT,
                           const float* w_hh, const float* b_hh, S* dgir,
                           S* dgiz, S* dgin, float* dh0, float* partial,
                           int T, int B, int grid, size_t bytes,
                           cudaStream_t stream) {
  if (bytes != (size_t)MmaLayout<H, BT, S>::BYTES) return cudaErrorInvalidValue;
  // cp.async moves 16-byte chunks of these; refuse before a misaligned copy
  // faults the context
  if (!aligned16({gir, giz, gin, outs, h0, douts, w_hh}))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel_mma<H, BT, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  gru_bwd_kernel_mma<H, BT, S><<<grid, kThreads, bytes, stream>>>(
      gir, giz, gin, outs, masks, h0, douts, dhT, w_hh, b_hh, dgir, dgiz,
      dgin, dh0, partial, T, B);
  return cudaGetLastError();
}

// Kernel variants of both entries, as ops/cuda_gru.py:fwd_plan and
// bwd_plan choose them: the CUDA-core kernel with W read from global memory
// or held in shared memory, and the tensor-core one.
enum { kGlobalW = 0, kSmemW = 1, kMma = 2 };

template <typename S>
cudaError_t fwd_entry(const S* gir, const S* giz, const S* gin,
                      const float* masks, const float* h0, const float* w_hh,
                      const float* b_hh, S* outs, float* hT, int T, int B,
                      int H, int variant, int bt, int grid, size_t bytes,
                      cudaStream_t s) {
  if (variant == kMma) {
#define GRU_FWD_MMA(HH, BB)                                                  \
  if (H == HH && bt == BB)                                                   \
    return launch_fwd_mma<HH, BB, S>(gir, giz, gin, masks, h0, w_hh, b_hh,  \
                                     outs, hT, T, B, grid, bytes, s);
    GRU_FWD_MMA(16, 8) GRU_FWD_MMA(16, 16) GRU_FWD_MMA(32, 8)
    GRU_FWD_MMA(32, 16) GRU_FWD_MMA(48, 8) GRU_FWD_MMA(48, 16)
    GRU_FWD_MMA(64, 8) GRU_FWD_MMA(64, 16)
#undef GRU_FWD_MMA
  } else if ((variant == kGlobalW || variant == kSmemW) &&
             !bad_shape(T, B, H, bt) && grid == (B + bt - 1) / bt &&
             bytes == simt_fwd_bytes(H, bt, variant == kSmemW)) {
    return (variant == kSmemW ? launch_fwd<true, S> : launch_fwd<false, S>)(
        gir, giz, gin, masks, h0, w_hh, b_hh, outs, hT, T, B, H, bt, bytes,
        s);
  }
  return cudaErrorInvalidValue;
}

template <typename S>
cudaError_t bwd_entry(const S* gir, const S* giz, const S* gin,
                      const S* outs, const float* masks, const S* h0,
                      const S* douts, const float* dhT, const float* w_hh,
                      const float* b_hh, S* dgir, S* dgiz, S* dgin,
                      float* dh0, float* dw_hh, float* db_hh, float* partial,
                      int T, int B, int H, int variant, int bt, int grid,
                      size_t bytes, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == kMma) {
#define GRU_BWD_MMA(HH, BB)                                                  \
  if (H == HH && bt == BB)                                                   \
    err = launch_bwd_mma<HH, BB, S>(gir, giz, gin, outs, masks, h0, douts,  \
                                    dhT, w_hh, b_hh, dgir, dgiz, dgin, dh0, \
                                    partial, T, B, grid, bytes, s);
    GRU_BWD_MMA(16, 8) GRU_BWD_MMA(16, 16) GRU_BWD_MMA(32, 8)
    GRU_BWD_MMA(32, 16) GRU_BWD_MMA(48, 8) GRU_BWD_MMA(48, 16)
    GRU_BWD_MMA(64, 8) GRU_BWD_MMA(64, 16)
#undef GRU_BWD_MMA
  } else if ((variant == kGlobalW || variant == kSmemW) &&
             !bad_shape(T, B, H, bt) && grid == (B + bt - 1) / bt &&
             bytes == simt_bwd_bytes(H, bt, variant == kSmemW)) {
    err = (variant == kSmemW ? launch_bwd<true, S> : launch_bwd<false, S>)(
        gir, giz, gin, outs, masks, h0, douts, dhT, w_hh, b_hh, dgir, dgiz,
        dgin, dh0, partial, T, B, H, bt, bytes, s);
  }
  if (err != cudaSuccess) return err;
  const int nacc = (H + 1) * 3 * H;
  const int rgrid = (nacc + kThreads - 1) / kThreads;
  gru_bwd_reduce<<<rgrid, kThreads, 0, s>>>(partial, grid, H, dw_hh, db_hh);
  return cudaGetLastError();
}

// Shapes of the wide backward (gru_bwd_gates_gemm, gru_bwd_carry,
// gru_bwd_dw_gemm): a carry-kernel warp for each 32 hidden units, at most
// 512 threads, and M = T * B rows that an int counts.
bool wide_shape(int T, int B, int H) {
  return T > 0 && B > 0 && H > 64 && H <= 512 && H % 32 == 0 &&
         (long long)T * B <= 0x7fffffffLL - WideGemm::BM;
}

template <typename S>
cudaError_t wide_gates(const S* outs, const S* h0, const float* masks,
                       const float* w_hh, const float* b_hh, float* gh, int T,
                       int B, int H, cudaStream_t s) {
  using G = WideGemm;
  using L = WideGemmLayout<false, S>;
  // cp.async moves 16-byte chunks of these, the epilogue float2s of gh
  if (!wide_shape(T, B, H) || !aligned16({outs, h0, w_hh, gh}))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_gates_gemm<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return err;
  const int M = T * B;
  const long long blocks = (long long)((3 * H + G::BN - 1) / G::BN) *
                           ((M + G::BM - 1) / G::BM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gru_bwd_gates_gemm<S><<<(unsigned)blocks, G::THREADS, L::BYTES, s>>>(
      outs, h0, masks, w_hh, b_hh, gh, M, B, H);
  return cudaGetLastError();
}

template <typename S>
cudaError_t wide_carry(const S* gir, const S* giz, const S* gin,
                       const S* outs, const float* masks, const S* h0,
                       const S* douts, const float* dhT, const float* w_hh,
                       float* g, S* dgir, S* dgiz, S* dgin, float* dh0, int T,
                       int B, int H, int bt, int grid, size_t bytes,
                       cudaStream_t s) {
  using L = CarryLayout;
  // cp.async moves 16-byte chunks of W and g; the gate math moves four
  // elements of every stream at a time
  if (!wide_shape(T, B, H) || bt != L::BT || grid <= 0 ||
      grid > (B + L::BT - 1) / L::BT || bytes != L::bytes(H) ||
      !aligned16({gir, giz, gin, outs, h0, douts, dhT, w_hh, g, dgir, dgiz,
                  dgin, dh0}))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_carry<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  gru_bwd_carry<S><<<grid, H, bytes, s>>>(gir, giz, gin, outs, masks, h0,
                                          douts, dhT, w_hh, g, dgir, dgiz,
                                          dgin, dh0, T, B, H);
  return cudaGetLastError();
}

template <typename S>
cudaError_t wide_dw(const S* outs, const S* h0, const float* masks,
                    const float* dg, float* partial, float* dw, float* db,
                    int T, int B, int H, int splits, cudaStream_t s) {
  using G = WideGemm;
  using L = WideGemmLayout<true, S>;
  if (!wide_shape(T, B, H) || splits <= 0 || splits > 65536 ||
      !aligned16({outs, h0, dg, partial}))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_dw_gemm<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return err;
  const int blocks = ((3 * H + G::BN - 1) / G::BN) *
                     ((H + G::BM - 1) / G::BM) * splits;
  gru_bwd_dw_gemm<S><<<blocks, G::THREADS, L::BYTES, s>>>(
      outs, h0, masks, dg, partial, T * B, B, H, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nacc = (H + 1) * 3 * H;
  gru_bwd_reduce<<<(nacc + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, splits, H, dw, db);
  return cudaGetLastError();
}

// The wide forward's T step launches (gru_fwd_wide_step) on `grid` blocks
// of `bt` rows: h_{t-1} from h0 at t = 0, else from the scratch buffer
// step t - 1 wrote (`hbuf`, [min(T - 1, 2)][B, H] f32); h_t into the
// other buffer, or into hT at the last step.
template <typename S>
cudaError_t wide_fwd(const S* gir, const S* giz, const S* gin,
                     const float* masks, const float* h0, const float* w_hh,
                     const float* b_hh, S* outs, float* hT, float* hbuf, int T,
                     int B, int H, int bt, int grid, size_t bytes,
                     cudaStream_t s) {
  using F = WideFwd;
  // cp.async moves 16-byte chunks of h0, hbuf and W, the epilogue pairs of
  // the streams and of h
  if (!wide_shape(T, B, H) || bt != F::BM || bytes != (size_t)F::BYTES ||
      grid != (H / F::U) * ((B + F::BM - 1) / F::BM) ||
      !aligned16({gir, giz, gin, h0, w_hh, outs, hT}) ||
      (T > 1 && !aligned16({hbuf})))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_wide_step<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F::BYTES);
  if (err != cudaSuccess) return err;
  const size_t step = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const float* src = t == 0 ? h0 : hbuf + ((t - 1) & 1) * step;
    float* dst = t == T - 1 ? hT : hbuf + (t & 1) * step;
    const size_t o = (size_t)t * step;
    gru_fwd_wide_step<S><<<grid, F::THREADS, F::BYTES, s>>>(
        gir + o, giz + o, gin + o, masks + (size_t)t * B, src, w_hh, b_hh,
        outs + o, dst, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Stream types of both entries' `stream_type`: the element type of the
// [T, B, H] sequence streams (ops/cuda_gru.py:STREAM_TYPES).
enum { kF32 = 0, kBF16 = 1 };

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok);
// 1 (cudaErrorInvalidValue) for a shape, plan or stream type the kernels do
// not take.

// Launches the forward `variant` on `grid` blocks of `bt` batch rows with
// `smem_bytes` of dynamic shared memory. gir, giz, gin and outs are
// [T, B, H] streams of `stream_type`; everything else is f32. The
// CUDA-core variants need grid = ceil(B / bt); the tensor-core one H in
// {16, 32, 48, 64}, bt in {8, 16}, grid <= ceil(B / bt), 16-byte aligned gi
// streams and W, and its layout's bytes.
int gru_seq_fwd(const void* gir, const void* giz, const void* gin,
                const float* masks, const float* h0, const float* w_hh,
                const float* b_hh, void* outs, float* hT, int T, int B,
                int H, int variant, int bt, int grid, int smem_bytes,
                int stream_type, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || bt <= 0 || grid <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)smem_bytes;
  if (stream_type == kF32) {
    using S = float;
    return fwd_entry<S>((const S*)gir, (const S*)giz, (const S*)gin, masks,
                        h0, w_hh, b_hh, (S*)outs, hT, T, B, H, variant, bt,
                        grid, bytes, s);
  }
  if (stream_type == kBF16) {
    using S = __nv_bfloat16;
    return fwd_entry<S>((const S*)gir, (const S*)giz, (const S*)gin, masks,
                        h0, w_hh, b_hh, (S*)outs, hT, T, B, H, variant, bt,
                        grid, bytes, s);
  }
  return cudaErrorInvalidValue;
}

// The largest dynamic shared memory a block of this device may opt into.
int gru_smem_optin() { return max_dynamic_smem(); }

// Launches the backward `variant` on `grid` blocks of `bt` batch rows with
// `smem_bytes` of dynamic shared memory, then the partials' reduction.
// gir, giz, gin, outs, h0 (hprev at t = 0: the forward's h0 in the stream
// type), douts and dgir, dgiz, dgin are of `stream_type`; everything else
// is f32. `partial` holds grid * (H + 1) * 3H floats of scratch. The
// CUDA-core variants need grid = ceil(B / bt); the tensor-core one H in
// {16, 32, 48, 64}, bt in {8, 16}, 16-byte aligned streams and W, and its
// layout's bytes.
int gru_seq_bwd(const void* gir, const void* giz, const void* gin,
                const void* outs, const float* masks, const void* h0,
                const void* douts, const float* dhT, const float* w_hh,
                const float* b_hh, void* dgir, void* dgiz, void* dgin,
                float* dh0, float* dw_hh, float* db_hh, float* partial,
                int T, int B, int H, int variant, int bt, int grid,
                int smem_bytes, int stream_type, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || bt <= 0 || grid <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)smem_bytes;
  if (stream_type == kF32) {
    using S = float;
    return bwd_entry<S>((const S*)gir, (const S*)giz, (const S*)gin,
                        (const S*)outs, masks, (const S*)h0, (const S*)douts,
                        dhT, w_hh, b_hh, (S*)dgir, (S*)dgiz, (S*)dgin, dh0,
                        dw_hh, db_hh, partial, T, B, H, variant, bt, grid,
                        bytes, s);
  }
  if (stream_type == kBF16) {
    using S = __nv_bfloat16;
    return bwd_entry<S>((const S*)gir, (const S*)giz, (const S*)gin,
                        (const S*)outs, masks, (const S*)h0, (const S*)douts,
                        dhT, w_hh, b_hh, (S*)dgir, (S*)dgiz, (S*)dgin, dh0,
                        dw_hh, db_hh, partial, T, B, H, variant, bt, grid,
                        bytes, s);
  }
  return cudaErrorInvalidValue;
}

// The wide forward (variant tensor_core_wide of ops/cuda_gru.py), for
// 64 < H <= 512, H % 32 == 0: T launches of one step on `grid` blocks of
// `bt` (128) rows with `smem_bytes` of dynamic shared memory. gir, giz,
// gin and outs are [T, B, H] streams of `stream_type`, everything else
// f32; `hbuf` is min(T - 1, 2) * B * H floats of scratch. Every
// pointer but masks and b_hh must be 16-byte aligned.
int gru_wide_fwd(const void* gir, const void* giz, const void* gin,
                 const float* masks, const float* h0, const float* w_hh,
                 const float* b_hh, void* outs, float* hT, float* hbuf, int T,
                 int B, int H, int bt, int grid, int smem_bytes,
                 int stream_type, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)smem_bytes;
  if (stream_type == kF32) {
    using S = float;
    return wide_fwd<S>((const S*)gir, (const S*)giz, (const S*)gin, masks, h0,
                       w_hh, b_hh, (S*)outs, hT, hbuf, T, B, H, bt, grid,
                       bytes, s);
  }
  if (stream_type == kBF16) {
    using S = __nv_bfloat16;
    return wide_fwd<S>((const S*)gir, (const S*)giz, (const S*)gin, masks, h0,
                       w_hh, b_hh, (S*)outs, hT, hbuf, T, B, H, bt, grid,
                       bytes, s);
  }
  return cudaErrorInvalidValue;
}

// The three launches of the wide backward (variant tensor_core_wide of
// ops/cuda_gru.py), for 64 < H <= 512, H % 32 == 0. outs and h0 (hprev at
// t = 0: the forward's h0 in the stream type) and the other [T, B, H]
// streams are of `stream_type`, everything else f32; every pointer they
// move in 16-byte chunks must be 16-byte aligned.
// GH [T * B, 3H] = (hprev * m) . W_hh + b_hh.
int gru_wide_gates(const void* outs, const void* h0, const float* masks,
                   const float* w_hh, const float* b_hh, float* gh, int T,
                   int B, int H, int stream_type, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stream_type == kF32)
    return wide_gates<float>((const float*)outs, (const float*)h0, masks, w_hh,
                             b_hh, gh, T, B, H, s);
  if (stream_type == kBF16)
    return wide_gates<__nv_bfloat16>((const __nv_bfloat16*)outs,
                                     (const __nv_bfloat16*)h0, masks, w_hh,
                                     b_hh, gh, T, B, H, s);
  return cudaErrorInvalidValue;
}

// The carry on `grid` blocks of `bt` (32) batch rows, H threads and
// `smem_bytes` of dynamic shared memory: dgir, dgiz, dgin, dh0, and dG
// [T * B, 3H] f32 over GH in `g`.
int gru_wide_carry(const void* gir, const void* giz, const void* gin,
                   const void* outs, const float* masks, const void* h0,
                   const void* douts, const float* dhT, const float* w_hh,
                   float* g, void* dgir, void* dgiz, void* dgin, float* dh0,
                   int T, int B, int H, int bt, int grid, int smem_bytes,
                   int stream_type, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)smem_bytes;
  if (stream_type == kF32) {
    using S = float;
    return wide_carry<S>((const S*)gir, (const S*)giz, (const S*)gin,
                         (const S*)outs, masks, (const S*)h0, (const S*)douts,
                         dhT, w_hh, g, (S*)dgir, (S*)dgiz, (S*)dgin, dh0, T,
                         B, H, bt, grid, bytes, s);
  }
  if (stream_type == kBF16) {
    using S = __nv_bfloat16;
    return wide_carry<S>((const S*)gir, (const S*)giz, (const S*)gin,
                         (const S*)outs, masks, (const S*)h0, (const S*)douts,
                         dhT, w_hh, g, (S*)dgir, (S*)dgiz, (S*)dgin, dh0, T,
                         B, H, bt, grid, bytes, s);
  }
  return cudaErrorInvalidValue;
}

// dW_hh [H, 3H] and db_hh [3H] from dG in `splits` K-ranges, their
// partials in `partial` (splits * (H + 1) * 3H floats), summed in order.
int gru_wide_dw(const void* outs, const void* h0, const float* masks,
                const float* dg, float* partial, float* dw, float* db, int T,
                int B, int H, int splits, int stream_type, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stream_type == kF32)
    return wide_dw<float>((const float*)outs, (const float*)h0, masks, dg,
                          partial, dw, db, T, B, H, splits, s);
  if (stream_type == kBF16)
    return wide_dw<__nv_bfloat16>((const __nv_bfloat16*)outs,
                                  (const __nv_bfloat16*)h0, masks, dg, partial,
                                  dw, db, T, B, H, splits, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
