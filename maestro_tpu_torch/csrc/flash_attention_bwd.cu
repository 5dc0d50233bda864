// flash_attention_bwd: the backward of exact (non-causal) softmax attention on
// the head-packed [B, L, H, D] layout, the gradient of flash_attention.cu.
//
// Replaces the backward attention tiers of the JAX package's ops/attention.py
// (_pk_bwd_kernel, _qb_bwd_kernel, _sb_bwd_kernel and the stock flash
// kernel's backward): with P = softmax(scale * Q K^T),
//     dV = P^T dO,   dP = dO V^T,   dS = P o (dP - rowsum(dO o O)),
//     dQ = scale * dS K,   dK = scale * dS^T Q.
// The TPU kernels recomputed each row's full softmax; here the forward's fp32
// logsumexp (lse) gives P = exp(scale * s - lse) tile by tile, so no pass
// needs a whole row of scores.
//
// What bounds it on an H100: operations.  The five products need 10*B*H*L^2*D
// operations (the bound chip_smoke.py states); this design spends 14 (S is
// formed twice) to stay free of atomics and deterministic:
//   1. attn_bwd_delta: Delta = rowsum(dO o O) in fp32, [B, H, L].
//   2. attn_bwd_dkdv (one block per 64 keys of one (batch, head), a loop over
//      32-query tiles): S^T, P^T, dV += P^T dO, dP^T, dS^T, dK += dS^T Q.
//   3. attn_bwd_dq (one block per 64 queries, a loop over 32-key tiles):
//      S, P, dP, dS, dQ += dS K.
// Every output element is written by exactly one thread, once.  bf16 inputs
// run all products on the tensor cores (mma.sync m16n8k16, fp32 accumulators;
// P and dS rounded to bf16 as operands, as the forward rounds P); the K/V
// (or Q/dO) tiles of a block live in shared memory, the streamed tiles arrive
// by cp.async into a two-stage buffer and reach the tensor cores through
// ldmatrix.  fp32 inputs take shared-memory FMA kernels with full fp32
// products.  Keys and queries beyond L are masked in the kernels (no padding
// in device memory).  dQ, dK, dV are written through strides, so they can be
// the three slots of one [B, L, 3, H, D] buffer: the gradient of the fused qkv
// projection, with no concatenation.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include <math_constants.h>

#include "mma_helpers.cuh"

namespace {

using namespace mma;

struct Strides {
  long long b, l, h;  // element strides of batch, row, head; D is contiguous
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// 1. Delta = rowsum(dO o O): one warp per (batch, row, head)
// ---------------------------------------------------------------------------
constexpr int kDeltaWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
               int B, int L, int H, int D, Strides so, Strides sd) {
  const long long item = (long long)blockIdx.x * kDeltaWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= (long long)B * L * H) return;
  const int head = item % H;
  const int row = (item / H) % L;
  const int batch = item / ((long long)H * L);
  const T* op = o + batch * so.b + row * so.l + head * so.h;
  const T* dp = dout + batch * sd.b + row * sd.l + head * sd.h;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)batch * H + head) * L + row] = acc;
}

// ---------------------------------------------------------------------------
// 2./3. bf16 tensor-core kernels
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;   // 16 rows (keys in dkdv, queries in dq) per warp
constexpr int kBlk = 64;    // rows per block
constexpr int kStep = 32;   // streamed rows per tile (queries in dkdv, keys in dq)
constexpr int kPad = 8;     // bf16 elements of row padding: rows 16 bytes apart mod 128

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K and V of the block's 64 keys, two stages of Q and dO tiles, lse and Delta
  return sizeof(__nv_bfloat16) * (2 * kBlk + 2 * 2 * kStep) * (D + kPad) +
         sizeof(float) * 2 * 2 * kStep;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(__nv_bfloat16) * 2 * 2 * kStep * (D + kPad);  // two stages of K and V tiles
}

// rows [row0, row0 + rows) of one (batch, head) slice -> shared [rows][D + kPad],
// 16-byte cp.async per vector, rows beyond L zero-filled (not committed here)
template <int D>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int row0, int rows, int L,
                                                int tid) {
  constexpr int VEC = D / 8;
  for (int idx = tid; idx < rows * VEC; idx += kWarps * 32) {
    const int r = idx / VEC;
    const int c = (idx % VEC) * 8;
    if (row0 + r < L) {
      cp_async_16(&dst[r * (D + kPad) + c], src + (long long)(row0 + r) * row_stride + c);
    } else {
      *reinterpret_cast<uint4*>(&dst[r * (D + kPad) + c]) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One warp: C[16 x kStep] += A[16 rows of a_s, D] . B[kStep rows of b_s, D]^T,
// both operands row-major in shared memory (A through ldmatrix, B through
// ldmatrix as its transpose-free "col" operand).
template <int D>
__device__ __forceinline__ void warp_abt(float (&c)[kStep / 8][4], const __nv_bfloat16* a_s,
                                         const __nv_bfloat16* b_s, int lane) {
  constexpr int LD = D + kPad;
  const int lm_mat = lane >> 3, lm_row = lane & 7;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, &a_s[((lm_mat & 1) * 8 + lm_row) * LD + ks * 16 + (lm_mat >> 1) * 8]);
#pragma unroll
    for (int np = 0; np < kStep / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, &b_s[(np * 16 + (lm_mat >> 1) * 8 + lm_row) * LD + ks * 16 + (lm_mat & 1) * 8]);
      mma_bf16_16816(c[2 * np], a, b[0], b[1]);
      mma_bf16_16816(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// One warp, A held in registers: C[16 x kStep] += A[16, D] . B[kStep rows of b_s, D]^T
template <int D>
__device__ __forceinline__ void warp_rbt(float (&c)[kStep / 8][4], const uint32_t (&a)[D / 16][4],
                                         const __nv_bfloat16* b_s, int lane) {
  constexpr int LD = D + kPad;
  const int lm_mat = lane >> 3, lm_row = lane & 7;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < kStep / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, &b_s[(np * 16 + (lm_mat >> 1) * 8 + lm_row) * LD + ks * 16 + (lm_mat & 1) * 8]);
      mma_bf16_16816(c[2 * np], a[ks], b[0], b[1]);
      mma_bf16_16816(c[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// One warp: acc[16 x D] += P[16 x kStep] (packed A fragments) . X[kStep rows of x_s, D]
template <int D>
__device__ __forceinline__ void warp_pv(float (&acc)[D / 8][4], const uint32_t (&p)[kStep / 16][4],
                                        const __nv_bfloat16* x_s, int lane) {
  constexpr int LD = D + kPad;
  const int lm_mat = lane >> 3, lm_row = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, &x_s[(kk * 16 + (lm_mat & 1) * 8 + lm_row) * LD + dp * 16 +
                                (lm_mat >> 1) * 8]);
      mma_bf16_16816(acc[2 * dp], p[kk], b[0], b[1]);
      mma_bf16_16816(acc[2 * dp + 1], p[kk], b[2], b[3]);
    }
  }
}

// this warp's 16 rows of acc -> out rows [row0, row0 + 16) (rows >= L skipped)
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long row_stride,
                                           const float (&acc)[D / 8][4], float scale, int row0,
                                           int L, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r_lo < L) {
      *reinterpret_cast<uint32_t*>(out + (long long)r_lo * row_stride + c) =
          pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    }
    if (r_hi < L) {
      *reinterpret_cast<uint32_t*>(out + (long long)r_hi * row_stride + c) =
          pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int L,
                   Strides sq, Strides sk, Strides sv, Strides sd, Strides sx, float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int QT = kStep * LD;  // elements of one streamed Q (or dO) tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBlk][LD]
  __nv_bfloat16* Vs = Ks + kBlk * LD;                               // [kBlk][LD]
  __nv_bfloat16* Qs = Vs + kBlk * LD;                               // [2][kStep][LD]
  __nv_bfloat16* Ds = Qs + 2 * QT;                                  // [2][kStep][LD] (dO)
  float* lse_s = reinterpret_cast<float*>(Ds + 2 * QT);             // [2][kStep]
  float* del_s = lse_s + 2 * kStep;                                 // [2][kStep]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int key0 = blockIdx.x * kBlk;

  const __nv_bfloat16* qb = q + batch * sq.b + head * sq.h;
  const __nv_bfloat16* db = dout + batch * sd.b + head * sd.h;
  const float* lse_b = lse + ((long long)batch * gridDim.y + head) * L;
  const float* del_b = delta + ((long long)batch * gridDim.y + head) * L;

  load_rows_async<D>(Ks, k + batch * sk.b + head * sk.h, sk.l, key0, kBlk, L, tid);
  load_rows_async<D>(Vs, v + batch * sv.b + head * sv.h, sv.l, key0, kBlk, L, tid);

  auto load_tile = [&](int tile, int stage) {
    const int qr0 = tile * kStep;
    load_rows_async<D>(Qs + stage * QT, qb, sq.l, qr0, kStep, L, tid);
    load_rows_async<D>(Ds + stage * QT, db, sd.l, qr0, kStep, L, tid);
    cp_async_commit();
    if (tid < kStep) {  // queries beyond L: lse = +inf gives P = 0
      lse_s[stage * kStep + tid] = qr0 + tid < L ? lse_b[qr0 + tid] : CUDART_INF_F;
    } else if (tid < 2 * kStep) {
      const int i = tid - kStep;
      del_s[stage * kStep + i] = qr0 + i < L ? del_b[qr0 + i] : 0.f;
    }
  };

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dkacc[i][j] = dvacc[i][j] = 0.f;
  }

  const int n_tiles = (L + kStep - 1) / kStep;
  load_tile(0, 0);  // commits the K/V loads with the first tile
  const __nv_bfloat16* kw = Ks + warp * 16 * LD;  // this warp's 16 keys
  const __nv_bfloat16* vw = Vs + warp * 16 * LD;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qs = Qs + stage * QT;
    const __nv_bfloat16* ds = Ds + stage * QT;
    const float* ls = lse_s + stage * kStep;
    const float* dl = del_s + stage * kStep;

    // S^T = K Q^T for this warp's 16 keys x 32 queries; P^T = exp(scale S^T - lse[q])
    float p[kStep / 8][4];
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
    warp_abt<D>(p, kw, qs, lane);
    uint32_t pf[kStep / 16][4];
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) {
      const float l0 = ls[nt * 8 + 2 * t], l1 = ls[nt * 8 + 2 * t + 1];
      p[nt][0] = __expf(p[nt][0] * sm_scale - l0);
      p[nt][1] = __expf(p[nt][1] * sm_scale - l1);
      p[nt][2] = __expf(p[nt][2] * sm_scale - l0);
      p[nt][3] = __expf(p[nt][3] * sm_scale - l1);
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[nt][0], p[nt][1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[nt][2], p[nt][3]);
    }
    // dV += P^T dO
    warp_pv<D>(dvacc, pf, ds, lane);

    // dP^T = V dO^T; dS^T = P^T o (dP^T - Delta[q])
    float dp[kStep / 8][4];
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    warp_abt<D>(dp, vw, ds, lane);
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) {
      const float d0 = dl[nt * 8 + 2 * t], d1 = dl[nt * 8 + 2 * t + 1];
      pf[nt >> 1][(nt & 1) * 2 + 0] =
          pack_bf16(p[nt][0] * (dp[nt][0] - d0), p[nt][1] * (dp[nt][1] - d1));
      pf[nt >> 1][(nt & 1) * 2 + 1] =
          pack_bf16(p[nt][2] * (dp[nt][2] - d0), p[nt][3] * (dp[nt][3] - d1));
    }
    // dK += dS^T Q
    warp_pv<D>(dkacc, pf, qs, lane);
    __syncthreads();  // this stage is free for the load issued next iteration
  }

  const int kr0 = key0 + warp * 16;
  store_rows<D>(dk + batch * sx.b + head * sx.h, sx.l, dkacc, sm_scale, kr0, L, lane);
  store_rows<D>(dv + batch * sx.b + head * sx.h, sx.l, dvacc, 1.f, kr0, L, lane);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int L, Strides sq, Strides sk, Strides sv,
                 Strides sd, Strides sx, float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int KT = kStep * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kStep][LD]
  __nv_bfloat16* Vs = Ks + 2 * KT;                                  // [2][kStep][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row0 = blockIdx.x * kBlk + warp * 16;  // first query row of this warp

  const __nv_bfloat16* kb = k + batch * sk.b + head * sk.h;
  const __nv_bfloat16* vb = v + batch * sv.b + head * sv.h;

  auto load_tile = [&](int tile, int stage) {
    load_rows_async<D>(Ks + stage * KT, kb, sk.l, tile * kStep, kStep, L, tid);
    load_rows_async<D>(Vs + stage * KT, vb, sv.l, tile * kStep, kStep, L, tid);
    cp_async_commit();
  };
  const int n_tiles = (L + kStep - 1) / kStep;
  load_tile(0, 0);

  // Q and dO fragments (A operands) straight from device memory, once per block
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
  uint32_t qf[D / 16][4], df[D / 16][4];
  {
    const __nv_bfloat16* qb = q + batch * sq.b + head * sq.h;
    const __nv_bfloat16* db = dout + batch * sd.b + head * sd.h;
    const uint32_t* q_lo = reinterpret_cast<const uint32_t*>(qb + (long long)r_lo * sq.l);
    const uint32_t* q_hi = reinterpret_cast<const uint32_t*>(qb + (long long)r_hi * sq.l);
    const uint32_t* d_lo = reinterpret_cast<const uint32_t*>(db + (long long)r_lo * sd.l);
    const uint32_t* d_hi = reinterpret_cast<const uint32_t*>(db + (long long)r_hi * sd.l);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks * 8 + t;  // 32-bit word index: element ks*16 + 2t
      qf[ks][0] = r_lo < L ? q_lo[c] : 0u;
      qf[ks][1] = r_hi < L ? q_hi[c] : 0u;
      qf[ks][2] = r_lo < L ? q_lo[c + 4] : 0u;
      qf[ks][3] = r_hi < L ? q_hi[c + 4] : 0u;
      df[ks][0] = r_lo < L ? d_lo[c] : 0u;
      df[ks][1] = r_hi < L ? d_hi[c] : 0u;
      df[ks][2] = r_lo < L ? d_lo[c + 4] : 0u;
      df[ks][3] = r_hi < L ? d_hi[c + 4] : 0u;
    }
  }
  const long long bh = ((long long)batch * gridDim.y + head) * L;
  const float lse_lo = r_lo < L ? lse[bh + r_lo] : 0.f;
  const float lse_hi = r_hi < L ? lse[bh + r_hi] : 0.f;
  const float del_lo = r_lo < L ? delta[bh + r_lo] : 0.f;
  const float del_hi = r_hi < L ? delta[bh + r_hi] : 0.f;

  float dqacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dqacc[i][0] = dqacc[i][1] = dqacc[i][2] = dqacc[i][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kStep;
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = Ks + stage * KT;
    const __nv_bfloat16* vs = Vs + stage * KT;

    // S = Q K^T, P = exp(scale S - lse), keys beyond L masked to P = 0
    float p[kStep / 8][4];
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
    warp_rbt<D>(p, qf, ks, lane);
    // dP = dO V^T
    float dp[kStep / 8][4];
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    warp_rbt<D>(dp, df, vs, lane);
    uint32_t sf[kStep / 16][4];
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) {
      const int col = key0 + nt * 8 + 2 * t;
      const float p0 = col < L ? __expf(p[nt][0] * sm_scale - lse_lo) : 0.f;
      const float p1 = col + 1 < L ? __expf(p[nt][1] * sm_scale - lse_lo) : 0.f;
      const float p2 = col < L ? __expf(p[nt][2] * sm_scale - lse_hi) : 0.f;
      const float p3 = col + 1 < L ? __expf(p[nt][3] * sm_scale - lse_hi) : 0.f;
      sf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0 * (dp[nt][0] - del_lo), p1 * (dp[nt][1] - del_lo));
      sf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2 * (dp[nt][2] - del_hi), p3 * (dp[nt][3] - del_hi));
    }
    // dQ += dS K
    warp_pv<D>(dqacc, sf, ks, lane);
    __syncthreads();
  }
  store_rows<D>(dq + batch * sx.b + head * sx.h, sx.l, dqacc, sm_scale, row0, L, lane);
}

// ---------------------------------------------------------------------------
// fp32 FMA kernels
// ---------------------------------------------------------------------------
constexpr int kFThreads = 128;
constexpr int kFK = 32;  // keys per block (dkdv) / per tile (dq): one per lane
constexpr int kFQ = 8;   // queries per tile (dkdv) / per block (dq)

template <int D>
__global__ void __launch_bounds__(kFThreads)
attn_bwd_dkdv_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int L, Strides sq, Strides sk,
                  Strides sv, Strides sd, Strides sx, float sm_scale) {
  __shared__ float Ks[kFK][D + 1];  // +1: lanes read one column of 32 rows
  __shared__ float Vs[kFK][D + 1];
  __shared__ float Qs[kFQ][D];
  __shared__ float Os[kFQ][D];  // dO
  __shared__ float Ps[kFQ][kFK + 1];
  __shared__ float Ss[kFQ][kFK + 1];  // dS
  __shared__ float lse_s[kFQ], del_s[kFQ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int key0 = blockIdx.x * kFK;
  const long long bh = ((long long)batch * gridDim.y + head) * L;

  for (int idx = tid; idx < kFK * D; idx += kFThreads) {
    const int r = idx / D, c = idx % D;
    const bool live = key0 + r < L;
    Ks[r][c] = live ? k[batch * sk.b + head * sk.h + (long long)(key0 + r) * sk.l + c] : 0.f;
    Vs[r][c] = live ? v[batch * sv.b + head * sv.h + (long long)(key0 + r) * sv.l + c] : 0.f;
  }
  // this thread's accumulator slice: key akey, columns acol + 4*i
  const int akey = tid >> 2;
  const int acol = tid & 3;
  float dka[D / 4], dva[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dka[i] = dva[i] = 0.f;

  for (int qr0 = 0; qr0 < L; qr0 += kFQ) {
    __syncthreads();
    for (int idx = tid; idx < kFQ * D; idx += kFThreads) {
      const int r = idx / D, c = idx % D;
      const bool live = qr0 + r < L;
      Qs[r][c] = live ? q[batch * sq.b + head * sq.h + (long long)(qr0 + r) * sq.l + c] : 0.f;
      Os[r][c] = live ? dout[batch * sd.b + head * sd.h + (long long)(qr0 + r) * sd.l + c] : 0.f;
    }
    if (tid < kFQ) {
      lse_s[tid] = qr0 + tid < L ? lse[bh + qr0 + tid] : CUDART_INF_F;
      del_s[tid] = qr0 + tid < L ? delta[bh + qr0 + tid] : 0.f;
    }
    __syncthreads();
    // warp w owns query rows w, w + 4; lane = key within the block
#pragma unroll
    for (int rr = 0; rr < kFQ / 4; ++rr) {
      const int r = warp + 4 * rr;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        s = fmaf(Qs[r][c], Ks[lane][c], s);
        dp = fmaf(Os[r][c], Vs[lane][c], dp);
      }
      const float p = expf(s * sm_scale - lse_s[r]);
      Ps[r][lane] = p;
      Ss[r][lane] = p * (dp - del_s[r]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kFQ; ++r) {
      const float p = Ps[r][akey], ds = Ss[r][akey];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        dva[i] = fmaf(p, Os[r][acol + 4 * i], dva[i]);
        dka[i] = fmaf(ds, Qs[r][acol + 4 * i], dka[i]);
      }
    }
  }
  if (key0 + akey < L) {
    const long long off = batch * sx.b + head * sx.h + (long long)(key0 + akey) * sx.l;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      dk[off + acol + 4 * i] = dka[i] * sm_scale;
      dv[off + acol + 4 * i] = dva[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
attn_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int L, Strides sq, Strides sk, Strides sv, Strides sd,
                Strides sx, float sm_scale) {
  __shared__ float Qs[kFQ][D];
  __shared__ float Os[kFQ][D];  // dO
  __shared__ float Ks[kFK][D + 1];
  __shared__ float Vs[kFK][D + 1];
  __shared__ float Ss[kFQ][kFK + 1];  // dS
  __shared__ float lse_s[kFQ], del_s[kFQ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row0 = blockIdx.x * kFQ;
  const long long bh = ((long long)batch * gridDim.y + head) * L;

  for (int idx = tid; idx < kFQ * D; idx += kFThreads) {
    const int r = idx / D, c = idx % D;
    const bool live = row0 + r < L;
    Qs[r][c] = live ? q[batch * sq.b + head * sq.h + (long long)(row0 + r) * sq.l + c] : 0.f;
    Os[r][c] = live ? dout[batch * sd.b + head * sd.h + (long long)(row0 + r) * sd.l + c] : 0.f;
  }
  if (tid < kFQ) {
    lse_s[tid] = row0 + tid < L ? lse[bh + row0 + tid] : 0.f;
    del_s[tid] = row0 + tid < L ? delta[bh + row0 + tid] : 0.f;
  }
  // this thread's output slice: row orow, columns ocol + 16*i
  const int orow = tid >> 4;
  const int ocol = tid & 15;
  float acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i] = 0.f;

  for (int key0 = 0; key0 < L; key0 += kFK) {
    __syncthreads();
    for (int idx = tid; idx < kFK * D; idx += kFThreads) {
      const int r = idx / D, c = idx % D;
      const bool live = key0 + r < L;
      Ks[r][c] = live ? k[batch * sk.b + head * sk.h + (long long)(key0 + r) * sk.l + c] : 0.f;
      Vs[r][c] = live ? v[batch * sv.b + head * sv.h + (long long)(key0 + r) * sv.l + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kFQ / 4; ++rr) {
      const int r = warp + 4 * rr;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        s = fmaf(Qs[r][c], Ks[lane][c], s);
        dp = fmaf(Os[r][c], Vs[lane][c], dp);
      }
      const float p = key0 + lane < L ? expf(s * sm_scale - lse_s[r]) : 0.f;
      Ss[r][lane] = p * (dp - del_s[r]);
    }
    __syncthreads();
    for (int j = 0; j < kFK; ++j) {
      const float ds = Ss[orow][j];
#pragma unroll
      for (int i = 0; i < D / 16; ++i) acc[i] = fmaf(ds, Ks[j][ocol + 16 * i], acc[i]);
    }
  }
  if (row0 + orow < L) {
    float* op = dq + batch * sx.b + head * sx.h + (long long)(row0 + orow) * sx.l;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) op[ocol + 16 * i] = acc[i] * sm_scale;
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, L, H;
  Strides sq, sk, sv, so, sd, sx;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T>
int launch_delta(const Args& a, int D) {
  const long long items = (long long)a.B * a.L * a.H;
  const unsigned blocks = static_cast<unsigned>((items + kDeltaWarps - 1) / kDeltaWarps);
  attn_bwd_delta<T><<<blocks, kDeltaWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.B, a.L, a.H, D,
      a.so, a.sd);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int dtype) {
  using bf = __nv_bfloat16;
  if (dtype == 0) {
    int err = launch_delta<bf>(a, D);
    if (err != 0) return err;
    constexpr size_t smem_kv = dkdv_smem_bytes<D>();
    constexpr size_t smem_q = dq_smem_bytes<D>();
    static_assert(smem_kv <= 227 * 1024, "dkdv tiles exceed an SM's shared memory");
    static bool smem_raised = false;  // per head dim; setting it twice is harmless
    if (!smem_raised) {
      cudaError_t e = cudaFuncSetAttribute(attn_bwd_dkdv_bf16<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_kv));
      if (e != cudaSuccess) return static_cast<int>(e);
      e = cudaFuncSetAttribute(attn_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_raised = true;
    }
    dim3 grid((a.L + kBlk - 1) / kBlk, a.H, a.B);
    attn_bwd_dkdv_bf16<D><<<grid, kWarps * 32, smem_kv, a.stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
        static_cast<const bf*>(a.dout), a.lse, a.delta, static_cast<bf*>(a.dk),
        static_cast<bf*>(a.dv), a.L, a.sq, a.sk, a.sv, a.sd, a.sx, a.sm_scale);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    attn_bwd_dq_bf16<D><<<grid, kWarps * 32, smem_q, a.stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
        static_cast<const bf*>(a.dout), a.lse, a.delta, static_cast<bf*>(a.dq), a.L, a.sq, a.sk,
        a.sv, a.sd, a.sx, a.sm_scale);
  } else {
    int err = launch_delta<float>(a, D);
    if (err != 0) return err;
    dim3 grid_kv((a.L + kFK - 1) / kFK, a.H, a.B);
    attn_bwd_dkdv_fma<D><<<grid_kv, kFThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.L, a.sq, a.sk, a.sv, a.sd, a.sx,
        a.sm_scale);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    dim3 grid_q((a.L + kFQ - 1) / kFQ, a.H, a.B);
    attn_bwd_dq_fma<D><<<grid_q, kFThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.dq), a.L, a.sq, a.sk, a.sv, a.sd, a.sx, a.sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Three launches on `stream` (Delta, dK/dV, dQ).  Returns cudaGetLastError()
// after them (0 = launched), or cudaErrorInvalidValue for a head dim / dtype
// this file does not build.  lse: the forward's fp32 [B, H, L]; delta: fp32
// [B, H, L] scratch; dq, dk, dv share the strides (x_sb, x_sl, x_sh).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int L, int H, int D,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, long long d_sb, long long d_sl, long long d_sh,
    long long x_sb, long long x_sl, long long x_sh, float sm_scale, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, L, H,
               Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh}, Strides{v_sb, v_sl, v_sh},
               Strides{o_sb, o_sl, o_sh}, Strides{d_sb, d_sl, d_sh}, Strides{x_sb, x_sl, x_sh},
               sm_scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return launch<32>(a, dtype);
    case 64: return launch<64>(a, dtype);
    case 96: return launch<96>(a, dtype);
    case 128: return launch<128>(a, dtype);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
