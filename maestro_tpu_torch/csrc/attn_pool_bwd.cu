// attentive_pool_bwd: the backward of the attentive date pool (attn_pool.cu).
// For every row (b, d, l) of x [B, D, L, E], with the forward's saved out,
// m, den [B, L, *] and g = dLoss/dout [B, L, E], per head h (dh = E / H):
//   T_h    = sum_{e in h} g_e out_e              (softmax pivot, from the saved out)
//   y      = LayerNorm(x_d), k, v = y . W_kv^T   (recomputed as the forward does)
//   a_h    = exp(logit_h - m_h) / den_h,  t_h = sum_{e in h} g_e v_e
//   dlogit = a (t - T),  dv_e = a_h(e) g_e,  dk_e = dlogit_h(e) query_e dh^-1/2
//   dy     = [dk, dv] . W_kv,  dx = LayerNorm backward of dy
// Outputs: dx [B, D, L, E] in x's dtype (skipped for a null pointer), and fp32
//   d_w_kv [2E, E] = sum_rows [dk, dv]^T y,   d_query = sum_rows dlogit k dh^-1/2,
//   d_ln_scale = sum_rows dy * xhat,          d_ln_bias = sum_rows dy.
//
// Replaces the JAX package's ops/attn_pool.py _bwd_kernel (with _vjp_bwd).
// That kernel runs a sequential grid and accumulates the four parameter
// gradients in revisited output blocks.  Blocks on Hopper run in parallel and
// in no order, so here every parameter gradient is a per-block partial plus a
// fixed-order finishing sum (no atomics: the result does not depend on block
// scheduling).  Five launches:
//   A  pool_bwd_dkv<T, DH>  block = (32-row tile, head), laid out as the
//      forward kernel: LayerNorm of the tile into shared memory (bf16), the
//      head's k and v columns of y . W_kv^T on the tensor cores (W_kv through
//      a two-stage cp.async buffer), then per row a, t, T and dlogit; writes
//      the bf16 [dk, dv] rows, the tile's d_query partial, and each row's
//      LayerNorm mean and 1/std.
//   B  pool_bwd_dx<T, E>    block = 32 rows x all E columns: dy = [dk, dv] .
//      W_kv (reduction over 2E in 32-deep chunks, both operands through
//      cp.async), then the LayerNorm backward from registers (row sums over
//      the 8 warps through shared memory) -> dx, and the tile's d_ln_scale /
//      d_ln_bias partials (column sums over the tile's rows by shuffles).
//   C  pool_bwd_dw<T>       d_w_kv = [dk, dv]^T . y as a tiled product of its
//      own: [128 x 128] output tiles, split over row slices (split-K), y
//      recomputed from x and the saved statistics as the tile is staged; the
//      slices' partials are summed in order by D.
//   D, E  column_sums       fixed-order sums of the slice partials of d_w_kv
//      and of the tiles' [d_query | d_ln_scale | d_ln_bias] partials.
// A head's dy needs every head's dk and dv of the row, so the forward's
// "(row tile, head)" block cannot finish the row: A stores [dk, dv] (bf16,
// 2E per row) and B and C read it back.  At [32, 26, 128, 768] that is 327 MB
// written and read twice, about 1 GB of traffic a launch beyond the roughly
// 0.33 GB of x, dx, g and out the work needs.
//
// What bounds it on an H100: operations.  12*E*E + 8*E*H + 25*E operations a
// row (the JAX package's _bwd_cost): three products of [rows, E] x [E, 2E]
// size on the tensor cores (k/v recompute, dy, d_w_kv), against about
// 4*E bytes a row of x, dx, g and out.  A and B stream all of W_kv (2.4 MB of
// bf16 at E = 768) through shared memory once per 32-row tile, from L2, as
// the forward does; that and mma.sync (no wgmma, no TMA) keep them well above
// the bound.
//
// Precision: LayerNorm statistics, softmax, dlogit and every sum are fp32;
// products take bf16 operands (y, W_kv, [dk, dv]) with fp32 accumulation, for
// both input dtypes (fp32 x is normalized in fp32 and rounded to bf16 only as
// an operand).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

using mma::cp_async_16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16_16816;
using mma::pack_bf16;

constexpr int kRows = 32;    // rows of one tile in A and B (the partial-sum granularity)
constexpr int kRG = 2;       // 16-row groups of a tile
constexpr int kKC = 64;      // A: W_kv columns (reduction dim E) per shared chunk
constexpr int kBKC = 32;     // B: W_kv rows (reduction dim 2E) per shared chunk
constexpr int kCT = 128;     // C: output tile [f x e]
constexpr int kCK = 32;      // C: rows (reduction dim) per shared chunk
constexpr int kPad = 8;      // bf16 padding of shared rows: rows 16 bytes apart mod 128
constexpr int kMaxE = 1024;  // LayerNorm keeps a row in registers: 32 lanes x 4 x 8

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------- kernel A
template <int DH>
constexpr int kColSplits = DH % 32 == 0 ? 2 : 1;

template <int DH>
size_t dkv_smem_bytes(int E) {
  return sizeof(__nv_bfloat16) * (static_cast<size_t>(kRows) * (E + kPad) +
                                  2 * static_cast<size_t>(2 * DH) * (kKC + kPad)) +
         sizeof(float) * (3 * kRows * kColSplits<DH> + kRG * DH);
}

// T: dtype of x, out and g.  Block (tile of 32 rows, head); per 16-row group
// NH k-warps and NH v-warps, each with DH / NH of the head's k or v columns.
template <typename T, int DH>
__global__ void __launch_bounds__(kRG * 64 * kColSplits<DH>)
pool_bwd_dkv(const T* __restrict__ x, const float* __restrict__ ln_scale,
             const float* __restrict__ ln_bias, const __nv_bfloat16* __restrict__ w_kv,
             const float* __restrict__ query, const T* __restrict__ out,
             const T* __restrict__ gout, const float* __restrict__ m_in,
             const float* __restrict__ den_in, __nv_bfloat16* __restrict__ dkv,
             float* __restrict__ part, float* __restrict__ mu_out,
             float* __restrict__ rstd_out, long long n_rows, int D, int L, int E, int H,
             float eps, float sm_scale) {
  constexpr int NH = kColSplits<DH>;
  constexpr int DW = DH / NH;            // columns of this warp
  constexpr int NT = DW / 8;             // n-tiles of this warp
  constexpr int WARPS = 2 * NH * kRG;
  constexpr int THREADS = WARPS * 32;
  constexpr int LN_ROWS = kRows / WARPS;
  constexpr int WLD = kKC + kPad;
  constexpr int WSTAGE = 2 * DH * WLD;   // one W stage: the head's k rows, then its v rows
  static_assert(NT % 2 == 0, "ldmatrix.x4 feeds two n-tiles at a time");
  static_assert(kRows % WARPS == 0, "rows divide over the warps for LayerNorm");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int YLD = E + kPad;
  __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][YLD]
  __nv_bfloat16* Ws = Ys + kRows * YLD;                            // [2][2*DH][WLD]
  float* logit_s = reinterpret_cast<float*>(Ws + 2 * WSTAGE);      // [kRows][NH]
  float* t_s = logit_s + kRows * NH;                               // [kRows][NH]
  float* piv_s = t_s + kRows * NH;                                 // [kRows][NH]
  float* dq_s = piv_s + kRows * NH;                                // [kRG][DH]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int group = warp % kRG;
  const bool v_role = (warp / kRG) % 2 == 1;
  const int half = warp / (2 * kRG);
  const int head = blockIdx.y;
  const long long tile_row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int lm_mat = lane >> 3, lm_row = lane & 7;

  const int n_chunks = E / kKC;
  auto load_w_chunk = [&](int chunk, int stage) {
    constexpr int VEC_PER_ROW = kKC / 8;
    const int kc = chunk * kKC;
    __nv_bfloat16* ws = Ws + stage * WSTAGE;
    for (int idx = tid; idx < 2 * DH * VEC_PER_ROW; idx += THREADS) {
      const int n = idx / VEC_PER_ROW;
      const int c = (idx % VEC_PER_ROW) * 8;
      const int wrow = (n < DH ? 0 : E - DH) + head * DH + n;
      cp_async_16(&ws[n * WLD + c], w_kv + static_cast<long long>(wrow) * E + kc + c);
    }
    cp_async_commit();
  };
  load_w_chunk(0, 0);

  // ---- LayerNorm of LN_ROWS rows per warp -> Ys (bf16); head 0 saves the statistics
  for (int rr = 0; rr < LN_ROWS; ++rr) {
    const int r = warp * LN_ROWS + rr;
    const long long row = tile_row0 + r;
    __nv_bfloat16* yrow = Ys + r * YLD;
    if (row >= n_rows) {
      for (int c = lane * 8; c < E; c += 256) {
        *reinterpret_cast<uint4*>(yrow + c) = make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
    const T* xrow = x + row * E;
    float vals[kMaxE / 256][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxE / 256; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < E) {
        load8(xrow + c, vals[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += vals[i][j];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum / E;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxE / 256; ++i) {
      if (lane * 8 + i * 256 < E) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dlt = vals[i][j] - mu;
          sq += dlt * dlt;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rstd = rsqrtf(sq / E + eps);
    if (head == 0 && lane == 0) {
      mu_out[row] = mu;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int i = 0; i < kMaxE / 256; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < E) {
        float sc[8], bi[8];
        load8(ln_scale + c, sc);
        load8(ln_bias + c, bi);
        uint4 packed;
        uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pw[j] = pack_bf16((vals[i][2 * j] - mu) * rstd * sc[2 * j] + bi[2 * j],
                            (vals[i][2 * j + 1] - mu) * rstd * sc[2 * j + 1] + bi[2 * j + 1]);
        }
        *reinterpret_cast<uint4*>(yrow + c) = packed;
      }
    }
  }

  // ---- this warp's DW columns (of k or of v) of Ys . W_head^T, over E in chunks
  float f[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) f[nt][0] = f[nt][1] = f[nt][2] = f[nt][3] = 0.f;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int stage = chunk & 1;
    if (chunk + 1 < n_chunks) {
      load_w_chunk(chunk + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk visible to all; on the first chunk, Ys too
    const int kc = chunk * kKC;
    const __nv_bfloat16* ws = Ws + stage * WSTAGE + ((v_role ? DH : 0) + half * DW) * WLD;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, &Ys[(group * 16 + (lm_mat & 1) * 8 + lm_row) * YLD + kc + ks * 16 +
                         (lm_mat >> 1) * 8]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, &ws[(np * 16 + (lm_mat >> 1) * 8 + lm_row) * WLD + ks * 16 +
                             (lm_mat & 1) * 8]);
        mma_bf16_16816(f[2 * np], a, bfr[0], bfr[1]);
        mma_bf16_16816(f[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this stage is free for the chunk after next
  }

  // ---- per row: partial logits (k-warps), partial t and T (v-warps)
  const long long r_lo = tile_row0 + group * 16 + g, r_hi = r_lo + 8;
  const bool ok_lo = r_lo < n_rows, ok_hi = r_hi < n_rows;
  const long long per_b = static_cast<long long>(D) * L;
  // (b, l) row of out, g, m and den for a row (b, d, l) of x
  const long long p_lo = ok_lo ? (r_lo / per_b) * L + r_lo % L : 0;
  const long long p_hi = ok_hi ? (r_hi / per_b) * L + r_hi % L : 0;
  const int col0 = head * DH + half * DW;  // first of this warp's columns within k (or v)
  float gv[NT][4];  // v-warps: g at their (row, column) pairs
  float qv[NT][2];  // k-warps: the query at their columns
  if (v_role) {
    float t_lo = 0.f, t_hi = 0.f, pv_lo = 0.f, pv_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + nt * 8 + 2 * t;
      float2 glo = make_float2(0.f, 0.f), ghi = glo, olo = glo, ohi = glo;
      if (ok_lo) {
        glo = load2(gout + p_lo * E + c);
        olo = load2(out + p_lo * E + c);
      }
      if (ok_hi) {
        ghi = load2(gout + p_hi * E + c);
        ohi = load2(out + p_hi * E + c);
      }
      gv[nt][0] = glo.x; gv[nt][1] = glo.y; gv[nt][2] = ghi.x; gv[nt][3] = ghi.y;
      t_lo += f[nt][0] * glo.x + f[nt][1] * glo.y;
      t_hi += f[nt][2] * ghi.x + f[nt][3] * ghi.y;
      pv_lo += olo.x * glo.x + olo.y * glo.y;
      pv_hi += ohi.x * ghi.x + ohi.y * ghi.y;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      t_lo += __shfl_xor_sync(0xffffffffu, t_lo, off);
      t_hi += __shfl_xor_sync(0xffffffffu, t_hi, off);
      pv_lo += __shfl_xor_sync(0xffffffffu, pv_lo, off);
      pv_hi += __shfl_xor_sync(0xffffffffu, pv_hi, off);
    }
    if (t == 0) {
      t_s[(group * 16 + g) * NH + half] = t_lo;
      t_s[(group * 16 + g + 8) * NH + half] = t_hi;
      piv_s[(group * 16 + g) * NH + half] = pv_lo;
      piv_s[(group * 16 + g + 8) * NH + half] = pv_hi;
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      qv[nt][0] = query[col0 + nt * 8 + 2 * t];
      qv[nt][1] = query[col0 + nt * 8 + 2 * t + 1];
    }
    float lg_lo = 0.f, lg_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      lg_lo += f[nt][0] * qv[nt][0] + f[nt][1] * qv[nt][1];
      lg_hi += f[nt][2] * qv[nt][0] + f[nt][3] * qv[nt][1];
    }
    lg_lo += __shfl_xor_sync(0xffffffffu, lg_lo, 1);
    lg_lo += __shfl_xor_sync(0xffffffffu, lg_lo, 2);
    lg_hi += __shfl_xor_sync(0xffffffffu, lg_hi, 1);
    lg_hi += __shfl_xor_sync(0xffffffffu, lg_hi, 2);
    if (t == 0) {
      logit_s[(group * 16 + g) * NH + half] = lg_lo;
      logit_s[(group * 16 + g + 8) * NH + half] = lg_hi;
    }
  }
  __syncthreads();

  // ---- softmax weight and dlogit of rows g, g + 8 (every warp of the group)
  float lg_lo = 0.f, lg_hi = 0.f, tt_lo = 0.f, tt_hi = 0.f, pv_lo = 0.f, pv_hi = 0.f;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    lg_lo += logit_s[(group * 16 + g) * NH + hh];
    lg_hi += logit_s[(group * 16 + g + 8) * NH + hh];
    tt_lo += t_s[(group * 16 + g) * NH + hh];
    tt_hi += t_s[(group * 16 + g + 8) * NH + hh];
    pv_lo += piv_s[(group * 16 + g) * NH + hh];
    pv_hi += piv_s[(group * 16 + g + 8) * NH + hh];
  }
  float a_lo = 0.f, a_hi = 0.f;
  if (ok_lo) a_lo = expf(lg_lo * sm_scale - m_in[p_lo * H + head]) / den_in[p_lo * H + head];
  if (ok_hi) a_hi = expf(lg_hi * sm_scale - m_in[p_hi * H + head]) / den_in[p_hi * H + head];
  const float dl_lo = a_lo * (tt_lo - pv_lo), dl_hi = a_hi * (tt_hi - pv_hi);

  const long long E2 = 2LL * E;
  if (v_role) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = E + col0 + nt * 8 + 2 * t;
      if (ok_lo) store2(dkv + r_lo * E2 + c, a_lo * gv[nt][0], a_lo * gv[nt][1]);
      if (ok_hi) store2(dkv + r_hi * E2 + c, a_hi * gv[nt][2], a_hi * gv[nt][3]);
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + nt * 8 + 2 * t;
      if (ok_lo) {
        store2(dkv + r_lo * E2 + c, dl_lo * qv[nt][0] * sm_scale, dl_lo * qv[nt][1] * sm_scale);
      }
      if (ok_hi) {
        store2(dkv + r_hi * E2 + c, dl_hi * qv[nt][0] * sm_scale, dl_hi * qv[nt][1] * sm_scale);
      }
      // d_query: column sums of dlogit * k over the group's rows
      float s0 = dl_lo * f[nt][0] + dl_hi * f[nt][2];
      float s1 = dl_lo * f[nt][1] + dl_hi * f[nt][3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (g == 0) {
        dq_s[group * DH + half * DW + nt * 8 + 2 * t] = s0;
        dq_s[group * DH + half * DW + nt * 8 + 2 * t + 1] = s1;
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < DH; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int gr = 0; gr < kRG; ++gr) s += dq_s[gr * DH + c];
    part[static_cast<long long>(blockIdx.x) * 3 * E + head * DH + c] = s * sm_scale;
  }
}

// ---------------------------------------------------------------- kernel B
constexpr int kBWarps = 8;

template <int E>
constexpr size_t dx_smem_bytes() {
  return sizeof(__nv_bfloat16) * 2 * (static_cast<size_t>(kRows) * (kBKC + kPad) +
                                      static_cast<size_t>(kBKC) * (E + kPad)) +
         sizeof(float) * 2 * kBWarps * kRows;
}

// Block: 32 rows x all E columns; warp w owns columns [w E/8, (w+1) E/8) of
// both 16-row groups.
template <typename T, int E>
__global__ void __launch_bounds__(kBWarps * 32)
pool_bwd_dx(const T* __restrict__ x, const float* __restrict__ ln_scale,
            const __nv_bfloat16* __restrict__ w_kv, const __nv_bfloat16* __restrict__ dkv,
            const float* __restrict__ mu, const float* __restrict__ rstd, T* __restrict__ dx,
            float* __restrict__ part, long long n_rows) {
  constexpr int CW = E / kBWarps;
  constexpr int NT = CW / 8;
  constexpr int ALD = kBKC + kPad;
  constexpr int WLD = E + kPad;
  constexpr int ASTAGE = kRows * ALD;
  constexpr int WSTAGE = kBKC * WLD;
  constexpr int THREADS = kBWarps * 32;
  static_assert(NT % 2 == 0, "ldmatrix.x4 feeds two n-tiles at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kRows][ALD]
  __nv_bfloat16* Ws = As + 2 * ASTAGE;                             // [2][kBKC][WLD]
  float* red = reinterpret_cast<float*>(Ws + 2 * WSTAGE);          // [2][kBWarps][kRows]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lm_mat = lane >> 3, lm_row = lane & 7;
  const long long tile_row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long E2 = 2LL * E;

  auto load_stage = [&](int chunk, int stage) {
    const int kc = chunk * kBKC;
    // [dk, dv] rows (past the last row: the last row again, masked below)
    for (int idx = tid; idx < kRows * (kBKC / 8); idx += THREADS) {
      const int r = idx / (kBKC / 8);
      const int c = (idx % (kBKC / 8)) * 8;
      long long row = tile_row0 + r;
      if (row >= n_rows) row = n_rows - 1;
      cp_async_16(&As[stage * ASTAGE + r * ALD + c], dkv + row * E2 + kc + c);
    }
    for (int idx = tid; idx < kBKC * (E / 8); idx += THREADS) {
      const int kk = idx / (E / 8);
      const int c = (idx % (E / 8)) * 8;
      cp_async_16(&Ws[stage * WSTAGE + kk * WLD + c],
                  w_kv + static_cast<long long>(kc + kk) * E + c);
    }
    cp_async_commit();
  };

  float acc[kRG][NT][4];
#pragma unroll
  for (int rg = 0; rg < kRG; ++rg)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[rg][nt][0] = acc[rg][nt][1] = acc[rg][nt][2] = acc[rg][nt][3] = 0.f;

  const int n_chunks = 2 * E / kBKC;
  load_stage(0, 0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int stage = chunk & 1;
    if (chunk + 1 < n_chunks) {
      load_stage(chunk + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = As + stage * ASTAGE;
    const __nv_bfloat16* ws = Ws + stage * WSTAGE + warp * CW;
#pragma unroll
    for (int ks = 0; ks < kBKC / 16; ++ks) {
      uint32_t a[kRG][4];
#pragma unroll
      for (int rg = 0; rg < kRG; ++rg) {
        ldmatrix_x4(a[rg], &as[(rg * 16 + (lm_mat & 1) * 8 + lm_row) * ALD + ks * 16 +
                               (lm_mat >> 1) * 8]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // B[k][n] = W_kv[kc + k][col]: rows are k, so transposed fragments
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, &ws[(ks * 16 + (lm_mat & 1) * 8 + lm_row) * WLD + np * 16 +
                                   (lm_mat >> 1) * 8]);
#pragma unroll
        for (int rg = 0; rg < kRG; ++rg) {
          mma_bf16_16816(acc[rg][2 * np], a[rg], bfr[0], bfr[1]);
          mma_bf16_16816(acc[rg][2 * np + 1], a[rg], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  // ---- LayerNorm backward.  acc[rg][nt] holds dy of rows rg*16 + g (0, 1)
  // and rg*16 + g + 8 (2, 3), columns warp*CW + nt*8 + 2t, +1.
  float mu_r[kRG][2], rs_r[kRG][2], s1[kRG][2], s2[kRG][2];
  bool ok[kRG][2];
#pragma unroll
  for (int rg = 0; rg < kRG; ++rg) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const long long row = tile_row0 + rg * 16 + hi * 8 + g;
      ok[rg][hi] = row < n_rows;
      mu_r[rg][hi] = ok[rg][hi] ? mu[row] : 0.f;
      rs_r[rg][hi] = ok[rg][hi] ? rstd[row] : 0.f;
      s1[rg][hi] = s2[rg][hi] = 0.f;
      if (!ok[rg][hi]) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[rg][nt][2 * hi] = acc[rg][nt][2 * hi + 1] = 0.f;
      }
    }
  }
  float* part_row = part + static_cast<long long>(blockIdx.x) * 3 * E;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = warp * CW + nt * 8 + 2 * t;
    const float sc0 = ln_scale[c], sc1 = ln_scale[c + 1];
    float ds0 = 0.f, ds1 = 0.f, db0 = 0.f, db1 = 0.f;
#pragma unroll
    for (int rg = 0; rg < kRG; ++rg) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        if (!ok[rg][hi]) continue;
        const long long row = tile_row0 + rg * 16 + hi * 8 + g;
        const float2 xv = load2(x + row * E + c);
        const float xh0 = (xv.x - mu_r[rg][hi]) * rs_r[rg][hi];
        const float xh1 = (xv.y - mu_r[rg][hi]) * rs_r[rg][hi];
        const float dy0 = acc[rg][nt][2 * hi], dy1 = acc[rg][nt][2 * hi + 1];
        ds0 += dy0 * xh0;
        ds1 += dy1 * xh1;
        db0 += dy0;
        db1 += dy1;
        s1[rg][hi] += dy0 * sc0 + dy1 * sc1;
        s2[rg][hi] += dy0 * sc0 * xh0 + dy1 * sc1 * xh1;
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      ds0 += __shfl_xor_sync(0xffffffffu, ds0, off);
      ds1 += __shfl_xor_sync(0xffffffffu, ds1, off);
      db0 += __shfl_xor_sync(0xffffffffu, db0, off);
      db1 += __shfl_xor_sync(0xffffffffu, db1, off);
    }
    if (g == 0) {
      part_row[E + c] = ds0;
      part_row[E + c + 1] = ds1;
      part_row[2 * E + c] = db0;
      part_row[2 * E + c + 1] = db1;
    }
  }
  if (dx == nullptr) return;
  // row sums: over the 4 lanes of a row, then over the 8 warps in order
#pragma unroll
  for (int rg = 0; rg < kRG; ++rg) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s1[rg][hi] += __shfl_xor_sync(0xffffffffu, s1[rg][hi], off);
        s2[rg][hi] += __shfl_xor_sync(0xffffffffu, s2[rg][hi], off);
      }
      if (t == 0) {
        red[warp * kRows + rg * 16 + hi * 8 + g] = s1[rg][hi];
        red[(kBWarps + warp) * kRows + rg * 16 + hi * 8 + g] = s2[rg][hi];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int rg = 0; rg < kRG; ++rg) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      if (!ok[rg][hi]) continue;
      const int r = rg * 16 + hi * 8 + g;
      float tot1 = 0.f, tot2 = 0.f;
#pragma unroll
      for (int w = 0; w < kBWarps; ++w) {
        tot1 += red[w * kRows + r];
        tot2 += red[(kBWarps + w) * kRows + r];
      }
      const float mean1 = tot1 / E, mean2 = tot2 / E;
      const long long row = tile_row0 + r;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = warp * CW + nt * 8 + 2 * t;
        const float2 xv = load2(x + row * E + c);
        const float xh0 = (xv.x - mu_r[rg][hi]) * rs_r[rg][hi];
        const float xh1 = (xv.y - mu_r[rg][hi]) * rs_r[rg][hi];
        const float dxh0 = acc[rg][nt][2 * hi] * ln_scale[c];
        const float dxh1 = acc[rg][nt][2 * hi + 1] * ln_scale[c + 1];
        store2(dx + row * E + c, rs_r[rg][hi] * (dxh0 - mean1 - xh0 * mean2),
               rs_r[rg][hi] * (dxh1 - mean1 - xh1 * mean2));
      }
    }
  }
}

// ---------------------------------------------------------------- kernel C
// d_w_kv[f, e] = sum over rows n of dkv[n, f] * y[n, e], rows [begin, end) of
// one slice.  Block: output tile f in [m0, m0 + 128), e in [n0, n0 + 128);
// 8 warps as 4 (f) x 2 (e), each [32 x 64].
template <typename T>
__global__ void __launch_bounds__(256)
pool_bwd_dw(const T* __restrict__ x, const float* __restrict__ ln_scale,
            const float* __restrict__ ln_bias, const __nv_bfloat16* __restrict__ dkv,
            const float* __restrict__ mu, const float* __restrict__ rstd,
            float* __restrict__ dw_part, long long n_rows, int E, long long rows_per_split) {
  constexpr int LD = kCT + kPad;
  __shared__ __align__(16) __nv_bfloat16 As[2][kCK][LD];  // [dk, dv] chunk: [row][f]
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kCK][LD];  // y chunk: [row][e]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lm_mat = lane >> 3, lm_row = lane & 7;
  const int wm = warp % 4, wn = warp / 4;
  const int n0 = blockIdx.x * kCT;  // e
  const int m0 = blockIdx.y * kCT;  // f
  const long long begin = static_cast<long long>(blockIdx.z) * rows_per_split;
  const long long end = begin + rows_per_split < n_rows ? begin + rows_per_split : n_rows;
  const long long E2 = 2LL * E;

  auto load_stage = [&](long long k0, int stage) {
    for (int idx = tid; idx < kCK * (kCT / 8); idx += 256) {
      const int kk = idx / (kCT / 8);
      const int c = (idx % (kCT / 8)) * 8;
      const long long row = k0 + kk;
      __nv_bfloat16* dst = &As[stage][kk][c];
      if (row < end) {
        cp_async_16(dst, dkv + row * E2 + m0 + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
    for (int idx = tid; idx < kCK * (kCT / 8); idx += 256) {
      const int kk = idx / (kCT / 8);
      const int c = (idx % (kCT / 8)) * 8;
      const long long row = k0 + kk;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (row < end) {
        float v[8], sc[8], bi[8];
        load8(x + row * E + n0 + c, v);
        load8(ln_scale + n0 + c, sc);
        load8(ln_bias + n0 + c, bi);
        const float mr = mu[row], rs = rstd[row];
        uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pw[j] = pack_bf16((v[2 * j] - mr) * rs * sc[2 * j] + bi[2 * j],
                            (v[2 * j + 1] - mr) * rs * sc[2 * j + 1] + bi[2 * j + 1]);
        }
      }
      *reinterpret_cast<uint4*>(&Bs[stage][kk][c]) = packed;
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const long long n_chunks = end > begin ? (end - begin + kCK - 1) / kCK : 0;
  if (n_chunks > 0) load_stage(begin, 0);
  for (long long chunk = 0; chunk < n_chunks; ++chunk) {
    const int stage = static_cast<int>(chunk & 1);
    if (chunk + 1 < n_chunks) {
      load_stage(begin + (chunk + 1) * kCK, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kCK / 16; ++ks) {
      // A[m = f][k = row] = As[row][f]: rows of As are k, so transposed fragments
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldmatrix_x4_trans(a[mt], &As[stage][ks * 16 + (lm_mat >> 1) * 8 + lm_row]
                                    [wm * 32 + mt * 16 + (lm_mat & 1) * 8]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, &Bs[stage][ks * 16 + (lm_mat & 1) * 8 + lm_row]
                                  [wn * 64 + np * 16 + (lm_mat >> 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], a[mt], bfr[0], bfr[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], a[mt], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  float* dst = dw_part + static_cast<long long>(blockIdx.z) * E2 * E;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const long long f = m0 + wm * 32 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int e = n0 + wn * 64 + nt * 8 + 2 * t;
      store2(dst + f * E + e, acc[mt][nt][0], acc[mt][nt][1]);
      store2(dst + (f + 8) * E + e, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// ---------------------------------------------------------------- D, E
// out[c] = sum over r of part[r][c], in a fixed order: lane row y sums rows
// y, y + blockDim.y, ...; then row 0 of the block adds the lanes in order.
__global__ void column_sums(const float* __restrict__ part, long long rows, long long cols,
                            float* __restrict__ out) {
  extern __shared__ float red_cols[];  // [blockDim.y][blockDim.x]
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (c < cols) {
    for (long long r = threadIdx.y; r < rows; r += blockDim.y) s += part[r * cols + c];
  }
  red_cols[threadIdx.y * blockDim.x + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float tot = 0.f;
    for (int j = 0; j < static_cast<int>(blockDim.y); ++j) tot += red_cols[j * blockDim.x + threadIdx.x];
    out[c] = tot;
  }
}

int launch_column_sums(const float* part, long long rows, long long cols, float* out,
                       int lanes_x, int lanes_y, cudaStream_t stream) {
  const dim3 block(lanes_x, lanes_y);
  const dim3 grid(static_cast<unsigned>((cols + lanes_x - 1) / lanes_x));
  column_sums<<<grid, block, sizeof(float) * lanes_x * lanes_y, stream>>>(part, rows, cols, out);
  return static_cast<int>(cudaGetLastError());
}

struct BwdArgs {
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const __nv_bfloat16* w_kv;
  const float* query;
  const void* out;
  const void* g;
  const float* m;
  const float* den;
  void* dx;
  __nv_bfloat16* dkv;
  float* mu;
  float* rstd;
  float* part_small;
  float* dw_part;
  float* dw;
  float* small_out;
  int B, D, L, E, H;
  float eps;
  int splits;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch_dkv(const BwdArgs& a, long long n_rows) {
  const size_t smem = dkv_smem_bytes<DH>(a.E);
  auto kernel = pool_bwd_dkv<T, DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows), a.H);
  kernel<<<grid, kRG * 64 * kColSplits<DH>, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.ln_scale, a.ln_bias, a.w_kv, a.query,
      static_cast<const T*>(a.out), static_cast<const T*>(a.g), a.m, a.den, a.dkv,
      a.part_small, a.mu, a.rstd, n_rows, a.D, a.L, a.E, a.H, a.eps,
      1.0f / sqrtf(static_cast<float>(DH)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_dx(const BwdArgs& a, long long n_rows) {
  constexpr size_t smem = dx_smem_bytes<E>();
  auto kernel = pool_bwd_dx<T, E>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows));
  kernel<<<grid, kBWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.ln_scale, a.w_kv, a.dkv, a.mu, a.rstd,
      static_cast<T*>(a.dx), a.part_small, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const BwdArgs& a) {
  const long long n_rows = static_cast<long long>(a.B) * a.D * a.L;
  int err;
  switch (a.E / a.H) {
    case 16: err = launch_dkv<T, 16>(a, n_rows); break;
    case 48: err = launch_dkv<T, 48>(a, n_rows); break;
    case 96: err = launch_dkv<T, 96>(a, n_rows); break;
    case 128: err = launch_dkv<T, 128>(a, n_rows); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  switch (a.E) {
    case 128: err = launch_dx<T, 128>(a, n_rows); break;
    case 384: err = launch_dx<T, 384>(a, n_rows); break;
    case 768: err = launch_dx<T, 768>(a, n_rows); break;
    case 1024: err = launch_dx<T, 1024>(a, n_rows); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  long long rows_per_split = (n_rows + a.splits - 1) / a.splits;
  rows_per_split = (rows_per_split + kCK - 1) / kCK * kCK;
  float* dw_dst = a.splits > 1 ? a.dw_part : a.dw;
  const dim3 grid(a.E / kCT, 2 * a.E / kCT, a.splits);
  pool_bwd_dw<T><<<grid, 256, 0, a.stream>>>(static_cast<const T*>(a.x), a.ln_scale,
                                             a.ln_bias, a.dkv, a.mu, a.rstd, dw_dst, n_rows,
                                             a.E, rows_per_split);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (a.splits > 1) {
    err = launch_column_sums(a.dw_part, a.splits, 2LL * a.E * a.E, a.dw, 256, 1, a.stream);
    if (err != 0) return err;
  }
  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  return launch_column_sums(a.part_small, n_tiles, 3LL * a.E, a.small_out, 32, 32, a.stream);
}

}  // namespace

// x [B, D, L, E], out and g [B, L, E] contiguous in one dtype (0 = bf16,
// 1 = fp32); ln_scale, ln_bias, query fp32 [E]; w_kv bf16 [2E, E]; m, den fp32
// [B, L, H].  dx (or null) like x.  Scratch: dkv bf16 [B*D*L, 2E]; mu, rstd fp32
// [B*D*L]; part_small fp32 [ceil(B*D*L / 32), 3E]; dw_part fp32 [splits, 2E, E]
// (unused when splits == 1).  Outputs: dw fp32 [2E, E]; small_out fp32 [3E] =
// d_query | d_ln_scale | d_ln_bias.  Returns cudaGetLastError() after the last
// launch that failed or the last one, or cudaErrorInvalidValue for a shape
// this file does not build.
extern "C" int attentive_pool_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w_kv, const void* query, const void* out,
                                  const void* g, const void* m, const void* den, void* dx,
                                  void* dkv, void* mu, void* rstd, void* part_small,
                                  void* dw_part, void* dw, void* small_out, int B, int D,
                                  int L, int E, int H, float eps, int splits, int dtype,
                                  void* stream) {
  if (H < 1 || E % H != 0 || E % kCT != 0 || E > kMaxE || B < 1 || D < 1 || L < 1 ||
      splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{x,
                  static_cast<const float*>(ln_scale),
                  static_cast<const float*>(ln_bias),
                  static_cast<const __nv_bfloat16*>(w_kv),
                  static_cast<const float*>(query),
                  out,
                  g,
                  static_cast<const float*>(m),
                  static_cast<const float*>(den),
                  dx,
                  static_cast<__nv_bfloat16*>(dkv),
                  static_cast<float*>(mu),
                  static_cast<float*>(rstd),
                  static_cast<float*>(part_small),
                  static_cast<float*>(dw_part),
                  static_cast<float*>(dw),
                  static_cast<float*>(small_out),
                  B, D, L, E, H, eps, splits,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return run<__nv_bfloat16>(a);
  if (dtype == 1) return run<float>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
