// attentive_pool_bwd: the backward of the attentive date pool (attn_pool.cu).
// For every position (b, l) of x [B, D, L, E], with the forward's saved out,
// m, den [B, L, *] and g = dLoss/dout [B, L, E], per head h (dh = E / H,
// s = dh^-1/2, y_d = LayerNorm(x_d), u_h and ybar_h as in pool_common.cuh):
//   dybar_h  = W_v,h^T g_h,   T_h = g_h . out_h          (the softmax pivot)
//   a_dh     = exp(s y_d . u_h - m_h) / den_h,  da_dh = dybar_h . y_d
//   dlogit   = a (da - T)
//   dy_d     = sum_h (a_dh dybar_h + s dlogit_dh u_h),  dx = LayerNorm backward of dy
//   du_h     = s sum dlogit_h y,   dW_k[j] = q_j du_h(j),   d_query_j = W_k[j] . du_h(j)
//   dW_v,h   = sum_positions g_h (x) ybar_h
//   d_ln_scale = sum dy * xhat,    d_ln_bias = sum dy
// Outputs: dx [B, D, L, E] in x's dtype (skipped for a null pointer), fp32
// d_w_kv [2E, E], d_query [E], d_ln_scale [E] and d_ln_bias [E].
//
// Replaces the JAX package's ops/attn_pool.py _bwd_kernel (with _vjp_bwd).
// That kernel recomputes the kv projection of every row and forms dy and
// d_w_kv as products over [dk, dv] rows: 12*E^2 operations a row.  Here the
// factored form needs about 12*E*H + 21*E fp32 operations a row and two
// [E x E] products a position, in six launches (no atomics: every sum runs
// in a fixed order, so two calls on the same inputs give the same bits):
//   1 pool_u            u [H, E], as in the forward.
//   2 pool_mma          dybar [B*L, H, E] fp32 = g_h . W_v,h on the tensor
//                       cores (M = B*L, N = E, K = dh per head).
//   3 pool_bwd_rows     one block per run of positions, kCols columns of E
//                       a thread; per position T and dybar into shared
//                       memory, then the dates in steps of kDC: x read once
//                       (cp.async a step ahead), LayerNorm statistics (fp64
//                       sums), xhat and y, one block reduction of the logits,
//                       da = y . dybar_h, T on a position's first step and
//                       the next step's LayerNorm sums, a from the saved m
//                       and den, dlogit, dy; a second reduction for the
//                       LayerNorm backward into dx (skipped without dx).
//                       Every warp finalizes the reductions itself, so a
//                       step has one barrier a reduction.  du and ybar
//                       accumulate in shared memory, d_ln_scale and
//                       d_ln_bias in registers (each thread its own columns);
//                       writes ybar (bf16, the operand of launch 4) and the
//                       block's du | d_ln_scale | d_ln_bias partial.  Bound by
//                       its fp32 work (12*E*H + 21*E a row at 67 TFLOP/s);
//                       x is read and dx written once.  Its four [H, E] fp32
//                       arrays (u, dybar, ybar, du) take 96 KB of shared
//                       memory at E = 768, so two blocks (6 warps) share an
//                       SM; with 4 columns a thread (12 warps) it measured
//                       slower: its instruction count holds it back.
//   4 pool_mma          dW_v partials = G_h^T . ybar_h (M = dh, N = E, K =
//                       B*L split into `splits` slices).
//   5 column_sums       the blocks' partials of launch 3, summed in order.
//   6 pool_bwd_finish   dW_k and d_query from du (the rank-1 terms), and
//                       dW_v as the in-order sum of launch 4's slices.
// No [dk, dv] row of the kv projection's gradient is formed (2E a row, 327 MB
// of bf16 at [32, 26, 128, 768]), and no product runs over every (batch,
// date, position) row.
//
// Precision: logits, softmax, u, dybar, da, dlogit, du and every sum are fp32;
// the LayerNorm statistics, xhat and y as in the forward (fp64 sums, the
// plain version's order of operations, y rounded to x's dtype); W_kv is bf16;
// the tensor-core operands are bf16: g (rounded for fp32 x) and ybar, with
// fp32 accumulation.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include "pool_common.cuh"

namespace {

using pool::bf16;
using pool::kDC;
using pool::kMaxHeads;

constexpr int kCols = 8;     // columns of E a thread owns
constexpr int kStages = 2;   // x of this step and of the next (a thread's own columns)
constexpr int kWarps = pool::kMaxWarps<kCols>;
constexpr int kVL = kDC * kMaxHeads;   // logits (then da) of a step, one (date, head) a lane
constexpr int kV12 = 2 * kDC;          // LayerNorm sums of the next step (fp64)
constexpr int kVR = 2 * kVL + kMaxHeads;  // a warp's row: logits, da, T
constexpr int kV4 = 2 * kDC;           // LayerNorm backward sums of a step
// a warp's own finalized values: a, dlogit [kMaxHeads][kDC], the next step's
// mu, rstd [kDC], this step's LayerNorm backward means c1, c2 [kDC]
constexpr int kFA = 0, kFDl = kFA + kVL, kFMu = kFDl + kVL, kFRstd = kFMu + kDC,
              kFC1 = kFRstd + kDC, kFC2 = kFC1 + kDC, kWF = kFC2 + kDC;
static_assert(kVL == 32, "the finalize gives each lane of a warp one (date, head)");

// floats before the x stages (a multiple of 4: the stages start 16-byte aligned)
__host__ __device__ int bwd_rows_floats(int E) {
  return 4 * kMaxHeads * E + 2 * kWarps * kV12 * 2 + 2 * kWarps * kVR + kWarps * kV4 + kWarps * kWF;
}

size_t bwd_rows_smem(int E, size_t elem) {
  return sizeof(float) * bwd_rows_floats(E) + elem * kStages * kDC * E;
}

// One block per run of positions; a step is kDC dates of one position.
// Iteration s: xhat and y of step s from its statistics; the partials of its
// logits and da, of the LayerNorm sums of step s + 1 and, on a position's
// first step, of the pivot T; one barrier, after which every warp finalizes
// a and dlogit of step s and the statistics of step s + 1 itself; dy and the
// accumulations; with dx, the LayerNorm backward sums, a second barrier and
// dx.
template <typename T>
__global__ void __launch_bounds__(pool::kMaxThreads<kCols>)
pool_bwd_rows(const T* __restrict__ x, const float* __restrict__ ln_scale,
              const float* __restrict__ ln_bias, const float* __restrict__ u,
              const T* __restrict__ out, const T* __restrict__ g, const float* __restrict__ m,
              const float* __restrict__ den, const float* __restrict__ dybar, T* __restrict__ dx,
              bf16* __restrict__ ybar, float* __restrict__ part, long long n_pos, int D, int L,
              int E, int H, int dh, float eps, float sm_scale, long long per_block) {
  extern __shared__ __align__(16) float smem[];
  // [kMaxHeads][E] each; a thread reads and writes only its own columns
  float* sU = smem;
  float* sDY = sU + kMaxHeads * E;        // this position's dybar
  float* sYB = sDY + kMaxHeads * E;       // this position's ybar
  float* sDU = sYB + kMaxHeads * E;       // the block's du
  // partial totals by step parity: LayerNorm sums [2][warps][kV12], the rest [2][warps][kVR]
  double* red_ln = reinterpret_cast<double*>(sDU + kMaxHeads * E);
  float* red = reinterpret_cast<float*>(red_ln + 2 * kWarps * kV12);
  float* red4 = red + 2 * kWarps * kVR;   // [warps][kV4]
  float* wf = red4 + kWarps * kV4;        // [warps][kWF]
  const pool::XStages<T, kCols> xs{reinterpret_cast<T*>(smem + bwd_rows_floats(E))};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const int c0 = tid * kCols;
  const bool active = c0 < E;
  const int head_c = c0 / dh;  // the head of this thread's columns (dh is a multiple of kCols)
  const float inv_e = 1.f / static_cast<float>(E);  // the LayerNorm backward's means
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  wf += warp * kWF;
  float gam[kCols] = {}, bet[kCols] = {};
  if (active) {
    pool::loadN<kCols>(ln_scale + c0, gam);
    pool::loadN<kCols>(ln_bias + c0, bet);
#pragma unroll
    for (int i = 0; i < kMaxHeads * kCols; i += 4) {
      const int o = (i / kCols) * E + c0 + i % kCols;
      *reinterpret_cast<float4*>(sU + o) = *reinterpret_cast<const float4*>(u + o);
      *reinterpret_cast<float4*>(sDY + o) = zero4;
      *reinterpret_cast<float4*>(sDU + o) = zero4;
    }
  }
  float dsc[kCols] = {}, dbi[kCols] = {};

  const long long date_step = static_cast<long long>(L) * E;
  const long long p_begin = blockIdx.x * per_block;
  const long long p_end = min(n_pos, p_begin + per_block);
  const int steps_per_pos = (D + kDC - 1) / kDC;
  const long long n_steps = (p_end - p_begin) * steps_per_pos;
  // x of step s lands in stage s % 2, copied a step ahead; `ahead` is two steps on
  pool::Cursor at(p_begin, L), ahead(p_begin, L);
  for (int s = 0; s < kStages; ++s) {
    if (s < n_steps) xs.issue(x, ahead, s, D, L, E, c0, active);
    mma::cp_async_commit();
    ahead.advance(D, L);
  }
  mma::cp_async_wait<0>();
  {  // step 0's statistics, through the parity-1 partials (step 0 writes parity 0)
    double part12[kV12];
    pool::ln_partials(xs, 0, E, c0, active, part12);
    double* r1 = red_ln + kWarps * kV12;
    pool::warp_totals<kV12>(part12, r1 + warp * kV12, lane);
    __syncthreads();
    pool::ln_finalize<kWarps>(r1, kV12, warps, lane, E, eps, wf + kFMu, wf + kFRstd);
    __syncwarp();
  }
  // lane (r, h) of every warp: head h's softmax statistics and pivot at this position
  float m_h = 0.f, den_h = 1.f, t_h = 0.f;

  for (long long step = 0; step < n_steps; ++step) {
    const long long pos = at.b * L + at.l;
    const long long base = at.row(0, D, L, E);  // date d at base + d * date_step
    const int d0 = at.d0;
    const int stage = static_cast<int>(step & 1);
    const int hl = lane % kMaxHeads, rl = lane / kMaxHeads;

    // ---- a new position: T's partial, its dybar, ybar = 0, m and den of head hl
    float tp[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) tp[h] = 0.f;
    if (d0 == 0) {
      if (active) {
        float gv[kCols], ov[kCols];
        pool::loadN<kCols>(g + pos * E + c0, gv);
        pool::loadN<kCols>(out + pos * E + c0, ov);
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) t += gv[j] * ov[j];
#pragma unroll
        for (int h = 0; h < kMaxHeads; ++h) {
          if (h == head_c) tp[h] = t;
        }
#pragma unroll
        for (int i = 0; i < kMaxHeads * kCols; i += 4) {
          const int h = i / kCols, o = h * E + c0 + i % kCols;
          if (h < H) {
            *reinterpret_cast<float4*>(sDY + o) =
                *reinterpret_cast<const float4*>(dybar + pos * H * E + o);
            *reinterpret_cast<float4*>(sYB + o) = zero4;
          }
        }
      }
      if (hl < H) {
        m_h = m[pos * H + hl];
        den_h = den[pos * H + hl];
      }
    }
    mma::cp_async_wait<0>();  // this thread's copies of steps s and s + 1 have landed

    // ---- xhat and y of this step; then its stage takes step s + 2
    float xh[kDC][kCols], y[kDC][kCols];
#pragma unroll
    for (int r = 0; r < kDC; ++r) {
      float xv[kCols] = {};
      if (active) xs.get(stage, r, E, c0, xv);
      const float mu = wf[kFMu + r], rs = wf[kFRstd + r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        xh[r][j] = active ? pool::ln_xhat(xv[j], mu, rs) : 0.f;
        y[r][j] = active ? pool::round_as<T>(pool::ln_y(xh[r][j], gam[j], bet[j])) : 0.f;
      }
    }
    float rstd[kDC];
#pragma unroll
    for (int r = 0; r < kDC; ++r) rstd[r] = wf[kFRstd + r];
    if (step + 2 < n_steps) xs.issue(x, ahead, stage, D, L, E, c0, active);
    mma::cp_async_commit();
    ahead.advance(D, L);
    at.advance(D, L);

    // ---- partials: logits y . u_h and da = y . dybar_h, the next step's
    // LayerNorm sums, T
    float* red_s = red + stage * kWarps * kVR;
    double* red_ln_s = red_ln + stage * kWarps * kV12;
    {
      float pr[2 * kVL];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        float uh[kCols] = {}, dyh[kCols] = {};
        if (active) {
          pool::loadN<kCols>(sU + h * E + c0, uh);
          pool::loadN<kCols>(sDY + h * E + c0, dyh);
        }
#pragma unroll
        for (int r = 0; r < kDC; ++r) {
          float lu = 0.f, ld = 0.f;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            lu += y[r][j] * uh[j];
            ld += y[r][j] * dyh[j];
          }
          pr[r * kMaxHeads + h] = lu;
          pr[kVL + r * kMaxHeads + h] = ld;
        }
      }
      pool::warp_totals<2 * kVL>(pr, red_s + warp * kVR, lane);
    }
    {
      double part12[kV12];
      pool::ln_partials(xs, stage ^ 1, E, c0, active, part12);
      pool::warp_totals<kV12>(part12, red_ln_s + warp * kV12, lane);
    }
    if (d0 == 0) pool::warp_totals<kMaxHeads>(tp, red_s + warp * kVR + 2 * kVL, lane);
    __syncthreads();

    // ---- every warp: a and dlogit of lane (r, h) = (rl, hl) ...
    {
      if (d0 == 0) t_h = pool::block_total<kWarps>(red_s, kVR, 2 * kVL + hl, warps);
      const float lgt = sm_scale * pool::block_total<kWarps>(red_s, kVR, lane, warps);
      const float da = pool::block_total<kWarps>(red_s, kVR, kVL + lane, warps);
      const bool valid = hl < H && d0 + rl < D;
      const float a = valid ? expf(lgt - m_h) / den_h : 0.f;
      wf[kFA + hl * kDC + rl] = a;
      wf[kFDl + hl * kDC + rl] = valid ? a * (da - t_h) : 0.f;
    }
    // ... and the next step's statistics (xhat and y of this step have read this step's)
    pool::ln_finalize<kWarps>(red_ln_s, kV12, warps, lane, E, eps, wf + kFMu, wf + kFRstd);
    __syncwarp();

    // ---- dy; du, ybar, d_ln_scale and d_ln_bias accumulate
    float dy[kDC][kCols];
#pragma unroll
    for (int r = 0; r < kDC; ++r) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) dy[r][j] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < H && active) {
        float uh[kCols], dyh[kCols], duh[kCols], ybh[kCols];
        pool::loadN<kCols>(sU + h * E + c0, uh);
        pool::loadN<kCols>(sDY + h * E + c0, dyh);
        pool::loadN<kCols>(sDU + h * E + c0, duh);
        pool::loadN<kCols>(sYB + h * E + c0, ybh);
        const float4 a4 = *reinterpret_cast<const float4*>(wf + kFA + h * kDC);
        const float4 l4 = *reinterpret_cast<const float4*>(wf + kFDl + h * kDC);
        const float av[kDC] = {a4.x, a4.y, a4.z, a4.w};
        const float sdl[kDC] = {sm_scale * l4.x, sm_scale * l4.y, sm_scale * l4.z, sm_scale * l4.w};
#pragma unroll
        for (int r = 0; r < kDC; ++r) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            dy[r][j] += av[r] * dyh[j] + sdl[r] * uh[j];
            duh[j] += sdl[r] * y[r][j];
            ybh[j] += av[r] * y[r][j];
          }
        }
        pool::storeN<kCols>(sDU + h * E + c0, duh);
        pool::storeN<kCols>(sYB + h * E + c0, ybh);
      }
    }
    // rows past D have a = dlogit = 0, so dy = 0 there
#pragma unroll
    for (int r = 0; r < kDC; ++r) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        dsc[j] += dy[r][j] * xh[r][j];
        dbi[j] += dy[r][j];
      }
    }

    // ---- LayerNorm backward: dx = rstd (dy*gam - mean(dy*gam) - xhat mean(dy*gam*xhat))
    if (dx != nullptr) {
      float part4[kV4];
#pragma unroll
      for (int r = 0; r < kDC; ++r) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          dy[r][j] *= gam[j];  // dy * gam from here on
          s1 += dy[r][j];
          s2 += dy[r][j] * xh[r][j];
        }
        part4[r] = s1;
        part4[kDC + r] = s2;
      }
      pool::warp_totals<kV4>(part4, red4 + warp * kV4, lane);
      __syncthreads();
      if (lane < kV4) wf[kFC1 + lane] = pool::block_total<kWarps>(red4, kV4, lane, warps) * inv_e;
      __syncwarp();
      if (active) {
#pragma unroll
        for (int r = 0; r < kDC; ++r) {
          if (d0 + r < D) {
            const float c1 = wf[kFC1 + r], c2 = wf[kFC2 + r];
            float o[kCols];
#pragma unroll
            for (int j = 0; j < kCols; ++j) o[j] = rstd[r] * (dy[r][j] - c1 - xh[r][j] * c2);
            pool::storeN<kCols>(dx + base + (d0 + r) * date_step + c0, o);
          }
        }
      }
    }

    if (d0 + kDC >= D && active) {  // the position's last step: its ybar
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < H) {
          float ybh[kCols];
          pool::loadN<kCols>(sYB + h * E + c0, ybh);
          pool::storeN<kCols>(ybar + (pos * H + h) * E + c0, ybh);
        }
      }
    }
  }

  // the block's partial: du [H][E] | d_ln_scale [E] | d_ln_bias [E]
  if (active) {
    float* dst = part + static_cast<long long>(blockIdx.x) * (H + 2) * E;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < H) {
        float duh[kCols];
        pool::loadN<kCols>(sDU + h * E + c0, duh);
        pool::storeN<kCols>(dst + h * E + c0, duh);
      }
    }
    pool::storeN<kCols>(dst + H * E + c0, dsc);
    pool::storeN<kCols>(dst + (H + 1) * E + c0, dbi);
  }
}

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

// One block a row j of d_w_kv [2E, E].  j < E: dW_k[j] = q_j du_h(j) and
// d_query[j] = W_k[j] . du_h(j) (a fixed-order block sum); j >= E: dW_v[j - E]
// as the in-order sum of the `splits` slices of launch 4.
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kFinishThreads)
pool_bwd_finish(const bf16* __restrict__ w_kv, const float* __restrict__ query,
                const float* __restrict__ du, const float* __restrict__ dwv_part, int splits,
                float* __restrict__ d_w, float* __restrict__ d_query, int E, int dh) {
  __shared__ float red_w[kFinishThreads / 32];
  const int j = blockIdx.x, tid = threadIdx.x;
  float* dst = d_w + static_cast<long long>(j) * E;
  if (j < E) {
    const float q = query[j];
    const float* duh = du + static_cast<long long>(j / dh) * E;
    const bf16* wk = w_kv + static_cast<long long>(j) * E;
    float dot = 0.f;
    for (int e = tid; e < E; e += kFinishThreads) {
      const float v = duh[e];
      dst[e] = q * v;
      dot += __bfloat162float(wk[e]) * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if ((tid & 31) == 0) red_w[tid >> 5] = dot;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kFinishThreads / 32; ++w) s += red_w[w];
      d_query[j] = s;
    }
  } else {
    const long long row = j - E;
    for (int e = tid; e < E; e += kFinishThreads) {
      float s = 0.f;
      for (int sp = 0; sp < splits; ++sp) {
        s += dwv_part[(sp * static_cast<long long>(E) + row) * E + e];
      }
      dst[e] = s;
    }
  }
}

struct BwdArgs {
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const bf16* w_kv;
  const float* query;
  const void* out;
  const void* g;
  const bf16* g16;
  const float* m;
  const float* den;
  void* dx;
  float* u;
  float* dybar;
  bf16* ybar;
  float* part;
  float* small;
  float* dwv_part;
  float* d_w;
  float* d_query;
  int B, D, L, E, H;
  float eps;
  cudaStream_t stream;
};

// Row blocks of launch 3 and K slices of launch 4 at this shape.
template <typename T>
int plan(long long n_pos, int E, int H, pool::RowGrid* rows, int* splits) {
  const int err = pool::row_grid(pool_bwd_rows<T>, n_pos, pool::row_threads(E, kCols),
                                 bwd_rows_smem(E, sizeof(T)), rows);
  if (err != 0) return err;
  // dW_v output tiles; slices of at least 512 positions until about four
  // blocks an SM are in flight
  const int dh = E / H;
  const long long tiles = static_cast<long long>((dh + pool::kBM - 1) / pool::kBM) *
                          ((E + pool::kBN - 1) / pool::kBN) * H;
  const long long want = (4LL * pool::sm_count() + tiles - 1) / tiles;
  const long long most = (n_pos + 511) / 512;
  *splits = static_cast<int>(want < most ? want : most);
  if (*splits < 1) *splits = 1;
  return 0;
}

template <typename T>
int run(const BwdArgs& a) {
  const int dh = a.E / a.H;
  const long long n_pos = static_cast<long long>(a.B) * a.L;
  pool::RowGrid rows;
  int splits = 1;
  int err = plan<T>(n_pos, a.E, a.H, &rows, &splits);
  if (err != 0) return err;

  pool::pool_u<<<dim3((a.E + 127) / 128, kMaxHeads), 128, 0, a.stream>>>(a.w_kv, a.query, a.u,
                                                                         a.E, a.H, dh);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const bf16* w_v = a.w_kv + static_cast<long long>(a.E) * a.E;
  // dybar[p, h, e] = sum_c g[p, h*dh + c] * W_v[h*dh + c, e]
  pool::MmaArgs mm{};
  mm.a = a.g16;
  mm.lda = a.E;
  mm.a_head = dh;
  mm.b = w_v;
  mm.ldb = a.E;
  mm.b_head = static_cast<long long>(dh) * a.E;
  mm.c = a.dybar;
  mm.ldc = static_cast<long long>(a.H) * a.E;
  mm.c_head = a.E;
  mm.c_split = 0;
  mm.m = static_cast<int>(n_pos);
  mm.n = a.E;
  mm.k = dh;
  mm.k_split = dh;
  mm.splits = 1;
  err = pool::launch_mma<false, true, float>(mm, a.H, a.stream);
  if (err != 0) return err;

  const int threads = pool::row_threads(a.E, kCols);
  pool_bwd_rows<T><<<rows.blocks, threads, bwd_rows_smem(a.E, sizeof(T)), a.stream>>>(
      static_cast<const T*>(a.x), a.ln_scale, a.ln_bias, a.u, static_cast<const T*>(a.out),
      static_cast<const T*>(a.g), a.m, a.den, a.dybar, static_cast<T*>(a.dx), a.ybar, a.part,
      n_pos, a.D, a.L, a.E, a.H, dh, a.eps, 1.0f / sqrtf(static_cast<float>(dh)), rows.per_block);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // dW_v slices: part[s][h*dh + c, e] = sum_{p in slice s} g[p, h*dh + c] * ybar[p, h, e]
  long long k_split = (n_pos + splits - 1) / splits;
  k_split = (k_split + pool::kBK - 1) / pool::kBK * pool::kBK;
  pool::MmaArgs dw{};
  dw.a = a.g16;
  dw.lda = a.E;
  dw.a_head = dh;
  dw.b = a.ybar;
  dw.ldb = static_cast<long long>(a.H) * a.E;
  dw.b_head = a.E;
  dw.c = a.dwv_part;
  dw.ldc = a.E;
  dw.c_head = static_cast<long long>(dh) * a.E;
  dw.c_split = static_cast<long long>(a.E) * a.E;
  dw.m = dh;
  dw.n = a.E;
  dw.k = static_cast<int>(n_pos);
  dw.k_split = static_cast<int>(k_split);
  dw.splits = splits;
  err = pool::launch_mma<true, true, float>(dw, a.H, a.stream);
  if (err != 0) return err;

  const long long cols = static_cast<long long>(a.H + 2) * a.E;
  const dim3 block(32, 32);
  const unsigned col_blocks = static_cast<unsigned>((cols + 31) / 32);
  column_sums<<<col_blocks, block, sizeof(float) * 32 * 32, a.stream>>>(
      a.part, rows.blocks, cols, a.small);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  pool_bwd_finish<<<2 * a.E, kFinishThreads, 0, a.stream>>>(a.w_kv, a.query, a.small, a.dwv_part,
                                                            splits, a.d_w, a.d_query, a.E, dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch the backward needs at this shape: out[0] = row blocks of
// launch 3 (rows of `part`), out[1] = K slices of launch 4 (of `dwv_part`).
extern "C" int attentive_pool_bwd_plan(long long n_pos, int E, int H, int dtype, int* out) {
  if (!pool::supported_shape(E, H) || n_pos < 1) return static_cast<int>(cudaErrorInvalidValue);
  pool::RowGrid rows;
  int splits = 1;
  int err;
  if (dtype == 0) {
    err = plan<bf16>(n_pos, E, H, &rows, &splits);
  } else if (dtype == 1) {
    err = plan<float>(n_pos, E, H, &rows, &splits);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = rows.blocks;
  out[1] = splits;
  return err;
}

// Dynamic shared memory of pool_bwd_rows<bf16> at width E (for the build report).
extern "C" int attentive_pool_bwd_smem_bytes(int E) {
  return static_cast<int>(bwd_rows_smem(E, sizeof(bf16)));
}

// x [B, D, L, E], out and g [B, L, E] contiguous in one dtype (0 = bf16,
// 1 = fp32); g16 the bf16 values of g (g itself for bf16); ln_scale, ln_bias,
// query fp32 [E]; w_kv bf16 [2E, E]; m, den fp32 [B, L, H].  dx (or null)
// like x.  Scratch: u fp32 [8, E]; dybar fp32 and ybar bf16 [B*L, H, E];
// part fp32 [plan[0], (H + 2) * E]; small fp32 [(H + 2) * E] = du | d_ln_scale
// | d_ln_bias; dwv_part fp32 [plan[1], E, E].  Outputs: d_w fp32 [2E, E],
// d_query fp32 [E].  Returns cudaGetLastError() after the first launch that
// failed or the last one, or cudaErrorInvalidValue for a shape this file
// does not build.
extern "C" int attentive_pool_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w_kv, const void* query, const void* out,
                                  const void* g, const void* g16, const void* m, const void* den,
                                  void* dx, void* u, void* dybar, void* ybar, void* part,
                                  void* small, void* dwv_part, void* d_w, void* d_query, int B,
                                  int D, int L, int E, int H, float eps, int dtype, void* stream) {
  if (!pool::supported_shape(E, H) || B < 1 || D < 1 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{x,
                  static_cast<const float*>(ln_scale),
                  static_cast<const float*>(ln_bias),
                  static_cast<const bf16*>(w_kv),
                  static_cast<const float*>(query),
                  out,
                  g,
                  static_cast<const bf16*>(g16),
                  static_cast<const float*>(m),
                  static_cast<const float*>(den),
                  dx,
                  static_cast<float*>(u),
                  static_cast<float*>(dybar),
                  static_cast<bf16*>(ybar),
                  static_cast<float*>(part),
                  static_cast<float*>(small),
                  static_cast<float*>(dwv_part),
                  static_cast<float*>(d_w),
                  static_cast<float*>(d_query),
                  B, D, L, E, H, eps,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return run<bf16>(a);
  if (dtype == 1) return run<float>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
