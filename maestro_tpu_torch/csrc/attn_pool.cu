// attentive_pool_fwd: for every (batch, position) row of x [B, D, L, E], a
// single learned query attends over the D dates:
//   y_d   = LayerNorm(x_d)            (fp32 statistics, eps, fp32 scale/bias)
//   k, v  = y_d . W_kv^T              (W_kv [2E, E]: rows 0..E-1 -> k, E..2E-1 -> v)
//   logit = <k_head, query_head> * dh^-0.5
//   out   = sum_d softmax_d(logit) * v_d
// Outputs: out [B, L, E] (input dtype), m and den [B, L, H] fp32 (the softmax
// max and denominator a backward pass needs).  No final LayerNorm.
//
// Replaces the forward of the JAX package's ops/attn_pool.py (_fwd_kernel).
// That kernel forms the kv projection of every (batch, date, position) row,
// 4*E^2 operations a row.  This file computes the same function in the
// factored form of pool_common.cuh, about 4*E*H + 8*E operations a row plus
// one [E x E] product a position, in three launches:
//   1 pool_u           u [H, E] = per head, the query times W_k (fp32).
//                      Replaces the k half of the kv projection.
//   2 pool_fwd_rows    one block per run of positions (as many blocks as
//                      fit on the card at once), kCols columns of E a thread
//                      (3 warps at E = 768); per position the dates in steps
//                      of kDC, x copied into shared memory by cp.async a step
//                      ahead and read once: LayerNorm statistics (fp64 sums),
//                      y rounded to x's dtype, the logits y . u_h, the online
//                      softmax over the dates (m, den, as the TPU kernel's
//                      date loop keeps them), and ybar_h = sum_d a_dh y_d in
//                      fp32 registers; writes m, den and ybar [B*L, H, E]
//                      (bf16, the operand of launch 3).  One block barrier a
//                      step: the logits of step s and the LayerNorm sums of
//                      step s + 1 are reduced together, every warp finalizes
//                      them itself (no second barrier), and the ybar update
//                      of step s waits for iteration s + 1.  Bound by its fp32
//                      work, about 4*E*H + 8*E a row at 67 TFLOP/s, and by
//                      reading x, about as long; what holds it back is the
//                      instruction count of the block reductions and the
//                      LayerNorm (PERF.md).
//   3 pool_mma         out[:, h] = ybar_h . W_v,h^T on the tensor cores, M =
//                      B*L, N = dh, K = E per head: each 64 x 64 tile reuses
//                      its W_v rows over 64 positions.  Replaces the v half
//                      of the kv projection and the TPU kernel's pooling.
//
// Precision: logits, softmax, u and ybar are fp32; the LayerNorm statistics
// are fp32 values of fp64 sums, and y = (x - mu) * rstd * scale + bias is
// taken in the plain version's order of fp32 operations, then rounded to x's
// dtype before the logits and ybar (as the plain version rounds LN(x) before
// the kv projection); W_kv is bf16; ybar is rounded to bf16 as the operand of
// launch 3 (fp32 accumulation).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include "pool_common.cuh"

namespace {

using pool::bf16;
using pool::kDC;
using pool::kMaxHeads;

constexpr int kCols = 8;     // columns of E a thread owns (4 measured slower)
constexpr int kStages = 2;   // x of this step and of the next (a thread's own columns)
constexpr int kWarps = pool::kMaxWarps<kCols>;
constexpr int kV3 = kDC * kMaxHeads;   // logits of a step, one (date, head) a lane
constexpr int kV12 = 2 * kDC;          // LayerNorm sums of the next step (fp64)
// a warp's own finalized values: p [kMaxHeads][kDC], alpha, den [kMaxHeads],
// the next step's mu, rstd [kDC]
constexpr int kFP = 0, kFAlpha = kFP + kV3, kFDen = kFAlpha + kMaxHeads, kFMu = kFDen + kMaxHeads,
              kFRstd = kFMu + kDC, kWF = kFRstd + kDC;
static_assert(kV3 == 32, "the softmax gives each lane of a warp one (date, head)");

// floats before the x stages (a multiple of 4: the stages start 16-byte aligned)
__host__ __device__ int fwd_rows_floats(int E) {
  return kMaxHeads * E + 2 * kWarps * kV12 * 2 + 2 * kWarps * kV3 + kWarps * kWF;
}

size_t fwd_rows_smem(int E, size_t elem) {
  return sizeof(float) * fwd_rows_floats(E) + elem * kStages * kDC * E;
}

// One block per run of positions; a step is kDC dates of one position.
// Iteration s: finish step s - 1 (its ybar update, and the position's output
// when it was the last step); y of step s from its statistics, its logit
// partials and the LayerNorm partials of step s + 1 together; one barrier;
// then every warp finalizes the softmax of step s and the statistics of
// step s + 1 itself.
template <typename T>
__global__ void __launch_bounds__(pool::kMaxThreads<kCols>)
pool_fwd_rows(const T* __restrict__ x, const float* __restrict__ ln_scale,
              const float* __restrict__ ln_bias, const float* __restrict__ u,
              bf16* __restrict__ ybar, float* __restrict__ m_out, float* __restrict__ den_out,
              long long n_pos, int D, int L, int E, int H, float eps, float sm_scale,
              long long per_block) {
  extern __shared__ __align__(16) float smem[];
  float* sU = smem;                        // [kMaxHeads][E]: each thread reads its own columns
  // partial totals by step parity: LayerNorm sums [2][warps][kV12], logits [2][warps][kV3]
  double* red_ln = reinterpret_cast<double*>(sU + kMaxHeads * E);
  float* red = reinterpret_cast<float*>(red_ln + 2 * kWarps * kV12);
  float* wf = red + 2 * kWarps * kV3;      // [warps][kWF]
  const pool::XStages<T, kCols> xs{reinterpret_cast<T*>(smem + fwd_rows_floats(E))};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const int c0 = tid * kCols;
  const bool active = c0 < E;
  wf += warp * kWF;
  float gam[kCols] = {}, bet[kCols] = {};
  if (active) {
    pool::loadN<kCols>(ln_scale + c0, gam);
    pool::loadN<kCols>(ln_bias + c0, bet);
#pragma unroll
    for (int i = 0; i < kMaxHeads * kCols; i += 4) {
      const int o = (i / kCols) * E + c0 + i % kCols;
      *reinterpret_cast<float4*>(sU + o) = *reinterpret_cast<const float4*>(u + o);
    }
  }

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
    double part[kV12];
    pool::ln_partials(xs, 0, E, c0, active, part);
    double* r1 = red_ln + kWarps * kV12;
    pool::warp_totals<kV12>(part, r1 + warp * kV12, lane);
    __syncthreads();
    pool::ln_finalize<kWarps>(r1, kV12, warps, lane, E, eps, wf + kFMu, wf + kFRstd);
    __syncwarp();
  }

  float acc[kMaxHeads][kCols];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[h][j] = 0.f;
  }
  float y[kDC][kCols];
  float m_run = -1e30f, den_run = 0.f;  // lane (r, h) of every warp: head h's softmax state
  long long prev_pos = -1;              // the position of step s - 1 when it was its last step

  for (long long step = 0; step <= n_steps; ++step) {
    // ---- finish step s - 1: ybar_h = ybar_h * alpha_h + sum_r p_rh y_r
    if (step > 0) {
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < H) {
          const float al = wf[kFAlpha + h];
          const float4 ph = *reinterpret_cast<const float4*>(wf + kFP + h * kDC);
          const float pr[kDC] = {ph.x, ph.y, ph.z, ph.w};
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            float t = acc[h][j] * al;
#pragma unroll
            for (int r = 0; r < kDC; ++r) t += pr[r] * y[r][j];
            acc[h][j] = t;
          }
        }
      }
      if (prev_pos >= 0) {  // that was the position's last step: its outputs
        if (warp == 0 && lane < H) {  // lanes (0, h)
          m_out[prev_pos * H + lane] = m_run;
          den_out[prev_pos * H + lane] = den_run;
        }
        if (active) {
#pragma unroll
          for (int h = 0; h < kMaxHeads; ++h) {
            if (h < H) {
              const float inv = 1.f / wf[kFDen + h];
              float o[kCols];
#pragma unroll
              for (int j = 0; j < kCols; ++j) {
                o[j] = acc[h][j] * inv;
                acc[h][j] = 0.f;
              }
              pool::storeN<kCols>(ybar + (prev_pos * H + h) * E + c0, o);
            }
          }
        }
      }
    }
    if (step == n_steps) break;

    const long long pos = at.b * L + at.l;
    const int d0 = at.d0;
    const int stage = static_cast<int>(step & 1);
    mma::cp_async_wait<0>();  // this thread's copies of steps s and s + 1 have landed

    // ---- y of this step; then its stage takes step s + 2
    {
      float xv[kDC][kCols];
#pragma unroll
      for (int r = 0; r < kDC; ++r) {
        if (active) {
          xs.get(stage, r, E, c0, xv[r]);
        } else {
#pragma unroll
          for (int j = 0; j < kCols; ++j) xv[r][j] = 0.f;
        }
        const float mu = wf[kFMu + r], rs = wf[kFRstd + r];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float yj = pool::ln_y(pool::ln_xhat(xv[r][j], mu, rs), gam[j], bet[j]);
          y[r][j] = active ? pool::round_as<T>(yj) : 0.f;
        }
      }
    }
    if (step + 2 < n_steps) xs.issue(x, ahead, stage, D, L, E, c0, active);
    mma::cp_async_commit();
    ahead.advance(D, L);
    at.advance(D, L);

    // ---- this step's logit partials and the next step's LayerNorm partials
    float* red_s = red + stage * kWarps * kV3;
    double* red_ln_s = red_ln + stage * kWarps * kV12;
    float lg[kV3];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      float uh[kCols] = {};
      if (active) pool::loadN<kCols>(sU + h * E + c0, uh);
#pragma unroll
      for (int r = 0; r < kDC; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) dot += y[r][j] * uh[j];
        lg[r * kMaxHeads + h] = dot;
      }
    }
    pool::warp_totals<kV3>(lg, red_s + warp * kV3, lane);
    double part[kV12];
    pool::ln_partials(xs, stage ^ 1, E, c0, active, part);
    pool::warp_totals<kV12>(part, red_ln_s + warp * kV12, lane);
    __syncthreads();

    // ---- every warp: the online softmax of this step, lane (r, h) ...
    {
      const int r = lane / kMaxHeads, h = lane % kMaxHeads;
      const bool valid = h < H && d0 + r < D;
      if (d0 == 0) {
        m_run = -1e30f;
        den_run = 0.f;
      }
      const float lgt = sm_scale * pool::block_total<kWarps>(red_s, kV3, lane, warps);
      float mx = valid ? lgt : -1e30f;  // the step's max of head h, then the running one
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, kMaxHeads));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2 * kMaxHeads));
      mx = fmaxf(mx, m_run);
      const float alpha = expf(m_run - mx);
      const float p = valid ? expf(lgt - mx) : 0.f;
      // the same sum in every lane of head h: (p0 + p1) + (p2 + p3), operands commuted
      float ps = p + __shfl_xor_sync(0xffffffffu, p, kMaxHeads);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2 * kMaxHeads);
      den_run = den_run * alpha + ps;
      m_run = mx;
      wf[kFP + h * kDC + r] = p;
      if (r == 0) {
        wf[kFAlpha + h] = alpha;
        wf[kFDen + h] = den_run;
      }
    }
    // ... and the next step's statistics (y of this step has read this step's)
    pool::ln_finalize<kWarps>(red_ln_s, kV12, warps, lane, E, eps, wf + kFMu, wf + kFRstd);
    __syncwarp();
    prev_pos = d0 + kDC >= D ? pos : -1;
  }
}

struct FwdArgs {
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const bf16* w_kv;
  const float* query;
  float* u;
  bf16* ybar;
  void* out;
  float* m_out;
  float* den_out;
  int B, D, L, E, H;
  float eps;
  cudaStream_t stream;
};

template <typename T>
int run(const FwdArgs& a) {
  const int dh = a.E / a.H;
  const long long n_pos = static_cast<long long>(a.B) * a.L;
  pool::pool_u<<<dim3((a.E + 127) / 128, kMaxHeads), 128, 0, a.stream>>>(a.w_kv, a.query, a.u,
                                                                         a.E, a.H, dh);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const int threads = pool::row_threads(a.E, kCols);
  const size_t smem = fwd_rows_smem(a.E, sizeof(T));
  pool::RowGrid grid;
  err = pool::row_grid(pool_fwd_rows<T>, n_pos, threads, smem, &grid);
  if (err != 0) return err;
  pool_fwd_rows<T><<<grid.blocks, threads, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.ln_scale, a.ln_bias, a.u, a.ybar, a.m_out, a.den_out, n_pos,
      a.D, a.L, a.E, a.H, a.eps, 1.0f / sqrtf(static_cast<float>(dh)), grid.per_block);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // out[p, h*dh + c] = sum_e ybar[p, h, e] * W_v[h*dh + c, e]
  pool::MmaArgs mm{};
  mm.a = a.ybar;
  mm.lda = static_cast<long long>(a.H) * a.E;
  mm.a_head = a.E;
  mm.b = a.w_kv + static_cast<long long>(a.E) * a.E;
  mm.ldb = a.E;
  mm.b_head = static_cast<long long>(dh) * a.E;
  mm.c = a.out;
  mm.ldc = a.E;
  mm.c_head = dh;
  mm.c_split = 0;
  mm.m = static_cast<int>(n_pos);
  mm.n = dh;
  mm.k = a.E;
  mm.k_split = a.E;
  mm.splits = 1;
  return pool::launch_mma<false, false, T>(mm, a.H, a.stream);
}

}  // namespace

// x [B, D, L, E] contiguous (dtype 0 = bf16, 1 = fp32), ln_scale/ln_bias/query
// fp32 [E], w_kv bf16 [2E, E] contiguous.  Scratch: u fp32 [8, E], ybar bf16
// [B*L, H, E].  Outputs: out [B, L, E] like x, m and den fp32 [B, L, H].
// Returns cudaGetLastError() after the first launch that failed or the last
// one, or cudaErrorInvalidValue for a shape this file does not build.
extern "C" int attentive_pool_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w_kv, const void* query, void* u, void* ybar,
                                  void* out, void* m_out, void* den_out, int B, int D, int L,
                                  int E, int H, float eps, int dtype, void* stream) {
  if (!pool::supported_shape(E, H) || B < 1 || D < 1 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs a{x,
                  static_cast<const float*>(ln_scale),
                  static_cast<const float*>(ln_bias),
                  static_cast<const bf16*>(w_kv),
                  static_cast<const float*>(query),
                  static_cast<float*>(u),
                  static_cast<bf16*>(ybar),
                  out,
                  static_cast<float*>(m_out),
                  static_cast<float*>(den_out),
                  B, D, L, E, H, eps,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return run<bf16>(a);
  if (dtype == 1) return run<float>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of pool_fwd_rows<bf16> at width E (for the build report).
extern "C" int attentive_pool_fwd_smem_bytes(int E) {
  return static_cast<int>(fwd_rows_smem(E, sizeof(bf16)));
}
