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
// That kernel keeps a [rows, E] fp32 accumulator and a [rows, 2E] fp32 kv tile
// resident per block; at E = 768 this does not fit an SM's shared memory, and
// heads are independent, so here a block owns (row tile, head): it computes
// only that head's dh k-columns and dh v-columns.  Each 16-row group has
// k-warps and v-warps (two of each when dh is a multiple of 32, each taking
// half of the columns): a k-warp multiplies its k-columns and reduces them
// against the query to a partial logit per row (a register dot product plus a
// 4-thread shuffle — the TPU kernel's selector matmuls are not needed); the
// partial logits meet in shared memory, every warp of the group then runs the
// same online-softmax step, and a v-warp, which multiplied its v-columns
// meanwhile, folds them into its [16, dh/2] fp32 accumulator kept in mma.sync
// fragments.  The date loop runs inside the block, so x is read (once per
// head, from L2 after the first) and out is written once; LayerNorm output is
// staged in shared memory as bf16, and the head's W_kv rows stream through a
// two-stage cp.async buffer in 64-column chunks, the next chunk loading while
// this one is multiplied.
//
// A block has 32 rows (two 16-row groups): the serving path's [8, 26, 64, 768]
// launch has only 512 rows, and smaller blocks spread them over more SMs.
//
// Products run on the tensor cores with bf16 operands and fp32 accumulation
// for both input dtypes (fp32 x is normalized in fp32 and rounded to bf16 only
// as the matmul operand).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKC = 64;      // W_kv columns (reduction dim) per shared-memory chunk
constexpr int kPad = 8;      // bf16 padding of shared rows: rows 16 bytes apart mod 128
constexpr int kMaxE = 1024;  // LayerNorm keeps a row in registers: 32 lanes x 4 x 8
constexpr int kRG = 2;       // 16-row groups per block
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i; thread (g, t) receives row g, columns 2t, 2t+1 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

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

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Column halves per role: a head's k (and v) columns are split over two warps
// when each half still holds whole pairs of 8-column tiles.
template <int DH>
constexpr int kColSplits = DH % 32 == 0 ? 2 : 1;

template <int DH>
size_t pool_smem_bytes(int E) {
  return sizeof(__nv_bfloat16) * (static_cast<size_t>(16 * kRG) * (E + kPad) +
                                  2 * static_cast<size_t>(2 * DH) * (kKC + kPad)) +
         sizeof(float) * 16 * kRG * kColSplits<DH>;
}

// T: dtype of x and out.  DH: head dim (E / heads), a multiple of 16.
// Each of the block's kRG 16-row groups has NH k-warps and NH v-warps
// (NH = kColSplits<DH>), so a block has 2 * NH * kRG warps.
template <typename T, int DH>
__global__ void __launch_bounds__(kRG * 64 * kColSplits<DH>)
attn_pool_fwd(const T* __restrict__ x, const float* __restrict__ ln_scale,
              const float* __restrict__ ln_bias, const __nv_bfloat16* __restrict__ w_kv,
              const float* __restrict__ query, T* __restrict__ out, float* __restrict__ m_out,
              float* __restrict__ den_out, int B, int D, int L, int E, int H, float eps,
              float sm_scale) {
  constexpr int NH = kColSplits<DH>;
  constexpr int DW = DH / NH;            // columns of this warp
  constexpr int NT = DW / 8;             // n-tiles of this warp
  constexpr int ROWS = 16 * kRG;         // (batch, position) rows per block
  constexpr int WARPS = 2 * NH * kRG;
  constexpr int THREADS = WARPS * 32;
  constexpr int LN_ROWS = ROWS / WARPS;  // rows each warp normalizes per date
  constexpr int WLD = kKC + kPad;        // shared row stride of a W chunk
  constexpr int WSTAGE = 2 * DH * WLD;   // elements of one W stage (k rows, then v rows)
  static_assert(NT % 2 == 0, "ldmatrix.x4 feeds two n-tiles at a time");
  static_assert(ROWS % WARPS == 0, "rows divide over the warps for LayerNorm");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int YLD = E + kPad;              // shared row stride of the LayerNorm tile
  __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][YLD]
  __nv_bfloat16* Ws = Ys + ROWS * YLD;                             // [2][2*DH][WLD]
  float* logit_s = reinterpret_cast<float*>(Ws + 2 * WSTAGE);      // [ROWS][NH] partial logits

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int group = warp % kRG;                // 16-row group of this warp
  const bool v_role = (warp / kRG) % 2 == 1;   // k columns or v columns
  const int half = warp / (2 * kRG);           // which DW-column slice of the head
  const int head = blockIdx.y;
  const long long n_rows = (long long)B * L;
  const long long tile_row0 = (long long)blockIdx.x * ROWS;
  const int lm_mat = lane >> 3, lm_row = lane & 7;  // ldmatrix lane roles

  const int n_chunks = E / kKC;
  const int total_chunks = D * n_chunks;
  // chunk -> stage: this head's k rows then v rows of W_kv, columns kc..kc+63
  auto load_w_chunk = [&](int chunk, int stage) {
    constexpr int VEC_PER_ROW = kKC / 8;
    const int kc = (chunk % n_chunks) * kKC;
    __nv_bfloat16* ws = Ws + stage * WSTAGE;
    for (int idx = tid; idx < 2 * DH * VEC_PER_ROW; idx += THREADS) {
      const int n = idx / VEC_PER_ROW;
      const int c = (idx % VEC_PER_ROW) * 8;
      const int wrow = (n < DH ? 0 : E - DH) + head * DH + n;  // n >= DH: E + head*DH + n - DH
      cp_async_16(&ws[n * WLD + c], w_kv + (long long)wrow * E + kc + c);
    }
    cp_async_commit();
  };
  load_w_chunk(0, 0);

  // k-warps: this thread's slice of the head's query, columns nt*8 + 2t, +1 of its half
  float qv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    qv[nt][0] = query[head * DH + half * DW + nt * 8 + 2 * t];
    qv[nt][1] = query[head * DH + half * DW + nt * 8 + 2 * t + 1];
  }

  float acc[NT][4];  // v-warps: the pooled sum
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // every warp tracks the softmax state of its rows g and g+8 (same arithmetic
  // on the same logits in each warp of a group, so the copies agree exactly)
  float m_lo = kNegInit, m_hi = kNegInit, den_lo = 0.f, den_hi = 0.f;

  int chunk = 0;
  for (int d = 0; d < D; ++d) {
    // ---- LayerNorm of LN_ROWS rows per warp -> Ys (bf16).  The barrier that
    // ended the previous date's last chunk makes Ys free to overwrite.
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
      const long long b = row / L, l = row % L;
      const T* xrow = x + ((b * D + d) * L + l) * (long long)E;
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
    for (int kc = 0; kc < E; kc += kKC, ++chunk) {
      const int stage = chunk & 1;
      // the other stage was last read in the previous chunk, which ended in a barrier
      if (chunk + 1 < total_chunks) {
        load_w_chunk(chunk + 1, stage ^ 1);
        cp_async_wait<1>();  // all but the newest group: this chunk has landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk visible to all; on a date's first chunk, Ys too
      const __nv_bfloat16* ws = Ws + stage * WSTAGE + ((v_role ? DH : 0) + half * DW) * WLD;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        // A: rows 0..7 k lo, rows 8..15 k lo, rows 0..7 k hi, rows 8..15 k hi
        uint32_t a[4];
        ldmatrix_x4(a, &Ys[(group * 16 + (lm_mat & 1) * 8 + lm_row) * YLD + kc + ks * 16 +
                           (lm_mat >> 1) * 8]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          // B: (cols np*16+0..7, k lo), (same, k hi), (cols +8, k lo), (cols +8, k hi)
          uint32_t bfr[4];
          ldmatrix_x4(bfr, &ws[(np * 16 + (lm_mat >> 1) * 8 + lm_row) * WLD + ks * 16 +
                               (lm_mat & 1) * 8]);
          mma_bf16_16816(f[2 * np], a, bfr[0], bfr[1]);
          mma_bf16_16816(f[2 * np + 1], a, bfr[2], bfr[3]);
        }
      }
      __syncthreads();  // this stage (and, after a date's last chunk, Ys) is free
    }

    // ---- k-warps: partial logit of their columns against the query
    if (!v_role) {
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
    __syncthreads();  // partial logits of this date visible to the group's warps
    // (logit_s is rewritten only after the next date's chunk barriers)

    // ---- online softmax over dates, in every warp; v-warps pool
    float lg_lo = 0.f, lg_hi = 0.f;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      lg_lo += logit_s[(group * 16 + g) * NH + hh];
      lg_hi += logit_s[(group * 16 + g + 8) * NH + hh];
    }
    lg_lo *= sm_scale;
    lg_hi *= sm_scale;
    const float mn_lo = fmaxf(m_lo, lg_lo), mn_hi = fmaxf(m_hi, lg_hi);
    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    const float p_lo = expf(lg_lo - mn_lo), p_hi = expf(lg_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    den_lo = den_lo * al_lo + p_lo;
    den_hi = den_hi * al_hi + p_hi;
    if (v_role) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] = acc[nt][0] * al_lo + p_lo * f[nt][0];
        acc[nt][1] = acc[nt][1] * al_lo + p_lo * f[nt][1];
        acc[nt][2] = acc[nt][2] * al_hi + p_hi * f[nt][2];
        acc[nt][3] = acc[nt][3] * al_hi + p_hi * f[nt][3];
      }
    }
  }

  // ---- write out (v-warps) and m, den (the first k-warp of each group)
  const long long r_lo = tile_row0 + group * 16 + g, r_hi = r_lo + 8;
  if (v_role) {
    const float inv_lo = 1.f / den_lo, inv_hi = 1.f / den_hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = head * DH + half * DW + nt * 8 + 2 * t;
      if (r_lo < n_rows) store2(out + r_lo * E + c, acc[nt][0] * inv_lo, acc[nt][1] * inv_lo);
      if (r_hi < n_rows) store2(out + r_hi * E + c, acc[nt][2] * inv_hi, acc[nt][3] * inv_hi);
    }
  } else if (half == 0 && t == 0) {
    if (r_lo < n_rows) {
      m_out[r_lo * H + head] = m_lo;
      den_out[r_lo * H + head] = den_lo;
    }
    if (r_hi < n_rows) {
      m_out[r_hi * H + head] = m_hi;
      den_out[r_hi * H + head] = den_hi;
    }
  }
}

struct PoolArgs {
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const void* w_kv;
  const float* query;
  void* out;
  float* m_out;
  float* den_out;
  int B, D, L, E, H;
  float eps;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch(const PoolArgs& a) {
  const size_t smem = pool_smem_bytes<DH>(a.E);
  auto kernel = attn_pool_fwd<T, DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = (long long)a.B * a.L;
  dim3 grid(static_cast<unsigned>((n_rows + 16 * kRG - 1) / (16 * kRG)), a.H);
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(DH));
  kernel<<<grid, kRG * 64 * kColSplits<DH>, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.ln_scale, a.ln_bias,
      static_cast<const __nv_bfloat16*>(a.w_kv), a.query, static_cast<T*>(a.out), a.m_out,
      a.den_out, a.B, a.D, a.L, a.E, a.H, a.eps, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int dh, const PoolArgs& a) {
  switch (dh) {
    case 16: return launch<T, 16>(a);
    case 48: return launch<T, 48>(a);
    case 96: return launch<T, 96>(a);
    case 128: return launch<T, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [B, D, L, E] contiguous (dtype 0 = bf16, 1 = fp32), ln_scale/ln_bias/query
// fp32 [E], w_kv bf16 [2E, E] contiguous.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape this file does not build.
extern "C" int attentive_pool_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w_kv, const void* query, void* out, void* m_out,
                                  void* den_out, int B, int D, int L, int E, int H, float eps,
                                  int dtype, void* stream) {
  if (H < 1 || E % H != 0 || E % kKC != 0 || E > kMaxE || B < 1 || D < 1 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PoolArgs a{x,
                   static_cast<const float*>(ln_scale),
                   static_cast<const float*>(ln_bias),
                   w_kv,
                   static_cast<const float*>(query),
                   out,
                   static_cast<float*>(m_out),
                   static_cast<float*>(den_out),
                   B, D, L, E, H, eps,
                   static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<__nv_bfloat16>(E / H, a);
  if (dtype == 1) return dispatch<float>(E / H, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
