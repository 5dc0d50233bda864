// Pieces shared by the attentive date pool's forward (attn_pool.cu) and
// backward (attn_pool_bwd.cu), both written on the factored form of the pool.
//
// With s = dh^-1/2, y_d = LayerNorm(x_d) and W_k, W_v the two halves of W_kv
// (nn.Linear layout [2E, E]), per head h:
//   u_h      = sum_{j in h} q_j W_k[j, :]          ([H, E]: the k projection is never formed)
//   logit_dh = s * y_d . u_h
//   ybar_h   = sum_d a_dh y_d                      (a = softmax over the dates)
//   out_h    = W_v,h . ybar_h                      (once per position, not per date)
// so a (batch, date, position) row costs about 4EH + 8E operations instead of
// the 4E^2 of a kv projection, and the E^2 products remain once per position.
//
// Here:
//   pool_u      u [kMaxHeads, E] fp32 from the bf16 W_k and the fp32 query
//               (rows h >= H are zero);
//   pool_mma    a tile product C = A . B on the tensor cores (mma.sync
//               m16n8k16, bf16 operands, fp32 accumulation), batched over the
//               heads and split over K, for the per-position products;
//   the row-kernel helpers: a row kernel's thread owns NC consecutive
//   columns of E, so a sum over a row is a block-wide reduction.  A
//   warp reduces V partial values with the halving butterfly (V - 1 shuffles
//   for V >= 32, not 5V), one lane of each value's lane group writes its
//   warp's total to shared memory, and after one barrier every warp adds the
//   warps' totals itself, in a fixed order (one value a lane): each warp gets
//   the same bits, so it needs no second barrier, and every sum is the same
//   from one call to the next.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace pool {

using bf16 = __nv_bfloat16;

constexpr int kMaxHeads = 8;                 // every per-(head, column) array is this wide
constexpr int kMaxE = 1024;
constexpr int kDC = 4;                       // dates a row kernel takes per step

// threads and warps of a row-kernel block whose threads own NC columns each
template <int NC>
constexpr int kMaxThreads = kMaxE / NC;
template <int NC>
constexpr int kMaxWarps = kMaxThreads<NC> / 32;

// the plain version rounds y to x's dtype before the logits and the pooled sum
template <typename T>
__device__ __forceinline__ float round_as(float v);
template <>
__device__ __forceinline__ float round_as<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ float round_as<float>(float v) {
  return v;
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 raw;
  raw.x = mma::pack_bf16(v[0], v[1]);
  raw.y = mma::pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// NC consecutive elements (NC a multiple of 4), as four-element pieces
template <int NC, typename T>
__device__ __forceinline__ void loadN(const T* p, float (&v)[NC]) {
#pragma unroll
  for (int i = 0; i < NC / 4; ++i) load4(p + 4 * i, *reinterpret_cast<float(*)[4]>(v + 4 * i));
}

template <int NC, typename T>
__device__ __forceinline__ void storeN(T* p, const float (&v)[NC]) {
#pragma unroll
  for (int i = 0; i < NC / 4; ++i) {
    store4(p + 4 * i, *reinterpret_cast<const float(*)[4]>(v + 4 * i));
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = mma::pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Where a row kernel is: position (b, l) and the first date d0 of a step of
// kDC dates.  Advanced a step at a time, so no division in the loop.
struct Cursor {
  long long b;
  int l, d0;

  __device__ __forceinline__ Cursor(long long pos, int L)
      : b(pos / L), l(static_cast<int>(pos % L)), d0(0) {}
  __device__ __forceinline__ void advance(int D, int L) {
    d0 += kDC;
    if (d0 >= D) {
      d0 = 0;
      if (++l == L) {
        l = 0;
        ++b;
      }
    }
  }
  // offset of date d of this position in x [B, D, L, E]
  __device__ __forceinline__ long long row(int d, int D, int L, int E) const {
    return ((b * D + d) * L + l) * static_cast<long long>(E);
  }
};

// The x rows of a step in shared memory, copied by cp.async a step ahead: a
// barrier waits for outstanding loads into registers, but not for cp.async,
// so the copies stay in flight across the steps' block reductions.  A stage
// holds kDC rows of E; a thread copies and reads only its own columns, so its
// own cp.async.wait_group is all the ordering a stage needs.  Rows past D
// read as 0.
template <typename T, int NC>
struct XStages {
  T* base;  // [stages][kDC][E]

  __device__ __forceinline__ void issue(const T* __restrict__ x, const Cursor& at, int stage, int D,
                                        int L, int E, int c0, bool active) const {
    constexpr int kStep = 16 / sizeof(T);  // elements a 16-byte copy moves
    static_assert(NC % kStep == 0, "16-byte copies");
    if (!active) return;
#pragma unroll
    for (int r = 0; r < kDC; ++r) {
      const bool valid = at.d0 + r < D;
      const T* src = valid ? x + at.row(at.d0 + r, D, L, E) + c0 : x;
      T* dst = base + (stage * kDC + r) * E + c0;
#pragma unroll
      for (int k = 0; k < NC; k += kStep) mma::cp_async_16(dst + k, valid ? src + k : x, valid);
    }
  }
  __device__ __forceinline__ void get(int stage, int r, int E, int c0, float (&v)[NC]) const {
    loadN<NC>(base + (stage * kDC + r) * E + c0, v);
  }
};

// A thread's LayerNorm partial sums of a step's rows (its own columns), in
// fp64: sums [0, kDC), sums of squares [kDC, 2 kDC).  In fp64 the row's
// mean and variance come out as the exact values rounded once to fp32, so y
// rounds to bf16 as the plain version's does in all but rare ties.
template <typename T, int NC>
__device__ __forceinline__ void ln_partials(const XStages<T, NC>& xs, int stage, int E, int c0,
                                            bool active, double (&part)[2 * kDC]) {
#pragma unroll
  for (int r = 0; r < kDC; ++r) {
    double s1 = 0.0, s2 = 0.0;
    if (active) {
      float xv[NC];
      xs.get(stage, r, E, c0, xv);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        s1 += xv[j];
        s2 += static_cast<double>(xv[j]) * xv[j];
      }
    }
    part[r] = s1;
    part[kDC + r] = s2;
  }
}

// xhat = (x - mu) * rstd and y = xhat * scale + bias in the plain version's
// order of fp32 operations (no fused multiply-add): y rounds as its does
__device__ __forceinline__ float ln_xhat(float x, float mu, float rstd) {
  return __fmul_rn(__fsub_rn(x, mu), rstd);
}
__device__ __forceinline__ float ln_y(float xhat, float scale, float bias) {
  return __fadd_rn(__fmul_rn(xhat, scale), bias);
}

// One step of the halving butterfly: N live values; the lane with bit OFF set
// keeps the upper half, its partner the lower, each adding what the other
// sends.  When one value is left, the remaining offsets reduce it whole.
template <int N, int OFF, typename V>
__device__ __forceinline__ void halve(V* v, int lane) {
  if constexpr (OFF > 0) {
    if constexpr (N == 1) {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      halve<1, OFF / 2, V>(v, lane);
    } else {
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const V send = upper ? v[i] : v[i + N / 2];
        const V keep = upper ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      halve<N / 2, OFF / 2, V>(v, lane);
    }
  }
}

// Sums v[0..V) over the warp and writes the warp's totals to dst[0..V) (its
// row of a [warps][stride] array).  V is a power of two.  After the butterfly,
// lane l holds the totals of values l*(V/32) .. l*(V/32) + V/32 - 1 (V >= 32),
// or of value l / (32/V).
template <int V, typename W>
__device__ __forceinline__ void warp_totals(W (&v)[V], W* dst, int lane) {
  halve<V, 16, W>(v, lane);
  if constexpr (V >= 32) {
#pragma unroll
    for (int i = 0; i < V / 32; ++i) dst[lane * (V / 32) + i] = v[i];
  } else {
    if (lane % (32 / V) == 0) dst[lane / (32 / V)] = v[0];
  }
}

// the block's total of value k of a [warps][stride] array, adding the warps
// in order (all loads issued first): every warp that asks gets the same bits
template <int MAX_WARPS, typename W>
__device__ __forceinline__ W block_total(const W* red, int stride, int k, int warps) {
  W part[MAX_WARPS];
#pragma unroll
  for (int w = 0; w < MAX_WARPS; ++w) part[w] = w < warps ? red[w * stride + k] : W(0);
  W s = part[0];
#pragma unroll
  for (int w = 1; w < MAX_WARPS; ++w) {
    if (w < warps) s += part[w];
  }
  return s;
}

// Lanes r < kDC of a warp: mean and 1/std of row r from the block's fp64 sums
// (values [0, 2 kDC) of a [warps][stride] array); rstd = rsqrt(var + eps) in
// fp32, as the plain version takes it.  Every lane takes part (the shuffle).
template <int MAX_WARPS>
__device__ __forceinline__ void ln_finalize(const double* red, int stride, int warps, int lane,
                                            int E, float eps, float* mu, float* rstd) {
  const double tot = lane < 2 * kDC ? block_total<MAX_WARPS>(red, stride, lane, warps) / E : 0.0;
  const double sq = __shfl_down_sync(0xffffffffu, tot, kDC);
  if (lane < kDC) {
    mu[lane] = static_cast<float>(tot);
    rstd[lane] = rsqrtf(__fadd_rn(static_cast<float>(fmax(sq - tot * tot, 0.0)), eps));
  }
}

// u[h][e] = sum_{j < dh} query[h*dh + j] * W_k[h*dh + j][e], rows h >= H zero.
// grid (ceil(E / 128), kMaxHeads), 128 threads.
__global__ void pool_u(const bf16* __restrict__ w_kv, const float* __restrict__ query,
                       float* __restrict__ u, int E, int H, int dh) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  if (e >= E) return;
  float s = 0.f;
  if (h < H) {
    const bf16* w = w_kv + static_cast<long long>(h) * dh * E + e;
    const float* q = query + h * dh;
    for (int j = 0; j < dh; ++j) s += q[j] * __bfloat162float(w[static_cast<long long>(j) * E]);
  }
  u[h * E + e] = s;
}

// ---------------------------------------------------------------- tile product
// C[z](m, n) = sum_k A[z](m, k) B[z](k, n), for m < M, n < N and k in the
// split's range; z = head * splits + split.  A is stored k-contiguous
// (element (m, k) at a + m*lda + k) or, with A_MC, m-contiguous (a + k*lda + m);
// B k-contiguous (b + n*ldb + k) or, with B_NC, n-contiguous (b + k*ldb + n).
// Each head adds a_head / b_head / c_head elements, each split c_split.  The
// contiguous dimension of each operand is a multiple of 8 and 16-byte aligned;
// out-of-range chunks of 8 are zero-filled by cp.async.
constexpr int kBM = 64, kBN = 64, kBK = 32, kMmaThreads = 128;

struct MmaArgs {
  const bf16* a;
  long long lda, a_head;
  const bf16* b;
  long long ldb, b_head;
  void* c;
  long long ldc, c_head, c_split;
  int m, n, k, k_split, splits;
};

// 64 x 64 output tile a block, four warps of 32 x 32, K in 32-deep stages
// through a two-stage cp.async ring; fragments by ldmatrix (.trans for an
// operand stored along M or N).
template <bool A_MC, bool B_NC, typename OutT>
__global__ void __launch_bounds__(kMmaThreads) pool_mma(const MmaArgs p) {
  constexpr int AR = A_MC ? kBK : kBM, AW = A_MC ? kBM : kBK;  // stored rows x width
  constexpr int BR = B_NC ? kBK : kBN, BW = B_NC ? kBN : kBK;
  constexpr int kPad = 8;  // rows 16 bytes apart mod 128: ldmatrix without bank conflicts
  __shared__ __align__(16) bf16 As[2][AR][AW + kPad];
  __shared__ __align__(16) bf16 Bs[2][BR][BW + kPad];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int lm_mat = lane >> 3, lm_row = lane & 7;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int head = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int k_begin = split * p.k_split;
  const int k_end = min(p.k, k_begin + p.k_split);
  const bf16* A = p.a + head * p.a_head;
  const bf16* B = p.b + head * p.b_head;

  auto load = [&](int k0, int st) {
    for (int idx = tid; idx < AR * AW / 8; idx += kMmaThreads) {
      const int r = idx / (AW / 8), c = (idx % (AW / 8)) * 8;
      const int mm = A_MC ? m0 + c : m0 + r, kk = A_MC ? k0 + r : k0 + c;
      const bool ok = mm < p.m && kk < k_end;
      const bf16* src = A_MC ? A + static_cast<long long>(kk) * p.lda + mm
                             : A + static_cast<long long>(mm) * p.lda + kk;
      mma::cp_async_16(&As[st][r][c], ok ? src : p.a, ok);
    }
    for (int idx = tid; idx < BR * BW / 8; idx += kMmaThreads) {
      const int r = idx / (BW / 8), c = (idx % (BW / 8)) * 8;
      const int nn = B_NC ? n0 + c : n0 + r, kk = B_NC ? k0 + r : k0 + c;
      const bool ok = nn < p.n && kk < k_end;
      const bf16* src = B_NC ? B + static_cast<long long>(kk) * p.ldb + nn
                             : B + static_cast<long long>(nn) * p.ldb + kk;
      mma::cp_async_16(&Bs[st][r][c], ok ? src : p.b, ok);
    }
    mma::cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }

  const int n_k = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  if (n_k > 0) load(k_begin, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    // the other stage was last read in the previous step, which ended in a barrier
    if (kt + 1 < n_k) {
      load(k_begin + (kt + 1) * kBK, st ^ 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int mb = wm * 32 + mt * 16;
        if constexpr (A_MC) {
          mma::ldmatrix_x4_trans(a[mt], &As[st][ks * 16 + (lm_mat >> 1) * 8 + lm_row]
                                           [mb + (lm_mat & 1) * 8]);
        } else {
          mma::ldmatrix_x4(a[mt], &As[st][mb + (lm_mat & 1) * 8 + lm_row]
                                     [ks * 16 + (lm_mat >> 1) * 8]);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nb = wn * 32 + np * 16;
        uint32_t bfr[4];
        if constexpr (B_NC) {
          mma::ldmatrix_x4_trans(bfr, &Bs[st][ks * 16 + (lm_mat & 1) * 8 + lm_row]
                                         [nb + (lm_mat >> 1) * 8]);
        } else {
          mma::ldmatrix_x4(bfr, &Bs[st][nb + (lm_mat >> 1) * 8 + lm_row]
                                   [ks * 16 + (lm_mat & 1) * 8]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma::mma_bf16_16816(acc[mt][2 * np], a[mt], bfr[0], bfr[1]);
          mma::mma_bf16_16816(acc[mt][2 * np + 1], a[mt], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  OutT* C = static_cast<OutT*>(p.c) + head * p.c_head + split * p.c_split;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row = m0 + wm * 32 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t;
      if (col >= p.n) continue;
      if (row < p.m) {
        store2(C + static_cast<long long>(row) * p.ldc + col, acc[mt][nt][0], acc[mt][nt][1]);
      }
      if (row + 8 < p.m) {
        store2(C + static_cast<long long>(row + 8) * p.ldc + col, acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

template <bool A_MC, bool B_NC, typename OutT>
int launch_mma(const MmaArgs& p, int heads, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.m + kBM - 1) / kBM),
                  static_cast<unsigned>((p.n + kBN - 1) / kBN),
                  static_cast<unsigned>(heads * p.splits));
  pool_mma<A_MC, B_NC, OutT><<<grid, kMmaThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- launch helpers
inline bool supported_shape(int E, int H) {
  if (H < 1 || H > kMaxHeads || E % H != 0 || E % 64 != 0 || E > kMaxE) return false;
  const int dh = E / H;
  return dh == 16 || dh == 48 || dh == 96 || dh == 128;
}

inline int row_threads(int E, int cols) { return (E / cols + 31) / 32 * 32; }

inline int sm_count() {
  int dev = 0, n = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Positions a row-kernel block takes: as many blocks as fit on the card at
// once, each over a contiguous run of positions (the same for every call).
struct RowGrid {
  long long per_block;
  int blocks;
};

template <typename Kernel>
int row_grid(Kernel kernel, long long n_pos, int threads, size_t smem, RowGrid* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long target = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
  out->per_block = (n_pos + target - 1) / target;
  out->blocks = static_cast<int>((n_pos + out->per_block - 1) / out->per_block);
  return 0;
}

}  // namespace pool
