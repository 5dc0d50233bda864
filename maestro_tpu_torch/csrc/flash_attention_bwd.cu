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
// What bounds it on an H100: operations, 10*B*H*L^2*D for the five products.
// bf16 inputs take three launches that do exactly those ten units:
//   1. attn_bwd_delta: Delta = rowsum(dO o O) in fp32 and lse * log2 e, both
//      [B, H, ceil(L / 64) * 64] (0 and +inf past L); the same launch zeroes
//      the fp32 dQ scratch.
//   2. attn_bwd_wgmma: one block per (128 keys, head, sample), two
//      warpgroups of 64 keys each (256 threads, so up to 255 registers a
//      thread: dK and dV alone hold 128 at D = 128).  Thread 0 loads the
//      block's K and V tiles once by TMA, then streams 64-query tiles of Q
//      and dO through a two-stage ring (TMA completing on mbarriers; the
//      second warpgroup to finish a tile refills its stage, so neither waits
//      for the other), each tile with its rows of lse * log2 e and Delta
//      (bulk copies of rows the Delta launch pads to whole tiles).  Per query
//      tile each warpgroup runs five wgmma products, P and dS rounded to bf16
//      as operands (as the forward rounds P):
//        S^T = K Q^T, dP^T = V dO^T (both operands in shared memory),
//        P^T = exp2(S^T * scale * log2 e - lse * log2 e) (keys past L: 0),
//        dV += P^T dO (A from registers, dO MN-major),
//        dS^T = P^T o (dP^T - Delta),  dK += dS^T Q (A from registers),
//        dQ_part = dS K over its 64 keys: dS^T goes to shared memory (128-byte
//        swizzle, read MN-major), the fp32 partial is staged in shared memory
//        and added into the scratch by one bulk reduce-add
//        (cp.reduce.async.bulk .add.f32), which overlaps the next tile.
//      dK (times scale) and dV leave the registers once, through strides.
//   3. attn_bwd_dq_convert: scratch times scale -> bf16, into dq's strides.
// The dQ scratch is [B, H, ceil(L / 64), D / 8, 128, 4] fp32: for each
// 64-query tile the wgmma accumulators in thread order (float4 j of thread t
// holds row 16(t/32) + (t%32)/4 (+8 for its last two), columns 8j + 2(t%4),
// +1), so staging is conflict-free and the convert pass undoes it.
// Determinism: dK and dV are each written once by one thread and are
// bit-identical from run to run; dQ's fp32 sums arrive from 2 * ceil(L / 128)
// blocks in an order that varies, so dq may differ by a rounding between runs.
// Keys and queries beyond L arrive zero-filled by TMA and are masked (lse =
// +inf, Delta = 0, P = 0), never stored; the 4-D tensor maps keep every tile
// inside its sample.  dQ, dK, dV are written through strides, so they can be
// the three slots of one [B, L, 3, H, D] buffer.
// fp32 inputs take shared-memory FMA kernels with full fp32 products (14
// units: S is formed in a dK/dV kernel and again in a dQ kernel).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include <math_constants.h>

#include "hopper.cuh"

namespace {

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
// 1. Delta = rowsum(dO o O): one warp per (batch, row, head), rows of `rows`
//    entries (L, or L rounded up to the query tile with Delta = 0 past L).
//    With lse2 set it also writes lse * log2 e there (+inf past L), the rows
//    the wgmma kernel copies tile by tile; every thread also zeroes a share of
//    the dQ scratch (n_zero float4s, may be 0).
// ---------------------------------------------------------------------------
constexpr int kDeltaWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
               const float* __restrict__ lse, float* __restrict__ lse2,
               float4* __restrict__ zero, long long n_zero, int B, int L, int rows, int H, int D,
               Strides so, Strides sd) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_zero; i += stride) {
    zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const long long item = (long long)blockIdx.x * kDeltaWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= (long long)B * rows * H) return;
  const int head = item % H;
  const int row = (item / H) % rows;
  const int batch = item / ((long long)H * rows);
  const long long bh = (long long)batch * H + head;
  float acc = 0.f;
  if (row < L) {
    const T* op = o + batch * so.b + row * so.l + head * so.h;
    const T* dp = dout + batch * sd.b + row * sd.l + head * sd.h;
    for (int c = lane; c < D; c += 32) acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    delta[bh * rows + row] = acc;
    if (lse2 != nullptr) {
      lse2[bh * rows + row] = row < L ? lse[bh * L + row] * CUDART_L2E_F : CUDART_INF_F;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. bf16 wgmma kernel
// ---------------------------------------------------------------------------
constexpr int kBK = 128;       // keys per block: 64 per warpgroup
constexpr int kBQ = 64;        // queries per streamed tile
constexpr int kStages = 2;     // Q/dO tiles in flight
constexpr int kThreads = 256;  // two warpgroups, up to 255 registers a thread

template <int D>
struct BwdSmem {
  static constexpr uint32_t KT = kBK * D * 2;  // bytes of the K (or V) tile
  static constexpr uint32_t QT = kBQ * D * 2;  // bytes of one Q (or dO) tile
  static constexpr uint32_t DST = kBQ * 64 * 2;  // one warpgroup's dS^T tile (64 keys x 64 queries)
  static constexpr uint32_t ACC = kBQ * D * 4;   // one warpgroup's fp32 dQ partial
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = KT;
  static constexpr uint32_t Q = 2 * KT;                 // stage s at Q + s * QT
  static constexpr uint32_t DO = Q + kStages * QT;      // stage s at DO + s * QT
  static constexpr uint32_t DS = DO + kStages * QT;     // warpgroup w at DS + w * DST
  static constexpr uint32_t STAGE = DS + 2 * DST;       // warpgroup w at STAGE + w * ACC
  static constexpr uint32_t LSE = STAGE + 2 * ACC;      // [kStages][kBQ] lse * log2 e
  static constexpr uint32_t DEL = LSE + kStages * kBQ * 4;  // [kStages][kBQ] Delta
  static constexpr uint32_t BARS = DEL + kStages * kBQ * 4;  // kv_full, full[kStages]
  static constexpr uint32_t DONE = BARS + 8 * (1 + kStages);    // int count[kStages]
  static constexpr uint32_t BYTES = DONE + 4 * kStages + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int L, Strides sx, float sm_scale,
               float scale_log2) {
  using namespace hopper;
  using T = Tile<D>;
  using S = BwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));  // generic pointer to base
  const uint32_t kv_full = base + S::BARS;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  // warpgroups done with stage s, ever: the second of a tile sees an odd count
  int* done = reinterpret_cast<int*>(gbase + S::DONE);
  auto stage_done = [&](int s) {
    __threadfence_block();
    return (atomicAdd(done + s, 1) & 1) == 1;
  };

  const int head = blockIdx.y, batch = blockIdx.z;
  const int H = gridDim.y;
  const int key0 = blockIdx.x * kBK;
  const int n_q = (L + kBQ - 1) / kBQ;
  const long long bh = (long long)batch * H + head;

  // one thread issues every load: Q and dO tile `it` (TMA), and its rows of
  // lse * log2 e and Delta (bulk copies of the padded rows), into stage it % kStages
  auto load_qdo = [&](int it) {
    const int s = it % kStages;
    mbar_arrive_expect_tx(full(s), 2 * S::QT + 2 * kBQ * 4);
    const uint32_t qs = base + S::Q + s * S::QT, ds = base + S::DO + s * S::QT;
    for (int c = 0; c < D / T::CH; ++c) {
      tma_load_4d(qs + c * kBQ * T::SW, &map_q, full(s), c * T::CH, head, it * kBQ, batch);
      tma_load_4d(ds + c * kBQ * T::SW, &map_do, full(s), c * T::CH, head, it * kBQ, batch);
    }
    const long long row0 = bh * n_q * kBQ + it * kBQ;
    bulk_load(base + S::LSE + s * kBQ * 4, lse2 + row0, kBQ * 4, full(s));
    bulk_load(base + S::DEL + s * kBQ * 4, delta + row0, kBQ * 4, full(s));
  };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      done[s] = 0;
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(kv_full, 2 * S::KT);
    for (int c = 0; c < D / T::CH; ++c) {
      tma_load_4d(base + S::K + c * kBK * T::SW, &map_k, kv_full, c * T::CH, head, key0, batch);
      tma_load_4d(base + S::V + c * kBK * T::SW, &map_v, kv_full, c * T::CH, head, key0, batch);
    }
    for (int it = 0; it < kStages && it < n_q; ++it) load_qdo(it);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const uint32_t k_w = base + S::K + wg * 64 * T::SW;  // this warpgroup's 64 keys
  const uint32_t v_w = base + S::V + wg * 64 * T::SW;
  const uint32_t ds_w = base + S::DS + wg * S::DST;
  const uint32_t acc_w = base + S::STAGE + wg * S::ACC;
  unsigned char* ds_gen = gbase + S::DS + wg * S::DST;
  float4* acc_gen = reinterpret_cast<float4*>(gbase + S::STAGE + wg * S::ACC);
  const int r_lo = key0 + wg * 64 + warp * 16 + g, r_hi = r_lo + 8;  // this thread's keys
  const bool ok_lo = r_lo < L, ok_hi = r_hi < L;
  const float* lse_s = reinterpret_cast<const float*>(gbase + S::LSE);
  const float* del_s = reinterpret_cast<const float*>(gbase + S::DEL);

  float dkacc[D / 2], dvacc[D / 2];
  zero_regs(dkacc);
  zero_regs(dvacc);

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_q; ++it) {
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    const uint32_t qs = base + S::Q + s * S::QT, dos = base + S::DO + s * S::QT;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each
    float st[kBQ / 2], dpt[kBQ / 2];
    zero_regs(st);
    zero_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBQ>::ss<0, 0>(st, desc_k<D>(k_w, kBK, kk), desc_k<D>(qs, kBQ, kk), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBQ>::ss<0, 0>(dpt, desc_k<D>(v_w, kBK, kk), desc_k<D>(dos, kBQ, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp2(S^T * scale * log2 e - lse * log2 e), keys past L masked;
    // lse * log2 e of this thread's query columns 8j + 2t, +1 (+inf past L)
    float l2[kBQ / 4];
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(lse_s + s * kBQ + 8 * j + 2 * t);
      l2[2 * j] = v.x;
      l2[2 * j + 1] = v.y;
    }
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      st[4 * j + 0] = ok_lo ? exp2_approx(st[4 * j + 0] * scale_log2 - l2[2 * j]) : 0.f;
      st[4 * j + 1] = ok_lo ? exp2_approx(st[4 * j + 1] * scale_log2 - l2[2 * j + 1]) : 0.f;
      st[4 * j + 2] = ok_hi ? exp2_approx(st[4 * j + 2] * scale_log2 - l2[2 * j]) : 0.f;
      st[4 * j + 3] = ok_hi ? exp2_approx(st[4 * j + 3] * scale_log2 - l2[2 * j + 1]) : 0.f;
    }
    uint32_t pf[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
    }
    // dV += P^T dO
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      Wgmma<D>::template rs<1>(dvacc, pf[kk], desc_mn<D>(dos, kBQ, kk), 1);
    }
    wgmma_commit();
    // Delta of the same columns (0 past L)
    float dl[kBQ / 4];
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(del_s + s * kBQ + 8 * j + 2 * t);
      dl[2 * j] = v.x;
      dl[2 * j + 1] = v.y;
    }
    // each product completes before the next operand is built, so the
    // registers of an in-flight one stay out of the peak
    wgmma_wait<0>();
    fence_regs(dvacc);
    fence_regs(pf);

    // dS^T = P^T o (dP^T - Delta)
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - dl[2 * j]);
      dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - dl[2 * j + 1]);
      dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - dl[2 * j]);
      dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - dl[2 * j + 1]);
    }
    uint32_t sf[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) sf[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
    }
    // dS^T -> shared memory, rows = keys, 128-byte rows of 64 queries,
    // 16-byte group j of row r stored at group j ^ (r % 8)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = warp * 16 + g + 8 * (r & 1);
        const int grp = 2 * kk + (r >> 1);  // query columns 8 * grp + 2t, +1
        *reinterpret_cast<uint32_t*>(ds_gen + row * 128 + ((grp ^ g) << 4) + 4 * t) = sf[kk][r];
      }
    }
    fence_proxy_async();
    if (tid == 0) bulk_wait_read_all();  // the last reduce has read the staging buffer
    named_bar_sync(1 + wg, 128);         // dS^T is in shared memory
    // dK += dS^T Q, and the dQ partial = dS K over this warpgroup's 64 keys
    float dq[D / 2];
    zero_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      Wgmma<D>::template rs<1>(dkacc, sf[kk], desc_mn<D>(qs, kBQ, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      Wgmma<D>::template ss<1, 1>(dq, desc_mn<64>(ds_w, 64, kk), desc_mn<D>(k_w, kBK, kk),
                                  kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dkacc);
    fence_regs(sf);
    fence_regs(dq);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc_gen[j * 128 + tid] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);  // the staged partial is complete; Q and dO are read
    if (tid == 0) {
      bulk_reduce_add_f32(dq_acc + (bh * n_q + it) * kBQ * D, acc_w, S::ACC);
      bulk_commit();
      // the second warpgroup done with tile it refills its stage: neither
      // waits for the other
      if (stage_done(s) && it + kStages < n_q) load_qdo(it + kStages);
    }
    __syncwarp();  // warp 0 reconverges before the next warp-aligned wgmma
  }
  if (tid == 0) bulk_wait_all();

  __nv_bfloat16* dkb = dk + batch * sx.b + head * sx.h;
  __nv_bfloat16* dvb = dv + batch * sx.b + head * sx.h;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (ok_lo) {
      *reinterpret_cast<uint32_t*>(dkb + (long long)r_lo * sx.l + c) =
          pack_bf16(dkacc[4 * i] * sm_scale, dkacc[4 * i + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dvb + (long long)r_lo * sx.l + c) =
          pack_bf16(dvacc[4 * i], dvacc[4 * i + 1]);
    }
    if (ok_hi) {
      *reinterpret_cast<uint32_t*>(dkb + (long long)r_hi * sx.l + c) =
          pack_bf16(dkacc[4 * i + 2] * sm_scale, dkacc[4 * i + 3] * sm_scale);
      *reinterpret_cast<uint32_t*>(dvb + (long long)r_hi * sx.l + c) =
          pack_bf16(dvacc[4 * i + 2], dvacc[4 * i + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq = scale * scratch, from the fragment-ordered scratch into dq's strides
// ---------------------------------------------------------------------------
constexpr int kConvertThreads = 256;

__global__ void __launch_bounds__(kConvertThreads)
attn_bwd_dq_convert(const float4* __restrict__ acc, __nv_bfloat16* __restrict__ dq, int L, int H,
                    int D, int n_q, long long n4, Strides sx, float sm_scale) {
  const long long i = (long long)blockIdx.x * kConvertThreads + threadIdx.x;
  if (i >= n4) return;
  const long long per_tile = 16LL * D;  // float4s of one 64-query tile
  const long long tile = i / per_tile;
  const int within = static_cast<int>(i % per_tile);
  const int j = within / 128, t = within % 128;
  const int qt = static_cast<int>(tile % n_q);
  const long long bh = tile / n_q;
  const int head = static_cast<int>(bh % H);
  const long long batch = bh / H;
  const int row = qt * kBQ + 16 * (t / 32) + (t % 32) / 4;
  const int col = 8 * j + 2 * (t % 4);
  const float4 v = acc[i];
  __nv_bfloat16* base = dq + batch * sx.b + head * sx.h + col;
  if (row < L) {
    *reinterpret_cast<uint32_t*>(base + (long long)row * sx.l) =
        hopper::pack_bf16(v.x * sm_scale, v.y * sm_scale);
  }
  if (row + 8 < L) {
    *reinterpret_cast<uint32_t*>(base + (long long)(row + 8) * sx.l) =
        hopper::pack_bf16(v.z * sm_scale, v.w * sm_scale);
  }
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
  float* dq_acc;
  void *dq, *dk, *dv;
  int B, L, H;
  Strides sq, sk, sv, so, sd, sx;
  float sm_scale;
  cudaStream_t stream;
};

// rows: entries per (batch, head) row of delta (and of lse2 when set)
template <typename T>
int launch_delta(const Args& a, int D, int rows, float* lse2, long long n_zero4) {
  const long long items = (long long)a.B * rows * a.H;
  const unsigned blocks = static_cast<unsigned>((items + kDeltaWarps - 1) / kDeltaWarps);
  attn_bwd_delta<T><<<blocks, kDeltaWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.lse, lse2,
      reinterpret_cast<float4*>(a.dq_acc), n_zero4, a.B, a.L, rows, a.H, D, a.so, a.sd);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int dtype) {
  using bf = __nv_bfloat16;
  if (dtype == 0) {
    using T = hopper::Tile<D>;
    const int n_q = (a.L + kBQ - 1) / kBQ;
    const long long n4 = (long long)a.B * a.H * n_q * 16 * D;  // float4s of the dQ scratch
    CUtensorMap mq, mk, mv, mdo;
    int err = hopper_host::encode_blhd(&mq, a.q, a.B, a.L, a.H, D, a.sq.b, a.sq.l, a.sq.h, T::CH,
                                       kBQ, 0);
    if (err == 0) {
      err = hopper_host::encode_blhd(&mk, a.k, a.B, a.L, a.H, D, a.sk.b, a.sk.l, a.sk.h, T::CH,
                                     kBK, 1);
    }
    if (err == 0) {
      err = hopper_host::encode_blhd(&mv, a.v, a.B, a.L, a.H, D, a.sv.b, a.sv.l, a.sv.h, T::CH,
                                     kBK, 2);
    }
    if (err == 0) {
      err = hopper_host::encode_blhd(&mdo, a.dout, a.B, a.L, a.H, D, a.sd.b, a.sd.l, a.sd.h,
                                     T::CH, kBQ, 3);
    }
    if (err != 0) return err;
    // delta holds two [B, H, n_q * 64] halves: Delta, then lse * log2 e
    const long long half = (long long)a.B * a.H * n_q * kBQ;
    float* lse2 = a.delta + half;
    err = launch_delta<bf>(a, D, n_q * kBQ, lse2, n4);
    if (err != 0) return err;
    constexpr uint32_t smem = BwdSmem<D>::BYTES;
    static_assert(smem <= 227 * 1024, "tiles exceed an SM's shared memory");
    static bool smem_raised = false;  // per head dim; setting it twice is harmless
    if (!smem_raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          attn_bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return hopper_host::kSmemRefused + static_cast<int>(e);
      smem_raised = true;
    }
    dim3 grid((a.L + kBK - 1) / kBK, a.H, a.B);
    attn_bwd_wgmma<D><<<grid, kThreads, smem, a.stream>>>(
        mq, mk, mv, mdo, lse2, a.delta, a.dq_acc, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
        a.L, a.sx, a.sm_scale, a.sm_scale * CUDART_L2E_F);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return hopper_host::kLaunchRefused + err;
    const unsigned blocks = static_cast<unsigned>((n4 + kConvertThreads - 1) / kConvertThreads);
    attn_bwd_dq_convert<<<blocks, kConvertThreads, 0, a.stream>>>(
        reinterpret_cast<const float4*>(a.dq_acc), static_cast<bf*>(a.dq), a.L, a.H, D, n_q, n4,
        a.sx, a.sm_scale);
  } else {
    int err = launch_delta<float>(a, D, a.L, nullptr, 0);
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

// Three launches on `stream` (bf16: Delta + zeroed scratch, the wgmma kernel,
// the dq convert; fp32: Delta, dK/dV, dQ).  Returns cudaGetLastError() after
// them (0 = launched), or cudaErrorInvalidValue for a head dim / dtype this
// file does not build; hopper_host's codes for a refused tensor map or
// shared-memory size.  lse: the
// forward's fp32 [B, H, L]; delta: fp32 scratch, [B, H, L] for fp32 and
// [2, B, H, ceil(L / 64) * 64] for bf16 (Delta, lse * log2 e); dq_acc: for bf16
// the fp32 dQ scratch of B * H * ceil(L / 64) * 64 * D floats (any contents;
// null for fp32); dq, dk, dv share the strides (x_sb, x_sl, x_sh).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, float* dq_acc, void* dq, void* dk, void* dv, int B, int L,
    int H, int D, long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, long long d_sb, long long d_sl, long long d_sh,
    long long x_sb, long long x_sl, long long x_sh, float sm_scale, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && dq_acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv, B, L, H,
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

// Dynamic shared memory of one bf16 wgmma block at head dim D (0 if not built).
extern "C" int flash_attention_bwd_smem(int D) {
  switch (D) {
    case 32: return static_cast<int>(BwdSmem<32>::BYTES);
    case 64: return static_cast<int>(BwdSmem<64>::BYTES);
    case 96: return static_cast<int>(BwdSmem<96>::BYTES);
    case 128: return static_cast<int>(BwdSmem<128>::BYTES);
    default: return 0;
  }
}
