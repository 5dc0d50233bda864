// flash_attention_fwd: exact (non-causal) softmax attention on the head-packed
// [B, L, H, D] layout, read through strides so q, k, v can be views of a fused
// qkv projection.  Forward; the backward is flash_attention_bwd.cu, which reads
// the optional fp32 logsumexp [B, H, L] this kernel writes when given a
// pointer (the serving path passes none and writes nothing extra).
//
// Replaces the forward attention tiers of the JAX package's ops/attention.py
// (_pk_fwd_kernel, _qb_fwd_kernel, _sb_fwd_kernel, the stock flash kernel and
// the short-sequence einsum): fp32 scores, fp32 softmax, P rounded to V's
// dtype before P.V, fp32 accumulation, output in the input dtype.
//
// What bounds it on an H100: operations (4*B*H*L^2*D against 4*B*L*H*D
// elements moved: L/2 operations a byte, above the card's ~295 from L ~600).
// Two kernels:
//   * attn_fwd_wgmma (bf16): one block per (128 query rows, head, sample),
//     two warpgroups of 64 rows each.  Thread 0 loads the block's Q tile once;
//     128-key K and V tiles stream through a two-stage ring by TMA
//     (cp.async.bulk.tensor on 4-D maps of the strided views; each load
//     completes on its stage's mbarrier).  The second warpgroup to finish a
//     tile refills its stage (a shared-memory count decides), so neither
//     waits for the other and one's softmax overlaps the other's products.
//     S = Q.K^T is a wgmma m64n128k16 with both operands in swizzled shared
//     memory; the online softmax runs in fp32 registers in the log2 domain
//     (scale * log2 e folded into the FFMA before each ex2; keys past L,
//     zero-filled by TMA, masked in the last tile); P is rounded to bf16 in
//     registers and O += P.V is a wgmma with A from registers and V's tile
//     (MN-major) from shared memory.  Rows past L are not stored; O and the
//     logsumexp go out through their strides.  Shared memory at D = 128:
//     Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB.  No producer warp: a third
//     warpgroup would hold every thread to 168 registers (setmaxnreg did not
//     lift ptxas's budget), which the backward cannot live with; two
//     warpgroups leave 255.
//   * attn_fma (fp32): products as shared-memory FMA loops in full fp32, 16
//     query rows per block, 32 keys per tile.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr float kMasked = -1e30f;  // finite: a tile always holds a valid key

struct Strides {
  long long b, l, h;  // element strides of batch, row, head; D is contiguous
};

// ---------------------------------------------------------------------------
// bf16 wgmma kernel
// ---------------------------------------------------------------------------
constexpr int kBM = 128;       // query rows per block: 64 per warpgroup
constexpr int kBN = 128;       // keys per K/V tile
constexpr int kStages = 2;     // K/V tiles in flight
constexpr int kThreads = 256;  // two warpgroups, up to 255 registers a thread

template <int D>
struct FwdSmem {
  static constexpr uint32_t TILE = kBN * D * 2;  // bytes of a 128-row tile (Q, K or V)
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = TILE;                     // K of stage s at K + s * 2 * TILE
  static constexpr uint32_t V = 2 * TILE;                 // V of stage s at V + s * 2 * TILE
  static constexpr uint32_t BARS = (1 + 2 * kStages) * TILE;  // q_full, full[kStages]
  static constexpr uint32_t DONE = BARS + 8 * (1 + kStages);    // int count[kStages]
  static constexpr uint32_t BYTES = DONE + 4 * kStages + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int L, Strides so, float scale_log2) {
  using namespace hopper;
  using T = Tile<D>;
  using S = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + S::BARS;  // then full[kStages]
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  // warpgroups done with stage s, ever: the second of a tile sees an odd count
  int* done = reinterpret_cast<int*>(smem_raw + (base - smem_u32(smem_raw)) + S::DONE);
  auto stage_done = [&](int s) {
    __threadfence_block();
    return (atomicAdd(done + s, 1) & 1) == 1;
  };

  const int head = blockIdx.y, batch = blockIdx.z;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (L + kBN - 1) / kBN;

  // thread 0 issues every TMA load: K/V tile j into stage j % kStages
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    mbar_arrive_expect_tx(full(s), 2 * S::TILE);
    const uint32_t ks = base + S::K + s * 2 * S::TILE, vs = base + S::V + s * 2 * S::TILE;
    for (int c = 0; c < D / T::CH; ++c) {
      tma_load_4d(ks + c * kBN * T::SW, &map_k, full(s), c * T::CH, head, j * kBN, batch);
      tma_load_4d(vs + c * kBN * T::SW, &map_v, full(s), c * T::CH, head, j * kBN, batch);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      done[s] = 0;
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(q_full, S::TILE);
    for (int c = 0; c < D / T::CH; ++c) {
      tma_load_4d(base + S::Q + c * kBM * T::SW, &map_q, q_full, c * T::CH, head, q0, batch);
    }
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const uint32_t q_tile = base + S::Q + wg * 64 * T::SW;  // this warpgroup's rows

  float oacc[D / 2];
  zero_regs(oacc);
  float m_lo = kMasked, m_hi = kMasked;  // running max (log2 domain) of rows g, g + 8
  float l_lo = 0.f, l_hi = 0.f;          // this thread's share of the running sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(full(s), (j / kStages) & 1);
    const uint32_t ks = base + S::K + s * 2 * S::TILE, vs = base + S::V + s * 2 * S::TILE;

    // S = Q K^T: 64 rows x 128 keys
    float sacc[kBN / 2];
    zero_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBN>::ss<0, 0>(sacc, desc_k<D>(q_tile, kBM, kk), desc_k<D>(ks, kBN, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // keys past L (the last tile only) masked; row max of the raw scores
    const int key0 = j * kBN;
    if (key0 + kBN > L) {
#pragma unroll
      for (int c = 0; c < kBN / 8; ++c) {
        const int col = key0 + 8 * c + 2 * t;
        if (col >= L) sacc[4 * c + 0] = sacc[4 * c + 2] = kMasked;
        if (col + 1 >= L) sacc[4 * c + 1] = sacc[4 * c + 3] = kMasked;
      }
    }
    float mx_lo = kMasked, mx_hi = kMasked;
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c) {
      mx_lo = fmaxf(mx_lo, fmaxf(sacc[4 * c + 0], sacc[4 * c + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sacc[4 * c + 2], sacc[4 * c + 3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // running max in the log2 domain (scale * log2 e > 0 keeps the order)
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2), mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float alpha_lo = exp2_approx(m_lo - mn_lo), alpha_hi = exp2_approx(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      oacc[4 * i + 0] *= alpha_lo;
      oacc[4 * i + 1] *= alpha_lo;
      oacc[4 * i + 2] *= alpha_hi;
      oacc[4 * i + 3] *= alpha_hi;
    }

    // P = exp2(S * scale * log2 e - m) in fp32 (one FFMA and one ex2 each),
    // summed in fp32, rounded to bf16 as the A operand
    uint32_t pf[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float mn = (r & 1) ? mn_hi : mn_lo;
        const float p0 = exp2_approx(fmaf(sacc[8 * kk + 2 * r], scale_log2, -mn));
        const float p1 = exp2_approx(fmaf(sacc[8 * kk + 2 * r + 1], scale_log2, -mn));
        if (r & 1) {
          l_hi += p0 + p1;
        } else {
          l_lo += p0 + p1;
        }
        pf[kk][r] = pack_bf16(p0, p1);
      }
    }

    // O += P V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      Wgmma<D>::template rs<1>(oacc, pf[kk], desc_mn<D>(vs, kBN, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pf);
    // the second warpgroup done with tile j refills its stage: neither waits
    // for the other, so the two drift apart and their softmax phases overlap
    // the other's products
    named_bar_sync(1 + wg, 128);
    if (tid == 0 && stage_done(s) && j + kStages < n_tiles) load_kv(j + kStages);
    __syncwarp();  // warp 0 reconverges before the next warp-aligned wgmma
  }

  // finish the row sums across the four threads that share a row
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int r_lo = q0 + wg * 64 + warp * 16 + g, r_hi = r_lo + 8;
  __nv_bfloat16* ob = o + batch * so.b + head * so.h;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (r_lo < L) {
      *reinterpret_cast<uint32_t*>(ob + (long long)r_lo * so.l + c) =
          pack_bf16(oacc[4 * i + 0] * inv_lo, oacc[4 * i + 1] * inv_lo);
    }
    if (r_hi < L) {
      *reinterpret_cast<uint32_t*>(ob + (long long)r_hi * so.l + c) =
          pack_bf16(oacc[4 * i + 2] * inv_hi, oacc[4 * i + 3] * inv_hi);
    }
  }
  if (lse != nullptr && t == 0) {  // natural-log logsumexp of the scaled scores, [B, H, L]
    float* lb = lse + ((long long)batch * gridDim.y + head) * L;
    if (r_lo < L) lb[r_lo] = (m_lo + __log2f(l_lo)) * CUDART_LN2_F;
    if (r_hi < L) lb[r_hi] = (m_hi + __log2f(l_hi)) * CUDART_LN2_F;
  }
}

// ---------------------------------------------------------------------------
// fp32 FMA kernel
// ---------------------------------------------------------------------------
constexpr int kFM = 16;        // query rows per block
constexpr int kFN = 32;        // keys per tile (one per lane in the softmax)
constexpr int kFThreads = 128;

template <int D>
__global__ void __launch_bounds__(kFThreads)
attn_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         float* __restrict__ o, float* __restrict__ lse, int L, Strides sq, Strides sk,
         Strides sv, Strides so, float sm_scale) {
  __shared__ float Qs[kFM][D];
  __shared__ float Ks[kFN][D + 1];  // +1: lanes read one column of 32 rows
  __shared__ float Vs[kFN][D];
  __shared__ float Ps[kFM][kFN + 1];
  __shared__ float alpha_s[kFM];
  __shared__ float m_s[kFM];
  __shared__ float l_s[kFM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row0 = blockIdx.x * kFM;

  const float* qb = q + batch * sq.b + head * sq.h;
  const float* kb = k + batch * sk.b + head * sk.h;
  const float* vb = v + batch * sv.b + head * sv.h;

  for (int idx = tid; idx < kFM * D; idx += kFThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r][c] = row0 + r < L ? qb[(long long)(row0 + r) * sq.l + c] : 0.f;
  }
  if (tid < kFM) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }

  // this thread's output slice: row orow, columns ocol + 8*i
  const int orow = tid >> 3;
  const int ocol = tid & 7;
  float oacc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) oacc[i] = 0.f;

  const int n_tiles = (L + kFN - 1) / kFN;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kFN;
    __syncthreads();
    for (int idx = tid; idx < kFN * D; idx += kFThreads) {
      const int r = idx / D, c = idx % D;
      const bool live = key0 + r < L;
      Ks[r][c] = live ? kb[(long long)(key0 + r) * sk.l + c] : 0.f;
      Vs[r][c] = live ? vb[(long long)(key0 + r) * sv.l + c] : 0.f;
    }
    __syncthreads();

    // scores: warp w owns rows w, w+4, w+8, w+12; lane = key within the tile
#pragma unroll
    for (int rr = 0; rr < kFM / 4; ++rr) {
      const int r = warp + 4 * rr;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) acc = fmaf(Qs[r][c], Ks[lane][c], acc);
      const float sc = key0 + lane < L ? acc * sm_scale : kMasked;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(sc - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[r][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();

    const float alpha = alpha_s[orow];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) oacc[i] *= alpha;
    for (int j = 0; j < kFN; ++j) {
      const float p = Ps[orow][j];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) oacc[i] = fmaf(p, Vs[j][ocol + 8 * i], oacc[i]);
    }
  }
  __syncthreads();

  if (row0 + orow < L) {
    const float inv = 1.f / l_s[orow];
    float* op = o + batch * so.b + head * so.h + (long long)(row0 + orow) * so.l;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) op[ocol + 8 * i] = oacc[i] * inv;
    if (lse != nullptr && ocol == 0) {
      lse[((long long)batch * gridDim.y + head) * L + row0 + orow] = m_s[orow] + logf(l_s[orow]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int L, int H,
           Strides sq, Strides sk, Strides sv, Strides so, float sm_scale, int dtype,
           cudaStream_t stream) {
  if (dtype == 0) {
    using T = hopper::Tile<D>;
    CUtensorMap mq, mk, mv;
    int err = hopper_host::encode_blhd(&mq, q, B, L, H, D, sq.b, sq.l, sq.h, T::CH, kBM, 0);
    if (err == 0) err = hopper_host::encode_blhd(&mk, k, B, L, H, D, sk.b, sk.l, sk.h, T::CH, kBN, 1);
    if (err == 0) err = hopper_host::encode_blhd(&mv, v, B, L, H, D, sv.b, sv.l, sv.h, T::CH, kBN, 2);
    if (err != 0) return err;
    constexpr uint32_t smem = FwdSmem<D>::BYTES;
    static_assert(smem <= 227 * 1024, "tiles exceed an SM's shared memory");
    static bool smem_raised = false;  // per head dim; setting it twice is harmless
    if (!smem_raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          attn_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return hopper_host::kSmemRefused + static_cast<int>(e);
      smem_raised = true;
    }
    dim3 grid((L + kBM - 1) / kBM, H, B);
    attn_fwd_wgmma<D><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, L, so, sm_scale * CUDART_L2E_F);
    const int e = static_cast<int>(cudaGetLastError());
    return e == 0 ? 0 : hopper_host::kLaunchRefused + e;
  } else {
    dim3 grid((L + kFM - 1) / kFM, H, B);
    attn_fma<D><<<grid, kFThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, L, sq, sk, sv, so, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head dim / dtype this file does not build;
// hopper_host's codes for a refused tensor map or shared-memory size.
// lse: null, or fp32 [B, H, L] contiguous, written with each row's logsumexp.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B,
                                   int L, int H, int D, long long q_sb, long long q_sl,
                                   long long q_sh, long long k_sb, long long k_sl,
                                   long long k_sh, long long v_sb, long long v_sl,
                                   long long v_sh, long long o_sb, long long o_sl,
                                   long long o_sh, float sm_scale, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_sl, q_sh}, sk{k_sb, k_sl, k_sh}, sv{v_sb, v_sl, v_sh},
      so{o_sb, o_sl, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, L, H, sq, sk, sv, so, sm_scale, dtype, st);
    case 64: return launch<64>(q, k, v, o, lse, B, L, H, sq, sk, sv, so, sm_scale, dtype, st);
    case 96: return launch<96>(q, k, v, o, lse, B, L, H, sq, sk, sv, so, sm_scale, dtype, st);
    case 128: return launch<128>(q, k, v, o, lse, B, L, H, sq, sk, sv, so, sm_scale, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one bf16 block at head dim D (0 if not built).
extern "C" int flash_attention_fwd_smem(int D) {
  switch (D) {
    case 32: return static_cast<int>(FwdSmem<32>::BYTES);
    case 64: return static_cast<int>(FwdSmem<64>::BYTES);
    case 96: return static_cast<int>(FwdSmem<96>::BYTES);
    case 128: return static_cast<int>(FwdSmem<128>::BYTES);
    default: return 0;
  }
}
