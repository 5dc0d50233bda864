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
// Two kernels, one tiling idea (one block per (batch, head, q-tile), a loop
// over key tiles with an online softmax, ragged tiles masked in the kernel):
//   * attn_mma_bf16: bf16 inputs, both products on the tensor cores through
//     mma.sync.m16n8k16 with fp32 accumulators; scores, running max/sum, the
//     P tile and the output tile stay in registers.  64 query rows per block
//     (4 warps x 16 rows), 64 keys per tile; K/V tiles arrive by cp.async into
//     a two-stage shared-memory buffer (the next tile loads while this one is
//     multiplied) and reach the tensor cores through ldmatrix.
//   * attn_fma: fp32 inputs, products as shared-memory FMA loops in full
//     fp32.  16 query rows per block, 32 keys per tile.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include "mma_helpers.cuh"

namespace {

constexpr float kMasked = -1e30f;  // finite: a tile always holds a valid key

struct Strides {
  long long b, l, h;  // element strides of batch, row, head; D is contiguous
};

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int kBM = 64;       // query rows per block
constexpr int kBN = 64;       // keys per tile
constexpr int kWarps = 4;     // 16 query rows per warp
constexpr int kPad = 8;       // bf16 elements of row padding: rows 16 bytes apart mod 128
constexpr int kStages = 2;    // K/V tiles in flight (cp.async double buffer)

using namespace mma;

template <int D>
constexpr size_t attn_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * kStages * 2 * kBN * (D + kPad);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_mma_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int L, Strides sq, Strides sk, Strides sv, Strides so,
              float sm_scale) {
  constexpr int LD = D + kPad;          // shared row stride in elements
  constexpr int TILE = kBN * LD;        // elements of one K (or V) tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][kBN][LD]
  __nv_bfloat16* Vs = Ks + kStages * TILE;                          // [kStages][kBN][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row0 = blockIdx.x * kBM + warp * 16;  // first query row of this warp

  const __nv_bfloat16* qb = q + batch * sq.b + head * sq.h;
  const __nv_bfloat16* kb = k + batch * sk.b + head * sk.h;
  const __nv_bfloat16* vb = v + batch * sv.b + head * sv.h;

  // K and V tile -> stage: 16-byte cp.async per vector, rows beyond L zero-filled
  auto load_tile = [&](int tile, int stage) {
    constexpr int VEC_PER_ROW = D / 8;
    const int key0 = tile * kBN;
    __nv_bfloat16* ks = Ks + stage * TILE;
    __nv_bfloat16* vs = Vs + stage * TILE;
    for (int idx = tid; idx < kBN * VEC_PER_ROW; idx += kWarps * 32) {
      const int r = idx / VEC_PER_ROW;
      const int c = (idx % VEC_PER_ROW) * 8;
      if (key0 + r < L) {
        cp_async_16(&ks[r * LD + c], kb + (long long)(key0 + r) * sk.l + c);
        cp_async_16(&vs[r * LD + c], vb + (long long)(key0 + r) * sv.l + c);
      } else {
        *reinterpret_cast<uint4*>(&ks[r * LD + c]) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(&vs[r * LD + c]) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  const int n_tiles = (L + kBN - 1) / kBN;
  load_tile(0, 0);

  // Q fragments (A operand) straight from device memory, once per block:
  // a[0]=(row g, k 2t..), a[1]=(row g+8, k 2t..), a[2]/a[3] the same at k+8.
  uint32_t qf[D / 16][4];
  {
    const int r_lo = row0 + g, r_hi = row0 + g + 8;
    const uint32_t* p_lo = reinterpret_cast<const uint32_t*>(qb + (long long)r_lo * sq.l);
    const uint32_t* p_hi = reinterpret_cast<const uint32_t*>(qb + (long long)r_hi * sq.l);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks * 8 + t;  // 32-bit word index: element ks*16 + 2t
      qf[ks][0] = r_lo < L ? p_lo[c] : 0u;
      qf[ks][1] = r_hi < L ? p_hi[c] : 0u;
      qf[ks][2] = r_lo < L ? p_lo[c + 4] : 0u;
      qf[ks][3] = r_hi < L ? p_hi[c + 4] : 0u;
    }
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  }
  float m_lo = kMasked, m_hi = kMasked;  // running max of rows g and g+8
  float l_lo = 0.f, l_hi = 0.f;          // this thread's share of the running sum

  // ldmatrix lane roles: matrix i = lane / 8, row within it = lane % 8
  const int lm_mat = lane >> 3, lm_row = lane & 7;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kBN;
    const int stage = tile & 1;
    // the other stage was last read in iteration tile-1, which ended in a barrier
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_wait<1>();  // all but the newest group: this tile has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks_tile = Ks + stage * TILE;
    const __nv_bfloat16* vs_tile = Vs + stage * TILE;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        // matrices: (keys np*16+0..7, k lo), (same keys, k hi),
        //           (keys np*16+8..15, k lo), (same keys, k hi)
        uint32_t b[4];
        ldmatrix_x4(b, &ks_tile[(np * 16 + (lm_mat >> 1) * 8 + lm_row) * LD + ks * 16 +
                                (lm_mat & 1) * 8]);
        mma_bf16_16816(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16_16816(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // scale, mask ragged keys, tile row max
    float mx_lo = kMasked, mx_hi = kMasked;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      const int col = key0 + nt * 8 + 2 * t;
      s[nt][0] = col < L ? s[nt][0] * sm_scale : kMasked;
      s[nt][1] = col + 1 < L ? s[nt][1] * sm_scale : kMasked;
      s[nt][2] = col < L ? s[nt][2] * sm_scale : kMasked;
      s[nt][3] = col + 1 < L ? s[nt][3] * sm_scale : kMasked;
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));

    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float alpha_lo = __expf(m_lo - mn_lo), alpha_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      oacc[i][0] *= alpha_lo;
      oacc[i][1] *= alpha_lo;
      oacc[i][2] *= alpha_hi;
      oacc[i][3] *= alpha_hi;
    }

    // P = exp(S - m) in fp32, summed in fp32, rounded to bf16 as the A operand
    uint32_t pf[kBN / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      const float p0 = __expf(s[nt][0] - mn_lo), p1 = __expf(s[nt][1] - mn_lo);
      const float p2 = __expf(s[nt][2] - mn_hi), p3 = __expf(s[nt][3] - mn_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      // the C layout of key tiles 2j and 2j+1 is the A layout of k-step j
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // V is [key][d]: transposed matrices (keys kk*16+0..7, d dp*16+0..7),
        // (keys +8, same d), (keys +0, d +8), (keys +8, d +8)
        uint32_t b[4];
        ldmatrix_x4_trans(b, &vs_tile[(kk * 16 + (lm_mat & 1) * 8 + lm_row) * LD + dp * 16 +
                                      (lm_mat >> 1) * 8]);
        mma_bf16_16816(oacc[2 * dp], pf[kk], b[0], b[1]);
        mma_bf16_16816(oacc[2 * dp + 1], pf[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the load issued next iteration
  }

  // finish the row sums across the four threads that share a row
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;

  __nv_bfloat16* ob = o + batch * so.b + head * so.h;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r_lo < L) {
      *reinterpret_cast<uint32_t*>(ob + (long long)r_lo * so.l + c) =
          pack_bf16(oacc[dt][0] * inv_lo, oacc[dt][1] * inv_lo);
    }
    if (r_hi < L) {
      *reinterpret_cast<uint32_t*>(ob + (long long)r_hi * so.l + c) =
          pack_bf16(oacc[dt][2] * inv_hi, oacc[dt][3] * inv_hi);
    }
  }
  if (lse != nullptr && t == 0) {  // logsumexp of the scaled scores, [B, H, L]
    float* lb = lse + ((long long)batch * gridDim.y + head) * L;
    if (r_lo < L) lb[r_lo] = m_lo + __logf(l_lo);
    if (r_hi < L) lb[r_hi] = m_hi + __logf(l_hi);
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
    constexpr size_t smem = attn_mma_smem_bytes<D>();
    static_assert(smem <= 227 * 1024, "K/V stages exceed an SM's shared memory");
    static bool smem_raised = false;  // per head dim; setting it twice is harmless
    if (!smem_raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          attn_mma_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_raised = true;
    }
    dim3 grid((L + kBM - 1) / kBM, H, B);
    attn_mma_bf16<D><<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, L, sq, sk, sv,
        so, sm_scale);
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
// cudaErrorInvalidValue for a head dim / dtype this file does not build.
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
