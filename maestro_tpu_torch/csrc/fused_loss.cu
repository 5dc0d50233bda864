// masked_patchnorm_sums: patch-group-normalised targets + L1/L2 error +
// token-masked reduction, forward and backward, over rows [N, F] (N tokens,
// F = C*p*p features in (C, ph, pw) order, so each norm group is a contiguous
// column slice).
//
// Replaces the JAX package's ops/fused_loss.py _fwd_kernel and _bwd_kernel:
// per row and per norm-group slice (start, size)
//     mean = sum(t) / size,  var = sum((t - mean)^2) / max(size - 1, 1)
//     tn   = (t - mean) * rsqrt(var + 1e-6),  diff = tn - r
// forward: per modality (sum over rows of m * sum(|diff|) or sum(diff^2),
// sum(m) * F); backward: d_rec = g * (-sign(diff) or -2 diff) * m, in r's
// dtype; t and m get no gradient.  Statistics are fp32 whatever the input
// dtype.
//
// What bounds it on an H100: bytes.  The forward reads t and r once (2 or 4
// bytes an element each) and does about ten fp32 operations an element, so at
// 3.35 TB/s the card has room for some 30 instructions a lane per element
// before the instructions, not the memory, set the pace.  The design of the
// forward (patchnorm_fwd_multi) follows from that:
//   * One launch a train step.  A table of up to 8 modalities (pointers, N,
//     F, dtype, up to 16 slices each) is a kernel parameter, and the grid's
//     blocks are shared out among the modalities by prefix sums in it, about
//     as many blocks as fit on the card at once (two an SM: the registers are
//     capped at 128 a thread).  A modality whose warp turn moves under 4 KB
//     (s1, s2) waits on latency, not bandwidth: it gets blocks for about 8
//     turns a warp, the others share the rest by their bytes.
//   * The finish is in the same launch.  Each block writes its partial sums;
//     the last block to finish (an atomic ticket after a __threadfence, reset
//     by that block) adds every modality's partials in block order.  The
//     result does not depend on scheduling: two calls give the same bits.
//   * Each row is read once, as 16-byte vectors, into registers, with as few
//     lanes a row as hold it in at most 4 vectors a lane: aerial (F = 1024
//     bf16) a warp a row, dem (F = 2048) two warps a row, adding their sums
//     through shared memory at a named barrier; small rows pack several to a
//     warp (s2, F = 40: two lanes a row; s1, F = 8: one lane a row) and
//     reduce over their segment with shuffles.  Mean and variance are two
//     passes over the registers (a centred second pass, as the plain version
//     takes it), the error a third; the slice of each vector (each element,
//     where a slice boundary falls inside a vector) is worked out once a
//     block from its column.  Staging the rows through shared memory by
//     cp.async, a row ahead, measured slower on an H100 than these loads,
//     and 8 vectors a lane spilled under the register cap.
//   * Rows that do not fit (F not a multiple of the vector, more than 256
//     vectors, or a boundary inside a vector when a lane holds several) take
//     a warp a row, element by element, in the same launch.
// The backward (patchnorm_bwd) is one launch a modality: a warp a row, three
// passes over the row (the second and third hit L1).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSlices = 16;
constexpr int kMaxMods = 8;
constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlocks = 2048;  // the backward's grid
constexpr int kMaxGridBlocks = 4096;  // the grouped forward's grid (partials it has room for)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1.0e-6f;
constexpr int kMinBlocksPerSm = 2;  // caps registers at 128 a thread (no spills at K = 4)
// a modality whose warp turn moves fewer bytes than this waits on latency, not
// bandwidth: it gets blocks enough for about kSmallTurns turns a warp
constexpr int kLatencyBytes = 4096;
constexpr int kSmallTurns = 8;

// forward routes of a modality: 0 a warp a row, element by element; 1 one
// 16-byte vector a lane with each element's slice found apart; 2, 3 K = 2, 4
// vectors a lane, each inside one slice; 4 as 3 with two warps a row
constexpr int kRouteRows = 0;

struct Slices {
  int n;
  int start[kMaxSlices];
  int size[kMaxSlices];
};

struct ModDesc {
  const void* t;
  const void* r;
  const float* m;
  long long n;  // rows
  int f;
  int dtype;  // 0 bf16, 1 fp32
  int route;
  int lpr;  // lanes a row (vector routes; 64: two warps)
  int rpw;  // rows a warp (vector routes)
  Slices slices;
};

struct Table {
  int n_mod;
  int square;
  int block_begin[kMaxMods + 1];
  ModDesc mod[kMaxMods];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// element e of a 16-byte vector, as fp32 (e is a compile-time constant where
// it is called, so this resolves to one register operation)
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static float at(const uint4& v, int e) {
    return __uint_as_float(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static float at(const uint4& v, int e) {
    const int i = e >> 1;
    const unsigned w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// sum over the segment of `lpr` lanes starting at lane `base` (q = lane -
// base), in a fixed order; every lane of the segment gets it.  Every lane of
// the warp calls it (lpr is the same across the warp).
__device__ __forceinline__ float seg_sum(float v, int q, int lpr, int base) {
  if (lpr == 32) return warp_sum(v);
  for (int off = 1; off < lpr; off <<= 1) {
    const float o = __shfl_down_sync(kFull, v, off);
    if (q + off < lpr) v += o;
  }
  return __shfl_sync(kFull, v, base);
}

// mean and 1/sqrt(var + eps) of t[start, start + size) of one row (every lane gets them)
template <typename T>
__device__ __forceinline__ void group_stats(const T* __restrict__ row, int start, int size,
                                            int lane, float& mean, float& inv_std) {
  float s = 0.f;
  for (int c = lane; c < size; c += 32) s += to_f(row[start + c]);
  mean = warp_sum(s) / static_cast<float>(size);
  float ss = 0.f;
  for (int c = lane; c < size; c += 32) {
    const float d = to_f(row[start + c]) - mean;
    ss = fmaf(d, d, ss);
  }
  const float var = warp_sum(ss) / static_cast<float>(size > 1 ? size - 1 : 1);
  inv_std = rsqrtf(var + kEps);
}

__device__ __forceinline__ int slice_of(int col, const int* s_start, int ns) {
  int i = 0;
  while (i + 1 < ns && col >= s_start[i + 1]) ++i;
  return i;
}

// Route 0: a warp a row, element by element (any F); per lane, adds m * its
// part of the row's error to err and (lane 0) m to msum.
template <typename T>
__device__ void rows_by_warp(const ModDesc& md, const int* s_start, const int* s_size, int ns,
                             int local, int nb, int square, float& err, float& msum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* t = static_cast<const T*>(md.t);
  const T* r = static_cast<const T*>(md.r);
  for (long long row = (long long)local * kWarps + warp; row < md.n;
       row += (long long)nb * kWarps) {
    const T* tr = t + row * md.f;
    const T* rr = r + row * md.f;
    float e = 0.f;
    for (int i = 0; i < ns; ++i) {
      const int start = s_start[i], size = s_size[i];
      float mean, inv_std;
      group_stats(tr, start, size, lane, mean, inv_std);
      for (int c = lane; c < size; c += 32) {
        const float diff = (to_f(tr[start + c]) - mean) * inv_std - to_f(rr[start + c]);
        e += square ? diff * diff : fabsf(diff);
      }
    }
    const float mr = __ldg(md.m + row);
    err += e * mr;
    if (lane == 0) msum += mr;
  }
}

// the two warps of pair `pair` (warps 2 pair, 2 pair + 1) wait for each other
__device__ __forceinline__ void pair_barrier(int pair) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + pair), "r"(64) : "memory");
}

// Routes 1-4: `rpw` rows a warp, `lpr` lanes a row, K 16-byte vectors a lane
// (vector j of lane q is the row's vector q + lpr * j); with kPair a row takes
// the 64 lanes of two warps, which add their sums through shared memory.
// Elements are taken in groups that lie in one slice: a vector each (kPerElem
// false), or, where a slice boundary may fall inside the lane's one vector, an
// element each.
template <typename T, int K, bool kPerElem, bool kPair>
__device__ void rows_by_vector(const ModDesc& md, const int* s_start, const int* s_size, int ns,
                               int local, int nb, int square, float& err, float& msum) {
  static_assert(!kPerElem || K == 1, "per-element slices take one vector a lane");
  constexpr int kVec = Pack<T>::kN;
  constexpr int kG = kPerElem ? kVec : K;  // groups a lane
  constexpr int kW = kPerElem ? 1 : kVec;  // elements a group
  constexpr int kUnits = kPair ? kWarps / 2 : kWarps;  // row units a block: pairs or warps
  __shared__ float xch[2][kWarps];  // the pairs' warp sums, two rounds in turn
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lpr = kPair ? 64 : md.lpr, rpw = kPair ? 1 : md.rpw;
  const int seg = kPair ? 0 : lane / lpr;
  const int q = kPair ? (warp & 1) * 32 + lane : lane - seg * lpr, base = seg * lpr;
  const int unit = kPair ? warp >> 1 : warp;
  int round = 0;
  // the sum over the row's lanes, in a fixed order (every lane of the row gets it)
  auto row_sum = [&](float v) -> float {
    if constexpr (kPair) {
      v = warp_sum(v);
      if (lane == 0) xch[round][warp] = v;
      pair_barrier(unit);
      v = xch[round][warp & ~1] + xch[round][warp | 1];
      round ^= 1;  // the partner reads this round's slot before it passes the next barrier
      return v;
    } else {
      return seg_sum(v, q, lpr, base);
    }
  };
  const int nvec = md.f / kVec;
  const long long n = md.n;
  const uint4* t = static_cast<const uint4*>(md.t);
  const uint4* r = static_cast<const uint4*>(md.r);

  // the slice of each group this lane holds, -1 where it holds none
  int gs[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int v = q + lpr * (kPerElem ? 0 : g);
    const int col = v * kVec + (kPerElem ? g : 0);
    gs[g] = (seg < rpw && v < nvec) ? slice_of(col, s_start, ns) : -1;
  }

  for (long long u = (long long)local * kUnits + unit; u * rpw < n; u += (long long)nb * kUnits) {
    const long long row = u * rpw + seg;
    const bool on = seg < rpw && row < n;
    uint4 tv[K], rv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int v = q + lpr * j;
      const bool ok = on && v < nvec;
      tv[j] = ok ? __ldcs(t + row * nvec + v) : make_uint4(0u, 0u, 0u, 0u);
      rv[j] = ok ? __ldcs(r + row * nvec + v) : make_uint4(0u, 0u, 0u, 0u);
    }
    const float mr = on ? __ldg(md.m + row) : 0.f;

    // pass 1: the mean of each slice
    float gsum[kG], gmean[kG], ginv[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        s += Pack<T>::at(tv[kPerElem ? 0 : g], kPerElem ? g : w);
      }
      gsum[g] = s;
      gmean[g] = 0.f;
      ginv[g] = 0.f;
    }
    for (int i = 0; i < ns; ++i) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) s += gs[g] == i ? gsum[g] : 0.f;
      const float mean = row_sum(s) / static_cast<float>(s_size[i]);
#pragma unroll
      for (int g = 0; g < kG; ++g) gmean[g] = gs[g] == i ? mean : gmean[g];
    }
    // pass 2: the centred sum of squares of each slice
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float ss = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float d = Pack<T>::at(tv[kPerElem ? 0 : g], kPerElem ? g : w) - gmean[g];
        ss = fmaf(d, d, ss);
      }
      gsum[g] = ss;
    }
    for (int i = 0; i < ns; ++i) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) s += gs[g] == i ? gsum[g] : 0.f;
      const int size = s_size[i];
      const float var = row_sum(s) / static_cast<float>(size > 1 ? size - 1 : 1);
      const float inv_std = rsqrtf(var + kEps);
#pragma unroll
      for (int g = 0; g < kG; ++g) ginv[g] = gs[g] == i ? inv_std : ginv[g];
    }
    // pass 3: the error (0 for the groups a lane does not hold: t, r, mean
    // and 1/std are all 0 there)
    float e = 0.f;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const int j = kPerElem ? 0 : g, el = kPerElem ? g : w;
        const float diff = (Pack<T>::at(tv[j], el) - gmean[g]) * ginv[g] - Pack<T>::at(rv[j], el);
        e += square ? diff * diff : fabsf(diff);
      }
    }
    err += e * mr;
    if (q == 0) msum += mr;
  }
}

template <typename T>
__device__ __forceinline__ void rows_of(const ModDesc& md, const int* s_start, const int* s_size,
                                        int ns, int local, int nb, int square, float& err,
                                        float& msum) {
  switch (md.route) {
    case 1: rows_by_vector<T, 1, true, false>(md, s_start, s_size, ns, local, nb, square, err, msum); break;
    case 2: rows_by_vector<T, 2, false, false>(md, s_start, s_size, ns, local, nb, square, err, msum); break;
    case 3: rows_by_vector<T, 4, false, false>(md, s_start, s_size, ns, local, nb, square, err, msum); break;
    case 4: rows_by_vector<T, 4, false, true>(md, s_start, s_size, ns, local, nb, square, err, msum); break;
    default: rows_by_warp<T>(md, s_start, s_size, ns, local, nb, square, err, msum); break;
  }
}

// (a, b) summed over the block in a fixed order; thread 0 gets the totals
__device__ __forceinline__ void block_sum2(float& a, float& b, float (*red)[kWarps]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.f;
    b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
patchnorm_fwd_multi(const __grid_constant__ Table tab, float* __restrict__ partials,
                    unsigned int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ int s_start[kMaxSlices], s_size[kMaxSlices];
  __shared__ float red[2][kWarps];
  __shared__ bool s_last;
  int k = 0;
  const int b = blockIdx.x;
  while (k + 1 < tab.n_mod && b >= tab.block_begin[k + 1]) ++k;
  const ModDesc& md = tab.mod[k];
  const int ns = md.slices.n;
  if (static_cast<int>(threadIdx.x) < ns) {
    s_start[threadIdx.x] = md.slices.start[threadIdx.x];
    s_size[threadIdx.x] = md.slices.size[threadIdx.x];
  }
  __syncthreads();
  const int local = b - tab.block_begin[k];
  const int nb = tab.block_begin[k + 1] - tab.block_begin[k];
  float err = 0.f, msum = 0.f;
  if (md.dtype == 0) {
    rows_of<__nv_bfloat16>(md, s_start, s_size, ns, local, nb, tab.square, err, msum);
  } else {
    rows_of<float>(md, s_start, s_size, ns, local, nb, tab.square, err, msum);
  }
  block_sum2(err, msum, red);
  if (threadIdx.x == 0) {
    partials[2 * b] = err;
    partials[2 * b + 1] = msum;
    __threadfence();  // the partials are visible before the ticket is taken
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: each modality's partials, in block order
  __threadfence();
  for (int kk = 0; kk < tab.n_mod; ++kk) {
    float a = 0.f, b = 0.f;
    for (int blk = tab.block_begin[kk] + threadIdx.x; blk < tab.block_begin[kk + 1];
         blk += kThreads) {
      a += __ldcg(partials + 2 * blk);
      b += __ldcg(partials + 2 * blk + 1);
    }
    block_sum2(a, b, red);
    if (threadIdx.x == 0) {
      out[2 * kk] = a;
      out[2 * kk + 1] = b * static_cast<float>(tab.mod[kk].f);
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next call on this stream
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
patchnorm_bwd(const T* __restrict__ t, const T* __restrict__ r, const float* __restrict__ m,
              const float* __restrict__ g, int N, int F, Slices slices, int square,
              T* __restrict__ dr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float gs = *g;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < N;
       row += (long long)gridDim.x * kWarps) {
    const T* tr = t + row * F;
    const T* rr = r + row * F;
    T* out = dr + row * F;
    const float mr = m[row];
    for (int i = 0; i < slices.n; ++i) {
      const int start = slices.start[i], size = slices.size[i];
      float mean, inv_std;
      group_stats(tr, start, size, lane, mean, inv_std);
      for (int c = lane; c < size; c += 32) {
        const float diff = (to_f(tr[start + c]) - mean) * inv_std - to_f(rr[start + c]);
        const float d = square ? -2.f * diff : -static_cast<float>((diff > 0.f) - (diff < 0.f));
        out[start + c] = from_f<T>(gs * d * mr);
      }
    }
  }
}

int blocks_for(int N) {
  const int b = (N + kWarps - 1) / kWarps;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

bool make_slices(const int* starts, const int* sizes, int n, int F, Slices& s) {
  if (n < 1 || n > kMaxSlices) return false;
  s.n = n;
  for (int i = 0; i < n; ++i) {
    if (sizes[i] < 1 || starts[i] < 0 || starts[i] + sizes[i] > F) return false;
    s.start[i] = starts[i];
    s.size[i] = sizes[i];
  }
  return true;
}

// The forward route of a modality, its lanes a row and rows a warp: as few
// lanes a row as hold it in at most 4 vectors a lane (more rows a warp, fewer
// turns), two warps a row up to 256 vectors, else a warp a row by elements.
void plan_route(ModDesc& md) {
  const int vec = md.dtype == 0 ? 8 : 4;  // elements a 16-byte vector
  md.route = kRouteRows;
  md.lpr = 32;
  md.rpw = 1;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(md.t) | reinterpret_cast<uintptr_t>(md.r);
  if (md.f % vec != 0 || addr % 16 != 0) return;
  const int nvec = md.f / vec;
  bool inside = false;  // a slice boundary inside a vector
  for (int i = 1; i < md.slices.n; ++i) inside = inside || md.slices.start[i] % vec != 0;
  if (inside) {  // a vector a lane, each element's slice apart
    if (nvec > 32) return;
    md.route = 1;
    md.lpr = nvec;
  } else {
    const int lpr = (nvec + 3) / 4;
    if (lpr > 64) return;
    const int per_lane = (nvec + lpr - 1) / lpr;
    md.route = lpr > 32 ? 4 : per_lane == 1 ? 1 : per_lane == 2 ? 2 : 3;
    md.lpr = lpr > 32 ? 64 : lpr;
  }
  md.rpw = md.lpr > 32 ? 1 : 32 / md.lpr;
}

// blocks of the grouped forward that fit on the card at once (cached per
// device); 0 on an error
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, patchnorm_fwd_multi, kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// Floats of partials the grouped forward needs: the caller keeps them and a
// ticket (one unsigned int, zeroed once) for the device and passes both to
// every call on one stream.
extern "C" int masked_patchnorm_sums_multi_scratch() { return 2 * kMaxGridBlocks; }

// Grouped forward: one launch on `stream` for n_mod modalities (at most 8).
// Per modality k: t[k], r[k] [n[k], f[k]] contiguous, bf16 (dtype[k] 0) or
// fp32 (1); m[k] fp32 [n[k]]; slice k's starts and sizes at
// slice_start/slice_size[slice_off[k] .. slice_off[k] + n_slices[k]), tiling
// [0, f[k]) in order.  out = fp32 [n_mod, 2]: (sum_err, count) a row.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments this file does not take.
extern "C" int masked_patchnorm_sums_fwd_multi(int n_mod, const void* const* t,
                                               const void* const* r, const float* const* m,
                                               const long long* n, const int* f, const int* dtype,
                                               const int* n_slices, const int* slice_off,
                                               const int* slice_start, const int* slice_size,
                                               int square, float* partials, unsigned int* ticket,
                                               float* out, void* stream) {
  if (n_mod < 1 || n_mod > kMaxMods) return static_cast<int>(cudaErrorInvalidValue);
  Table tab;
  tab.n_mod = n_mod;
  tab.square = square;
  long long turns[kMaxMods];  // warp turns: a warp's pass over its rows
  double bytes[kMaxMods];
  bool small[kMaxMods];
  for (int k = 0; k < n_mod; ++k) {
    ModDesc& md = tab.mod[k];
    md.t = t[k];
    md.r = r[k];
    md.m = m[k];
    md.n = n[k];
    md.f = f[k];
    md.dtype = dtype[k];
    if (md.n < 1 || md.f < 1 || (md.dtype != 0 && md.dtype != 1) ||
        !make_slices(slice_start + slice_off[k], slice_size + slice_off[k], n_slices[k], md.f,
                     md.slices)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int end = 0;  // the slices tile [0, f) in order
    for (int i = 0; i < md.slices.n; ++i) {
      if (md.slices.start[i] != end) return static_cast<int>(cudaErrorInvalidValue);
      end += md.slices.size[i];
    }
    if (end != md.f) return static_cast<int>(cudaErrorInvalidValue);
    plan_route(md);
    const int wpr = md.lpr > 32 ? 2 : 1;  // warps a row
    turns[k] = (md.n + md.rpw - 1) / md.rpw * wpr;
    bytes[k] = 2.0 * md.n * md.f * (md.dtype == 0 ? 2 : 4);
    small[k] = bytes[k] / turns[k] < kLatencyBytes;
  }
  const int resident = resident_blocks();
  if (resident < 1) {
    const int err = static_cast<int>(cudaGetLastError());
    return err != 0 ? err : static_cast<int>(cudaErrorInvalidDevice);
  }
  // blocks: a small modality enough for kSmallTurns turns a warp (or its
  // share by bytes, if larger), the rest of the card's resident blocks to the
  // others by their bytes
  const int target = resident < kMaxGridBlocks - kMaxMods ? resident : kMaxGridBlocks - kMaxMods;
  double all_bytes = 0.0;
  for (int k = 0; k < n_mod; ++k) all_bytes += bytes[k];
  long long blocks_of[kMaxMods];
  long long left = target;
  double big_bytes = 0.0;
  for (int k = 0; k < n_mod; ++k) {
    const long long most = (turns[k] + kWarps - 1) / kWarps;  // one turn a warp
    if (small[k]) {
      long long b = (turns[k] + kSmallTurns * kWarps - 1) / (kSmallTurns * kWarps);
      const long long by_bytes = static_cast<long long>(target * bytes[k] / all_bytes + 0.5);
      b = b > by_bytes ? b : by_bytes;
      blocks_of[k] = b < most ? b : most;
      left -= blocks_of[k];
    } else {
      big_bytes += bytes[k];
    }
  }
  if (left < n_mod) left = n_mod;
  tab.block_begin[0] = 0;
  for (int k = 0; k < n_mod; ++k) {
    const long long most = (turns[k] + kWarps - 1) / kWarps;
    if (!small[k]) {
      const long long b = static_cast<long long>(left * bytes[k] / big_bytes + 0.5);
      blocks_of[k] = b < 1 ? 1 : b < most ? b : most;
    }
    tab.block_begin[k + 1] = tab.block_begin[k] + static_cast<int>(blocks_of[k]);
  }
  const int blocks = tab.block_begin[n_mod];
  if (blocks > kMaxGridBlocks) return static_cast<int>(cudaErrorInvalidValue);
  patchnorm_fwd_multi<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, partials, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

// Backward: one launch; g = fp32 device scalar (the cotangent of sum_err);
// dr = [N, F] in the dtype of t and r.
extern "C" int masked_patchnorm_sums_bwd(const void* t, const void* r, const float* m,
                                         const float* g, int N, int F, const int* starts,
                                         const int* sizes, int n_slices, int square, int dtype,
                                         void* dr, void* stream) {
  Slices s;
  if (N < 1 || F < 1 || (dtype != 0 && dtype != 1) || !make_slices(starts, sizes, n_slices, F, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(N);
  if (dtype == 0) {
    patchnorm_bwd<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(t), static_cast<const __nv_bfloat16*>(r), m, g, N, F, s,
        square, static_cast<__nv_bfloat16*>(dr));
  } else {
    patchnorm_bwd<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(t), static_cast<const float*>(r), m, g, N, F, s, square,
        static_cast<float*>(dr));
  }
  return static_cast<int>(cudaGetLastError());
}
