// masked_patchnorm_sums: patch-group-normalised targets + L1/L2 error +
// token-masked reduction, forward and backward, over rows [N, F] (N tokens,
// F = C*p*p features in (C, ph, pw) order, so each norm group is a contiguous
// column slice).
//
// Replaces the JAX package's ops/fused_loss.py _fwd_kernel and _bwd_kernel:
// per row and per norm-group slice (start, size)
//     mean = sum(t) / size,  var = sum((t - mean)^2) / max(size - 1, 1)
//     tn   = (t - mean) * rsqrt(var + 1e-6),  diff = tn - r
// forward: (sum over rows of m * sum(|diff|) or sum(diff^2),  sum(m) * F);
// backward: d_rec = g * (-sign(diff) or -2 diff) * m, in r's dtype; t and m
// get no gradient.  Statistics are fp32 whatever the input dtype.
//
// What bounds it on an H100: bytes (a few operations per element read).  One
// warp owns a row: it reads t once from device memory (the second and third
// passes over the row, for the variance and the error, hit L1) and r once,
// and keeps every statistic in registers.  Any F and any slice layout are
// served by one kernel: the slices arrive as a small array argument (the TPU
// kernel needed F >= 128 for its lanes).  The forward reduces per block into a
// [blocks, 2] fp32 scratch and a second one-block launch sums it in a fixed
// order, so the result does not depend on block scheduling (no atomics).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlices = 16;
constexpr int kWarps = 8;  // rows in flight per block
constexpr int kMaxBlocks = 2048;
constexpr float kEps = 1.0e-6f;

struct Slices {
  int n;
  int start[kMaxSlices];
  int size[kMaxSlices];
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
patchnorm_fwd(const T* __restrict__ t, const T* __restrict__ r, const float* __restrict__ m,
              int N, int F, Slices slices, int square, float* __restrict__ partials) {
  __shared__ float red[2][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float err_acc = 0.f, m_acc = 0.f;  // lane 0's are the warp's
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < N;
       row += (long long)gridDim.x * kWarps) {
    const T* tr = t + row * F;
    const T* rr = r + row * F;
    float e = 0.f;
    for (int i = 0; i < slices.n; ++i) {
      const int start = slices.start[i], size = slices.size[i];
      float mean, inv_std;
      group_stats(tr, start, size, lane, mean, inv_std);
      for (int c = lane; c < size; c += 32) {
        const float diff = (to_f(tr[start + c]) - mean) * inv_std - to_f(rr[start + c]);
        e += square ? diff * diff : fabsf(diff);
      }
    }
    const float mr = m[row];
    err_acc += warp_sum(e) * mr;
    m_acc += mr;
  }
  if (lane == 0) {
    red[0][warp] = err_acc;
    red[1][warp] = m_acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float se = 0.f, sm = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      se += red[0][w];
      sm += red[1][w];
    }
    partials[2 * blockIdx.x] = se;
    partials[2 * blockIdx.x + 1] = sm;
  }
}

// one block: out = (sum of partial errors, sum of partial masks * F), fixed order
__global__ void __launch_bounds__(256)
patchnorm_finish(const float* __restrict__ partials, int blocks, int F, float* __restrict__ out) {
  __shared__ float red[2][256];
  float se = 0.f, sm = 0.f;
  for (int b = threadIdx.x; b < blocks; b += 256) {
    se += partials[2 * b];
    sm += partials[2 * b + 1];
  }
  red[0][threadIdx.x] = se;
  red[1][threadIdx.x] = sm;
  __syncthreads();
  for (int half = 128; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      red[0][threadIdx.x] += red[0][threadIdx.x + half];
      red[1][threadIdx.x] += red[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = red[0][0];
    out[1] = red[1][0] * static_cast<float>(F);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
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

}  // namespace

// Scratch size the forward needs, in floats.
extern "C" int masked_patchnorm_sums_scratch(int N) { return 2 * blocks_for(N); }

// Forward: two launches on `stream`; out = fp32[2] (sum_err, count).  t, r:
// [N, F] contiguous, bf16 (dtype 0) or fp32 (dtype 1); m: fp32 [N]; slice
// starts/sizes: host arrays of n_slices ints.  Returns cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for arguments this file does not take.
extern "C" int masked_patchnorm_sums_fwd(const void* t, const void* r, const float* m, int N,
                                         int F, const int* starts, const int* sizes,
                                         int n_slices, int square, int dtype, float* scratch,
                                         float* out, void* stream) {
  Slices s;
  if (N < 1 || F < 1 || (dtype != 0 && dtype != 1) || !make_slices(starts, sizes, n_slices, F, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(N);
  if (dtype == 0) {
    patchnorm_fwd<__nv_bfloat16><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(t), static_cast<const __nv_bfloat16*>(r), m, N, F, s,
        square, scratch);
  } else {
    patchnorm_fwd<float><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const float*>(t), static_cast<const float*>(r), m, N, F, s, square, scratch);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  patchnorm_finish<<<1, 256, 0, st>>>(scratch, blocks, F, out);
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
    patchnorm_bwd<__nv_bfloat16><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(t), static_cast<const __nv_bfloat16*>(r), m, g, N, F, s,
        square, static_cast<__nv_bfloat16*>(dr));
  } else {
    patchnorm_bwd<float><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const float*>(t), static_cast<const float*>(r), m, g, N, F, s, square,
        static_cast<float*>(dr));
  }
  return static_cast<int>(cudaGetLastError());
}
