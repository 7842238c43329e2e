// Distillation-loss kernels for Hopper (sm_90a): the vocabulary reduction
// of TVD++, TVD and forward KL over fp32 student and teacher logits.
//
// Replaces the three TPU kernels of src/repro/kernels/distill_loss.py:
//   row_logsumexp -> pallas_call(_lse_kernel)    per-row logsumexp
//   loss_terms    -> pallas_call(_terms_kernel)  per-row loss, c = sum p*w,
//                                                sum p*r, sum p*r^2
//   loss_grad     -> pallas_call(_grad_kernel)   dL/ds = g*p*(w - c), or
//                                                g*(p - q) for kld
// with p = exp(s - lse_s), q = exp(t - lse_t), r = 1{q > p} and the weight
//   tvdpp: w = -(r - mu) * inv_sigma      tvd: w = 0.5 * sign(p - q).
// The TPU kernels walked the vocabulary as the sequential minor axis of a
// (row tiles, vocab tiles) grid and carried their running sums across grid
// steps in VMEM scratch. Blocks on this card run in parallel with nothing
// carried between them, so here one block of 256 threads owns one row and
// walks the whole vocabulary itself: each thread takes every 256th group of
// four values and keeps its running (m, l) or its four sums in registers;
// the block merges them with warp shuffles, then through shared memory, in
// a fixed order (no atomics: the result does not change from run to run).
//
// What bounds them on this card: bytes. Each element costs a few flops and
// one or two exps, against 4 or 8 bytes read (12 for loss_grad, which also
// writes its output), far below the card's 20 flops per byte. At the
// full-width chunk (N = 2048 rows, V = 32000) row_logsumexp reads 262 MB,
// loss_terms 524 MB and loss_grad moves 786 MB: 0.078, 0.157 and 0.235 ms
// at 3.35 TB/s. The design reads every value once, in 16-byte loads with
// neighbouring threads on neighbouring addresses, writes loss_grad's output
// in 16-byte stores, and keeps every intermediate (p, q, r, w) in registers.
// A row whose addresses are not 16-byte aligned at the same element (V not
// a multiple of 4, or a row stride that is not) runs a scalar head and tail
// around the 16-byte body, or all scalar where the inputs disagree.
// mu and inv_sigma are read from 1-element device tensors, so no host sync
// is needed to hand over values the card computed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;   // as the plain version's NEG_INF
constexpr int KLD = 0, TVD = 1, TVDPP = 2;

// A row of V floats read (and written) at up to three addresses: elements
// [0, head) and [head + 4 * nvec, V) one by one, the nvec groups of four
// between them as float4. The float4 body needs all three addresses on a
// 16-byte boundary at the same element; where they differ, all is scalar.
struct RowSplit {
  int head, nvec;
};

__device__ __forceinline__ RowSplit split_row(const float* a, const float* b,
                                              const float* c, int V) {
  const unsigned ma = (unsigned)(reinterpret_cast<uintptr_t>(a) & 15);
  const unsigned mb = (unsigned)(reinterpret_cast<uintptr_t>(b) & 15);
  const unsigned mc = (unsigned)(reinterpret_cast<uintptr_t>(c) & 15);
  if (ma != mb || ma != mc || (ma & 3)) return {V, 0};
  int head = (int)((16 - ma) & 15) / 4;
  if (head > V) head = V;
  return {head, (V - head) / 4};
}

// Calls f(x[i]) on every element of the row that this thread owns.
template <typename F>
__device__ __forceinline__ void walk1(const float* __restrict__ x, int V,
                                      F&& f) {
  const RowSplit sp = split_row(x, x, x, V);
  for (int i = threadIdx.x; i < sp.head; i += THREADS) f(x[i]);
  const float4* xv = reinterpret_cast<const float4*>(x + sp.head);
#pragma unroll 4
  for (int j = threadIdx.x; j < sp.nvec; j += THREADS) {
    const float4 a = __ldg(xv + j);
    f(a.x);
    f(a.y);
    f(a.z);
    f(a.w);
  }
  for (int i = sp.head + 4 * sp.nvec + threadIdx.x; i < V; i += THREADS)
    f(x[i]);
}

// Calls f(s[i], t[i]) on every element of the row that this thread owns.
template <typename F>
__device__ __forceinline__ void walk2(const float* __restrict__ s,
                                      const float* __restrict__ t, int V,
                                      F&& f) {
  const RowSplit sp = split_row(s, t, s, V);
  for (int i = threadIdx.x; i < sp.head; i += THREADS) f(s[i], t[i]);
  const float4* sv = reinterpret_cast<const float4*>(s + sp.head);
  const float4* tv = reinterpret_cast<const float4*>(t + sp.head);
#pragma unroll 4
  for (int j = threadIdx.x; j < sp.nvec; j += THREADS) {
    const float4 a = __ldg(sv + j);
    const float4 b = __ldg(tv + j);
    f(a.x, b.x);
    f(a.y, b.y);
    f(a.z, b.z);
    f(a.w, b.w);
  }
  for (int i = sp.head + 4 * sp.nvec + threadIdx.x; i < V; i += THREADS)
    f(s[i], t[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums of K values over the block, in a fixed order; valid in thread 0.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K]) {
  __shared__ float part[K][WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) part[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float acc = 0.f;
      for (int w = 0; w < WARPS; ++w) acc += part[k][w];
      v[k] = acc;
    }
  }
}

// Online logsumexp state (m, l): l = sum exp(x - m) over the values seen.
__device__ __forceinline__ void lse_push(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& l, float m2,
                                          float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// x: (N, V) rows at stride x_stride; out: (N,). grid = N, block = THREADS.
__global__ void __launch_bounds__(THREADS)
row_logsumexp_kernel(const float* __restrict__ x, long long x_stride,
                     float* __restrict__ out, int V) {
  const float* row = x + (long long)blockIdx.x * x_stride;
  float m = NEG_INF, l = 0.f;
  walk1(row, V, [&](float a) { lse_push(m, l, a); });

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    lse_merge(m, l, m2, l2);
  }
  __shared__ float pm[WARPS], pl[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    pm[warp] = m;
    pl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) lse_merge(m, l, pm[w], pl[w]);
    out[blockIdx.x] = m + logf(l);
  }
}

template <int MODE>
__device__ __forceinline__ float weight(float p, float q, float r, float mu,
                                        float inv_sigma) {
  if constexpr (MODE == TVDPP) {
    return -(r - mu) * inv_sigma;
  } else {
    return p > q ? 0.5f : (p < q ? -0.5f : 0.f);   // 0.5 * sign(p - q)
  }
}

// s, t: (N, V) rows at their strides; lse_s, lse_t: (N,); mu, inv_sigma:
// 1 element each; out: loss, c, r1, r2, each (N,). grid = N.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
loss_terms_kernel(const float* __restrict__ s, long long s_stride,
                  const float* __restrict__ t, long long t_stride,
                  const float* __restrict__ lse_s,
                  const float* __restrict__ lse_t,
                  const float* __restrict__ mu_p,
                  const float* __restrict__ inv_sigma_p,
                  float* __restrict__ loss, float* __restrict__ c,
                  float* __restrict__ r1, float* __restrict__ r2, int V) {
  const int n = blockIdx.x;
  const float ls = lse_s[n], lt = lse_t[n];
  const float mu = *mu_p, inv_sigma = *inv_sigma_p;
  float a_loss = 0.f, a_c = 0.f, a_r1 = 0.f, a_r2 = 0.f;  // a_loss: tvd, kld
  walk2(s + (long long)n * s_stride, t + (long long)n * t_stride, V,
        [&](float sx, float tx) {
          const float p = expf(sx - ls);
          const float q = expf(tx - lt);
          const float r = q > p ? 1.f : 0.f;
          if constexpr (MODE == KLD) {
            a_loss += q * ((tx - lt) - (sx - ls));
          } else {
            a_c += p * weight<MODE>(p, q, r, mu, inv_sigma);
            if constexpr (MODE == TVD) a_loss += 0.5f * fabsf(q - p);
          }
          a_r1 += p * r;
          a_r2 += p * r * r;
        });
  float acc[4] = {a_loss, a_c, a_r1, a_r2};
  block_sums<4>(acc);
  if (threadIdx.x == 0) {
    loss[n] = MODE == TVDPP ? acc[1] : acc[0];
    c[n] = acc[1];
    r1[n] = acc[2];
    r2[n] = acc[3];
  }
}

// out: (N, V) contiguous fp32. grid = N.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
loss_grad_kernel(const float* __restrict__ s, long long s_stride,
                 const float* __restrict__ t, long long t_stride,
                 const float* __restrict__ lse_s,
                 const float* __restrict__ lse_t,
                 const float* __restrict__ c_rows,
                 const float* __restrict__ g_rows,
                 const float* __restrict__ mu_p,
                 const float* __restrict__ inv_sigma_p,
                 float* __restrict__ out, int V) {
  const int n = blockIdx.x;
  const float ls = lse_s[n], lt = lse_t[n], c = c_rows[n], g = g_rows[n];
  const float mu = *mu_p, inv_sigma = *inv_sigma_p;
  const float* srow = s + (long long)n * s_stride;
  const float* trow = t + (long long)n * t_stride;
  float* orow = out + (long long)n * V;
  auto grad = [&](float sx, float tx) {
    const float p = expf(sx - ls);
    const float q = expf(tx - lt);
    if constexpr (MODE == KLD) {
      return g * (p - q);
    } else {
      const float r = q > p ? 1.f : 0.f;
      return g * p * (weight<MODE>(p, q, r, mu, inv_sigma) - c);
    }
  };
  const RowSplit sp = split_row(srow, trow, orow, V);
  for (int i = threadIdx.x; i < sp.head; i += THREADS)
    orow[i] = grad(srow[i], trow[i]);
  const float4* sv = reinterpret_cast<const float4*>(srow + sp.head);
  const float4* tv = reinterpret_cast<const float4*>(trow + sp.head);
  float4* ov = reinterpret_cast<float4*>(orow + sp.head);
#pragma unroll 4
  for (int j = threadIdx.x; j < sp.nvec; j += THREADS) {
    const float4 a = __ldg(sv + j);
    const float4 b = __ldg(tv + j);
    ov[j] = make_float4(grad(a.x, b.x), grad(a.y, b.y), grad(a.z, b.z),
                        grad(a.w, b.w));
  }
  for (int i = sp.head + 4 * sp.nvec + threadIdx.x; i < V; i += THREADS)
    orow[i] = grad(srow[i], trow[i]);
}

}  // namespace

// Each entry point launches on ``stream`` and returns the CUDA error of
// the launch (0 on success). mode: 0 = kld, 1 = tvd, 2 = tvdpp; another
// mode, V < 1 or N < 0 returns cudaErrorInvalidValue without launching.
// N = 0 launches nothing.

extern "C" int row_logsumexp_launch(const void* x, long long x_stride,
                                    void* out, int N, int V, void* stream) {
  if (N < 0 || V < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  row_logsumexp_kernel<<<N, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, x_stride, (float*)out, V);
  return (int)cudaGetLastError();
}

extern "C" int loss_terms_launch(const void* s, long long s_stride,
                                 const void* t, long long t_stride,
                                 const void* lse_s, const void* lse_t,
                                 const void* mu, const void* inv_sigma,
                                 void* loss, void* c, void* r1, void* r2,
                                 int N, int V, int mode, void* stream) {
  if (N < 0 || V < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define TERMS_ARGS                                                        \
  (const float*)s, s_stride, (const float*)t, t_stride,                   \
      (const float*)lse_s, (const float*)lse_t, (const float*)mu,         \
      (const float*)inv_sigma, (float*)loss, (float*)c, (float*)r1,       \
      (float*)r2, V
  if (mode == KLD) {
    loss_terms_kernel<KLD><<<N, THREADS, 0, st>>>(TERMS_ARGS);
  } else if (mode == TVD) {
    loss_terms_kernel<TVD><<<N, THREADS, 0, st>>>(TERMS_ARGS);
  } else if (mode == TVDPP) {
    loss_terms_kernel<TVDPP><<<N, THREADS, 0, st>>>(TERMS_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef TERMS_ARGS
  return (int)cudaGetLastError();
}

extern "C" int loss_grad_launch(const void* s, long long s_stride,
                                const void* t, long long t_stride,
                                const void* lse_s, const void* lse_t,
                                const void* c, const void* g_rows,
                                const void* mu, const void* inv_sigma,
                                void* out, int N, int V, int mode,
                                void* stream) {
  if (N < 0 || V < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define GRAD_ARGS                                                         \
  (const float*)s, s_stride, (const float*)t, t_stride,                   \
      (const float*)lse_s, (const float*)lse_t, (const float*)c,          \
      (const float*)g_rows, (const float*)mu, (const float*)inv_sigma,    \
      (float*)out, V
  if (mode == KLD) {
    loss_grad_kernel<KLD><<<N, THREADS, 0, st>>>(GRAD_ARGS);
  } else if (mode == TVD) {
    loss_grad_kernel<TVD><<<N, THREADS, 0, st>>>(GRAD_ARGS);
  } else if (mode == TVDPP) {
    loss_grad_kernel<TVDPP><<<N, THREADS, 0, st>>>(GRAD_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef GRAD_ARGS
  return (int)cudaGetLastError();
}

// The resources of one kernel's instance, into info (KERNEL_INFO_INTS
// ints, kernel_info.cuh): which 0 = row_logsumexp, 1 = loss_terms, 2 =
// loss_grad, in mode as the launch entries take it. Launches nothing;
// returns the CUDA error of the query.
extern "C" int distill_loss_query(int which, int mode, int* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  if (which == 0) return kernel_info(row_logsumexp_kernel, THREADS, 0, info);
  if (which == 1) {
    if (mode == KLD) return kernel_info(loss_terms_kernel<KLD>, THREADS, 0, info);
    if (mode == TVD) return kernel_info(loss_terms_kernel<TVD>, THREADS, 0, info);
    if (mode == TVDPP)
      return kernel_info(loss_terms_kernel<TVDPP>, THREADS, 0, info);
  }
  if (which == 2) {
    if (mode == KLD) return kernel_info(loss_grad_kernel<KLD>, THREADS, 0, info);
    if (mode == TVD) return kernel_info(loss_grad_kernel<TVD>, THREADS, 0, info);
    if (mode == TVDPP)
      return kernel_info(loss_grad_kernel<TVDPP>, THREADS, 0, info);
  }
  return (int)cudaErrorInvalidValue;
}
