// Tree attention for Hopper (sm_90a): every node of a speculative draft
// tree attends the KV cache under its own ancestor mask, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/tree_attention.py:
// tree_attention -> pallas_call(_tree_kernel). That kernel walked the KV
// tiles as the sequential minor axis of its grid and carried the online
// softmax state in VMEM scratch from one grid step to the next. Blocks on
// this card run in parallel with nothing carried between them, so here one
// block owns up to MAX_WARPS query rows of one (batch, kv head) and loops
// over the KV tiles itself; each row's m, l and acc[hd] stay in fp32
// registers of its warp for the whole loop.
//
// What bounds it on this card: reading K and V, B*S*Hkv*hd*2 values of 2
// bytes each in bf16, plus the (B, N, S) mask. The arithmetic is 4*hd flops
// per (row, slot), far below the card's rate at N*G <= a few dozen rows.
// The design reads each K/V tile from device memory once per block into
// shared memory, in 16-byte loads with several in flight (converted to fp32
// there), and lets every warp of the block score it: one lane per slot for
// q.k, then one lane per output dimension for p.V. Rows beyond MAX_WARPS
// go to further blocks, which read the same tiles again through L2. Split-KV across blocks, TMA and wgmma are not
// used: at the serving shapes (S of a few hundred, N*G <= 21) the launch
// itself costs more than the bytes.
//
// Semantics follow the plain version (kernels/ref.py ref_tree_attention):
// fp32 scores scaled by 1/sqrt(hd), optional tanh softcap, masked slots set
// to the finite sentinel -1e30 (a fully masked row averages V over all S
// slots, as the reference does), fp32 output. Any S is allowed: slots past
// S in the ragged last tile take no part at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;        // KV slots per tile: one per lane
constexpr int MAX_WARPS = 8;    // query rows (one per warp) per block
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// q: (B, Hkv, N, G, HD); k, v: (B, S, Hkv, HD); mask: (B, N, S) bytes;
// out: (B, Hkv, N, G, HD) fp32. grid = (B*Hkv, ceil(N*G / MAX_WARPS)).
template <typename T, int HD>
__global__ void __launch_bounds__(32 * MAX_WARPS)
tree_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ out, int S, int Hkv, int N, int G,
                      float scale, int has_cap, float cap) {
  constexpr int PER_LANE = HD / 32;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ float ks[TILE][HD + 1];   // +1: lane j reads row j conflict-free
  __shared__ float vs[TILE][HD];
  __shared__ float qs[MAX_WARPS][HD];

  const int bh = blockIdx.x;           // b * Hkv + h
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = N * G;
  const int row = blockIdx.y * MAX_WARPS + warp;   // row = n * G + g
  const bool active = row < rows;
  const int n = active ? row / G : 0;
  const size_t qrow = ((size_t)bh * rows + row) * HD;

  if (active) {
    for (int d = lane; d < HD; d += 32) qs[warp][d] = to_float(q[qrow + d]);
  }
  const uint8_t* mrow = mask + ((size_t)b * N + n) * S;

  float m = MASKED;
  float l = 0.f;
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TILE) {
    __syncthreads();                   // the previous tile is consumed
    // 16-byte loads (the wrapper checks the alignment), unrolled so that
    // several are in flight before the first lands
#pragma unroll 4
    for (int c = threadIdx.x; c < TILE * HD / VEC; c += blockDim.x) {
      const int j = c / (HD / VEC);
      const int d = (c - j * (HD / VEC)) * VEC;
      const int s = t0 + j;
      uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * Hkv + h) * HD + d;
        kraw = *reinterpret_cast<const uint4*>(k + off);
        vraw = *reinterpret_cast<const uint4*>(v + off);
      }
      const T* kt = reinterpret_cast<const T*>(&kraw);
      const T* vt = reinterpret_cast<const T*>(&vraw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j][d + e] = to_float(kt[e]);
        vs[j][d + e] = to_float(vt[e]);
      }
    }
    __syncthreads();
    if (!active) continue;

    const int s = t0 + lane;
    float score = -INFINITY;           // past S: no weight, not even masked
    if (s < S) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qs[warp][d] * ks[lane][d];
      score = dot * scale;
      if (has_cap) score = cap * tanhf(score / cap);
      if (!mrow[s]) score = MASKED;
    }
    float tmax = score;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    const float p = (s < S) ? expf(score - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] *= alpha;
    const int jmax = min(TILE, S - t0);
    for (int j = 0; j < jmax; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) acc[i] += pj * vs[j][lane + 32 * i];
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) out[qrow + lane + 32 * i] = acc[i] * inv;
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const void* mask,
            void* out, int B, int S, int Hkv, int N, int G, int has_cap,
            float cap, cudaStream_t stream) {
  const int rows = N * G;
  const dim3 grid(B * Hkv, (rows + MAX_WARPS - 1) / MAX_WARPS);
  const dim3 block(32 * (rows < MAX_WARPS ? rows : MAX_WARPS));
  const float scale = 1.0f / sqrtf((float)HD);
  tree_attention_kernel<T, HD><<<grid, block, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)mask,
      (float*)out, S, Hkv, N, G, scale, has_cap, cap);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike). Returns the CUDA
// error of the launch (0 on success); an unsupported hd or dtype returns
// cudaErrorInvalidValue without launching.
extern "C" int tree_attention_launch(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int B, int S, int Hkv, int N,
                                     int G, int hd, int dtype, int has_cap,
                                     float cap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || S < 1 || Hkv < 1 || N < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64) {
    launch<float, 64>(q, k, v, mask, out, B, S, Hkv, N, G, has_cap, cap, st);
  } else if (dtype == 0 && hd == 128) {
    launch<float, 128>(q, k, v, mask, out, B, S, Hkv, N, G, has_cap, cap, st);
  } else if (dtype == 1 && hd == 64) {
    launch<__nv_bfloat16, 64>(q, k, v, mask, out, B, S, Hkv, N, G, has_cap,
                              cap, st);
  } else if (dtype == 1 && hd == 128) {
    launch<__nv_bfloat16, 128>(q, k, v, mask, out, B, S, Hkv, N, G, has_cap,
                               cap, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
