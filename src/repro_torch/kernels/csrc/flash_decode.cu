// Flash decode for Hopper (sm_90a): attention of one decode position per
// query head over a KV cache, the G query heads of a KV head sharing every
// K/V read.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py: flash_decode
// -> pallas_call(_decode_kernel). That kernel walked 128-slot KV tiles as
// the sequential minor axis of a (B, Hkv, tiles) grid and carried the
// online softmax state (m, l, acc) in VMEM scratch from one tile to the
// next. Blocks on this card run in parallel with nothing carried between
// them, so here the slots of a (batch, kv head) are split across blocks
// (split-KV), each block loops over its share with the same online
// softmax, and a second kernel combines the blocks' partial states in a
// fixed order; with one split the block normalises and writes the output
// itself.
//
// What bounds it on this card: reading K and V, 2*B*S*Hkv*hd values. The
// arithmetic is 4*hd flops per (query row, slot), with G rows per slot
// read, far below the card's rate. A slot's K (or V) row of one head is
// hd*sizeof(T) contiguous bytes at a stride of Hkv*hd elements; a group of
// LANES adjacent lanes reads it in 16-byte loads (two per lane for fp32 at
// hd 256), so whole 32-byte sectors. Each group takes UNROLL slots a step
// and issues all their loads before any arithmetic, so a thread keeps
// 2*UNROLL*16 bytes in flight. The split count (chosen by the wrapper,
// kernels/flash_decode.py) gives a few blocks per SM even where B*Hkv is
// small: the drafter has 32 (batch, kv head) pairs for 132 SMs.
//
// Semantics follow the plain version (kernels/ref.py ref_flash_decode):
// fp32 scores scaled by 1/sqrt(hd), optional tanh softcap, masked slots set
// to the finite sentinel -1e30 (a fully masked row averages V over all S
// slots, as the reference does), the final division guarded by
// max(l, 1e-30), fp32 output. Any S >= 1: slots past S take no part.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;    // 4 warps per block
constexpr int UNROLL = 4;       // slots per group per step
constexpr int COMBINE_THREADS = 64;
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// How a block reads a row of HD values of type T: LANES lanes per slot,
// ELEMS values in VECS 16-byte loads per lane, GROUPS slot groups.
template <typename T, int HD>
struct RowSplit {
  static constexpr int BYTES = HD * (int)sizeof(T);
  static constexpr int LANES = BYTES / 16 < 32 ? BYTES / 16 : 32;
  static constexpr int ELEMS = HD / LANES;
  static constexpr int VECS = ELEMS * (int)sizeof(T) / 16;
  static constexpr int GROUPS = THREADS / LANES;
};

// q: (B, Hkv, G, HD); k, v: (B, S, Hkv, HD); mask: (B, S) bytes.
// grid = (B*Hkv, ceil(G / GT), splits): block (bh, y, z) owns query rows
// y*GT .. y*GT+GT-1 of (batch, kv head) bh and slots [z*chunk, (z+1)*chunk).
// splits == 1: out (B, Hkv, G, HD) fp32, normalised. Otherwise the
// partial state of row r = bh*G + g goes to part[(r*splits + z)*(HD + 2)]:
// acc[HD] unnormalised, then m, then l.
template <typename T, int HD, int GT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, float* __restrict__ part, int S,
                    int Hkv, int G, int chunk, int splits, float scale,
                    int has_cap, float cap) {
  using R = RowSplit<T, HD>;
  constexpr int LANES = R::LANES, E = R::ELEMS, NV = R::VECS, NG = R::GROUPS;
  __shared__ float sm_acc[GT][NG][HD];
  __shared__ float sm_m[GT][NG];
  __shared__ float sm_l[GT][NG];

  const int bh = blockIdx.x;           // b * Hkv + h
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int g0 = blockIdx.y * GT;
  const int s_begin = blockIdx.z * chunk;
  const int s_end = min(S, s_begin + chunk);
  const int grp = threadIdx.x / LANES;
  const int e0 = (threadIdx.x % LANES) * E;   // this lane's first value

  float qr[GT][E], m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    const int g = g0 + i;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[i][e] = g < G ? to_float(q[((size_t)bh * G + g) * HD + e0 + e]) : 0.f;
      acc[i][e] = 0.f;
    }
    m[i] = MASKED;
    l[i] = 0.f;
  }

  const size_t stride = (size_t)Hkv * HD;     // values from slot to slot
  const T* kp = k + ((size_t)b * S * Hkv + h) * HD + e0;
  const T* vp = v + ((size_t)b * S * Hkv + h) * HD + e0;
  const uint8_t* mp = mask + (size_t)b * S;

  for (int base = s_begin; base < s_end; base += NG * UNROLL) {
    // all loads of the step first (the wrapper checks 16-byte alignment)
    uint4 kr[UNROLL][NV], vr[UNROLL][NV];
    bool in[UNROLL], keep[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = base + u * NG + grp;
      in[u] = s < s_end;
      keep[u] = false;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        kr[u][c] = make_uint4(0u, 0u, 0u, 0u);
        vr[u][c] = kr[u][c];
      }
      if (in[u]) {
        const uint4* k4 = reinterpret_cast<const uint4*>(kp + (size_t)s * stride);
        const uint4* v4 = reinterpret_cast<const uint4*>(vp + (size_t)s * stride);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          kr[u][c] = k4[c];
          vr[u][c] = v4[c];
        }
        keep[u] = mp[s] != 0;
      }
    }

    // scores: each lane's partial q.k, summed over the group's lanes
    float sc[GT][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const T* kt = reinterpret_cast<const T*>(kr[u]);
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[i][e], to_float(kt[e]), dot);
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        float s = dot * scale;
        if (has_cap) s = cap * tanhf(s / cap);
        if (!keep[u]) s = MASKED;
        sc[i][u] = in[u] ? s : -INFINITY;   // past the share: no weight
      }
    }

    // online softmax over the step's slots
#pragma unroll
    for (int i = 0; i < GT; ++i) {
      float tmax = sc[i][0];
#pragma unroll
      for (int u = 1; u < UNROLL; ++u) tmax = fmaxf(tmax, sc[i][u]);
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float p[UNROLL], psum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u] = in[u] ? expf(sc[i][u] - m_new) : 0.f;
        psum += p[u];
      }
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const T* vt = reinterpret_cast<const T*>(vr[u]);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[i][e] = fmaf(p[u], to_float(vt[e]), acc[i][e]);
      }
      m[i] = m_new;
    }
  }

  // the groups' states, combined in group order
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    if (threadIdx.x % LANES == 0) {
      sm_m[i][grp] = m[i];
      sm_l[i][grp] = l[i];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[i][grp][e0 + e] = acc[i][e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < GT * HD; t += THREADS) {
    const int i = t / HD;
    const int d = t - i * HD;
    const int g = g0 + i;
    if (g >= G) continue;
    float mt = MASKED;
    for (int j = 0; j < NG; ++j) mt = fmaxf(mt, sm_m[i][j]);
    float lt = 0.f, at = 0.f;
    for (int j = 0; j < NG; ++j) {
      const float w = expf(sm_m[i][j] - mt);
      lt = fmaf(w, sm_l[i][j], lt);
      at = fmaf(w, sm_acc[i][j][d], at);
    }
    const size_t row = (size_t)bh * G + g;
    if (splits == 1) {
      out[row * HD + d] = at / fmaxf(lt, 1e-30f);
    } else {
      float* pp = part + (row * splits + blockIdx.z) * (HD + 2);
      pp[d] = at;
      if (d == 0) {
        pp[HD] = mt;
        pp[HD + 1] = lt;
      }
    }
  }
}

// part: (rows, splits, hd + 2) -> out (rows, hd), the splits in order.
// grid = rows.
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_decode_combine(const float* __restrict__ part, float* __restrict__ out,
                     int splits, int hd) {
  const size_t row = blockIdx.x;
  const float* p = part + row * splits * (hd + 2);
  float mt = MASKED;
  for (int z = 0; z < splits; ++z) mt = fmaxf(mt, p[z * (hd + 2) + hd]);
  for (int d = threadIdx.x; d < hd; d += COMBINE_THREADS) {
    float lt = 0.f, at = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float* pz = p + z * (hd + 2);
      const float w = expf(pz[hd] - mt);
      lt = fmaf(w, pz[hd + 1], lt);
      at = fmaf(w, pz[d], at);
    }
    out[row * hd + d] = at / fmaxf(lt, 1e-30f);
  }
}

struct Args {
  const void *q, *k, *v, *mask;
  void *out, *part;
  int B, S, Hkv, G, chunk, splits, has_cap;
  float cap;
  cudaStream_t stream;
};

template <typename T, int HD, int GT>
int launch(const Args& a) {
  const dim3 grid(a.B * a.Hkv, (a.G + GT - 1) / GT, a.splits);
  const float scale = 1.0f / sqrtf((float)HD);
  flash_decode_kernel<T, HD, GT><<<grid, THREADS, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask,
      (float*)a.out, (float*)a.part, a.S, a.Hkv, a.G, a.chunk, a.splits,
      scale, a.has_cap, a.cap);
  if (a.splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_decode_combine<<<a.B * a.Hkv * a.G, COMBINE_THREADS, 0, a.stream>>>(
        (const float*)a.part, (float*)a.out, a.splits, HD);
  }
  return (int)cudaGetLastError();
}

// Query rows per block: 1, 2, or 4 (G >= 3; G > 4 takes several blocks).
template <typename T, int HD>
int by_rows(const Args& a) {
  if (a.G == 1) return launch<T, HD, 1>(a);
  if (a.G == 2) return launch<T, HD, 2>(a);
  return launch<T, HD, 4>(a);
}

template <typename T>
int by_head_dim(const Args& a, int hd) {
  switch (hd) {
    case 16: return by_rows<T, 16>(a);
    case 32: return by_rows<T, 32>(a);
    case 64: return by_rows<T, 64>(a);
    case 128: return by_rows<T, 128>(a);
    case 256: return by_rows<T, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike). chunk slots per
// block, splits = ceil(S / chunk) blocks per (batch, kv head, row tile);
// with splits > 1, part holds B*Hkv*G*splits*(hd + 2) floats of scratch.
// Returns the CUDA error of the launches (0 on success); arguments the
// kernel does not take return cudaErrorInvalidValue without launching.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* mask, void* out,
                                   void* part, int B, int S, int Hkv, int G,
                                   int hd, int dtype, int chunk, int splits,
                                   int has_cap, float cap, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || chunk < 1 ||
      splits != (S + chunk - 1) / chunk || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, out, part, B, S, Hkv, G, chunk, splits,
               has_cap, cap, (cudaStream_t)stream};
  if (dtype == 0) return by_head_dim<float>(a, hd);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(a, hd);
  return (int)cudaErrorInvalidValue;
}
