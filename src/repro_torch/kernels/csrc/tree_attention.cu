// Tree attention for Hopper (sm_90a): every node of a speculative draft
// tree attends the KV cache under its own ancestor mask, in one launch
// (plus a combine launch where the slots are split).
//
// Replaces the TPU kernel src/repro/kernels/tree_attention.py:
// tree_attention -> pallas_call(_tree_kernel). That kernel walked the KV
// tiles as the sequential minor axis of its grid and carried the online
// softmax state in VMEM scratch from one grid step to the next. Blocks on
// this card run in parallel with nothing carried between them, so here
// the slots of a (batch, kv head) are split across blocks (split-KV, as
// in flash_decode.cu, which is the case of one node), each block runs the
// online softmax over its share for up to RT query rows, and a second
// kernel combines the blocks' partial states in split order; with one
// split the block normalises and writes the output itself.
//
// What bounds it on this card: reading K and V, 2*B*S*Hkv*hd values (13.2
// MB, 3.9 us at 3.35 TB/s, for the 7B target's verify pass: B 4, Hkv 32,
// S 201, hd 128, bf16). The arithmetic, 4*hd flops per (row, slot) over
// N*G <= a few dozen rows, is far below the card's rate, but a block that
// walks every slot of a head alone, one tile after another with a barrier
// between load and use (the first version of this kernel), is a chain of
// latencies, and on the CUDA cores the N*G rows' dot products, shuffles
// and exponentials cost more than the bytes. The design:
//   * split-KV: the wrapper's plan (kernels/tree_attention.py) splits the
//     slots of a head across blocks where B*Hkv blocks would leave SMs
//     idle, and the partial states are combined in a fixed order;
//   * bf16 at head dims 32-128 (the serving path) runs on the tensor cores
//     (tree_attention_mma): 16 query rows and 8 warps a block, each warp
//     taking 16-slot chunks with the next chunk's K and V in flight, so
//     that a warp's chain of dependent loads is short; the target's verify
//     pass is 128 blocks of one split, at most 2 chunks a warp;
//   * bf16 at head dim 256 (Gemma-2-9B's verify) runs on the tensor cores
//     too (tree_attention_mma_ring), where a warp's q fragments, output
//     and K in registers would take about 320: 4 warps a block, each
//     staging its chunks' K and V rows in its own 2-stage cp.async ring in
//     shared memory, q and K read by ldmatrix, V by ldmatrix.trans (the
//     staging of flash_decode.cu's MmaWarp); the verify pass past the
//     window is 32 (batch, kv head) tiles x 4 splits, 17 chunks a warp;
//   * otherwise (fp32 at every head dim, bf16 at hd 16) the CUDA-core
//     kernel: a group of LANES adjacent lanes reads a slot's strided K (or
//     V) row in 16-byte loads, UNROLL slots a step with all loads issued
//     before any arithmetic, and a block holds RT (1, 2, 4 or 8) of the
//     N*G rows in registers, more rows taking more row tiles.
// Each row's node selects its mask row. The partial states are combined in
// a fixed order, so the result does not depend on scheduling.
//
// Semantics follow the plain version (kernels/ref.py ref_tree_attention):
// fp32 scores scaled by 1/sqrt(hd), optional tanh softcap, masked slots set
// to the finite sentinel -1e30 (a fully masked row averages V over all S
// slots, as the reference does), the final division guarded by
// max(l, 1e-30), fp32 output. Any S >= 1: slots past S take no part. Head
// dims 16, 32, 64, 128 and 256.
//
// Resources (nvcc 12.8 -Xptxas -v for sm_90a, as chip_smoke.py phase 1
// prints them): tree_attention_mma at hd 32/64/128: 80/128/206 registers,
// 20/36/68 KiB of dynamic shared memory, hd 64 spilling 4/4 bytes;
// tree_attention_mma_ring at hd 256: 244 registers, 140.25 KiB of dynamic
// and 512 B of static shared memory, one block an SM, no spills.
// tree_attention_kernel: 71-255 registers and 2-36 KiB of shared memory
// across its 24 instances (RT 8 at hd 16 and 256 takes 255);
// fp32 at hd 256 with RT 8 spills 108/84 bytes, at hd 128 and 64 with RT
// 1 or 2 8-12 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_info.cuh"

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

// q: (B, Hkv, N, G, HD) = (B*Hkv, R = N*G rows, HD); k, v: (B, S, Hkv, HD);
// mask: (B, N, S) bytes. grid = (B*Hkv, ceil(R / RT), splits): block
// (bh, y, z) owns rows y*RT .. y*RT+RT-1 of (batch, kv head) bh and slots
// [z*chunk, (z+1)*chunk). splits == 1: out (B*Hkv, R, HD) fp32,
// normalised. Otherwise the partial state of row bh*R + r goes to
// part[((bh*R + r)*splits + z)*(HD + 2)]: acc[HD] unnormalised, m, l.
template <typename T, int HD, int RT>
__global__ void __launch_bounds__(THREADS)
tree_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      float* __restrict__ out, float* __restrict__ part, int S,
                      int Hkv, int N, int G, int chunk, int splits,
                      float scale, int has_cap, float cap) {
  using R = RowSplit<T, HD>;
  constexpr int LANES = R::LANES, E = R::ELEMS, NV = R::VECS, NG = R::GROUPS;
  __shared__ float sm_acc[RT][NG][HD];
  __shared__ float sm_m[RT][NG];
  __shared__ float sm_l[RT][NG];

  const int rows = N * G;
  const int bh = blockIdx.x;           // b * Hkv + h
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int r0 = blockIdx.y * RT;
  const int s_begin = blockIdx.z * chunk;
  const int s_end = min(S, s_begin + chunk);
  const int grp = threadIdx.x / LANES;
  const int e0 = (threadIdx.x % LANES) * E;   // this lane's first value

  float qr[RT][E], m[RT], l[RT], acc[RT][E];
  const uint8_t* mrow[RT];              // each row's node's mask row
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + i;
    const bool live = r < rows;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[i][e] = live ? to_float(q[((size_t)bh * rows + r) * HD + e0 + e]) : 0.f;
      acc[i][e] = 0.f;
    }
    m[i] = MASKED;
    l[i] = 0.f;
    mrow[i] = mask + ((size_t)b * N + (live ? r / G : 0)) * S;
  }

  const size_t stride = (size_t)Hkv * HD;     // values from slot to slot
  const T* kp = k + ((size_t)b * S * Hkv + h) * HD + e0;
  const T* vp = v + ((size_t)b * S * Hkv + h) * HD + e0;

  for (int base = s_begin; base < s_end; base += NG * UNROLL) {
    // all loads of the step first (the wrapper checks 16-byte alignment)
    uint4 kr[UNROLL][NV], vr[UNROLL][NV];
    bool in[UNROLL];
    bool keep[UNROLL][RT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = base + u * NG + grp;
      in[u] = s < s_end;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        kr[u][c] = make_uint4(0u, 0u, 0u, 0u);
        vr[u][c] = kr[u][c];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) keep[u][i] = false;
      if (in[u]) {
        const uint4* k4 = reinterpret_cast<const uint4*>(kp + (size_t)s * stride);
        const uint4* v4 = reinterpret_cast<const uint4*>(vp + (size_t)s * stride);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          kr[u][c] = k4[c];
          vr[u][c] = v4[c];
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) keep[u][i] = mrow[i][s] != 0;
      }
    }

    // scores: each lane's partial q.k, summed over the group's lanes
    float sc[RT][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const T* kt = reinterpret_cast<const T*>(kr[u]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[i][e], to_float(kt[e]), dot);
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        float s = dot * scale;
        if (has_cap) s = cap * tanhf(s / cap);
        if (!keep[u][i]) s = MASKED;
        sc[i][u] = in[u] ? s : -INFINITY;   // past the share: no weight
      }
    }

    // online softmax over the step's slots
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float tmax = sc[i][0];
#pragma unroll
      for (int u = 1; u < UNROLL; ++u) tmax = fmaxf(tmax, sc[i][u]);
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = __expf(m[i] - m_new);
      float p[UNROLL], psum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u] = in[u] ? __expf(sc[i][u] - m_new) : 0.f;
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
  for (int i = 0; i < RT; ++i) {
    if (threadIdx.x % LANES == 0) {
      sm_m[i][grp] = m[i];
      sm_l[i][grp] = l[i];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[i][grp][e0 + e] = acc[i][e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < RT * HD; t += THREADS) {
    const int i = t / HD;
    const int d = t - i * HD;
    const int r = r0 + i;
    if (r >= rows) continue;
    float mt = MASKED;
    for (int j = 0; j < NG; ++j) mt = fmaxf(mt, sm_m[i][j]);
    float lt = 0.f, at = 0.f;
    for (int j = 0; j < NG; ++j) {
      const float w = __expf(sm_m[i][j] - mt);
      lt = fmaf(w, sm_l[i][j], lt);
      at = fmaf(w, sm_acc[i][j][d], at);
    }
    const size_t row = (size_t)bh * rows + r;
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
tree_attention_combine(const float* __restrict__ part, float* __restrict__ out,
                       int splits, int hd) {
  const size_t row = blockIdx.x;
  const float* p = part + row * splits * (hd + 2);
  float mt = MASKED;
  for (int z = 0; z < splits; ++z) mt = fmaxf(mt, p[z * (hd + 2) + hd]);
  for (int d = threadIdx.x; d < hd; d += COMBINE_THREADS) {
    float lt = 0.f, at = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float* pz = p + z * (hd + 2);
      const float w = __expf(pz[hd] - mt);
      lt = fmaf(w, pz[hd + 1], lt);
      at = fmaf(w, pz[d], at);
    }
    out[row * hd + d] = at / fmaxf(lt, 1e-30f);
  }
}


// ---- bf16 at head dims 32 to 128: the scores and p.V on the tensor cores

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// Four bf16 8x8 matrices from shared memory, lanes 8i..8i+7 giving the row
// addresses of matrix i: register i of lane l holds row l/4, columns
// 2(l%4) and +1 of matrix i (ldsm_x4), or of its transpose (ldsm_x4_trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int MMA_ROWS = 16;    // query rows per block: the MMA's M
constexpr int CHUNK = 16;       // slots per warp and step: the MMA's K of p.V
constexpr int MMA_THREADS = 256;  // 8 warps: a short chain of chunks each

// The tensor-core kernels' steps for a warp's 16 query rows: lane l holds
// rows g = l / 4 and g + 8 (c 0, 1 and c 2, 3 of a C fragment), t = l % 4.

// The online softmax of the rows over a chunk of 16 slots: p holds the
// chunk's scores (C fragments of two 8-slot tiles), m the rows' running
// max, l this lane's share of their sums; acc is rescaled, and p becomes
// the A operand of p.V (slots 2t, 2t+1 | 2t+8, 2t+9) in two bf16 terms,
// hi + lo, which keep 16 bits of p.
template <int NT>
__device__ __forceinline__ void softmax_chunk(float (&p)[2][4], float (&m)[2],
                                              float (&l)[2], float (&acc)[NT][4],
                                              uint32_t (&ph)[4],
                                              uint32_t (&pl)[4]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = fmaxf(fmaxf(p[0][2 * hr], p[0][2 * hr + 1]),
                     fmaxf(p[1][2 * hr], p[1][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hr], mx);
    const float alpha = __expf(m[hr] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 2 * hr; c < 2 * hr + 2; ++c) {
        p[nt][c] = __expf(p[nt][c] - m_new);
        psum += p[nt][c];
      }
    l[hr] = l[hr] * alpha + psum;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      acc[i][2 * hr] *= alpha;
      acc[i][2 * hr + 1] *= alpha;
    }
    m[hr] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p0 = p[i >> 1][2 * (i & 1)];
    const float p1 = p[i >> 1][2 * (i & 1) + 1];
    const float h0 = __bfloat162float(__float2bfloat16_rn(p0));
    const float h1 = __bfloat162float(__float2bfloat16_rn(p1));
    ph[i] = pack_bf16(h0, h1);
    pl[i] = pack_bf16(p0 - h0, p1 - h1);
  }
}

// acc += p.V over a chunk of 16 staged V rows; vrow is this lane's row
// address for ldmatrix.trans: matrices (slots 0-7 | 8-15) x (columns 0-7 |
// 8-15) give b0, b1 of column tile 2d, then of tile 2d + 1
template <int NT>
__device__ __forceinline__ void pv_chunk(float (&acc)[NT][4],
                                         const uint32_t (&ph)[4],
                                         const uint32_t (&pl)[4],
                                         const __nv_bfloat16* vrow) {
#pragma unroll
  for (int d = 0; d < NT / 2; ++d) {
    uint32_t b[4];
    ldsm_x4_trans(b, vrow + 16 * d);
    mma_bf16(acc[2 * d], pl[0], pl[1], pl[2], pl[3], b[0], b[1]);
    mma_bf16(acc[2 * d], ph[0], ph[1], ph[2], ph[3], b[0], b[1]);
    mma_bf16(acc[2 * d + 1], pl[0], pl[1], pl[2], pl[3], b[2], b[3]);
    mma_bf16(acc[2 * d + 1], ph[0], ph[1], ph[2], ph[3], b[2], b[3]);
  }
}

// The warps' states combined in warp order, once every warp is done with
// the block's dynamic shared memory raw (WARPS * 16 * HD floats): rows
// row0 .. row0 + live - 1 of the output, normalised (one split), or their
// partial states in part (split blockIdx.z).
template <int HD, int WARPS>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4],
                                           const float (&m)[2], float (&l)[2],
                                           uint8_t* raw,
                                           float (&sm_m)[WARPS][MMA_ROWS],
                                           float (&sm_l)[WARPS][MMA_ROWS],
                                           float* out, float* part,
                                           size_t row0, int live, int splits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  __syncthreads();                     // every warp is done with raw
  float* sm_acc = reinterpret_cast<float*>(raw);   // [WARPS][16][HD]
  if (t == 0) {
    sm_m[warp][g] = m[0];
    sm_m[warp][g + 8] = m[1];
    sm_l[warp][g] = l[0];
    sm_l[warp][g + 8] = l[1];
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = g + 8 * (c >> 1);
      sm_acc[(warp * MMA_ROWS + row) * HD + 8 * i + 2 * t + (c & 1)] = acc[i][c];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < live * HD; e += 32 * WARPS) {
    const int i = e / HD;
    const int d = e - i * HD;
    float mt = MASKED;
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, sm_m[w][i]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float wt = __expf(sm_m[w][i] - mt);
      lt = fmaf(wt, sm_l[w][i], lt);
      at = fmaf(wt, sm_acc[(w * MMA_ROWS + i) * HD + d], at);
    }
    const size_t row = row0 + i;
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

template <int HD>
struct MmaSmem {  // V double buffers of the warps, then their states
  static constexpr int WARPS = MMA_THREADS / 32;
  static constexpr int VSTRIDE = HD + 8;      // staged V row: no conflicts
  static constexpr int VBYTES = 2 * WARPS * CHUNK * VSTRIDE * 2;
  static constexpr int ABYTES = WARPS * MMA_ROWS * HD * 4;
  static constexpr int BYTES = VBYTES > ABYTES ? VBYTES : ABYTES;
};

// The same function as tree_attention_kernel for bf16 q/k/v. Each warp
// takes 16-slot chunks of the block's share in turn (warp w: chunks w,
// w + 8, ...) and runs its own online softmax over them; the 8 warps'
// states are combined in warp order. Scores: q (16 rows, A) times k (B,
// 8 slots a tile), both read from device memory with one 16-byte load per
// lane and 32 values of hd (the K order within a step is permuted alike
// on both sides); exact bf16 products, fp32 sums. p.V: p in fp32, split
// into two bf16 terms (hi + lo keeps 16 bits), times V staged in shared
// memory by cp.async and read transposed with ldmatrix. The grid, the
// slot split and the partial state are those of tree_attention_kernel,
// with RT = 16.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
tree_attention_mma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   float* __restrict__ part, int S, int Hkv, int N, int G,
                   int chunk, int splits, float scale, int has_cap,
                   float cap) {
  constexpr int WARPS = MmaSmem<HD>::WARPS;
  constexpr int KS = HD / 32;          // 32-value steps of hd for q.k
  constexpr int NT = HD / 8;           // 8-column tiles of the output
  constexpr int VSTRIDE = MmaSmem<HD>::VSTRIDE;
  extern __shared__ __align__(16) uint8_t raw[];
  __shared__ float sm_m[WARPS][MMA_ROWS];
  __shared__ float sm_l[WARPS][MMA_ROWS];

  const int rows = N * G;
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int r0 = blockIdx.y * MMA_ROWS;
  const int s_begin = blockIdx.z * chunk;
  const int s_end = min(S, s_begin + chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // A fragments of q: rows g and g + 8 of the tile; step j of 32 values
  // gives two k16 steps, lane t holding values 32j + 8t .. 32j + 8t + 7
  const int ra = r0 + g, rb = r0 + g + 8;
  const bool live_a = ra < rows, live_b = rb < rows;
  uint32_t qa[KS][2][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint4 xa = make_uint4(0u, 0u, 0u, 0u), xb = xa;
    if (live_a)
      xa = *reinterpret_cast<const uint4*>(q + ((size_t)bh * rows + ra) * HD +
                                           32 * j + 8 * t);
    if (live_b)
      xb = *reinterpret_cast<const uint4*>(q + ((size_t)bh * rows + rb) * HD +
                                           32 * j + 8 * t);
    qa[j][0][0] = xa.x; qa[j][0][1] = xb.x; qa[j][0][2] = xa.y; qa[j][0][3] = xb.y;
    qa[j][1][0] = xa.z; qa[j][1][1] = xb.z; qa[j][1][2] = xa.w; qa[j][1][3] = xb.w;
  }
  const uint8_t* mra = mask + ((size_t)b * N + (live_a ? ra / G : 0)) * S;
  const uint8_t* mrb = mask + ((size_t)b * N + (live_b ? rb / G : 0)) * S;

  float m2[2] = {MASKED, MASKED};      // rows g, g + 8
  float l2[2] = {0.f, 0.f};            // this lane's share of the sums
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  const size_t stride = (size_t)Hkv * HD;
  const __nv_bfloat16* kbase = k + ((size_t)b * S * Hkv + h) * HD;
  const __nv_bfloat16* vbase = v + ((size_t)b * S * Hkv + h) * HD;
  // a chunk's V into a buffer of this warp (zeros past the share), as one
  // cp.async group, and its K rows into registers as the B operand
  auto vbuf = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(raw) +
           ((i & 1) * WARPS + warp) * CHUNK * VSTRIDE;
  };
  auto fetch = [&](int c0, int i, uint4 (&kr)[2][KS]) {
    constexpr int VCH = HD / 8;        // 16-byte pieces of a row
    __nv_bfloat16* buf = vbuf(i);
    for (int e = lane; e < CHUNK * VCH; e += 32) {
      const int rr = e / VCH, cc = e - rr * VCH;
      const int sl = c0 + rr;
      const bool ok = sl < s_end;
      cp_async16(buf + rr * VSTRIDE + cc * 8,
                 ok ? vbase + (size_t)sl * stride + cc * 8 : vbase, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int sl = c0 + 8 * nt + g;
#pragma unroll
      for (int j = 0; j < KS; ++j)
        kr[nt][j] = sl < s_end
                        ? *reinterpret_cast<const uint4*>(
                              kbase + (size_t)sl * stride + 32 * j + 8 * t)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // the next chunk's K and V are in flight while one is computed
  uint4 kr[2][KS], kn[2][KS];
  int c0 = s_begin + warp * CHUNK;
  if (c0 < s_end) fetch(c0, 0, kr);
  for (int it = 0; c0 < s_end; ++it, c0 += WARPS * CHUNK) {
    const int c1 = c0 + WARPS * CHUNK;
    if (c1 < s_end) {
      fetch(c1, it + 1, kn);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);   // keeps the count
    }
    // scores of slots c0 + 8nt + (column)
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        mma_bf16(sc[nt], qa[j][0][0], qa[j][0][1], qa[j][0][2], qa[j][0][3],
                 kr[nt][j].x, kr[nt][j].y);
        mma_bf16(sc[nt], qa[j][1][0], qa[j][1][1], qa[j][1][2], qa[j][1][3],
                 kr[nt][j].z, kr[nt][j].w);
      }
    }
    // C fragment: (row g | g + 8, slot c0 + 8nt + 2t + (c & 1))
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int sl = c0 + 8 * nt + 2 * t + (c & 1);
        float x = sc[nt][c] * scale;
        if (has_cap) x = cap * tanhf(x / cap);
        const bool in = sl < s_end;
        const bool keep =
            in && (c < 2 ? live_a && mra[sl] : live_b && mrb[sl]);
        sc[nt][c] = !in ? -INFINITY : keep ? x : MASKED;
      }
    uint32_t ph[4], pl[4];
    softmax_chunk(sc, m2, l2, acc, ph, pl);
    cp_async_wait<1>();                // chunk c0's V
    __syncwarp();
    const int mat = lane >> 3;
    pv_chunk(acc, ph, pl,
             vbuf(it) + ((lane & 7) + 8 * (mat & 1)) * VSTRIDE + 8 * (mat >> 1));
    __syncwarp();                      // the buffer is refilled next chunk
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < KS; ++j) kr[nt][j] = kn[nt][j];
  }
  cp_async_wait<0>();
  store_rows<HD, WARPS>(acc, m2, l2, raw, sm_m, sm_l, out, part,
                        (size_t)bh * rows + r0, min(rows - r0, MMA_ROWS),
                        splits);
}

// ---- bf16 at head dim 256: K and V staged in shared memory

// The shared memory of tree_attention_mma_ring: the query tile (16 rows,
// zeros past the N*G rows), then each warp's ring of NST stages, a stage
// holding a chunk's 16 K rows and then its 16 V rows; after the slot loop
// the warps' states. A head row of 512 bytes: 4 warps with 2-stage rings,
// 140 KiB, one block an SM (as flash_decode.cu's MmaWarp at hd 256).
template <int HD>
struct RingSmem {
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NST = 2;
  static constexpr int LD = HD + 8;            // staged row: no conflicts
  static constexpr int STAGE = 2 * CHUNK * LD;
  static constexpr int QBYTES = MMA_ROWS * LD * 2;
  static constexpr int BYTES = QBYTES + WARPS * NST * STAGE * 2;
  static_assert(WARPS * MMA_ROWS * HD * 4 <= BYTES, "states overflow");
};

// The same function as tree_attention_mma where a warp's q fragments,
// output and two chunks of K would not fit its registers (hd 256: 320
// registers). Each warp takes 16-slot chunks of the block's share in turn
// (warp w: chunks w, w + 4, ...) and stages their K and V rows in its own
// ring by cp.async, NST - 1 chunks ahead of the one it computes. Scores: q
// (16 rows, A) times K (B), both read from shared memory by ldmatrix,
// exact bf16 products, fp32 sums in two chains; row g and g + 8 of the
// tile each take their node's mask row. p.V as in tree_attention_mma. The
// grid, the slot split and the partial state are those of
// tree_attention_kernel, with RT = 16.
template <int HD>
__global__ void __launch_bounds__(RingSmem<HD>::THREADS)
tree_attention_mma_ring(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        float* __restrict__ out, float* __restrict__ part,
                        int S, int Hkv, int N, int G, int chunk, int splits,
                        float scale, int has_cap, float cap) {
  using SM = RingSmem<HD>;
  constexpr int WARPS = SM::WARPS, THREADS = SM::THREADS, LD = SM::LD;
  constexpr int NT = HD / 8;           // 8-column tiles of the output
  extern __shared__ __align__(16) uint8_t raw[];
  __shared__ float sm_m[WARPS][MMA_ROWS];
  __shared__ float sm_l[WARPS][MMA_ROWS];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(raw);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(raw + SM::QBYTES);

  const int rows = N * G;
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int r0 = blockIdx.y * MMA_ROWS;
  const int live = min(rows - r0, MMA_ROWS);   // rows of this tile
  const int s_begin = blockIdx.z * chunk;
  const int s_end = min(S, s_begin + chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, r8 = lane & 7;

  // this warp's chunks: c0 = first + i * span, i < n
  constexpr int span = WARPS * CHUNK;
  const int first = s_begin + warp * CHUNK;
  const int n = first < s_end ? (s_end - first + span - 1) / span : 0;
  const size_t stride = (size_t)Hkv * HD;
  const __nv_bfloat16* kbase = k + ((size_t)b * S * Hkv + h) * HD;
  const __nv_bfloat16* vbase = v + ((size_t)b * S * Hkv + h) * HD;
  __nv_bfloat16* wring = ring + warp * SM::NST * SM::STAGE;
  // chunk i's K and V rows into stage i % NST, zeros past the share
  auto fetch = [&](int i) {
    constexpr int PIECES = HD / 8;     // 16-byte copies a row
    const int c0 = first + i * span;
    __nv_bfloat16* dst = wring + (i % SM::NST) * SM::STAGE;
    for (int e = lane; e < CHUNK * PIECES; e += 32) {
      const int r = e / PIECES;
      const int c = (e - r * PIECES) * 8;
      const bool ok = c0 + r < s_end;
      const size_t off = ok ? (size_t)(c0 + r) * stride + c : 0;
      cp_async16(dst + r * LD + c, kbase + off, ok);
      cp_async16(dst + (CHUNK + r) * LD + c, vbase + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < SM::NST - 1; ++i) {
    if (i < n) fetch(i);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // the query tile while the first chunks load
  const __nv_bfloat16* qb = q + ((size_t)bh * rows + r0) * HD;
  for (int e = threadIdx.x; e < MMA_ROWS * HD / 8; e += THREADS) {
    const int i = e / (HD / 8);
    const int c = (e - i * (HD / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (i < live) x = *reinterpret_cast<const uint4*>(qb + i * HD + c);
    *reinterpret_cast<uint4*>(qs + i * LD + c) = x;
  }
  __syncthreads();

  // this lane's rows g and g + 8 of the tile, each its node's mask row
  const bool live_a = g < live, live_b = g + 8 < live;
  const uint8_t* mra = mask + ((size_t)b * N + (live_a ? (r0 + g) / G : 0)) * S;
  const uint8_t* mrb =
      mask + ((size_t)b * N + (live_b ? (r0 + g + 8) / G : 0)) * S;
  // the softcap as a product by 1/cap, within an ulp of x / cap: the
  // division took 9% of Gemma's paged verify on an H100 (PERF.md)
  const float inv_cap = 1.f / cap;
  float m2[2] = {MASKED, MASKED};      // rows g, g + 8
  float l2[2] = {0.f, 0.f};            // this lane's share of the sums
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  // q's matrices (rows 0-7 | 8-15) x (hd 0-7 | 8-15) of a k16 step give
  // a0-a3; K's (slots 0-7 | 8-15) x (hd 0-7 | 8-15) give b0, b1 of slot
  // tile 0, then of 1
  const __nv_bfloat16* qrow = qs + (r8 + 8 * (mat & 1)) * LD + 8 * (mat >> 1);
  const int koff = (r8 + 8 * (mat >> 1)) * LD + 8 * (mat & 1);
  const int voff = (CHUNK + r8 + 8 * (mat & 1)) * LD + 8 * (mat >> 1);

  for (int i = 0; i < n; ++i) {
    if (i + SM::NST - 1 < n) fetch(i + SM::NST - 1);
    asm volatile("cp.async.commit_group;\n" ::);   // empty groups count too
    const int c0 = first + i * span;
    // the mask bytes of this lane's slots c0 + 8nt + 2t + c, read while
    // the chunk lands
    bool ka[2][2], kb[2][2], in[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int sl = c0 + 8 * nt + 2 * t + c;
        in[nt][c] = sl < s_end;
        ka[nt][c] = in[nt][c] && live_a && mra[sl] != 0;
        kb[nt][c] = in[nt][c] && live_b && mrb[sl] != 0;
      }
    cp_async_wait<SM::NST - 1>();      // chunk i has landed
    __syncwarp();
    const __nv_bfloat16* st = wring + (i % SM::NST) * SM::STAGE;
    float sc[2][2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[hh][nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, qrow + 16 * kk);
      ldsm_x4(bk, st + koff + 16 * kk);
      mma_bf16(sc[kk & 1][0], a[0], a[1], a[2], a[3], bk[0], bk[1]);
      mma_bf16(sc[kk & 1][1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
    }
    // C fragment: (row g | g + 8, slot c0 + 8nt + 2t + (c & 1))
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = (sc[0][nt][c] + sc[1][nt][c]) * scale;
        if (has_cap) x = cap * tanhf(x * inv_cap);
        const bool keep = c < 2 ? ka[nt][c & 1] : kb[nt][c & 1];
        p[nt][c] = !in[nt][c & 1] ? -INFINITY : keep ? x : MASKED;
      }
    uint32_t ph[4], pl[4];
    softmax_chunk(p, m2, l2, acc, ph, pl);
    pv_chunk(acc, ph, pl, st + voff);
    __syncwarp();                      // its stage is refilled next
  }
  cp_async_wait<0>();
  store_rows<HD, WARPS>(acc, m2, l2, raw, sm_m, sm_l, out, part,
                        (size_t)bh * rows + r0, live, splits);
}

struct Args {
  const void *q, *k, *v, *mask;
  void *out, *part;
  int B, S, Hkv, N, G, chunk, splits, has_cap;
  float cap;
  cudaStream_t stream;
  int* info;   // set: report the instances' resources, launch nothing
};

// The tensor-core kernel at head dim HD, its threads and dynamic shared
// memory: K and V staged in per-warp rings at hd 256, else in registers
template <int HD>
struct MmaInstance {
  static constexpr bool RING = HD > 128;
  static constexpr int THREADS = RING ? RingSmem<HD>::THREADS : MMA_THREADS;
  static constexpr int BYTES = RING ? RingSmem<HD>::BYTES : MmaSmem<HD>::BYTES;
  static auto kernel() {
    if constexpr (RING) return tree_attention_mma_ring<HD>;
    else return tree_attention_mma<HD>;
  }
};

// RT 16 with bf16 at head dims 32-256: a tensor-core kernel
template <typename T, int HD, int RT>
int launch(const Args& a) {
  using MI = MmaInstance<HD>;
  if (a.info) {
    int err;
    if constexpr (RT == MMA_ROWS)
      err = kernel_info(MI::kernel(), MI::THREADS, MI::BYTES, a.info);
    else
      err = kernel_info(tree_attention_kernel<T, HD, RT>, THREADS, 0, a.info);
    if (err != 0 || a.splits == 1) return err;
    return kernel_info(tree_attention_combine, COMBINE_THREADS, 0,
                       a.info + KERNEL_INFO_INTS);
  }
  const int rows = a.N * a.G;
  const dim3 grid(a.B * a.Hkv, (rows + RT - 1) / RT, a.splits);
  const float scale = 1.0f / sqrtf((float)HD);
  if constexpr (RT == MMA_ROWS) {
    const auto kernel = MI::kernel();
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MI::BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, MI::THREADS, MI::BYTES, a.stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const uint8_t*)a.mask, (float*)a.out,
        (float*)a.part, a.S, a.Hkv, a.N, a.G, a.chunk, a.splits, scale,
        a.has_cap, a.cap);
  } else {
    tree_attention_kernel<T, HD, RT><<<grid, THREADS, 0, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask,
        (float*)a.out, (float*)a.part, a.S, a.Hkv, a.N, a.G, a.chunk,
        a.splits, scale, a.has_cap, a.cap);
  }
  if (a.splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tree_attention_combine<<<a.B * a.Hkv * rows, COMBINE_THREADS, 0,
                             a.stream>>>((const float*)a.part, (float*)a.out,
                                         a.splits, HD);
  }
  return (int)cudaGetLastError();
}

// Query rows per block: 16 on the tensor cores (bf16, head dims 32-256),
// else 1, 2, 4 or 8; more rows take several row tiles.
// kernels/tree_attention.py rows_per_block mirrors this choice.
template <typename T, int HD>
int by_rows(const Args& a) {
  const int rows = a.N * a.G;
  if constexpr (sizeof(T) == 2 && HD >= 32) {
    return launch<T, HD, MMA_ROWS>(a);
  } else {
    if (rows == 1) return launch<T, HD, 1>(a);
    if (rows == 2) return launch<T, HD, 2>(a);
    if (rows <= 4) return launch<T, HD, 4>(a);
    return launch<T, HD, 8>(a);
  }
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
// with splits > 1, part holds B*Hkv*N*G*splits*(hd + 2) floats of
// scratch. Returns the CUDA error of the launches (0 on success);
// arguments the kernel does not take return cudaErrorInvalidValue without
// launching.
extern "C" int tree_attention_launch(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, void* part, int B, int S,
                                     int Hkv, int N, int G, int hd, int dtype,
                                     int chunk, int splits, int has_cap,
                                     float cap, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || N < 1 || G < 1 || chunk < 1 ||
      splits != (S + chunk - 1) / chunk || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, out, part, B, S, Hkv, N, G, chunk, splits,
               has_cap, cap, (cudaStream_t)stream};
  if (dtype == 0) return by_head_dim<float>(a, hd);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(a, hd);
  return (int)cudaErrorInvalidValue;
}

// The resources of the instances tree_attention_launch picks for N*G
// query rows at head dim hd and dtype (0 = float32, 1 = bfloat16), into
// info: KERNEL_INFO_INTS ints for the attention kernel, then, with splits
// > 1, as many for the combine kernel (kernel_info.cuh). Launches nothing;
// returns the CUDA error of the query.
extern "C" int tree_attention_query(int N, int G, int hd, int dtype,
                                    int splits, int* info) {
  if (N < 1 || G < 1 || splits < 1 || info == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.N = N;
  a.G = G;
  a.splits = splits;
  a.info = info;
  if (dtype == 0) return by_head_dim<float>(a, hd);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(a, hd);
  return (int)cudaErrorInvalidValue;
}
