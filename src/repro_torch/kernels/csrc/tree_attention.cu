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
//   * otherwise (fp32, hd 16 and 256) the CUDA-core kernel: a group of
//     LANES adjacent lanes reads a slot's strided K (or V) row in 16-byte
//     loads, UNROLL slots a step with all loads issued before any
//     arithmetic, and a block holds RT (1, 2, 4 or 8) of the N*G rows in
//     registers, more rows taking more row tiles.
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
// prints them): tree_attention_mma at hd 32/64/128: 80/124/210 registers,
// 20/36/68 KiB of dynamic shared memory, no spills. tree_attention_kernel:
// 71-255 registers and 2-36 KiB of shared memory across its 28 instances
// (RT 8 at hd 16 and 256 takes 255); fp32 at hd 256 with RT 8 spills
// 108/84 bytes, at hd 128 and 64 with RT 1 or 2 8-12 bytes.

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

constexpr int MMA_ROWS = 16;    // query rows per block: the MMA's M
constexpr int CHUNK = 16;       // slots per warp and step: the MMA's K of p.V
constexpr int MMA_THREADS = 256;  // 8 warps: a short chain of chunks each

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
    // online softmax of rows g (c 0, 1) and g + 8 (c 2, 3) over the chunk
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = fmaxf(fmaxf(sc[0][2 * hr], sc[0][2 * hr + 1]),
                       fmaxf(sc[1][2 * hr], sc[1][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[hr], mx);
      const float alpha = __expf(m2[hr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 2 * hr; c < 2 * hr + 2; ++c) {
          sc[nt][c] = __expf(sc[nt][c] - m_new);
          psum += sc[nt][c];
        }
      l2[hr] = l2[hr] * alpha + psum;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        acc[i][2 * hr] *= alpha;
        acc[i][2 * hr + 1] *= alpha;
      }
      m2[hr] = m_new;
    }
    // p as the A operand of p.V (slots 2t, 2t+1 | 2t+8, 2t+9), in two terms
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p0 = sc[i >> 1][2 * (i & 1)];
      const float p1 = sc[i >> 1][2 * (i & 1) + 1];
      const float h0 = __bfloat162float(__float2bfloat16_rn(p0));
      const float h1 = __bfloat162float(__float2bfloat16_rn(p1));
      ph[i] = pack_bf16(h0, h1);
      pl[i] = pack_bf16(p0 - h0, p1 - h1);
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // chunk c0's V
    __syncwarp();
    // B fragments of V, two 8-column tiles at a time: matrices (slots
    // 0-7 | 8-15) x (columns 0-7 | 8-15), transposed by ldmatrix
    const int mat = lane >> 3;
    const __nv_bfloat16* vrow =
        vbuf(it) + ((lane & 7) + 8 * (mat & 1)) * VSTRIDE + 8 * (mat >> 1);
#pragma unroll
    for (int d = 0; d < HD / 16; ++d) {
      uint32_t b0, b1, b2, b3;
      const unsigned addr = (unsigned)__cvta_generic_to_shared(vrow + 16 * d);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
          : "r"(addr));
      mma_bf16(acc[2 * d], pl[0], pl[1], pl[2], pl[3], b0, b1);
      mma_bf16(acc[2 * d], ph[0], ph[1], ph[2], ph[3], b0, b1);
      mma_bf16(acc[2 * d + 1], pl[0], pl[1], pl[2], pl[3], b2, b3);
      mma_bf16(acc[2 * d + 1], ph[0], ph[1], ph[2], ph[3], b2, b3);
    }
    __syncwarp();                      // the buffer is refilled next chunk
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < KS; ++j) kr[nt][j] = kn[nt][j];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the warps' states, combined in warp order
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l2[hr] += __shfl_xor_sync(0xffffffffu, l2[hr], 1);
    l2[hr] += __shfl_xor_sync(0xffffffffu, l2[hr], 2);
  }
  __syncthreads();                     // every warp is done with raw
  float* sm_acc = reinterpret_cast<float*>(raw);   // [WARPS][16][HD]
  if (t == 0) {
    sm_m[warp][g] = m2[0];
    sm_m[warp][g + 8] = m2[1];
    sm_l[warp][g] = l2[0];
    sm_l[warp][g + 8] = l2[1];
  }
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = g + 8 * (c >> 1);
      sm_acc[(warp * MMA_ROWS + row) * HD + 8 * i + 2 * t + (c & 1)] = acc[i][c];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < MMA_ROWS * HD; e += MMA_THREADS) {
    const int i = e / HD;
    const int d = e - i * HD;
    const int r = r0 + i;
    if (r >= rows) continue;
    float mt = MASKED;
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, sm_m[w][i]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float wt = __expf(sm_m[w][i] - mt);
      lt = fmaf(wt, sm_l[w][i], lt);
      at = fmaf(wt, sm_acc[(w * MMA_ROWS + i) * HD + d], at);
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

struct Args {
  const void *q, *k, *v, *mask;
  void *out, *part;
  int B, S, Hkv, N, G, chunk, splits, has_cap;
  float cap;
  cudaStream_t stream;
};

// RT 16 with bf16 at head dims 32-128: the tensor-core kernel
template <typename T, int HD, int RT>
int launch(const Args& a) {
  const int rows = a.N * a.G;
  const dim3 grid(a.B * a.Hkv, (rows + RT - 1) / RT, a.splits);
  const float scale = 1.0f / sqrtf((float)HD);
  if constexpr (RT == MMA_ROWS) {
    constexpr int bytes = MmaSmem<HD>::BYTES;
    const cudaError_t err = cudaFuncSetAttribute(
        tree_attention_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    tree_attention_mma<HD><<<grid, MMA_THREADS, bytes, a.stream>>>(
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

// Query rows per block: 16 on the tensor cores (bf16, head dims 32-128),
// else 1, 2, 4 or 8; more rows take several row tiles.
// kernels/tree_attention.py rows_per_block mirrors this choice.
template <typename T, int HD>
int by_rows(const Args& a) {
  const int rows = a.N * a.G;
  if constexpr (sizeof(T) == 2 && HD >= 32 && HD <= 128) {
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
