// Flash decode for Hopper (sm_90a): attention of one decode position per
// query head over a KV cache, in one launch. Every query head of a KV head
// is served by one block, or by one thread-block cluster of blocks that
// split the slots, so each K/V byte is read from device memory once.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py: flash_decode
// -> pallas_call(_decode_kernel). That kernel walked 128-slot KV tiles as
// the sequential minor axis of a (B, Hkv, tiles) grid and carried the
// online softmax state (m, l, acc) in VMEM scratch from one tile to the
// next. Blocks on this card run in parallel with nothing carried between
// them, so here the slots of a (batch, kv head) are split across the
// blocks of a cluster and the blocks' states are combined through
// distributed shared memory, in a fixed order, inside the same launch.
//
// What bounds it on this card: reading K and V, 2*B*S*Hkv*hd values (8.4
// MB, 2.5 us at 3.35 TB/s, for Yi-9B's decode: B 4, Hkv 4, G 8, hd 128, S
// 1024, bf16). The arithmetic, 4*hd flops per (query row, slot), is far
// below the card's rate, but on the CUDA cores a row's dot product is a
// chain of FMAs, shuffles and an exponential per slot, so G rows cost G
// chains. The design:
//   * one row tile: a block holds every query row of its (batch, kv head)
//     up to ROW_TILE = 16 (every config of the registry; only G > 16 takes
//     further row tiles, each reading K/V again);
//   * one launch: the wrapper's plan (kernels/flash_decode.py) splits the
//     slots of a (batch, kv head) over at most MAX_SPLITS = 8 blocks, a
//     portable cluster, so that the grid holds about one block per SM;
//     each block combines its warps' states in shared memory, then the
//     blocks of the cluster read each other's states through distributed
//     shared memory, all loads issued together, combine them in rank order
//     and each writes a share of the output. Longer caches give each block
//     a longer chunk, never more splits, so no partial state goes to
//     device memory and nothing needs a workspace or a memset;
//   * deep loads: each of a block's 8 warps (4 where a head row is 512
//     bytes or more) takes 16-slot chunks of the block's share in turn
//     (warp w: chunks w, w + 8, ...) and stages their K and V rows in its
//     own ring of NST (2 or 4) stages in shared memory with cp.async, NST
//     - 1 chunks ahead of the one it computes and all NST while it waits:
//     128 KB in flight per block at hd 128 in bf16;
//   * bf16 at head dims 32-256 runs on the tensor cores (MmaWarp): the 16
//     rows (G padded with zero queries) times a chunk's K as
//     mma.sync.m16n8k16 (bf16 products exact, fp32 sums), then p.V with p
//     split into two bf16 terms (hi + lo keeps 16 bits of p; rounding p
//     to bf16 alone is off by about 1e-3 of scale); q, K and V are read
//     from shared memory by ldmatrix. At G 1, where 15 of the 16 rows are
//     padding, the CUDA cores measured within 3% of this on an H100, and
//     2-3.5x slower at G 8 (PERF.md), so bf16 has this one route;
//   * fp32 inputs and head dim 16 stay on the CUDA cores (SimtWarp):
//     LANES adjacent lanes hold a slot's row in 16-byte pieces, the warp
//     takes 32 / LANES slots at a time and all GT (1, 2, 4, 8 or 16) rows
//     of the tile; the query rows are read from shared memory in fp32.
// Both routes keep each warp's online softmax in registers; the warps'
// and the blocks' states are combined in warp and rank order, so the
// result is the same bit for bit from run to run.
//
// Semantics follow the plain version (kernels/ref.py ref_flash_decode):
// fp32 scores scaled by 1/sqrt(hd), optional tanh softcap, masked slots set
// to the finite sentinel -1e30 (a fully masked row averages V over all S
// slots, as the reference does), the final division guarded by
// max(l, 1e-30), fp32 output. Any S >= 1: slots past S take no part.
//
// Resources (nvcc 12.8 -Xptxas -v for sm_90a, as chip_smoke.py phase 1
// prints them): the tensor-core instances at hd 32/64/128/256 take
// 72/93/154/234 registers and 81/146/140/140 KiB of dynamic shared memory
// (one block an SM from hd 64 up), no spills; the 30 CUDA-core instances
// (fp32 at every head dim, bf16 at 16) 64-255 registers, fp32 at hd 256
// with 16 rows spilling 12/40 bytes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "kernel_info.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int ROW_TILE = 16;    // query rows a block holds at most
constexpr int MAX_SPLITS = 8;   // blocks of a cluster: the portable limit
constexpr float MASKED = -1e30f;
enum Route { SIMT = 0, MMA = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---- PTX: tensor-core products, shared-memory matrix loads, async copies

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

// four 8x8 bf16 matrices, lanes 8i..8i+7 giving the row addresses of
// matrix i; register i of lane l holds row l/4, columns 2(l%4) and +1
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same, each matrix transposed: register i of lane l holds rows
// 2(l%4) and +1 of column l/4
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes from device to shared memory, zeros where !valid; the L2 fetches
// whole 128-byte lines (1% faster on an H100 at every timed shape)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- end of PTX

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float score(float dot, float scale, int has_cap,
                                       float cap, bool in, bool keep) {
  float x = dot * scale;
  if (has_cap) x = cap * tanhf(x / cap);
  return !in ? -INFINITY : keep ? x : MASKED;   // past the share: no weight
}

// The warps of a block and its shared memory: the query tile, then the
// warps' rings. After the slot loop the rings hold the warps' states and
// the block's. 8 warps with 2-stage rings beat 4 with 3 stages at every
// hd-128 bf16 shape on an H100 (PERF.md); rows of 512 bytes or more keep 4
// warps, so that the rings fit.
template <typename T, int HD, int ROUTE, int GT>
struct Smem {
  static constexpr int ROWB = HD * (int)sizeof(T);   // a slot's row, bytes
  static constexpr int WARPS = ROWB >= 512 ? 4 : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int CS = ROWB >= 1024 ? 8 : 16;   // slots per chunk
  static constexpr int NST = ROWB <= 128 ? 4 : 2;
  static constexpr int LD = HD + 16 / (int)sizeof(T);  // staged row, in T
  static constexpr int STAGE = 2 * CS * LD;            // K, then V, in T
  static constexpr int RING = WARPS * NST * STAGE * (int)sizeof(T);
  static constexpr int QLD = HD + 8;                   // MMA: bf16 q rows
  static constexpr int QBYTES = ROUTE == MMA ? ROW_TILE * QLD * 2 : GT * HD * 4;
  static constexpr int WSTATE = WARPS * GT * (HD + 2) * 4;
  static constexpr int BSTATE = GT * (HD + 2) * 4;
  static constexpr int BYTES = QBYTES + RING;
  static_assert(WSTATE + BSTATE <= RING, "states overflow the rings");
  static_assert(QBYTES % 16 == 0 && (LD * (int)sizeof(T)) % 16 == 0, "align");
};

// ---- CUDA cores: fp32, and bf16 at head dim 16

template <typename T, int HD, int GT>
struct SimtWarp {
  using SM = Smem<T, HD, SIMT, GT>;
  static constexpr int VE = 16 / (int)sizeof(T);             // values a load
  static constexpr int E = HD / 32 > VE ? HD / 32 : VE;      // values a lane
  static constexpr int NV = E / VE;                          // loads a row
  static constexpr int LANES = HD / E;                       // lanes a slot
  static constexpr int SG = 32 / LANES;                      // slots at once
  static constexpr int SPG = SM::CS / SG;                    // steps a chunk
  static constexpr int U0 = GT * E <= 16 ? 4 : GT * E <= 64 ? 2 : 1;
  static constexpr int U = U0 < SPG ? U0 : SPG;              // slots a step
  static_assert(SPG % U == 0, "chunk steps");

  float acc[GT][E], m[GT], l[GT];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < GT; ++i) {
      m[i] = MASKED;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
    }
  }

  // q: fp32 (GT, HD); st: the chunk's K rows then V rows (stride LD);
  // slots c0 .. c0 + CS - 1, those from s_end on past the share
  __device__ void consume(const float* qs, const T* st, int c0, int s_end,
                          const uint8_t* mrow, float scale, int has_cap,
                          float cap, int lane) {
    const int grp = lane / LANES;
    const int e0 = (lane % LANES) * E;
    for (int j = 0; j < SPG; j += U) {
      uint4 kr[U][NV], vr[U][NV];
      bool in[U], keep[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = (j + u) * SG + grp;
        in[u] = c0 + r < s_end;
        keep[u] = in[u] && mrow[c0 + r] != 0;
        const uint4* k4 = reinterpret_cast<const uint4*>(st + r * SM::LD + e0);
        const uint4* v4 =
            reinterpret_cast<const uint4*>(st + (SM::CS + r) * SM::LD + e0);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          kr[u][c] = k4[c];
          vr[u][c] = v4[c];
        }
      }
      // scores: each lane's partial q.k, summed over the slot's lanes
      float sc[GT][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T* kt = reinterpret_cast<const T*>(kr[u]);
#pragma unroll
        for (int i = 0; i < GT; ++i) {
          const float4* q4 = reinterpret_cast<const float4*>(qs + i * HD + e0);
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < E / 4; ++c) {
            const float4 qv = q4[c];
            dot = fmaf(qv.x, to_float(kt[4 * c]), dot);
            dot = fmaf(qv.y, to_float(kt[4 * c + 1]), dot);
            dot = fmaf(qv.z, to_float(kt[4 * c + 2]), dot);
            dot = fmaf(qv.w, to_float(kt[4 * c + 3]), dot);
          }
#pragma unroll
          for (int o = LANES / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          sc[i][u] = score(dot, scale, has_cap, cap, in[u], keep[u]);
        }
      }
      // online softmax over the step's slots
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        float tmax = sc[i][0];
#pragma unroll
        for (int u = 1; u < U; ++u) tmax = fmaxf(tmax, sc[i][u]);
        const float m_new = fmaxf(m[i], tmax);
        const float alpha = __expf(m[i] - m_new);
        float p[U], psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = __expf(sc[i][u] - m_new);
          psum += p[u];
        }
        l[i] = l[i] * alpha + psum;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const T* vt = reinterpret_cast<const T*>(vr[u]);
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[i][e] = fmaf(p[u], to_float(vt[e]), acc[i][e]);
        }
        m[i] = m_new;
      }
    }
  }

  // the slot groups' states combined across the warp, then written by
  // group 0: acc (GT, HD), m (GT), l (GT)
  __device__ void store(float* wacc, float* wm, float* wl, int lane) {
#pragma unroll
    for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
        const float mn = fmaxf(m[i], mo);
        const float a = __expf(m[i] - mn), b = __expf(mo - mn);
        l[i] = l[i] * a + lo * b;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[i][e], o);
          acc[i][e] = acc[i][e] * a + ao * b;
        }
        m[i] = mn;
      }
    }
    if (lane < LANES) {
#pragma unroll
      for (int i = 0; i < GT; ++i) {
#pragma unroll
        for (int e = 0; e < E; ++e) wacc[i * HD + lane * E + e] = acc[i][e];
        if (lane == 0) {
          wm[i] = m[i];
          wl[i] = l[i];
        }
      }
    }
  }
};

// ---- tensor cores: bf16 at head dims 32 to 256

template <int HD>
struct MmaWarp {
  using SM = Smem<__nv_bfloat16, HD, MMA, ROW_TILE>;
  static constexpr int NT = HD / 8;   // 8-column tiles of the output

  float acc[NT][4];                   // C fragments: rows g, g + 8
  float m[2], l[2];                   // rows g, g + 8; l: this lane's share

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    m[0] = m[1] = MASKED;
    l[0] = l[1] = 0.f;
  }

  // q: bf16 (16, HD) at stride QLD, rows past G zero; st: the chunk's 16
  // K rows then 16 V rows (stride LD)
  __device__ void consume(const __nv_bfloat16* qs, const __nv_bfloat16* st,
                          int c0, int s_end, const uint8_t* mrow, float scale,
                          int has_cap, float cap, int lane) {
    const int t = lane & 3;
    const int mat = lane >> 3, r8 = lane & 7;
    // this lane's four slots: c0 + 8nt + 2t + c
    bool in[2][2], keep[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int sl = c0 + 8 * nt + 2 * t + c;
        in[nt][c] = sl < s_end;
        keep[nt][c] = in[nt][c] && mrow[sl] != 0;
      }
    // scores: q (A: rows x hd) times K (B: hd x slots), 16 of hd a step,
    // even and odd steps in two chains; K's matrices (slots 0-7 | 8-15) x
    // (hd 0-7 | 8-15) of the step give b0, b1 of slot tile 0, then of 1
    const __nv_bfloat16* vs = st + SM::CS * SM::LD;
    float sc[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[h][nt][c] = 0.f;
    const __nv_bfloat16* qrow = qs + (r8 + 8 * (mat & 1)) * SM::QLD + 8 * (mat >> 1);
    const __nv_bfloat16* krow = st + (r8 + 8 * (mat >> 1)) * SM::LD + 8 * (mat & 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, qrow + 16 * kk);
      ldsm_x4(b, krow + 16 * kk);
      mma_bf16(sc[kk & 1][0], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_bf16(sc[kk & 1][1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[nt][c] = sc[0][nt][c] + sc[1][nt][c];
    // C fragment: (row g | g + 8, slot 8nt + 2t + (c & 1))
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[nt][c] = score(p[nt][c], scale, has_cap, cap, in[nt][c & 1],
                          keep[nt][c & 1]);
    // online softmax of rows g (c 0, 1) and g + 8 (c 2, 3) over the chunk
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
    // p as the A operand of p.V (slots 2t, 2t+1 | 2t+8, 2t+9), in two terms
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p0 = p[i >> 1][2 * (i & 1)];
      const float p1 = p[i >> 1][2 * (i & 1) + 1];
      const float h0 = __bfloat162float(__float2bfloat16_rn(p0));
      const float h1 = __bfloat162float(__float2bfloat16_rn(p1));
      ph[i] = pack_bf16(h0, h1);
      pl[i] = pack_bf16(p0 - h0, p1 - h1);
    }
    // V's matrices (slots 0-7 | 8-15) x (columns 0-7 | 8-15), transposed:
    // b0, b1 of column tile 2d, then of tile 2d + 1
    const __nv_bfloat16* vrow = vs + (r8 + 8 * (mat & 1)) * SM::LD + 8 * (mat >> 1);
#pragma unroll
    for (int d = 0; d < HD / 16; ++d) {
      uint32_t b[4];
      ldsm_x4_trans(b, vrow + 16 * d);
      mma_bf16(acc[2 * d], pl[0], pl[1], pl[2], pl[3], b[0], b[1]);
      mma_bf16(acc[2 * d], ph[0], ph[1], ph[2], ph[3], b[0], b[1]);
      mma_bf16(acc[2 * d + 1], pl[0], pl[1], pl[2], pl[3], b[2], b[3]);
      mma_bf16(acc[2 * d + 1], ph[0], ph[1], ph[2], ph[3], b[2], b[3]);
    }
  }

  // acc (16, HD), m (16), l (16) of the warp
  __device__ void store(float* wacc, float* wm, float* wl, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
    if (t == 0) {
      wm[g] = m[0];
      wm[g + 8] = m[1];
      wl[g] = l[0];
      wl[g + 8] = l[1];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wacc[(g + 8 * (c >> 1)) * HD + 8 * i + 2 * t + (c & 1)] = acc[i][c];
  }
};

// q: (B, Hkv, G, HD); k, v: (B, S, Hkv, HD); mask: (B, S) bytes; out: (B,
// Hkv, G, HD) fp32. grid = (splits * B * Hkv, ceil(G / ROW_TILE)), in
// clusters of (splits, 1, 1): block x owns (batch, kv head) x / splits,
// rank z = x % splits of its cluster, slots [z * chunk, (z + 1) * chunk)
// and query rows y * ROW_TILE .. y * ROW_TILE + GT - 1 (GT >= the rows).
template <typename T, int HD, int ROUTE, int GT>
__global__ void __launch_bounds__((Smem<T, HD, ROUTE, GT>::THREADS))
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int S, int Hkv, int G, int chunk,
                    int splits, float scale, int has_cap, float cap) {
  using SM = Smem<T, HD, ROUTE, GT>;
  using Warp = std::conditional_t<ROUTE == MMA, MmaWarp<HD>, SimtWarp<T, HD, GT>>;
  using QT = std::conditional_t<ROUTE == MMA, __nv_bfloat16, float>;
  extern __shared__ __align__(16) uint8_t smem[];
  QT* qs = reinterpret_cast<QT*>(smem);
  T* ring = reinterpret_cast<T*>(smem + SM::QBYTES);

  const int bh = blockIdx.x / splits;
  const int z = blockIdx.x - bh * splits;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int r0 = blockIdx.y * ROW_TILE;
  const int rows = min(G - r0, ROW_TILE);
  const int s_begin = z * chunk;
  const int s_end = min(S, s_begin + chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // this warp's chunks: c0 = s_begin + (i * WARPS + warp) * CS, i < n
  constexpr int WARPS = SM::WARPS, THREADS = SM::THREADS;
  const int span = WARPS * SM::CS;
  const int first = s_begin + warp * SM::CS;
  const int n = first < s_end ? (s_end - first + span - 1) / span : 0;
  const size_t stride = (size_t)Hkv * HD;          // values from slot to slot
  const T* kbase = k + ((size_t)b * S * Hkv + h) * HD;
  const T* vbase = v + ((size_t)b * S * Hkv + h) * HD;
  const uint8_t* mrow = mask + (size_t)b * S;
  T* wring = ring + warp * SM::NST * SM::STAGE;
  // chunk i's K and V rows into stage i % NST, zeros past the share
  auto fetch = [&](int i) {
    constexpr int VT = 16 / (int)sizeof(T);         // values a copy
    constexpr int PIECES = HD / VT;                 // copies a row
    const int c0 = first + i * span;
    T* dst = wring + (i % SM::NST) * SM::STAGE;
    for (int e = lane; e < SM::CS * PIECES; e += 32) {
      const int r = e / PIECES;
      const int c = (e - r * PIECES) * VT;
      const bool ok = c0 + r < s_end;
      const size_t off = ok ? (size_t)(c0 + r) * stride + c : 0;
      cp_async16(dst + r * SM::LD + c, kbase + off, ok);
      cp_async16(dst + (SM::CS + r) * SM::LD + c, vbase + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < SM::NST - 1; ++i) {
    if (i < n) fetch(i);
    cp_async_commit();
  }

  // the query tile, zero rows past G, while the first chunks load
  const T* qb = q + ((size_t)bh * G + r0) * HD;
  if constexpr (ROUTE == MMA) {
    for (int e = threadIdx.x; e < ROW_TILE * HD / 8; e += THREADS) {
      const int i = e / (HD / 8);
      const int c = (e - i * (HD / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (i < rows) x = *reinterpret_cast<const uint4*>(qb + i * HD + c);
      *reinterpret_cast<uint4*>(qs + i * SM::QLD + c) = x;
    }
  } else {
    for (int e = threadIdx.x; e < GT * HD; e += THREADS)
      qs[e] = e < rows * HD ? to_float(qb[e]) : 0.f;
  }
  __syncthreads();

  Warp w;
  w.init();
  for (int i = 0; i < n; ++i) {
    if (i + SM::NST - 1 < n) fetch(i + SM::NST - 1);
    cp_async_commit();                       // empty groups keep the count
    cp_async_wait<SM::NST - 1>();            // chunk i has landed
    __syncwarp();
    w.consume(qs, wring + (i % SM::NST) * SM::STAGE, first + i * span, s_end,
              mrow, scale, has_cap, cap, lane);
    __syncwarp();                            // its stage is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();                           // every warp is done with ring

  // the warps' states, combined in warp order into the block's
  float* wacc = reinterpret_cast<float*>(ring);    // [WARPS][GT][HD]
  float* wm = wacc + WARPS * GT * HD;              // [WARPS][GT]
  float* wl = wm + WARPS * GT;
  float* bacc = wl + WARPS * GT;                   // [GT][HD]
  float* bm = bacc + GT * HD;                      // [GT]
  float* bl = bm + GT;
  w.store(wacc + warp * GT * HD, wm + warp * GT, wl + warp * GT, lane);
  __syncthreads();
  float* orow = out + ((size_t)bh * G + r0) * HD;
  for (int e = threadIdx.x; e < rows * HD; e += THREADS) {
    const int i = e / HD;
    float mt = MASKED;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) mt = fmaxf(mt, wm[j * GT + i]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      const float wt = __expf(wm[j * GT + i] - mt);
      lt = fmaf(wt, wl[j * GT + i], lt);
      at = fmaf(wt, wacc[j * GT * HD + e], at);
    }
    if (splits == 1) {
      orow[e] = at / fmaxf(lt, 1e-30f);
    } else {
      bacc[e] = at;
      if (e - i * HD == 0) {
        bm[i] = mt;
        bl[i] = lt;
      }
    }
  }
  if (splits == 1) return;

  // the blocks' states, read from every rank of the cluster (all loads
  // issued together) and combined in rank order; rank z writes elements
  // z * THREADS + tid, stepping splits * THREADS
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = z * THREADS + threadIdx.x; e < rows * HD; e += splits * THREADS) {
    const int i = e / HD;
    float mz[MAX_SPLITS], lz[MAX_SPLITS], az[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      if (j < splits) {
        mz[j] = *cluster.map_shared_rank(bm + i, j);
        lz[j] = *cluster.map_shared_rank(bl + i, j);
        az[j] = *cluster.map_shared_rank(bacc + e, j);
      }
    }
    float mt = MASKED;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      if (j < splits) mt = fmaxf(mt, mz[j]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      if (j < splits) {
        const float wt = __expf(mz[j] - mt);
        lt = fmaf(wt, lz[j], lt);
        at = fmaf(wt, az[j], at);
      }
    }
    orow[e] = at / fmaxf(lt, 1e-30f);
  }
  cluster.sync();                            // no block leaves while read
}

struct Args {
  const void *q, *k, *v, *mask;
  void* out;
  int B, S, Hkv, G, chunk, splits, has_cap;
  float cap;
  cudaStream_t stream;
  int* clusters;   // set: ask how many clusters of splits blocks fit at once
  int* info;       // set: report the instance's resources, launch nothing
};

// Launches the instance, or with a.clusters set, asks the card how many of
// its clusters of a.splits blocks can be resident at once (the wrapper's
// plan keeps the grid within one such wave). The instance's dynamic shared
// memory limit is raised once per device, not on every call.
template <typename T, int HD, int ROUTE, int GT>
int launch(const Args& a) {
  using SM = Smem<T, HD, ROUTE, GT>;
  auto kernel = flash_decode_kernel<T, HD, ROUTE, GT>;
  if (a.info) return kernel_info(kernel, SM::THREADS, SM::BYTES, a.info);
  static std::atomic<unsigned long long> raised{0};   // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(raised.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits * a.B * a.Hkv, (a.G + ROW_TILE - 1) / ROW_TILE, 1);
  cfg.blockDim = dim3(SM::THREADS, 1, 1);
  cfg.dynamicSmemBytes = SM::BYTES;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 || a.clusters ? 1 : 0;
  if (a.clusters)
    return (int)cudaOccupancyMaxActiveClusters(a.clusters, (void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)a.q, (const T*)a.k,
                           (const T*)a.v, (const uint8_t*)a.mask,
                           (float*)a.out, a.S, a.Hkv, a.G, a.chunk, a.splits,
                           1.0f / sqrtf((float)HD), a.has_cap, a.cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The route and the rows a block holds: bf16 at head dims 32-256 takes the
// tensor cores (MMA) with 16 rows; fp32 and head dim 16 the CUDA cores
// (SIMT) with the next power of two >= min(G, 16). kernels/flash_decode.py
// route and rows_per_block mirror this choice.
template <typename T, int HD>
int by_route(const Args& a) {
  if constexpr (sizeof(T) == 2 && HD >= 32) {
    return launch<T, HD, MMA, ROW_TILE>(a);
  } else {
    const int rows = a.G < ROW_TILE ? a.G : ROW_TILE;
    if (rows == 1) return launch<T, HD, SIMT, 1>(a);
    if (rows == 2) return launch<T, HD, SIMT, 2>(a);
    if (rows <= 4) return launch<T, HD, SIMT, 4>(a);
    if (rows <= 8) return launch<T, HD, SIMT, 8>(a);
    return launch<T, HD, SIMT, 16>(a);
  }
}

template <typename T>
int by_head_dim(const Args& a, int hd) {
  switch (hd) {
    case 16: return by_route<T, 16>(a);
    case 32: return by_route<T, 32>(a);
    case 64: return by_route<T, 64>(a);
    case 128: return by_route<T, 128>(a);
    case 256: return by_route<T, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike). chunk slots per
// block, splits = ceil(S / chunk) <= 8 blocks per (batch, kv head, row
// tile), one cluster. Returns the CUDA error of the launch (0 on
// success); arguments the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* mask, void* out,
                                   int B, int S, int Hkv, int G, int hd,
                                   int dtype, int chunk, int splits,
                                   int has_cap, float cap, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || chunk < 1 || splits < 1 ||
      splits > MAX_SPLITS || splits != (S + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, out, B, S, Hkv, G, chunk, splits, has_cap,
               cap, (cudaStream_t)stream, nullptr};
  if (dtype == 0) return by_head_dim<float>(a, hd);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(a, hd);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `splits` blocks of the instance for (G, hd, dtype)
// the current device holds at once, into *clusters. Returns the CUDA error
// of the query (0 on success).
extern "C" int flash_decode_max_clusters(int G, int hd, int dtype, int splits,
                                         int* clusters) {
  if (G < 1 || splits < 1 || splits > MAX_SPLITS || clusters == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 16 * splits, 1,
               G, 16, splits, 0, 0.f, nullptr, clusters};
  if (dtype == 0) return by_head_dim<float>(a, hd);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(a, hd);
  return (int)cudaErrorInvalidValue;
}

// The resources of the instance flash_decode_launch picks for G query
// rows a KV head at head dim hd and dtype, into info (KERNEL_INFO_INTS
// ints, kernel_info.cuh). Launches nothing; returns the CUDA error of the
// query.
extern "C" int flash_decode_query(int G, int hd, int dtype, int* info) {
  if (G < 1 || info == nullptr) return (int)cudaErrorInvalidValue;
  Args a{};
  a.G = G;
  a.splits = 1;
  a.info = info;
  if (dtype == 0) return by_head_dim<float>(a, hd);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(a, hd);
  return (int)cudaErrorInvalidValue;
}
