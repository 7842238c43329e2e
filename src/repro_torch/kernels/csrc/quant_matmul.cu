// Weight-only quantized matmul for Hopper (sm_90a): x (M, K) @ dequant(q,
// scale) -> fp32 (M, N), with int8 or packed int4 weights widened to bf16
// in registers and multiplied on the tensor cores, so that the
// full-precision weight never exists in memory.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py: quant_matmul
// -> pallas_call(_int8_kernel | _int4_kernel). That kernel walked K as the
// sequential minor axis of its grid and carried an fp32 (Mt, Nt) tile in
// VMEM scratch from one K step to the next. Blocks on this card run in
// parallel with nothing carried between them, so here a block owns a
// (BM rows, BN columns) output tile of one K slice (or, for 64-row tiles,
// of all slices in turn) and loops over K itself.
//
// Layouts (quant/qweight.py), read as stored:
//   int8: q (K, N) int8, scale (1, N) fp32, applied once after the K sum.
//   int4: q (K/2, N) uint8, even K row in the low nibble, odd row in the
//         high one, each sign-extended to [-8, 7]; scale (K/group, N) fp32,
//         applied to each group's partial sum (group a multiple of 16).
// The AWQ pre-scale multiplies x before the launch (kernels/ops.py).
//
// What bounds it on this card. Decode (M 4 to 28): the weight bytes, K*N
// (int8) or K*N/2 plus the group scales (int4); wq 4096 x 4096 int8 is
// 16.8 MB, 5.0 us at 3.35 TB/s, against 0.94 GFLOP at M 28, about 1 us at
// the bf16 tensor-core rate. Prefill (M 512): the operations, 2*M*K*N,
// 17.4 us for wq at 989 TFLOP/s.
//
// What the design does about it:
//   * Exact products on the tensor cores. int8 values and int4 nibbles are
//     integers in [-128, 127], exact in bf16, so the weight widens to bf16
//     without rounding; bf16 x goes to mma.sync.m16n8k16 (bf16 x bf16 ->
//     fp32) as it is, fp32 x is split into three bf16 terms (x = hi + mid +
//     lo holds its 24-bit significand), one MMA each. Every MMA chain is at
//     most one warp's 64-row share of a stage long and starts from zero;
//     its sum is added to an fp32 accumulator (int4: times the group's
//     scale), so the tensor cores' truncating adds never run over all of K.
//   * Operands swapped: the widened weight tile (columns x k) is the
//     16-row A operand and x, transposed, the 8-column B operand, so M 4
//     pads to 8 rather than 16 and M 28 runs one pass over the weights.
//   * A ring of 3 or 4 stages in shared memory filled by cp.async: 256 K
//     rows of the block's weight columns and of its x rows per stage, the
//     next stages' bytes in flight while one is widened and multiplied.
//     The warps are groups of 32 columns times 4 shares of the stage's K
//     rows, 64 each; the shares' sums are added in share order at the end
//     of a slice. Widening: int8, byte permutes and one fp32 add a
//     weight; int4, a byte permute, a mask and a bf16 subtract a pair.
//   * Decode (up to 32 rows, BN 64, two blocks an SM): K is split into
//     slices (kernels/quant_matmul.py plan: 4 at N 4096, 256 blocks), whose
//     partial sums the block that finishes last adds in slice order.
//   * Prefill (64-row tiles; int8 with 16 warps and BN 128): one block
//     walks all slices and adds their sums in the same order itself, so
//     no partial sums leave it.
// A row's result is a function of (K, N, bits, group, x dtype) only: the
// K order, the warp split, the slices and the order of every sum do not
// depend on M or on the row's place in the batch, so a verify pass at
// M 28 repeats an autoregressive pass at M 4 bit for bit. Nothing depends
// on scheduling: the slice counter only picks which block adds.
//
// Any M, K and N: ragged edges are zero-filled in shared memory, and
// where N, K or a pointer is not aligned to 16 bytes the tiles are loaded
// element by element.
//
// Resources (nvcc 12.8 -Xptxas -v for sm_90a, as chip_smoke.py phase 1
// prints them; dynamic shared memory is the ring, from Ring below):
//   bf16 x, int8: BM 8/16/32: 63/105/122 registers, 97/85/110 KiB, two
//     blocks an SM; BM 64 (512 threads): 128 registers with 72/48 bytes
//     spilled, 207 KiB;
//   bf16 x, int4: BM 8/16/32/64: 121/127/127/168 registers, 65/81/86/180
//     KiB, no spills;
//   fp32 x: BM 8/16/32: 77/110/128 registers (int8), 127/127/161 (int4),
//     81-212 KiB, one block an SM, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SHARES = 4;              // warps along K
constexpr int WN = 32;                 // columns per warp
constexpr int BK = 256;                // K rows per stage
constexpr int KW = BK / SHARES;        // K rows per warp and stage: 64
constexpr int STEPS = KW / 16;         // k16 MMA steps per warp and stage
constexpr int XPAD = 8;                // x row padding (elements): no bank
                                       // conflicts on the B fragments
constexpr int MAX_STAGES = 4;

// Block shape: int8 64-row tiles (prefill) take 16 warps and 128 columns,
// so that each staged x row feeds twice the columns; the rest take 8 warps
// and 64 columns (int4's scales would not fit 16 warps' registers). Either
// way the warps are column groups of WN times SHARES shares of K, so a
// row's sums do not change.
template <int BM, int BITS>
struct Shape {
  static constexpr int THREADS = BM == 64 && BITS == 8 ? 512 : 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int BN = WN * WARPS / SHARES;   // output columns
};

template <int BITS, int BN>
struct WTile {    // one stage's weight tile in shared memory
  static constexpr int ROWS = BITS == 8 ? BK : BK / 2;
  // row strides padded so that the A fragment reads hit distinct banks
  static constexpr int STRIDE = BITS == 8 ? BN + 16 : BN + 32;
  static constexpr int BYTES = ROWS * STRIDE;
};

template <typename T, int BM>
struct XTile {    // one stage's x tile in shared memory
  static constexpr int STRIDE = BK + XPAD;          // elements
  static constexpr int BYTES = BM * STRIDE * (int)sizeof(T);
};

// stages of the ring: as many as the budget holds, at most MAX_STAGES.
// bf16 x at up to 32 rows (decode) keeps two blocks on an SM.
template <typename T, int BM, int BITS>
struct Ring {
  static constexpr int BLOCKS_PER_SM = BM <= 32 && sizeof(T) == 2 ? 2 : 1;
  static constexpr int BUDGET = BLOCKS_PER_SM == 2 ? 110 * 1024 : 220 * 1024;
  static constexpr int STAGE =
      WTile<BITS, Shape<BM, BITS>::BN>::BYTES + XTile<T, BM>::BYTES;
  static constexpr int FIT = BUDGET / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  // the shares' sums are added in a (BM, BN) fp32 tile in the ring: after
  // the loop, or between slices in the slot just consumed
  static constexpr int FOLD = BM * Shape<BM, BITS>::BN * 4;
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(FOLD <= STAGE, "a stage's slot holds the fold");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d = a (16x16 bf16, row) * b (16x8 bf16, col) + d, fp32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bytes c of the words u0 and u1 (already XORed with 0x80808080, so a
// byte holds s + 128) as the bf16 pair (s0, s1), exactly: each byte goes
// into the significand of 2^23, 2^23 + 128 comes off in fp32, and the
// integer's upper 16 bits are its bf16 value
__device__ __forceinline__ uint32_t s8pair(uint32_t u0, uint32_t u1, int c) {
  const float f0 =
      __int_as_float(__byte_perm(u0, 0x4B000000u, 0x7650 | c)) - 8388736.f;
  const float f1 =
      __int_as_float(__byte_perm(u1, 0x4B000000u, 0x7650 | c)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// both nibbles of byte c of the packed word u (already XORed with
// 0x88888888, so a nibble holds s + 8) as bf16 (low nibble, high nibble):
// byte c of u and of u >> 4 permuted into the two halves, masked to one
// nibble each under the exponent of 128, then 136 off
__device__ __forceinline__ uint32_t s4pair(uint32_t u, uint32_t u4, int c) {
  const uint32_t b = __byte_perm(u, u4, c | (c << 4) | ((c + 4) << 8) |
                                            ((c + 4) << 12));
  const uint32_t r = (b & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&r),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);  // 128 + s + 8 - 136 = s
}

// x, transposed, as the B fragment of one k16 step: rows k0 + 2t, 2t+1
// (b0) and k0 + 2t + 8, 2t + 9 (b1) of x row xr. bf16 gives one term; fp32
// three (lo, mid, hi), each exact, summed lo first.
template <typename T>
struct BFrag;
template <>
struct BFrag<__nv_bfloat16> {
  static constexpr int TERMS = 1;
  uint32_t b[1][2];
  __device__ __forceinline__ void load(const __nv_bfloat16* xr) {
    b[0][0] = *reinterpret_cast<const uint32_t*>(xr);
    b[0][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
  }
};
template <>
struct BFrag<float> {
  static constexpr int TERMS = 3;
  uint32_t b[3][2];
  __device__ __forceinline__ void split(float2 v, uint32_t& lo, uint32_t& mid,
                                        uint32_t& hi) {
    const float h0 = __bfloat162float(__float2bfloat16_rn(v.x));
    const float h1 = __bfloat162float(__float2bfloat16_rn(v.y));
    const float r0 = v.x - h0, r1 = v.y - h1;
    const float m0 = __bfloat162float(__float2bfloat16_rn(r0));
    const float m1 = __bfloat162float(__float2bfloat16_rn(r1));
    hi = pack_bf16(h0, h1);
    mid = pack_bf16(m0, m1);
    lo = pack_bf16(r0 - m0, r1 - m1);
  }
  __device__ __forceinline__ void load(const float* xr) {
    split(*reinterpret_cast<const float2*>(xr), b[0][0], b[1][0], b[2][0]);
    split(*reinterpret_cast<const float2*>(xr + 8), b[0][1], b[1][1], b[2][1]);
  }
};

// x: (M, K) T; q: int8 (K, N) or uint8 (K/2, N); scale: (1, N) or
// (K/group, N) fp32; out: (M, N) fp32. grid = (ceil(N/BN), ceil(M/BM),
// slices or 1): block (x, y, z) owns columns BN*x.., rows BM*y.. and K
// rows [z*chunk, min(K, (z+1)*chunk)). With slices > 1 its sums go to
// part[(z*M + m)*N + n] and the last block of the tile to finish (counted
// in cnt, which it resets) adds them in slice order. With a grid of one
// slice (BM 64 only) the block walks all slices and adds their sums in
// the same order itself.
template <typename T, int BM, int BITS>
__global__ void __launch_bounds__(Shape<BM, BITS>::THREADS,
                                  (Ring<T, BM, BITS>::BLOCKS_PER_SM))
quant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ cnt, int M,
                    int K, int N, int group, int chunk, int slices,
                    int wvec, int xvec) {
  constexpr int THREADS = Shape<BM, BITS>::THREADS;
  constexpr int BN = Shape<BM, BITS>::BN;
  using W = WTile<BITS, BN>;
  using X = XTile<T, BM>;
  constexpr int NB = BM / 8;                 // B tiles (8 x rows each)
  constexpr int VEC = 16 / (int)sizeof(T);   // x elements per 16 bytes
  constexpr int STAGES = Ring<T, BM, BITS>::STAGES;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int share = warp % SHARES;           // K rows 64*share.. of a stage
  const int wc = (warp / SHARES) * WN;       // the warp's first column
  const int lane = tid & 31;
  const int g = lane >> 2;                   // MMA group: columns 4g..4g+3
  const int t = lane & 3;                    // MMA thread in group
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const bool walk = gridDim.z == 1 && slices > 1;   // all slices here
  const int k_begin = blockIdx.z * chunk;
  const int k_end = walk ? K : min(K, k_begin + chunk);
  const int n_stages = (k_end - k_begin + BK - 1) / BK;
  constexpr int stage_bytes = Ring<T, BM, BITS>::STAGE;

  // ---- one stage of the ring: weights and x of K rows k0 .. k0+BK-1
  auto load_stage = [&](int s) {
    if (s >= n_stages) return;
    uint8_t* ws = smem + (s % STAGES) * stage_bytes;
    T* xs = reinterpret_cast<T*>(ws + W::BYTES);
    const int k0 = k_begin + s * BK;
    const int qrow0 = BITS == 8 ? k0 : k0 / 2;
    const int qrows = BITS == 8 ? K : K / 2;
    constexpr int WCH = BN / 16;                          // chunks per row
    for (int c = tid; c < W::ROWS * WCH; c += THREADS) {
      const int r = c / WCH;
      const int col = n0 + (c % WCH) * 16;
      const int gr = qrow0 + r;
      uint8_t* dst = ws + r * W::STRIDE + (c % WCH) * 16;
      if (wvec) {
        const bool ok = gr < qrows && col < N;
        cp_async16(dst, ok ? q + (size_t)gr * N + col : q, ok);
      } else {
        for (int e = 0; e < 16; ++e)
          dst[e] = (gr < qrows && col + e < N) ? q[(size_t)gr * N + col + e]
                                               : (uint8_t)0;
      }
    }
    constexpr int XCH = BK / VEC;                         // chunks per row
    for (int c = tid; c < BM * XCH; c += THREADS) {
      const int r = c / XCH;
      const int kk = (c - r * XCH) * VEC;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      T* dst = xs + r * X::STRIDE + kk;
      if (xvec) {
        const bool ok = gm < M && gk < k_end;
        cp_async16(dst, ok ? x + (size_t)gm * K + gk : x, ok);
      } else {
        for (int e = 0; e < VEC; ++e)
          dst[e] = (gm < M && gk + e < k_end) ? x[(size_t)gm * K + gk + e]
                                              : T(0.f);
      }
    }
  };

  float acc[2][NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // the shares' sums of the slice just walked, added in share order into
  // fold (BM, BN); C fragment of tile i: (row g, cols 2t, 2t+1) -> column
  // wc + 4g + 2i, rows 8j + 2t, 2t+1; row g + 8 -> column wc + 4g + 2i + 1.
  // Then acc restarts from zero.
  auto fold_shares = [&](float* fold) {
#pragma unroll 1
    for (int w = 0; w < SHARES; ++w) {
      if (share == w) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int m = 8 * j + 2 * t + (c & 1);
              const int col = wc + 4 * g + 2 * i + (c >> 1);
              float& f = fold[m * BN + col];
              f = w == 0 ? acc[i][j][c] : f + acc[i][j][c];
              acc[i][j][c] = 0.f;
            }
      }
      __syncthreads();
    }
  };
  constexpr int OUTS = BM * BN / THREADS;    // outputs per thread
  float total[OUTS];                         // slices added so far (walk)
#pragma unroll
  for (int u = 0; u < OUTS; ++u) total[u] = 0.f;

  // one stage: widen this warp's weights and multiply them with x
  auto compute_stage = [&](int s) {
    const uint8_t* ws = smem + (s % STAGES) * stage_bytes;
    const T* xs = reinterpret_cast<const T*>(ws + W::BYTES);
    const int kw = k_begin + s * BK + share * KW;         // this warp's share
    if (kw >= k_end) return;                              // warp-uniform

    // int4: this thread's scales of columns 4g..4g+3 at each step's group
    float4 sc[STEPS];
    if constexpr (BITS == 4) {
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int kg = kw + st * 16;
        sc[st] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kg < k_end) {
          const int n = n0 + wc + 4 * g;
          const float* sp = scale + (size_t)(kg / group) * N + n;
          if (wvec && n < N) {
            sc[st] = __ldg(reinterpret_cast<const float4*>(sp));
          } else {
            if (n < N) sc[st].x = __ldg(sp);
            if (n + 1 < N) sc[st].y = __ldg(sp + 1);
            if (n + 2 < N) sc[st].z = __ldg(sp + 2);
            if (n + 3 < N) sc[st].w = __ldg(sp + 3);
          }
        }
      }
    }

    // A fragments of the share's steps: tile i, row g <-> column wc + 4g +
    // 2i, row g + 8 <-> column wc + 4g + 2i + 1; K in its natural order
    uint32_t a[STEPS][2][4];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int kr = share * KW + st * 16;                // row in the stage
      if constexpr (BITS == 8) {
        const uint8_t* w0 = ws + (kr + 2 * t) * W::STRIDE + wc + 4 * g;
        const uint32_t x80 = 0x80808080u;
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(w0) ^ x80;
        const uint32_t r1 =
            *reinterpret_cast<const uint32_t*>(w0 + W::STRIDE) ^ x80;
        const uint32_t r8 =
            *reinterpret_cast<const uint32_t*>(w0 + 8 * W::STRIDE) ^ x80;
        const uint32_t r9 =
            *reinterpret_cast<const uint32_t*>(w0 + 9 * W::STRIDE) ^ x80;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[st][i][0] = s8pair(r0, r1, 2 * i);
          a[st][i][1] = s8pair(r0, r1, 2 * i + 1);
          a[st][i][2] = s8pair(r8, r9, 2 * i);
          a[st][i][3] = s8pair(r8, r9, 2 * i + 1);
        }
      } else {
        // packed rows kr/2 + t (K rows 2t, 2t+1) and kr/2 + t + 4 (2t+8, 2t+9)
        const uint8_t* w0 = ws + (kr / 2 + t) * W::STRIDE + wc + 4 * g;
        const uint32_t pa = *reinterpret_cast<const uint32_t*>(w0) ^ 0x88888888u;
        const uint32_t pb =
            *reinterpret_cast<const uint32_t*>(w0 + 4 * W::STRIDE) ^ 0x88888888u;
        const uint32_t pa4 = pa >> 4, pb4 = pb >> 4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[st][i][0] = s4pair(pa, pa4, 2 * i);
          a[st][i][1] = s4pair(pa, pa4, 2 * i + 1);
          a[st][i][2] = s4pair(pb, pb4, 2 * i);
          a[st][i][3] = s4pair(pb, pb4, 2 * i + 1);
        }
      }
    }
    // steps of the share inside K, and where a sum is flushed: at the end
    // of the share or of K, and (int4) of a scale group
    const int steps = min(STEPS, (k_end - kw + 15) / 16);
    unsigned flush_at = 1u << (steps - 1);
    if constexpr (BITS == 4) {
      for (int st = 0; st + 1 < steps; ++st)
        if ((kw + 16 * st + 16) % group == 0) flush_at |= 1u << st;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const T* xr = xs + (8 * j + g) * X::STRIDE + share * KW + 2 * t;
      float p[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        if (st >= steps) break;                           // warp-uniform
        BFrag<T> b;
        b.load(xr + st * 16);
#pragma unroll
        for (int term = 0; term < BFrag<T>::TERMS; ++term) {
          mma(p[0], a[st][0], b.b[term][0], b.b[term][1]);
          mma(p[1], a[st][1], b.b[term][0], b.b[term][1]);
        }
        if (flush_at >> st & 1) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if constexpr (BITS == 4) {
              const float s_lo = i == 0 ? sc[st].x : sc[st].z;
              const float s_hi = i == 0 ? sc[st].y : sc[st].w;
              acc[i][j][0] = fmaf(p[i][0], s_lo, acc[i][j][0]);
              acc[i][j][1] = fmaf(p[i][1], s_lo, acc[i][j][1]);
              acc[i][j][2] = fmaf(p[i][2], s_hi, acc[i][j][2]);
              acc[i][j][3] = fmaf(p[i][3], s_hi, acc[i][j][3]);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[i][j][c] += p[i][c];
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) p[i][c] = 0.f;
          }
        }
      }
    }
    };

  for (int s = 0; s < STAGES - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    // wait for stage s (STAGES - 2 newer groups may stay in flight), then
    // refill the slot every warp finished with in the previous iteration
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // walking all slices: the end of a slice (not the last) folds its sums,
    // in the slot of stage s - 1 before it is refilled
    if (walk && s > 0 && (s * BK) % chunk == 0) {
      float* fold =
          reinterpret_cast<float*>(smem + ((s - 1) % STAGES) * stage_bytes);
      fold_shares(fold);
#pragma unroll
      for (int u = 0; u < OUTS; ++u) total[u] += fold[tid + u * THREADS];
      __syncthreads();
    }
    load_stage(s + STAGES - 1);
    cp_async_commit();
    compute_stage(s);
  }
  cp_async_wait_all();
  __syncthreads();                     // the ring is free: reuse it

  float* fold = reinterpret_cast<float*>(smem);
  fold_shares(fold);
  const bool direct = slices == 1 || walk;
#pragma unroll
  for (int u = 0; u < OUTS; ++u) {
    const int o = tid + u * THREADS;
    const int m = o / BN;
    const int col = o - m * BN;
    const int gm = m0 + m;
    const int gn = n0 + col;
    // walking: the slices in order from zero, as the last block adds them
    const float v = walk ? total[u] + fold[o] : fold[o];
    if (gm >= M || gn >= N) continue;
    if (direct) {
      out[(size_t)gm * N + gn] = BITS == 8 ? v * __ldg(scale + gn) : v;
    } else {
      part[((size_t)blockIdx.z * M + gm) * N + gn] = v;
    }
  }
  if (direct) return;

  // the last block of this tile adds the slices in order
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(cnt + tile, 1) == slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = tid; o < BM * BN; o += THREADS) {
    const int gm = m0 + o / BN;
    const int gn = n0 + o % BN;
    if (gm >= M || gn >= N) continue;
    float v = 0.f;
    for (int z = 0; z < slices; ++z)
      v += __ldcg(part + ((size_t)z * M + gm) * N + gn);
    out[(size_t)gm * N + gn] = BITS == 8 ? v * __ldg(scale + gn) : v;
  }
  if (tid == 0) cnt[tile] = 0;         // ready for the next launch
}

struct Args {
  const void *x, *q, *scale;
  void *out, *part, *cnt;
  int M, K, N, group, chunk, slices, wvec, xvec;
  cudaStream_t stream;
};

template <typename T, int BM, int BITS>
int launch(const Args& a) {
  constexpr int bytes = Ring<T, BM, BITS>::BYTES;
  auto kernel = quant_matmul_kernel<T, BM, BITS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  // 64-row tiles (prefill) walk all slices in one block: no partial sums
  constexpr int BN = Shape<BM, BITS>::BN;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM,
                  BM == 64 ? 1 : a.slices);
  kernel<<<grid, Shape<BM, BITS>::THREADS, bytes, a.stream>>>(
      (const T*)a.x, (const uint8_t*)a.q, (const float*)a.scale,
      (float*)a.out, (float*)a.part, (int*)a.cnt, a.M, a.K, a.N, a.group,
      a.chunk, a.slices, a.wvec, a.xvec);
  return (int)cudaGetLastError();
}

// Rows per block: 8, 16, 32 or 64 (fp32 x: at most 32, its stage is twice
// as large). The rows a block holds do not change any row's arithmetic.
template <typename T, int BITS>
int by_rows(const Args& a) {
  if (a.M <= 8) return launch<T, 8, BITS>(a);
  if (a.M <= 16) return launch<T, 16, BITS>(a);
  if (a.M <= 32 || sizeof(T) == 4) return launch<T, 32, BITS>(a);
  return launch<T, sizeof(T) == 4 ? 32 : 64, BITS>(a);
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16. bits 8 (group ignored) or 4
// (group a multiple of 16 dividing K). chunk K rows per slice (a multiple
// of 256, and for int4 of the group), slices = ceil(K / chunk); with
// slices > 1 and M <= 32 (or x float32), part holds slices*M*N floats of
// scratch and cnt
// ceil(N/64)*ceil(M/8) zeroed ints, left zeroed. Returns the CUDA error of
// the launch (0 on success); arguments the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int quant_matmul_launch(const void* x, const void* q,
                                   const void* scale, void* out, void* part,
                                   void* cnt, int M, int K, int N, int bits,
                                   int group, int dtype, int chunk,
                                   int slices, void* stream) {
  const bool walks = dtype == 1 && M > 32;   // 64-row tiles walk all slices
  if (M < 1 || K < 1 || N < 1 || (M + 7) / 8 > 65535 || chunk < 1 ||
      chunk % BK || slices != (K + chunk - 1) / chunk || slices > 65535 ||
      (slices > 1 && !walks && (part == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && (K % 2 || group < 16 || group % 16 || K % group ||
                    chunk % group))
    return (int)cudaErrorInvalidValue;
  const int wvec = N % 16 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)scale % 16 == 0;
  const int xvec = K % (dtype == 0 ? 4 : 8) == 0 && (uintptr_t)x % 16 == 0;
  const Args a{x, q, scale, out, part, cnt, M, K, N, group, chunk, slices,
               wvec, xvec, (cudaStream_t)stream};
  if (dtype == 0 && bits == 8) return by_rows<float, 8>(a);
  if (dtype == 0 && bits == 4) return by_rows<float, 4>(a);
  if (dtype == 1 && bits == 8) return by_rows<__nv_bfloat16, 8>(a);
  if (dtype == 1 && bits == 4) return by_rows<__nv_bfloat16, 4>(a);
  return (int)cudaErrorInvalidValue;
}
