// Weight-only quantized matmul for Hopper (sm_90a): x (M, K) @ dequant(q,
// scale) -> fp32 (M, N), with int8 or packed int4 weights that are widened
// in registers, so that the full-precision weight never exists in memory.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py: quant_matmul
// -> pallas_call(_int8_kernel | _int4_kernel). That kernel walked K as the
// sequential minor axis of its grid and carried an fp32 (Mt, Nt) tile in
// VMEM scratch from one K step to the next. Blocks on this card run in
// parallel with nothing carried between them, so here one block owns a
// (BM rows, 32 columns) output tile and loops over K itself; its 256
// threads split that K range 32 ways and keep their partial sums in fp32
// registers, and the 32 partial sums of each output are added in a fixed
// order at the end (shuffles, then shared memory), so results repeat
// exactly from run to run.
//
// Layouts (quant/qweight.py):
//   int8: q (K, N) int8, scale (1, N) fp32. The scale is constant along K,
//         so the block sums x * q over all of K and applies it once.
//   int4: q (K/2, N) uint8, even K row in the low nibble, odd row in the
//         high one, each sign-extended to [-8, 7]; scale (K/group, N) fp32,
//         applied to each weight before its product, as the TPU kernel does.
// The AWQ pre-scale multiplies x before the launch (kernels/ops.py).
//
// What bounds it on this card: at decode shapes (M up to a few dozen) the
// weight bytes, K*N (int8) or K*N/2 plus the group scales (int4), against
// 2*M*K*N operations: at M 28 a 4096 x 4096 int8 weight is 16.8 MB, 5.0 us
// at 3.35 TB/s, and 0.94 GFLOP, about 1 us at the bf16 tensor-core rate.
// At prefill (M 512) the operations bound it instead. The design streams
// each weight byte from device memory once per M tile: threads lie along N,
// which is contiguous in q, 8 threads on 32 adjacent columns, so that a
// warp's load covers whole 32-byte sectors of 4 K rows; each thread owns 4
// adjacent columns and 4 adjacent K rows per step (one 4-byte word per row
// for int8, per row pair for int4) and issues all 4 steps of a 512-row K
// chunk before it computes, to keep loads in flight. The x rows of the
// chunk are staged once per block in shared memory as fp32 and read back
// as float4, four K rows at a time, so each shared-memory read feeds 16
// FMAs. Products run on the fp32 CUDA cores: wgmma, int8 tensor cores and
// TMA are later work. Any M, K and N: ragged edges are masked, and where N
// or a row start is not aligned the weights and scales are read byte by
// byte (x: element by element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 8;              // threads along N
constexpr int COLS = 4;            // adjacent columns per thread
constexpr int BN = TN * COLS;      // 32 output columns per block
constexpr int TK = 32;             // threads along K
constexpr int ROWS = 4;            // adjacent K rows per thread and step
constexpr int THREADS = TN * TK;   // 256
constexpr int WARPS = THREADS / 32;
constexpr int STEP = TK * ROWS;    // 128 K rows per block step
constexpr int STEPS = 4;
constexpr int KC = STEP * STEPS;   // 512 K rows of x staged per chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Bytes n0..n0+3 of the row starting at p + off as one word (byte c =
// column n0 + c); columns at or past N read as 0. The caller ensures
// n0 < N.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ p,
                                              size_t off, int n0, int N,
                                              bool vec) {
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p + off + n0));
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < COLS; ++c)
    if (n0 + c < N) w |= (uint32_t)__ldg(p + off + n0 + c) << (8 * c);
  return w;
}

__device__ __forceinline__ float4 load_scale4(const float* __restrict__ s,
                                              size_t off, int n0, int N,
                                              bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(s + off + n0));
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n0 < N) r.x = __ldg(s + off + n0);
  if (n0 + 1 < N) r.y = __ldg(s + off + n0 + 1);
  if (n0 + 2 < N) r.z = __ldg(s + off + n0 + 2);
  if (n0 + 3 < N) r.w = __ldg(s + off + n0 + 3);
  return r;
}

// x: (M, K) T; q: int8 (K, N) or uint8 (K/2, N); scale: (1, N) or
// (K/group, N) fp32; out: (M, N) fp32. grid = (ceil(N/BN), ceil(M/BM)).
template <typename T, int BM, int BITS>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int M, int K, int N, int group, int wvec, int xvec) {
  constexpr int WORDS = BITS == 8 ? ROWS : ROWS / 2;   // q rows per step
  constexpr int SCALES = BITS == 8 ? 1 : ROWS / 2;
  constexpr int VEC = 16 / sizeof(T);                  // x elements per 16 B
  __shared__ __align__(16) float xs[BM * KC];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tn = lane % TN;
  const int tk = warp * (32 / TN) + lane / TN;          // 0 .. TK-1
  const int n0 = blockIdx.x * BN + tn * COLS;
  const int m0 = blockIdx.y * BM;
  const bool has_cols = n0 < N;

  float acc[BM][COLS];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();                 // the previous chunk of xs is consumed

    // this chunk's weights (and int4 scales), all steps issued up front
    uint32_t wr[STEPS][WORDS];
    float4 sc[STEPS][SCALES];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int k = k0 + j * STEP + tk * ROWS;
#pragma unroll
      for (int r = 0; r < WORDS; ++r) {
        wr[j][r] = 0u;
        if constexpr (BITS == 8) {
          if (has_cols && k + r < K)
            wr[j][r] = load_word(q, (size_t)(k + r) * N, n0, N, wvec);
        } else {
          // packed row (k + 2r) / 2 holds K rows k + 2r and k + 2r + 1,
          // which share a scale group since group is even
          sc[j][r] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (has_cols && k + 2 * r < K) {
            wr[j][r] = load_word(q, (size_t)((k >> 1) + r) * N, n0, N, wvec);
            sc[j][r] = load_scale4(scale, (size_t)((k + 2 * r) / group) * N,
                                   n0, N, wvec);
          }
        }
      }
    }

    // stage x[m0 : m0+BM, k0 : k0+KC] as fp32, zeros past M and K
    if (xvec) {
      for (int u = tid; u < BM * KC / VEC; u += THREADS) {
        const int e = u * VEC;
        const int m = e / KC;
        const int kk = e - m * KC;
        const int gm = m0 + m;
        const int gk = k0 + kk;
        float* dst = xs + m * KC + kk;
        if (gm < M && gk < K) {      // K % VEC == 0: the whole vector is in
          const uint4 raw =
              __ldg(reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk));
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < VEC; ++i) dst[i] = to_float(v[i]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) dst[i] = 0.f;
        }
      }
    } else {
      for (int e = tid; e < BM * KC; e += THREADS) {
        const int m = e / KC;
        const int kk = e - m * KC;
        const int gm = m0 + m;
        const int gk = k0 + kk;
        xs[e] = (gm < M && gk < K) ? to_float(x[(size_t)gm * K + gk]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      if (k0 + j * STEP >= K) break;   // block-uniform: the rest is past K
      float w[ROWS][COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        if constexpr (BITS == 8) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            w[r][c] = (float)((int)(wr[j][r] << (24 - 8 * c)) >> 24);
        } else {
#pragma unroll
          for (int r = 0; r < WORDS; ++r) {
            const float s = comp(sc[j][r], c);
            w[2 * r][c] = (float)((int)(wr[j][r] << (28 - 8 * c)) >> 28) * s;
            w[2 * r + 1][c] =
                (float)((int)(wr[j][r] << (24 - 8 * c)) >> 28) * s;
          }
        }
      }
      const int kk = j * STEP + tk * ROWS;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + m * KC + kk);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          float a = acc[m][c];
          a = fmaf(xv.x, w[0][c], a);
          a = fmaf(xv.y, w[1][c], a);
          a = fmaf(xv.z, w[2][c], a);
          a = fmaf(xv.w, w[3][c], a);
          acc[m][c] = a;
        }
      }
    }
  }

  // add the TK partial sums of each output in a fixed order: the 4 lanes
  // of a warp that share tn by shuffles, then the 8 warps through xs
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __syncthreads();                   // xs is free: WARPS*BM*BN <= BM*KC
  float* red = xs;
  if (lane < TN) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        red[(warp * BM + m) * BN + tn * COLS + c] = acc[m][c];
  }
  __syncthreads();
  for (int o = tid; o < BM * BN; o += THREADS) {
    const int m = o / BN;
    const int col = o - m * BN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * BM + m) * BN + col];
    const int gm = m0 + m;
    const int gn = blockIdx.x * BN + col;
    if (gm < M && gn < N)
      out[(size_t)gm * N + gn] = BITS == 8 ? s * __ldg(scale + gn) : s;
  }
}

template <typename T, int BM, int BITS>
void launch(const void* x, const void* q, const void* scale, void* out, int M,
            int K, int N, int group, int wvec, int xvec, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_kernel<T, BM, BITS><<<grid, THREADS, 0, st>>>(
      (const T*)x, (const uint8_t*)q, (const float*)scale, (float*)out, M, K,
      N, group, wvec, xvec);
}

template <typename T, int BITS>
void launch_rows(const void* x, const void* q, const void* scale, void* out,
                 int M, int K, int N, int group, int wvec, int xvec,
                 cudaStream_t st) {
  if (M <= 4) {
    launch<T, 4, BITS>(x, q, scale, out, M, K, N, group, wvec, xvec, st);
  } else if (M <= 8) {
    launch<T, 8, BITS>(x, q, scale, out, M, K, N, group, wvec, xvec, st);
  } else {
    launch<T, 16, BITS>(x, q, scale, out, M, K, N, group, wvec, xvec, st);
  }
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16. bits 8 (group ignored) or 4 (K
// even, group even and dividing K). Returns the CUDA error of the launch
// (0 on success); arguments the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int quant_matmul_launch(const void* x, const void* q,
                                   const void* scale, void* out, int M, int K,
                                   int N, int bits, int group, int dtype,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || K < 1 || N < 1 || (M + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && (K % 2 || group < 2 || group % 2 || K % group))
    return (int)cudaErrorInvalidValue;
  const int wvec = N % 4 == 0 && (uintptr_t)q % 4 == 0 &&
                   (uintptr_t)scale % 16 == 0;
  const int xvec = K % (dtype == 0 ? 4 : 8) == 0 && (uintptr_t)x % 16 == 0;
  if (dtype == 0 && bits == 8) {
    launch_rows<float, 8>(x, q, scale, out, M, K, N, group, wvec, xvec, st);
  } else if (dtype == 0 && bits == 4) {
    launch_rows<float, 4>(x, q, scale, out, M, K, N, group, wvec, xvec, st);
  } else if (dtype == 1 && bits == 8) {
    launch_rows<__nv_bfloat16, 8>(x, q, scale, out, M, K, N, group, wvec,
                                  xvec, st);
  } else if (dtype == 1 && bits == 4) {
    launch_rows<__nv_bfloat16, 4>(x, q, scale, out, M, K, N, group, wvec,
                                  xvec, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
