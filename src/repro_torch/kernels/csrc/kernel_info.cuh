// The resources of one kernel instance as the CUDA runtime reports them,
// for the query entry of each source (<name>_query), which picks the
// instance with its launcher's own code and launches nothing. Read by
// src/repro_torch/analysis/kernel_lint.py against the card's limits.
//
// KERNEL_INFO_INTS ints a kernel, in this order:
//   0 registers a thread          1 static shared memory, bytes
//   2 dynamic shared memory the launcher asks for, bytes
//   3 local memory a thread, bytes (spills and stack)
//   4 most threads a block the compiled instance allows
//   5 threads a block the launcher uses
//   6 blocks an SM at those threads and dynamic bytes
//   7 the CUDA error of raising the dynamic shared memory limit (0: none)
#pragma once

#include <cuda_runtime.h>

constexpr int KERNEL_INFO_INTS = 8;

template <typename K>
inline int kernel_info(K* kernel, int threads, int dynamic_bytes, int* info) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.sharedSizeBytes;
  info[2] = dynamic_bytes;
  info[3] = (int)fa.localSizeBytes;
  info[4] = fa.maxThreadsPerBlock;
  info[5] = threads;
  info[6] = 0;
  info[7] = 0;
  if (dynamic_bytes > 0) {   // as the launcher does before it launches
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_bytes);
    if (err != cudaSuccess) {
      info[7] = (int)err;
      cudaGetLastError();      // the refusal is the answer, not a fault
      return 0;
    }
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      dynamic_bytes);
  if (err != cudaSuccess) return (int)err;
  info[6] = blocks;
  return 0;
}
