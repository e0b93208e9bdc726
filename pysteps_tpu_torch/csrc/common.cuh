// Shared launch helpers for the hand-written Hopper kernels of
// pysteps_tpu_torch.  Every entry point has a plain C interface (loaded with
// ctypes), launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PST_THREADS 256

// Grid for a grid-stride loop over `total` elements: enough blocks to fill
// the card many times over, capped so huge batches still launch.
static inline unsigned int pst_blocks(long long total, int per_thread = 1) {
  long long b = (total + (long long)PST_THREADS * per_thread - 1) /
                ((long long)PST_THREADS * per_thread);
  if (b < 1) b = 1;
  if (b > 132LL * 64) b = 132LL * 64;
  return (unsigned int)b;
}

__device__ __forceinline__ int pst_clamp(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// lerp written with round-to-nearest intrinsics so nvcc cannot contract it
// into an FMA: the result then equals the plain PyTorch version's
// a * (1 - w) + c * w operation for operation.
__device__ __forceinline__ float pst_lerp(float a, float c, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(c, w));
}
