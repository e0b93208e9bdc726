// K3: 128-knot monotone piecewise-linear quantile map (PWL CDF match apply).
//
// Replaces pysteps_tpu/ops/pallas_histmatch.py::pwl_apply_gather (kernel
// _pwl_gather_kernel).  Per member b, from the table built by
// pack_gather_lut:
//   idx  = #{g in 1..7 : x >= e8[b, g]}              (7 coarse compares)
//   acc0 = T[idx, 45] + sum_j T[idx, 15 + j] * 1[x >= T[idx, j]]   j = 0..14
//   acc1 = T[idx, 46] + sum_j T[idx, 30 + j] * 1[x >= T[idx, j]]
//   out  = (q0 + acc0) + x * acc1, and out = ztrg where x == zval.
// The 15 fine terms are summed in the TPU kernel's order, with
// round-to-nearest intrinsics so that no FMA changes the rounding.
//
// Design: grid (pixel blocks, members); each block copies its member's
// (8, 48) table, 8 block edges and 3 scalars into shared memory once, then
// walks its pixels with a grid-stride loop.  Any N works: there is no row
// tiling, so the TPU kernel's rows % 32 trap does not exist here.
// Bound on the H100: memory (one read and one write of the field); the
// ~60 compares and adds per pixel are far below the f32 rate.  Left on the
// table: the per-thread table row is read from shared memory with a
// data-dependent row index, so lanes with different blocks conflict on banks;
// 128-bit vector loads of x and out would cut the instruction count.
#include "common.cuh"

__global__ void pst_pwl_gather_kernel(const float* __restrict__ x,
                                      const float* __restrict__ e8,
                                      const float* __restrict__ T,
                                      const float* __restrict__ scal,
                                      float* __restrict__ out, long long N) {
  __shared__ float sT[8 * 48];
  __shared__ float se8[8];
  __shared__ float ssc[3];
  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < 8 * 48; k += blockDim.x)
    sT[k] = T[(long long)b * 8 * 48 + k];
  if (threadIdx.x < 8) se8[threadIdx.x] = e8[b * 8 + threadIdx.x];
  if (threadIdx.x < 3) ssc[threadIdx.x] = scal[b * 3 + threadIdx.x];
  __syncthreads();
  const float q0 = ssc[0], zval = ssc[1], ztrg = ssc[2];
  const float* xb = x + (long long)b * N;
  float* ob = out + (long long)b * N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < N;
       p += stride) {
    const float v = xb[p];
    int idx = 0;
#pragma unroll
    for (int g = 1; g < 8; ++g) idx += v >= se8[g] ? 1 : 0;
    const float* row = sT + idx * 48;
    float acc0 = row[45];
    float acc1 = row[46];
#pragma unroll
    for (int j = 0; j < 15; ++j) {
      const float sf = v >= row[j] ? 1.0f : 0.0f;
      acc0 = __fadd_rn(acc0, __fmul_rn(row[15 + j], sf));
      acc1 = __fadd_rn(acc1, __fmul_rn(row[30 + j], sf));
    }
    const float o = __fadd_rn(__fadd_rn(q0, acc0), __fmul_rn(v, acc1));
    ob[p] = v == zval ? ztrg : o;
  }
}

extern "C" int pst_pwl_gather(const void* x, const void* e8, const void* T,
                              const void* scal, void* out, long long batch,
                              long long N, void* stream) {
  if (batch > 0 && N > 0) {
    dim3 grid(pst_blocks(N, 4), (unsigned int)batch);
    pst_pwl_gather_kernel<<<grid, PST_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)e8, (const float*)T,
        (const float*)scal, (float*)out, N);
  }
  return (int)cudaGetLastError();
}
