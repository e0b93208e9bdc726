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
// round-to-nearest intrinsics so that no FMA changes the rounding.  The
// per-pixel map is common.cuh's pst_pwl_gather_eval, which the fused chain
// (chain.cu) evaluates too.
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
  const long long b = blockIdx.y;
  pst_pwl_gather_load(e8 + b * 8, T + b * 8 * 48, se8, sT);
  const float q0 = scal[b * 3], zval = scal[b * 3 + 1], ztrg = scal[b * 3 + 2];
  __syncthreads();
  const float* xb = x + b * N;
  float* ob = out + b * N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < N;
       p += stride) {
    ob[p] = pst_pwl_gather_eval(xb[p], se8, sT, q0, zval, ztrg);
  }
}

extern "C" int pst_pwl_gather(const void* x, const void* e8, const void* T,
                              const void* scal, void* out, long long batch,
                              long long N, void* stream) {
  for (long long b0 = 0; b0 < batch && N > 0; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid(pst_blocks(N, 4), (unsigned int)nb);
    pst_pwl_gather_kernel<<<grid, PST_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x + b0 * N, (const float*)e8 + b0 * 8,
        (const float*)T + b0 * 8 * 48, (const float*)scal + b0 * 3,
        (float*)out + b0 * N, N);
  }
  return (int)cudaGetLastError();
}
