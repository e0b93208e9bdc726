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
// Design.  Bound on the H100: memory, one read and one write of the field.
// - The map is common.cuh's prefix-table evaluation, the code chain stage 1
//   runs (chain.cu): a block builds its member's running sums and sorted
//   fine edges in shared memory once, then a pixel costs 7 compares against
//   block starts held in registers, a 4-step search and one 8-byte shared
//   load, equal under == to the 15-term sum.  A member whose LUT fails the
//   table check takes the 15-term sum out of line (pst_pwl_sum_eval): the
//   branch is uniform over the block, so every LUT gives K3's values.
// - A block covers PWL_PIX pixels of one member, so that the table build
//   (384 loads, 16 threads summing 15 terms, two barriers) is paid once per
//   16,384 pixels; a separate table launch would add a launch a call and a
//   round trip through device memory for no less work.
// - Pixels stream through common.cuh's pst_stream: 16-byte loads and
//   stores, PST_STREAM_VEC vectors of a thread in flight, a scalar head
//   and tail, a scalar member where the input is off the output's
//   alignment.  Any N.
#include "common.cuh"

#define PWL_PIX 16384  // pixels of a block

// The map of one value from the prefix tables (the LUT passed the check).
struct PwlPrefixMap {
  const float* e8r;  // the block starts: the kernel's array, kept in registers
  const float* sE;
  const float2* sP;
  float q0, zval, ztrg;
  __device__ __forceinline__ float operator()(float v) const {
    return pst_pwl_prefix_eval(v, e8r, sE, sP, q0, zval, ztrg);
  }
};

// The 15-term sum, out of line (the LUT failed the check).
struct PwlSumMap {
  const float* se8;
  const float* sT;
  float q0, zval, ztrg;
  __device__ __forceinline__ float operator()(float v) const {
    return pst_pwl_sum_eval(v, se8, sT, q0, zval, ztrg);
  }
};

__global__ void __launch_bounds__(PST_STREAM_THREADS) pst_pwl_gather_kernel(
    const float* __restrict__ x, const float* __restrict__ e8,
    const float* __restrict__ T, const float* __restrict__ scal,
    float* __restrict__ out, long long N) {
  __shared__ float sT[8 * 48];
  __shared__ float se8[8];
  __shared__ __align__(16) float2 sP[8 * PST_PWL_LS];
  __shared__ float sE[8 * PST_PWL_LS];
  const long long b = blockIdx.y;
  pst_pwl_gather_load(e8 + b * 8, T + b * 8 * 48, se8, sT);
  const float q0 = scal[b * 3], zval = scal[b * 3 + 1], ztrg = scal[b * 3 + 2];
  __syncthreads();
  const bool fast = __syncthreads_and(pst_pwl_prefix_build(sT, sP, sE));
  const float* xb = x + b * N;
  float* ob = out + b * N;
  float e8r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) e8r[k] = se8[k];
  if (fast) {
    PwlPrefixMap map;
    map.e8r = e8r;
    map.sE = sE;
    map.sP = sP;
    map.q0 = q0;
    map.zval = zval;
    map.ztrg = ztrg;
    pst_stream<PST_STREAM_THREADS, PST_STREAM_VEC>(xb, ob, N, PWL_PIX, map);
  } else {
    pst_stream<PST_STREAM_THREADS, PST_STREAM_VEC>(xb, ob, N, PWL_PIX,
                                     PwlSumMap{se8, sT, q0, zval, ztrg});
  }
}

extern "C" int pst_pwl_gather(const void* x, const void* e8, const void* T,
                              const void* scal, void* out, long long batch,
                              long long N, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  const long long nbx = (N + PWL_PIX - 1) / PWL_PIX;
  if (nbx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  for (long long b0 = 0; b0 < batch; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid((unsigned int)nbx, (unsigned int)nb);
    pst_pwl_gather_kernel<<<grid, PST_STREAM_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x + b0 * N, (const float*)e8 + b0 * 8,
        (const float*)T + b0 * 8 * 48, (const float*)scal + b0 * 3,
        (float*)out + b0 * N, N);
  }
  return (int)cudaGetLastError();
}
