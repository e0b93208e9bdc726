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
// - Pixels stream as 16-byte loads and stores, PWL_VEC vectors of a thread
//   in flight, when the member's input and output rows share their
//   alignment modulo 16 bytes; the up to 3 pixels before the first aligned
//   vector and after the last go scalar.  Otherwise (an input view off its
//   alignment against the fresh output) the member goes scalar.  Any N.
#include "common.cuh"

#define PWL_THREADS 256
#define PWL_PIX 16384  // pixels of a block
#define PWL_VEC 4      // 16-byte vectors of a thread in flight

// Map the pixels [p0, p1) of one member, a thread every PWL_THREADS.
template <bool kFast>
__device__ __forceinline__ void pwl_scalar(const float* xb, float* ob,
                                           long long p0, long long p1,
                                           const float* e8r, const float* sE,
                                           const float2* sP, const float* se8,
                                           const float* sT, float q0,
                                           float zval, float ztrg) {
  for (long long p = p0 + threadIdx.x; p < p1; p += PWL_THREADS) {
    const float v = xb[p];
    ob[p] = kFast ? pst_pwl_prefix_eval(v, e8r, sE, sP, q0, zval, ztrg)
                  : pst_pwl_sum_eval(v, se8, sT, q0, zval, ztrg);
  }
}

template <bool kFast>
__device__ __forceinline__ void pwl_block(const float* xb, float* ob,
                                          long long N, const float* e8r,
                                          const float* sE, const float2* sP,
                                          const float* se8, const float* sT,
                                          float q0, float zval, float ztrg) {
  const long long p0 = (long long)blockIdx.x * PWL_PIX;
  const long long p1 = p0 + PWL_PIX < N ? p0 + PWL_PIX : N;
  const uintptr_t xa = (uintptr_t)xb, oa = (uintptr_t)ob;
  if (((xa ^ oa) & 15) != 0) {
    pwl_scalar<kFast>(xb, ob, p0, p1, e8r, sE, sP, se8, sT, q0, zval, ztrg);
    return;
  }
  // the member's aligned vectors [head, head + 4 nv); PWL_PIX is a
  // multiple of 4, so each block's vectors are whole
  long long head = (long long)((16 - (xa & 15)) & 15) / 4;
  if (head > N) head = N;
  const long long nv = (N - head) / 4, tail = head + 4 * nv;
  if (blockIdx.x == 0)
    pwl_scalar<kFast>(xb, ob, 0, head, e8r, sE, sP, se8, sT, q0, zval, ztrg);
  if (blockIdx.x == gridDim.x - 1)
    pwl_scalar<kFast>(xb, ob, tail, N, e8r, sE, sP, se8, sT, q0, zval, ztrg);
  // vectors whose first pixel, counted from head, lies in [p0, p1)
  const long long v0 = p0 / 4;
  const long long v1 = (p1 / 4 < nv) ? p1 / 4 : nv;
  const float4* x4 = (const float4*)(xb + head);
  float4* o4 = (float4*)(ob + head);
  for (long long v = v0 + threadIdx.x; v < v1; v += PWL_VEC * PWL_THREADS) {
    float4 a[PWL_VEC];
#pragma unroll
    for (int k = 0; k < PWL_VEC; ++k) {
      const long long w = v + k * PWL_THREADS;
      if (w < v1) a[k] = __ldg(x4 + w);
    }
#pragma unroll
    for (int k = 0; k < PWL_VEC; ++k) {
      const long long w = v + k * PWL_THREADS;
      if (w < v1) {
        float4 o;
        if (kFast) {
          o.x = pst_pwl_prefix_eval(a[k].x, e8r, sE, sP, q0, zval, ztrg);
          o.y = pst_pwl_prefix_eval(a[k].y, e8r, sE, sP, q0, zval, ztrg);
          o.z = pst_pwl_prefix_eval(a[k].z, e8r, sE, sP, q0, zval, ztrg);
          o.w = pst_pwl_prefix_eval(a[k].w, e8r, sE, sP, q0, zval, ztrg);
        } else {
          o.x = pst_pwl_sum_eval(a[k].x, se8, sT, q0, zval, ztrg);
          o.y = pst_pwl_sum_eval(a[k].y, se8, sT, q0, zval, ztrg);
          o.z = pst_pwl_sum_eval(a[k].z, se8, sT, q0, zval, ztrg);
          o.w = pst_pwl_sum_eval(a[k].w, se8, sT, q0, zval, ztrg);
        }
        o4[w] = o;
      }
    }
  }
}

__global__ void __launch_bounds__(PWL_THREADS) pst_pwl_gather_kernel(
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
  float e8r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) e8r[k] = se8[k];
  const float* xb = x + b * N;
  float* ob = out + b * N;
  if (fast)
    pwl_block<true>(xb, ob, N, e8r, sE, sP, se8, sT, q0, zval, ztrg);
  else
    pwl_block<false>(xb, ob, N, e8r, sE, sP, se8, sT, q0, zval, ztrg);
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
    pst_pwl_gather_kernel<<<grid, PWL_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x + b0 * N, (const float*)e8 + b0 * 8,
        (const float*)T + b0 * 8 * 48, (const float*)scal + b0 * 3,
        (float*)out + b0 * N, N);
  }
  return (int)cudaGetLastError();
}
