// The PWL CDF-match apply in its two other LUT layouts: the hierarchical
// (16 x 8) map and the flat 128-edge map.  Both compute the same monotone
// piecewise-linear quantile map as K3 (pwl.cu).
//
// pst_pwl_hier replaces pysteps_tpu/ops/pallas_histmatch.py::pwl_apply_hier
// (kernel _pwl_hier_kernel).  Per member b, from (e16 (16,), M3 (72, 16))
// of pack_hier_lut, whose three 24-row splits a, b, c are bf16-exact parts
// of one f32 table M = (a + b) + c:
//   g    = #{k in 0..15 : x >= e16[k]}; the selected column is M[:, g - 1],
//          or all zeros when g = 0 (x below the first block start: the TPU
//          kernel's one-hot is empty there, so the map gives q0)
//   s0   = sum_f d0[f] * 1[x >= ef[f]], s1 likewise with d1   (f = 0..6)
//   out  = q0 + ((pb0 + s0) + x * (pb1 + s1)), and ztrg where x == zval,
// with ef = M[0:7], d0 = M[7:14], d1 = M[14:21], pb0 = M[21], pb1 = M[22].
// The TPU kernel selects the column with a one-hot bf16 matmul, exact
// because exactly one column is hit; here the count indexes the column.
//
// pst_pwl_flat replaces pysteps_tpu/ops/pallas_histmatch.py::pwl_apply
// (kernel _pwl_kernel): out = (q0 + sum_j W0[j] * 1[x >= e_j])
//                             + x * sum_j W1[j] * 1[x >= e_j],   j = 0..127,
// W0 = (w0 + w1) + w2 and W1 = (w3 + w4) + w5 from the bf16x3 rows of
// w (8, 128), summed in j order (the TPU kernel sums on its matrix unit).
// The dry override stays with the caller, as in match_cdf_pwl_flat.
//
// Design: grid (pixel blocks, members); each block builds its member's
// table in shared memory once (the triples summed back into f32), then
// walks its pixels with a grid-stride loop.  Both take any N.  The sums use
// round-to-nearest intrinsics in a fixed order, which the plain PyTorch
// versions repeat.
// Bound on the H100: the hierarchical map by memory (one read and one write
// of the field; ~60 operations a pixel).  The flat map by operations: 128
// compares and 128 x 2 adds a pixel, each thread keeping 4 pixels so that
// one 16-byte shared-memory load of (e_j, W0_j, W1_j) serves 4 pixels.
// Left on the table: the hierarchical table row is read with a
// data-dependent index, so lanes in different blocks conflict on banks.
#include "common.cuh"

__global__ void pst_pwl_hier_kernel(const float* __restrict__ x,
                                    const float* __restrict__ e16,
                                    const float* __restrict__ M3,
                                    const float* __restrict__ scal,
                                    float* __restrict__ out, long long N) {
  __shared__ float sS[17 * 24];  // row 0 zeros, row g + 1 block g
  __shared__ float se16[16];
  const long long b = blockIdx.y;
  const float* M = M3 + b * 72 * 16;
  for (int k = threadIdx.x; k < 17 * 24; k += blockDim.x) {
    const int g = k / 24 - 1, c = k - (k / 24) * 24;
    sS[k] = g < 0 ? 0.0f
                  : __fadd_rn(__fadd_rn(M[c * 16 + g], M[(24 + c) * 16 + g]),
                              M[(48 + c) * 16 + g]);
  }
  if (threadIdx.x < 16) se16[threadIdx.x] = e16[b * 16 + threadIdx.x];
  const float q0 = scal[b * 3], zval = scal[b * 3 + 1], ztrg = scal[b * 3 + 2];
  __syncthreads();
  const float* xb = x + b * N;
  float* ob = out + b * N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < N;
       p += stride) {
    const float v = xb[p];
    int g = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) g += v >= se16[k] ? 1 : 0;
    const float* row = sS + g * 24;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int f = 0; f < 7; ++f) {
      const float sf = v >= row[f] ? 1.0f : 0.0f;
      s0 = __fadd_rn(s0, __fmul_rn(row[7 + f], sf));
      s1 = __fadd_rn(s1, __fmul_rn(row[14 + f], sf));
    }
    const float o = __fadd_rn(
        q0, __fadd_rn(__fadd_rn(row[21], s0),
                      __fmul_rn(v, __fadd_rn(row[22], s1))));
    ob[p] = v == zval ? ztrg : o;
  }
}

#define PWL_FLAT_PIX 4  // pixels per thread

__global__ void pst_pwl_flat_kernel(const float* __restrict__ x,
                                    const float* __restrict__ edges,
                                    const float* __restrict__ w,
                                    const float* __restrict__ q0s,
                                    float* __restrict__ out, long long N) {
  __shared__ float4 sTab[128];  // (e_j, W0_j, W1_j, 0)
  const long long b = blockIdx.y;
  const float* wb = w + b * 8 * 128;
  for (int k = threadIdx.x; k < 128; k += blockDim.x) {
    sTab[k] = make_float4(
        edges[b * 128 + k],
        __fadd_rn(__fadd_rn(wb[k], wb[128 + k]), wb[256 + k]),
        __fadd_rn(__fadd_rn(wb[384 + k], wb[512 + k]), wb[640 + k]), 0.0f);
  }
  const float q0 = q0s[b];
  __syncthreads();
  const float* xb = x + b * N;
  float* ob = out + b * N;
  const long long chunk = (long long)PWL_FLAT_PIX * blockDim.x;
  for (long long base = (long long)blockIdx.x * chunk; base < N;
       base += (long long)gridDim.x * chunk) {
    float v[PWL_FLAT_PIX], a0[PWL_FLAT_PIX], a1[PWL_FLAT_PIX];
#pragma unroll
    for (int u = 0; u < PWL_FLAT_PIX; ++u) {
      const long long p = base + threadIdx.x + (long long)u * blockDim.x;
      v[u] = p < N ? xb[p] : 0.0f;
      a0[u] = 0.0f;
      a1[u] = 0.0f;
    }
#pragma unroll 4
    for (int j = 0; j < 128; ++j) {
      const float4 t = sTab[j];
#pragma unroll
      for (int u = 0; u < PWL_FLAT_PIX; ++u) {
        // adding W * 0 leaves the sum as it is, so the select is exact
        if (v[u] >= t.x) {
          a0[u] = __fadd_rn(a0[u], t.y);
          a1[u] = __fadd_rn(a1[u], t.z);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PWL_FLAT_PIX; ++u) {
      const long long p = base + threadIdx.x + (long long)u * blockDim.x;
      if (p < N) ob[p] = __fadd_rn(__fadd_rn(q0, a0[u]), __fmul_rn(v[u], a1[u]));
    }
  }
}

extern "C" int pst_pwl_hier(const void* x, const void* e16, const void* M3,
                            const void* scal, void* out, long long batch,
                            long long N, void* stream) {
  for (long long b0 = 0; b0 < batch && N > 0; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid(pst_blocks(N, 4), (unsigned int)nb);
    pst_pwl_hier_kernel<<<grid, PST_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x + b0 * N, (const float*)e16 + b0 * 16,
        (const float*)M3 + b0 * 72 * 16, (const float*)scal + b0 * 3,
        (float*)out + b0 * N, N);
  }
  return (int)cudaGetLastError();
}

extern "C" int pst_pwl_flat(const void* x, const void* edges, const void* w,
                            const void* q0, void* out, long long batch,
                            long long N, void* stream) {
  for (long long b0 = 0; b0 < batch && N > 0; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid(pst_blocks(N, PWL_FLAT_PIX), (unsigned int)nb);
    pst_pwl_flat_kernel<<<grid, PST_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x + b0 * N, (const float*)edges + b0 * 128,
        (const float*)w + b0 * 8 * 128, (const float*)q0 + b0,
        (float*)out + b0 * N, N);
  }
  return (int)cudaGetLastError();
}
