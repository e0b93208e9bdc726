// K1: bounded-displacement axis resample.
//
// Replaces pysteps_tpu/ops/pallas_warp.py::pallas_resample0 (kernel
// _resample0_kernel) and its wrapper axis_resample_pallas:
//   out[b, i, j] = lerp(f[b, i0, j], f[b, i0 + 1, j], frac)   (axis 0)
// with i0 = idx0 clipped first to [i - D, i + D] (the D given, unrounded)
// and then to [0, m - 1].  Axis 1 is the same map along the columns; it is
// done by index arithmetic, with no transposed copy.
//
// Design: one thread per output pixel, neighbouring threads on neighbouring
// columns, so the idx0/frac/out streams are coalesced; the two source rows a
// warp reads are nearly the same for the smooth displacement fields of
// semi-Lagrangian advection, so they coalesce as well and hit L1/L2.
// idx0/frac may be shared by `rep` consecutive fields (the two velocity
// channels of warp_shifted_multi), which saves those bytes.
//
// Bound on the H100: memory.  Each output reads one field value (twice, the
// second from cache), one index and one fraction and writes one float.
// Left on the table: idx0/frac are computed by a separate elementwise pass in
// PyTorch (floor of the coordinates) and written to device memory; computing
// them in the kernel from the displacement, as K2 does, would remove two of
// the four streams.
#include "common.cuh"

__global__ void pst_resample_kernel(const float* __restrict__ field,
                                    const int* __restrict__ idx0,
                                    const float* __restrict__ frac,
                                    float* __restrict__ out, long long total,
                                    int m, int n, int rep, int D, int axis) {
  const long long plane = (long long)m * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / plane;
    const long long p = t - b * plane;
    const int i = (int)(p / n);
    const int j = (int)(p - (long long)i * n);
    const long long q = (b / rep) * plane + p;
    const int pos = axis == 0 ? i : j;
    const int size = axis == 0 ? m : n;
    const int k = pst_clamp(idx0[q], pos - D, pos + D);
    const int k0 = pst_clamp(k, 0, size - 1);
    const int k1 = pst_clamp(k + 1, 0, size - 1);
    const float* f = field + b * plane;
    float a, c;
    if (axis == 0) {
      a = f[(long long)k0 * n + j];
      c = f[(long long)k1 * n + j];
    } else {
      a = f[(long long)i * n + k0];
      c = f[(long long)i * n + k1];
    }
    out[t] = pst_lerp(a, c, frac[q]);
  }
}

extern "C" int pst_resample(const void* field, const void* idx0,
                            const void* frac, void* out, long long batch,
                            int rep, int m, int n, int D, int axis,
                            void* stream) {
  const long long total = batch * (long long)m * n;
  if (total > 0) {
    pst_resample_kernel<<<pst_blocks(total), PST_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const float*)field, (const int*)idx0, (const float*)frac,
        (float*)out, total, m, n, rep, D, axis);
  }
  return (int)cudaGetLastError();
}
