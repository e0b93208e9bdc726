// K4: bounded L1 distance rim (the incremental-mask grayscale rim).
//
// Replaces pysteps_tpu/ops/pallas_dilate.py::dilated_rim_from_field_pallas
// (kernel _rim_kernel_whole) and dilated_rim_pallas (kernel _rim_kernel);
// the mask entry point is this kernel fed a 0/1 field with thr = 0.5.
//   wet(i, j) = field[i, j] >= thr
//   dv(i, j)  = min_{|k| <= R} (wet(i + k, j) ? |k| : R + 1)       (vertical)
//   d(i, j)   = min_{|k| <= R} dv(i, j + k) + |k|                  (horizontal)
//   rim       = clip((R + 1 - d) / (r + 1), 0, 1),   R = kr + r.
// L1 distance is separable and every value is a small integer held in a
// float, so the result equals the TPU kernels' jump-doubling and 5-point
// stencil forms exactly (any d > R gives 0 in all of them).
//
// Design: two launches, one thread per pixel, the vertical distances in a
// scratch field.  Bound on the H100: memory (one read and one write of the
// field), plus the scratch written and read back.  Left on the table: each
// pixel re-reads 2R + 1 neighbours per pass from L1/L2 and the scratch
// makes two extra field passes; one shared-memory tile with an R halo in
// both directions would do one read and one write.
#include "common.cuh"

__global__ void pst_rim_v_kernel(const float* __restrict__ field, float thr,
                                 float* __restrict__ dv, long long total,
                                 int m, int n, int R) {
  const long long plane = (long long)m * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / plane;
    const long long p = t - b * plane;
    const int i = (int)(p / n);
    const int j = (int)(p - (long long)i * n);
    const float* f = field + b * plane;
    int best = R + 1;
    const int lo = max(i - R, 0), hi = min(i + R, m - 1);
    for (int ii = lo; ii <= hi; ++ii) {
      if (f[(long long)ii * n + j] >= thr) best = min(best, abs(ii - i));
    }
    dv[t] = (float)best;
  }
}

__global__ void pst_rim_h_kernel(const float* __restrict__ dv,
                                 float* __restrict__ out, long long total,
                                 int m, int n, int R, int r) {
  const long long plane = (long long)m * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / plane;
    const long long p = t - b * plane;
    const int i = (int)(p / n);
    const int j = (int)(p - (long long)i * n);
    const float* row = dv + b * plane + (long long)i * n;
    float best = (float)(R + 1);
    const int lo = max(j - R, 0), hi = min(j + R, n - 1);
    for (int jj = lo; jj <= hi; ++jj) {
      best = fminf(best, __fadd_rn(row[jj], (float)abs(jj - j)));
    }
    out[t] = pst_rim_of(best, R, r);
  }
}

extern "C" int pst_rim(const void* field, float thr, void* scratch, void* out,
                       long long batch, int m, int n, int kr, int r,
                       void* stream) {
  const long long total = batch * (long long)m * n;
  if (total > 0) {
    const int R = kr + r;
    const unsigned int blocks = pst_blocks(total);
    cudaStream_t s = (cudaStream_t)stream;
    pst_rim_v_kernel<<<blocks, PST_THREADS, 0, s>>>(
        (const float*)field, thr, (float*)scratch, total, m, n, R);
    pst_rim_h_kernel<<<blocks, PST_THREADS, 0, s>>>(
        (const float*)scratch, (float*)out, total, m, n, R, r);
  }
  return (int)cudaGetLastError();
}
