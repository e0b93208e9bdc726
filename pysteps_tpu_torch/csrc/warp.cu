// K2: separable bilinear backward warp with in-kernel coordinates.
//
// Replaces pysteps_tpu/ops/pallas_warp.py::warp_fused_pallas (kernels
// _warp_v_kernel and _warp_h_kernel).  Two passes, two launches:
//   vertical:   C[b,i,j]   = lerp(f[b, y0, j], f[b, y0 + 1, j], cy - floor(cy)),
//               cy = i + dy[b,i,j], y0 = floor(cy) clipped to [i-D, i+D] then
//               to [0, m-1];
//   horizontal: out[b,i,j] = lerp(C[b, i, x0], C[b, i, x0 + 1], cx - floor(cx)),
//               cx = j + disp_t[b,0,j,i], x0 clipped to [j-D, j+D] then
//               [0, n-1]; when `masked`, pixels whose source
//               (i + disp_t[b,1,j,i], cx) lies outside [0,m-1]x[0,n-1] get cval.
// D arrives already rounded up to a multiple of 8, as the TPU wrapper rounds
// it; the outside test reads the transposed dy plane, as _warp_h_kernel does.
// The taps and the lerp are common.cuh's pst_tap and pst_lerp, shared with
// the fused chain (chain.cu).
//
// Design: one thread per output pixel, coalesced along the last axis.
// Bound on the H100: memory, at least field + dy + disp_t (2 planes) + out,
// plus the intermediate C written and read back.  What holds it back: the
// horizontal pass reads disp_t (n, m) at [j, i] from the thread that owns
// (i, j), a read with stride m; neighbouring threads touch neighbouring
// lines, so each 32-byte sector serves one thread.  A tiled transpose
// through shared memory, or taking dx in (m, n) layout, would fix it, and
// fusing both passes over a tile with a D-row halo would drop C.
#include "common.cuh"

__global__ void pst_warp_v_kernel(const float* __restrict__ field,
                                  const float* __restrict__ dy,
                                  float* __restrict__ C, long long total,
                                  int m, int n, int D) {
  const long long plane = (long long)m * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / plane;
    const long long p = t - b * plane;
    const int i = (int)(p / n);
    const int j = (int)(p - (long long)i * n);
    const PstTap y = pst_tap(i, dy[t], D, m);
    const float* f = field + b * plane;
    C[t] = pst_lerp(f[(long long)y.k0 * n + j], f[(long long)y.k1 * n + j], y.w);
  }
}

__global__ void pst_warp_h_kernel(const float* __restrict__ C,
                                  const float* __restrict__ disp_t,
                                  float* __restrict__ out, long long total,
                                  int m, int n, int D, float cval,
                                  int masked) {
  const long long plane = (long long)m * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / plane;
    const long long p = t - b * plane;
    const int i = (int)(p / n);
    const int j = (int)(p - (long long)i * n);
    const float* dxt = disp_t + 2 * b * plane;  // (n, m) planes
    const long long q = (long long)j * m + i;
    const PstTap x = pst_tap(j, dxt[q], D, n);
    const float* c = C + b * plane + (long long)i * n;
    float v = pst_lerp(c[x.k0], c[x.k1], x.w);
    if (masked) {
      const float cy = __fadd_rn((float)i, dxt[plane + q]);
      const bool inside = cy >= 0.0f && cy <= (float)(m - 1) && x.c >= 0.0f &&
                          x.c <= (float)(n - 1);
      if (!inside) v = cval;
    }
    out[t] = v;
  }
}

extern "C" int pst_warp(const void* field, const void* dy, const void* disp_t,
                        void* scratch, void* out, long long batch, int m,
                        int n, int D, float cval, int masked, void* stream) {
  const long long total = batch * (long long)m * n;
  if (total > 0) {
    const unsigned int blocks = pst_blocks(total);
    cudaStream_t s = (cudaStream_t)stream;
    pst_warp_v_kernel<<<blocks, PST_THREADS, 0, s>>>(
        (const float*)field, (const float*)dy, (float*)scratch, total, m, n,
        D);
    pst_warp_h_kernel<<<blocks, PST_THREADS, 0, s>>>(
        (const float*)scratch, (const float*)disp_t, (float*)out, total, m, n,
        D, cval, masked);
  }
  return (int)cudaGetLastError();
}
