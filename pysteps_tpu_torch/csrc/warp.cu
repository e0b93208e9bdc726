// K2: separable bilinear backward warp with in-kernel coordinates.
//
// Replaces pysteps_tpu/ops/pallas_warp.py::warp_fused_pallas (kernels
// _warp_v_kernel and _warp_h_kernel):
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
// the fused chain (chain.cu), so the result is the two-pass one bit for bit.
//
// Design.  Bound on the H100: memory, field + dy + the two transposed
// displacement planes read and out written, 5 planes.  One launch of the
// tile kernel, no scratch plane:
// - A block owns th output rows of one member by tw output columns: the
//   whole row (a strip, no column halo) when th rows of n columns fit 64 KB
//   of shared memory, else column tiles of 256 columns.  It first runs the
//   vertical lerp of its rows over every column a horizontal tap can
//   reach, [j0 - D, j0 + tw + D], clipped to the field, into shared memory
//   (C never leaves the chip; a column tile recomputes its 2 min(D, n) + 1
//   halo columns), WP_ROWS rows a thread, their 2 WP_ROWS field taps in
//   flight.
// - It then walks its columns WP_CH at a time.  The two transposed planes
//   (n, m) are read coalesced along i (th consecutive floats of a plane
//   row) and transposed through shared memory rows of th + 1 floats, so
//   neither the stores nor the reads along j conflict on banks; each next
//   step's planes are loaded into registers while a step computes, into
//   the other of two buffers, so a step costs one barrier.  Each output is
//   one lerp from the shared row and one coalesced store.
// - The host (pallas_warp.warp_geometry) picks th, the largest of 16, 8,
//   4, 2, 1 that still gives 2 blocks an SM, and tw, and sizes the tile's
//   columns and shared memory; pst_warp refuses a geometry that does not
//   hold the tile.  At most 64 registers a thread keep 4 blocks of 256
//   threads on an SM.  These choices (6 rows a thread, the first step's
//   planes loaded after the lerp, columns of 256 on 1024^2, 16-row tiles)
//   were measured on the card; scripts/tune_warp_tiles.py times the
//   geometries.  A shape whose tile cannot hold in a block's 227 KB takes
//   the two-pass kernels below (th = 0), through the caller's scratch
//   plane.
// Offsets inside a plane are 64-bit at each row base; the batch launches
// in chunks of PST_MAX_GRID_YZ members.
#include "common.cuh"

#define WP_THREADS 256
#define WP_CH 64          // output columns of a horizontal step
#define WP_ROWS 6         // rows of a thread's vertical step: taps in flight
#define WP_MIN_BLOCKS 4   // blocks an SM the register budget allows (64 a thread)
#define WP_MAX_TH 16
#define WP_PER (WP_CH * WP_MAX_TH / WP_THREADS)  // step elements a thread

__global__ void __launch_bounds__(WP_THREADS, WP_MIN_BLOCKS) pst_warp_tile_kernel(
    const float* __restrict__ field, const float* __restrict__ dy,
    const float* __restrict__ disp_t, float* __restrict__ out, int m, int n,
    int D, float cval, int masked, int lth, int tw, int wcs,
    unsigned int ncol) {
  extern __shared__ __align__(16) float wsm[];
  const int th = 1 << lth;
  float* sC = wsm;
  float* sD = wsm + th * wcs;  // [buffer][plane][WP_CH][th + 1]
  const int sdp = WP_CH * (th + 1);

  const int tid = threadIdx.x;
  const int j0 = (int)(blockIdx.x % ncol) * tw;
  const int i0 = (int)(blockIdx.x / ncol) * th;
  const int rows = min(th, m - i0);
  const int jend = j0 + min(tw, n - j0);  // live output columns [j0, jend)
  const int Dn = min(D, n);
  const int cs = max(0, j0 - Dn), ce = min(n, jend + Dn + 1);
  const int wc = ce - cs;
  const long long plane = (long long)m * n;
  const float* fb = field + blockIdx.y * plane;
  const float* dyb = dy + blockIdx.y * plane;
  const float* dxt = disp_t + 2 * blockIdx.y * plane;  // (n, m) planes
  const float* dyt = dxt + plane;
  float* ob = out + blockIdx.y * plane;

  // a step's transposed planes: element e = tid + WP_THREADS u is row
  // e & (th - 1) of plane row (column) e >> lth
  float px[WP_PER], py[WP_PER];
  auto fetch = [&](int jc0) {
#pragma unroll
    for (int u = 0; u < WP_PER; ++u) {
      const int e = tid + WP_THREADS * u;
      const int r = e & (th - 1), cj = e >> lth;
      const bool ok = cj < WP_CH && r < rows && jc0 + cj < jend;
      const long long q = (long long)(jc0 + cj) * m + i0 + r;
      px[u] = ok ? __ldg(dxt + q) : 0.0f;
      py[u] = ok && masked ? __ldg(dyt + q) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
    float* sx = sD + 2 * buf * sdp;
#pragma unroll
    for (int u = 0; u < WP_PER; ++u) {
      const int e = tid + WP_THREADS * u;
      const int r = e & (th - 1), cj = e >> lth;
      if (cj < WP_CH) {
        sx[cj * (th + 1) + r] = px[u];
        sx[sdp + cj * (th + 1) + r] = py[u];
      }
    }
  };

  // 1. the vertical lerp of the block's rows over columns [cs, ce): item q
  //    is column q % wc of the rows' group q / wc, WP_ROWS rows a group
  const int ngrp = (rows + WP_ROWS - 1) / WP_ROWS;
  for (int q = tid; q < ngrp * wc; q += WP_THREADS) {
    const int g = q / wc, c = q - g * wc, col = cs + c;
    const int r0 = g * WP_ROWS;
    float d[WP_ROWS];
#pragma unroll
    for (int k = 0; k < WP_ROWS; ++k)
      d[k] = r0 + k < rows ? __ldg(dyb + (long long)(i0 + r0 + k) * n + col) : 0.0f;
    float a[WP_ROWS], z[WP_ROWS], w[WP_ROWS];
#pragma unroll
    for (int k = 0; k < WP_ROWS; ++k) {
      const PstTap y = pst_tap(i0 + r0 + k, d[k], D, m);
      w[k] = y.w;
      const bool live = r0 + k < rows;
      a[k] = live ? __ldg(fb + (long long)y.k0 * n + col) : 0.0f;
      z[k] = live ? __ldg(fb + (long long)y.k1 * n + col) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < WP_ROWS; ++k)
      if (r0 + k < rows) sC[(r0 + k) * wcs + c] = pst_lerp(a[k], z[k], w[k]);
  }
  fetch(j0);  // not before the lerp: its registers would stay live there
  stash(0);
  __syncthreads();

  // 2. the horizontal lerp and the fill, WP_CH columns a step: element
  //    e = tid + WP_THREADS u is column e % WP_CH of row e / WP_CH
  const int nstep = (jend - j0 + WP_CH - 1) / WP_CH;
  for (int s = 0; s < nstep; ++s) {
    const int jc0 = j0 + s * WP_CH;
    if (s + 1 < nstep) fetch(jc0 + WP_CH);
    const float* sx = sD + 2 * (s & 1) * sdp;
#pragma unroll
    for (int u = 0; u < WP_PER; ++u) {
      const int e = tid + WP_THREADS * u;
      const int cj = e & (WP_CH - 1), r = e / WP_CH;
      const int j = jc0 + cj;
      if (r < rows && j < jend) {
        const int i = i0 + r;
        const PstTap x = pst_tap(j, sx[cj * (th + 1) + r], D, n);
        const float* crow = sC + r * wcs - cs;
        float v = pst_lerp(crow[x.k0], crow[x.k1], x.w);
        if (masked) {
          const float cy = __fadd_rn((float)i, sx[sdp + cj * (th + 1) + r]);
          const bool inside = cy >= 0.0f && cy <= (float)(m - 1) && x.c >= 0.0f &&
                              x.c <= (float)(n - 1);
          if (!inside) v = cval;
        }
        ob[(long long)i * n + j] = v;
      }
    }
    if (s + 1 < nstep) stash((s + 1) & 1);
    __syncthreads();
  }
}

// The two-pass kernels of shapes whose tile does not fit: one thread a
// pixel, the vertical pass into the caller's scratch plane C.
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

static long long pst_warp_granted[PST_MAX_DEVICES];

static int wp_lth(int th) {
  for (int l = 0; (1 << l) <= WP_MAX_TH; ++l)
    if (th == 1 << l) return l;
  return -1;
}

// th, tw, cols, smem: the tile geometry (pallas_warp.warp_tile: th rows by
// tw output columns, cols columns of C a block holds, its shared memory in
// bytes), or th = 0 for the two-pass kernels, which need `scratch`, a float
// plane of out's shape.  A geometry whose columns miss a tap's reach, or
// whose shared memory is short of th rows of C and the two buffers of
// WP_CH rows of th + 1 floats of both planes, is refused.
extern "C" int pst_warp(const void* field, const void* dy, const void* disp_t,
                        void* scratch, void* out, long long batch, int m,
                        int n, int D, float cval, int masked, int th, int tw,
                        int cols, long long smem, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (th == 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const long long total = batch * (long long)m * n;
    const unsigned int blocks = pst_blocks(total);
    pst_warp_v_kernel<<<blocks, PST_THREADS, 0, s>>>(
        (const float*)field, (const float*)dy, (float*)scratch, total, m, n, D);
    pst_warp_h_kernel<<<blocks, PST_THREADS, 0, s>>>(
        (const float*)scratch, (const float*)disp_t, (float*)out, total, m, n,
        D, cval, masked);
    return (int)cudaGetLastError();
  }
  const int lth = wp_lth(th);
  if (lth < 0 || tw <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  const long long reach = tw >= n ? n : tw + 2LL * (D < n ? D : n) + 1;
  if (cols < (reach < n ? reach : n) ||
      smem < 4LL * ((long long)th * cols + 4LL * WP_CH * (th + 1)))
    return (int)cudaErrorInvalidValue;
  const unsigned int ncol = (unsigned int)((n + tw - 1) / tw);
  const long long nx = (long long)ncol * ((m + th - 1) / th);
  if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = pst_allow_smem(pst_warp_tile_kernel, smem, pst_warp_granted);
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)m * n;
  for (long long b0 = 0; b0 < batch; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid((unsigned int)nx, (unsigned int)nb);
    pst_warp_tile_kernel<<<grid, WP_THREADS, smem, s>>>(
        (const float*)field + b0 * plane, (const float*)dy + b0 * plane,
        (const float*)disp_t + 2 * b0 * plane, (float*)out + b0 * plane, m, n,
        D, cval, masked, lth, tw, cols, ncol);
  }
  return (int)cudaGetLastError();
}

// The blocks of the tile kernel that fit on one SM of the current card at
// `smem` bytes of dynamic shared memory (the occupancy API; computed, not
// measured).
extern "C" int pst_warp_info(long long smem, int* blocks_per_sm) {
  if (smem <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = pst_allow_smem(pst_warp_tile_kernel, smem, pst_warp_granted);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pst_warp_tile_kernel, WP_THREADS, (size_t)smem);
}
