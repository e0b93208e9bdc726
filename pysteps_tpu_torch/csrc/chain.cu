// The fused STEPS spatial chain: PWL CDF match -> vertical resample + rim
// mask, then horizontal resample with the out-of-domain fill.
//
// Replaces pysteps_tpu/ops/pallas_chain.py::match_warp_rim (kernels
// _k1_kernel and _k2_kernel).  Per member b, with the gather LUT (e8, T) of
// pack_gather_lut and D already rounded up to a multiple of 8:
//   matched = K3's map of field (pst_pwl_gather_eval)
//   C[i,j]  = lerp(matched[k0, j], matched[k1, j], w)   taps of i + dy[i,j]
//   mask    = clip((R + 1 - d) / (r + 1), 0, 1), d the bounded L1 distance
//             to {matched >= thr} (out-of-field never wet), R = kr + r;
//             zeros when do_rim is 0
//   out     = lerp(C[i, k0], C[i, k1], w)              taps of j + dx[i,j]
//             cval where the source (i + dy, j + dx) leaves [0,m-1]x[0,n-1];
// dx and dy of stage 2 come from the transposed planes disp_t (B, 2, n, m),
// stage 1 reads dy in (m, n) layout, as the TPU kernels do.  The taps and
// lerps are common.cuh's, so the result equals K3 -> K2 (masked) and K3 ->
// K4 exactly.
//
// Design.  The TPU kernel keeps the whole field and its matched copy in
// VMEM (1 MB each at 512^2); a block here has at most 227 KB of shared
// memory, so stage 1 tiles the field: a block owns 64 rows x 32 columns of
// one member, matches them plus a halo of `halo` rows (at least R) and (with
// the rim) R columns into shared memory once, and both the rim and the
// vertical resample read that copy.  The rim is two separable min passes
// over the shared copy that stop at the first hit (exact: small integers
// in floats).  A vertical tap outside the halo (a displacement larger than
// the halo) is matched again from the field, so any halo >= R gives the
// same result: the caller picks it.  The default max(R, 8) keeps shared
// memory at (64 + 2 halo) x (32 + 2R) floats; a halo of D + 1 rows never
// re-matches but matches 1.8x as many pixels per block.  Stage 2 is one
// thread per output pixel over 32 x 32 tiles: the two transposed
// displacement planes are read coalesced and transposed through shared
// memory, and C is read along rows.
//
// Bound on the H100: memory, 8 field planes (field, dy, C written, mask
// written; C read, 2 displacement planes, out written).  The intermediate
// C is the one plane the TPU version keeps in VMEM; the halo rows and
// columns are matched again by the neighbouring blocks: (64 + 2 halo) x
// (32 + 2R) / (64 x 32) maps per pixel, 2.4 at halo = R = 12 with the rim.
#include "common.cuh"

#define CH_TR 64  // stage 1 rows per block
#define CH_TC 32  // stage 1 columns per block (one warp wide)
#define CH_T2 32  // stage 2 square tile
#define CH_MAX_DEVICES 64

__global__ void pst_chain_v_kernel(
    const float* __restrict__ field, const float* __restrict__ e8,
    const float* __restrict__ T, const float* __restrict__ scal,
    const float* __restrict__ dy, float* __restrict__ C,
    float* __restrict__ mask, int m, int n, int D, int kr, int r, float thr,
    int do_rim, int halo) {
  extern __shared__ float sm[];
  float* sT = sm;          // (8, 48) LUT
  float* se8 = sT + 8 * 48;  // 8 block starts
  float* sM = se8 + 8;     // matched rows [ra, rb) x columns [ca, cb)
  const int R = kr + r;
  const int hc = do_rim ? R : 0;
  float* sDv = sM + (CH_TR + 2 * halo) * (CH_TC + 2 * hc);  // rim: (64, W)

  const long long b = blockIdx.z;
  const long long plane = (long long)m * n;
  const int i0 = blockIdx.y * CH_TR, j0 = blockIdx.x * CH_TC;
  const int iend = min(i0 + CH_TR, m), jend = min(j0 + CH_TC, n);
  const int ra = max(i0 - halo, 0), rb = min(iend + halo, m);
  const int ca = max(j0 - hc, 0), cb = min(jend + hc, n);
  const int W = cb - ca;

  pst_pwl_gather_load(e8 + b * 8, T + b * 8 * 48, se8, sT);
  const float q0 = scal[b * 3], zval = scal[b * 3 + 1], ztrg = scal[b * 3 + 2];
  __syncthreads();

  const float* fb = field + b * plane;
  for (int t = threadIdx.x; t < (rb - ra) * W; t += blockDim.x) {
    const int rr = t / W, cc = t - rr * W;
    sM[t] = pst_pwl_gather_eval(fb[(long long)(ra + rr) * n + ca + cc], se8,
                                sT, q0, zval, ztrg);
  }
  __syncthreads();

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = j0 + tx;
  const int nwarps = blockDim.x >> 5;
  for (int i = i0 + ty; i < iend; i += nwarps) {
    if (j >= jend) break;
    const long long p = b * plane + (long long)i * n + j;
    const PstTap y = pst_tap(i, dy[p], D, m);
    const float a = (y.k0 >= ra && y.k0 < rb)
                        ? sM[(y.k0 - ra) * W + (j - ca)]
                        : pst_pwl_gather_eval(fb[(long long)y.k0 * n + j], se8,
                                              sT, q0, zval, ztrg);
    const float c = (y.k1 >= ra && y.k1 < rb)
                        ? sM[(y.k1 - ra) * W + (j - ca)]
                        : pst_pwl_gather_eval(fb[(long long)y.k1 * n + j], se8,
                                              sT, q0, zval, ztrg);
    C[p] = pst_lerp(a, c, y.w);
  }

  if (!do_rim) {
    for (int i = i0 + ty; i < iend && j < jend; i += nwarps)
      mask[b * plane + (long long)i * n + j] = 0.0f;
    return;
  }

  // vertical distance to the nearest wet pixel within R rows, for the
  // tile's rows and the halo columns; every row i +- k inside the field
  // lies in [ra, rb) because halo >= R
  for (int t = threadIdx.x; t < (iend - i0) * W; t += blockDim.x) {
    const int rr = t / W, cc = t - rr * W;
    const int i = i0 + rr;
    int best = R + 1;
    for (int k = 0; k <= R; ++k) {
      if ((i - k >= 0 && sM[(i - k - ra) * W + cc] >= thr) ||
          (i + k < m && sM[(i + k - ra) * W + cc] >= thr)) {
        best = k;
        break;
      }
    }
    sDv[t] = (float)best;
  }
  __syncthreads();

  for (int i = i0 + ty; i < iend && j < jend; i += nwarps) {
    const float* row = sDv + (i - i0) * W;
    const int c = j - ca;
    float best = row[c];
    for (int k = 1; k <= R && (float)k < best; ++k) {
      float cand = (float)(R + 1);
      if (j - k >= 0) cand = row[c - k];
      if (j + k < n) cand = fminf(cand, row[c + k]);
      best = fminf(best, __fadd_rn(cand, (float)k));
    }
    mask[b * plane + (long long)i * n + j] = pst_rim_of(best, R, r);
  }
}

__global__ void pst_chain_h_kernel(const float* __restrict__ C,
                                   const float* __restrict__ disp_t,
                                   float* __restrict__ out, int m, int n,
                                   int D, float cval) {
  __shared__ float sx[CH_T2][CH_T2 + 1];
  __shared__ float sy[CH_T2][CH_T2 + 1];
  const long long b = blockIdx.z;
  const long long plane = (long long)m * n;
  const int i0 = blockIdx.y * CH_T2, j0 = blockIdx.x * CH_T2;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* dxt = disp_t + 2 * b * plane;  // (n, m) planes
  const float* dyt = dxt + plane;
  // rows j of the transposed planes, coalesced along i
  for (int jj = ty; jj < CH_T2; jj += nwarps) {
    const int jg = j0 + jj, ig = i0 + tx;
    if (jg < n && ig < m) {
      sx[jj][tx] = dxt[(long long)jg * m + ig];
      sy[jj][tx] = dyt[(long long)jg * m + ig];
    }
  }
  __syncthreads();
  const int j = j0 + tx;
  if (j >= n) return;
  for (int ii = ty; ii < CH_T2 && i0 + ii < m; ii += nwarps) {
    const int i = i0 + ii;
    const PstTap x = pst_tap(j, sx[tx][ii], D, n);
    const float* c = C + b * plane + (long long)i * n;
    const float v = pst_lerp(c[x.k0], c[x.k1], x.w);
    const float cy = __fadd_rn((float)i, sy[tx][ii]);
    const bool inside = cy >= 0.0f && cy <= (float)(m - 1) && x.c >= 0.0f &&
                        x.c <= (float)(n - 1);
    out[b * plane + (long long)i * n + j] = inside ? v : cval;
  }
}

// Shared memory of stage 1 in bytes; above the card's 227 KB cudaFuncSetAttribute
// refuses it and the wrapper raises.
static long long pst_chain_v_smem(int R, int halo, int do_rim) {
  const int hc = do_rim ? R : 0;
  const long long W = CH_TC + 2 * hc;
  long long floats = 8 * 48 + 8 + (CH_TR + 2 * halo) * W;
  if (do_rim) floats += CH_TR * W;
  return floats * (long long)sizeof(float);
}

extern "C" int pst_chain_v(const void* field, const void* e8, const void* T,
                           const void* scal, const void* dy, void* C,
                           void* mask, long long batch, int m, int n, int D,
                           int kr, int r, float thr, int do_rim, int halo,
                           void* stream) {
  const long long smem = pst_chain_v_smem(kr + r, halo, do_rim);
  // above the 48 KB default the kernel needs a larger carve-out; raise the
  // attribute once per card for the largest size asked so far
  static long long smem_set[CH_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= CH_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(pst_chain_v_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  const long long plane = (long long)m * n;
  for (long long b0 = 0; b0 < batch && plane > 0; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid((n + CH_TC - 1) / CH_TC, (m + CH_TR - 1) / CH_TR,
              (unsigned int)nb);
    pst_chain_v_kernel<<<grid, PST_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)field + b0 * plane, (const float*)e8 + b0 * 8,
        (const float*)T + b0 * 8 * 48, (const float*)scal + b0 * 3,
        (const float*)dy + b0 * plane, (float*)C + b0 * plane,
        (float*)mask + b0 * plane, m, n, D, kr, r, thr, do_rim, halo);
  }
  return (int)cudaGetLastError();
}

extern "C" int pst_chain_h(const void* C, const void* disp_t, void* out,
                           long long batch, int m, int n, int D, float cval,
                           void* stream) {
  const long long plane = (long long)m * n;
  for (long long b0 = 0; b0 < batch && plane > 0; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid((n + CH_T2 - 1) / CH_T2, (m + CH_T2 - 1) / CH_T2,
              (unsigned int)nb);
    pst_chain_h_kernel<<<grid, PST_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)C + b0 * plane, (const float*)disp_t + 2 * b0 * plane,
        (float*)out + b0 * plane, m, n, D, cval);
  }
  return (int)cudaGetLastError();
}
