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
// Stage 1 design.  The TPU kernel keeps the whole field and its matched
// copy in VMEM (1 MB each at 512^2); a block here has at most 227 KB of
// shared memory.  Bound on the H100: memory (field and dy read, C and the
// rim written), so the design matches each pixel a block needs once, keeps
// the map cheap, and never goes back to device memory for a tap:
// - A block owns a full-height strip of one member: CV_W output columns
//   plus the rim's R columns on each side.  It walks the strip downward,
//   CV_TH rows a step, and keeps the matched output columns in a ring of
//   shared-memory rows from D rows above the step to D + 1 below it, so
//   every tap of pst_tap (clipped to [i - D, i + D + 1]) lies in the ring.
//   Each pixel of the strip window is matched once: (CV_W + 2R) / CV_W
//   matches per output, 1.375 at R = 12 (1.328 over 512 columns, whose edge
//   strips have no columns outside the field), against 2.4 for the 64 x 32
//   halo tiles of the first design, which also matched taps beyond their
//   halo a second time from device memory.  Strips rather than 2-D tiles
//   because a tile's vertical halo of 2D + 1 rows is paid once per strip.
//   The ring holds 2 CV_TH + 2D + 1 rows, so the next step's rows are
//   matched while the current step is still read: one barrier a step.  The
//   field loads of a step's new rows are issued before the step before it
//   computes, and a warp maps all its values before it stores any, so the
//   maps' table loads overlap.
// - The PWL map reads per-member prefix tables, common.cuh's
//   pst_pwl_prefix_build / pst_pwl_prefix_eval, which K3 (pwl.cu)
//   evaluates too: 7 block-start compares, a 4-step search and one 8-byte
//   load a pixel, equal under == to K3's 15-term sum; a LUT that fails the
//   table check takes that sum (pst_pwl_sum_eval, a uniform branch).
// - The rim keeps only wet bits and byte distances.  A warp matches whole
//   rows of the window, 32 columns at a time, and its ballot is the row's
//   wet bit word; the horizontal distance (capped at R + 1) of each output
//   column is a clz / ffs over those words.  One thread per output column
//   then sweeps the step's rows in registers: a backward min-plus from R
//   rows below the step, then a forward one over its result, carried down
//   the strip.  That is the bounded L1 distance K4's two separable min
//   passes give (small integers, exact), and the rim value is looked up
//   from pst_rim_of of each integer distance.
// - Warps 0-1 sweep the rim, warps 2-7 resample, and all eight match.
//   32-row steps: taller ones hold more registers than two blocks an SM
//   allow, shorter ones pay the barrier and the rim's look-ahead more often.
// - A second instantiation (kCount) also counts the window pixels whose
//   map it stores, so that a run can read the matches per output from the
//   card (pst_chain_v_count); the launched one (pst_chain_v) does not.
// Stage 2 is one thread per output pixel over 32 x 32 tiles: the two
// transposed displacement planes are read coalesced and transposed through
// shared memory, and C is read along rows.
//
// Bound on the H100: memory, 8 field planes (field, dy, C written, mask
// written; C read, 2 displacement planes, out written).  The intermediate
// C is the one plane the TPU version keeps in VMEM.
#include "common.cuh"

#define CV_W 64       // stage 1 output columns of a strip
#define CV_TH 32      // stage 1 rows a step
#define CV_WARPS 8
#define CV_RIM_WARPS 2  // one rim thread per output column
#define CV_RPW (CV_TH / CV_WARPS)  // rows a warp matches per round
#define CV_MAX_R 254  // byte distances hold R + 1
#define CH_T2 32      // stage 2 square tile

__host__ __device__ __forceinline__ long long cv_min(long long a, long long b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ long long cv_max(long long a, long long b) {
  return a > b ? a : b;
}

// Stage 1's strip geometry and shared-memory layout (byte offsets, each a
// multiple of 16), computed alike by the entry point and the kernel.
struct CvGeom {
  int hc;    // rim columns matched on each side of the strip (R, or 0)
  int W;     // matched columns of a strip: CV_W + 2 hc
  int nw;    // 32-column wet words of a matched row
  int hhi;   // rows matched below a step's last row: max(D + 1, hc)
  int ring;  // rows of the ring: min(m, 2 CV_TH + hhi + D)
  long long P, T, E, e8, rim, M, bits, dh, bytes;
};

__host__ __device__ inline CvGeom cv_geom(int m, int D, int R, int do_rim) {
  CvGeom g;
  const long long Dr = cv_min(D < 0 ? -(long long)D : D, m);
  g.hc = do_rim ? R : 0;
  g.W = CV_W + 2 * g.hc;
  g.nw = (g.W + 31) / 32;
  g.hhi = (int)cv_max(Dr + 1, g.hc);
  g.ring = (int)cv_min(m, 2 * CV_TH + g.hhi + Dr);
  long long off = 0;
  g.P = off;    off += 8 * PST_PWL_LS * 8;  // float2 prefix sums (acc0, acc1)
  g.T = off;    off += 8 * 48 * 4;     // the gather LUT as given
  g.E = off;    off += 8 * PST_PWL_LS * 4;  // fine edges
  g.e8 = off;   off += 8 * 4;
  g.rim = off;  off += do_rim ? ((R + 2) * 4 + 15) / 16 * 16 : 0;
  g.M = off;    off += (long long)g.ring * CV_W * 4;  // matched ring
  g.bits = off; off += do_rim ? CV_WARPS * CV_RPW * g.nw * 4 : 0;
  g.dh = off;   off += do_rim ? (long long)g.ring * CV_W : 0;  // byte distances
  g.bytes = off;
  return g;
}

template <bool kCount>
__global__ void __launch_bounds__(CV_WARPS * 32) pst_chain_v_kernel(
    const float* __restrict__ field, const float* __restrict__ e8,
    const float* __restrict__ T, const float* __restrict__ scal,
    const float* __restrict__ dy, float* __restrict__ C,
    float* __restrict__ mask, int m, int n, int D, int R, int r, float thr,
    int do_rim, unsigned long long* __restrict__ nmatch) {
  extern __shared__ __align__(16) unsigned char sm[];
  const CvGeom g = cv_geom(m, D, R, do_rim);
  float2* sP = (float2*)(sm + g.P);
  float* sT = (float*)(sm + g.T);
  float* sE = (float*)(sm + g.E);
  float* se8 = (float*)(sm + g.e8);
  float* srim = (float*)(sm + g.rim);
  float* sM = (float*)(sm + g.M);
  unsigned* sbits = (unsigned*)(sm + g.bits);
  unsigned char* sdh = sm + g.dh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.y;
  const long long plane = (long long)m * n;
  const int j0 = blockIdx.x * CV_W;
  const int cbase = j0 - g.hc;  // field column of window position 0
  const int cw = min(CV_W, n - j0);  // live output columns
  const float* fb = field + b * plane;
  const float* dyb = dy + b * plane;
  float* Cb = C + b * plane;
  float* Mb = mask + b * plane;

  // the member's LUT, its prefix tables and the check that they are exact
  for (int k = tid; k < 8 * 48; k += blockDim.x) sT[k] = T[b * 8 * 48 + k];
  if (tid < 8) se8[tid] = e8[b * 8 + tid];
  if (do_rim)
    for (int d = tid; d <= R + 1; d += blockDim.x)
      srim[d] = pst_rim_of((float)d, R, r);
  const float q0 = scal[b * 3], zval = scal[b * 3 + 1], ztrg = scal[b * 3 + 2];
  __syncthreads();
  const bool fast = __syncthreads_and(pst_pwl_prefix_build(sT, sP, sE));
  float e8r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) e8r[k] = se8[k];

  int s0 = 0;       // ring slot of the step's first row
  int fwd = R + 1;  // rim threads: forward distance carried down the strip
  unsigned long long counted = 0;  // kCount: window pixels this warp matched
  unsigned* wbits = sbits + warp * CV_RPW * g.nw;
  // a warp matches CV_RPW rows at a time, 3 words of 32 columns each
  float v[CV_RPW][3];
  bool in[CV_RPW][3];

  // the field under rows rb.. (those below hi), words qb..qb + 2
  auto load = [&](int rb, int hi, int qb) {
#pragma unroll
    for (int rr = 0; rr < CV_RPW; ++rr) {
#pragma unroll
      for (int qq = 0; qq < 3; ++qq) {
        const int row = rb + rr, x = 32 * (qb + qq) + lane, col = cbase + x;
        in[rr][qq] = row < hi && x < g.W && col >= 0 && col < n;
        v[rr][qq] = in[rr][qq] ? __ldg(fb + row * n + col) : 0.0f;
      }
    }
  };
  // map the loaded values (every map before any shared-memory store, so
  // their table loads overlap), then fill the ring (row rb in slot sb)
  // and the wet words
  auto match = [&](int rb, int sb, int hi, int qb) {
    float mv[CV_RPW][3];
    if (fast) {
#pragma unroll
      for (int rr = 0; rr < CV_RPW; ++rr)
#pragma unroll
        for (int qq = 0; qq < 3; ++qq)
          mv[rr][qq] = pst_pwl_prefix_eval(v[rr][qq], e8r, sE, sP, q0, zval, ztrg);
    } else {
#pragma unroll
      for (int rr = 0; rr < CV_RPW; ++rr)
#pragma unroll
        for (int qq = 0; qq < 3; ++qq)
          mv[rr][qq] = in[rr][qq] ? pst_pwl_sum_eval(v[rr][qq], se8, sT, q0, zval, ztrg)
                                  : 0.0f;
    }
#pragma unroll
    for (int rr = 0; rr < CV_RPW; ++rr) {
      const int row = rb + rr;
      const int slot = sb + rr >= g.ring ? sb + rr - g.ring : sb + rr;
#pragma unroll
      for (int qq = 0; qq < 3; ++qq) {
        const int q = qb + qq;
        if (row < hi && q < g.nw) {  // warp-uniform
          if (kCount) counted += __popc(__ballot_sync(0xffffffffu, in[rr][qq]));
          const int c = 32 * q + lane - g.hc;
          if (in[rr][qq] && c >= 0 && c < CV_W) sM[slot * CV_W + c] = mv[rr][qq];
          if (do_rim) {
            const unsigned word = __ballot_sync(0xffffffffu, in[rr][qq] && mv[rr][qq] >= thr);
            if (lane == 0) wbits[rr * g.nw + q] = word;
          }
        }
      }
    }
  };
  // rows rb.. below hi, row rb in ring slot sb: every word (the first
  // three already loaded when `loaded`), then the rows' horizontal
  // distances
  auto match_rows = [&](int rb, int sb, int hi, bool loaded) {
    for (int qb = 0; qb < g.nw; qb += 3) {
      if (!loaded || qb > 0) load(rb, hi, qb);
      match(rb, sb, hi, qb);
    }
    if (do_rim) {
      __syncwarp();
      for (int rr = 0; rr < CV_RPW && rb + rr < hi; ++rr) {
        const int slot = sb + rr >= g.ring ? sb + rr - g.ring : sb + rr;
        for (int c = lane; c < cw; c += 32)
          sdh[slot * CV_W + c] =
              (unsigned char)pst_hdist(wbits + rr * g.nw, g.nw, c + g.hc, R);
      }
      __syncwarp();
    }
  };

  // the rows the first step reads, in rounds of CV_TH; each later step
  // adds CV_TH rows, loaded while the step before it computes
  int lo = min(m, CV_TH + g.hhi);  // rows matched so far (lo <= ring)
  int slo = lo == g.ring ? 0 : lo;   // ring slot of row lo
  for (int rb = warp * CV_RPW; rb < lo; rb += CV_TH) match_rows(rb, rb, lo, false);
  constexpr int ngrp = (CV_WARPS - CV_RIM_WARPS) * 32 / CV_W;  // C row groups
  constexpr int kMaxRows = (CV_TH + ngrp - 1) / ngrp;
  const int u = tid - CV_RIM_WARPS * 32;  // C threads: column, row group
  const int cc = u & (CV_W - 1), grp = u / CV_W;
  for (int i0 = 0; i0 < m; i0 += CV_TH) {
    const int iend = min(m, i0 + CV_TH);
    // 1. match the rows this step adds: through hhi rows below its last
    if (i0 > 0) {
      const int hi = min(m, i0 + CV_TH + g.hhi);
      const int sb = slo + warp * CV_RPW;
      match_rows(lo + warp * CV_RPW, sb >= g.ring ? sb - g.ring : sb, hi, true);
      slo += hi - lo;
      if (slo >= g.ring) slo -= g.ring;
      lo = hi;
    }
    __syncthreads();
    if (i0 + CV_TH < m) load(lo + warp * CV_RPW, min(m, i0 + 2 * CV_TH + g.hhi), 0);

    // 2. the step's rows [i0, iend): the rim on warps 0-1, C on the rest
    if (warp < CV_RIM_WARPS) {
      const int c = tid;
      if (c < cw) {
        float* mrow = Mb + j0 + c;
        if (!do_rim) {
          for (int i = i0; i < iend; ++i) mrow[i * n] = 0.0f;
        } else {
          // the step's horizontal distances, in registers
          int dv[CV_TH];
#pragma unroll
          for (int k = 0; k < CV_TH; ++k) {
            const int sk = s0 + k >= g.ring ? s0 + k - g.ring : s0 + k;
            dv[k] = i0 + k < iend ? (int)sdh[sk * CV_W + c] : R + 1;
          }
          // backward min-plus from the last row within R below the step,
          // written over dv; the forward min-plus over it is then the
          // bounded distance (each term a distance to a wet pixel, and
          // every wet pixel within R rows reached)
          int bwd = R + 1;
          const int last = min(m, iend + R) - 1;
          int s = s0 + (last - i0);
          if (s >= g.ring) s -= g.ring;
#pragma unroll 4
          for (int i = last; i >= iend; --i) {
            bwd = min((int)sdh[s * CV_W + c], bwd + 1);
            s = s == 0 ? g.ring - 1 : s - 1;
          }
#pragma unroll
          for (int k = CV_TH - 1; k >= 0; --k) {
            bwd = min(dv[k], bwd + 1);
            dv[k] = bwd;
          }
          // forward min-plus, carried down the strip
#pragma unroll
          for (int k = 0; k < CV_TH; ++k) {
            if (i0 + k < iend) {
              fwd = min(dv[k], fwd + 1);
              mrow[(i0 + k) * n] = srim[fwd];
            }
          }
        }
      }
    } else if (cc < cw) {
      const int j = j0 + cc;
      float dyv[kMaxRows];
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) {
        const int i = i0 + grp + ngrp * k;
        dyv[k] = i < iend ? dyb[i * n + j] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) {
        const int i = i0 + grp + ngrp * k;
        if (i < iend) {
          int si = s0 + (i - i0);
          if (si >= g.ring) si -= g.ring;
          const PstTap y = pst_tap(i, dyv[k], D, m);
          int s_0 = si + (y.k0 - i), s_1 = si + (y.k1 - i);
          s_0 += s_0 < 0 ? g.ring : (s_0 >= g.ring ? -g.ring : 0);
          s_1 += s_1 < 0 ? g.ring : (s_1 >= g.ring ? -g.ring : 0);
          Cb[i * n + j] = pst_lerp(sM[s_0 * CV_W + cc], sM[s_1 * CV_W + cc], y.w);
        }
      }
    }
    s0 += CV_TH;
    if (s0 >= g.ring) s0 -= g.ring;
  }
  if (kCount && lane == 0) atomicAdd(nmatch, counted);
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

// Stage 1's dynamic shared memory; 0 for arguments it refuses (a rim
// radius above CV_MAX_R).
static long long pst_chain_v_bytes(int m, int D, int kr, int r, int do_rim) {
  const int R = kr + r;
  if (do_rim && (R < 0 || R > CV_MAX_R)) return 0;
  return cv_geom(m, D, R, do_rim).bytes;
}

static long long pst_chain_v_granted[2][PST_MAX_DEVICES];

template <bool kCount>
static int pst_chain_v_run(const void* field, const void* e8, const void* T,
                           const void* scal, const void* dy, void* C,
                           void* mask, long long batch, int m, int n, int D,
                           int kr, int r, float thr, int do_rim,
                           unsigned long long* nmatch, void* stream) {
  const long long plane = (long long)m * n;
  if (batch <= 0 || plane <= 0) return (int)cudaSuccess;
  if (plane > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // int offsets
  const long long smem = pst_chain_v_bytes(m, D, kr, r, do_rim);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = pst_allow_smem(pst_chain_v_kernel<kCount>, smem,
                                         pst_chain_v_granted[kCount]);
  if (err != cudaSuccess) return (int)err;
  for (long long b0 = 0; b0 < batch; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid((n + CV_W - 1) / CV_W, (unsigned int)nb);
    pst_chain_v_kernel<kCount><<<grid, CV_WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const float*)field + b0 * plane, (const float*)e8 + b0 * 8,
        (const float*)T + b0 * 8 * 48, (const float*)scal + b0 * 3,
        (const float*)dy + b0 * plane, (float*)C + b0 * plane,
        (float*)mask + b0 * plane, m, n, D, kr + r, r, thr, do_rim, nmatch);
  }
  return (int)cudaGetLastError();
}

extern "C" int pst_chain_v(const void* field, const void* e8, const void* T,
                           const void* scal, const void* dy, void* C,
                           void* mask, long long batch, int m, int n, int D,
                           int kr, int r, float thr, int do_rim,
                           void* stream) {
  return pst_chain_v_run<false>(field, e8, T, scal, dy, C, mask, batch, m, n,
                                D, kr, r, thr, do_rim, nullptr, stream);
}

// pst_chain_v through the counting instantiation: the same outputs, and in
// *nmatch (one device word, zeroed here on the stream) the window pixels
// whose map the blocks stored, over the whole batch.
extern "C" int pst_chain_v_count(const void* field, const void* e8,
                                 const void* T, const void* scal,
                                 const void* dy, void* C, void* mask,
                                 long long batch, int m, int n, int D, int kr,
                                 int r, float thr, int do_rim, void* nmatch,
                                 void* stream) {
  const cudaError_t err =
      cudaMemsetAsync(nmatch, 0, sizeof(unsigned long long), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return pst_chain_v_run<true>(field, e8, T, scal, dy, C, mask, batch, m, n, D,
                               kr, r, thr, do_rim, (unsigned long long*)nmatch,
                               stream);
}

// What stage 1 asks of the card for these arguments, from its geometry
// and the occupancy API: its dynamic shared memory in bytes, the ring's
// rows, the blocks that fit on one SM and the pixels it should match for
// one member (each strip's window, every row).
extern "C" int pst_chain_v_info(int m, int n, int D, int kr, int r,
                                int do_rim, long long* smem, int* ring,
                                int* blocks_per_sm, long long* matches) {
  *smem = pst_chain_v_bytes(m, D, kr, r, do_rim);
  if (*smem == 0) return (int)cudaErrorInvalidValue;
  const CvGeom g = cv_geom(m, D, kr + r, do_rim);
  *ring = g.ring;
  *matches = 0;
  for (int j0 = 0; j0 < n; j0 += CV_W)
    *matches += (long long)m * (cv_min(n, j0 + CV_W + g.hc) - cv_max(0, j0 - g.hc));
  cudaError_t err = pst_allow_smem(pst_chain_v_kernel<false>, *smem,
                                   pst_chain_v_granted[0]);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pst_chain_v_kernel<false>, CV_WARPS * 32, (size_t)*smem);
  return (int)err;
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
