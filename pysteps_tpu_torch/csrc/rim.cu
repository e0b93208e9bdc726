// K4: bounded L1 distance rim (the incremental-mask grayscale rim).
//
// Replaces pysteps_tpu/ops/pallas_dilate.py::dilated_rim_from_field_pallas
// (kernel _rim_kernel_whole) and dilated_rim_pallas (kernel _rim_kernel).
//   wet(i, j) = x[i, j] >= thr (the field entry point), x[i, j] > 0 (the
//               mask entry point); NaN and out-of-field pixels never wet
//   d(i, j)   = min(R + 1, L1 distance to the nearest wet pixel)
//   rim       = clip((R + 1 - d) / (r + 1), 0, 1),   R = kr + r.
// L1 distance is separable, d is a small integer, and any d > R gives 0,
// so the result equals the TPU kernels' jump-doubling and 5-point stencil
// forms exactly.
//
// Design.  Bound on the H100: memory, one read of x and one write of the
// rim a pixel.  One launch, no scratch plane:
// - A block owns one member and a tile of RIM_W = 128 output columns (one
//   thread each) by H output rows.  It reads the window of rows
//   [i0 - R, i0 + H + R) and columns [j0 - R, j0 + RIM_W + R), clipped to
//   the field (out-of-field pixels are never wet, so clipping is exact),
//   once, and keeps only the ballot of each warp load: 1 bit a pixel in
//   shared memory, each row's words between two zero words.  A warp loads
//   RIM_ROWS rows at a time, each row from one 64-bit base with its words
//   at immediate offsets (24 loads in flight a warp at R <= 31), and
//   ballots with all lanes, so no divergence check sits around a ballot.
//   The halo's re-reads by neighbouring tiles mostly hit L2.
// - Each thread takes its column's horizontal distance on every window
//   row from the words: for R <= 31 three shared loads, two funnel shifts
//   and two leading-zero counts (rim_hdist_near, no cap: distances stop at
//   32), beyond that the word walk of pst_hdist (a second instantiation,
//   so neither carries the other's branch).  It runs the backward min-plus
//   from the window's last row up to the tile's first, keeping the tile's
//   values as bytes in shared memory, then the forward min-plus from the
//   window's first row down, and writes each row's rim from a table of
//   pst_rim_of over the distances: a warp writes 32 consecutive floats.
// - H is chosen at launch: the largest of 128, 64, 32, 16, 8 that still
//   gives 2 blocks an SM, so that a single 512^2 mask (the STEPS init)
//   fills the card (H 8: 256 blocks) and large batches pay little halo
//   (H 128: 1.19 window rows an output row at R = 12; 20,784 B of shared
//   memory).  At most 64 registers a thread keep 8 blocks of 128 threads
//   on an SM, so that some load while others sweep.  Offsets inside a
//   plane are 32-bit but each row's base, which is 64-bit, so every m x n
//   works; the batch launches in chunks of PST_MAX_GRID_YZ members.
// - The distances are bytes, so the tile kernel takes R <= RIM_MAX_R (as
//   chain stage 1 does); its shared memory is then at most 73,376 B.
//   Above that the entry point runs the two-pass kernels below (vertical
//   distances into the caller's float scratch plane, then the horizontal
//   pass), which take any R.
// Both take x as float (the field, or a float mask) or as bytes (a bool
// or uint8 mask), read as given: wet is (float)x > thr when `strict`,
// (float)x >= thr otherwise.
#include "common.cuh"

#define RIM_W 128       // output columns of a tile, one thread each
#define RIM_MAX_H 128   // output rows of a tile, at most
#define RIM_MIN_H 8
#define RIM_ROWS 4      // window rows a warp loads at a time
#define RIM_MIN_BLOCKS 8  // blocks an SM: at most 64 registers a thread
#define RIM_MAX_R 254   // byte distances hold R + 1

__device__ __forceinline__ bool rim_wet(float v, float thr, int strict) {
  return strict ? v > thr : v >= thr;
}

// Entries of the rim table: distances 0..R + 1, and up to 32 when
// R <= 31 (the funnel-shift distances stop at 32, see rim_hdist_near).
__host__ __device__ inline int rim_table_len(int R) { return R + 2 > 33 ? R + 2 : 33; }

// The tile kernel's shared-memory layout for tiles of H rows (byte
// offsets, each a multiple of 16), sized for the largest window: each
// window row's nw wet words between two zero words.
struct RimGeom {
  long long rim, g, bits, bytes;
};

__host__ __device__ inline RimGeom rim_geom(int m, int n, int R, int H) {
  RimGeom s;
  const long long rows = m < H + 2LL * R ? m : H + 2LL * R;
  const long long cols = n < RIM_W + 2LL * R ? n : RIM_W + 2LL * R;
  long long off = 0;
  s.rim = off;  off += (rim_table_len(R) * 4 + 15) / 16 * 16;  // pst_rim_of
  s.g = off;    off += (long long)H * RIM_W;  // backward distances
  s.bits = off; off += rows * ((cols + 31) / 32 + 2) * 4;  // wet words
  s.bytes = off;
  return s;
}

// Distance from bit `off` of word w[1] to the nearest wet bit within 31
// positions, 32 if none; w[0] and w[2] are the words on either side.  Not
// capped at R + 1: for R <= 31 a distance of 32 or more gives rim 0 like
// R + 1, and the min-plus sweep of values <= 32 stays <= 32.
__device__ __forceinline__ int rim_hdist_near(const unsigned* w, int off) {
  const unsigned cur = w[1];
  const unsigned left = __funnelshift_rc(w[0], cur, off + 1);  // bit 31: p
  const unsigned right = __funnelshift_r(cur, w[2], off);      // bit 0: p
  return min(__clz(left), __clz(__brev(right)));
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(RIM_W, RIM_MIN_BLOCKS) pst_rim_tile_kernel(
    const T* __restrict__ x, float thr, int strict, float* __restrict__ out,
    int m, int n, int R, int r, int H, unsigned int ncol) {
  extern __shared__ __align__(16) unsigned char sm[];
  const RimGeom s = rim_geom(m, n, R, H);
  float* srim = (float*)(sm + s.rim);
  unsigned char* sg = sm + s.g;
  unsigned* sbits = (unsigned*)(sm + s.bits);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = (int)(blockIdx.x % ncol) * RIM_W;
  const int i0 = (int)(blockIdx.x / ncol) * H;
  const int iend = i0 + min(H, m - i0);
  const int rs = max(0, i0 - R), re = iend + min(R, m - iend);  // window rows
  const int cs = max(0, j0 - R), ce = j0 + min(RIM_W + R, n - j0);  // columns
  const int rows = re - rs, wc = ce - cs, nw = (wc + 31) >> 5, ns = nw + 2;
  const long long plane = (long long)m * n;
  const T* xw = x + blockIdx.y * plane + (long long)rs * n + cs;

  for (int d = tid; d < rim_table_len(R); d += blockDim.x) srim[d] = pst_rim_of((float)d, R, r);
  for (int row = tid; row < rows; row += blockDim.x) {
    sbits[row * ns] = 0u;
    sbits[row * ns + nw + 1] = 0u;
  }
  // the window's wet words, word q of row k at sbits[k * ns + 1 + q]: a
  // warp takes RIM_ROWS rows at a time, each row's words kQ at a time (all
  // of them when R <= 31), every load issued before the ballots; a ballot
  // of all 32 lanes whatever the bounds (out of bounds reads as NaN, never
  // wet), so no branch around it
  constexpr int kWarps = RIM_W / 32;
  constexpr int kQ = (RIM_W + 62 + 31) / 32;  // words of a row when R <= 31
  const float nan = __int_as_float(0x7fffffff);
  for (int r0 = warp; r0 < rows; r0 += kWarps * RIM_ROWS) {
    for (int q0 = 0; q0 < nw; q0 += kQ) {
      float v[RIM_ROWS][kQ];
#pragma unroll
      for (int a = 0; a < RIM_ROWS; ++a) {
        const int row = r0 + a * kWarps;
        const T* xr = xw + (long long)min(row, rows - 1) * n + 32 * q0 + lane;
        const int left = row < rows ? wc - 32 * q0 - lane : 0;  // columns left
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq)
          v[a][qq] = 32 * qq < left ? (float)__ldg(xr + 32 * qq) : nan;
      }
#pragma unroll
      for (int a = 0; a < RIM_ROWS; ++a) {
        const int row = r0 + a * kWarps;
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) {
          const unsigned word = __ballot_sync(0xffffffffu, rim_wet(v[a][qq], thr, strict));
          if (lane == 0 && row < rows && q0 + qq < nw) sbits[row * ns + 1 + q0 + qq] = word;
        }
      }
    }
  }
  __syncthreads();

  const int c = tid;
  if (c >= min(RIM_W, n - j0)) return;
  const int p = j0 + c - cs;  // the column's window position
  // the horizontal distance on window row i
  const unsigned* wq = sbits + (p >> 5);
  auto hdist = [&](int i) {
    if constexpr (kWide) return pst_hdist(sbits + (i - rs) * ns + 1, nw, p, R);
    else return rim_hdist_near(wq + (i - rs) * ns, p & 31);
  };
  const int far = kWide ? R + 1 : 32;
  // backward min-plus from the window's last row; the tile's rows keep it
  int gd = far;
#pragma unroll 4
  for (int i = re - 1; i >= iend; --i) gd = min(hdist(i), gd + 1);
#pragma unroll 4
  for (int i = iend - 1; i >= i0; --i) {
    gd = min(hdist(i), gd + 1);
    sg[(i - i0) * RIM_W + c] = (unsigned char)gd;
  }
  // forward min-plus from the window's first row: the bounded distance
  int fd = far;
#pragma unroll 4
  for (int i = rs; i < i0; ++i) fd = min(hdist(i), fd + 1);
  float* o = out + blockIdx.y * plane + (long long)i0 * n + j0 + c;
#pragma unroll 4
  for (int i = i0; i < iend; ++i, o += n) {
    fd = min((int)sg[(i - i0) * RIM_W + c], fd + 1);
    *o = srim[fd];
  }
}

// The two-pass kernels for R > RIM_MAX_R: one thread a pixel, the vertical
// distances in a float scratch plane.
template <typename T>
__global__ void pst_rim_v_kernel(const T* __restrict__ x, float thr, int strict,
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
    const T* f = x + b * plane;
    int best = R + 1;
    const int lo = max(i - R, 0), hi = min(i + R, m - 1);
    for (int ii = lo; ii <= hi; ++ii) {
      if (rim_wet((float)f[(long long)ii * n + j], thr, strict))
        best = min(best, abs(ii - i));
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

static int pst_rim_sms[PST_MAX_DEVICES];
static long long pst_rim_granted[4][PST_MAX_DEVICES];

// The tile kernel's H for these arguments: the largest candidate that
// still gives 2 blocks an SM of the current card.
static cudaError_t rim_tile_h(long long batch, int m, int n, int* H) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= PST_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (pst_rim_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&pst_rim_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long ncol = (n + RIM_W - 1) / RIM_W;
  *H = RIM_MAX_H;
  while (*H > RIM_MIN_H &&
         batch * ncol * ((m + *H - 1) / *H) < 2LL * pst_rim_sms[dev])
    *H /= 2;
  return cudaSuccess;
}

template <typename T, bool kWide>
static int pst_rim_tile_launch(const T* x, float thr, int strict, float* out,
                               long long batch, int m, int n, int R, int r,
                               cudaStream_t stream) {
  int H = 0;
  cudaError_t err = rim_tile_h(batch, m, n, &H);
  if (err != cudaSuccess) return (int)err;
  const long long smem = rim_geom(m, n, R, H).bytes;
  err = pst_allow_smem(pst_rim_tile_kernel<T, kWide>, smem,
                       pst_rim_granted[2 * (sizeof(T) == 1) + kWide]);
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)m * n;
  const unsigned int ncol = (unsigned int)((n + RIM_W - 1) / RIM_W);
  const unsigned int nrow = (unsigned int)((m + H - 1) / H);
  for (long long b0 = 0; b0 < batch; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid(ncol * nrow, (unsigned int)nb);
    pst_rim_tile_kernel<T, kWide><<<grid, RIM_W, smem, stream>>>(
        x + b0 * plane, thr, strict, out + b0 * plane, m, n, R, r, H, ncol);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int pst_rim_tile(const T* x, float thr, int strict, float* out,
                        long long batch, int m, int n, int R, int r,
                        cudaStream_t stream) {
  return R <= 31
             ? pst_rim_tile_launch<T, false>(x, thr, strict, out, batch, m, n, R, r, stream)
             : pst_rim_tile_launch<T, true>(x, thr, strict, out, batch, m, n, R, r, stream);
}

template <typename T>
static int pst_rim_two_pass(const T* x, float thr, int strict, float* scratch,
                            float* out, long long batch, int m, int n, int R,
                            int r, cudaStream_t stream) {
  const long long total = batch * (long long)m * n;
  const unsigned int blocks = pst_blocks(total);
  pst_rim_v_kernel<T><<<blocks, PST_THREADS, 0, stream>>>(
      x, thr, strict, scratch, total, m, n, R);
  pst_rim_h_kernel<<<blocks, PST_THREADS, 0, stream>>>(scratch, out, total, m,
                                                       n, R, r);
  return (int)cudaGetLastError();
}

// x: (batch, m, n) float32 (is_bytes 0) or bool / uint8 (is_bytes 1); out
// float32 of the same shape; scratch a float32 plane of that shape when
// kr + r > RIM_MAX_R, else unused.
extern "C" int pst_rim(const void* x, int is_bytes, float thr, int strict,
                       void* scratch, void* out, long long batch, int m, int n,
                       int kr, int r, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  const int R = kr + r;
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= RIM_MAX_R) {
    return is_bytes ? pst_rim_tile((const unsigned char*)x, thr, strict, (float*)out,
                                   batch, m, n, R, r, s)
                    : pst_rim_tile((const float*)x, thr, strict, (float*)out,
                                   batch, m, n, R, r, s);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  return is_bytes ? pst_rim_two_pass((const unsigned char*)x, thr, strict,
                                     (float*)scratch, (float*)out, batch, m, n, R, r, s)
                  : pst_rim_two_pass((const float*)x, thr, strict, (float*)scratch,
                                     (float*)out, batch, m, n, R, r, s);
}

// The tile kernel's geometry for these arguments on the current card,
// computed, not measured: H, RIM_W, dynamic shared memory, blocks of the
// launch and blocks that fit on one SM (float input).
extern "C" int pst_rim_info(long long batch, int m, int n, int kr, int r,
                            int* H, int* W, long long* smem, long long* blocks,
                            int* blocks_per_sm) {
  const int R = kr + r;
  if (R > RIM_MAX_R || batch <= 0 || m <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = rim_tile_h(batch, m, n, H);
  if (err != cudaSuccess) return (int)err;
  *W = RIM_W;
  *smem = rim_geom(m, n, R, *H).bytes;
  *blocks = batch * ((n + RIM_W - 1) / RIM_W) * ((m + *H - 1) / *H);
  const bool wide = R > 31;
  const auto kernel = wide ? pst_rim_tile_kernel<float, true> : pst_rim_tile_kernel<float, false>;
  err = pst_allow_smem(kernel, *smem, pst_rim_granted[wide]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, RIM_W, (size_t)*smem);
}
