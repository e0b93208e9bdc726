// Shared launch helpers and device arithmetic for the hand-written Hopper
// kernels of pysteps_tpu_torch.  Every entry point has a plain C interface
// (loaded with ctypes), launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() so that the Python wrapper can raise on a
// refused launch.  The __device__ helpers below are the arithmetic that the
// standalone kernels and the fused chain share, so both compute the same
// values operation for operation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PST_THREADS 256
// grid.y / grid.z limit: batch axes longer than this launch in chunks
#define PST_MAX_GRID_YZ 65535LL
#define PST_MAX_DEVICES 64

// Grid for a grid-stride loop over `total` elements: enough blocks to fill
// the card many times over, capped so huge batches still launch.
static inline unsigned int pst_blocks(long long total, int per_thread = 1) {
  long long b = (total + (long long)PST_THREADS * per_thread - 1) /
                ((long long)PST_THREADS * per_thread);
  if (b < 1) b = 1;
  if (b > 132LL * 64) b = 132LL * 64;
  return (unsigned int)b;
}

// Raise a kernel's dynamic shared-memory limit on the current card to
// `smem` when that is above the 48 KB default.  `granted` (one array per
// kernel) keeps the largest size set on each card, so the attribute is
// set once.  Above the card's 227 KB the attribute is refused: the error
// is returned and cleared, so that the next launch's check does not see it.
template <typename Kernel>
static cudaError_t pst_allow_smem(Kernel kernel, long long smem,
                                  long long* granted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= PST_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(smem < (1LL << 30) ? smem : (1LL << 30)));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  granted[dev] = smem;
  return cudaSuccess;
}

__device__ __forceinline__ int pst_clamp(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// lerp written with round-to-nearest intrinsics so nvcc cannot contract it
// into an FMA: the result then equals the plain PyTorch version's
// a * (1 - w) + c * w operation for operation.
__device__ __forceinline__ float pst_lerp(float a, float c, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(c, w));
}

// The two taps of a bounded backward lerp along one axis (K2 and the
// chain): c = pos + disp, k = floor(c) clipped to [pos - D, pos + D], taps
// k and k + 1 clipped to [0, size - 1], weight c - floor(c).  `c` is kept
// unclipped for the in-domain test.
struct PstTap {
  int k0, k1;
  float w, c;
};

__device__ __forceinline__ PstTap pst_tap(int pos, float disp, int D,
                                          int size) {
  PstTap t;
  t.c = __fadd_rn((float)pos, disp);
  const float f = floorf(t.c);
  t.w = __fsub_rn(t.c, f);
  const int k = pst_clamp((int)f, pos - D, pos + D);
  t.k0 = pst_clamp(k, 0, size - 1);
  t.k1 = pst_clamp(k + 1, 0, size - 1);
  return t;
}

// K3's block-gathered PWL map of one value (K3 and the chain).  `se8`
// holds the 8 block starts, `sT` the (8, 48) table of pack_gather_lut:
//   idx  = #{g in 1..7 : v >= se8[g]}
//   acc0 = T[idx, 45] + sum_j T[idx, 15 + j] * 1[v >= T[idx, j]]   j = 0..14
//   acc1 = T[idx, 46] + sum_j T[idx, 30 + j] * 1[v >= T[idx, j]]
//   out  = (q0 + acc0) + v * acc1, and ztrg where v == zval,
// summed in the TPU kernel's order with no FMA contraction.
__device__ __forceinline__ float pst_pwl_gather_eval(float v,
                                                     const float* se8,
                                                     const float* sT,
                                                     float q0, float zval,
                                                     float ztrg) {
  int idx = 0;
#pragma unroll
  for (int g = 1; g < 8; ++g) idx += v >= se8[g] ? 1 : 0;
  const float* row = sT + idx * 48;
  float acc0 = row[45];
  float acc1 = row[46];
#pragma unroll
  for (int j = 0; j < 15; ++j) {
    const float sf = v >= row[j] ? 1.0f : 0.0f;
    acc0 = __fadd_rn(acc0, __fmul_rn(row[15 + j], sf));
    acc1 = __fadd_rn(acc1, __fmul_rn(row[30 + j], sf));
  }
  const float o = __fadd_rn(__fadd_rn(q0, acc0), __fmul_rn(v, acc1));
  return v == zval ? ztrg : o;
}

// Block-wide copy of one member's gather LUT into shared memory; the
// caller synchronises before use.
__device__ __forceinline__ void pst_pwl_gather_load(const float* e8,
                                                    const float* T,
                                                    float* se8, float* sT) {
  for (int k = threadIdx.x; k < 8 * 48; k += blockDim.x) sT[k] = T[k];
  if (threadIdx.x < 8) se8[threadIdx.x] = e8[threadIdx.x];
}

// K3's map from per-member prefix tables (K3 and chain stage 1).
// pack_gather_lut sorts its edges, so within a row of T the fine terms a
// value selects are a prefix 0..t-1, and the 15-term sum equals its running
// sum stopped at t: each later term is d * 0 = +-0, which leaves the sum
// equal under ==.  The block builds the running sums of each row in K3's
// order (__fadd_rn of __fmul_rn(d, 1)); a value then costs 7 block-start
// compares, a 4-step search among its row's fine edges and one 8-byte
// load, in place of 45 loads.  The equality needs every row's edges
// nondecreasing and free of NaN and every d0/d1 term finite: the block
// checks its member's LUT once and otherwise takes the 15-term sum of
// pst_pwl_gather_eval (pst_pwl_sum_eval, a uniform branch), so any LUT
// gives K3's values.  The tables have an odd row stride, so rows start on
// distinct banks.
#define PST_PWL_LS 17

// Build the prefix tables of the LUT sT (8, 48) in shared memory: sP the
// (8, PST_PWL_LS) float2 running sums (acc0, acc1) after t = 0..15 terms,
// sE the (8, PST_PWL_LS) fine edges.  Threads 0-7 check a row each,
// threads 8-23 sum a row's d0 or d1 (blockDim.x >= 24).  Returns this
// thread's share of the check: the caller's __syncthreads_and of it (the
// barrier before the tables are read) says whether the LUT passed.
__device__ __forceinline__ int pst_pwl_prefix_build(const float* sT,
                                                    float2* sP, float* sE) {
  const int tid = threadIdx.x;
  int ok = 1;
  if (tid < 8) {
    const float* row = sT + tid * 48;
    for (int j = 0; j < 14; ++j) ok &= row[j] <= row[j + 1] ? 1 : 0;  // NaN fails
    for (int j = 15; j < 45; ++j) ok &= isfinite(row[j]) ? 1 : 0;
  } else if (tid < 24) {
    const int gi = (tid - 8) >> 1, c = tid & 1;
    const float* row = sT + gi * 48;
    float* out = (float*)sP + 2 * gi * PST_PWL_LS + c;
    float acc = row[45 + c];
    out[0] = acc;
    for (int j = 0; j < 15; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(row[15 + 15 * c + j], 1.0f));
      out[2 * (j + 1)] = acc;
    }
  }
  for (int k = tid; k < 8 * 15; k += blockDim.x)
    sE[(k / 15) * PST_PWL_LS + k % 15] = sT[(k / 15) * 48 + k % 15];
  return ok;
}

// The map of one value from the prefix tables, e8r the 8 block starts in
// registers: equal under == to pst_pwl_gather_eval when the LUT passed the
// check.
__device__ __forceinline__ float pst_pwl_prefix_eval(
    float v, const float* e8r, const float* sE, const float2* sP, float q0,
    float zval, float ztrg) {
  int idx = 0;
#pragma unroll
  for (int g = 1; g < 8; ++g) idx += v >= e8r[g] ? 1 : 0;
  const float* e = sE + idx * PST_PWL_LS;
  // t = #{j : v >= e[j]}, the selected prefix of the sorted fine edges
  int t = v >= e[7] ? 8 : 0;
  t += v >= e[t + 3] ? 4 : 0;
  t += v >= e[t + 1] ? 2 : 0;
  t += v >= e[t] ? 1 : 0;
  const float2 acc = sP[idx * PST_PWL_LS + t];
  const float o = __fadd_rn(__fadd_rn(q0, acc.x), __fmul_rn(v, acc.y));
  return v == zval ? ztrg : o;
}

// K3's 15-term sum for a LUT that fails the prefix-table check; out of
// line, so the prefix path's registers stay its own.
static __device__ __noinline__ float pst_pwl_sum_eval(float v, const float* se8,
                                                      const float* sT, float q0,
                                                      float zval, float ztrg) {
  return pst_pwl_gather_eval(v, se8, sT, q0, zval, ztrg);
}

// The streaming loop of the three PWL maps (K3 in pwl.cu, the hierarchical
// and flat maps in pwl_variants.cu).  A block maps the pixels
// [blockIdx.x * pix, + pix) of one member, `pix` a multiple of 4, through
// `map`: a functor whose operator()(float) maps one value.  Pixels stream
// as 16-byte loads and stores, kVec vectors of a thread in flight, when the
// member's input and output rows share their alignment modulo 16 bytes; the
// up to 3 pixels before the first aligned vector (block 0) and after the
// last (the last block) go scalar.  Otherwise (an input view off its
// alignment against the fresh output) the member goes scalar.  Any N.
// pst_map4 maps a vector; a map that does better on 4 values at once (the
// flat map's fallback) overloads it.
template <class Map>
__device__ __forceinline__ float4 pst_map4(const Map& map, float4 a) {
  float4 o;
  o.x = map(a.x);
  o.y = map(a.y);
  o.z = map(a.z);
  o.w = map(a.w);
  return o;
}

template <int kThreads, class Map>
__device__ __forceinline__ void pst_stream_scalar(const float* xb, float* ob,
                                                  long long p0, long long p1,
                                                  const Map& map) {
  for (long long p = p0 + threadIdx.x; p < p1; p += kThreads) ob[p] = map(xb[p]);
}

#define PST_STREAM_THREADS 256  // threads of a block of the three PWL maps
#define PST_STREAM_VEC 4        // 16-byte vectors of a thread in flight

template <int kThreads, int kVec, class Map>
__device__ __forceinline__ void pst_stream(const float* xb, float* ob,
                                           long long N, long long pix,
                                           const Map& map) {
  const long long p0 = (long long)blockIdx.x * pix;
  const long long p1 = p0 + pix < N ? p0 + pix : N;
  const uintptr_t xa = (uintptr_t)xb, oa = (uintptr_t)ob;
  if (((xa ^ oa) & 15) != 0) {
    pst_stream_scalar<kThreads>(xb, ob, p0, p1, map);
    return;
  }
  // the member's aligned vectors [head, head + 4 nv); pix is a multiple
  // of 4, so each block's vectors are whole
  long long head = (long long)((16 - (xa & 15)) & 15) / 4;
  if (head > N) head = N;
  const long long nv = (N - head) / 4, tail = head + 4 * nv;
  if (blockIdx.x == 0) pst_stream_scalar<kThreads>(xb, ob, 0, head, map);
  if (blockIdx.x == gridDim.x - 1) pst_stream_scalar<kThreads>(xb, ob, tail, N, map);
  // vectors whose first pixel, counted from head, lies in [p0, p1)
  const long long v0 = p0 / 4;
  const long long v1 = (p1 / 4 < nv) ? p1 / 4 : nv;
  const float4* x4 = (const float4*)(xb + head);
  float4* o4 = (float4*)(ob + head);
  for (long long v = v0 + threadIdx.x; v < v1; v += kVec * kThreads) {
    float4 a[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long w = v + k * kThreads;
      if (w < v1) a[k] = __ldg(x4 + w);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long w = v + k * kThreads;
      if (w < v1) o4[w] = pst_map4(map, a[k]);
    }
  }
}

// Node i (1 .. 2^L - 1) of the implicit search tree (level order, children
// 2i and 2i + 1) over the sorted values e[1 .. 2^L - 1]: the index into e of
// its value.  After L steps i = 2i + (v >= node i), i - 2^L counts the
// values at or below v when e is nondecreasing and free of NaN.  A level of
// at most 32 nodes lies in distinct banks, so a warp reads it with no
// conflict however its lanes descend.
__device__ __forceinline__ int pst_tree_src(int i, int L) {
  const int d = 31 - __clz(i);
  return (2 * (i - (1 << d)) + 1) << (L - 1 - d);
}

// Rim value of a bounded L1 distance d (a small integer held in a float):
// clip((R + 1 - d) / (r + 1), 0, 1), R = kr + r (K4 and the chain).
__device__ __forceinline__ float pst_rim_of(float d, int R, int r) {
  const float rim = __fdiv_rn(__fsub_rn((float)(R + 1), d), (float)(r + 1));
  return fminf(fmaxf(rim, 0.0f), 1.0f);
}

// Distance from window position p to the nearest wet bit within R
// positions, R + 1 if none; w holds the row's nw wet words (K4 and the
// chain).  For R <= 31 two funnel shifts bring the 32 positions on either
// side of p into one word each; a wider rim walks the words.
__device__ __forceinline__ int pst_hdist(const unsigned* w, int nw, int p,
                                         int R) {
  if (R <= 31) {
    const int q = p >> 5, off = p & 31;
    const unsigned cur = w[q];
    const unsigned prev = q > 0 ? w[q - 1] : 0u;
    const unsigned next = q + 1 < nw ? w[q + 1] : 0u;
    const unsigned left = __funnelshift_rc(prev, cur, off + 1);  // bit 31: p
    const unsigned right = __funnelshift_r(cur, next, off);      // bit 0: p
    const int dl = __clz(left), dr = right ? __ffs(right) - 1 : 32;
    return min(min(dl, dr), R + 1);
  }
  int best = R + 1;
  int q = p >> 5, base = q << 5;
  unsigned bits = w[q] & (0xffffffffu >> (31 - (p & 31)));
  for (;;) {  // leftward: the highest wet position <= p
    if (bits) {
      best = min(best, p - (base + 31 - __clz(bits)));
      break;
    }
    if (q == 0 || p - base + 1 > R) break;
    --q;
    base -= 32;
    bits = w[q];
  }
  q = p >> 5;
  base = q << 5;
  bits = w[q] & (0xffffffffu << (p & 31));
  for (;;) {  // rightward: the lowest wet position >= p
    if (bits) {
      best = min(best, base + __ffs(bits) - 1 - p);
      break;
    }
    if (q + 1 >= nw || base + 32 - p > R) break;
    ++q;
    base += 32;
    bits = w[q];
  }
  return best;
}
