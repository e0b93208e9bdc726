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
//
// pst_pwl_flat replaces pysteps_tpu/ops/pallas_histmatch.py::pwl_apply
// (kernel _pwl_kernel): out = (q0 + sum_j W0[j] * 1[x >= e_j])
//                             + x * sum_j W1[j] * 1[x >= e_j],   j = 0..127,
// W0 = (w0 + w1) + w2 and W1 = (w3 + w4) + w5 from the bf16x3 rows of
// w (8, 128), each term the IEEE product (an infinite or NaN weight gives
// NaN where its edge is not selected), summed in j order from +0.  The dry
// override stays with the caller, as in match_cdf_pwl_flat.
//
// Design.  Bound on the H100: memory, one read and one write of the field;
// both maps stream it through common.cuh's pst_stream (16-byte vectors),
// as K3 does, and evaluate it from prefix tables, as K3 and chain stage 1
// do.  build_pwl_coeffs sorts its edges, so the terms a value selects are
// a prefix 0..t-1 of the sorted edges and each later term is W * 0 = +-0,
// which leaves a running sum from +0 equal under ==.  A block builds its
// member's running sums in shared memory once, in the kernel's order with
// round-to-nearest intrinsics, so a value costs a search and one 8-byte
// load:
// - hierarchical: g from a 4-level tree over e16[1..15] (two levels in
//   registers) and one compare with e16[0], a 3-step search among row g's
//   7 fine edges, the row's (pb0 + S0[t], pb1 + S1[t]); 23 x 16 triple sums
//   a table, paid once per HIER_PIX pixels.  The block is half K3's: C's
//   102,400-pixel members take 13 blocks (1,248 for 96 members, 9.5 an SM
//   on 132 SMs), where 16,384 would leave one partial wave of 672 blocks
//   and 4,096 pays the table build twice as often;
// - flat: a 7-level tree over edges[1..127] (three levels in registers)
//   and one compare with edges[0], the table's (q0 + P0[t], P1[t]) of 129
//   entries; two threads sum the 128 terms in order, once per FLAT_PIX.
// The equality needs, per member, the searched edges nondecreasing and
// free of NaN and every summed term finite.  The block checks its member
// once; a member that fails takes the full sum out of line (a uniform
// branch), so every LUT, unsorted, NaN or infinite, gives the plain
// version's values.  The search trees are stored level by level, so each
// level of up to 32 nodes reads without bank conflicts; the rows of the
// hierarchical table have an odd stride.
#include "common.cuh"

#define HIER_PIX 8192     // pixels of a block, hierarchical map
#define HIER_LS 9         // row stride of its fine edges and prefix tables
#define FLAT_PIX 16384    // pixels of a block, flat map

// The hierarchical map's 7-term sum of one value from the full table sS
// (row 0 zeros, row g + 1 block g) for a LUT that fails the prefix check.
static __device__ __noinline__ float hier_sum_eval(float v, const float* se16,
                                                   const float* sS, float q0,
                                                   float zval, float ztrg) {
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
      q0, __fadd_rn(__fadd_rn(row[21], s0), __fmul_rn(v, __fadd_rn(row[22], s1))));
  return v == zval ? ztrg : o;
}

struct HierSumMap {
  const float* se16;
  const float* sS;
  float q0, zval, ztrg;
  __device__ __forceinline__ float operator()(float v) const {
    return hier_sum_eval(v, se16, sS, q0, zval, ztrg);
  }
};

// The hierarchical map of one value from the prefix tables.
struct HierPrefixMap {
  float e0, n1, n2, n3;  // e16[0] and the tree's top two levels
  const float* sK;       // the tree over e16[1..15], nodes 1..15
  const float* sE;       // row g's fine edges at g * HIER_LS
  const float2* sA;      // row g's (pb0 + S0[t], pb1 + S1[t]) at g * HIER_LS + t
  float q0, zval, ztrg;
  __device__ __forceinline__ float operator()(float v) const {
    int i = v >= n1 ? 3 : 2;
    i = 2 * i + (v >= (i == 3 ? n3 : n2) ? 1 : 0);
    i = 2 * i + (v >= sK[i] ? 1 : 0);
    i = 2 * i + (v >= sK[i] ? 1 : 0);  // 16 + #{k in 1..15 : v >= e16[k]}
    const int g = i - 16 + (v >= e0 ? 1 : 0);
    const float* e = sE + g * HIER_LS;
    int t = v >= e[3] ? 4 : 0;
    t += v >= e[t + 1] ? 2 : 0;
    t += v >= e[t] ? 1 : 0;
    const float2 a = sA[g * HIER_LS + t];
    const float o = __fadd_rn(q0, __fadd_rn(a.x, __fmul_rn(v, a.y)));
    return v == zval ? ztrg : o;
  }
};

// Build the hierarchical prefix tables from sS and se16; returns this
// thread's share of the check (the caller's __syncthreads_and of it says
// whether the member passed).  Threads 0-15 check row g + 1, thread 16 the
// block starts, threads 32-65 sum row r's d0 or d1 (rows 0-16; row 0's
// zeros give (+0, +0), so a value below e16[0] or NaN maps to
// q0 + (0 + x * 0) as in the full sum), threads 96-110 place the tree.
__device__ __forceinline__ int hier_prefix_build(const float* sS,
                                                 const float* se16, float2* sA,
                                                 float* sE, float* sK) {
  const int tid = threadIdx.x;
  int ok = 1;
  if (tid < 16) {
    const float* row = sS + (tid + 1) * 24;
    for (int f = 0; f < 6; ++f) ok &= row[f] <= row[f + 1] ? 1 : 0;  // NaN fails
    for (int f = 7; f < 21; ++f) ok &= isfinite(row[f]) ? 1 : 0;
  } else if (tid == 16) {
    for (int k = 0; k < 15; ++k) ok &= se16[k] <= se16[k + 1] ? 1 : 0;
  } else if (tid >= 32 && tid < 32 + 2 * 17) {
    const int r = (tid - 32) >> 1, c = tid & 1;
    const float* row = sS + r * 24;
    float* out = (float*)sA + 2 * r * HIER_LS + c;
    const float pb = row[21 + c];
    float acc = 0.0f;
    out[0] = __fadd_rn(pb, acc);
    for (int f = 0; f < 7; ++f) {
      acc = __fadd_rn(acc, __fmul_rn(row[7 + 7 * c + f], 1.0f));
      out[2 * (f + 1)] = __fadd_rn(pb, acc);
    }
  } else if (tid >= 96 && tid < 111) {
    const int i = tid - 95;
    sK[i] = se16[pst_tree_src(i, 4)];
  }
  for (int k = tid; k < 17 * 7; k += blockDim.x)
    sE[(k / 7) * HIER_LS + k % 7] = sS[(k / 7) * 24 + k % 7];
  return ok;
}

__global__ void __launch_bounds__(PST_STREAM_THREADS) pst_pwl_hier_kernel(
    const float* __restrict__ x, const float* __restrict__ e16,
    const float* __restrict__ M3, const float* __restrict__ scal,
    float* __restrict__ out, long long N) {
  __shared__ float sS[17 * 24];  // row 0 zeros, row g + 1 block g
  __shared__ float se16[16];
  __shared__ __align__(16) float2 sA[17 * HIER_LS];
  __shared__ float sE[17 * HIER_LS];
  __shared__ float sK[16];
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
  const bool fast = __syncthreads_and(hier_prefix_build(sS, se16, sA, sE, sK));
  const float* xb = x + b * N;
  float* ob = out + b * N;
  if (fast) {
    const HierPrefixMap map{se16[0], sK[1], sK[2], sK[3], sK, sE, sA, q0, zval, ztrg};
    pst_stream<PST_STREAM_THREADS, PST_STREAM_VEC>(xb, ob, N, HIER_PIX, map);
  } else {
    pst_stream<PST_STREAM_THREADS, PST_STREAM_VEC>(xb, ob, N, HIER_PIX,
                                       HierSumMap{se16, sS, q0, zval, ztrg});
  }
}

// The flat map's 128-term IEEE sums of U values, for a LUT that fails the
// prefix check: one table read serves the U values.
template <int U>
__device__ __forceinline__ void flat_sum(const float* v, float* o,
                                         const float4* sTab, float q0) {
  float a0[U], a1[U];
#pragma unroll
  for (int u = 0; u < U; ++u) a0[u] = a1[u] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < 128; ++j) {
    const float4 t = sTab[j];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float sf = v[u] >= t.x ? 1.0f : 0.0f;
      a0[u] = __fadd_rn(a0[u], __fmul_rn(t.y, sf));
      a1[u] = __fadd_rn(a1[u], __fmul_rn(t.z, sf));
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    o[u] = __fadd_rn(__fadd_rn(q0, a0[u]), __fmul_rn(v[u], a1[u]));
}

static __device__ __noinline__ float flat_sum1(float v, const float4* sTab, float q0) {
  float o;
  flat_sum<1>(&v, &o, sTab, q0);
  return o;
}

static __device__ __noinline__ float4 flat_sum4(float4 a, const float4* sTab, float q0) {
  const float v[4] = {a.x, a.y, a.z, a.w};
  float o[4];
  flat_sum<4>(v, o, sTab, q0);
  return make_float4(o[0], o[1], o[2], o[3]);
}

struct FlatSumMap {
  const float4* sTab;
  float q0;
  __device__ __forceinline__ float operator()(float v) const {
    return flat_sum1(v, sTab, q0);
  }
};

__device__ __forceinline__ float4 pst_map4(const FlatSumMap& map, float4 a) {
  return flat_sum4(a, map.sTab, map.q0);
}

// The flat map of one value from the prefix table.
struct FlatPrefixMap {
  float e0;
  float n[7];       // the tree's top three levels, nodes 1..7
  const float* sK;  // the tree over edges[1..127], nodes 1..127
  const float2* sA;  // (q0 + P0[t], P1[t]), t = 0..128
  __device__ __forceinline__ float operator()(float v) const {
    int i = v >= n[0] ? 3 : 2;
    i = 2 * i + (v >= (i == 3 ? n[2] : n[1]) ? 1 : 0);
    const float m = (i & 2) ? ((i & 1) ? n[6] : n[5]) : ((i & 1) ? n[4] : n[3]);
    i = 2 * i + (v >= m ? 1 : 0);
#pragma unroll
    for (int l = 0; l < 4; ++l) i = 2 * i + (v >= sK[i] ? 1 : 0);
    const int t = i - 128 + (v >= e0 ? 1 : 0);  // #{j : v >= edges[j]}
    const float2 a = sA[t];
    return __fadd_rn(a.x, __fmul_rn(v, a.y));
  }
};

__global__ void __launch_bounds__(PST_STREAM_THREADS) pst_pwl_flat_kernel(
    const float* __restrict__ x, const float* __restrict__ edges,
    const float* __restrict__ w, const float* __restrict__ q0s,
    float* __restrict__ out, long long N) {
  __shared__ float4 sTab[128];               // (e_j, W0_j, W1_j, 0)
  __shared__ __align__(16) float2 sA[129];   // (q0 + P0[t], P1[t])
  __shared__ float sK[128];                  // the tree, nodes 1..127
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const float* wb = w + b * 8 * 128;
  const float* eb = edges + b * 128;
  const float q0 = q0s[b];
  if (tid < 128) {
    sTab[tid] = make_float4(
        eb[tid], __fadd_rn(__fadd_rn(wb[tid], wb[128 + tid]), wb[256 + tid]),
        __fadd_rn(__fadd_rn(wb[384 + tid], wb[512 + tid]), wb[640 + tid]), 0.0f);
  } else if (tid < 255) {
    const int i = tid - 127;
    sK[i] = eb[pst_tree_src(i, 7)];
  }
  __syncthreads();
  int ok = 1;
  if (tid < 128) {
    const float4 t = sTab[tid];
    ok = isfinite(t.y) && isfinite(t.z) && (tid == 127 || t.x <= sTab[tid + 1].x);
  } else if (tid < 130) {
    // the running sums P0 or P1 over the edges in order, from +0
    const int c = tid - 128;
    const float* term = (const float*)sTab + 1 + c;
    float* dst = (float*)sA + c;
    float acc = 0.0f;
    dst[0] = c ? acc : __fadd_rn(q0, acc);
#pragma unroll 8
    for (int j = 0; j < 128; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(term[4 * j], 1.0f));
      dst[2 * (j + 1)] = c ? acc : __fadd_rn(q0, acc);
    }
  }
  const bool fast = __syncthreads_and(ok);
  const float* xb = x + b * N;
  float* ob = out + b * N;
  if (fast) {
    FlatPrefixMap map;
    map.e0 = sTab[0].x;
#pragma unroll
    for (int k = 0; k < 7; ++k) map.n[k] = sK[k + 1];
    map.sK = sK;
    map.sA = sA;
    pst_stream<PST_STREAM_THREADS, PST_STREAM_VEC>(xb, ob, N, FLAT_PIX, map);
  } else {
    pst_stream<PST_STREAM_THREADS, PST_STREAM_VEC>(xb, ob, N, FLAT_PIX, FlatSumMap{sTab, q0});
  }
}

// One launch a call (the member axis in grid.y, in chunks above 65,535).
template <typename Kernel>
static int pwlv_launch(Kernel kernel, long long pix, const void* x,
                       const void* lut0, long long lut0_stride, const void* lut1,
                       long long lut1_stride, const void* scal,
                       long long scal_stride, void* out, long long batch,
                       long long N, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  const long long nbx = (N + pix - 1) / pix;
  if (nbx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  for (long long b0 = 0; b0 < batch; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid((unsigned int)nbx, (unsigned int)nb);
    kernel<<<grid, PST_STREAM_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x + b0 * N, (const float*)lut0 + b0 * lut0_stride,
        (const float*)lut1 + b0 * lut1_stride, (const float*)scal + b0 * scal_stride,
        (float*)out + b0 * N, N);
  }
  return (int)cudaGetLastError();
}

extern "C" int pst_pwl_hier(const void* x, const void* e16, const void* M3,
                            const void* scal, void* out, long long batch,
                            long long N, void* stream) {
  return pwlv_launch(pst_pwl_hier_kernel, HIER_PIX, x, e16, 16, M3, 72 * 16,
                     scal, 3, out, batch, N, stream);
}

extern "C" int pst_pwl_flat(const void* x, const void* edges, const void* w,
                            const void* q0, void* out, long long batch,
                            long long N, void* stream) {
  return pwlv_launch(pst_pwl_flat_kernel, FLAT_PIX, x, edges, 128, w, 8 * 128,
                     q0, 1, out, batch, N, stream);
}
