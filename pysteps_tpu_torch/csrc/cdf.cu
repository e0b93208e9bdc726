// Exact empirical-CDF counts at 128 value edges, per member.
//
// Replaces pysteps_tpu/ops/pallas_histmatch.py::cdf_counts (kernel
// _cdf_kernel).  For member b:
//   out[b, j] = #{p : x[b, p] >= edges[b, j]},   j = 0..127,
// as f32 converted once from exact int32 counts.  Unsorted and duplicate
// edges count as they are, a NaN edge counts 0 and a NaN pixel counts under
// no edge (x >= NaN and NaN >= e are false).  The TPU kernel sums 0/1
// floats over (rows, 128) tiles and adds the tiles' parts in f32.
//
// Bound on the H100: bytes, one 4-byte read a pixel.  Comparing every pixel
// with every edge costs 128 compares and adds a pixel, far above that, so a
// block places each pixel among its member's edges, sorted once:
// - sort: thread j of the first 128 ranks edge j by the key (ordered bits
//   of the value, or the largest key where isnan: a NaN with its sign bit
//   set would otherwise land below -inf; then the index), so the sorted
//   edges S are nondecreasing with any NaN last (-0 before +0, which
//   compare equal) and x >= S[s] holds for a prefix of s;
// - search: k = #{s : x >= S[s]} in 0..128 by one compare with S[0] and a
//   7-level walk down the level-order tree over S[1..127] (common.cuh's
//   pst_tree_src, whose levels of up to 32 nodes read without bank
//   conflicts), the root in a register; a NaN pixel gets k = 0.  The walk
//   keeps the node's shared-memory address, so a level is one load, one
//   FSETP and either a SEL and an IMAD (form A) or two predicated IMADs
//   (form B): the levels alternate the forms, splitting the work between
//   the ALU and FMA pipes, which run integer and compare work at half rate;
// - histogram: one shared increment of bin k of the warp's own 129 bins
//   (ptxas makes it ATOMS.POPC.INC, which adds the lanes that share a bin
//   at once, so the dry pixels of a radar field, 70% of path E's in one
//   bin, cost no more than spread ones);
// - finish: warp 0 sums the 8 warps' bins and takes the suffix sums
//   cnt[s] = sum_{k > s} hist[k] = #{x >= S[s]} (a NaN edge's slot gets 0,
//   tied edges their tie's count), adds cnt[s] to the member's int32 count
//   of edge perm[s] with one atomicAdd per edge and block, and the block
//   that arrives last for its member writes the member's 128 counts as f32.
//   The entry point zeroes the counts and arrivals on the launch's stream.
// The pixels stream as 16-byte loads, CDF_VEC vectors of a thread in
// flight: the first issued before the sort, so that they arrive while it
// runs, each next before the current ones' increments.  A scalar head and
// tail take a member row off its 16-byte alignment and N not a multiple of
// 4.  The launch gives a member the number of blocks, within one wave of
// the card (SMs x resident blocks, from the occupancy API), that loads the
// busiest SM least, the fewest among ties, each with at least CDF_MIN_PIX
// pixels to pay for its sort: 4 a member for 96 members on 132 SMs.
#include "common.cuh"

#define CDF_K 128
#define CDF_BINS (CDF_K + 1)
#define CDF_THREADS 256
#define CDF_WARPS (CDF_THREADS / 32)
#define CDF_VEC 4         // 16-byte vectors of a thread in flight
#define CDF_MIN_PIX 8192  // fewest pixels of a block

// One level down the tree from the node at shared address ib (node i at
// tb + 4 i): ib = 2 ib + (x >= node ? c1 : c0), c0 = -tb, c1 = 4 - tb.
__device__ __forceinline__ unsigned cdf_step_a(unsigned ib, float x, unsigned c0,
                                               unsigned c1) {
  unsigned r;
  asm("{\n\t.reg .pred p;\n\t.reg .f32 e;\n\t.reg .u32 c;\n\t"
      "ld.shared.f32 e, [%1];\n\t"
      "setp.ge.f32 p, %2, e;\n\t"
      "selp.u32 c, %4, %3, p;\n\t"
      "mad.lo.u32 %0, %1, 2, c;\n\t}"
      : "=r"(r)
      : "r"(ib), "f"(x), "r"(c0), "r"(c1));
  return r;
}

__device__ __forceinline__ unsigned cdf_step_b(unsigned ib, float x, unsigned c0,
                                               unsigned c1) {
  asm("{\n\t.reg .pred p;\n\t.reg .f32 e;\n\t"
      "ld.shared.f32 e, [%0];\n\t"
      "setp.ge.f32 p, %1, e;\n\t"
      "@p mad.lo.u32 %0, %0, 2, %3;\n\t"
      "@!p mad.lo.u32 %0, %0, 2, %2;\n\t}"
      : "+r"(ib)
      : "f"(x), "r"(c0), "r"(c1));
  return ib;
}

// A thread's view of its block's tree and its warp's histogram.
struct CdfSearch {
  float root, e0;          // node 1 and S[0]
  unsigned n2, n3;         // the addresses of nodes 2 and 3
  unsigned c0, c1;         // the steps' constants
  unsigned h0, h1;         // leaf address to histogram address, x < / >= e0
  // the shared address of the warp's bin k = #{s : x >= S[s]}
  __device__ __forceinline__ unsigned slot(float x) const {
    unsigned ib;
    asm("{\n\t.reg .pred p;\n\tsetp.ge.f32 p, %1, %2;\n\tselp.u32 %0, %4, %3, p;\n\t}"
        : "=r"(ib)
        : "f"(x), "f"(root), "r"(n2), "r"(n3));
#pragma unroll
    for (int l = 0; l < 6; ++l)
      ib = (l & 1) ? cdf_step_a(ib, x, c0, c1) : cdf_step_b(ib, x, c0, c1);
    // ib = tb + 4 i, leaf i in 128..255: bin i - 128 + (x >= e0)
    unsigned ha;
    asm("{\n\t.reg .pred p;\n\t.reg .u32 c;\n\tsetp.ge.f32 p, %1, %2;\n\t"
        "selp.u32 c, %5, %4, p;\n\tadd.u32 %0, %3, c;\n\t}"
        : "=r"(ha)
        : "f"(x), "f"(e0), "r"(ib), "r"(h0), "r"(h1));
    return ha;
  }
};

__device__ __forceinline__ void cdf_add(unsigned ha) {
  asm volatile("red.shared.add.u32 [%0], 1;" ::"r"(ha));
}

__global__ void __launch_bounds__(CDF_THREADS, 4) pst_cdf_counts_kernel(
    const float* __restrict__ x, const float* __restrict__ edges,
    int* __restrict__ cnt, unsigned* __restrict__ arrive, float* __restrict__ out,
    long long N) {
  __shared__ unsigned long long sKey[CDF_K];  // sort key << 32 | index
  __shared__ float sS[CDF_K];                 // the sorted edges
  __shared__ int sPerm[CDF_K];                // sS[s] = edges[sPerm[s]]
  __shared__ float sK[CDF_K];                 // the tree, nodes 1..127
  __shared__ int sH[CDF_WARPS][CDF_BINS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.y;
  const float* xb = x + b * N;

  // this block's aligned vectors [v0, v1), counted from the member's head
  const uintptr_t xa = (uintptr_t)xb;
  long long head = (long long)((16 - (xa & 15)) & 15) / 4;
  if (head > N) head = N;
  const long long nv = (N - head) / 4, tail = head + 4 * nv;
  const long long per = (nv + gridDim.x - 1) / gridDim.x;
  const long long v0 = (long long)blockIdx.x * per;
  const long long v1 = v0 + per < nv ? v0 + per : nv;
  const float4* x4 = (const float4*)(xb + head);
  long long v = v0 + tid;
  float4 a[CDF_VEC];
#pragma unroll
  for (int k = 0; k < CDF_VEC; ++k) {
    const long long w = v + k * CDF_THREADS;
    if (w < v1) a[k] = __ldg(x4 + w);
  }

  // sort the member's edges by rank: ties by index, NaN last
  float e = 0.0f;
  if (tid < CDF_K) {
    e = edges[b * CDF_K + tid];
    const unsigned u = __float_as_uint(e);
    const unsigned key = isnan(e) ? 0xffffffffu : u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
    sKey[tid] = ((unsigned long long)key << 32) | (unsigned)tid;
  }
  for (int k = tid; k < CDF_WARPS * CDF_BINS; k += CDF_THREADS) (&sH[0][0])[k] = 0;
  __syncthreads();
  if (tid < CDF_K) {
    const unsigned long long kj = sKey[tid];
    int r = 0;
#pragma unroll 16
    for (int i = 0; i < CDF_K; ++i) r += sKey[i] < kj ? 1 : 0;
    sS[r] = e;
    sPerm[r] = tid;
  }
  __syncthreads();
  if (tid >= CDF_K && tid < 2 * CDF_K - 1) {
    const int i = tid - (CDF_K - 1);
    sK[i] = sS[pst_tree_src(i, 7)];
  }
  __syncthreads();
  const unsigned tb = (unsigned)__cvta_generic_to_shared(sK);
  CdfSearch srch;
  srch.root = sK[1];
  srch.e0 = sS[0];
  srch.n2 = tb + 8;
  srch.n3 = tb + 12;
  srch.c0 = 0u - tb;
  srch.c1 = 4u - tb;
  srch.h0 = (unsigned)__cvta_generic_to_shared(sH[warp]) - tb - 4 * CDF_K;
  srch.h1 = srch.h0 + 4;

  // the histogram of k = #{s : x >= sS[s]}
  for (;;) {
    unsigned ha[4 * CDF_VEC];
#pragma unroll
    for (int k = 0; k < CDF_VEC; ++k) {
      ha[4 * k] = srch.slot(a[k].x);
      ha[4 * k + 1] = srch.slot(a[k].y);
      ha[4 * k + 2] = srch.slot(a[k].z);
      ha[4 * k + 3] = srch.slot(a[k].w);
    }
    const long long vc = v;
    v += CDF_VEC * CDF_THREADS;
#pragma unroll
    for (int k = 0; k < CDF_VEC; ++k) {
      const long long w = v + k * CDF_THREADS;
      if (w < v1) a[k] = __ldg(x4 + w);
    }
#pragma unroll
    for (int k = 0; k < CDF_VEC; ++k) {
      if (vc + k * CDF_THREADS < v1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) cdf_add(ha[4 * k + q]);
      }
    }
    if (v >= v1) break;
  }
  if (blockIdx.x == 0) {
    for (long long p = tid; p < head; p += CDF_THREADS) cdf_add(srch.slot(xb[p]));
  }
  if (blockIdx.x == gridDim.x - 1) {
    for (long long p = tail + tid; p < N; p += CDF_THREADS) cdf_add(srch.slot(xb[p]));
  }
  __syncthreads();

  // warp 0: lane l holds bins 4l + 1 .. 4l + 4 (bin 0 counts under no edge)
  if (warp != 0) return;
  int c[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < CDF_WARPS; ++w) s += sH[w][4 * lane + 1 + q];
    c[q] = s;
  }
  c[2] += c[3];
  c[1] += c[2];
  c[0] += c[1];
  int above = c[0];  // inclusive suffix sum over the lanes, then exclusive
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_down_sync(0xffffffffu, above, d);
    if (lane + d < 32) above += t;
  }
  above -= c[0];
  int* cb = cnt + b * CDF_K;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = c[q] + above;  // #{x >= sS[4 lane + q]}
    if (n != 0) atomicAdd(cb + sPerm[4 * lane + q], n);
  }
  // the member's last block converts its counts
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(arrive + b, 1u) == gridDim.x - 1;
  if (__shfl_sync(0xffffffffu, last, 0)) {
    __threadfence();
    for (int j = lane; j < CDF_K; j += 32) out[b * CDF_K + j] = __int2float_rn(__ldcg(cb + j));
  }
}

extern "C" int pst_cdf_counts(const void* x, const void* edges, void* work, void* out,
                              long long batch, long long N, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // work: the int32 counts (batch, 128), then the arrivals (batch,)
  cudaError_t err = cudaMemsetAsync(work, 0, (size_t)batch * (CDF_K + 1) * sizeof(int), st);
  if (err == cudaSuccess && N <= 0)
    err = cudaMemsetAsync(out, 0, (size_t)batch * CDF_K * sizeof(float), st);
  if (err != cudaSuccess || N <= 0) return (int)err;
  // the card's SMs and the kernel's resident blocks an SM, read once per card
  static int sms[PST_MAX_DEVICES], per_sm[PST_MAX_DEVICES];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= PST_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0, r = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, pst_cdf_counts_kernel,
                                                          CDF_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    per_sm[dev] = r > 0 ? r : 1;
    sms[dev] = n;
  }
  // blocks a member p within one wave: the least busiest-SM share
  // ceil(batch p / SMs) / p of a member's pixels, the fewest p among ties
  long long hi = (long long)sms[dev] * per_sm[dev] / batch;
  if (hi > N / CDF_MIN_PIX) hi = N / CDF_MIN_PIX;
  long long per_member = 1, load = (batch + sms[dev] - 1) / sms[dev];
  for (long long p = 2; p <= hi; ++p) {
    const long long l = (batch * p + sms[dev] - 1) / sms[dev];
    if (l * per_member < load * p) {
      per_member = p;
      load = l;
    }
  }
  for (long long b0 = 0; b0 < batch; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid((unsigned int)per_member, (unsigned int)nb);
    pst_cdf_counts_kernel<<<grid, CDF_THREADS, 0, st>>>(
        (const float*)x + b0 * N, (const float*)edges + b0 * CDF_K,
        (int*)work + b0 * CDF_K, (unsigned*)work + batch * CDF_K + b0,
        (float*)out + b0 * CDF_K, N);
  }
  return (int)cudaGetLastError();
}
