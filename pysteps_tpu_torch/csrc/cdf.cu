// Exact empirical-CDF counts at 128 value edges, per member.
//
// Replaces pysteps_tpu/ops/pallas_histmatch.py::cdf_counts (kernel
// _cdf_kernel).  For member b:
//   out[b, j] = #{p : x[b, p] >= edges[b, j]},   j = 0..127,
// in int32.  Every edge is compared with every pixel, so unsorted and
// duplicate edges count as they are, a NaN edge counts 0 and a NaN pixel
// counts under no edge (x >= NaN and NaN >= e are false).  The TPU kernel
// sums 0/1 floats over (rows, 128) tiles and adds the tiles' parts in f32;
// here the counts stay integers, and the wrapper converts them to f32 once.
//
// Design: grid (pixel blocks, members).  A lane keeps 4 edges of its member
// in registers (edges lane, lane + 32, lane + 64, lane + 96), so one warp
// holds all 128.  The warp walks chunks of 128 pixels: it loads a chunk
// (coalesced, out-of-range pixels as NaN) into its own shared-memory row,
// and every lane then reads the chunk back 4 pixels at a time with one
// broadcast 16-byte load and compares them with its 4 edges.  At the end
// the block sums its 8 warps' counts in shared memory and adds them with
// one integer atomicAdd per edge into `out`, which the entry point zeroes
// on the launch's stream first.
// Bound on the H100: bytes, one 4-byte read a pixel.  The function needs
// about 9 operations a pixel: sorted once per block with their indices,
// the 128 edges split the line into 129 intervals, so an 8-compare search
// and one increment of a 129-bin histogram, then a suffix sum, give the
// same exact counts for unsorted, duplicate and NaN edges.  This design
// compares every edge instead, 128 compares and 128 adds a pixel, at about
// 2.4 instructions per compare and add (an FSETP, then integer selects and
// adds that nvcc builds from the 0/1 results): issue-bound, far above the
// bound.  That search is the redesign left for later.
#include "common.cuh"

#define CDF_K 128
#define CDF_CHUNK 128  // pixels a warp takes per step
#define CDF_WARPS (PST_THREADS / 32)
#define CDF_MAX_DEVICES 64

__global__ void pst_cdf_counts_kernel(const float* __restrict__ x,
                                      const float* __restrict__ edges,
                                      int* __restrict__ out, long long N) {
  __shared__ float4 sX[CDF_WARPS][CDF_CHUNK / 4];
  __shared__ int sCount[CDF_WARPS][CDF_K];
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float e[4];
  int c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[k] = edges[b * CDF_K + lane + 32 * k];
    c[k] = 0;
  }
  const float* xb = x + b * N;
  float* row = reinterpret_cast<float*>(sX[warp]);
  const long long n_chunks = (N + CDF_CHUNK - 1) / CDF_CHUNK;
  const long long warps = (long long)gridDim.x * CDF_WARPS;
  for (long long ch = (long long)blockIdx.x * CDF_WARPS + warp; ch < n_chunks;
       ch += warps) {
    const long long base = ch * CDF_CHUNK;
#pragma unroll
    for (int u = 0; u < CDF_CHUNK / 32; ++u) {
      const long long p = base + lane + 32 * u;
      row[lane + 32 * u] = p < N ? xb[p] : __int_as_float(0x7fc00000);
    }
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < CDF_CHUNK / 4; ++i) {
      const float4 v = sX[warp][i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[k] += (v.x >= e[k]) + (v.y >= e[k]) + (v.z >= e[k]) + (v.w >= e[k]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sCount[warp][lane + 32 * k] = c[k];
  __syncthreads();
  for (int j = threadIdx.x; j < CDF_K; j += blockDim.x) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < CDF_WARPS; ++w) s += sCount[w][j];
    if (s != 0) atomicAdd(out + b * CDF_K + j, s);
  }
}

extern "C" int pst_cdf_counts(const void* x, const void* edges, void* out,
                              long long batch, long long N, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)batch * CDF_K * sizeof(int), st);
  if (err != cudaSuccess || N <= 0) return (int)err;
  // the card's SM count, read once per card
  static int sm_count[CDF_MAX_DEVICES];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= CDF_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // about 32 blocks per SM in all, so that each block's 128 atomics are few
  // beside its pixels, and no more blocks than a member has chunks for
  const long long chunks = (N + CDF_CHUNK - 1) / CDF_CHUNK;
  long long per_member = (sm_count[dev] * 32LL + batch - 1) / batch;
  const long long need = (chunks + CDF_WARPS - 1) / CDF_WARPS;
  if (per_member > need) per_member = need;
  if (per_member < 1) per_member = 1;
  for (long long b0 = 0; b0 < batch; b0 += PST_MAX_GRID_YZ) {
    const long long nb = batch - b0 < PST_MAX_GRID_YZ ? batch - b0 : PST_MAX_GRID_YZ;
    dim3 grid((unsigned int)per_member, (unsigned int)nb);
    pst_cdf_counts_kernel<<<grid, PST_THREADS, 0, st>>>(
        (const float*)x + b0 * N, (const float*)edges + b0 * CDF_K,
        (int*)out + b0 * CDF_K, N);
  }
  return (int)cudaGetLastError();
}
