// K1: bounded-displacement axis resample.
//
// Replaces pysteps_tpu/ops/pallas_warp.py::pallas_resample0 (kernel
// _resample0_kernel) and its wrapper axis_resample_pallas:
//   out[b, i, j] = lerp(f[b, i0, j], f[b, i0 + 1, j], frac)   (axis 0)
// with i0 = idx0 clipped first to [i - D, i + D] (the D given, unrounded)
// and then to [0, m - 1].  Axis 1 is the same map along the columns.
// idx0/frac may be shared by `rep` consecutive fields (the two velocity
// channels of warp_shifted_multi): field b reads plane b / rep.
//
// Bound on the H100: memory.  Each output reads one field value, the index
// and the fraction of its plane once per `rep` fields, and writes one float.
// At the main path's 192 x 128^2 a launch has 3.1 M outputs, so the first
// design (a 1-D grid-stride loop with two 64-bit divisions an element, the
// axis a runtime branch, each index plane read once per field) was bound
// by its index arithmetic.  This design:
// - a 3-D grid (column tiles, row tiles, index planes) with 32-bit offsets
//   inside a plane: no division;
// - one template instantiation per axis and per vector width;
// - one thread per 4 columns of a row (VEC = 4, when n % 4 == 0 and the
//   streams are 16-byte aligned): idx0, frac and out move as 16-byte
//   vectors, and the thread keeps its clipped taps in registers for all
//   `rep` fields of its plane, so each index plane is read once;
// - axis 1 stages the block's source rows, the window [j0 - D, j0 + 32 VEC
//   + D + 1) clipped to the field, in shared memory one field at a time and
//   gathers from there;
// - axis 0 gathers straight from the field: with the smooth displacements
//   of advection a warp's taps fall on one or two source rows, which L1
//   serves, where a staged band of 2D + 1 extra rows would read more.
// Left on the table: idx0/frac are computed by a separate elementwise pass
// in PyTorch (floor of the coordinates) and written to device memory;
// computing them in the kernel from the displacement, as K2 does, would
// remove two of the four streams, and one launch could do both axes.
#include "common.cuh"

#define RS_TR 8  // rows of a block (one warp each)

template <int AXIS, int VEC>
__global__ void __launch_bounds__(32 * RS_TR) pst_resample_kernel(
    const float* __restrict__ field, const int* __restrict__ idx0,
    const float* __restrict__ frac, float* __restrict__ out, int m, int n,
    int rep, int D, int Dw) {
  extern __shared__ float srow[];  // axis 1: RS_TR rows of the window
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.y * RS_TR + ty;
  const int j0 = blockIdx.x * 32 * VEC;
  const int j = j0 + tx * VEC;
  const int plane = m * n;
  const bool live = i < m && j < n;  // VEC = 4 needs n % 4 == 0
  const int q = live ? i * n + j : 0;
  const long long p = blockIdx.z;    // index plane; fields p*rep .. +rep-1

  int k0[VEC], k1[VEC];
  float w[VEC];
  if (live) {
    int kv[VEC];
    if constexpr (VEC == 4) {
      const int4 a = *reinterpret_cast<const int4*>(idx0 + p * plane + q);
      const float4 c = *reinterpret_cast<const float4*>(frac + p * plane + q);
      kv[0] = a.x; kv[1] = a.y; kv[2] = a.z; kv[3] = a.w;
      w[0] = c.x; w[1] = c.y; w[2] = c.z; w[3] = c.w;
    } else {
      kv[0] = idx0[p * plane + q];
      w[0] = frac[p * plane + q];
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const int pos = AXIS == 0 ? i : j + u;
      const int size = AXIS == 0 ? m : n;
      const int k = pst_clamp(kv[u], pos - D, pos + D);
      k0[u] = pst_clamp(k, 0, size - 1);
      k1[u] = pst_clamp(k + 1, 0, size - 1);
    }
  }

  // axis 1: the window of source columns the block's taps can reach
  const int lo = max(j0 - Dw, 0);
  const int sw = (int)min((long long)j0 + 32 * VEC + Dw + 1, (long long)n) - lo;
  float* mine = srow + ty * sw;
  for (int r = 0; r < rep; ++r) {
    const long long fi = p * rep + r;
    const float* f = field + fi * plane;
    float o[VEC];
    if constexpr (AXIS == 1) {
      __syncthreads();  // the previous field's gathers are done
      if (i < m)
        for (int t = tx; t < sw; t += 32) mine[t] = f[i * n + lo + t];
      __syncthreads();
      if (live) {
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          o[u] = pst_lerp(mine[k0[u] - lo], mine[k1[u] - lo], w[u]);
      }
    } else if (live) {
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        o[u] = pst_lerp(__ldg(f + k0[u] * n + j + u), __ldg(f + k1[u] * n + j + u), w[u]);
    }
    if (live) {
      float* dst = out + fi * plane + q;
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      else
        dst[0] = o[0];
    }
  }
}

template <int AXIS, int VEC>
static int pst_resample_launch(const float* field, const int* idx0,
                               const float* frac, float* out, long long planes,
                               int rep, int m, int n, int D,
                               cudaStream_t stream) {
  // a clip wider than the axis is no clip: keeps pos +- D and the window
  // inside int
  const int size = AXIS == 0 ? m : n;
  const int Dc = D > size ? size : (D < -size ? -size : D);
  const int Dw = Dc < 0 ? -Dc : Dc;
  long long smem = 0;
  if constexpr (AXIS == 1) {
    static long long granted[PST_MAX_DEVICES];
    const long long sw = (long long)32 * VEC + 2LL * Dw + 1;
    smem = (long long)RS_TR * (sw < n ? sw : n) * sizeof(float);
    const cudaError_t err =
        pst_allow_smem(pst_resample_kernel<AXIS, VEC>, smem, granted);
    if (err != cudaSuccess) return (int)err;
  }
  const long long plane = (long long)m * n;
  const dim3 block(32, RS_TR);
  for (long long p0 = 0; p0 < planes; p0 += PST_MAX_GRID_YZ) {
    const long long np = planes - p0 < PST_MAX_GRID_YZ ? planes - p0 : PST_MAX_GRID_YZ;
    const dim3 grid((n + 32 * VEC - 1) / (32 * VEC), (m + RS_TR - 1) / RS_TR,
                    (unsigned int)np);
    pst_resample_kernel<AXIS, VEC><<<grid, block, smem, stream>>>(
        field + p0 * rep * plane, idx0 + p0 * plane, frac + p0 * plane,
        out + p0 * rep * plane, m, n, rep, Dc, Dw);
  }
  return (int)cudaGetLastError();
}

static bool pst_aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15) == 0;
}

extern "C" int pst_resample(const void* field, const void* idx0,
                            const void* frac, void* out, long long batch,
                            int rep, int m, int n, int D, int axis,
                            void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  if ((long long)m * n > 0x7fffffffLL || rep <= 0 || batch % rep != 0)
    return (int)cudaErrorInvalidValue;
  const long long planes = batch / rep;
  const bool vec = n % 4 == 0 && pst_aligned16(idx0) && pst_aligned16(frac) &&
                   pst_aligned16(out);
  const float* f = (const float*)field;
  const int* k = (const int*)idx0;
  const float* w = (const float*)frac;
  float* o = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (axis == 0)
    return vec ? pst_resample_launch<0, 4>(f, k, w, o, planes, rep, m, n, D, s)
               : pst_resample_launch<0, 1>(f, k, w, o, planes, rep, m, n, D, s);
  return vec ? pst_resample_launch<1, 4>(f, k, w, o, planes, rep, m, n, D, s)
             : pst_resample_launch<1, 1>(f, k, w, o, planes, rep, m, n, D, s);
}
