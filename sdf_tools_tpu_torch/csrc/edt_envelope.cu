// K2, K3 and K5: the exact 1-D parabolic envelope of int32 d^2 fields,
//   out[i] = min_j f[j] + (i - j)^2,
// along axis 1 or axis 2 of contiguous [X, Y, Z] arrays (z fastest).
//
// Replaces the TPU kernels `_envelope_dual_kernel` (K2; sdf_tools_tpu/ops/
// edt_pallas.py:331, body `_relax_to_envelope` :297, launched by
// `envelope_dual_pallas`), `_envelope_dual_combine_kernel` (K3; :426,
// launched by `envelope_dual_combine_pallas`), which is the axis-2 envelope
// with the signed combine sqrt(a)*res - sqrt(b)*res as its epilogue, and
// `_envelope_kernel` (K5; :115, production branch :136-142, launched by
// `envelope_pass_pallas`), the same envelope of one field. The kernels below
// serve all three: one over a [Y, zt] tile (axis 1), one template over the
// number of fields and the combine (axis 2).
//
// The TPU kernels relax a k-tap stencil to quiescence because the TPU
// vector unit cannot index lanes dynamically. Here every thread can, and
// the kernels search each line's row minima instead of taking the brute
// minimum over the whole line for every cell (n candidates per cell, which
// made the first version of these kernels bound by integer instruction
// throughput).
//
// The search is envelope_search.cuh's (shared with K6): each line's
// leftmost row minima J(i), level by level, one warp per line.
//
// Bound on Hopper: device memory (one read and one write of int32 per cell
// and field) once the work is O(log n) candidates per cell. Along axis 2 a
// block holds kAxis2Warps lines; along axis 1 a [Y, zt] tile loaded
// coalesced along z and transposed into zt column lines, zt <= 32.
//
// Bit-equality of K3 with `edt.d2_to_distance(a) - d2_to_distance(b)`
// needs correctly rounded sqrt, multiply and subtract, and no contraction
// of `va*res - vb*res` into an FMA: the epilogue uses the _rn intrinsics and
// the library is built with -fmad=false and without fast math.

#include <cstdint>
#include <cuda_runtime.h>

#include "envelope_search.cuh"

namespace {

constexpr int32_t kInfD2 = 1 << 29;

__device__ __forceinline__ float d2_to_distance(int32_t d2, float res) {
  const float v = d2 >= kInfD2 ? __int_as_float(0x7f800000)
                               : __fsqrt_rn(__int2float_rn(d2));
  return __fmul_rn(v, res);
}

// Axis 1: block = one [Y, zt] tile of one x plane of one field
// (blockIdx.y selects the field; gridDim.y is the number of fields), zt a
// power of two (1 << lzt), one warp per column. The tile is loaded
// coalesced along z and stored transposed, column x as a line at x * ls
// (ls = 1 mod 32, so the transposing stores fall in distinct banks), J
// beside it; the outputs go back the same way.
__global__ void envelope_axis1_kernel(const int32_t* __restrict__ fa,
                                      const int32_t* __restrict__ fb,
                                      int32_t* __restrict__ oa,
                                      int32_t* __restrict__ ob, int Y, int Z,
                                      int lzt, int n_ztiles, int ls) {
  extern __shared__ int32_t smem[];
  const int zt = 1 << lzt;
  int16_t* J = (int16_t*)(smem + (size_t)zt * ls);
  const int32_t* f = blockIdx.y ? fb : fa;
  int32_t* o = blockIdx.y ? ob : oa;
  const long long x = blockIdx.x / n_ztiles;
  const int z0 = (blockIdx.x % n_ztiles) * zt;
  const long long base = x * Y * (long long)Z + z0;
  const int cells = Y << lzt;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int i = c >> lzt, col = c & (zt - 1);
    if (z0 + col < Z) smem[col * ls + i] = f[base + (long long)i * Z + col];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (z0 + warp < Z) search_line(smem + warp * ls, J + warp * ls, Y, threadIdx.x & 31);
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int i = c >> lzt, col = c & (zt - 1);
    if (z0 + col < Z)
      o[base + (long long)i * Z + col] = envelope_from(smem + col * ls, J + col * ls, i);
  }
}

// Axis 2: each warp owns one (x, y) line of one field in shared memory
// (warp w: values at w * Z, J at warps * Z + w * Z), loads it and searches
// it. kFields == 2: the warps of a line are adjacent, field a first; after
// one __syncthreads they share the line's cells for the output. kCombine
// writes the f32 signed distance instead of two d^2 lines.
template <int kFields, bool kCombine>
__global__ void envelope_axis2_kernel(const int32_t* __restrict__ fa,
                                      const int32_t* __restrict__ fb,
                                      int32_t* __restrict__ oa,
                                      int32_t* __restrict__ ob,
                                      float* __restrict__ out, float res,
                                      int Z, long long lines) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int field = warp % kFields;
  const long long line = (long long)blockIdx.x * (warps / kFields) + warp / kFields;
  int32_t* f = smem + (size_t)warp * Z;
  int16_t* J = (int16_t*)(smem + (size_t)warps * Z) + (size_t)warp * Z;
  const bool live = line < lines;
  const long long base = line * Z;
  if (live) {
    const int32_t* src = field ? fb : fa;
    for (int i = lane; i < Z; i += 32) f[i] = src[base + i];
    __syncwarp();
    search_line(f, J, Z, lane);
  }
  if (kFields == 2) __syncthreads();  // the other field's J
  if (!live) return;
  const int32_t* fl = f - (size_t)field * Z;  // field a of this line
  const int16_t* Jl = J - (size_t)field * Z;
  for (int i = field * 32 + lane; i < Z; i += 32 * kFields) {
    const int32_t ea = envelope_from(fl, Jl, i);
    if (kFields == 1) {
      oa[base + i] = ea;
      continue;
    }
    const int32_t eb = envelope_from(fl + Z, Jl + Z, i);
    if (kCombine) {
      out[base + i] = __fsub_rn(d2_to_distance(ea, res), d2_to_distance(eb, res));
    } else {
      oa[base + i] = ea;
      ob[base + i] = eb;
    }
  }
}

template <int kFields, bool kCombine>
int launch_axis2(const void* fa, const void* fb, void* oa, void* ob, void* out,
                 float res, int X, int Y, int Z, cudaStream_t stream) {
  if (Z > kMaxAxis) return (int)cudaErrorInvalidValue;
  int limit = 0;
  int err = max_dynamic_smem(&limit);
  if (err) return err;
  // kAxis2Warps warps, fewer where their lines do not fit
  int warps = kAxis2Warps;
  while (warps > kFields && warps * line_bytes(Z) > (size_t)limit) warps -= kFields;
  const size_t bytes = warps * line_bytes(Z);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  err = allow_smem(envelope_axis2_kernel<kFields, kCombine>, bytes);
  if (err) return err;
  const long long lines = (long long)X * Y;
  const int per_block = warps / kFields;
  const long long blocks = (lines + per_block - 1) / per_block;
  envelope_axis2_kernel<kFields, kCombine><<<(unsigned)blocks, warps * 32, bytes, stream>>>(
      (const int32_t*)fa, (const int32_t*)fb, (int32_t*)oa, (int32_t*)ob,
      (float*)out, res, Z, lines);
  return (int)cudaGetLastError();
}

int launch_axis1(const void* fa, const void* fb, void* oa, void* ob,
                 int n_fields, int X, int Y, int Z, cudaStream_t stream) {
  if (Y > kMaxAxis) return (int)cudaErrorInvalidValue;
  int limit = 0;
  int err = max_dynamic_smem(&limit);
  if (err) return err;
  int lzt = 0, ls = 0;
  const size_t bytes = axis1_tile(Y, Z, limit, &lzt, &ls);
  if (!bytes) return (int)cudaErrorInvalidValue;
  err = allow_smem(envelope_axis1_kernel, bytes);
  if (err) return err;
  const int zt = 1 << lzt;
  const int n_ztiles = (Z + zt - 1) / zt;
  const dim3 grid((unsigned)((long long)X * n_ztiles), n_fields);
  envelope_axis1_kernel<<<grid, zt * 32, bytes, stream>>>(
      (const int32_t*)fa, (const int32_t*)fb, (int32_t*)oa, (int32_t*)ob, Y, Z,
      lzt, n_ztiles, ls);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdf_envelope_dual(const void* fa, const void* fb, void* oa,
                                 void* ob, int X, int Y, int Z, int axis,
                                 void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return (int)cudaErrorInvalidValue;
  if (axis == 1)
    return launch_axis1(fa, fb, oa, ob, 2, X, Y, Z, (cudaStream_t)stream);
  if (axis == 2)
    return launch_axis2<2, false>(fa, fb, oa, ob, nullptr, 0.0f, X, Y, Z,
                                  (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sdf_envelope(const void* f, void* out, int X, int Y, int Z,
                            int axis, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return (int)cudaErrorInvalidValue;
  if (axis == 1)
    return launch_axis1(f, f, out, out, 1, X, Y, Z, (cudaStream_t)stream);
  if (axis == 2)
    return launch_axis2<1, false>(f, nullptr, out, nullptr, nullptr, 0.0f, X,
                                  Y, Z, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sdf_envelope_dual_combine(const void* fa, const void* fb,
                                         void* out, float res, int X, int Y,
                                         int Z, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return (int)cudaErrorInvalidValue;
  return launch_axis2<2, true>(fa, fb, nullptr, nullptr, out, res, X, Y, Z,
                               (cudaStream_t)stream);
}
