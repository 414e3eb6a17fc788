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
// are templates over the number of fields (two for K2/K3, one for K5).
//
// The TPU kernels relax a k-tap stencil to quiescence because the TPU
// vector unit cannot index lanes dynamically. Here every thread can, so the
// first version is the brute per-cell minimum over a line held in shared
// memory: exact by construction, no stack, no division, no special case.
// A line with no finite entry comes out exactly INF_D2 (the j == i term),
// and INF_D2 + (n-1)^2 < 2^31 for n <= 16384, so nothing overflows.
//
// Bound on Hopper: integer arithmetic, not memory. The work is n (add, mul,
// min) triples per cell, about 3e11 integer ops for the 512^3 signed field,
// against one read and one write of int32 per cell and field. The design
// keeps every read of f[j] in shared memory and makes it conflict-free:
// along axis 2 all threads of a warp read the same f[j] (a broadcast);
// along axis 1 a block holds a [Y, zt] tile loaded coalesced along z, and
// thread (i, z) reads f[j, z], so a warp reads 16 or 32 consecutive words.
// The tile is the widest zt <= 32 that leaves room for three blocks per SM
// (at Y = 1024 that is zt = 16, 64 KB), so that enough warps hide the
// shared-memory latency. A per-line Meijster/Felzenszwalb scan (O(n) per
// line, as K9 does) is later work.
//
// Bit-equality of K3 with `edt.d2_to_distance(a) - d2_to_distance(b)`
// needs correctly rounded sqrt, multiply and subtract, and no contraction
// of `va*res - vb*res` into an FMA: the epilogue uses the _rn intrinsics and
// the library is built with -fmad=false and without fast math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInfD2 = 1 << 29;
constexpr int kThreads = 256;

// min_j s[j*stride] + (i-j)^2 over one line of n entries in shared memory.
__device__ __forceinline__ int32_t envelope_at(const int32_t* s, int stride,
                                               int n, int i) {
  int32_t best = s[i * stride];
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const int d = i - j;
    best = min(best, s[j * stride] + d * d);
  }
  return best;
}

__device__ __forceinline__ float d2_to_distance(int32_t d2, float res) {
  const float v = d2 >= kInfD2 ? __int_as_float(0x7f800000)
                               : __fsqrt_rn(__int2float_rn(d2));
  return __fmul_rn(v, res);
}

// Axis 1: block = one [Y, zt] tile of one x plane of one field
// (blockIdx.y selects the field; gridDim.y is the number of fields).
// blockDim = (zt, kThreads / zt).
__global__ void envelope_axis1_kernel(const int32_t* __restrict__ fa,
                                      const int32_t* __restrict__ fb,
                                      int32_t* __restrict__ oa,
                                      int32_t* __restrict__ ob, int Y, int Z,
                                      int zt, int n_ztiles) {
  extern __shared__ int32_t tile[];  // [Y][zt]
  const int32_t* f = blockIdx.y ? fb : fa;
  int32_t* o = blockIdx.y ? ob : oa;
  const long long x = blockIdx.x / n_ztiles;
  const int z = (blockIdx.x % n_ztiles) * zt + threadIdx.x;
  const long long base = x * Y * (long long)Z + z;
  if (z < Z) {
    for (int i = threadIdx.y; i < Y; i += blockDim.y)
      tile[i * zt + threadIdx.x] = f[base + (long long)i * Z];
  }
  __syncthreads();
  if (z >= Z) return;
  for (int i = threadIdx.y; i < Y; i += blockDim.y)
    o[base + (long long)i * Z] = envelope_at(tile + threadIdx.x, zt, Y, i);
}

// Axis 2: block = one (x, y) line of each field, side by side in shared
// memory. kCombine (two fields) writes the f32 signed distance instead of
// two d^2 lines.
template <int kFields, bool kCombine>
__global__ void envelope_axis2_kernel(const int32_t* __restrict__ fa,
                                      const int32_t* __restrict__ fb,
                                      int32_t* __restrict__ oa,
                                      int32_t* __restrict__ ob,
                                      float* __restrict__ out, float res,
                                      int Z) {
  extern __shared__ int32_t line[];  // [kFields][Z]
  const long long base = blockIdx.x * (long long)Z;
  for (int i = threadIdx.x; i < Z; i += blockDim.x) {
    line[i] = fa[base + i];
    if (kFields == 2) line[Z + i] = fb[base + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Z; i += blockDim.x) {
    const int32_t ea = envelope_at(line, 1, Z, i);
    if (kFields == 1) {
      oa[base + i] = ea;
      continue;
    }
    const int32_t eb = envelope_at(line + Z, 1, Z, i);
    if (kCombine) {
      out[base + i] = __fsub_rn(d2_to_distance(ea, res), d2_to_distance(eb, res));
    } else {
      oa[base + i] = ea;
      ob[base + i] = eb;
    }
  }
}

int max_dynamic_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Opt in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int kFields, bool kCombine>
int launch_axis2(const void* fa, const void* fb, void* oa, void* ob, void* out,
                 float res, int X, int Y, int Z, cudaStream_t stream) {
  int limit = 0;
  int err = max_dynamic_smem(&limit);
  if (err) return err;
  const size_t bytes = kFields * (size_t)Z * sizeof(int32_t);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  err = allow_smem(envelope_axis2_kernel<kFields, kCombine>, bytes);
  if (err) return err;
  const int threads = Z >= kThreads ? kThreads : ((Z + 31) / 32) * 32;
  const long long lines = (long long)X * Y;
  envelope_axis2_kernel<kFields, kCombine><<<(unsigned)lines, threads, bytes, stream>>>(
      (const int32_t*)fa, (const int32_t*)fb, (int32_t*)oa, (int32_t*)ob,
      (float*)out, res, Z);
  return (int)cudaGetLastError();
}

int launch_axis1(const void* fa, const void* fb, void* oa, void* ob,
                 int n_fields, int X, int Y, int Z, cudaStream_t stream) {
  int limit = 0;
  int err = max_dynamic_smem(&limit);
  if (err) return err;
  // widest z tile (<= one warp) whose [Y, zt] int32 tile leaves room for
  // three blocks per SM (one column if none does)
  int zt = Z < 32 ? Z : 32;
  while (zt > 1 && (size_t)Y * zt * sizeof(int32_t) > (size_t)limit / 3) zt /= 2;
  const size_t bytes = (size_t)Y * zt * sizeof(int32_t);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  err = allow_smem(envelope_axis1_kernel, bytes);
  if (err) return err;
  const int n_ztiles = (Z + zt - 1) / zt;
  const dim3 block(zt, kThreads / zt > 0 ? kThreads / zt : 1);
  const dim3 grid((unsigned)((long long)X * n_ztiles), n_fields);
  envelope_axis1_kernel<<<grid, block, bytes, stream>>>(
      (const int32_t*)fa, (const int32_t*)fb, (int32_t*)oa, (int32_t*)ob, Y, Z,
      zt, n_ztiles);
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
