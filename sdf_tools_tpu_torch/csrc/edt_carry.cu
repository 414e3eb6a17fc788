// K6: the exact 1-D parabolic envelope of one int32 d^2 field with its
// winner,
//   out[i] = min_j f[j] + (i - j)^2,   w[i] = the j that attains it,
// along axis 1 or axis 2 of a contiguous [X, Y, Z] array (z fastest), and up
// to three int32 payloads carried from the winner: q_k[i] = p_k[w[i]]
// (same line). The argmin form writes w itself; the carry form writes the
// carried payloads instead.
//
// Replaces the TPU kernel `_envelope_carry_kernel` (sdf_tools_tpu/ops/
// edt_pallas.py:581, launched by `envelope_carry_pallas` and, with an iota
// payload, by `envelope_argmin_pallas`). The TPU kernel relaxes a k-tap
// stencil to quiescence and lets each cell inherit the payload of the
// neighbour that improved it; here, as in K2 (edt_envelope.cu), every thread
// indexes the line directly, so each cell takes the brute minimum over its
// line in shared memory and keeps the winner beside it. The carried payload
// is then one read of p_k at the winner, instead of a register copied along
// every relaxation step.
//
// Tie rule: the smallest j that attains the minimum (j ascending, strict <).
// The plain version (ops/edt_cuda.py) follows the same rule, so the two
// agree bitwise on d^2, winners and payloads. The TPU relaxation keeps
// whichever tied source reached the cell first, which is neither the first
// nor the last minimum; any minimiser is a correct nearest seed.
// A line with no finite entry comes out exactly INF_D2 with winner i (the
// j == i term is the unique minimum), as on the TPU. An axis of length 1
// gives f itself, winner 0 and the payloads unchanged, as on the TPU.
//
// Bound on Hopper: integer instructions, as K2: n (add, mul, compare, two
// selects) per cell, about 1.4e11 (cell, source) pairs per launch at 512^3,
// against 4 bytes read and 8 written per cell in the argmin form (0.48 ms
// of memory time at 3.35 TB/s). Shared-memory reads are conflict-free as in
// K2: broadcast along axis 2, 32 consecutive words along axis 1.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPayloads = 3;

struct Payloads {
  const int32_t* in[kMaxPayloads];
  int32_t* out[kMaxPayloads];
  int n;
};

// (min, first argmin) over j of s[j*stride] + (i-j)^2, one line of n
// entries in shared memory. Every sum is < 2^31 (INF_D2 + (n-1)^2 for
// n <= 16384), so INT_MAX is above all of them.
__device__ __forceinline__ int32_t argmin_at(const int32_t* s, int stride,
                                             int n, int i, int* win) {
  int32_t best = INT_MAX;
  int w = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const int d = i - j;
    const int32_t v = s[j * stride] + d * d;
    if (v < best) {
      best = v;
      w = j;
    }
  }
  *win = w;
  return best;
}

// Write cell `cell`'s minimum, winner and carried payloads; `line` is the
// flat index of the line's entry 0 and `step` the stride along the line.
__device__ __forceinline__ void store(long long cell, long long line,
                                      long long step, int32_t best, int w,
                                      int32_t* __restrict__ out,
                                      int32_t* __restrict__ win_out,
                                      const Payloads& p) {
  out[cell] = best;
  if (win_out) win_out[cell] = w;
  const long long src = line + w * step;
  for (int k = 0; k < p.n; ++k) p.out[k][cell] = p.in[k][src];
}

// Axis 1: block = one [Y, zt] tile of one x plane. blockDim = (zt, kThreads / zt).
__global__ void carry_axis1_kernel(const int32_t* __restrict__ f,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ win_out, Payloads p,
                                   int Y, int Z, int zt, int n_ztiles) {
  extern __shared__ int32_t tile[];  // [Y][zt]
  const long long x = blockIdx.x / n_ztiles;
  const int z = (blockIdx.x % n_ztiles) * zt + threadIdx.x;
  const long long base = x * Y * (long long)Z + z;
  if (z < Z) {
    for (int i = threadIdx.y; i < Y; i += blockDim.y)
      tile[i * zt + threadIdx.x] = f[base + (long long)i * Z];
  }
  __syncthreads();
  if (z >= Z) return;
  for (int i = threadIdx.y; i < Y; i += blockDim.y) {
    int w;
    const int32_t best = argmin_at(tile + threadIdx.x, zt, Y, i, &w);
    store(base + (long long)i * Z, base, Z, best, w, out, win_out, p);
  }
}

// Axis 2: block = one (x, y) line in shared memory.
__global__ void carry_axis2_kernel(const int32_t* __restrict__ f,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ win_out, Payloads p,
                                   int Z) {
  extern __shared__ int32_t line[];  // [Z]
  const long long base = blockIdx.x * (long long)Z;
  for (int i = threadIdx.x; i < Z; i += blockDim.x) line[i] = f[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < Z; i += blockDim.x) {
    int w;
    const int32_t best = argmin_at(line, 1, Z, i, &w);
    store(base + i, base, 1, best, w, out, win_out, p);
  }
}

int smem_limit(int* bytes) {
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

int launch_axis1(const int32_t* f, int32_t* out, int32_t* win_out,
                 const Payloads& p, int X, int Y, int Z, cudaStream_t stream) {
  int limit = 0;
  int err = smem_limit(&limit);
  if (err) return err;
  // widest z tile (<= one warp) whose [Y, zt] int32 tile fits
  int zt = Z < 32 ? Z : 32;
  while (zt > 1 && (size_t)Y * zt * sizeof(int32_t) > (size_t)limit) zt /= 2;
  const size_t bytes = (size_t)Y * zt * sizeof(int32_t);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  err = allow_smem(carry_axis1_kernel, bytes);
  if (err) return err;
  const int n_ztiles = (Z + zt - 1) / zt;
  const dim3 block(zt, kThreads / zt > 0 ? kThreads / zt : 1);
  carry_axis1_kernel<<<(unsigned)((long long)X * n_ztiles), block, bytes,
                       stream>>>(f, out, win_out, p, Y, Z, zt, n_ztiles);
  return (int)cudaGetLastError();
}

int launch_axis2(const int32_t* f, int32_t* out, int32_t* win_out,
                 const Payloads& p, int X, int Y, int Z, cudaStream_t stream) {
  int limit = 0;
  int err = smem_limit(&limit);
  if (err) return err;
  const size_t bytes = (size_t)Z * sizeof(int32_t);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  err = allow_smem(carry_axis2_kernel, bytes);
  if (err) return err;
  const int threads = Z >= kThreads ? kThreads : ((Z + 31) / 32) * 32;
  carry_axis2_kernel<<<(unsigned)((long long)X * Y), threads, bytes,
                       stream>>>(f, out, win_out, p, Z);
  return (int)cudaGetLastError();
}

}  // namespace

// win may be null (carry form); payload pointers past n_payload are ignored.
extern "C" int sdf_envelope_carry(const void* f, void* out, void* win,
                                  int n_payload, const void* in0,
                                  const void* in1, const void* in2,
                                  void* out0, void* out1, void* out2, int X,
                                  int Y, int Z, int axis, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return (int)cudaErrorInvalidValue;
  if (n_payload < 0 || n_payload > kMaxPayloads)
    return (int)cudaErrorInvalidValue;
  Payloads p;
  p.in[0] = (const int32_t*)in0;
  p.in[1] = (const int32_t*)in1;
  p.in[2] = (const int32_t*)in2;
  p.out[0] = (int32_t*)out0;
  p.out[1] = (int32_t*)out1;
  p.out[2] = (int32_t*)out2;
  p.n = n_payload;
  const int32_t* fi = (const int32_t*)f;
  int32_t* o = (int32_t*)out;
  int32_t* w = (int32_t*)win;
  if (axis == 1)
    return launch_axis1(fi, o, w, p, X, Y, Z, (cudaStream_t)stream);
  if (axis == 2)
    return launch_axis2(fi, o, w, p, X, Y, Z, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
