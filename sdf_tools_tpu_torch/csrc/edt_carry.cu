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
// neighbour that improved it; here every thread indexes the line directly,
// so each line's leftmost row minima J(i) are found by the monotone search
// of envelope_search.cuh (the one K2, K3 and K5 run), and the winner is J
// itself. The carried payload is one read of p_k at the winner, instead of
// a register copied along every relaxation step.
//
// Tie rule: the smallest j that attains the minimum (the search's J is the
// leftmost minimiser). The plain version (ops/edt_cuda.py) follows the same
// rule, so the two agree bitwise on d^2, winners and payloads. The TPU
// relaxation keeps whichever tied source reached the cell first, which is
// neither the first nor the last minimum; any minimiser is a correct
// nearest seed. A line with no finite entry comes out exactly INF_D2 with
// winner i (the j == i term is the unique minimum), as on the TPU. An axis
// of length 1 gives f itself, winner 0 and the payloads unchanged, as on
// the TPU. Axis lengths up to 16384 (the search's int16 J).
//
// Layouts, K5's: along axis 1 a [Y, zt] tile loaded coalesced along z and
// transposed into zt column lines, one warp per column; along axis 2 one
// warp per contiguous line, kAxis2Warps lines a block. Outputs go back the
// way the lines came in, so stores are coalesced; a carried payload is read
// at row J(i, col), which along axis 1 is a gather over up to 32 rows.
//
// Bound on Hopper: device memory once the work is O(log n) candidates per
// cell: 4 bytes read and 8 written per cell in the argmin form (0.48 ms at
// 3.35 TB/s for 512^3).

#include <cstdint>
#include <cuda_runtime.h>

#include "envelope_search.cuh"

namespace {

constexpr int kMaxPayloads = 3;

struct Payloads {
  const int32_t* in[kMaxPayloads];
  int32_t* out[kMaxPayloads];
  int n;
};

// Write cell `cell`'s minimum, winner and carried payloads; `line` is the
// flat index of the line's entry 0, `step` the stride along the line and
// (best, w) the cell's minimum and winner.
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

// Axis 1: block = one [Y, zt] tile of one x plane (axis1_tile), one warp
// per column.
__global__ void carry_axis1_kernel(const int32_t* __restrict__ f,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ win_out, Payloads p,
                                   int Y, int Z, int lzt, int n_ztiles,
                                   int ls) {
  extern __shared__ int32_t smem[];
  const int zt = 1 << lzt;
  int16_t* J = (int16_t*)(smem + (size_t)zt * ls);
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
    if (z0 + col >= Z) continue;
    const int32_t* fl = smem + col * ls;
    const int16_t* Jl = J + col * ls;
    store(base + (long long)i * Z + col, base + col, Z, envelope_from(fl, Jl, i), Jl[i], out, win_out, p);
  }
}

// Axis 2: each warp owns one (x, y) line (values at w * Z, J at
// warps * Z + w * Z), loads it, searches it and writes it back.
__global__ void carry_axis2_kernel(const int32_t* __restrict__ f,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ win_out, Payloads p,
                                   int Z, long long lines) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long line = (long long)blockIdx.x * warps + warp;
  if (line >= lines) return;
  int32_t* fl = smem + (size_t)warp * Z;
  int16_t* Jl = (int16_t*)(smem + (size_t)warps * Z) + (size_t)warp * Z;
  const long long base = line * Z;
  for (int i = lane; i < Z; i += 32) fl[i] = f[base + i];
  __syncwarp();
  search_line(fl, Jl, Z, lane);
  for (int i = lane; i < Z; i += 32) store(base + i, base, 1, envelope_from(fl, Jl, i), Jl[i], out, win_out, p);
}

int launch_axis1(const int32_t* f, int32_t* out, int32_t* win_out,
                 const Payloads& p, int X, int Y, int Z, cudaStream_t stream) {
  int limit = 0;
  int err = max_dynamic_smem(&limit);
  if (err) return err;
  int lzt = 0, ls = 0;
  const size_t bytes = axis1_tile(Y, Z, limit, &lzt, &ls);
  if (!bytes) return (int)cudaErrorInvalidValue;
  err = allow_smem(carry_axis1_kernel, bytes);
  if (err) return err;
  const int zt = 1 << lzt;
  const int n_ztiles = (Z + zt - 1) / zt;
  carry_axis1_kernel<<<(unsigned)((long long)X * n_ztiles), zt * 32, bytes,
                       stream>>>(f, out, win_out, p, Y, Z, lzt, n_ztiles, ls);
  return (int)cudaGetLastError();
}

int launch_axis2(const int32_t* f, int32_t* out, int32_t* win_out,
                 const Payloads& p, int X, int Y, int Z, cudaStream_t stream) {
  int limit = 0;
  int err = max_dynamic_smem(&limit);
  if (err) return err;
  // kAxis2Warps lines, fewer where they do not fit
  int warps = kAxis2Warps;
  while (warps > 1 && warps * line_bytes(Z) > (size_t)limit) --warps;
  const size_t bytes = warps * line_bytes(Z);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  err = allow_smem(carry_axis2_kernel, bytes);
  if (err) return err;
  const long long lines = (long long)X * Y;
  const long long blocks = (lines + warps - 1) / warps;
  carry_axis2_kernel<<<(unsigned)blocks, warps * 32, bytes, stream>>>(
      f, out, win_out, p, Z, lines);
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
  if ((axis == 1 ? Y : Z) > kMaxAxis) return (int)cudaErrorInvalidValue;
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
