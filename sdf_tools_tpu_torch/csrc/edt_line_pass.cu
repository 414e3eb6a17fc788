// K1 and K4: binary line passes along axis 0 of a [X, Y, Z] mask (z fastest).
//
// K1 replaces the TPU kernel `_line_pass_dual_kernel` (sdf_tools_tpu/ops/
// edt_pallas.py:504, launched by `line_pass_dual_pallas`). For every (y, z)
// column it writes, from one read of the mask, the squared distance along x
// to the nearest True cell (field a) and to the nearest False cell (field b),
// or exactly INF_D2 where the column holds no such seed.
//
// K4 replaces `_line_pass_kernel` (edt_pallas.py:226, launched by
// `line_pass_pallas`): the True field alone, squared with INF_D2 (`square`)
// or as the linear distance with the 1 << 24 sentinel (the form the slabbed
// and sharded line passes combine across boundaries before squaring).
//
// Bound on Hopper: device memory. Per cell K1 reads the 1-byte mask once
// and writes two int32 values, re-reads them on the way back and writes them
// again (26 bytes per cell; K4 14); the arithmetic is a handful of integer
// ops. Design: one thread per column, a forward sweep and a backward sweep
// along x (stride Y*Z), shared by both kernels as a template over the number
// of fields. Neighbouring threads own neighbouring z, so every row access of
// a warp is one coalesced 32-byte (mask) or 128-byte (int32) transaction.
// The TPU kernel's blocking, VMEM sizing and Z == 1 reshape do not carry
// over; no shape is special-cased (any axis may have length 1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInfD2 = 1 << 29;
constexpr int32_t kLineSentinel = 1 << 24;

// Field 0's seeds are the True cells, field 1's the False cells.
template <int kFields>
__global__ void line_pass_kernel(const uint8_t* __restrict__ mask,
                                 int32_t* __restrict__ out_a,
                                 int32_t* __restrict__ out_b, int X,
                                 long long YZ, bool square) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= YZ) return;
  int32_t* const out[2] = {out_a, out_b};
  // BIG = X marks "no seed seen yet"; a real distance is at most X - 1.
  const int big = X;
  int r[kFields];
#pragma unroll
  for (int f = 0; f < kFields; ++f) r[f] = big;
  for (int x = 0; x < X; ++x) {
    const long long o = x * YZ + c;
    const bool m = mask[o] != 0;
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      const bool seed = f == 0 ? m : !m;
      r[f] = seed ? 0 : min(r[f] + 1, big);
      out[f][o] = r[f];
    }
  }
#pragma unroll
  for (int f = 0; f < kFields; ++f) r[f] = big;
  for (int x = X - 1; x >= 0; --x) {
    const long long o = x * YZ + c;
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      const int fwd = out[f][o];
      // a forward distance of 0 is a seed of that field
      r[f] = fwd == 0 ? 0 : min(r[f] + 1, big);
      const int d = min(fwd, r[f]);
      if (square)
        out[f][o] = d >= big ? kInfD2 : d * d;
      else
        out[f][o] = d >= big ? kLineSentinel : d;
    }
  }
}

template <int kFields>
int launch(const void* mask, void* out_a, void* out_b, int X, int Y, int Z,
           bool square, void* stream) {
  const long long yz = (long long)Y * Z;
  if (X <= 0 || yz <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (yz + threads - 1) / threads;
  line_pass_kernel<kFields><<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (int32_t*)out_a, (int32_t*)out_b, X, yz, square);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdf_line_pass_dual(const void* mask, void* out_a, void* out_b,
                                  int X, int Y, int Z, void* stream) {
  return launch<2>(mask, out_a, out_b, X, Y, Z, true, stream);
}

extern "C" int sdf_line_pass(const void* mask, void* out, int X, int Y, int Z,
                             int square, void* stream) {
  return launch<1>(mask, out, nullptr, X, Y, Z, square != 0, stream);
}
