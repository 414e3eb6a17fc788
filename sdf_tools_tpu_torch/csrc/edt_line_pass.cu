// K1: dual binary line pass along axis 0 of a [X, Y, Z] mask (z fastest).
//
// Replaces the TPU kernel `_line_pass_dual_kernel` (sdf_tools_tpu/ops/
// edt_pallas.py:504, launched by `line_pass_dual_pallas`). For every (y, z)
// column it writes, from one read of the mask, the squared distance along x
// to the nearest True cell (field a) and to the nearest False cell (field b),
// or exactly INF_D2 where the column holds no such seed.
//
// Bound on Hopper: device memory. Per cell it reads the 1-byte mask once and
// writes two int32 values, re-reads them on the way back and writes them
// again (26 bytes per cell); the arithmetic is a handful of integer ops.
// Design: one thread per column, a forward sweep and a backward sweep along
// x (stride Y*Z). Neighbouring threads own neighbouring z, so every row
// access of a warp is one coalesced 32-byte (mask) or 128-byte (int32)
// transaction. The TPU kernel's blocking and VMEM sizing do not carry over;
// no shape is special-cased (any axis may have length 1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInfD2 = 1 << 29;

__global__ void line_pass_dual_kernel(const uint8_t* __restrict__ mask,
                                      int32_t* __restrict__ out_a,
                                      int32_t* __restrict__ out_b, int X,
                                      long long YZ) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= YZ) return;
  // BIG = X marks "no seed seen yet"; a real distance is at most X - 1.
  const int big = X;
  int ra = big, rb = big;
  for (int x = 0; x < X; ++x) {
    const long long o = x * YZ + c;
    const bool m = mask[o] != 0;
    ra = m ? 0 : min(ra + 1, big);
    rb = m ? min(rb + 1, big) : 0;
    out_a[o] = ra;
    out_b[o] = rb;
  }
  ra = big;
  rb = big;
  for (int x = X - 1; x >= 0; --x) {
    const long long o = x * YZ + c;
    const int fa = out_a[o];
    const int fb = out_b[o];
    // a forward distance of 0 is a seed of that field
    ra = fa == 0 ? 0 : min(ra + 1, big);
    rb = fb == 0 ? 0 : min(rb + 1, big);
    const int da = min(fa, ra);
    const int db = min(fb, rb);
    out_a[o] = da >= big ? kInfD2 : da * da;
    out_b[o] = db >= big ? kInfD2 : db * db;
  }
}

}  // namespace

extern "C" int sdf_line_pass_dual(const void* mask, void* out_a, void* out_b,
                                  int X, int Y, int Z, void* stream) {
  const long long yz = (long long)Y * Z;
  if (X <= 0 || yz <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (yz + threads - 1) / threads;
  line_pass_dual_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (int32_t*)out_a, (int32_t*)out_b, X, yz);
  return (int)cudaGetLastError();
}
