// K7: the winner segment sum along one axis of contiguous [X, Y, Z] arrays
// (z fastest),
//   out[.., j, ..] = sum over i of g[.., i, ..] * [win[.., i, ..] == j],
// for f32 g and int16 or int32 winners; a winner outside [0, n) adds
// nowhere. It is the adjoint of the winner gather out[i] = prev[win[i]] of
// the feature transform (sdf_tools_tpu/ops/diff.py:_ft_bwd routes cotangents
// back through three of them per field).
//
// Replaces the TPU kernels `_segsum_axis0_kernel` (sdf_tools_tpu/ops/
// edt_pallas.py:736) and `_segsum_windowed_kernel` (:764), both behind the
// one `pallas_call` of `winner_segment_sum_pallas` (:857). The TPU kernels
// move the axis to the front (an XLA transpose) and pad the lanes; for
// every input row i they compare the whole output block against win[i] and
// add where it hits, O(n) work per cell. Both add each output's
// contributions in ascending i, starting from 0.0.
//
// Here one thread owns one line and walks it once in ascending i, so every
// output gets the same additions in the same order: the kernel is bitwise
// equal to the TPU kernels and to the plain version, with no atomics. The
// thread keeps the running sum of the current output row in a register and
// writes it when the winner changes; winner maps of the feature transform
// are monotone along the line, so each output is written once, rows no
// winner reaches are zero-filled as the walk passes them, and a row that is
// revisited (a map that is not monotone) is read back and continued. The
// kernel takes the axis itself: line c starts at (c / inner) * n * inner +
// c % inner and steps by `inner` (Y*Z, Z or 1), so along axes 0 and 1 the
// 32 threads of a warp read 32 neighbouring z, one coalesced row; along
// axis 2 each thread reads its own contiguous line, through L1.
//
// Bound on Hopper: device memory. Per cell it reads 4 bytes of g and 2 or 4
// of winner and writes 4 bytes; at 512^3 with int16 winners that is 1.34 GB,
// 0.40 ms at 3.35 TB/s. An axis of length 1 copies g, as the TPU wrapper
// returns g there whatever the winners.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename W>
__global__ void segsum_kernel(const float* __restrict__ g,
                              const W* __restrict__ win,
                              float* __restrict__ out, int n, long long inner,
                              long long lines) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= lines) return;
  const long long base = (c / inner) * n * inner + c % inner;
  if (n == 1) {
    out[base] = g[base];
    return;
  }
  int cur = -1;  // the output row whose sum is in acc
  int top = -1;  // every row <= top other than cur is already in out
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const long long o = base + i * inner;
    const int w = win[o];
    const float gi = g[o];
    if (w < 0 || w >= n) continue;
    if (w != cur) {
      if (cur >= 0) out[base + cur * inner] = acc;
      if (w > top) {
        for (int j = top + 1; j < w; ++j) out[base + j * inner] = 0.0f;
        top = w;
        acc = 0.0f;
      } else {
        acc = out[base + w * inner];
      }
      cur = w;
    }
    acc = __fadd_rn(acc, gi);
  }
  if (cur >= 0) out[base + cur * inner] = acc;
  for (int j = top + 1; j < n; ++j) out[base + j * inner] = 0.0f;
}

template <typename W>
int launch(const void* g, const void* win, void* out, int n, long long inner,
           long long lines, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (lines + threads - 1) / threads;
  segsum_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      (const float*)g, (const W*)win, (float*)out, n, inner, lines);
  return (int)cudaGetLastError();
}

}  // namespace

// win_bytes: 2 (int16 winners) or 4 (int32 winners).
extern "C" int sdf_winner_segment_sum(const void* g, const void* win,
                                      int win_bytes, void* out, int X, int Y,
                                      int Z, int axis, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || axis < 0 || axis > 2)
    return (int)cudaErrorInvalidValue;
  const long long dims[3] = {X, Y, Z};
  long long inner = 1;
  for (int a = axis + 1; a < 3; ++a) inner *= dims[a];
  const long long lines = (long long)X * Y * Z / dims[axis];
  const int n = (int)dims[axis];
  if (win_bytes == 2)
    return launch<int16_t>(g, win, out, n, inner, lines, (cudaStream_t)stream);
  if (win_bytes == 4)
    return launch<int32_t>(g, win, out, n, inner, lines, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
