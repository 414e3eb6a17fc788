// K9: the exact 1-D parabolic envelope along axis 1 of a contiguous int32
// [X, Y, Z] array (z fastest), by its lower envelope per line,
//   out[i] = min_j f[j] + (i - j)^2,  then  out[i] > kClamp -> INF_D2,
// for a scan axis of at most 1024 (axis 2 runs on the transposed volume).
//
// Replaces the TPU kernel `_cht_kernel` (sdf_tools_tpu/ops/edt_cht.py:176,
// launched by `_envelope_cht_axis1` :221 under `envelope_pass_cht` :260).
// The TPU kernel keeps the convex hull in K fixed register slots per lane
// because its vector unit cannot index lanes dynamically; it flags blocks
// whose hull overflows K and the host recomputes them with the relaxation.
// A Hopper thread can index freely, so this kernel keeps the whole hull of
// its line and needs no cap, no overflow flag and no fallback; its result
// is exact either way, so it is the same function.
//
// kClamp (3 * 1024^2 + 1024, from the global 1024 and not from Y) is the
// TPU kernel's bound on a real output: a larger value came from no source
// and becomes INF_D2. A source with f > kClamp can therefore only produce
// values above kClamp and is left out of the hull; a line with no source
// left is INF_D2 everywhere.
//
// Design: one thread per line (x, z), 32 lines per block, so that at each
// step the 32 threads of a warp read and write 32 consecutive z (coalesced).
// A forward pass over the line builds the lower envelope of the parabolas
// p_j(i) = f[j] + (i - j)^2 (Felzenszwalb-Huttenlocher), keeping the hull's
// source indices as int16 in shared memory ([Y][32]: 64 KB at Y = 1024);
// a second pass walks the hull while it writes the outputs. The take-over
// test compares the break points s(b, q) <= s(a, b), s(p, r) =
// (g_r - g_p) / (2 (r - p)) with g = f + j^2, by exact 64-bit integer
// cross-multiplication (|g| < 2^23, |r - p| < 2^10), and the evaluation
// advances while the next parabola is not above the current one at i: no
// division and no float. The f of a hull entry is read again from global
// memory (L2 holds the block's lines) instead of a second shared array,
// which would halve the blocks per SM.
//
// Bound on Hopper: device memory in principle (one int32 read and one
// write per cell, O(1) amortised hull work), in practice the latency of the
// per-thread dependent chain at 3 blocks (3 warps) per SM when Y = 1024: the
// forward pass loads kChunk values ahead to keep several loads in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInfD2 = 1 << 29;
constexpr int32_t kClamp = 3 * 1024 * 1024 + 1024;
constexpr int kMaxAxis = 1024;
constexpr int kLines = 32;
constexpr int kChunk = 8;

// Parabola b (between a and q, a < b < q) is nowhere strictly below both.
__device__ __forceinline__ bool hidden(int a, int ga, int b, int gb, int q,
                                       int gq) {
  return (long long)(gq - gb) * (b - a) <= (long long)(gb - ga) * (q - b);
}

__global__ void __launch_bounds__(kLines)
    envelope_cht_kernel(const int32_t* __restrict__ f,
                        int32_t* __restrict__ out, int Y, int Z,
                        long long lines) {
  extern __shared__ int16_t hull[];  // [Y][kLines]
  const long long line = blockIdx.x * (long long)kLines + threadIdx.x;
  if (line >= lines) return;
  const long long x = line / Z;
  const long long base = x * Y * (long long)Z + (line - x * Z);
  const int32_t* fl = f + base;  // f[x, j, z] at fl[j * Z]
  int32_t* ol = out + base;
  int16_t* h = hull + threadIdx.x;  // hull entry k at h[k * kLines]

  // ---- forward: the lower envelope of the sources with f <= kClamp
  int top = -1;        // entries h[0..top]
  int a = 0, ga = 0;   // the entry below the top, g = f + j^2
  int b = 0, gb = 0;   // the top entry
  for (int q0 = 0; q0 < Y; q0 += kChunk) {
    int fv[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
      fv[t] = q0 + t < Y ? __ldg(fl + (long long)(q0 + t) * Z) : kInfD2;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (fv[t] > kClamp) continue;  // no source (also the pad past Y)
      const int q = q0 + t;
      const int gq = fv[t] + q * q;
      while (top >= 1 && hidden(a, ga, b, gb, q, gq)) {
        --top;
        b = a;
        gb = ga;
        if (top >= 1) {
          a = h[(top - 1) * kLines];
          ga = __ldg(fl + (long long)a * Z) + a * a;
        }
      }
      h[++top * kLines] = (int16_t)q;
      a = b;
      ga = gb;
      b = q;
      gb = gq;
    }
  }

  // ---- evaluate: walk the hull left to right
  if (top < 0) {
    for (int i = 0; i < Y; ++i) ol[(long long)i * Z] = kInfD2;
    return;
  }
  int k = 0;
  int c = h[0];
  int fc = __ldg(fl + (long long)c * Z);
  int n = 0, fn = 0;  // the next entry, when k < top
  if (top >= 1) {
    n = h[kLines];
    fn = __ldg(fl + (long long)n * Z);
  }
  for (int i = 0; i < Y; ++i) {
    while (k < top) {
      const int dn = i - n, dc = i - c;
      if (fn + dn * dn > fc + dc * dc) break;
      ++k;
      c = n;
      fc = fn;
      if (k < top) {
        n = h[(k + 1) * kLines];
        fn = __ldg(fl + (long long)n * Z);
      }
    }
    const int d = i - c;
    const int v = fc + d * d;
    ol[(long long)i * Z] = v > kClamp ? kInfD2 : v;
  }
}

}  // namespace

extern "C" int sdf_envelope_cht(const void* f, void* out, int X, int Y, int Z,
                                void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || Y > kMaxAxis)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)Y * kLines * sizeof(int16_t);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        envelope_cht_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long lines = (long long)X * Z;
  const long long blocks = (lines + kLines - 1) / kLines;
  envelope_cht_kernel<<<(unsigned)blocks, kLines, bytes,
                        (cudaStream_t)stream>>>((const int32_t*)f,
                                                (int32_t*)out, Y, Z, lines);
  return (int)cudaGetLastError();
}
