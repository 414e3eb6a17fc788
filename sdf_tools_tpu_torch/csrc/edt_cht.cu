// K9: the exact 1-D parabolic envelope along axis 1 or axis 2 of a
// contiguous int32 [X, Y, Z] array (z fastest), by the lower envelope
// (convex hull) of each line's parabolas,
//   out[i] = min_j f[j] + (i - j)^2,  then  out[i] > kClamp -> INF_D2,
// for a scan axis of at most 1024 and d^2 inputs (f >= 0).
//
// Replaces the TPU kernel `_cht_kernel` (sdf_tools_tpu/ops/edt_cht.py:176,
// launched by `_envelope_cht_axis1` :221 under `envelope_pass_cht` :260).
// The TPU kernel keeps the hull in K fixed register slots per lane because
// its vector unit cannot index lanes dynamically; it flags blocks whose
// hull overflows K and the host recomputes them with the relaxation. Here
// the whole hull of a line lives in shared memory, so there is no cap, no
// overflow flag and no fallback; the result is exact either way, so it is
// the same function. K9 writes no winner, so any correct hull gives the
// same int32 values.
//
// kClamp (3 * 1024^2 + 1024, from the global 1024 and not from n) is the
// TPU kernel's bound on a real output: a larger value came from no source
// and becomes INF_D2. A source with f > kClamp can only produce values above
// kClamp and is left out of the hull; a line with no source left is INF_D2
// everywhere.
//
// Design: the Parallel Banding Algorithm of Cao, Tang, Mei and Lin (I3D
// 2010), phases 2-3, one warp per line, the line staged in shared memory so
// that no step of the hull goes to device memory. Lane b owns band b, the
// ceil(n / 32) consecutive cells from b * ceil(n / 32).
//   1. Each lane builds the lower envelope of its band's sources with the
//      forward stack of Felzenszwalb-Huttenlocher, kept in place: at each
//      entry's own cell, `down` links the entry below and `up` the entry
//      above. A popped entry's `down` becomes -1.
//   2. Five merge rounds: in round r the groups of 2^r bands merge in pairs,
//      by the left group's lane. The merged envelope is a prefix of the left
//      one and a suffix of the right one (a left source wins left of every
//      crossing), so the lane pops the left top while the right's first
//      entry hides it and drops the right's first entry while the left top
//      and the right's second hide it, until neither does, and links the
//      two. An empty group passes the other through. Neither bottom of the
//      left nor top of the right can be hidden (no neighbour on that side).
//   3. The entries whose `down` is not -1 form the hull. Each lane flags its
//      band's (a 32-bit mask: a band has at most 32 cells), a warp prefix
//      sum places them, and the link storage, no longer needed, takes the
//      compact hull: entry k = f | index << 22 (f <= kClamp < 2^22, index
//      < 2^10). Each lane finds the entry active at its band's first cell
//      by binary search (hull entry k + 1 is not above entry k at i, which
//      holds for a prefix of k: the break points increase along the hull),
//      then walks its cells forward, writing the outputs over the line's
//      values; the block stores them back coalesced.
// The take-over test compares break points s(b, q) <= s(a, b), s(p, r) =
// (g_r - g_p) / (2 (r - p)) with g = f + j^2, by exact 64-bit integer
// cross-multiplication (|g| < 2^23, |r - p| < 2^10); no division, no float.
//
// Shared memory: per cell 4 bytes of value and 4 of links (down, up), with
// one word of padding every 32 cells, so that the lanes, at the same offset
// in their bands, fall in distinct banks: about 8.3 KB a line at n = 1024,
// kLines lines a block (3 blocks per SM). Along axis 1 the block's lines
// are a [Y, zt] tile, loaded coalesced along z and transposed, as in K5;
// along axis 2 each warp loads a contiguous line.
//
// Bound on Hopper: device memory (one int32 read and one write per cell);
// the hull work is O(n) per line, in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInfD2 = 1 << 29;
constexpr int32_t kClamp = 3 * 1024 * 1024 + 1024;
constexpr int kMaxAxis = 1024;
constexpr int kLines = 8;  // lines (warps) per block
constexpr unsigned kAll = 0xffffffffu;
constexpr int kFBits = 22;  // a compact hull entry: f in the low bits, its index above
constexpr uint32_t kFMask = (1u << kFBits) - 1;

// Cell q's word in its line: one word of padding every 32 cells.
__device__ __forceinline__ int pad(int q) { return q + (q >> 5); }

// The links of cell q in the line's link words: down, then up.
__device__ __forceinline__ int16_t& down(int16_t* lk, int q) { return lk[2 * pad(q)]; }
__device__ __forceinline__ int16_t& up(int16_t* lk, int q) { return lk[2 * pad(q) + 1]; }

// Parabola b (between a and q, a < b < q) is nowhere strictly below both.
__device__ __forceinline__ bool hidden(int a, int ga, int b, int gb, int q,
                                       int gq) {
  return (long long)(gq - gb) * (b - a) <= (long long)(gb - ga) * (q - b);
}

// A compact hull entry's parabola at i.
__device__ __forceinline__ int at(uint32_t e, int i) {
  const int d = i - (int)(e >> kFBits);
  return (int)(e & kFMask) + d * d;
}

// One line of n <= 1024 values (cell q at f[pad(q)]) and its link words lk,
// in shared memory, by one warp: leaves the envelope, clamped, in f.
__device__ void hull_line(int32_t* f, int16_t* lk, int n, int lane) {
  const int B = (n + 31) >> 5;
  const int c0 = min(lane * B, n), c1 = min(c0 + B, n);

  // ---- 1. the band's lower envelope: a stack in place, bottom to top
  int bot = -1, top = -1, g_top = 0;
  for (int q = c0; q < c1; ++q) {
    const int fq = f[pad(q)];
    if (fq > kClamp) {  // no source
      down(lk, q) = -1;
      continue;
    }
    const int gq = fq + q * q;
    while (top != bot) {
      const int s = down(lk, top);
      const int gs = f[pad(s)] + s * s;
      if (!hidden(s, gs, top, g_top, q, gq)) break;
      down(lk, top) = -1;
      top = s;
      g_top = gs;
    }
    if (top < 0) {
      bot = q;
      down(lk, q) = (int16_t)q;  // the bottom: any value but -1
    } else {
      down(lk, q) = (int16_t)top;
      up(lk, top) = (int16_t)q;
    }
    top = q;
    g_top = gq;
  }

  // ---- 2. merge the bands' envelopes in five rounds
  for (int step = 1; step < 32; step <<= 1) {
    __syncwarp();  // the last round's links
    const int rb = __shfl_down_sync(kAll, bot, step);
    const int rt = __shfl_down_sync(kAll, top, step);
    if (lane & (2 * step - 1)) continue;  // not a left group's lane
    if (top < 0) {
      bot = rb;
      top = rt;
    } else if (rt >= 0) {
      int t = top, gt = f[pad(t)] + t * t;
      int u = rb, gu = f[pad(u)] + u * u;
      for (;;) {
        if (t != bot) {
          const int s = down(lk, t), gs = f[pad(s)] + s * s;
          if (hidden(s, gs, t, gt, u, gu)) {
            down(lk, t) = -1;
            t = s;
            gt = gs;
            continue;
          }
        }
        if (u != rt) {
          const int v = up(lk, u), gv = f[pad(v)] + v * v;
          if (hidden(t, gt, u, gu, v, gv)) {
            down(lk, u) = -1;
            u = v;
            gu = gv;
            continue;
          }
        }
        break;
      }
      up(lk, t) = (int16_t)u;
      down(lk, u) = (int16_t)t;
      top = rt;
    }
  }
  __syncwarp();

  // ---- 3. compact the hull, then evaluate each band from its start entry
  unsigned mask = 0;
  for (int q = c0; q < c1; ++q)
    if (down(lk, q) >= 0) mask |= 1u << (q - c0);
  const int count = __popc(mask);
  int incl = count;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += y;
  }
  const int total = __shfl_sync(kAll, incl, 31);
  __syncwarp();  // every flag read before the links become the hull
  uint32_t* hull = (uint32_t*)lk;
  int k = incl - count;
  for (unsigned m = mask; m; m &= m - 1) {
    const int q = c0 + __ffs(m) - 1;
    hull[k++] = (uint32_t)f[pad(q)] | ((uint32_t)q << kFBits);
  }
  __syncwarp();  // the whole hull before the walks; f now takes the outputs
  if (c0 >= c1) return;
  if (total == 0) {
    for (int i = c0; i < c1; ++i) f[pad(i)] = kInfD2;
    return;
  }
  int lo = 0, hi = total - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (at(hull[mid + 1], c0) <= at(hull[mid], c0))
      lo = mid + 1;
    else
      hi = mid;
  }
  k = lo;
  uint32_t cur = hull[k], next = k + 1 < total ? hull[k + 1] : 0;
  for (int i = c0; i < c1; ++i) {
    while (k + 1 < total && at(next, i) <= at(cur, i)) {
      ++k;
      cur = next;
      if (k + 1 < total) next = hull[k + 1];
    }
    const int v = at(cur, i);
    f[pad(i)] = v > kClamp ? kInfD2 : v;
  }
}

// Words of one line of n cells (padded), rounded up to 32, plus 32 / zt
// (mod 32): in an axis-1 tile of zt columns the transposing loads and
// stores of one warp cover 32 / zt consecutive cells of zt columns, which
// then fall in distinct banks.
int line_words(int n, int zt) {
  return (n + ((n - 1) >> 5) + 31) / 32 * 32 + (32 / zt) % 32;
}

// Axis 1: block = one [Y, zt] tile of one x plane, zt = 1 << lzt column
// lines at col * ls, their links after them at (zt + col) * ls; one warp
// per column.
__global__ void __launch_bounds__(kLines * 32)
    cht_axis1_kernel(const int32_t* __restrict__ f, int32_t* __restrict__ out,
                     int Y, int Z, int lzt, int n_ztiles, int ls) {
  extern __shared__ int32_t smem[];
  const int zt = 1 << lzt;
  const long long x = blockIdx.x / n_ztiles;
  const int z0 = (blockIdx.x % n_ztiles) * zt;
  const long long base = x * Y * (long long)Z + z0;
  const int cells = Y << lzt;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int i = c >> lzt, col = c & (zt - 1);
    if (z0 + col < Z) smem[col * ls + pad(i)] = f[base + (long long)i * Z + col];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (z0 + warp < Z)
    hull_line(smem + warp * ls, (int16_t*)(smem + (zt + warp) * ls), Y, threadIdx.x & 31);
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int i = c >> lzt, col = c & (zt - 1);
    if (z0 + col < Z) out[base + (long long)i * Z + col] = smem[col * ls + pad(i)];
  }
}

// Axis 2: each warp owns one (x, y) line: values at warp * ls, links at
// (warps + warp) * ls.
__global__ void __launch_bounds__(kLines * 32)
    cht_axis2_kernel(const int32_t* __restrict__ f, int32_t* __restrict__ out,
                     int Z, long long lines, int ls) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long line = (long long)blockIdx.x * warps + warp;
  if (line >= lines) return;
  int32_t* fl = smem + (size_t)warp * ls;
  const long long base = line * Z;
  for (int i = lane; i < Z; i += 32) fl[pad(i)] = f[base + i];
  __syncwarp();
  hull_line(fl, (int16_t*)(smem + (size_t)(warps + warp) * ls), Z, lane);
  __syncwarp();
  for (int i = lane; i < Z; i += 32) out[base + i] = fl[pad(i)];
}

// Opt in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int sdf_envelope_cht(const void* f, void* out, int X, int Y, int Z,
                                int axis, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || (axis != 1 && axis != 2) ||
      (axis == 1 ? Y : Z) > kMaxAxis)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (axis == 1) {
    int lzt = 3;  // zt = kLines columns, at most Z
    while ((1 << lzt) > Z) --lzt;
    const int zt = 1 << lzt;
    const int ls = line_words(Y, zt);
    const size_t bytes = 2 * (size_t)zt * ls * sizeof(int32_t);
    const int err = allow_smem(cht_axis1_kernel, bytes);
    if (err) return err;
    const int n_ztiles = (Z + zt - 1) / zt;
    cht_axis1_kernel<<<(unsigned)((long long)X * n_ztiles), zt * 32, bytes, s>>>(
        (const int32_t*)f, (int32_t*)out, Y, Z, lzt, n_ztiles, ls);
  } else {
    const int ls = line_words(Z, 1);
    const size_t bytes = 2 * (size_t)kLines * ls * sizeof(int32_t);
    const int err = allow_smem(cht_axis2_kernel, bytes);
    if (err) return err;
    const long long lines = (long long)X * Y;
    cht_axis2_kernel<<<(unsigned)((lines + kLines - 1) / kLines), kLines * 32, bytes, s>>>(
        (const int32_t*)f, (int32_t*)out, Z, lines, ls);
  }
  return (int)cudaGetLastError();
}
