// The leftmost row-minimum search of the exact 1-D parabolic envelope
//   out[i] = min_j f[j] + (i - j)^2
// of one int32 line in shared memory, by one warp, and the launch helpers
// its kernels share: K2, K3 and K5 (edt_envelope.cu) and K6 (edt_carry.cu).
//
// The search. M[i][j] = f[j] + (i - j)^2 is a Monge array ((i - j)^2 is:
// (i' - i)(j' - j) >= 0), so the leftmost minimising j of row i, J(i), never
// decreases as i grows, for any f (INF_D2 entries and ties included). With
// N = 2^K >= n, level k < K solves the rows i at the odd multiples of
// s = 2^(K-1-k): each scans only [J(i - s), J(i + s)], rows solved at
// earlier levels (0 for i - s = 0, n - 1 past the end of the line); level K
// solves row 0 over [0, J(1)]. The ranges of one level sum to at most
// n + 2^k, so a line costs about n log2(n) candidates instead of n^2. A
// scan keeps the least (value, j), the leftmost minimiser: a rule that
// picked different minimisers for different rows would not be monotone. J
// lives in shared memory beside the line as int16 (n <= 16384). The value
// f[J(i)] + (i - J(i))^2 is the brute minimum by construction, so the int32
// outputs are the same bits, J(i) is the first minimiser (K6's tie rule),
// and a line with no finite entry comes out exactly INF_D2 with J(i) = i.
// INF_D2 + (n-1)^2 < 2^31 for n <= 16384, so nothing overflows.
//
// Parallel layout: one warp per line, levels separated by __syncwarp. A
// level's sum is small, but one row can span the gap between two seeds
// (up to n candidates), so its scan is spread over the whole warp; the
// other rows take one lane each (search_line).
//
// Each including file gets its own copy (anonymous namespace).

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxAxis = 16384;  // int16 J; see the overflow note above
constexpr int kWide = 32;        // a row with more candidates is scanned by its warp
constexpr unsigned kAll = 0xffffffffu;
constexpr int kAxis2Warps = 8;   // lines (and fields) per block along axis 2

// Levels of the search for a line of n: the K with 2^(K-1) < n <= 2^K;
// levels 0 .. K run.
__device__ __forceinline__ int search_levels(int n) {
  return n == 1 ? 0 : 32 - __clz(n - 1);
}

// Row b of level k: its index i and the bounds [lo, hi] of its scan.
__device__ __forceinline__ void row_bounds(const int16_t* J, int n, int K,
                                           int k, int b, int& i, int& lo,
                                           int& hi) {
  if (k == K) {
    i = 0;
    lo = 0;
    hi = n > 1 ? J[1] : 0;
    return;
  }
  const int s = 1 << (K - 1 - k);
  i = s * (2 * b + 1);
  lo = i - s > 0 ? J[i - s] : 0;
  hi = i + s < n ? J[i + s] : n - 1;
}

// Leftmost j in [lo, hi] minimising f[j] + (i - j)^2, by one lane.
__device__ __forceinline__ int row_argmin(const int32_t* f, int i, int lo,
                                          int hi) {
  int best_j = lo;
  int32_t best = f[lo] + (i - lo) * (i - lo);
  for (int j = lo + 1; j <= hi; ++j) {
    const int d = i - j;
    const int32_t v = f[j] + d * d;
    if (v < best) {
      best = v;
      best_j = j;
    }
  }
  return best_j;
}

// The same by the whole warp: lane l scans lo + l, lo + l + 32, ... going
// up, and the warp keeps the least (value, j), the leftmost minimiser.
__device__ __forceinline__ int row_argmin_warp(const int32_t* f, int i,
                                               int lo, int hi, int lane) {
  int32_t best = INT_MAX;
  int best_j = INT_MAX;
  for (int j = lo + lane; j <= hi; j += 32) {
    const int d = i - j;
    const int32_t v = f[j] + d * d;
    if (v < best) {
      best = v;
      best_j = j;
    }
  }
  for (int off = 16; off > 0; off /= 2) {
    const int32_t ov = __shfl_xor_sync(kAll, best, off);
    const int oj = __shfl_xor_sync(kAll, best_j, off);
    if (ov < best || (ov == best && oj < best_j)) {
      best = ov;
      best_j = oj;
    }
  }
  return best_j;
}

// The search over one line of n values f[0..n) in shared memory by one
// warp (all 32 lanes), writing J[0..n). The lanes take the rows of a level
// 32 at a time; a row of more than kWide candidates (the rows that span a
// gap between seeds, up to n wide) is left by its lane and scanned by the
// whole warp, so that no lane walks a gap alone while the others wait.
__device__ void search_line(const int32_t* f, int16_t* J, int n, int lane) {
  const int K = search_levels(n);
  for (int k = 0; k <= K; ++k) {
    const int rows = k == K ? 1 : (n - 1 - (1 << (K - 1 - k))) / (2 << (K - 1 - k)) + 1;
    for (int b0 = 0; b0 < rows; b0 += 32) {
      int i = 0, lo = 0, hi = -1;
      if (b0 + lane < rows) row_bounds(J, n, K, k, b0 + lane, i, lo, hi);
      const bool wide = hi - lo >= kWide;
      if (!wide && hi >= lo) J[i] = (int16_t)row_argmin(f, i, lo, hi);
      for (unsigned m = __ballot_sync(kAll, wide); m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int wi = __shfl_sync(kAll, i, src);
        const int wlo = __shfl_sync(kAll, lo, src);
        const int whi = __shfl_sync(kAll, hi, src);
        const int j = row_argmin_warp(f, wi, wlo, whi, lane);
        if (lane == 0) J[wi] = (int16_t)j;
      }
    }
    __syncwarp();  // this level's J before the next level reads it
  }
}

__device__ __forceinline__ int32_t envelope_from(const int32_t* f,
                                                 const int16_t* J, int i) {
  const int j = J[i];
  return f[j] + (i - j) * (i - j);
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

// shared memory of n entries: the int32 values and their int16 J
size_t line_bytes(long long n) { return (size_t)n * (sizeof(int32_t) + sizeof(int16_t)); }

// The axis-1 tile of the search kernels: a [Y, zt] tile of one x plane,
// loaded coalesced along z and stored transposed, column c as a line at
// c * ls (ls = 1 mod 32, so the transposing stores fall in distinct banks),
// its J beside it. Picks the widest power-of-two zt (1 << lzt, at most one
// warp of columns and at most Z) whose lines fit `limit` bytes; returns
// the bytes, or 0 if not even one column fits.
size_t axis1_tile(int Y, int Z, int limit, int* lzt, int* ls) {
  *ls = (Y + 31) / 32 * 32 + 1;
  *lzt = 5;
  while (*lzt > 0 && ((1 << *lzt) > Z || line_bytes((long long)*ls << *lzt) > (size_t)limit)) --*lzt;
  const size_t bytes = line_bytes((long long)*ls << *lzt);
  return bytes > (size_t)limit ? 0 : bytes;
}

}  // namespace
