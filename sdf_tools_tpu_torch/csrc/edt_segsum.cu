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
// equal to the TPU kernels and to the plain version, with no atomics and no
// warp-level reduction. The thread keeps the running sum of the current
// output row in a register and writes it back when the winner changes; a
// row that is revisited (a map that is not monotone) is read back and
// continued, and rows no winner reaches are zero.
//
// Bound on Hopper: device memory. Per cell it reads 4 bytes of g and 2 or 4
// of winner and writes 4 bytes; at 512^3 with int16 winners that is 1.34 GB,
// 0.40 ms at 3.35 TB/s. A thread walking its line straight through device
// memory reads uncoalesced along axis 2 (32 lines n*4 bytes apart per warp
// load) and, along any axis, writes its outputs wherever its winners point:
// the lanes of a warp store to 32 scattered rows. So a block owns L <= 32
// lines (L = 32 at n <= 512) and keeps their outputs in shared memory,
// zeroed first and held whole (outputs are indexed by winner value):
//
// - the block moves kChunk steps of all its lines at a time from device
//   memory into shared memory, coalesced whatever the axis (along the lines
//   when they are contiguous, axis 2; across them otherwise, where
//   neighbouring lines are neighbouring addresses), through registers, the
//   next chunk's loads in flight while the current chunk is walked;
// - thread l walks line l in shared memory, kPipe steps' inputs at a time,
//   without branches (the lanes change rows at different steps);
// - the block stores the outputs coalesced. Rows are padded by one word,
//   so the lanes' reads and writes of one column fall in distinct banks.
//
// An axis of length 1 copies g, as the TPU wrapper returns g there whatever
// the winners; so does the in-place walk (segsum_strided_kernel), which is
// kept for lines too long for a block's shared memory (n > ~56k).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPipe = 8;         // steps of the walk loaded ahead
constexpr int kStridedThreads = 256;
constexpr int kTileThreads = 128;
constexpr int kMaxLines = 32;    // lines per block of the tiled walk
constexpr int kChunk = 32;       // steps of each line staged per round

// The in-place walk: one thread per line, straight through device memory.
// Line c starts at (c / inner) * n * inner + c % inner and steps by inner.
// cur: the output row whose sum is in acc; top: every row <= top other
// than cur is already in out (rows are zero-filled as the walk passes them).
template <typename W>
__global__ void segsum_strided_kernel(const float* __restrict__ g,
                                      const W* __restrict__ win,
                                      float* __restrict__ out, int n,
                                      long long inner, long long lines) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= lines) return;
  const long long base = (c / inner) * n * inner + c % inner;
  if (n == 1) {
    out[base] = g[base];
    return;
  }
  int cur = -1, top = -1;
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

// One step of the shared-memory walk, without branches (the lanes of a
// warp change rows at different steps). row holds the line's outputs,
// zeroed before the walk, so a row above top (not yet visited) starts from
// 0.0 without a read, and a revisited row is read back. cur starts at n,
// the row's pad slot, so the first change stores there harmlessly. A winner
// outside [0, n) adds +0.0 to the current sum, which changes nothing: a sum
// from +0.0 is never -0.0.
__device__ __forceinline__ void tile_step(int w, float gi, int n, float* row,
                                          int& cur, int& top, float& acc) {
  const bool valid = (unsigned)w < (unsigned)n;
  const int to = valid ? w : cur;
  const bool change = to != cur;
  const bool fresh = to > top;
  if (change) row[cur] = acc;
  float base = acc;
  if (change && !fresh) base = row[to];
  if (fresh) base = 0.0f;
  acc = __fadd_rn(base, valid ? gi : 0.0f);
  top = fresh ? to : top;
  cur = to;
}

// Block = L <= 32 lines; thread l < L walks line l. Line c starts at
// (c / inner) * n * inner + c % inner and steps by inner. The block moves
// kChunk steps of all its lines at a time between device memory and shared
// memory: along the line when inner == 1 (lines contiguous), across the
// lines when inner > 1 (neighbouring lines are neighbouring addresses), so
// the loads and the final stores are coalesced either way. Each thread
// holds kPer elements of a chunk in registers: the next chunk is loaded
// while the current one is walked. Shared memory: the outputs [L][n + 1],
// then g and the winners (as int32) of one chunk, [L][kChunk + 1] each.
template <typename W>
__global__ void segsum_tile_kernel(const float* __restrict__ g,
                                   const W* __restrict__ win,
                                   float* __restrict__ out, int n,
                                   long long inner, long long lines, int L) {
  constexpr int kPer = kMaxLines * kChunk / kTileThreads;
  extern __shared__ float smem[];
  const int ostride = n + 1;
  constexpr int cstride = kChunk + 1;
  float* so = smem;
  float* sg = so + (size_t)L * ostride;
  int* sw = (int*)(sg + L * cstride);
  const long long line0 = blockIdx.x * (long long)L;
  const int nl = (int)(lines - line0 < L ? lines - line0 : L);
  const bool along = inner == 1;  // chunk elements run along the line
  const int lane = threadIdx.x & 31;
  auto line_base = [&](int l) {
    const long long c = line0 + l;
    return (c / inner) * n * inner + c % inner;
  };
  // element e of thread tid, idx = e * kTileThreads + tid: across the lines
  // (line idx % 32 = lane, step idx / 32), along them (line idx / kChunk,
  // step idx % kChunk)
  const long long lane_base = along ? 0 : line_base(lane < nl ? lane : 0);
  auto slot = [&](int e, int& l, int& i) {
    const int idx = e * kTileThreads + threadIdx.x;
    if (along) {
      l = idx / kChunk;
      i = idx % kChunk;
    } else {
      l = idx % kMaxLines;
      i = idx / kMaxLines;
    }
  };
  float gv[kPer];
  int wv[kPer];
  auto load = [&](int c0) {
    const int cw = n - c0 < kChunk ? n - c0 : kChunk;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      int l, i;
      slot(e, l, i);
      const bool ok = l < nl && i < cw;
      const long long at = along ? (line0 + l) * n + c0 + i : lane_base + (c0 + i) * inner;
      gv[e] = ok ? g[at] : 0.0f;
      wv[e] = ok ? (int)win[at] : -1;
    }
  };

  for (int k = threadIdx.x; k < nl * ostride; k += kTileThreads) so[k] = 0.0f;
  const bool walker = threadIdx.x < nl;
  float* row = so + (walker ? threadIdx.x : 0) * ostride;
  int cur = n, top = -1;
  float acc = 0.0f;
  load(0);
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int cw = n - c0 < kChunk ? n - c0 : kChunk;
    __syncthreads();  // the zero fill, or the last chunk's walk, is done
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      int l, i;
      slot(e, l, i);
      if (l < nl && i < cw) {
        sg[l * cstride + i] = gv[e];
        sw[l * cstride + i] = wv[e];
      }
    }
    __syncthreads();
    if (c0 + kChunk < n) load(c0 + kChunk);
    if (!walker) continue;
    // kPipe steps' winners and g into registers at once, then their sums:
    // the loads of a group do not wait on the previous step's store
    const float* rg = sg + threadIdx.x * cstride;
    const int* rw = sw + threadIdx.x * cstride;
    int i = 0;
    for (; i + kPipe <= cw; i += kPipe) {
      int wq[kPipe];
      float gq[kPipe];
#pragma unroll
      for (int k = 0; k < kPipe; ++k) {
        wq[k] = rw[i + k];
        gq[k] = rg[i + k];
      }
#pragma unroll
      for (int k = 0; k < kPipe; ++k) tile_step(wq[k], gq[k], n, row, cur, top, acc);
    }
    for (; i < cw; ++i) tile_step(rw[i], rg[i], n, row, cur, top, acc);
  }
  if (walker) row[cur] = acc;
  __syncthreads();
  if (along) {
    for (int l = threadIdx.x >> 5; l < nl; l += kTileThreads / 32)
      for (int j = lane; j < n; j += 32) out[(line0 + l) * n + j] = so[l * ostride + j];
  } else if (lane < nl) {
    for (int j = threadIdx.x >> 5; j < n; j += kTileThreads / 32)
      out[lane_base + j * inner] = so[lane * ostride + j];
  }
}

size_t tile_smem_bytes(int n, int L) {
  return ((size_t)L * (n + 1) + 2 * (size_t)L * (kChunk + 1)) * sizeof(float);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename W>
int launch(const void* g, const void* win, void* out, int n, long long inner,
           long long lines, cudaStream_t stream) {
  if (n > 1) {
    int dev = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    // the most lines (<= 32) that leave room for two blocks per SM, or one
    // line in the whole of a block's shared memory
    int L = kMaxLines;
    while (L > 1 && tile_smem_bytes(n, L) > (size_t)limit / 2) L /= 2;
    const size_t bytes = tile_smem_bytes(n, L);
    if (bytes <= (size_t)limit) {
      int err = allow_smem(segsum_tile_kernel<W>, bytes);
      if (err) return err;
      const long long blocks = (lines + L - 1) / L;
      segsum_tile_kernel<W><<<(unsigned)blocks, kTileThreads, bytes, stream>>>(
          (const float*)g, (const W*)win, (float*)out, n, inner, lines, L);
      return (int)cudaGetLastError();
    }
    // a line longer than a block's shared memory holds (n > ~56k) is
    // walked in place
  }
  const long long blocks = (lines + kStridedThreads - 1) / kStridedThreads;
  segsum_strided_kernel<W><<<(unsigned)blocks, kStridedThreads, 0, stream>>>(
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
