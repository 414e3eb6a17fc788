// K1 and K4: binary line passes along axis 0 of a [X, Y, Z] mask (z fastest).
//
// K1 replaces the TPU kernel `_line_pass_dual_kernel` (sdf_tools_tpu/ops/
// edt_pallas.py:504, launched by `line_pass_dual_pallas`). For every (y, z)
// column it writes, from one read of the mask, the distance along x to the
// nearest True cell (field a) and to the nearest False cell (field b).
//
// K4 replaces `_line_pass_kernel` (edt_pallas.py:226, launched by
// `line_pass_pallas`): the True field alone.
//
// Both come in two modes: squared (int32 d^2, exactly INF_D2 = 1 << 29 on a
// column without a seed) and linear (d, exactly 1 << 24 there; the form the
// slabbed and sharded line passes combine across boundaries before
// squaring). A mask byte != 0 is a seed of field a.
//
// Bound on Hopper: device memory. The least traffic is the 1-byte mask read
// once and each int32 output written once (K1 9 bytes a cell, K4 5), with a
// handful of integer operations a cell. The TPU kernel sweeps each block
// forward and back through VMEM, where a read-back is cheap; on the card it
// would go through device memory. So here each output is written exactly
// once and nothing is read back: a blocked scan along x.
//
// * A block owns 32 adjacent columns c = y * Z + z (one lane each: every
//   row access of a warp is one 32-byte mask sector or one 128-byte int32
//   line, for any Y and Z) and splits x into chunks of 32 rows; a thread
//   (lane, warp) takes `C` consecutive chunks of its column (C = 1 up to
//   X = 1024, one warp a chunk).
// * Phase 1: the thread packs each chunk's 32 mask bytes into a word (bit i
//   = row i; field b's word is ~word & valid) and finds its range's first
//   and last seed of each field (__ffs / __clz). It publishes them in shared
//   memory.
// * Phase 2, after one barrier: its carries, the last seed before its range
//   (max over the earlier warps) and the first after it (min over the later
//   ones).
// * Phase 3: it walks its rows. The last seed at or before row i is carried
//   along the walk; the first at or after it is the lowest set bit of
//   word >> i (the highest of brev(word) << i), else the first seed of a
//   later chunk of its range (a look-ahead that only moves forward, so each
//   later chunk is re-read at most once a field, likely from L2), else the
//   right carry. Each row's outputs are then written once.
//
// Positions are 32-bit: a real distance is at most X - 1, "no seed before"
// is -X and "no seed after" is 0xffffffff, and the distances are taken in
// unsigned arithmetic, so a distance >= X means no seed for any X < 2^31.
// Offsets x * Y * Z + c are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInfD2 = 1 << 29;
constexpr int32_t kLineSentinel = 1 << 24;
constexpr int kRows = 32;   // rows of a chunk: the bits of a word
constexpr int kMaxWarps = 32;
constexpr uint32_t kNoneAfter = 0xffffffffu;

// The chunk's mask bits, row i of the chunk at bit i; rows at or past X are 0.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ mask, int X, long long YZ,
                                              long long c, int k) {
  const int base = k * kRows;
  const uint8_t* p = mask + (long long)base * YZ + c;
  uint32_t w = 0;
  if (X - base >= kRows) {
#pragma unroll
    for (int i = 0; i < kRows; ++i, p += YZ) w |= (uint32_t)(*p != 0) << i;
  } else {
    for (int i = 0; i < X - base; ++i, p += YZ) w |= (uint32_t)(*p != 0) << i;
  }
  return w;
}

__device__ __forceinline__ uint32_t valid_rows(int X, int k) {
  const int n = X - k * kRows;
  return n >= kRows ? 0xffffffffu : (1u << n) - 1u;
}

// Field 0's seeds are the True cells, field 1's the False cells.
__device__ __forceinline__ uint32_t field_word(uint32_t w, uint32_t valid, int f) {
  return f == 0 ? w : ~w & valid;
}

template <bool kSquare>
__device__ __forceinline__ int32_t encode(uint32_t d, uint32_t X) {
  if (d >= X) return kSquare ? kInfD2 : kLineSentinel;
  return kSquare ? (int32_t)(d * d) : (int32_t)d;
}

template <int kFields, bool kSquare>
__global__ void __launch_bounds__(kRows * kMaxWarps)
    line_pass_kernel(const uint8_t* __restrict__ mask, int32_t* __restrict__ out_a,
                     int32_t* __restrict__ out_b, int X, long long YZ, int C) {
  __shared__ int32_t s_last[kFields][kMaxWarps][kRows];
  __shared__ uint32_t s_first[kFields][kMaxWarps][kRows];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int W = blockDim.y;
  const long long c = blockIdx.x * (long long)kRows + lane;
  const bool live = c < YZ;
  const int nchunks = (X - 1) / kRows + 1;
  const int k0 = warp * C;
  const int k1 = min(k0 + C, nchunks);

  // phase 1: the range's first and last seed of each field
  uint32_t w0 = 0;  // the range's first word, kept for phase 3 (C == 1: the only one)
  int32_t last[kFields];
  uint32_t first[kFields];
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    last[f] = -X;
    first[f] = kNoneAfter;
  }
  if (live) {
    for (int k = k0; k < k1; ++k) {
      const uint32_t w = load_word(mask, X, YZ, c, k);
      if (k == k0) w0 = w;
      const uint32_t valid = valid_rows(X, k);
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        const uint32_t wf = field_word(w, valid, f);
        if (wf) {
          if (first[f] == kNoneAfter) first[f] = (uint32_t)(k * kRows + __ffs(wf) - 1);
          last[f] = k * kRows + 31 - __clz(wf);
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    s_last[f][warp][lane] = last[f];
    s_first[f][warp][lane] = first[f];
  }
  __syncthreads();
  if (!live) return;

  // phase 2: the carries from the other ranges of the column
  int32_t prev[kFields];   // the last seed at or before the current row
  uint32_t ahead[kFields];  // the first seed after the current chunk, once looked up
  uint32_t right[kFields];
  int scan[kFields];  // the next chunk the look-ahead reads
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    prev[f] = -X;
    for (int v = 0; v < warp; ++v) prev[f] = max(prev[f], s_last[f][v][lane]);
    right[f] = kNoneAfter;
    for (int v = warp + 1; v < W; ++v) right[f] = min(right[f], s_first[f][v][lane]);
    ahead[f] = 0;  // stale: looked up at the first chunk
    scan[f] = k0 + 1;
  }

  // phase 3: the walk, each output written once
  int32_t* const outs[2] = {out_a, out_b};
  for (int k = k0; k < k1; ++k) {
    const int base = k * kRows;
    const uint32_t w = k == k0 ? w0 : load_word(mask, X, YZ, c, k);
    const uint32_t valid = valid_rows(X, k);
    uint32_t rw[kFields];
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      rw[f] = __brev(field_word(w, valid, f));
      if (ahead[f] < (uint32_t)base + kRows) {
        // the known next seed lies in this chunk or before: look further
        ahead[f] = right[f];
        int j = max(scan[f], k + 1);
        for (; j < k1; ++j) {
          const uint32_t wf = field_word(load_word(mask, X, YZ, c, j), valid_rows(X, j), f);
          if (wf) {
            ahead[f] = (uint32_t)(j * kRows + __ffs(wf) - 1);
            break;
          }
        }
        scan[f] = j + 1;
      }
    }
    const int n = min(kRows, X - base);
    long long o = (long long)base * YZ + c;
#pragma unroll
    for (int i = 0; i < kRows; ++i, o += YZ) {
      if (i < n) {
        const int32_t x = base + i;
        if ((w >> i) & 1u)
          prev[0] = x;
        else if (kFields == 2)
          prev[kFields - 1] = x;  // a valid row that is not a seed of a is one of b
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
          const uint32_t t = rw[f] << i;
          const uint32_t next = t ? (uint32_t)x + __clz(t) : ahead[f];
          const uint32_t d = min((uint32_t)x - (uint32_t)prev[f], next - (uint32_t)x);
          outs[f][o] = encode<kSquare>(d, (uint32_t)X);
        }
      }
    }
  }
}

template <int kFields>
int launch(const void* mask, void* out_a, void* out_b, int X, int Y, int Z, bool square, void* stream) {
  const long long yz = (long long)Y * Z;
  if (X <= 0 || yz <= 0) return (int)cudaErrorInvalidValue;
  const int nchunks = (X - 1) / kRows + 1;
  const int C = (nchunks + kMaxWarps - 1) / kMaxWarps;  // chunks a thread
  const int warps = (nchunks + C - 1) / C;
  const long long blocks = (yz + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block(kRows, warps);
  auto* m = (const uint8_t*)mask;
  auto* a = (int32_t*)out_a;
  auto* b = (int32_t*)out_b;
  auto s = (cudaStream_t)stream;
  if (square)
    line_pass_kernel<kFields, true><<<(unsigned)blocks, block, 0, s>>>(m, a, b, X, yz, C);
  else
    line_pass_kernel<kFields, false><<<(unsigned)blocks, block, 0, s>>>(m, a, b, X, yz, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdf_line_pass_dual(const void* mask, void* out_a, void* out_b, int X, int Y, int Z, int square,
                                  void* stream) {
  return launch<2>(mask, out_a, out_b, X, Y, Z, square != 0, stream);
}

extern "C" int sdf_line_pass(const void* mask, void* out, int X, int Y, int Z, int square, void* stream) {
  return launch<1>(mask, out, nullptr, X, Y, Z, square != 0, stream);
}
