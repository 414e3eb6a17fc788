// The envelope-design probes on Hopper: the primitives an envelope pass is
// made of, each measured alone. They replace the TPU probes of
// scripts/bench_micro_gather.py (E1-E6), bench_micro_gather2.py (G1-G8) and
// bench_micro_gather3.py (H1-H8, the one `make` function, its pallas_call at
// :54), which timed the same functions on a TPU core to choose the O(N)
// envelope kernel's design. Five kernels cover the 24 probes:
//
//   micro_ops           G8 (gather2.py:230): acc = min(2 acc + 1, x + i), a
//                       loop of 512 steps; the floor the in-loop probes are
//                       read against.
//   micro_gather        E1, E1b, E2, E3 (gather.py:52, :74, :101, :123),
//                       G1-G3 (gather2.py:41, :67, :93), H1-H8 (gather3.py:36):
//                       out[o, j, k] = sum over i < steps of
//                       x[o, (q[o, j, k] + i) mod M, k], x viewed as
//                       [outer, n, inner] around the gathered axis.
//   micro_onehot_min    E5 (gather.py:195), G4 (gather2.py:119): the one-hot
//                       fallback of a gather, sum over steps of
//                       min over d of (d == q_i ? x[d, k] : 2^30); on this
//                       card one indexed load a step, min(x[q_i, k], 2^30)
//                       (2^30 where q_i is no row).
//   micro_onehot_write  E6 (gather.py:225), G5 (gather2.py:150): the one-hot
//                       stack write, w[d, k] = (d == q_i ? v : w[d, k]) for
//                       every d, each step; on this card one indexed store
//                       a step, w[r_i, k] = v.
//   micro_row_scan      E4, E4b (gather.py:145, :170), G6, G7 (gather2.py:182,
//                       :206): o_i = min(o_{i-1} + 1, x_i) along one axis,
//                       o_{-1} = 0.
//
// All values are int32; sums and the scan's +1 wrap as int32 (unsigned
// arithmetic here, as XLA and PyTorch wrap). An index (q + i) mod M is the
// floor modulo of JAX's `%`; a thread reduces q once and then steps it with
// a compare and a reset, which gives the same index at every step. The
// non-looped gathers (E1-E3) pass M = n: their q must lie in [0, n).
//
// Batch: every probe takes a leading axis of B independent instances (a TPU
// probe is one (8, 128)-tiled block on one core; B = 1 is its call).
// Every kernel spreads an instance over several blocks when the batch is
// small (its geometry below): at B = 1 one block would use one SM of 132.
//
// Which memory each probe reads is what it measures on this card:
//   - shared memory: an x of an instance that fits in a block's 227 KB is
//     staged there once a block (coalesced), then read by per-thread index,
//     the access of csrc/envelope_search.cuh (one warp per line reading f[j]
//     and J by lane-dependent j). E3, G3, H1, H2, H4-H7 (gathers: a block
//     stages the box of x its outputs read), G4 (one-hot min) and G5
//     (one-hot write; its scratch is the staged columns);
//   - device memory through L1/L2 (read-only loads): an x over 227 KB, the
//     2 MiB probes E1, E1b, E2, E6 and the 256 KiB ones E5, G1, G2, H3, H8,
//     reread each step from the caches (E6 reads x once, in 16-byte vectors);
//   - the row scans (E4, E4b, G6, G7) read each element once from device
//     memory and write it once; staging would only add a copy;
//   - G8 reads x once into registers.
// The wrapper (sdf_tools_tpu_torch/scripts/_micro.py) chooses shared or
// device memory by the same 227 KB rule and passes it down.
//
// Bound on this card: the bytes each probe must move (the elements of x
// its output depends on and every other input read once, each output
// written once, 3.35 TB/s) or its 32-bit operations at the 67 TFLOP/s
// float32 rate, whichever is larger. For the in-loop probes neither counts
// the on-chip rereads that are the point of the probe, so a one-block
// instance is bound by one SM's shared-memory or L1 rate and by the launch,
// not by the device. Each kernel fills the card at B = 1 too:
//   - micro_gather: a grid of tiles, a tile a box of the outputs, cut so
//     that the outputs that read the same column of x share a block (its
//     L1, or one staged box) as far as the tile count allows. A block's
//     threads split the steps into groups; a thread takes one output at a
//     time and its group's steps with kUnroll = 8 loads in flight into 8
//     accumulators (unsigned sums are associative and commutative, so any
//     split of the steps gives the same bits), and the groups' partial sums
//     are added in shared memory: no output is split over blocks, so no
//     atomics and no zeroing pass (a launch of its own). Every (output,
//     step) gather is performed once: no probe is summed by a shortcut,
//     even where its window covers the whole axis. The 8 loads in flight
//     cost 56-64 registers (one 1024-thread block an SM), which the L1/L2
//     gathers need more than a second block; a launch of one group of
//     under 16 steps (E1-E3) runs unrolled once, in 32 registers, two
//     blocks an SM.
//   - micro_onehot_min: micro_gather's geometry on q [1, 1, inner] (boxes
//     of columns, step groups summed in shared memory, 8 loads in flight),
//     a step's one-hot minimum over D rows taken as its one indexed load;
//     G4 stages its block's columns of x, E5 reads its 256 KiB x through
//     L1/L2;
//   - micro_onehot_write, in shared memory (G5): a block takes a tile of
//     columns, stages them (all D rows), and each thread runs its column's
//     steps as one store each, w[r_i * tile + k] = v; every step's store is
//     issued, then the out rows are written. In device memory (E6, one
//     step): one streaming pass over row tiles, each element of out
//     d == q[k] ? v[k] : x[d, k], 16-byte loads and stores where inner % 4
//     == 0;
//   - micro_row_scan: a blocked min-plus scan (below). A tile is a box of
//     8 columns or more with all n rows; its threads split the rows into
//     runs of up to 16, scanned in shared memory, so at B = 1 an instance's
//     x is in flight over about 128 SMs at once (16 for G6's 128 columns);
//   - micro_ops: tiles of a warp's lanes or more, a lane's chain in one
//     thread, so at B = 1 G8 runs as 32 warps on 32 SMs, bound by the
//     chain's latency and not by one SM's issue rate.
// The tiles, groups and runs come from the wrapper (_micro.py:
// gather_geometry, onehot_min_geometry, onehot_write_geometry,
// row_scan_geometry, lane_geometry, where the rule and its reasons are
// written): 4 blocks an SM wanted in all, so B = 1 takes up to 4 x SMs
// blocks and a batch of 4 x SMs instances (B_fill) one block an instance,
// the geometry of a one-block design, which its four blocks an SM already
// fill.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemMax = 232448;        // a block's shared memory on H100 (227 KB)
constexpr int kSmemDefault = 48 * 1024; // above this only after cudaFuncSetAttribute
constexpr int kBig = 1 << 30;           // the one-hot min's "no match"
// micro_gather: loads a thread keeps in flight, one accumulator each. A launch of one group of
// fewer than two rounds of steps runs the kernel unrolled once: its 32 registers let two
// 1024-thread blocks share an SM, where the eight accumulators' kernel (56-64) fits one.
constexpr int kUnroll = 8;
constexpr int kStageThreads = 256;      // micro_onehot_write: threads at least, to stage a narrow column tile

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// A value the compiler must treat as unknown at each use, so that a loop
// whose every step computes the same thing (E5's fixed index) is not folded
// into one step.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

int threads_for(long long items) {
  const long long t = (items + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t));
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  if (bytes > kSmemDefault)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return cudaSuccess;
}

// ---- micro_ops: G8 ----------------------------------------------------------
// Grid (tiles, B): block t takes the lanes [t tile, (t + 1) tile) of its
// instance, a thread a lane (looping where a tile is wider than a block). A
// lane's steps run in order in its thread: the doubling wraps in int32 and
// is not monotone, so the steps do not compose into a shorter form. x + i is
// an induction variable off the chain, which is then two dependent
// instructions a step (2 acc + 1, then the min).

__global__ void __launch_bounds__(kMaxThreads)
micro_ops(const int* __restrict__ x, int* __restrict__ out, int elems, int steps, int tile) {
  const int e0 = blockIdx.x * tile;
  const int count = min(elems, e0 + tile) - e0;
  const size_t base = (size_t)blockIdx.y * elems + e0;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    int xi = __ldg(x + base + e);  // x + i
    int acc = 0;
#pragma unroll 8
    for (int i = 0; i < steps; ++i) {
      acc = min((int)((unsigned)acc * 2u + 1u), xi);
      xi = wrap_add(xi, 1);
    }
    out[base + e] = acc;
  }
}

// ---- micro_gather: E1, E1b, E2, E3, G1-G3, H1-H8 ---------------------------
// Grid (j tiles, k tiles, o tiles x B). A tile is a box of the outputs
// [o, j, k]: ow rows o whole; or, where ow == 1, kw columns k of one o
// with every j; or, where kw == 1 too, mw outputs j of one column. The
// block's threads form `groups` groups; group g takes the steps
// [g chunk, (g + 1) chunk) of every output of the box, consecutive threads
// on consecutive k, then j, then o. With several groups a group has a
// thread for each output, and the groups' partial sums meet in shared
// memory, where they are added. Shared: the block stages the columns of x
// its box reads, [o][r][k], ahead of the partial sums.

template <bool kShared>
__device__ __forceinline__ int gather_load(const int* p) {
  return kShared ? *p : __ldg(p);
}

// Output u of a box of os rows o, ms outputs j and kn columns k (k fastest,
// then j, then o) whose first output is (o0, j0, k0): its offset in the
// instance's output from k0, and (o - o0, k - k0). A side of 1 takes no
// division (the one-load probes are bound by such arithmetic).
__device__ __forceinline__ int box_output(int u, int os, int ms, int kn, int m, int inner, int o0, int j0, int& oo,
                                          int& kk) {
  const int oj = kn == 1 ? u : u / kn;  // (o - o0) ms + (j - j0)
  kk = u - oj * kn;
  oo = os == 1 ? 0 : ms == 1 ? oj : oj / ms;
  return ((o0 + oo) * m + j0 + oj - oo * ms) * inner + kk;
}

template <bool kShared, int kUnrollBy>
__global__ void __launch_bounds__(kMaxThreads, kUnrollBy == 1 ? 2 : 1)
micro_gather(const int* __restrict__ x, const int* __restrict__ q, int* __restrict__ out, int outer, int n,
             int inner, int m, int steps, int mod, int ow, int kw, int mw, int groups, int chunk, int tiles_o) {
  extern __shared__ int smem[];
  const int b = tiles_o == 1 ? (int)blockIdx.z : (int)blockIdx.z / tiles_o;  // the instance
  const int o0 = (blockIdx.z - b * tiles_o) * ow;
  const int k0 = blockIdx.y * kw;
  const int j0 = blockIdx.x * mw;
  const int os = min(outer, o0 + ow) - o0;  // the box: os rows o, ms outputs j, kn columns k
  const int ms = min(m, j0 + mw) - j0;
  const int kn = min(inner, k0 + kw) - k0;
  const int count = os * ms * kn;
  const int line = n * inner;  // the elements of x of one o
  const int* xb = x + ((size_t)b * outer + o0) * line + k0;
  const int* qb = q + (size_t)b * outer * m * inner + k0;
  int* ob = out + (size_t)b * outer * m * inner + k0;
  unsigned* part = reinterpret_cast<unsigned*>(smem + (kShared ? ow * n * kw : 0));
  if (kShared) {
    if (kn == inner) {  // whole rows: one contiguous run
#pragma unroll 4
      for (int s = threadIdx.x; s < os * line; s += blockDim.x) smem[s] = __ldg(xb + s);
    } else {
#pragma unroll 4
      for (int s = threadIdx.x; s < os * n * kn; s += blockDim.x)
        smem[s] = __ldg(xb + (size_t)(s / kn) * inner + s % kn);
    }
    __syncthreads();
  }
  if (kUnrollBy == 1) groups = 1;  // a launch unrolled once is one group (its chunk is short)
  const int per = groups > 1 ? blockDim.x / groups : blockDim.x;  // threads a group
  const int g = groups > 1 ? threadIdx.x / per : 0;
  const int i0 = g * chunk;
  const int len = max(0, min(steps - i0, chunk));
  const int shift = g > 0 ? i0 % mod : 0;
  const int stride = kShared ? kn : inner;  // from one r to the next
  for (int u = threadIdx.x - g * per; u < count; u += per) {
    int oo, kk;
    const int e = box_output(u, os, ms, kn, m, inner, o0, j0, oo, kk);
    const int* col = (kShared ? smem + oo * n * kn : xb + oo * line) + kk;
    const int q0 = __ldg(qb + e);
    int r = (unsigned)q0 < (unsigned)mod ? q0 : floor_mod(q0, mod);
    r += shift;
    r = r >= mod ? r - mod : r;
    unsigned acc[kUnrollBy] = {};
    int i = 0;
    for (; i + kUnrollBy <= len; i += kUnrollBy) {
#pragma unroll
      for (int v = 0; v < kUnrollBy; ++v) {
        acc[v] += (unsigned)gather_load<kShared>(col + r * stride);
        r = r + 1 == mod ? 0 : r + 1;
      }
    }
    for (; i < len; ++i) {
      acc[0] += (unsigned)gather_load<kShared>(col + r * stride);
      r = r + 1 == mod ? 0 : r + 1;
    }
    unsigned sum = 0;
#pragma unroll
    for (int v = 0; v < kUnrollBy; ++v) sum += acc[v];
    if (groups > 1)
      part[g * count + u] = sum;
    else
      ob[e] = (int)sum;
  }
  if (groups > 1) {
    __syncthreads();
    for (int u = threadIdx.x; u < count; u += blockDim.x) {
      unsigned sum = 0;
      for (int h = 0; h < groups; ++h) sum += part[h * count + u];
      int oo, kk;
      ob[box_output(u, os, ms, kn, m, inner, o0, j0, oo, kk)] = (int)sum;
    }
  }
}

// ---- micro_onehot_min: E5, G4 ----------------------------------------------
// x [D, inner], q [inner] -> out [inner]: out[k] is the unsigned sum over
// steps i of min(x[r_i, k], 2^30) where 0 <= r_i < D, else 2^30; r_i =
// (q[k] + i) mod `mod` (mod > 0, G4) or q[k] itself (mod == 0, E5). The
// one-hot minimum over d has at most one term that is not 2^30, so a step
// is one indexed load. Grid (tiles, B): a block takes kw columns k (each
// output reads its own column of x), its threads in `groups` groups of
// `chunk` steps as micro_gather's, 8 loads in flight a thread, the groups'
// partial sums added in shared memory; a shared block first stages its
// columns of x, [d][kk]. Every step's load is performed: each index passes
// through opaque(), so E5's fixed index is loaded at every step too.

template <bool kShared, int kUnrollBy>
__global__ void __launch_bounds__(kMaxThreads, kUnrollBy == 1 ? 2 : 1)
micro_onehot_min(const int* __restrict__ x, const int* __restrict__ q, int* __restrict__ out, int D, int inner,
                 int steps, int mod, int kw, int groups, int chunk) {
  extern __shared__ int smem[];
  const int k0 = blockIdx.x * kw;
  const int kn = min(inner, k0 + kw) - k0;  // the block's columns
  const int* xb = x + (size_t)blockIdx.y * D * inner + k0;
  const int* qb = q + (size_t)blockIdx.y * inner + k0;
  int* ob = out + (size_t)blockIdx.y * inner + k0;
  unsigned* part = reinterpret_cast<unsigned*>(smem + (kShared ? D * kw : 0));
  if (kShared) {
#pragma unroll 4
    for (int s = threadIdx.x; s < D * kn; s += blockDim.x) smem[s] = __ldg(xb + (size_t)(s / kn) * inner + s % kn);
    __syncthreads();
  }
  if (kUnrollBy == 1) groups = 1;  // a launch unrolled once is one group (its chunk is short)
  const int per = groups > 1 ? blockDim.x / groups : blockDim.x;  // threads a group
  const int g = groups > 1 ? threadIdx.x / per : 0;
  const int i0 = g * chunk;
  const int len = max(0, min(steps - i0, chunk));
  const int stride = kShared ? kn : inner;  // from one row d to the next
  for (int kk = threadIdx.x - g * per; kk < kn; kk += per) {
    const int* col = (kShared ? smem : xb) + kk;
    int r = __ldg(qb + kk);
    if (mod > 0) {
      r = (unsigned)r < (unsigned)mod ? r : floor_mod(r, mod);
      r += g > 0 ? i0 % mod : 0;
      r = r >= mod ? r - mod : r;
    }
    // step i's select: the load of row r_i, or 2^30 where r_i is no row
    auto select = [&]() -> unsigned {
      const int ri = opaque(r);
      if (mod > 0) r = r + 1 == mod ? 0 : r + 1;
      return (unsigned)ri < (unsigned)D ? (unsigned)min(gather_load<kShared>(col + ri * stride), kBig)
                                        : (unsigned)kBig;
    };
    unsigned acc[kUnrollBy] = {};
    int i = 0;
    for (; i + kUnrollBy <= len; i += kUnrollBy) {
#pragma unroll
      for (int v = 0; v < kUnrollBy; ++v) acc[v] += select();
    }
    for (; i < len; ++i) acc[0] += select();
    unsigned sum = 0;
#pragma unroll
    for (int v = 0; v < kUnrollBy; ++v) sum += acc[v];
    if (groups > 1)
      part[g * kn + kk] = sum;
    else
      ob[kk] = (int)sum;
  }
  if (groups > 1) {
    __syncthreads();
    for (int kk = threadIdx.x; kk < kn; kk += blockDim.x) {
      unsigned sum = 0;
      for (int h = 0; h < groups; ++h) sum += part[h * kn + kk];
      ob[kk] = (int)sum;
    }
  }
}

// ---- micro_onehot_write: E6, G5 --------------------------------------------
// w = x [D, inner]; step i writes w[d, k] = (d == q_i ? val : w[d, k]) for
// every d, val = v[k] (v given, E6) or i (G5); out = the first out_rows
// rows of w. A step changes at most one row of a column, so it is one
// store, skipped where q_i lies outside [0, D) (no row matches).

// Shared (G5): grid (ceil(inner / tile), B); block t stages the columns
// [t tile, (t + 1) tile) of w, all D rows, as w_s[d * tile + kk]; each
// column's steps run in order in one thread, a store a step.
__global__ void __launch_bounds__(kMaxThreads)
onehot_write_columns(const int* __restrict__ x, const int* __restrict__ q, const int* __restrict__ v,
                     int* __restrict__ out, int D, int inner, int steps, int mod, int out_rows, int tile) {
  extern __shared__ int smem[];
  const int k0 = blockIdx.x * tile;
  const int cols = min(inner, k0 + tile) - k0;
  const int* xb = x + (size_t)blockIdx.y * D * inner + k0;
  const int* qb = q + (size_t)blockIdx.y * inner + k0;
  const int* vb = v == nullptr ? nullptr : v + (size_t)blockIdx.y * inner + k0;
  int* ob = out + (size_t)blockIdx.y * out_rows * inner + k0;
#pragma unroll 4
  for (int t = threadIdx.x; t < D * cols; t += blockDim.x) {
    const int d = t / cols, kk = t % cols;
    smem[d * tile + kk] = __ldg(xb + (size_t)d * inner + kk);
  }
  __syncthreads();
  for (int kk = threadIdx.x; kk < cols; kk += blockDim.x) {
    int* w = smem + kk;
    const int q0 = __ldg(qb + kk);
    const int vk = vb == nullptr ? 0 : __ldg(vb + kk);
    int r = mod > 0 ? floor_mod(q0, mod) : q0;
#pragma unroll 8
    for (int i = 0; i < steps; ++i) {
      if ((unsigned)r < (unsigned)D) w[r * tile] = vb == nullptr ? i : vk;
      if (mod > 0) r = r + 1 == mod ? 0 : r + 1;
    }
    // each thread owns its column, so its own stores are all it reads
    for (int d = 0; d < out_rows; ++d) ob[(size_t)d * inner + kk] = w[d * tile];
  }
}

// Device memory (E6; steps <= 1, out_rows == D): grid (ceil(D / rows), B);
// block t streams the rows [t rows, (t + 1) rows), kVec ints a thread at a
// time (16-byte vectors where inner % 4 == 0): out = d == r[k] ? val : x.
template <int kVec>
__global__ void __launch_bounds__(kMaxThreads)
onehot_write_rows(const int* __restrict__ x, const int* __restrict__ q, const int* __restrict__ v,
                  int* __restrict__ out, int D, int inner, int steps, int mod, int rows) {
  using Vec = typename std::conditional<kVec == 4, int4, int>::type;
  const int vecs = inner / kVec;
  const int d0 = blockIdx.x * rows;
  const int count = (min(D, d0 + rows) - d0) * vecs;
  const size_t base = ((size_t)blockIdx.y * D + d0) * inner;
  const Vec* xv = reinterpret_cast<const Vec*>(x + base);
  const Vec* qv = reinterpret_cast<const Vec*>(q + (size_t)blockIdx.y * inner);
  const Vec* vv = v == nullptr ? nullptr : reinterpret_cast<const Vec*>(v + (size_t)blockIdx.y * inner);
  Vec* ov = reinterpret_cast<Vec*>(out + base);
#pragma unroll 4
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int d = d0 + t / vecs;
    const int kv = t % vecs;
    Vec xs = __ldg(xv + t);
    const Vec qs = __ldg(qv + kv);
    const Vec vs = vv == nullptr ? Vec{} : __ldg(vv + kv);  // no v: the value of step 0
    int* xe = reinterpret_cast<int*>(&xs);
    const int* qe = reinterpret_cast<const int*>(&qs);
    const int* ve = reinterpret_cast<const int*>(&vs);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int r = mod > 0 ? floor_mod(qe[j], mod) : qe[j];
      xe[j] = steps > 0 && d == r ? ve[j] : xe[j];
    }
    ov[t] = xs;
  }
}

// ---- micro_row_scan: E4, E4b, G6, G7 ----------------------------------------
// x [outer, n, inner]: o_i = min(o_{i-1} + 1, x_i) down each column (o, k),
// o_{-1} = 0.
//
// Why a split of the rows gives the same bits. By induction o_i <= i + 1
// (o_i <= o_{i-1} + 1), so o_{i-1} + 1 never wraps, and the int32
// recurrence is the recurrence in exact integers, where o_i = min(i + 1,
// min_{j <= i} (x_j + i - j)): a min-plus scan. A run of rows [a, b) maps its
// carry-in c = o_{a-1} to o_{b-1} = min(c + (b - a), m), m = min_{a <= j < b}
// (x_j + b - 1 - j); (L1, m1) then (L2, m2) is (L1 + L2, min(m1 + L2, m2)),
// an associative composition, so any split of a column's rows into runs
// gives the same outputs. Since c <= a, c + (b - a) <= b <= n, so replacing
// m by min(m, n) changes no output: a thread takes its run's m as the
// recurrence itself from n over its x clamped at n, which cannot overflow.
// With the runs of a chunk of rows each r long and C the chunk's carry-in,
// run j's carry-in is c_j = j r + min(C, min_{i < j} (m_i - (i + 1) r)), a
// prefix minimum, held in int64.
//
// Grid (k tiles, o tiles x B): a tile is a box of columns, ow whole rows o
// (kw == inner) or kw columns k of one o; its threads are [run][column],
// consecutive threads on consecutive columns, so a row of the box is read
// and written in whole sectors where it is 8 columns wide. A chunk is runs x
// r rows. With runs > 1 (kSplit; r <= kRun) a thread loads its run's r
// values into registers (all loads issued before its chain starts), writes
// m_j - (j + 1) r to shared memory, takes its prefix minimum there after a
// barrier, applies its carry and writes its outputs; the block walks the
// chunks in order, carrying each column's o. With runs == 1 a thread walks
// its whole column, its loop unrolled by 4, in 32 registers or fewer so
// that two blocks of 1024 threads share an SM: the one-block walk at a
// batch that fills the card (16 loads in flight a thread there measured,
// on an H100, 2.5-3.4% slower at B_fill on E4, E4b and G7, and spilled at 32
// registers). Every element is read once and written once.

constexpr int kRun = 16;  // rows a thread holds in registers where a column's rows are split

template <bool kSplit>
__global__ void __launch_bounds__(kMaxThreads, kSplit ? 1 : 2)
micro_row_scan(const int* __restrict__ x, int* __restrict__ out, int outer, int n, int inner, int ow, int kw,
               int runs, int r, int tiles_o) {
  __shared__ long long lows[kSplit ? kMaxThreads : 1];  // a chunk's m_j - (j + 1) r, [run][column]
  const int b = blockIdx.y / tiles_o;
  const int o0 = (blockIdx.y - b * tiles_o) * ow;
  const int k0 = blockIdx.x * kw;
  const int kn = min(inner, k0 + kw) - k0;
  const int count = (min(outer, o0 + ow) - o0) * kn;  // the box's columns: its rows o times kn columns k
  const int box = blockDim.x / runs;
  const int j = threadIdx.x / box;  // the thread's run
  const int u = threadIdx.x - j * box;  // its column in the box
  const int oo = u / kn;
  const size_t col = ((size_t)b * outer + o0 + oo) * n * inner + k0 + (u - oo * kn);
  const int* xc = x + col;
  int* oc = out + col;
  int carry = 0;  // o of the row before the rows at hand
  if (!kSplit) {
    if (u >= count) return;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      carry = min(carry + 1, __ldg(xc + (size_t)i * inner));
      oc[(size_t)i * inner] = carry;
    }
    return;
  }
  const int chunk = runs * r;
  for (int a = 0; a < n; a += chunk) {
    const int row0 = a + j * r;
    const int len = u < count ? max(0, min(n - row0, r)) : 0;
    int v[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (i < len) v[i] = __ldg(xc + (size_t)(row0 + i) * inner);
    int m = n;
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (i < len) m = min(m + 1, min(v[i], n));
    lows[threadIdx.x] = (long long)m - (long long)(j + 1) * r;
    __syncthreads();
    const int upto = a + chunk < n ? runs : j;  // the whole chunk where another follows
    long long low = carry, before = carry;
    for (int i = 0; i < upto; ++i) {
      if (i == j) before = low;
      low = min(low, lows[i * box + u]);
    }
    if (upto == j) before = low;
    int o = (int)((long long)j * r + before);
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (i < len) {
        o = min(o + 1, v[i]);
        oc[(size_t)(row0 + i) * inner] = o;
      }
    carry = (int)(chunk + low);  // read only where another chunk follows
    __syncthreads();
  }
}

// The launch floor the probes are read against.
__global__ void micro_empty() {}

bool fits_int(long long a) { return a > 0 && a <= 0x7fffffffLL; }

template <bool kShared, int kUnrollBy>
cudaError_t launch_gather(dim3 grid, long long threads, int smem, cudaStream_t s, const void* x, const void* q,
                          void* out, int outer, int n, int inner, int m, int steps, int mod, int ow, int kw, int mw,
                          int groups, int chunk, int tiles_o) {
  const cudaError_t err = allow_smem(micro_gather<kShared, kUnrollBy>, smem);
  if (err != cudaSuccess) return err;
  micro_gather<kShared, kUnrollBy><<<grid, (int)threads, smem, s>>>(
      (const int*)x, (const int*)q, (int*)out, outer, n, inner, m, steps, mod, ow, kw, mw, groups, chunk, tiles_o);
  return cudaGetLastError();
}

template <bool kShared, int kUnrollBy>
cudaError_t launch_onehot_min(dim3 grid, long long threads, int smem, cudaStream_t s, const void* x, const void* q,
                              void* out, int D, int inner, int steps, int mod, int kw, int groups, int chunk) {
  const cudaError_t err = allow_smem(micro_onehot_min<kShared, kUnrollBy>, smem);
  if (err != cudaSuccess) return err;
  micro_onehot_min<kShared, kUnrollBy><<<grid, (int)threads, smem, s>>>((const int*)x, (const int*)q, (int*)out, D,
                                                                        inner, steps, mod, kw, groups, chunk);
  return cudaGetLastError();
}

}  // namespace

// tile: lanes a block (_micro.py's lane_geometry).
extern "C" int sdf_micro_ops(const void* x, void* out, int B, int elems, int steps, int tile, void* stream) {
  if (B <= 0 || B > 65535 || elems <= 0 || steps < 0 || tile <= 0) return (int)cudaErrorInvalidValue;
  const int t = tile < elems ? tile : elems;
  const dim3 grid((elems + t - 1) / t, B);
  micro_ops<<<grid, threads_for(t), 0, (cudaStream_t)stream>>>((const int*)x, (int*)out, elems, steps, t);
  return (int)cudaGetLastError();
}

// ow, kw, mw: a tile's box (ow rows o; or kw columns k of one o, ow == 1;
// or mw outputs j of one column, ow == kw == 1); groups, chunk: the step
// groups of a block and the steps of each (_micro.py's gather_geometry).
// With several groups a group has a thread for each of the box's outputs.
extern "C" int sdf_micro_gather(const void* x, const void* q, void* out, int B, int outer, int n, int inner, int m,
                                int steps, int mod, int shared, int ow, int kw, int mw, int groups, int chunk,
                                void* stream) {
  if (B <= 0 || B > 65535 || outer <= 0 || n <= 0 || inner <= 0 || m <= 0 || steps < 0 || mod <= 0 || ow <= 0 ||
      kw <= 0 || mw <= 0 || (ow > 1 && (kw < inner || mw < m)) || (kw > 1 && mw < m) || groups <= 0 ||
      chunk <= 0 || (long long)groups * chunk < steps || !fits_int((long long)outer * n * inner) ||
      !fits_int((long long)outer * m * inner))
    return (int)cudaErrorInvalidValue;
  const int os = ow < outer ? ow : outer;
  const int kn = kw < inner ? kw : inner;
  const int ms = mw < m ? mw : m;
  const long long tiles_o = (outer + os - 1) / os;
  const dim3 grid((m + ms - 1) / ms, (inner + kn - 1) / kn, (unsigned)(tiles_o * B));
  const long long count = (long long)os * ms * kn;  // a box's outputs at most
  const long long threads = groups > 1 ? count * groups : threads_for(count);
  if (grid.y > 65535 || tiles_o * B > 65535 || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const long long bytes = ((shared ? (long long)os * n * kn : 0) + (groups > 1 ? groups * count : 0)) * 4;
  const int smem = bytes > kSmemMax ? kSmemMax + 1 : (int)bytes;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool once = groups == 1 && chunk < 2 * kUnroll;  // fewer than two rounds of steps, one group
  cudaError_t err;
  if (shared)
    err = once ? launch_gather<true, 1>(grid, threads, smem, s, x, q, out, outer, n, inner, m, steps, mod, os, kn, ms,
                                        groups, chunk, (int)tiles_o)
               : launch_gather<true, kUnroll>(grid, threads, smem, s, x, q, out, outer, n, inner, m, steps, mod, os,
                                              kn, ms, groups, chunk, (int)tiles_o);
  else
    err = once ? launch_gather<false, 1>(grid, threads, smem, s, x, q, out, outer, n, inner, m, steps, mod, os, kn,
                                         ms, groups, chunk, (int)tiles_o)
               : launch_gather<false, kUnroll>(grid, threads, smem, s, x, q, out, outer, n, inner, m, steps, mod, os,
                                               kn, ms, groups, chunk, (int)tiles_o);
  return (int)err;
}

// kw, groups, chunk: a block's columns, its step groups and the steps of
// each (_micro.py's onehot_min_geometry); with several groups a group has
// a thread for each of the block's columns.
extern "C" int sdf_micro_onehot_min(const void* x, const void* q, void* out, int B, int D, int inner, int steps,
                                    int mod, int shared, int kw, int groups, int chunk, void* stream) {
  if (B <= 0 || B > 65535 || D <= 0 || inner <= 0 || steps < 0 || mod < 0 || kw <= 0 || groups <= 0 || chunk <= 0 ||
      (long long)groups * chunk < steps || !fits_int((long long)D * inner))
    return (int)cudaErrorInvalidValue;
  const int kn = kw < inner ? kw : inner;
  const dim3 grid((inner + kn - 1) / kn, B);
  const long long threads = groups > 1 ? (long long)kn * groups : threads_for(kn);
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const long long bytes = ((shared ? (long long)D * kn : 0) + (groups > 1 ? (long long)groups * kn : 0)) * 4;
  const int smem = bytes > kSmemMax ? kSmemMax + 1 : (int)bytes;
  const bool once = groups == 1 && chunk < 2 * kUnroll;  // fewer than two rounds of steps, one group
  const cudaStream_t s = (cudaStream_t)stream;
  if (shared)
    return (int)(once ? launch_onehot_min<true, 1>(grid, threads, smem, s, x, q, out, D, inner, steps, mod, kn,
                                                   groups, chunk)
                      : launch_onehot_min<true, kUnroll>(grid, threads, smem, s, x, q, out, D, inner, steps, mod, kn,
                                                         groups, chunk));
  return (int)(once ? launch_onehot_min<false, 1>(grid, threads, smem, s, x, q, out, D, inner, steps, mod, kn, groups,
                                                  chunk)
                    : launch_onehot_min<false, kUnroll>(grid, threads, smem, s, x, q, out, D, inner, steps, mod, kn,
                                                        groups, chunk));
}

// tile: columns a block takes (shared) or rows (device memory; there only
// steps <= 1, out_rows == D); _micro.py's onehot_write_geometry.
extern "C" int sdf_micro_onehot_write(const void* x, const void* q, const void* v, void* out, int B, int D,
                                      int inner, int steps, int mod, int out_rows, int shared, int tile,
                                      void* stream) {
  if (B <= 0 || B > 65535 || D <= 0 || inner <= 0 || steps < 0 || mod < 0 || out_rows <= 0 || out_rows > D ||
      tile <= 0 || !fits_int((long long)D * inner))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    const int cols = tile < inner ? tile : inner;
    const long long bytes = (long long)D * cols * 4;
    const int b = bytes > kSmemMax ? kSmemMax + 1 : (int)bytes;
    const cudaError_t err = allow_smem(onehot_write_columns, b);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((inner + cols - 1) / cols, B);
    onehot_write_columns<<<grid, threads_for(cols > kStageThreads ? cols : kStageThreads), b, s>>>(
        (const int*)x, (const int*)q, (const int*)v, (int*)out, D, inner, steps, mod, out_rows, cols);
    return (int)cudaGetLastError();
  }
  // in device memory the write is one pass of one step over every row
  if (steps > 1 || out_rows != D) return (int)cudaErrorInvalidValue;
  const int rows = tile < D ? tile : D;
  const dim3 grid((D + rows - 1) / rows, B);
  if (inner % 4 == 0) {
    onehot_write_rows<4><<<grid, threads_for((long long)rows * inner / 4), 0, s>>>(
        (const int*)x, (const int*)q, (const int*)v, (int*)out, D, inner, steps, mod, rows);
  } else {
    onehot_write_rows<1><<<grid, threads_for((long long)rows * inner), 0, s>>>(
        (const int*)x, (const int*)q, (const int*)v, (int*)out, D, inner, steps, mod, rows);
  }
  return (int)cudaGetLastError();
}

// ow, kw: a tile's box (ow whole rows o; or kw columns k of one o, ow ==
// 1); runs, r: a chunk's runs of rows and the rows of each, at most kRun
// (runs == 1: a thread a column, r unused; _micro.py's row_scan_geometry).
extern "C" int sdf_micro_row_scan(const void* x, void* out, int B, int outer, int n, int inner, int ow, int kw,
                                  int runs, int r, void* stream) {
  if (B <= 0 || B > 65535 || outer <= 0 || n <= 0 || n >= (1 << 30) || inner <= 0 || ow <= 0 || kw <= 0 ||
      (ow > 1 && kw < inner) || runs <= 0 || r <= 0 || (runs > 1 && r > kRun) ||
      !fits_int((long long)outer * n * inner))
    return (int)cudaErrorInvalidValue;
  const int os = ow < outer ? ow : outer;
  const int kn = kw < inner ? kw : inner;
  const long long tiles_o = (outer + os - 1) / os;
  const long long threads = (long long)os * kn * runs;  // exactly [run][column]: the kernel divides by runs
  if (threads > kMaxThreads || tiles_o * B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((inner + kn - 1) / kn, (unsigned)(tiles_o * B));
  const cudaStream_t s = (cudaStream_t)stream;
  if (runs == 1)
    micro_row_scan<false><<<grid, (int)threads, 0, s>>>((const int*)x, (int*)out, outer, n, inner, os, kn, 1, n,
                                                        (int)tiles_o);
  else
    micro_row_scan<true><<<grid, (int)threads, 0, s>>>((const int*)x, (int*)out, outer, n, inner, os, kn, runs,
                                                       r < n ? r : n, (int)tiles_o);
  return (int)cudaGetLastError();
}

extern "C" int sdf_micro_empty(void* stream) {
  micro_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
