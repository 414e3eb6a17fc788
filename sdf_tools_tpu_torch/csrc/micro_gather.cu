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
//                       min over d of (d == q_i ? x[d, k] : 2^30).
//   micro_onehot_write  E6 (gather.py:225), G5 (gather2.py:150): the one-hot
//                       stack write, w[d, k] = (d == q_i ? v : w[d, k]) for
//                       every d, each step.
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
// Batch: every probe takes a leading axis of B independent instances, one
// block each (a TPU probe is one (8, 128)-tiled block on one core; B = 1 is
// its call). A block has up to 1024 threads, one per output element,
// column or line, each looping over the rest, with neighbouring threads on
// neighbouring k so that every row's loads and stores are coalesced.
//
// Which memory each probe reads is what it measures on this card:
//   - shared memory: an x of an instance that fits in a block's 227 KB is
//     staged there once (coalesced), then read by per-thread index, the
//     access of csrc/envelope_search.cuh (one warp per line reading f[j]
//     and J by lane-dependent j). E3, G3, H1, H2, H4-H7 (gathers), G4 (one-
//     hot min) and G5 (one-hot write; its scratch is the staged copy);
//   - device memory through L1/L2 (read-only loads): an x over 227 KB, the
//     2 MiB probes E1, E1b, E2, E6 and the 256 KiB ones E5, G1, G2, H3, H8,
//     reread each step from the caches;
//   - the row scans (E4, E4b, G6, G7) read each element once from device
//     memory and write it once; staging would only add a copy;
//   - G8 reads x once into registers.
// The wrapper (sdf_tools_tpu_torch/scripts/_micro.py) chooses shared or
// device memory by the same 227 KB rule and passes it down.
//
// Bound on this card: the bytes each probe must move (the elements of x
// its output depends on and every other input read once, each output
// written once, 3.35 TB/s) or its 32-bit operations at the 67 TFLOP/s
// float32 rate, whichever is larger. For the in-loop probes
// neither counts the on-chip rereads that are the point of the probe, so
// at B = 1 (one block on one of 132 SMs) the launch latency and the one
// SM's shared-memory or L1 rate bound them, not the device. The design does
// nothing to hide that: these kernels are probes, simple and right; their
// time per instance-element-step at a batch that fills the card is their
// answer.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemMax = 232448;        // a block's shared memory on H100 (227 KB)
constexpr int kSmemDefault = 48 * 1024; // above this only after cudaFuncSetAttribute
constexpr int kBig = 1 << 30;           // the one-hot min's "no match"

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

// Copy count ints of one instance into shared memory, all threads, then
// wait for the block.
__device__ __forceinline__ void stage(int* dst, const int* src, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = __ldg(src + t);
  __syncthreads();
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

__global__ void __launch_bounds__(kMaxThreads)
micro_ops(const int* __restrict__ x, int* __restrict__ out, int elems, int steps) {
  const size_t base = (size_t)blockIdx.x * elems;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int xe = __ldg(x + base + e);
    int acc = 0;
    for (int i = 0; i < steps; ++i)
      acc = min((int)((unsigned)acc * 2u + 1u), wrap_add(xe, i));
    out[base + e] = acc;
  }
}

// ---- micro_gather: E1, E1b, E2, E3, G1-G3, H1-H8 ---------------------------

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
micro_gather(const int* __restrict__ x, const int* __restrict__ q, int* __restrict__ out,
             int outer, int n, int inner, int m, int steps, int mod) {
  extern __shared__ int smem[];
  const int x_count = outer * n * inner;
  const int q_count = outer * m * inner;
  const int* xb = x + (size_t)blockIdx.x * x_count;
  const int* qb = q + (size_t)blockIdx.x * q_count;
  int* ob = out + (size_t)blockIdx.x * q_count;
  if (kShared) stage(smem, xb, x_count);
  for (int e = threadIdx.x; e < q_count; e += blockDim.x) {
    const int k = e % inner;
    const int o = e / (m * inner);
    const int* line = (kShared ? smem : xb) + o * n * inner + k;
    int r = floor_mod(__ldg(qb + e), mod);
    unsigned acc = 0;
    for (int i = 0; i < steps; ++i) {
      acc += (unsigned)(kShared ? line[r * inner] : __ldg(line + r * inner));
      r = r + 1 == mod ? 0 : r + 1;
    }
    ob[e] = (int)acc;
  }
}

// ---- micro_onehot_min: E5, G4 ----------------------------------------------
// x [D, inner], q [inner] -> out [inner]. mod > 0: the index of step i is
// (q + i) mod `mod` (G4); mod == 0: q itself at every step (E5).

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
micro_onehot_min(const int* __restrict__ x, const int* __restrict__ q, int* __restrict__ out,
                 int D, int inner, int steps, int mod) {
  extern __shared__ int smem[];
  const int x_count = D * inner;
  const int* xb = x + (size_t)blockIdx.x * x_count;
  const int* qb = q + (size_t)blockIdx.x * inner;
  int* ob = out + (size_t)blockIdx.x * inner;
  if (kShared) stage(smem, xb, x_count);
  const int* src = kShared ? smem : xb;
  for (int k = threadIdx.x; k < inner; k += blockDim.x) {
    const int q0 = __ldg(qb + k);
    int r = mod > 0 ? floor_mod(q0, mod) : q0;
    unsigned acc = 0;
    for (int i = 0; i < steps; ++i) {
      const int qi = opaque(r);
      int best = kBig;
      for (int d = 0; d < D; ++d) {
        const int v = kShared ? src[d * inner + k] : __ldg(src + d * inner + k);
        best = min(best, d == qi ? v : kBig);
      }
      acc += (unsigned)best;
      if (mod > 0) r = r + 1 == mod ? 0 : r + 1;
    }
    ob[k] = (int)acc;
  }
}

// ---- micro_onehot_write: E6, G5 --------------------------------------------
// w = x [D, inner]; step i writes w[d, k] = (d == q_i ? val : w[d, k]) for
// every d, val = v[k] (v given, E6) or i (G5); out = the first out_rows
// rows of w. Shared: w is the staged copy (G5). Device memory: w is out
// itself, its first step reading x (E6; out_rows == D).

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
micro_onehot_write(const int* __restrict__ x, const int* __restrict__ q, const int* __restrict__ v,
                   int* __restrict__ out, int D, int inner, int steps, int mod, int out_rows) {
  extern __shared__ int smem[];
  const int x_count = D * inner;
  const int* xb = x + (size_t)blockIdx.x * x_count;
  const int* qb = q + (size_t)blockIdx.x * inner;
  const int* vb = v == nullptr ? nullptr : v + (size_t)blockIdx.x * inner;
  int* ob = out + (size_t)blockIdx.x * out_rows * inner;
  if (kShared) stage(smem, xb, x_count);
  int* w = kShared ? smem : ob;
  for (int k = threadIdx.x; k < inner; k += blockDim.x) {
    const int q0 = __ldg(qb + k);
    int r = mod > 0 ? floor_mod(q0, mod) : q0;
    for (int i = 0; i < steps; ++i) {
      const int val = vb == nullptr ? i : __ldg(vb + k);
      const int* src = (!kShared && i == 0) ? xb : w;
      for (int d = 0; d < D; ++d) w[d * inner + k] = d == r ? val : src[d * inner + k];
      if (mod > 0) r = r + 1 == mod ? 0 : r + 1;
    }
    // each thread owns its columns k, so its own writes are all it reads
    if (kShared)
      for (int d = 0; d < out_rows; ++d) ob[d * inner + k] = w[d * inner + k];
  }
}

// ---- micro_row_scan: E4, E4b, G6, G7 ----------------------------------------
// x [outer, n, inner]: one thread per column (o, k) runs the recurrence
// along n, reading and writing each element once.

__global__ void __launch_bounds__(kMaxThreads)
micro_row_scan(const int* __restrict__ x, int* __restrict__ out, int outer, int n, int inner) {
  const size_t base = (size_t)blockIdx.x * outer * n * inner;
  for (int c = threadIdx.x; c < outer * inner; c += blockDim.x) {
    const size_t col = base + (size_t)(c / inner) * n * inner + c % inner;
    int carry = 0;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      carry = min(wrap_add(carry, 1), __ldg(x + col + (size_t)i * inner));
      out[col + (size_t)i * inner] = carry;
    }
  }
}

// The launch floor the probes are read against.
__global__ void micro_empty() {}

bool fits_int(long long a) { return a > 0 && a <= 0x7fffffffLL; }

}  // namespace

extern "C" int sdf_micro_ops(const void* x, void* out, int B, int elems, int steps, void* stream) {
  if (B <= 0 || elems <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  micro_ops<<<B, threads_for(elems), 0, (cudaStream_t)stream>>>((const int*)x, (int*)out, elems, steps);
  return (int)cudaGetLastError();
}

extern "C" int sdf_micro_gather(const void* x, const void* q, void* out, int B, int outer, int n,
                                int inner, int m, int steps, int mod, int shared, void* stream) {
  if (B <= 0 || outer <= 0 || n <= 0 || inner <= 0 || m <= 0 || steps < 0 || mod <= 0 ||
      !fits_int((long long)outer * n * inner) || !fits_int((long long)outer * m * inner))
    return (int)cudaErrorInvalidValue;
  const int threads = threads_for((long long)outer * m * inner);
  const cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    const int bytes = outer * n * inner > kSmemMax / 4 ? kSmemMax + 1 : outer * n * inner * 4;
    const cudaError_t err = allow_smem(micro_gather<true>, bytes);
    if (err != cudaSuccess) return (int)err;
    micro_gather<true><<<B, threads, bytes, s>>>((const int*)x, (const int*)q, (int*)out, outer, n, inner, m,
                                                 steps, mod);
  } else {
    micro_gather<false><<<B, threads, 0, s>>>((const int*)x, (const int*)q, (int*)out, outer, n, inner, m,
                                              steps, mod);
  }
  return (int)cudaGetLastError();
}

extern "C" int sdf_micro_onehot_min(const void* x, const void* q, void* out, int B, int D, int inner,
                                    int steps, int mod, int shared, void* stream) {
  if (B <= 0 || D <= 0 || inner <= 0 || steps < 0 || mod < 0 || !fits_int((long long)D * inner))
    return (int)cudaErrorInvalidValue;
  const int threads = threads_for(inner);
  const cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    const int bytes = D * inner > kSmemMax / 4 ? kSmemMax + 1 : D * inner * 4;
    const cudaError_t err = allow_smem(micro_onehot_min<true>, bytes);
    if (err != cudaSuccess) return (int)err;
    micro_onehot_min<true><<<B, threads, bytes, s>>>((const int*)x, (const int*)q, (int*)out, D, inner, steps,
                                                     mod);
  } else {
    micro_onehot_min<false><<<B, threads, 0, s>>>((const int*)x, (const int*)q, (int*)out, D, inner, steps,
                                                  mod);
  }
  return (int)cudaGetLastError();
}

extern "C" int sdf_micro_onehot_write(const void* x, const void* q, const void* v, void* out, int B, int D,
                                      int inner, int steps, int mod, int out_rows, int shared, void* stream) {
  if (B <= 0 || D <= 0 || inner <= 0 || steps < 0 || mod < 0 || out_rows <= 0 || out_rows > D ||
      !fits_int((long long)D * inner))
    return (int)cudaErrorInvalidValue;
  // in device memory the work buffer is out itself, so it holds every row
  if (!shared && out_rows != D) return (int)cudaErrorInvalidValue;
  const int threads = threads_for(inner);
  const cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    const int bytes = D * inner > kSmemMax / 4 ? kSmemMax + 1 : D * inner * 4;
    const cudaError_t err = allow_smem(micro_onehot_write<true>, bytes);
    if (err != cudaSuccess) return (int)err;
    micro_onehot_write<true><<<B, threads, bytes, s>>>((const int*)x, (const int*)q, (const int*)v, (int*)out,
                                                       D, inner, steps, mod, out_rows);
  } else {
    micro_onehot_write<false><<<B, threads, 0, s>>>((const int*)x, (const int*)q, (const int*)v, (int*)out, D,
                                                    inner, steps, mod, out_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" int sdf_micro_row_scan(const void* x, void* out, int B, int outer, int n, int inner, void* stream) {
  if (B <= 0 || outer <= 0 || n <= 0 || inner <= 0 || !fits_int((long long)outer * n * inner))
    return (int)cudaErrorInvalidValue;
  micro_row_scan<<<B, threads_for((long long)outer * inner), 0, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, outer, n, inner);
  return (int)cudaGetLastError();
}

extern "C" int sdf_micro_empty(void* stream) {
  micro_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
