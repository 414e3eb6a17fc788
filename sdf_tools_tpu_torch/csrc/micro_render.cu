// The render-design probes on Hopper: the primitives the plane-sweep
// renderer is made of (a band of a plane at a data-dependent base, its sum,
// the bilinear sampler of a ray row, a dynamic-offset copy of a band), each
// measured alone. They replace the TPU probes that chose the plane sweep's
// design:
//
//   micro_band_sum  R2 `load` (scripts/bench_micro_render2.py:45 make_kernel,
//                   its pallas_call at :99); R3, all 8 variants
//                   (bench_micro_render3.py:22 make_kernel and :67
//                   make_unroll_kernel, call :96); R4 `tab_load`
//                   (bench_micro_render4.py:31, call :81); R5 `fori`, `smem`,
//                   `load_s`, `load_d0`, `load_dsub`, `load_d2d`
//                   (bench_micro_render5.py:46, call :100). A chain of
//                   float32 adds over items, each item adding the sum of an
//                   H x W band (and, by variant, its bases).
//   micro_sampler   R1 (bench_micro_render.py:33 kernel, call :72); R2
//                   `loadtaa`, `full`, `static`, `mxu`; R4 `tab_full`; R5
//                   `sample`; R6 `sample9` (bench_micro_render6.py:25
//                   make_kernel, call :151). The bilinear sample of a row of
//                   128 rays, summed over the rays and chained over items (R6:
//                   chained per ray).
//   micro_band_copy S1 (scripts/probe_smem_block.py:24 probe1, call :32), S2
//                   (:44 probe2, call :67), D1 (scripts/probe_dma_align.py:17
//                   kernel, call :38), R6 `smem_rw`, `dma`, `dma_ovl`. A table
//                   row staged in shared memory, and dynamic-offset copies of
//                   bands into shared memory.
//
// Summation order. Every float sum here has one order, which the plain
// versions (sdf_tools_tpu_torch/scripts/_sampler.py) write out with
// reshapes and elementwise adds:
//   - a sum over a band of H x W (W a multiple of 128), or over a ray row
//     (1 x 128): partial t of 128 adds the elements t, t + 128, t + 256,
//     ... of the row-major band in order from 0.0f; then a fixed tree over
//     the 128 partials, p[t] += p[t + w] for w = 64, 32, ..., 1. A warp
//     holds the 128 partials of an item, lane l partials l, l + 32, l + 64
//     and l + 96 (the first two levels in registers, the rest by shuffles);
//   - the TPU probes' loops (rows in a step, steps, iterations) are chains:
//     acc = acc + term, in the probes' order, by one thread. A nested probe
//     (R1-R3) starts each step's chain at 0.0f and adds it to the total.
//     Every step of R1-R3 has the same items, so each step's chain is the
//     same, bit for bit: the kernels compute it once and add it `steps`
//     times, as the plain versions do.
// Sums of one-hot selects have one nonzero term, so they are exact in any
// order: a selected value is read by index. The MXU variant's one-hot
// products are fp32 FMAs (fmaf), exact for a one-hot operand; TF32 would
// round the band. The library builds with -fmad=false, so a product and a
// sum round apart, as in the plain versions.
//
// Memory each probe reads on this card:
//   - the (512, 512) float32 plane and the (64, 8, 512) cube (1 MiB each)
//     stay in the 50 MB L2; the bands and corners are read from there
//     through L1 (read-only loads), not staged: a band is read once per item
//     (the band sums) or in four corners a ray (the sampler), so staging
//     would only add a copy. The MXU variant reads its band rows as float4
//     broadcasts from L1;
//   - the copy probes stage what they copy in shared memory by bulk
//     asynchronous copies (cp.async.bulk, the counterpart of
//     pltpu.make_async_copy), one per contiguous run of the band, completing
//     on an mbarrier whose expected bytes are the band's: S2's (2, 32, 256)
//     float32 slab is one run of 64 KiB; D1's (4, 16, 128) float32 band 64
//     runs of 512 B at 32-byte offsets (its lane offset 8 * zb, the TPU
//     probe's question; a bulk copy needs 16-byte alignment of address and
//     size, which 8 floats give); R6's (9, 32, 256) bfloat16 band 288 runs
//     of 512 B at 0 or 256 B into a row of the 512^3 volume (256 MiB, in
//     device memory: each iteration's band is new). S1's and S2's table
//     rows (64 B) and D1's (32 B) are one bulk copy each (the TPU probes'
//     SMEM blocks);
//   - `dma_ovl`: two (9, 32, 256) bfloat16 bands take 288 KiB, over the
//     227 KB a block may have, so the TPU probe's double buffer does not
//     fit. The copies stream instead through a ring of kRingStages = 4
//     stages of kRingPlanes = 3 planes (48 KiB) each, 192 KiB, a band and
//     a third, so that the next band's first planes are in flight while
//     the current band's last ones land. (A ring of twelve one-plane
//     stages, a wait a plane, ran 2.3x `dma`'s time; PERF.md.) Plane 0 of
//     band i is read at iteration i, as in `dma`, so the output is
//     `dma`'s bit for bit.
//   - R6 `smem_rw` keeps its 128 counters in shared memory; the TPU probe
//     never initialises them, the port zero-fills them (a block that takes
//     a later run of the iterations starts them where they would stand).
//
// Batch: every probe takes a leading axis of B instances. The data (plane,
// cube, volume) is shared by the batch; the ray rows and tables are the
// instance's own. S1, S2 and D1 run one block an instance's table row, as
// the TPU grid's steps: at B = 1 they are at the launch floor (one row's
// work is a few hundred nanoseconds), so spreading them gains nothing.
//
// micro_band_sum, micro_sampler and R6's copies spread an instance over
// the card. Only the chain is serial; an item's term (its band sum, or its
// ray row's sampled sum, and its bases; an iteration's band row) depends on
// no other item. So:
//   - an instance's items (the M = per_step distinct items; the steps of
//     R1-R3 repeat them) are cut into `tiles` runs of `chunk` consecutive
//     items, one block each: ceil(4 x SMs / B) blocks an instance, one
//     from B_fill = 4 x SMs on (_sampler.py's render_geometry). A block's
//     warps take its items in turn, an item a warp (MXU: an item the
//     block's, its 2 x 16 one-hot rows of a ray spread over four threads),
//     so neighbouring items' bands are read by one block, through its L1.
//     No barrier stands between items;
//   - each item's addends (the terms the chain adds, in its order) go to a
//     device buffer the wrapper allocates with torch.empty ([B, stride]
//     floats, written before they are read, so never zero-filled). A band
//     that depends on no item (R5 `load_s`) is summed once, by the
//     instance's first block, into the buffer's last slot;
//   - the chain runs after the terms, in the same order, in a second kernel
//     launched by the same C entry point on the same stream (micro_chain,
//     a block an instance): its thread 0 streams the instance's terms into
//     shared memory through a ring of bulk copies, kChainStages of
//     kChainFloats, and chains them. (The other candidate, the instance's
//     last block chaining after an arrival counter, measured 4% slower at
//     B = 1 and 6% at B_fill over the band sums; PERF.md.);
//   - R6 `sample9` keeps the TPU probe's copy of each iteration's band into
//     shared memory (the probe's subject): a block takes a run of
//     iterations, copies each band, samples it and writes its 128 rays'
//     terms ([B, iterations, 128]); micro_ray_chain chains each ray through
//     a ring of bulk copies of kTermIters iterations' terms. From B_fill on
//     (one block an instance) it chains in registers and writes no terms;
//   - R6 `dma` and `dma_ovl` do the same with the copy alone: a block takes
//     a run of iterations and copies each band (`dma_ovl`: streams its run
//     of bands through its own ring), lane t's term is element t of the
//     band's first row, and micro_ray_chain chains each lane. A band (144
//     KiB, `dma_ovl`'s ring 192 KiB) leaves room for one block an SM;
//   - R6 `smem_rw`: a block takes a run of iterations; its counter r starts
//     at the earlier iterations of row r, (first - r + 127) >> 7 for a run
//     from `first`, so that each read returns the plain version's count.
//     Every value read and every partial sum of them is an integer below
//     2^24 (the wrapper checks the instance's total and raises past it), so
//     float adds of them are exact in any grouping: thread 0 sums its
//     block's values, and micro_chain chains the blocks' partial sums into
//     the probe's total, bit for bit its chain of 16,384 adds.
//
// Bound on this card: each input element the output depends on read once
// and the output written once, at 3.35 TB/s, or the function's operations
// at the 67 TFLOP/s float32 rate, whichever is larger. The chain is serial
// by definition (one dependent add an addend, about 4 cycles), so a probe
// of many items at B = 1 is bound by its chain, not the device. R6's
// copies move far more than their output needs (each iteration's whole
// band, the probe's subject, for 128 of its elements): spread over the
// card they are bound by the copies' rate, a chain of 16,384 adds a lane
// behind them. A wait on a copy that does not complete within kSpinLimit
// cycles traps, so a wrong expected byte count fails the launch instead of
// hanging the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;               // rays of a row; partials of a sum; threads of a sample9 block
constexpr int kWarps = 16;                // warps of a band-sum or sampler block: an item each
constexpr int kThreads = 32 * kWarps;
constexpr int kChainFloats = 2048;        // a chain stage: addends copied into shared memory at a time (8 KiB)
constexpr int kChainStages = 3;
constexpr int kTermIters = 64;            // a sample9 chain stage: iterations of 128 rays' terms (32 KiB)
constexpr int kTermStages = 4;
constexpr int kSmemMax = 232448;          // a block's shared memory on H100 (227 KB)
constexpr int kSmemDefault = 48 * 1024;   // above this only after cudaFuncSetAttribute
constexpr int kRingStages = 4;            // dma_ovl's ring: stages of kRingPlanes planes
constexpr int kRingPlanes = 3;
constexpr long long kSpinLimit = 1LL << 32;  // cycles (about 2 s) before a stuck copy traps

// ---- small pieces ---------------------------------------------------------

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// floor(x) converted to int32 as XLA converts: saturated, NaN -> 0
// (grid.floor_to_int32 in the port)
__device__ __forceinline__ int floor_to_int(float x) {
  const float f = floorf(x);
  if (f != f) return 0;
  if (f >= 2147483648.0f) return 2147483647;
  if (f <= -2147483648.0f) return (int)0x80000000;
  return (int)f;
}

// the band bases of a ray row from a warp's floors of its 128 y and z
// (lane l holds rays l, l + 32, l + 64, l + 96): min floor(y) rounded down
// to 8, min floor(z) to 128
__device__ __forceinline__ void warp_bases(int my, int mz, int& yb, int& zb) {
  for (int o = 16; o > 0; o >>= 1) {
    my = min(my, __shfl_xor_sync(0xffffffffu, my, o));
    mz = min(mz, __shfl_xor_sync(0xffffffffu, mz, o));
  }
  yb = floor_div(my, 8) * 8;
  zb = floor_div(mz, 128) * 128;
}

// the same, the warp reading the row's 128 values itself
__device__ __forceinline__ void row_bases(const float* y, const float* z, int& yb, int& zb) {
  const int l = threadIdx.x & 31;
  int my = floor_to_int(__ldg(y + l)), mz = floor_to_int(__ldg(z + l));
  for (int j = 1; j < kLanes / 32; ++j) {
    my = min(my, floor_to_int(__ldg(y + l + 32 * j)));
    mz = min(mz, floor_to_int(__ldg(z + l + 32 * j)));
  }
  warp_bases(my, mz, yb, zb);
}

// the tree over 128 partials held by a warp (lane l: p[l], p[l + 32],
// p[l + 64], p[l + 96]): lane 0 returns p[t] += p[t + w] for w = 64, ..., 1
__device__ __forceinline__ float tree128(float p0, float p1, float p2, float p3) {
  float v = (p0 + p2) + (p1 + p3);
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// the bilinear combine of the JAX probes, evaluated left to right
__device__ __forceinline__ float combine(float v00, float v01, float v10, float v11, float fy, float fz) {
  const float gy = 1.0f - fy, gz = 1.0f - fz;
  return ((v00 * gy * gz + v01 * gy * fz) + v10 * fy * gz) + v11 * fy * fz;
}

// ---- bulk copies into shared memory -----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wait for the phase of `parity` to complete; trap after kSpinLimit cycles
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

// A band (P, BY, BZ) of a volume (nx, ny, nz) of es-byte elements, copied
// to contiguous shared memory as its contiguous runs: rows of BZ elements,
// whole planes when BZ == nz, the whole band when also BY == ny.
struct Band {
  const char* vol;
  int es, nx, ny, nz, P, BY, BZ;

  __host__ __device__ int run_elems() const { return BZ < nz ? BZ : (BY < ny ? BY * nz : P * ny * nz); }
  __host__ __device__ int runs() const { return P * BY * BZ / run_elems(); }
  __host__ __device__ uint32_t bytes() const { return (uint32_t)P * BY * BZ * es; }

  // the start, clamped into the volume as a dynamic slice's
  __device__ void clamp(int& xb, int& yb, int& zb) const {
    xb = clampi(xb, 0, nx - P);
    yb = clampi(yb, 0, ny - BY);
    zb = clampi(zb, 0, nz - BZ);
  }

  // the runs of the band at (xb, yb, zb), issued by `threads` threads from
  // thread `first` (a multiple of 32 of them: run r by lane r / warps of
  // warp r % warps, so that every warp issues its share, which is what
  // bounds the issue rate); thread `first` arms the barrier with the
  // band's bytes
  __device__ void issue(void* dst, int xb, int yb, int zb, uint64_t* bar, int first, int threads) const {
    const int me = threadIdx.x - first;
    if (me < 0 || me >= threads) return;
    if (me == 0) bar_expect(bar, bytes());
    const int run = run_elems(), n = runs();
    const int per_plane = BZ < nz ? BY : 1;
    const int warps = threads / 32, slot = threads % 32 ? me : (me % 32) * warps + me / 32;
    for (int r = slot; r < n; r += threads) {
      const int p = r / per_plane, j = r % per_plane;
      const size_t src = ((size_t)(xb + p) * ny + (yb + (BZ < nz ? j : 0))) * nz + (BZ < nz ? zb : 0);
      bulk_copy((char*)dst + (size_t)r * run * es, vol + src * es, (uint32_t)run * es, bar);
    }
  }
};

// R6's packed copy offset: xb * 65536 + yb8 * 4 + zb128
__device__ __forceinline__ void unpack(int p, int& xb, int& yb, int& zb) {
  xb = floor_div(p, 65536);
  yb = floor_mod(floor_div(p, 4), 64) * 8;
  zb = floor_mod(p, 4) * 128;
}

// ---- the chain after the terms ---------------------------------------------------

// one addend x of the chain, after the fixed band's sum fv where kFixed
template <bool kFixed>
__device__ __forceinline__ float chain_add(float part, float fv, float x) {
  if (kFixed) part = part + fv;
  return part + x;
}

// An instance's chain (one thread): part = part + x over its n addends in
// order, with the fixed band's sum fv before each (an item's one stored
// addend) where kFixed. The addends stream through a ring of kChainStages
// bulk copies of kChainFloats into `ring` (the buffer's stride is padded to
// 16 bytes, so a last copy rounded up stays inside it); `bars` are fresh
// mbarriers.
template <bool kFixed>
__device__ float chain_terms(const float* terms, int n, float fv, float* ring, uint64_t* bars) {
  const int chunks = (n + kChainFloats - 1) / kChainFloats;
  auto issue = [&](int c) {
    const int s = c % kChainStages;
    const uint32_t bytes = (uint32_t)((min(kChainFloats, n - c * kChainFloats) + 3) / 4) * 16u;
    bar_expect(&bars[s], bytes);
    bulk_copy(ring + s * kChainFloats, terms + (size_t)c * kChainFloats, bytes, &bars[s]);
  };
  for (int c = 0; c < chunks && c < kChainStages; ++c) issue(c);
  float part = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kChainStages;
    bar_wait(&bars[s], (uint32_t)((c / kChainStages) & 1));
    const float* x = ring + s * kChainFloats;
    const int count = min(kChainFloats, n - c * kChainFloats);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int quads = count / 4;
#pragma unroll 8
    for (int q = 0; q < quads; ++q) {
      const float4 v = x4[q];
      part = chain_add<kFixed>(part, fv, v.x);
      part = chain_add<kFixed>(part, fv, v.y);
      part = chain_add<kFixed>(part, fv, v.z);
      part = chain_add<kFixed>(part, fv, v.w);
    }
    for (int e = 4 * quads; e < count; ++e) part = chain_add<kFixed>(part, fv, x[e]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the stage read before it is refilled
    if (c + kChainStages < chunks) issue(c + kChainStages);
  }
  return part;
}

// An instance's total: its addends chained once, then added `steps` times,
// R1-R3's steps being equal. `ring` and `bars`: the kernel's shared arrays
// of the chain's stages.
template <bool kFixed>
__device__ float chain_total(const float* terms, int n, float fv, int steps, float* ring, uint64_t* bars) {
  for (int s = 0; s < kChainStages; ++s) bar_init(&bars[s]);
  const float part = chain_terms<kFixed>(terms, n, fv, ring, bars);
  float total = 0.0f;
  for (int s = 0; s < steps; ++s) total = total + part;
  return total;
}

// each ray's chain over an instance's sample9 terms [iters, 128], all
// kLanes threads; thread 0 issues bulk copies of kTermIters iterations into
// a ring of kTermStages in `smem`, the band's buffer
__device__ float chain_rays(const float* terms, int iters, unsigned char* smem, uint64_t* bars) {
  const int t = threadIdx.x;
  const int chunks = (iters + kTermIters - 1) / kTermIters;
  float* ring = reinterpret_cast<float*>(smem);
  auto issue = [&](int c) {
    const int s = c % kTermStages;
    const uint32_t bytes = (uint32_t)min(kTermIters, iters - c * kTermIters) * kLanes * 4u;
    bar_expect(&bars[s], bytes);
    bulk_copy(ring + s * kTermIters * kLanes, terms + (size_t)c * kTermIters * kLanes, bytes, &bars[s]);
  };
  if (t == 0)
    for (int c = 0; c < chunks && c < kTermStages; ++c) issue(c);
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kTermStages;
    bar_wait(&bars[s], (uint32_t)((c / kTermStages) & 1));
    const float* x = ring + s * kTermIters * kLanes + t;
    const int count = min(kTermIters, iters - c * kTermIters);
    for (int j = 0; j < count; ++j) acc = acc + x[j * kLanes];
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // every ray has read the stage before it is refilled
    if (t == 0 && c + kTermStages < chunks) issue(c + kTermStages);
  }
  return acc;
}

// ---- micro_band_sum --------------------------------------------------------

enum Base { kBaseNone = 0, kBaseRays = 1, kBaseTable = 2 };
enum ColMode { kColZero = 0, kColBase = 1, kColRoll = 2 };
enum Extra { kNone = 0, kYThenZ = 1, kYPlusZ = 2, kZ = 3, kOne = 4 };

struct BandSumItem {
  const float* data;      // [R, C], shared by the batch
  int R, C;
  const float* y;         // this instance's rays [rows, 128] (kBaseRays)
  const float* z;
  const int* ytab;        // this instance's tables [per_step] (kBaseTable)
  const int* ztab;
  int base, H, W, row_base, col_mode, add_y, extra;
  int fixed;              // the band depends on no item: summed once, not stored (an item then stores one addend)
  int A;                  // addends an item stores

  // item m's bases, a warp's
  __device__ void bases(int m, int& yb, int& zb) const {
    yb = zb = 0;
    if (base == kBaseRays) {
      row_bases(y + (size_t)m * kLanes, z + (size_t)m * kLanes, yb, zb);
    } else if (base == kBaseTable) {
      yb = floor_div(__ldg(ytab + m), 8) * 8;
      zb = floor_div(__ldg(ztab + m), 128) * 128;
    }
  }

  // the sum of the band at bases (yb, zb), a warp's (lane 0 returns it);
  // kPer 128-column chunks a band row (0: W / 128 at run time). A dynamic
  // slice's start is clamped into the data, as lax.dynamic_slice does.
  template <int kPer>
  __device__ float band(int yb, int zb) const {
    const int l = threadIdx.x & 31;
    const int per = kPer > 0 ? kPer : W / kLanes;
    const int row0 = row_base ? clampi(yb, 0, R - H) : 0;
    const int col0 = col_mode == kColBase ? clampi(zb, 0, C - W) : 0;
    const float add = (float)yb;
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
#pragma unroll 2
    for (int i = 0; i < H; ++i) {
      const float* row = data + (size_t)(row0 + i) * C;
#pragma unroll
      for (int c = 0; c < per; ++c) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = c * kLanes + l + 32 * k;
          v[k] = __ldg(row + (col_mode == kColRoll ? floor_mod(j - zb, C) : col0 + j));
          if (add_y) v[k] = v[k] + add;
        }
        p0 = p0 + v[0];
        p1 = p1 + v[1];
        p2 = p2 + v[2];
        p3 = p3 + v[3];
      }
    }
    return tree128(p0, p1, p2, p3);
  }

  __device__ float band_at(int yb, int zb) const {
    switch (W / kLanes) {
      case 1: return band<1>(yb, zb);
      case 2: return band<2>(yb, zb);
      case 4: return band<4>(yb, zb);
      default: return band<0>(yb, zb);
    }
  }

  // item m's addends, in the chain's order, to t[m * A ...]; a warp's
  __device__ void operator()(int m, float* t) const {
    int yb, zb;
    bases(m, yb, zb);
    const float a = H > 0 && !fixed ? band_at(yb, zb) : 0.0f;
    if ((threadIdx.x & 31) != 0) return;
    float* o = t + (size_t)m * A;
    if (H > 0 && !fixed) *o++ = a;
    switch (extra) {
      case kYThenZ: o[0] = (float)yb; o[1] = (float)zb; break;
      case kYPlusZ: o[0] = (float)(yb + zb); break;
      case kZ: o[0] = (float)zb; break;
      case kOne: o[0] = 1.0f; break;
      default: break;
    }
  }
};

// block (tile) of instance b: its run of `chunk` items, an item a warp,
// their addends to the instance's terms. The fixed band's sum goes to the
// instance's slot (after its addends, at a 16-byte boundary).
__global__ void __launch_bounds__(kThreads, 2)
micro_band_sum(BandSumItem item, int M, int tiles, int chunk, int rows, int tab_len, float* terms, int stride) {
  const int b = blockIdx.x / tiles, tile = blockIdx.x - b * tiles;
  const int w = threadIdx.x >> 5;
  if (item.y) {
    item.y += (size_t)b * rows * kLanes;
    item.z += (size_t)b * rows * kLanes;
  }
  if (item.ytab) {
    item.ytab += (size_t)b * tab_len;
    item.ztab += (size_t)b * tab_len;
  }
  float* t = terms + (size_t)b * stride;
  if (item.fixed && tile == 0 && w == 0) {
    const float a = item.band_at(0, 0);
    if (threadIdx.x == 0) t[(M * item.A + 3) / 4 * 4] = a;
  }
  const int end = min(M, (tile + 1) * chunk);
  for (int m = tile * chunk + w; m < end; m += kWarps) item(m, t);
}

// ---- micro_sampler -----------------------------------------------------------

enum SamplerVariant { kFull = 0, kStatic = 1, kLoadTaa = 2, kMxu = 3, kTabFull = 4, kSample512 = 5, kSample9 = 6 };

struct SamplerItem {
  const float* data;  // [R, C], shared by the batch
  int R, C;
  const float* y;     // this instance's rays [rows, 128]
  const float* z;
  const int* ytab;    // this instance's tables
  const int* ztab;
  int variant, G, K;
  int A;              // addends an item stores (loadtaa: its two column sums)

  __device__ float at(int row, int col) const { return __ldg(data + (size_t)row * C + col); }

  // item n's term(s) to t[n * A ...], a warp's: lane l samples rays l,
  // l + 32, l + 64, l + 96 of the item's ray row
  __device__ void operator()(int n, float* t) const {
    const int l = threadIdx.x & 31;
    int r, yb = 0, zb = 0, H, W, ry_max, zi_max;
    float dy = 0.0f, dz = 0.0f;
    if (variant == kTabFull) {
      const int k = n % K, idx = n / K;
      r = idx / G;
      yb = floor_div(__ldg(ytab + idx), 8) * 8;
      zb = floor_div(__ldg(ztab + idx), 128) * 128;
      dy = __fmul_rn(0.01f, (float)k);
      dz = __fmul_rn(0.017f, (float)k);
      H = 24, W = 256, ry_max = 22, zi_max = 254;
    } else if (variant == kSample512) {
      r = n & 127;
      yb = floor_div(__ldg(ytab + n), 8) * 8;
      zb = 0;  // R5 `sample` reads all 512 columns; its zbase is unused
      H = 24, W = 512, ry_max = 22, zi_max = 510;
    } else {
      r = n;
      H = 16, W = 256, ry_max = 14, zi_max = 254;
    }
    float yv[4], zv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      yv[k] = __ldg(y + (size_t)r * kLanes + l + 32 * k);
      zv[k] = __ldg(z + (size_t)r * kLanes + l + 32 * k);
    }
    if (variant == kFull || variant == kLoadTaa) {
      int my = floor_to_int(yv[0]), mz = floor_to_int(zv[0]);
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        my = min(my, floor_to_int(yv[k]));
        mz = min(mz, floor_to_int(zv[k]));
      }
      warp_bases(my, mz, yb, zb);
    }
    const int row0 = clampi(yb, 0, R - H), col0 = clampi(zb, 0, C - W);
    float p[4], q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float yk = yv[k] + dy, zk = zv[k] + dz;
      const int y0 = floor_to_int(yk), z0 = floor_to_int(zk);
      const int zi = clampi(z0 - zb, 0, zi_max), ry = clampi(y0 - yb, 0, ry_max);
      if (variant == kLoadTaa) {
        float s0 = 0.0f, s1 = 0.0f;
        for (int i = 0; i < H; ++i) s0 = s0 + at(row0 + i, col0 + zi);
        for (int i = 0; i < H; ++i) s1 = s1 + at(row0 + i, col0 + zi + 1);
        p[k] = s0;
        q[k] = s1;
      } else {
        p[k] = 0.0f + combine(at(row0 + ry, col0 + zi), at(row0 + ry, col0 + zi + 1), at(row0 + ry + 1, col0 + zi),
                              at(row0 + ry + 1, col0 + zi + 1), yk - (float)y0, zk - (float)z0);
        q[k] = 0.0f;
      }
    }
    const float a = tree128(p[0], p[1], p[2], p[3]);
    const float bsum = A > 1 ? tree128(q[0], q[1], q[2], q[3]) : 0.0f;
    if (l == 0) {
      t[(size_t)n * A] = a;
      if (A > 1) t[(size_t)n * A + 1] = bsum;
    }
  }

  // the fp32 FMA one-hot products of band rows row .. row + 3 (columns
  // col0 ..) with columns zi and zi + 1: g[2 i + d] = sum over c of
  // band[row + i, c] * (c == zi + d), columns in order from 0.0f
  __device__ void onehot4(int row, int col0, int zi, float (&g)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = 0.0f;
    const float4* p = reinterpret_cast<const float4*>(data + (size_t)row * C + col0);
    const int pitch = C / 4;
#pragma unroll 1
    for (int c4 = 0; c4 < 256 / 4; ++c4) {
      const int c = 4 * c4;
      float s[2][4];
#pragma unroll
      for (int d = 0; d < 2; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[d][e] = c + e == zi + d ? 1.0f : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = __ldg(p + (size_t)i * pitch + c4);
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          float a = g[2 * i + d];
          a = fmaf(v.x, s[d][0], a);
          a = fmaf(v.y, s[d][1], a);
          a = fmaf(v.z, s[d][2], a);
          a = fmaf(v.w, s[d][3], a);
          g[2 * i + d] = a;
        }
      }
    }
  }

  // MXU items first .. end - 1, each the block's: thread (ray, quarter)
  // takes band rows 4 quarter .. 4 quarter + 3 of its ray, both products of
  // each (the (16, 256) band times the (256, 128) one-hot column selects);
  // the one-hot row selects keep rows ry and ry + 1, which meet in shared
  // memory (double-buffered: one barrier an item); then warp 0 combines the
  // ray row and sums it
  __device__ void mxu(int first, int end, float* t) const {
    __shared__ float sel[2][kLanes][4];
    const int ray = threadIdx.x % kLanes, quarter = threadIdx.x / kLanes;
    for (int n = first, j = 0; n < end; ++n, ++j) {
      const float* yr = y + (size_t)n * kLanes;
      const float* zr = z + (size_t)n * kLanes;
      int yb, zb;
      row_bases(yr, zr, yb, zb);
      const int row0 = clampi(yb, 0, R - 16), col0 = clampi(zb, 0, C - 256);
      const int zi = clampi(floor_to_int(__ldg(zr + ray)) - zb, 0, 254);
      const int ry = clampi(floor_to_int(__ldg(yr + ray)) - yb, 0, 14);
      float g[8];
      onehot4(row0 + 4 * quarter, col0, zi, g);
      float(*s)[4] = sel[j & 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * quarter + i == ry) s[ray][0] = g[2 * i], s[ray][1] = g[2 * i + 1];
        if (4 * quarter + i == ry + 1) s[ray][2] = g[2 * i], s[ray][3] = g[2 * i + 1];
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        const int l = threadIdx.x;
        float p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int rk = l + 32 * k;
          const float yv = __ldg(yr + rk), zv = __ldg(zr + rk);
          const int y0 = floor_to_int(yv), z0 = floor_to_int(zv);
          p[k] = 0.0f + combine(s[rk][0], s[rk][1], s[rk][2], s[rk][3], yv - (float)y0, zv - (float)z0);
        }
        const float a = tree128(p[0], p[1], p[2], p[3]);
        if (l == 0) t[n] = a;
      }
    }
  }
};

// block (tile) of instance b: its run of `chunk` items, an item a warp
// (MXU: the block), their terms to the instance's
__global__ void __launch_bounds__(kThreads, 2)
micro_sampler(SamplerItem item, int M, int tiles, int chunk, int rows, int tab_len, float* terms, int stride) {
  const int b = blockIdx.x / tiles, tile = blockIdx.x - b * tiles;
  item.y += (size_t)b * rows * kLanes;
  item.z += (size_t)b * rows * kLanes;
  if (item.ytab) {
    item.ytab += (size_t)b * tab_len;
    item.ztab += (size_t)b * tab_len;
  }
  float* t = terms + (size_t)b * stride;
  const int first = tile * chunk, end = min(M, first + chunk);
  if (item.variant == kMxu) {
    item.mxu(first, end, t);
  } else {
    for (int n = first + (threadIdx.x >> 5); n < end; n += kWarps) item(n, t);
  }
}

// R6 `sample9`, 128 threads (a ray each) a block: a block takes iterations
// first .. end - 1 of its instance; each copies its (9, 32, 256) bfloat16
// band (as `dma`), then samples plane 3 of it, the z + 1 gather stood in
// for by the z gather (bench_micro_render6.py:63). With one block an
// instance it chains each ray in registers; with several, it writes the
// terms [iters, 128] for micro_ray_chain.
__global__ void __launch_bounds__(kLanes)
micro_sample9(Band band, const int* tab, int tab_len, const float* y, const float* z, int rows, int M, int tiles,
              int chunk, float* terms, int stride, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  const int t = threadIdx.x;
  const int b = blockIdx.x / tiles, tile = blockIdx.x - b * tiles;
  tab += (size_t)b * tab_len;
  y += (size_t)b * rows * kLanes;
  z += (size_t)b * rows * kLanes;
  float* T = tiles > 1 ? terms + (size_t)b * stride : nullptr;
  if (t == 0) bar_init(&bar);
  __syncthreads();
  const __nv_bfloat16* bf = reinterpret_cast<const __nv_bfloat16*>(smem);
  float acc = 0.0f;
  const int first = tile * chunk, end = min(M, first + chunk);
  for (int i = first; i < end; ++i) {
    int xb, yb, zb;
    unpack(__ldg(tab + i), xb, yb, zb);
    band.clamp(xb, yb, zb);
    band.issue(smem, xb, yb, zb, &bar, 0, kLanes);
    const int r = i & 127;
    const float yv = __ldg(y + r * kLanes + t), zv = __ldg(z + r * kLanes + t);
    const int y0 = floor_to_int(yv), z0 = floor_to_int(zv);
    const int ry = clampi(floor_mod(y0, 32), 0, 30) + 3 * 32;
    const int zi = clampi(floor_mod(z0, 128), 0, 253);
    bar_wait(&bar, (uint32_t)((i - first) & 1));
    const float v00 = __bfloat162float(bf[ry * 256 + zi]);
    const float v10 = __bfloat162float(bf[(ry + 1) * 256 + zi]);
    const float F = combine(v00, v00, v10, v10, yv - (float)y0, zv - (float)z0);
    if (T)
      T[(size_t)i * kLanes + t] = F;
    else
      acc = acc + F;
    __syncthreads();  // every thread has read the band before the next copy lands
  }
  if (!T) out[(size_t)b * kLanes + t] = acc;
}

// the chain of instance blockIdx.x's n addends (thread 0), the fixed
// band's sum before each where `fixed`, then `steps` adds to its total,
// written to the instance's `lanes` outputs
__global__ void __launch_bounds__(32) micro_chain(const float* terms, int stride, int n, int fixed, int steps,
                                                  int lanes, float* out) {
  __shared__ __align__(128) float ring[kChainStages * kChainFloats];
  __shared__ uint64_t bars[kChainStages];
  if (threadIdx.x != 0) return;
  const int b = blockIdx.x;
  const float* t = terms + (size_t)b * stride;
  const int slot = (n + 3) / 4 * 4;
  const float total = fixed ? chain_total<true>(t, n, __ldcg(t + slot), steps, ring, bars)
                            : chain_total<false>(t, n, 0.0f, steps, ring, bars);
  for (int l = 0; l < lanes; ++l) out[(size_t)b * lanes + l] = total;
}

// each ray's chain over instance blockIdx.x's sample9 terms
__global__ void __launch_bounds__(kLanes) micro_ray_chain(const float* terms, int stride, int iters, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[kTermStages];
  if (threadIdx.x == 0)
    for (int s = 0; s < kTermStages; ++s) bar_init(&bars[s]);
  __syncthreads();
  const float acc = chain_rays(terms + (size_t)blockIdx.x * stride, iters, smem, bars);
  out[(size_t)blockIdx.x * kLanes + threadIdx.x] = acc;
}

// ---- micro_band_copy ---------------------------------------------------------

enum CopyVariant { kRowSum = 0, kTrips = 1, kCopyOut = 2, kSmemRw = 3, kDma = 4, kDmaOvl = 5 };

// S1, S2, D1: one block an instance's table row (tab [B, rows, width]).
__global__ void __launch_bounds__(kLanes)
micro_band_copy(const int* __restrict__ tab, int width, Band band, int variant, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) int row[16];
  __shared__ uint64_t bar;
  const int t = threadIdx.x;
  if (t == 0) bar_init(&bar);
  __syncthreads();

  // the table row (64 or 32 B), the TPU probe's SMEM block
  const int* src = tab + (size_t)blockIdx.x * width;
  if (t == 0) {
    bar_expect(&bar, (uint32_t)width * 4);
    bulk_copy(row, src, (uint32_t)width * 4, &bar);
  }
  bar_wait(&bar, 0);
  if (variant == kRowSum) {
    float acc = 0.0f;
    for (int s = 0; s < width; ++s) acc = acc + (float)row[s];
    out[(size_t)blockIdx.x * kLanes + t] = acc;
    return;
  }
  if (variant == kCopyOut) {
    int xb = row[0], yb = row[1] * 8, zb = row[2] * 8;
    band.clamp(xb, yb, zb);
    band.issue(smem, xb, yb, zb, &bar, 0, kLanes);
    bar_wait(&bar, 1);
    const float* f = reinterpret_cast<const float*>(smem);
    const int n = band.P * band.BY * band.BZ;
    float* o = out + (size_t)blockIdx.x * n;
    for (int e = t; e < n; e += kLanes) o[e] = f[e];
    return;
  }
  // kTrips: n copies of the slab vol[xb : xb + P], each waited for
  const int trips = clampi(row[0], 0, width - 1);
  float acc = 0.0f;
  const float* f = reinterpret_cast<const float*>(smem);
  for (int s = 0; s < trips; ++s) {
    int xb = row[1 + s], yb = 0, zb = 0;
    band.clamp(xb, yb, zb);
    band.issue(smem, xb, yb, zb, &bar, 0, kLanes);
    bar_wait(&bar, (uint32_t)((s + 1) & 1));
    acc = acc + f[t];
    __syncthreads();
  }
  out[(size_t)blockIdx.x * kLanes + t] = acc;
}

// R6 `smem_rw`, `dma`, `dma_ovl` (tab [B, width], the packed offsets):
// block (tile) of instance b takes iterations first .. end - 1, as
// micro_sample9 does. With one block an instance it chains in registers
// and writes the output; with several, it writes each iteration's terms
// (dma, dma_ovl: lane t's [iters, 128]) for micro_ray_chain, or (smem_rw)
// its partial sum [tiles] for micro_chain.
__global__ void __launch_bounds__(kLanes)
micro_band_copy_iters(const int* __restrict__ tab, int width, Band band, int variant, int iters, int tiles,
                      int chunk, float* __restrict__ terms, int stride, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[kRingStages];
  __shared__ int cnt[kLanes];
  __shared__ float total;
  const int t = threadIdx.x;
  const int b = blockIdx.x / tiles, tile = blockIdx.x - b * tiles;
  const int first = tile * chunk, end = min(iters, first + chunk);
  const int* ptab = tab + (size_t)b * width;
  float* T = tiles > 1 ? terms + (size_t)b * stride : nullptr;

  if (variant == kSmemRw) {
    // per-row counters, read and incremented each iteration; counter t
    // starts at the earlier iterations of its row, i < first with i & 127 == t
    volatile int* c = cnt;
    c[t] = (first - t + kLanes - 1) >> 7;
    __syncthreads();
    if (t == 0) {
      float acc = 0.0f;
      for (int i = first; i < end; ++i) {
        const int r = i & 127, v = c[r];
        c[r] = v + 1;
        acc = acc + (float)v;
      }
      if (T) T[tile] = acc;  // the block's partial sum
      total = acc;
    }
    __syncthreads();
    if (!T) out[(size_t)b * kLanes + t] = total;
    return;
  }

  if (t == 0)
    for (int s = 0; s < kRingStages; ++s) bar_init(&bars[s]);
  __syncthreads();
  float acc = 0.0f;
  // lane t's term of iteration i: element t of the band's first row
  auto take = [&](int i, const unsigned char* stage) {
    const float v = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(stage)[t]);
    if (T)
      T[(size_t)i * kLanes + t] = v;
    else
      acc = acc + v;
  };
  if (variant == kDma) {
    for (int i = first; i < end; ++i) {
      int xb, yb, zb;
      unpack(__ldg(ptab + i), xb, yb, zb);
      band.clamp(xb, yb, zb);
      band.issue(smem, xb, yb, zb, &bars[0], 0, kLanes);
      bar_wait(&bars[0], (uint32_t)((i - first) & 1));
      take(i, smem);
      __syncthreads();
    }
  } else {
    // kDmaOvl: the block's bands' planes stream through the ring; chunk c
    // is planes kRingPlanes * (c % per) ... of band first + c / per (per =
    // P / kRingPlanes), in stage c % kRingStages. Every thread waits for
    // every chunk (and reads plane 0 of a band), then a block barrier, then
    // the threads issue their shares of chunk c + kRingStages into the same
    // stage. The barrier orders it: no thread arms a stage's next phase
    // before every thread has waited for (and read) its current one, so no
    // wait can miss its phase and wait for a later one. (Only 96 of 128
    // threads issue a stage's runs, so the copies' completion alone would
    // not order the others.)
    Band part = band;
    part.P = kRingPlanes;
    const int per = band.P / kRingPlanes;
    const int chunks = (end - first) * per;
    const int stage_bytes = kRingPlanes * band.BY * band.BZ * band.es;
    auto issue = [&](int c) {
      int xb, yb, zb;
      unpack(__ldg(ptab + first + c / per), xb, yb, zb);
      band.clamp(xb, yb, zb);
      const int s = c % kRingStages;
      part.issue(smem + s * stage_bytes, xb + kRingPlanes * (c % per), yb, zb, &bars[s], 0, kLanes);
    };
    for (int c = 0; c < chunks && c < kRingStages; ++c) issue(c);
    for (int c = 0; c < chunks; ++c) {
      const int s = c % kRingStages;
      bar_wait(&bars[s], (uint32_t)((c / kRingStages) & 1));
      if (c % per == 0) take(first + c / per, smem + s * stage_bytes);
      __syncthreads();
      if (c + kRingStages < chunks) issue(c + kRingStages);
    }
  }
  if (!T) out[(size_t)b * kLanes + t] = acc;
}

// ---- launches ------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  if (bytes > kSmemDefault)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return cudaSuccess;
}

// a band every run of which is a legal bulk copy: 16-byte multiples of size
// and of the volume's row pitch; its z start is a multiple of 8 elements of
// 2 or 4 bytes by construction (D1: 8 * zb, R6: 128 * zb, S2: 0)
bool band_ok(const void* vol, int es, int nx, int ny, int nz, int P, int BY, int BZ) {
  return vol != nullptr && (es == 2 || es == 4) && P > 0 && BY > 0 && BZ > 0 && P <= nx && BY <= ny &&
         BZ <= nz && (BZ * es) % 16 == 0 && ((long long)nz * es) % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(vol) % 16) == 0 && (long long)P * BY * BZ * es <= kSmemMax - 1024;
}

// an instance's items cut into `tiles` runs of `chunk`, none empty
bool geometry_ok(int B, int M, int tiles, int chunk) {
  return tiles > 0 && chunk > 0 && (long long)tiles * chunk >= M && (long long)(tiles - 1) * chunk < M &&
         (long long)B * tiles <= 0x7fffffffLL;
}

// an instance's terms: its n addends padded to 16 bytes, then the fixed
// band's slot (4 floats)
bool stride_ok(long long n, int stride) { return stride % 4 == 0 && stride >= (n + 3) / 4 * 4 + 4; }

}  // namespace

// terms, stride: a buffer of B x stride floats (no fill needed), stride at
// least the instance's addends padded to 4, plus 4; tiles, chunk: the
// launch geometry (_sampler.py's render_geometry)
extern "C" int sdf_micro_band_sum(const void* data, int R, int C, const void* y, const void* z, const void* ytab,
                                  const void* ztab, void* out, void* terms, int stride, int B, int steps,
                                  int per_step, int rows, int tab_len, int base, int H, int W, int row_base,
                                  int col_mode, int add_y, int extra, int tiles, int chunk, void* stream) {
  const int fixed = H > 0 && !row_base && col_mode == kColZero && !add_y;
  const int A = (H > 0 && !fixed) + (extra == kYThenZ ? 2 : (extra == kNone ? 0 : 1));
  if (B <= 0 || steps <= 0 || per_step <= 0 || H < 0 || W < 0 || (H > 0 && (data == nullptr || W % kLanes != 0 ||
      H > R || W > C)) || (base == kBaseRays && (y == nullptr || z == nullptr || per_step > rows)) ||
      (base == kBaseTable && (ytab == nullptr || ztab == nullptr || per_step > tab_len)) || extra < 0 ||
      extra > kOne || col_mode < 0 || col_mode > kColRoll || A == 0 || (fixed && A != 1) || terms == nullptr ||
      !geometry_ok(B, per_step, tiles, chunk) || !stride_ok((long long)per_step * A, stride) ||
      (long long)per_step * A + 8 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  BandSumItem item{(const float*)data, R, C, base == kBaseRays ? (const float*)y : nullptr,
                   base == kBaseRays ? (const float*)z : nullptr, base == kBaseTable ? (const int*)ytab : nullptr,
                   base == kBaseTable ? (const int*)ztab : nullptr, base, H, W, row_base, col_mode, add_y, extra,
                   fixed, A};
  micro_band_sum<<<B * tiles, kThreads, 0, (cudaStream_t)stream>>>(item, per_step, tiles, chunk, rows, tab_len,
                                                                   (float*)terms, stride);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  micro_chain<<<B, 32, 0, (cudaStream_t)stream>>>((const float*)terms, stride, per_step * A, fixed, steps, 1,
                                                   (float*)out);
  return (int)cudaGetLastError();
}

// terms, stride as sdf_micro_band_sum's; sample9 writes terms only where
// an instance takes several blocks (tiles > 1): [iters, 128] an instance,
// stride at least iters x 128
extern "C" int sdf_micro_sampler(const void* data, int R, int C, const void* vol, int nx, int ny, int nz,
                                 const void* y, const void* z, int rows, const void* ytab, const void* ztab,
                                 int tab_len, void* out, void* terms, int stride, int B, int steps, int per_step,
                                 int G, int K, int variant, int tiles, int chunk, void* stream) {
  if (B <= 0 || steps <= 0 || per_step <= 0 || y == nullptr || z == nullptr || rows <= 0 ||
      variant < kFull || variant > kSample9 || !geometry_ok(B, per_step, tiles, chunk))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == kSample9) {
    Band band{(const char*)vol, 2, nx, ny, nz, 9, 32, 256};
    if (!band_ok(vol, 2, nx, ny, nz, 9, 32, 256) || ytab == nullptr || rows < kLanes || per_step > tab_len ||
        steps != 1 || (tiles > 1 && (terms == nullptr || stride < (long long)per_step * kLanes)))
      return (int)cudaErrorInvalidValue;
    const int bytes = (int)band.bytes();  // also the chain's ring: kTermStages x kTermIters x 128 floats
    if (bytes < kTermStages * kTermIters * kLanes * 4) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(micro_sample9, bytes);
    if (err != cudaSuccess) return (int)err;
    micro_sample9<<<B * tiles, kLanes, bytes, s>>>(band, (const int*)ytab, tab_len, (const float*)y,
                                                   (const float*)z, rows, per_step, tiles, chunk, (float*)terms,
                                                   stride, (float*)out);
    if (tiles == 1) return (int)cudaGetLastError();
    const int ring_bytes = kTermStages * kTermIters * kLanes * 4;
    const cudaError_t err2 = allow_smem(micro_ray_chain, ring_bytes);
    if (err2 != cudaSuccess) return (int)err2;
    micro_ray_chain<<<B, kLanes, ring_bytes, s>>>((const float*)terms, stride, per_step, (float*)out);
    return (int)cudaGetLastError();
  }
  const int H = variant == kTabFull || variant == kSample512 ? 24 : 16;
  const int W = variant == kSample512 ? 512 : 256;
  const int A = variant == kLoadTaa ? 2 : 1;
  const bool tables = variant == kTabFull || variant == kSample512;
  if (data == nullptr || R < H || C < W || (tables && (ytab == nullptr || ztab == nullptr)) ||
      (variant == kTabFull && (G <= 0 || K <= 0 || (long long)rows * G > tab_len || per_step != rows * G * K)) ||
      (variant == kSample512 && (per_step > tab_len || rows < kLanes)) || (!tables && per_step > rows) ||
      (variant == kMxu && (C % 4 != 0 || reinterpret_cast<uintptr_t>(data) % 16 != 0)) || terms == nullptr ||
      !stride_ok((long long)per_step * A, stride) || (long long)per_step * A + 8 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  SamplerItem item{(const float*)data, R, C, (const float*)y, (const float*)z, tables ? (const int*)ytab : nullptr,
                   tables ? (const int*)ztab : nullptr, variant, G, K, A};
  micro_sampler<<<B * tiles, kThreads, 0, s>>>(item, per_step, tiles, chunk, rows, tab_len, (float*)terms, stride);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  micro_chain<<<B, 32, 0, s>>>((const float*)terms, stride, per_step * A, 0, steps, 1, (float*)out);
  return (int)cudaGetLastError();
}

// S1, S2, D1: tiles == 1 (a block a table row). R6: tiles, chunk as
// sdf_micro_sampler's; terms a buffer of B x stride floats where tiles > 1
// (no fill needed): smem_rw's stride at least tiles padded to 4, dma's and
// dma_ovl's at least iters x 128
extern "C" int sdf_micro_band_copy(const void* tab, int rows, int width, const void* vol, int es, int nx, int ny,
                                   int nz, int P, int BY, int BZ, void* out, void* terms, int stride, int B, int iters,
                                   int variant, int tiles, int chunk, void* stream) {
  if (B <= 0 || variant < kRowSum || variant > kDmaOvl || iters < 0 || tab == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Band band{(const char*)vol, es, nx, ny, nz, P, BY, BZ};
  if (variant == kRowSum || variant == kTrips || variant == kCopyOut) {
    if (rows <= 0 || width <= 0 || width > 16 || (width * 4) % 16 != 0 ||
        (reinterpret_cast<uintptr_t>(tab) % 16) != 0 || tiles != 1 ||
        (variant != kRowSum && !band_ok(vol, es, nx, ny, nz, P, BY, BZ)))
      return (int)cudaErrorInvalidValue;
    const int bytes = variant == kRowSum ? 0 : P * BY * BZ * es;
    const cudaError_t err = allow_smem(micro_band_copy, bytes);
    if (err != cudaSuccess) return (int)err;
    micro_band_copy<<<B * rows, kLanes, bytes, s>>>((const int*)tab, width, band, variant, (float*)out);
    return (int)cudaGetLastError();
  }
  const bool copies = variant != kSmemRw;
  if (iters <= 0 || !geometry_ok(B, iters, tiles, chunk) || (copies && iters > width) ||
      (tiles > 1 && (terms == nullptr || stride % 4 != 0 ||
                     stride < (copies ? (long long)iters * kLanes : (long long)(tiles + 3) / 4 * 4))))
    return (int)cudaErrorInvalidValue;
  int bytes = 0;
  if (copies) {
    if (!band_ok(vol, es, nx, ny, nz, P, BY, BZ)) return (int)cudaErrorInvalidValue;
    bytes = variant == kDmaOvl ? kRingStages * kRingPlanes * BY * BZ * es : P * BY * BZ * es;
    if (variant == kDmaOvl && (BZ >= nz || P % kRingPlanes != 0 || bytes > kSmemMax - 1024 ||
                               (long long)chunk * P > 0x7fffffffLL))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(micro_band_copy_iters, bytes);
  if (err != cudaSuccess) return (int)err;
  micro_band_copy_iters<<<B * tiles, kLanes, bytes, s>>>((const int*)tab, width, band, variant, iters, tiles, chunk,
                                                          (float*)terms, stride, (float*)out);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  if (!copies) {
    micro_chain<<<B, 32, 0, s>>>((const float*)terms, stride, tiles, 0, 1, kLanes, (float*)out);
    return (int)cudaGetLastError();
  }
  const int ring_bytes = kTermStages * kTermIters * kLanes * 4;
  err = allow_smem(micro_ray_chain, ring_bytes);
  if (err != cudaSuccess) return (int)err;
  micro_ray_chain<<<B, kLanes, ring_bytes, s>>>((const float*)terms, stride, iters, (float*)out);
  return (int)cudaGetLastError();
}
