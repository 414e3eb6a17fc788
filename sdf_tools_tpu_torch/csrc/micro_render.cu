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
//     (1 x 128): thread t of a warp-group of 128 adds the elements t,
//     t + 128, t + 256, ... of the row-major band in order from 0.0f; then
//     a fixed tree over the 128 partials, p[t] += p[t + w] for w = 64, 32,
//     ..., 1 (the first two levels in shared memory, the rest by shuffles);
//   - the TPU probes' loops (rows in a step, steps, iterations) are chains:
//     acc = acc + term, in the probes' order, by one thread. A nested probe
//     (R1-R3) starts each step's chain at 0.0f and adds it to the total.
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
//     never initialises them, the port zero-fills them.
//
// Batch: every probe takes a leading axis of B instances, one block each
// (S1, S2 and D1: one block an instance's table row, as the TPU grid's
// steps). The data (plane, cube, volume) is shared by the batch; the ray
// rows and tables are the instance's own.
//
// Bound on this card: each input element the output depends on read once
// and the output written once, at 3.35 TB/s, or the function's operations
// at the 67 TFLOP/s float32 rate, whichever is larger. The probes' chains
// are serial by definition (one dependent add an item), and each item's
// work is one warp-group's, so at B = 1 (one block on one of 132 SMs) the
// latency of the dependent loads, of the reductions and of the chain bounds
// them, not the device. The design does nothing to hide that: these
// kernels are probes, simple and right; their time per item at a batch
// that fills the card is their answer. A wait on a copy that does not
// complete within kSpinLimit cycles traps, so a wrong expected byte count
// fails the launch instead of hanging the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;               // rays of a row; a warp-group's threads
constexpr int kGroups = 4;                // warp-groups of a band-sum or sampler block
constexpr int kThreads = kLanes * kGroups;
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

// the band bases of a ray row: min floor(y) rounded down to 8, min floor(z)
// to 128; each warp reads the row's 128 values itself (no block barrier)
__device__ __forceinline__ void row_bases(const float* y, const float* z, int& yb, int& zb) {
  const int l = threadIdx.x & 31;
  int my = floor_to_int(__ldg(y + l)), mz = floor_to_int(__ldg(z + l));
  for (int j = 1; j < kLanes / 32; ++j) {
    my = min(my, floor_to_int(__ldg(y + l + 32 * j)));
    mz = min(mz, floor_to_int(__ldg(z + l + 32 * j)));
  }
  for (int o = 16; o > 0; o >>= 1) {
    my = min(my, __shfl_xor_sync(0xffffffffu, my, o));
    mz = min(mz, __shfl_xor_sync(0xffffffffu, mz, o));
  }
  yb = floor_div(my, 8) * 8;
  zb = floor_div(mz, 128) * 128;
}

// the tree over a warp-group's 128 partials p, by its first warp: lane 0
// returns p[t] += p[t + w] for w = 64, ..., 1
__device__ __forceinline__ float tree128(const float* p) {
  const int l = threadIdx.x & 31;
  float v = (p[l] + p[l + 64]) + (p[l + 32] + p[l + 96]);
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// the bilinear combine of the JAX probes, evaluated left to right
__device__ __forceinline__ float combine(float v00, float v01, float v10, float v11, float fy, float fz) {
  const float gy = 1.0f - fy, gz = 1.0f - fz;
  return ((v00 * gy * gz + v01 * gy * fz) + v10 * fy * gz) + v11 * fy * fz;
}

// ---- the chain of items (micro_band_sum, micro_sampler) -------------------
// Items n = 0 .. steps * per_step - 1 go to the block's warp-groups in
// batches of kGroups (item 4k + g to group g); each thread writes its
// partial(s), a barrier, then each group's first warp takes the tree and
// thread 0 chains the previous batch's terms in item order. Partials are
// double-buffered and terms triple-buffered, so one barrier a batch
// suffices.

enum Extra { kNone = 0, kYThenZ = 1, kYPlusZ = 2, kZ = 3, kOne = 4 };

struct Term {
  float a, b;
  int yb, zb;
};

struct Chain {
  int per_step, has_a, has_b, extra;
  float part, total;

  __device__ void add(const Term& t, long long n) {
    const long long m = n % per_step;
    if (m == 0) part = 0.0f;
    if (has_a) part = part + t.a;
    if (has_b) part = part + t.b;
    switch (extra) {
      case kYThenZ: part = part + (float)t.yb; part = part + (float)t.zb; break;
      case kYPlusZ: part = part + (float)(t.yb + t.zb); break;
      case kZ: part = part + (float)t.zb; break;
      case kOne: part = part + 1.0f; break;
      default: break;
    }
    if (m == per_step - 1) total = total + part;
  }
};

// Item: __device__ void operator()(long long n, int t, float* pa, float* pb, Term* term) const;
// writes pa[t] (and pb[t]); thread t == 0 of the group writes term->yb, zb.
template <class Item>
__device__ void run_chain(const Item& item, long long n_items, Chain chain, float* out) {
  __shared__ float part[2][kGroups][2][kLanes];
  __shared__ Term terms[3][kGroups];
  const int g = threadIdx.x / kLanes, t = threadIdx.x % kLanes;
  const long long batches = (n_items + kGroups - 1) / kGroups;
  chain.part = 0.0f;
  chain.total = 0.0f;
  for (long long k = 0; k < batches; ++k) {
    const long long n = k * kGroups + g;
    const int pb = (int)(k & 1), tb = (int)(k % 3);
    if (n < n_items) item(n, t, part[pb][g][0], part[pb][g][1], &terms[tb][g]);
    __syncthreads();
    if (threadIdx.x == 0 && k > 0) {
      const int prev = (int)((k - 1) % 3);
      for (int j = 0; j < kGroups; ++j) chain.add(terms[prev][j], (k - 1) * kGroups + j);
    }
    if (t < 32 && n < n_items) {
      const float a = chain.has_a ? tree128(part[pb][g][0]) : 0.0f;
      const float b = chain.has_b ? tree128(part[pb][g][1]) : 0.0f;
      if (t == 0) {
        terms[tb][g].a = a;
        terms[tb][g].b = b;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && batches > 0) {
    const long long k = batches - 1;
    for (int j = 0; j < kGroups && k * kGroups + j < n_items; ++j) chain.add(terms[k % 3][j], k * kGroups + j);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = chain.total;
}

// ---- micro_band_sum --------------------------------------------------------

enum Base { kBaseNone = 0, kBaseRays = 1, kBaseTable = 2 };
enum ColMode { kColZero = 0, kColBase = 1, kColRoll = 2 };

struct BandSumItem {
  const float* data;      // [R, C], shared by the batch
  int R, C;
  const float* y;         // this instance's rays [rows, 128] (kBaseRays)
  const float* z;
  const int* ytab;        // this instance's tables [per_step] (kBaseTable)
  const int* ztab;
  int base, per_step, H, W, row_base, col_mode, add_y;

  __device__ void operator()(long long n, int t, float* pa, float*, Term* term) const {
    const int m = (int)(n % per_step);
    int yb = 0, zb = 0;
    if (base == kBaseRays) {
      row_bases(y + (size_t)m * kLanes, z + (size_t)m * kLanes, yb, zb);
    } else if (base == kBaseTable) {
      yb = floor_div(__ldg(ytab + m), 8) * 8;
      zb = floor_div(__ldg(ztab + m), 128) * 128;
    }
    if (t == 0) {
      term->yb = yb;
      term->zb = zb;
    }
    if (H == 0) return;
    // a dynamic slice's start is clamped into the data, as lax.dynamic_slice does
    const int row0 = row_base ? clampi(yb, 0, R - H) : 0;
    const int col0 = col_mode == kColBase ? clampi(zb, 0, C - W) : 0;
    const float add = (float)yb;
    float acc = 0.0f;
    for (int i = 0; i < H; ++i) {
      const float* row = data + (size_t)(row0 + i) * C;
      for (int cb = 0; cb < W; cb += kLanes) {
        const int j = cb + t;
        float v = __ldg(row + (col_mode == kColRoll ? floor_mod(j - zb, C) : col0 + j));
        if (add_y) v = v + add;
        acc = acc + v;
      }
    }
    pa[t] = acc;
  }
};

__global__ void __launch_bounds__(kThreads)
micro_band_sum(BandSumItem item, long long n_items, Chain chain, int rows, int tab_len, float* out) {
  // this instance's rays and tables
  const size_t b = blockIdx.x;
  item.y += b * rows * kLanes;
  item.z += b * rows * kLanes;
  item.ytab += b * tab_len;
  item.ztab += b * tab_len;
  run_chain(item, n_items, chain, out);
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

// ---- micro_sampler -----------------------------------------------------------

enum SamplerVariant { kFull = 0, kStatic = 1, kLoadTaa = 2, kMxu = 3, kTabFull = 4, kSample512 = 5, kSample9 = 6 };

struct SamplerItem {
  const float* data;  // [R, C], shared by the batch
  int R, C;
  const float* y;     // this instance's rays [rows, 128]
  const float* z;
  const int* ytab;    // this instance's tables
  const int* ztab;
  int variant, per_step, G, K;

  __device__ float at(int row, int col) const { return __ldg(data + (size_t)row * C + col); }

  // one fp32 FMA one-hot product: sum over c of band[row, c] * (c == zi)
  __device__ float onehot(int row, int col0, int zi) const {
    const float4* p = reinterpret_cast<const float4*>(data + (size_t)row * C + col0);
    float acc = 0.0f;
    for (int c4 = 0; c4 < 256 / 4; ++c4) {
      const float4 v = __ldg(p + c4);
      const int c = 4 * c4;
      acc = fmaf(v.x, c == zi ? 1.0f : 0.0f, acc);
      acc = fmaf(v.y, c + 1 == zi ? 1.0f : 0.0f, acc);
      acc = fmaf(v.z, c + 2 == zi ? 1.0f : 0.0f, acc);
      acc = fmaf(v.w, c + 3 == zi ? 1.0f : 0.0f, acc);
    }
    return acc;
  }

  __device__ void operator()(long long n, int t, float* pa, float* pb, Term* term) const {
    int r, yb = 0, zb = 0, H, W, ry_max, zi_max;
    float dy = 0.0f, dz = 0.0f;
    if (variant == kTabFull) {
      const int k = (int)(n % K), idx = (int)(n / K);
      r = idx / G;
      yb = floor_div(__ldg(ytab + idx), 8) * 8;
      zb = floor_div(__ldg(ztab + idx), 128) * 128;
      dy = __fmul_rn(0.01f, (float)k);
      dz = __fmul_rn(0.017f, (float)k);
      H = 24, W = 256, ry_max = 22, zi_max = 254;
    } else if (variant == kSample512) {
      const int i = (int)n;
      r = i & 127;
      yb = floor_div(__ldg(ytab + i), 8) * 8;
      zb = 0;  // R5 `sample` reads all 512 columns; its zbase is unused
      H = 24, W = 512, ry_max = 22, zi_max = 510;
    } else {
      r = (int)(n % per_step);
      if (variant != kStatic) row_bases(y + (size_t)r * kLanes, z + (size_t)r * kLanes, yb, zb);
      H = 16, W = 256, ry_max = 14, zi_max = 254;
    }
    if (t == 0) {
      term->yb = yb;
      term->zb = zb;
    }
    const float yv = __ldg(y + (size_t)r * kLanes + t) + dy;
    const float zv = __ldg(z + (size_t)r * kLanes + t) + dz;
    const int y0 = floor_to_int(yv), z0 = floor_to_int(zv);
    const int row0 = clampi(yb, 0, R - H), col0 = clampi(zb, 0, C - W);
    const int zi = clampi(z0 - zb, 0, zi_max), ry = clampi(y0 - yb, 0, ry_max);
    if (variant == kLoadTaa) {
      float s0 = 0.0f, s1 = 0.0f;
      for (int i = 0; i < H; ++i) s0 = s0 + at(row0 + i, col0 + zi);
      for (int i = 0; i < H; ++i) s1 = s1 + at(row0 + i, col0 + zi + 1);
      pa[t] = s0;
      pb[t] = s1;
      return;
    }
    float v00, v01, v10, v11;
    if (variant == kMxu) {
      // the (16, 256) x (256, 128) one-hot products of every row, then the row selects
      v00 = v01 = v10 = v11 = 0.0f;
      for (int i = 0; i < H; ++i) {
        const float g0 = onehot(row0 + i, col0, zi), g1 = onehot(row0 + i, col0, zi + 1);
        if (i == ry) v00 = g0, v01 = g1;
        if (i == ry + 1) v10 = g0, v11 = g1;
      }
    } else {
      v00 = at(row0 + ry, col0 + zi);
      v01 = at(row0 + ry, col0 + zi + 1);
      v10 = at(row0 + ry + 1, col0 + zi);
      v11 = at(row0 + ry + 1, col0 + zi + 1);
    }
    pa[t] = 0.0f + combine(v00, v01, v10, v11, yv - (float)y0, zv - (float)z0);
  }
};

// R6 `sample9`: each iteration copies its (9, 32, 256) bfloat16 band (as
// `dma`), then samples plane 3 of it, the z + 1 gather stood in for by the
// z gather (bench_micro_render6.py:63); one chain a ray. 128 threads.
__device__ void sample9(const Band& band, const int* tab, const float* y, const float* z, int iters, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  const int t = threadIdx.x;
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(smem);
  if (t == 0) bar_init(&bar);
  __syncthreads();
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    int xb, yb, zb;
    unpack(__ldg(tab + i), xb, yb, zb);
    band.clamp(xb, yb, zb);
    band.issue(smem, xb, yb, zb, &bar, 0, kLanes);
    const int r = i & 127;
    const float yv = __ldg(y + r * kLanes + t), zv = __ldg(z + r * kLanes + t);
    const int y0 = floor_to_int(yv), z0 = floor_to_int(zv);
    const int ry = clampi(floor_mod(y0, 32), 0, 30) + 3 * 32;
    const int zi = clampi(floor_mod(z0, 128), 0, 253);
    bar_wait(&bar, (uint32_t)(i & 1));
    const float v00 = __bfloat162float(b[ry * 256 + zi]);
    const float v10 = __bfloat162float(b[(ry + 1) * 256 + zi]);
    acc = acc + combine(v00, v00, v10, v10, yv - (float)y0, zv - (float)z0);
    __syncthreads();  // every thread has read the band before the next copy lands
  }
  out[(size_t)blockIdx.x * kLanes + t] = acc;
}

__global__ void __launch_bounds__(kThreads)
micro_sampler(SamplerItem item, long long n_items, Chain chain, int rows, int tab_len, Band band, float* out) {
  const size_t b = blockIdx.x;
  item.y += b * rows * kLanes;
  item.z += b * rows * kLanes;
  item.ytab += b * tab_len;
  item.ztab += b * tab_len;
  if (item.variant == kSample9) {
    sample9(band, item.ytab, item.y, item.z, (int)n_items, out);
    return;
  }
  run_chain(item, n_items, chain, out);
}

// ---- micro_band_copy ---------------------------------------------------------

enum CopyVariant { kRowSum = 0, kTrips = 1, kCopyOut = 2, kSmemRw = 3, kDma = 4, kDmaOvl = 5 };

// S1, S2, D1: one block an instance's table row (tab [B, rows, width]);
// R6: one block an instance (tab [B, width], the packed offsets).
__global__ void __launch_bounds__(kLanes)
micro_band_copy(const int* __restrict__ tab, int rows, int width, Band band, int variant, int iters,
                float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) int row[16];
  __shared__ uint64_t bars[kRingStages];
  __shared__ int cnt[kLanes];
  const int t = threadIdx.x;
  if (t == 0)
    for (int s = 0; s < kRingStages; ++s) bar_init(&bars[s]);
  __syncthreads();
  uint64_t* bar = &bars[0];

  if (variant == kRowSum || variant == kTrips || variant == kCopyOut) {
    // the table row (64 or 32 B), the TPU probe's SMEM block
    const int* src = tab + (size_t)blockIdx.x * width;
    if (t == 0) {
      bar_expect(bar, (uint32_t)width * 4);
      bulk_copy(row, src, (uint32_t)width * 4, bar);
    }
    bar_wait(bar, 0);
    if (variant == kRowSum) {
      float acc = 0.0f;
      for (int s = 0; s < width; ++s) acc = acc + (float)row[s];
      out[(size_t)blockIdx.x * kLanes + t] = acc;
      return;
    }
    if (variant == kCopyOut) {
      int xb = row[0], yb = row[1] * 8, zb = row[2] * 8;
      band.clamp(xb, yb, zb);
      band.issue(smem, xb, yb, zb, bar, 0, kLanes);
      bar_wait(bar, 1);
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
      band.issue(smem, xb, yb, zb, bar, 0, kLanes);
      bar_wait(bar, (uint32_t)((s + 1) & 1));
      acc = acc + f[t];
      __syncthreads();
    }
    out[(size_t)blockIdx.x * kLanes + t] = acc;
    return;
  }

  const int* ptab = tab + (size_t)blockIdx.x * width;
  if (variant == kSmemRw) {
    // per-row counters, read and incremented each iteration, zero-filled first
    volatile int* c = cnt;
    c[t] = 0;
    __syncthreads();
    __shared__ float total;
    if (t == 0) {
      float acc = 0.0f;
      for (int i = 0; i < iters; ++i) {
        const int r = i & 127, v = c[r];
        c[r] = v + 1;
        acc = acc + (float)v;
      }
      total = acc;
    }
    __syncthreads();
    out[(size_t)blockIdx.x * kLanes + t] = total;
    return;
  }

  const __nv_bfloat16* b16 = reinterpret_cast<const __nv_bfloat16*>(smem);
  float acc = 0.0f;
  if (variant == kDma) {
    for (int i = 0; i < iters; ++i) {
      int xb, yb, zb;
      unpack(__ldg(ptab + i), xb, yb, zb);
      band.clamp(xb, yb, zb);
      band.issue(smem, xb, yb, zb, bar, 0, kLanes);
      bar_wait(bar, (uint32_t)(i & 1));
      acc = acc + __bfloat162float(b16[t]);
      __syncthreads();
    }
    out[(size_t)blockIdx.x * kLanes + t] = acc;
    return;
  }

  // kDmaOvl: the bands' planes stream through the ring; chunk c is planes
  // kRingPlanes * (c % per) ... of band c / per (per = P / kRingPlanes), in
  // stage c % kRingStages. Every thread waits for every chunk (and reads
  // plane 0 of a band), then a block barrier, then the threads issue their
  // shares of chunk c + kRingStages into the same stage. The barrier orders
  // it: no thread arms a stage's next phase before every thread has waited
  // for (and read) its current one, so no wait can miss its phase and wait
  // for a later one. (Only 96 of 128 threads issue a stage's runs, so the
  // copies' completion alone would not order the others.)
  // (32-bit counters: iters * P fits an int, checked at the launch)
  Band part = band;
  part.P = kRingPlanes;
  const int per = band.P / kRingPlanes;
  const int chunks = iters * per;
  const int stage_bytes = kRingPlanes * band.BY * band.BZ * band.es;
  auto issue = [&](int c) {
    int xb, yb, zb;
    unpack(__ldg(ptab + c / per), xb, yb, zb);
    band.clamp(xb, yb, zb);
    const int s = c % kRingStages;
    part.issue(smem + s * stage_bytes, xb + kRingPlanes * (c % per), yb, zb, &bars[s], 0, kLanes);
  };
  for (int c = 0; c < chunks && c < kRingStages; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kRingStages;
    bar_wait(&bars[s], (uint32_t)((c / kRingStages) & 1));
    if (c % per == 0)
      acc = acc + __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(smem + s * stage_bytes)[t]);
    __syncthreads();
    if (c + kRingStages < chunks) issue(c + kRingStages);
  }
  out[(size_t)blockIdx.x * kLanes + t] = acc;
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

}  // namespace

extern "C" int sdf_micro_band_sum(const void* data, int R, int C, const void* y, const void* z, const void* ytab,
                                  const void* ztab, void* out, int B, int steps, int per_step, int rows,
                                  int tab_len, int base, int H, int W, int row_base, int col_mode, int add_y,
                                  int extra, void* stream) {
  if (B <= 0 || steps <= 0 || per_step <= 0 || H < 0 || W < 0 || (H > 0 && (data == nullptr || W % kLanes != 0 ||
      H > R || W > C)) || (base == kBaseRays && (y == nullptr || z == nullptr || per_step > rows)) ||
      (base == kBaseTable && (ytab == nullptr || ztab == nullptr || per_step > tab_len)) || extra < 0 ||
      extra > kOne || col_mode < 0 || col_mode > kColRoll)
    return (int)cudaErrorInvalidValue;
  BandSumItem item{(const float*)data, R, C, (const float*)y, (const float*)z, (const int*)ytab,
                   (const int*)ztab, base, per_step, H, W, row_base, col_mode, add_y};
  Chain chain{per_step, H > 0, 0, extra, 0.0f, 0.0f};
  micro_band_sum<<<B, kThreads, 0, (cudaStream_t)stream>>>(item, (long long)steps * per_step, chain, rows,
                                                           tab_len, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int sdf_micro_sampler(const void* data, int R, int C, const void* vol, int nx, int ny, int nz,
                                 const void* y, const void* z, int rows, const void* ytab, const void* ztab,
                                 int tab_len, void* out, int B, int steps, int per_step, int G, int K,
                                 int variant, void* stream) {
  if (B <= 0 || steps <= 0 || per_step <= 0 || y == nullptr || z == nullptr || rows <= 0 ||
      variant < kFull || variant > kSample9)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n_items = (long long)steps * per_step;
  SamplerItem item{(const float*)data, R, C, (const float*)y, (const float*)z, (const int*)ytab,
                   (const int*)ztab, variant, per_step, G, K};
  Band band{(const char*)vol, 2, nx, ny, nz, 9, 32, 256};
  if (variant == kSample9) {
    if (!band_ok(vol, 2, nx, ny, nz, 9, 32, 256) || ytab == nullptr || rows < kLanes || per_step > tab_len)
      return (int)cudaErrorInvalidValue;
    const int bytes = (int)band.bytes();
    const cudaError_t err = allow_smem(micro_sampler, bytes);
    if (err != cudaSuccess) return (int)err;
    micro_sampler<<<B, kLanes, bytes, s>>>(item, n_items, Chain{}, rows, tab_len, band, (float*)out);
    return (int)cudaGetLastError();
  }
  const int H = variant == kTabFull || variant == kSample512 ? 24 : 16;
  const int W = variant == kSample512 ? 512 : 256;
  const bool tables = variant == kTabFull || variant == kSample512;
  if (data == nullptr || R < H || C < W || (tables && (ytab == nullptr || ztab == nullptr)) ||
      (variant == kTabFull && (G <= 0 || K <= 0 || (long long)rows * G > tab_len || per_step != rows * G * K)) ||
      (variant == kSample512 && (per_step > tab_len || rows < kLanes)) ||
      (!tables && per_step > rows))
    return (int)cudaErrorInvalidValue;
  Chain chain{per_step, 1, variant == kLoadTaa, kNone, 0.0f, 0.0f};
  micro_sampler<<<B, kThreads, 0, s>>>(item, n_items, chain, rows, tab_len, band, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int sdf_micro_band_copy(const void* tab, int rows, int width, const void* vol, int es, int nx, int ny,
                                   int nz, int P, int BY, int BZ, void* out, int B, int iters, int variant,
                                   void* stream) {
  if (B <= 0 || variant < kRowSum || variant > kDmaOvl || iters < 0) return (int)cudaErrorInvalidValue;
  const bool per_row = variant == kRowSum || variant == kTrips || variant == kCopyOut;
  if (per_row && (tab == nullptr || rows <= 0 || width <= 0 || width > 16 || (width * 4) % 16 != 0 ||
                  (reinterpret_cast<uintptr_t>(tab) % 16) != 0))
    return (int)cudaErrorInvalidValue;
  if ((variant == kDma || variant == kDmaOvl) && (tab == nullptr || iters > width)) return (int)cudaErrorInvalidValue;
  const bool copies = variant == kTrips || variant == kCopyOut || variant == kDma || variant == kDmaOvl;
  if (copies && !band_ok(vol, es, nx, ny, nz, P, BY, BZ)) return (int)cudaErrorInvalidValue;
  Band band{(const char*)vol, es, nx, ny, nz, P, BY, BZ};
  int bytes = 0;
  if (copies)
    bytes = variant == kDmaOvl ? kRingStages * kRingPlanes * BY * BZ * es : P * BY * BZ * es;
  if (variant == kDmaOvl && (BZ >= nz || P % kRingPlanes != 0 || bytes > kSmemMax - 1024 ||
                             (long long)iters * P > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(micro_band_copy, bytes);
  if (err != cudaSuccess) return (int)err;
  micro_band_copy<<<per_row ? B * rows : B, kLanes, bytes, (cudaStream_t)stream>>>(
      (const int*)tab, rows, width, band, variant, iters, (float*)out);
  return (int)cudaGetLastError();
}
