// K8: plane-sweep sphere trace of 128-ray rows over per-row slot tables.
//
// Replaces the TPU kernel sdf_tools_tpu/ops/render_plane.py::_make_kernel
// (:143, launched at :1227) in its production setting: secant refinement,
// graze probes, entry/exit virtual samples, early row exit. The plain
// version, sdf_tools_tpu_torch/ops/render_plane.py::plane_sweep_rows_plain,
// states the semantics; this kernel computes every quantity by the same
// expression in the same order (built with -fmad=false and IEEE division),
// so the two agree bitwise.
//
// Layout: one block of 128 threads per row, one thread per ray. The block
// copies its header and slot table into shared memory and walks the active
// slabs in table order; it stops when every lane is dead (hit, or past its
// window), the TPU's early exit, and writes the count of executed slabs.
// Each thread streams a slab's 17 planes in its marching order, keeping
// only the previous plane's corrected corners, corner cell and sample, and
// evaluates each pair's crossing, graze probes, near-miss candidate and
// secant as it passes. It keeps the first candidate pair, the first and
// last valid planes and a bit mask of valid planes; the entry and exit
// models re-read their pair's corners. Each lane's result depends only on
// its own samples and its row's table, and every lane takes every slab the
// row executes (as on the TPU, where a dead lane still updates tnear), so
// the per-thread order gives the TPU's (16, 128) vector form's outputs.
//
// The launch. A one-block counting sort first orders the rows by slot
// count, most first (row_order_kernel), so that the longest rows start in
// the first wave instead of finishing the launch alone; each block still
// writes its own row. The sweep holds 7 blocks an SM (72 registers).
//
// What bounds it (tools/k8_probe.py; PERF.md section 6, H100 SXM): not the
// bytes (the distinct cells of the main render's executed slabs move in
// about 0.04 ms at 3.35 TB/s) and not the float arithmetic alone (about
// 0.1 ms at 67 TFLOP/s), but issuing the sweep's dependent instructions,
// compares and selects at the few warps an SM holds: with the corners a
// constant the arithmetic alone takes 78% of the time, with the arithmetic
// a checksum the loads alone take 35%, and each block fewer an SM costs
// 6-18%. The field's footprint is served by L1: a slab's 17 x 13 x 14
// cells (the main render's mean) are re-read by the slab's 128 rays.
//
// Staging each executed slab's footprint box in shared memory (a block
// min / max of the lanes' corner cells, cp.async copies, two buffers, one
// barrier a slab) was built and measured 25-35% slower at every buffer size
// (PERF.md section 6): L1 already serves the footprint, the buffers take
// L1's share of the SM's SRAM, and the box pass and copies add instructions
// to an issue-bound loop. (The TPU's band, 17 x 56 x 256 f32 = 975 KB,
// would not fit the 227 KB of shared memory at all.)
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LANES = 128;
constexpr int SLAB = 16;
constexpr int PB = SLAB + 1;
constexpr int BY = 56;
constexpr int BZ = 256;
constexpr int HDR = 8;
constexpr int NCH = 16;
constexpr float BIGF = 1e30f;
constexpr int MIN_BLOCKS = 7;  // blocks an SM must hold (registers)

// NaN-propagating min / max (torch.minimum / jnp.minimum)
__device__ __forceinline__ float nmin(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a)); }
__device__ __forceinline__ float nmax(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : (b > a ? b : a)); }

// float -> int32 truncation, saturating as the plain version's
// grid.float_to_int32 (which maps NaN to 0, here to -2^31: every caller
// clamps the result into the grid, where the two agree)
__device__ __forceinline__ int f2i(float x) {
    x = fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
    return isnan(x) ? 0 : static_cast<int>(x);
}

struct Ray {
    float y0, sy, z0, sz, tc0, tc1, t_start, t_end, half;
};

struct Geom {
    int nx, ny, nz;
    const float* vol;
};

// a slab of the row: its first plane and its band base (the slot's pack)
struct Slab {
    int slab, xb, yb, zb;
};

__device__ __forceinline__ Slab unpack(int pack, const Geom& g) {
    Slab s;
    s.zb = (pack % 32) * 128;
    s.yb = ((pack / 32) % 256) * 8;
    s.slab = pack / (32 * 256);
    s.xb = min(s.slab * SLAB, g.nx - PB);
    return s;
}

// a plane crossing: its t, corner cell, weights and validity
struct Cell {
    float ty, wy, wz;
    int loy, loz;
    bool valid;
};

__device__ __forceinline__ Cell plane_cell(const Ray& r, const Geom& g, const Slab& sl, int p) {
    Cell q;
    const int gx = sl.xb + p;
    const float ux = static_cast<float>(gx) + 0.5f;
    q.ty = r.tc0 + r.tc1 * ux;
    const float uy = r.y0 + r.sy * ux;
    const float uz = r.z0 + r.sz * ux;
    bool valid = q.ty >= r.t_start && q.ty <= r.t_end && gx >= 0 && gx <= g.nx - 1 && uy >= 0.0f &&
                 uy < static_cast<float>(g.ny) && uz >= 0.0f && uz < static_cast<float>(g.nz);
    q.loy = min(max(f2i(floorf(uy - 0.5f)), 0), g.ny - 2);
    q.loz = min(max(f2i(floorf(uz - 0.5f)), 0), g.nz - 2);
    q.wy = uy - 0.5f - static_cast<float>(q.loy);
    q.wz = uz - 0.5f - static_cast<float>(q.loz);
    const int ryb = q.loy - sl.yb, rzb = q.loz - sl.zb;
    q.valid = valid && ryb >= 0 && ryb <= BY - 2 && rzb >= 0 && rzb <= BZ - 2;
    return q;
}

struct Plane {
    float ty, d;
    float c00, c01, c10, c11;  // center-corrected corner values
    int loy, loz;
    bool valid;
};

__device__ __forceinline__ float corr(float v, float half) { return v >= 0.0f ? v - half : v + half; }

// plane p of slab sl: its crossing and its sample, the corners read from
// the field through the read-only path
__device__ __forceinline__ Plane load_plane(const Ray& r, const Geom& g, const Slab& sl, int p) {
    const Cell c = plane_cell(r, g, sl, p);
    Plane q;
    q.ty = c.ty;
    q.loy = c.loy;
    q.loz = c.loz;
    q.valid = c.valid;
    if (c.valid) {
        const float* s = g.vol + (static_cast<size_t>(sl.xb + p) * g.ny + c.loy) * g.nz + c.loz;
        const float v00 = __ldg(s);
        const float v01 = __ldg(s + 1);
        const float v10 = __ldg(s + g.nz);
        const float v11 = __ldg(s + g.nz + 1);
        q.c00 = corr(v00, r.half);
        q.c01 = corr(v01, r.half);
        q.c10 = corr(v10, r.half);
        q.c11 = corr(v11, r.half);
        q.d = q.c00 * (1.0f - c.wy) * (1.0f - c.wz) + q.c01 * (1.0f - c.wy) * c.wz + q.c10 * c.wy * (1.0f - c.wz) +
              q.c11 * c.wy * c.wz;
    } else {
        // an invalid plane's corners never reach an output
        q.c00 = q.c01 = q.c10 = q.c11 = 0.0f;
        q.d = BIGF;
    }
    return q;
}

__device__ __forceinline__ float bil(const Plane& P, float uym, float uzm) {
    const float wy = uym - 0.5f - static_cast<float>(P.loy);
    const float wz = uzm - 0.5f - static_cast<float>(P.loz);
    return P.c00 * (1.0f - wy) * (1.0f - wz) + P.c01 * (1.0f - wy) * wz + P.c10 * wy * (1.0f - wz) + P.c11 * wy * wz;
}

// the frozen-corner model of the pair (A = lower plane at gxa, B = upper)
__device__ __forceinline__ float model_at(const Ray& r, const Plane& A, const Plane& B, float gxa, float t) {
    const float uxm = (t - r.tc0) / r.tc1;
    const float uym = r.y0 + r.sy * uxm;
    const float uzm = r.z0 + r.sz * uxm;
    const float wxm = uxm - (gxa + 0.5f);
    return (1.0f - wxm) * bil(A, uym, uzm) + wxm * bil(B, uym, uzm);
}

// secant to the eps level inside a bracket
__device__ __forceinline__ float t_at_eps(float t0, float d0, float t1, float d1, float eps) {
    const float den = fabsf(d0 - d1) > 1e-20f ? d0 - d1 : 1e-20f;
    return t0 + (t1 - t0) * (d0 - eps) / den;
}

__device__ __forceinline__ bool pair_ok(unsigned vmask, int q) { return ((vmask >> q) & 3u) == 3u; }

// a lane's result so far
struct LaneState {
    float depth, tnear;
    int hit, steps, sampled, model, dead;
};

// a lane's constants of the sweep
struct LaneConst {
    float eps, spacing, deep_below, nm_thresh, graze_gap, entry_reach;
    bool dirpos;
};

// one slab of the row for one lane: its 17 planes in marching order, the
// pairs' crossings, graze probes and near misses, the entry / exit virtual
// samples, and the lane's state updated with the TPU kernel's priorities
__device__ __forceinline__ void sweep_slab(const Ray& r, const Geom& g, const Slab& sl, const LaneConst& kc,
                                           LaneState& st) {
    const float eps = kc.eps;
    const bool dirpos = kc.dirpos;
    const float spacing = kc.spacing;
    const float deep_below = kc.deep_below;
    const float nm_thresh = kc.nm_thresh;
    const float graze_gap = kc.graze_gap;
    const float entry_reach = kc.entry_reach;
    float depth = st.depth, tnear = st.tnear;
    int hit = st.hit, steps = st.steps, sampled = st.sampled, model = st.model, dead = st.dead;
    const bool unhit = hit == 0;

    bool has_cand = false, cand_graze = false, has_sample = false;
    float t_hit = 0.0f, firstd = 0.0f, firstt = 0.0f, lastd = 0.0f, lastt = 0.0f;
    int pfv = 0, plv = 0, n_valid = 0;
    unsigned vmask = 0u;
    Plane prev;
#pragma unroll
    for (int k = 0; k < PB; ++k) {
        const int p = dirpos ? k : PB - 1 - k;
        const Plane cur_p = load_plane(r, g, sl, p);
        if (cur_p.valid) {
            vmask |= 1u << p;
            ++n_valid;
            if (!has_sample) {
                has_sample = true;
                firstd = cur_p.d;
                firstt = cur_p.ty;
                pfv = p;
            }
            lastd = cur_p.d;
            lastt = cur_p.ty;
            plv = p;
        }
        if (k > 0) {
            // the pair (q, q+1); din / ta belong to the earlier plane along the ray
            const int q = dirpos ? p - 1 : p;
            const int gxq = sl.xb + q;
            const bool pair_valid =
                gxq >= sl.slab * SLAB && gxq < sl.slab * SLAB + SLAB && prev.valid && cur_p.valid;
            if (pair_valid) {
                const Plane& A = dirpos ? prev : cur_p;
                const Plane& B = dirpos ? cur_p : prev;
                const float gxa = static_cast<float>(gxq);
                const float din = prev.d, dout = cur_p.d, ta = prev.ty, tb = cur_p.ty;
                const bool cross = din >= eps && dout < eps;
                const float tq1 = ta + 0.25f * (tb - ta);
                const float tmid = 0.5f * (ta + tb);
                const float tq3 = ta + 0.75f * (tb - ta);
                const float dq1 = model_at(r, A, B, gxa, tq1);
                const float dmid = model_at(r, A, B, gxa, tmid);
                const float dq3 = model_at(r, A, B, gxa, tq3);
                const float dip_t = dq1 < eps ? tq1 : (dmid < eps ? tmid : (dq3 < eps ? tq3 : BIGF));
                const float dip_min = nmin(dq1, nmin(dmid, dq3));
                const bool graze = !cross && din >= eps && dout >= eps && nmin(din, dout) < graze_gap &&
                                   dip_t < BIGF && dip_min < deep_below;
                const float dmin_pair = nmin(nmin(din, dout), dip_min);
                if (dmin_pair < nm_thresh) tnear = nmin(tnear, nmax(ta, 0.0f));
                if ((cross || graze) && !has_cand) {
                    has_cand = true;
                    cand_graze = graze;
                    const float d_eff = graze ? dip_min : dout;
                    const float den = nmax(din - d_eff, 1e-20f);
                    const float tb_eff = graze ? dip_t : tb;
                    t_hit = ta + (tb_eff - ta) * (din - eps) / den;
                }
            }
        }
        prev = cur_p;
    }

    // ---- entry / exit virtual samples, immediate hit ----------------
    const bool fresh = !sampled && has_sample && unhit;
    const int pair_e = min(max(dirpos ? pfv : pfv - 1, 0), SLAB - 1);
    const bool e_ok = fresh && (firstt - r.t_start) <= entry_reach && pair_ok(vmask, pair_e);
    bool entry_hit = false, entry_graze = false;
    float t_entry_hit = 0.0f;
    if (e_ok) {
        const Plane A = load_plane(r, g, sl, pair_e);
        const Plane B = load_plane(r, g, sl, pair_e + 1);
        const float gxa = static_cast<float>(sl.xb + pair_e);
        const float d_entry = model_at(r, A, B, gxa, r.t_start);
        const float t_mid_e = 0.5f * (r.t_start + firstt);
        const float d_mid_e = model_at(r, A, B, gxa, t_mid_e);
        entry_hit = d_entry < eps;
        entry_graze = !entry_hit && firstd >= eps && d_mid_e < eps;
        t_entry_hit = entry_hit ? r.t_start : t_at_eps(r.t_start, d_entry, t_mid_e, d_mid_e, eps);
    }
    const int pair_x = min(max(dirpos ? plv - 1 : plv, 0), SLAB - 1);
    const bool exiting = has_sample && unhit && r.t_end < lastt + spacing && pair_ok(vmask, pair_x);
    bool exit_cross = false, exit_graze = false;
    float t_exit_hit = 0.0f;
    if (exiting && lastd >= eps) {
        const Plane A = load_plane(r, g, sl, pair_x);
        const Plane B = load_plane(r, g, sl, pair_x + 1);
        const float gxa = static_cast<float>(sl.xb + pair_x);
        const float d_exit = model_at(r, A, B, gxa, r.t_end);
        const float t_mid_x = 0.5f * (lastt + r.t_end);
        const float d_mid_x = model_at(r, A, B, gxa, t_mid_x);
        exit_cross = d_exit < eps;
        exit_graze = d_exit >= eps && d_mid_x < eps;
        t_exit_hit = exit_cross ? t_at_eps(lastt, lastd, r.t_end, d_exit, eps)
                                : t_at_eps(lastt, lastd, t_mid_x, d_mid_x, eps);
    }
    const bool imm = fresh && firstd < eps;
    const bool found = has_cand && unhit;
    const bool any_entry = entry_hit || entry_graze;
    const bool any_exit = exit_cross || exit_graze;

    // priority along the ray: entry < immediate < in-slab < exit
    if (any_entry) {
        depth = t_entry_hit;
    } else if (imm) {
        depth = firstt;
    } else if (found) {
        depth = t_hit;
    } else if (any_exit) {
        depth = t_exit_hit;
    }
    if (unhit) {
        model |= (any_entry && !imm ? 1 : 0) | (found && cand_graze ? 2 : 0) | (any_exit ? 4 : 0);
        steps += n_valid;
    }
    hit |= (any_entry || imm || found || any_exit) ? 1 : 0;
    sampled |= has_sample ? 1 : 0;
    const float xbf = static_cast<float>(sl.xb);
    const float t_reach = dirpos ? r.tc0 + r.tc1 * (xbf + (PB - 0.5f)) : r.tc0 + r.tc1 * (xbf + 0.5f);
    dead |= hit | (t_reach >= r.t_end ? 1 : 0);
    st.depth = depth;
    st.tnear = tnear;
    st.hit = hit;
    st.steps = steps;
    st.sampled = sampled;
    st.model = model;
    st.dead = dead;
}

__global__ void __launch_bounds__(LANES, MIN_BLOCKS) plane_sweep_kernel(
    const int* __restrict__ tab, int tab_w, const float* __restrict__ ch, const float* vol0, const float* vol1,
    const float* vol2, float eps, float t_max, const int* __restrict__ order, float* __restrict__ out_depth,
    int* __restrict__ out_hit, int* __restrict__ out_steps, int* __restrict__ out_model,
    float* __restrict__ out_tnear, int* __restrict__ out_exec) {
    extern __shared__ int stab[];
    // blocks take the rows in the given order (most slots first), each
    // writing its own row
    const int row = order != nullptr ? order[blockIdx.x] : static_cast<int>(blockIdx.x);
    const int lane = threadIdx.x;
    const int* trow = tab + static_cast<size_t>(row) * tab_w;
    for (int i = lane; i < tab_w; i += LANES) stab[i] = trow[i];
    __syncthreads();

    const int n_act = stab[0];
    const int axis = stab[1];
    Geom g;
    g.nx = stab[2];
    g.ny = stab[3];
    g.nz = stab[4];
    g.vol = axis == 0 ? vol0 : (axis == 1 ? vol1 : vol2);
    const float* c = ch + static_cast<size_t>(row) * NCH * LANES + lane;
    Ray r;
    r.y0 = c[0 * LANES];
    r.sy = c[1 * LANES];
    r.z0 = c[2 * LANES];
    r.sz = c[3 * LANES];
    r.tc0 = c[4 * LANES];
    r.tc1 = c[5 * LANES];
    r.t_start = c[6 * LANES];
    r.t_end = c[7 * LANES];
    r.half = c[8 * LANES];
    LaneConst kc;
    kc.eps = eps;
    kc.dirpos = r.tc1 > 0.0f;
    kc.spacing = fabsf(r.tc1);
    kc.deep_below = eps - 2.0f * r.half;  // a graze must dip below eps - res
    kc.nm_thresh = eps + 0.5f * (2.0f * r.half);
    kc.graze_gap = 1.1f * kc.spacing;
    kc.entry_reach = 1.5f * kc.spacing;

    LaneState st = {t_max, BIGF, 0, 0, 0, 0, 0};
    int s = 0;
    while (s < n_act) {
        if (!__syncthreads_or(!st.dead)) break;
        sweep_slab(r, g, unpack(stab[HDR + s], g), kc, st);
        ++s;
    }
    const size_t o = static_cast<size_t>(row) * LANES + lane;
    out_depth[o] = st.depth;
    out_hit[o] = st.hit;
    out_steps[o] = st.steps;
    out_model[o] = st.model;
    out_tnear[o] = st.tnear;
    out_exec[o] = s;
}

// ---- row order ---------------------------------------------------------------

constexpr int ORDER_THREADS = 1024;
constexpr int ORDER_BUCKETS = 256;  // slot counts from 255 up share the first place

// this lane's bucket of row i: most slots first
__device__ __forceinline__ int order_bucket(const int* tab, int tab_w, int i) {
    return ORDER_BUCKETS - 1 - min(max(tab[static_cast<size_t>(i) * tab_w], 0), ORDER_BUCKETS - 1);
}

// the rows by slot count, most first: a counting sort in one block (the
// order among rows of one count is the atomics'; each block of the sweep
// writes its own row, so the outputs do not depend on it)
__global__ void __launch_bounds__(ORDER_THREADS) row_order_kernel(const int* __restrict__ tab, int tab_w, int rows,
                                                                 int* __restrict__ order) {
    __shared__ int start[ORDER_BUCKETS];
    for (int b = threadIdx.x; b < ORDER_BUCKETS; b += ORDER_THREADS) start[b] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int i = threadIdx.x; i < rows; i += ORDER_THREADS) {
        const int b = order_bucket(tab, tab_w, i);
        const unsigned peers = __match_any_sync(__activemask(), b);
        if (lane == __ffs(peers) - 1) atomicAdd(&start[b], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int run = 0;
        for (int b = 0; b < ORDER_BUCKETS; ++b) {
            const int n = start[b];
            start[b] = run;
            run += n;
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += ORDER_THREADS) {
        const int b = order_bucket(tab, tab_w, i);
        const unsigned peers = __match_any_sync(__activemask(), b);
        const int leader = __ffs(peers) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&start[b], __popc(peers));
        base = __shfl_sync(peers, base, leader);
        order[base + __popc(peers & ((1u << lane) - 1u))] = i;
    }
}

}  // namespace

// order: rows ints of scratch for the row order (most slots first), or
// nullptr for the table's order; the slot table (tab_w ints) must fit the
// default 48 KB of dynamic shared memory
extern "C" int sdf_plane_sweep(const int* tab, int tab_w, const float* ch, const float* vol0, const float* vol1,
                               const float* vol2, float eps, float t_max, int rows, int* order, float* depth,
                               int* hit, int* steps, int* model, float* tnear, int* exec, cudaStream_t stream) {
    if (rows <= 0) return 0;
    if (order != nullptr) {
        row_order_kernel<<<1, ORDER_THREADS, 0, stream>>>(tab, tab_w, rows, order);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const size_t smem = static_cast<size_t>(tab_w) * sizeof(int);
    plane_sweep_kernel<<<rows, LANES, smem, stream>>>(tab, tab_w, ch, vol0, vol1, vol2, eps, t_max, order, depth,
                                                      hit, steps, model, tnear, exec);
    return static_cast<int>(cudaGetLastError());
}

// the kernel's registers per thread, local (spill) bytes, static shared
// bytes, most threads a block, blocks per SM and dynamic shared bytes at a
// table width: out[0..5]
extern "C" int sdf_plane_sweep_attrs(int tab_w, int* out) {
    const size_t smem = static_cast<size_t>(tab_w) * sizeof(int);
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, plane_sweep_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    int nb = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, plane_sweep_kernel, LANES, smem);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = a.maxThreadsPerBlock;
    out[4] = nb;
    out[5] = static_cast<int>(smem);
    return static_cast<int>(e);
}
