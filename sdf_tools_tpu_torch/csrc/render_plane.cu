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
// models re-read their pair's corners, which happens at most once or twice
// per ray. Each lane's result depends only on its own samples and its
// row's table, and every lane takes every slab the row executes (as on the
// TPU, where a dead lane still updates tnear), so the per-thread order
// gives the TPU's (16, 128) vector form's outputs.
//
// What bounds it: each sample reads 4 corner cells (two 8-byte pairs) from
// the row's transposed field through the read-only path (__ldg), and does
// about 30 float operations, plus about 100 more for each valid pair's
// three model probes. A tile's footprint over one slab is about 17 x 22 x
// 22 cells (about 33 KB), which the 50 MB L2 serves after the first touch;
// the TPU's band (17 x 56 x 256 f32, 975 KB) would not fit 227 KB of
// shared memory, and staging a footprint-sized band with TMA or cp.async
// is left to later work. Dead lanes of a running row still compute.
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

// NaN-propagating min / max (torch.minimum / jnp.minimum)
__device__ __forceinline__ float nmin(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a)); }
__device__ __forceinline__ float nmax(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : (b > a ? b : a)); }

// float -> int32 truncation saturating like the plain version's _f2i
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

struct Plane {
    float ty, d;
    float c00, c01, c10, c11;  // center-corrected corner values
    int loy, loz;
    bool valid;
};

__device__ __forceinline__ float corr(float v, float half) { return v >= 0.0f ? v - half : v + half; }

__device__ __forceinline__ Plane load_plane(const Ray& r, const Geom& g, int xb, int yb, int zb, int p) {
    Plane q;
    const int gx = xb + p;
    const float ux = static_cast<float>(gx) + 0.5f;
    q.ty = r.tc0 + r.tc1 * ux;
    const float uy = r.y0 + r.sy * ux;
    const float uz = r.z0 + r.sz * ux;
    bool valid = q.ty >= r.t_start && q.ty <= r.t_end && gx >= 0 && gx <= g.nx - 1 && uy >= 0.0f &&
                 uy < static_cast<float>(g.ny) && uz >= 0.0f && uz < static_cast<float>(g.nz);
    q.loy = min(max(f2i(floorf(uy - 0.5f)), 0), g.ny - 2);
    q.loz = min(max(f2i(floorf(uz - 0.5f)), 0), g.nz - 2);
    const float wy = uy - 0.5f - static_cast<float>(q.loy);
    const float wz = uz - 0.5f - static_cast<float>(q.loz);
    const int ryb = q.loy - yb, rzb = q.loz - zb;
    valid = valid && ryb >= 0 && ryb <= BY - 2 && rzb >= 0 && rzb <= BZ - 2;
    q.valid = valid;
    if (valid) {
        const float* c = g.vol + (static_cast<size_t>(gx) * g.ny + q.loy) * g.nz + q.loz;
        q.c00 = corr(__ldg(c), r.half);
        q.c01 = corr(__ldg(c + 1), r.half);
        q.c10 = corr(__ldg(c + g.nz), r.half);
        q.c11 = corr(__ldg(c + g.nz + 1), r.half);
        q.d = q.c00 * (1.0f - wy) * (1.0f - wz) + q.c01 * (1.0f - wy) * wz + q.c10 * wy * (1.0f - wz) +
              q.c11 * wy * wz;
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

__global__ void __launch_bounds__(LANES) plane_sweep_kernel(
    const int* __restrict__ tab, int tab_w, const float* __restrict__ ch, const float* vol0, const float* vol1,
    const float* vol2, float eps, float t_max, float* __restrict__ out_depth, int* __restrict__ out_hit,
    int* __restrict__ out_steps, int* __restrict__ out_model, float* __restrict__ out_tnear,
    int* __restrict__ out_exec) {
    extern __shared__ int stab[];
    const int row = blockIdx.x;
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
    const bool dirpos = r.tc1 > 0.0f;
    const float spacing = fabsf(r.tc1);
    const float deep_below = eps - 2.0f * r.half;  // a graze must dip below eps - res
    const float nm_thresh = eps + 0.5f * (2.0f * r.half);
    const float graze_gap = 1.1f * spacing;
    const float entry_reach = 1.5f * spacing;

    float depth = t_max, tnear = BIGF;
    int hit = 0, steps = 0, sampled = 0, model = 0, dead = 0;
    int s = 0;
    while (s < n_act) {
        if (!__syncthreads_or(!dead)) break;
        const int pack = stab[HDR + s];
        const int zb = (pack % 32) * 128;
        const int yb = ((pack / 32) % 256) * 8;
        const int slab = pack / (32 * 256);
        const int xb = min(slab * SLAB, g.nx - PB);
        const bool unhit = hit == 0;

        bool has_cand = false, cand_graze = false, has_sample = false;
        float t_hit = 0.0f, firstd = 0.0f, firstt = 0.0f, lastd = 0.0f, lastt = 0.0f;
        int pfv = 0, plv = 0, n_valid = 0;
        unsigned vmask = 0u;
        Plane prev;
#pragma unroll
        for (int k = 0; k < PB; ++k) {
            const int p = dirpos ? k : PB - 1 - k;
            const Plane cur = load_plane(r, g, xb, yb, zb, p);
            if (cur.valid) {
                vmask |= 1u << p;
                ++n_valid;
                if (!has_sample) {
                    has_sample = true;
                    firstd = cur.d;
                    firstt = cur.ty;
                    pfv = p;
                }
                lastd = cur.d;
                lastt = cur.ty;
                plv = p;
            }
            if (k > 0) {
                // the pair (q, q+1); din / ta belong to the earlier plane along the ray
                const int q = dirpos ? p - 1 : p;
                const int gxq = xb + q;
                const bool pair_valid = gxq >= slab * SLAB && gxq < slab * SLAB + SLAB && prev.valid && cur.valid;
                if (pair_valid) {
                    const Plane& A = dirpos ? prev : cur;
                    const Plane& B = dirpos ? cur : prev;
                    const float gxa = static_cast<float>(gxq);
                    const float din = prev.d, dout = cur.d, ta = prev.ty, tb = cur.ty;
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
            prev = cur;
        }

        // ---- entry / exit virtual samples, immediate hit ----------------
        const bool fresh = !sampled && has_sample && unhit;
        const int pair_e = min(max(dirpos ? pfv : pfv - 1, 0), SLAB - 1);
        const bool e_ok = fresh && (firstt - r.t_start) <= entry_reach && pair_ok(vmask, pair_e);
        bool entry_hit = false, entry_graze = false;
        float t_entry_hit = 0.0f;
        if (e_ok) {
            const Plane A = load_plane(r, g, xb, yb, zb, pair_e);
            const Plane B = load_plane(r, g, xb, yb, zb, pair_e + 1);
            const float gxa = static_cast<float>(xb + pair_e);
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
            const Plane A = load_plane(r, g, xb, yb, zb, pair_x);
            const Plane B = load_plane(r, g, xb, yb, zb, pair_x + 1);
            const float gxa = static_cast<float>(xb + pair_x);
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
        const float xbf = static_cast<float>(xb);
        const float t_reach = dirpos ? r.tc0 + r.tc1 * (xbf + (PB - 0.5f)) : r.tc0 + r.tc1 * (xbf + 0.5f);
        dead |= hit | (t_reach >= r.t_end ? 1 : 0);
        ++s;
    }
    const size_t o = static_cast<size_t>(row) * LANES + lane;
    out_depth[o] = depth;
    out_hit[o] = hit;
    out_steps[o] = steps;
    out_model[o] = model;
    out_tnear[o] = tnear;
    out_exec[o] = s;
}

}  // namespace

extern "C" int sdf_plane_sweep(const int* tab, int tab_w, const float* ch, const float* vol0, const float* vol1,
                               const float* vol2, float eps, float t_max, int rows, float* depth, int* hit,
                               int* steps, int* model, float* tnear, int* exec, cudaStream_t stream) {
    if (rows <= 0) return 0;
    const size_t smem = static_cast<size_t>(tab_w) * sizeof(int);
    plane_sweep_kernel<<<rows, LANES, smem, stream>>>(tab, tab_w, ch, vol0, vol1, vol2, eps, t_max, depth, hit,
                                                      steps, model, tnear, exec);
    return static_cast<int>(cudaGetLastError());
}
