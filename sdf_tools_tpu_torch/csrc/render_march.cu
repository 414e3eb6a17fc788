// The exact march: sphere-traced depth of independent rays over an SdfGrid.
//
// Replaces no Pallas kernel: the JAX march (sdf_tools_tpu/ops/render.py,
// _trace_depth) is plain XLA, a fixed sequence of masked vector steps. Its
// plain version here is sdf_tools_tpu_torch/ops/render.py::_march, which
// states the semantics; a CUDA tensor of float32 rays reaches this kernel
// through render._trace_depth instead.
//
// Design: one thread per ray, the ray's whole state (t, the previous t, the
// exit, the in-box, hit and near flags, the step count) in registers. The
// thread runs _march's phases in order: the ray/AABB entry, the coarse skip
// over the min-pooled field (when a pooled field is given), 3 rounds of the
// nearest-neighbour and trilinear phases, the final check and 6 bisection
// steps. Every quantity is the same float32 expression, evaluated in the same
// order, as the torch operations of _march (built with -fmad=false and IEEE
// division, so nothing is contracted or approximated): the trilinear sample
// repeats ops/query.py::interpolation_stencil's value path (g / res for the
// cell, the centre-corrected corners in (x)(y)(z) order with z fastest, the
// weights from the lower corner times 1 / res), the nearest-neighbour and
// coarse lookups take g * (1 / res) and g * (1 / (8 res)) as _march does,
// and the float-to-int casts saturate as grid.float_to_int32 (NaN -> 0).
// The pooled field's slack (res * 0.87) is subtracted here, at each lookup,
// as _march subtracts it from the whole pooled field: the same two floats.
//
// A ray leaves a phase early only where _march's masked steps could no
// longer change its state: a masked step that does not advance leaves t,
// the flags and the count as they were, so every later step of that phase
// does too; a ray that has hit or left the box changes nothing in the
// rounds after. Rays that miss the box take no step at all.
//
// What bounds it: not the bytes. A ray reads its origin and direction (24 B)
// and writes depth, hit and steps (9 B); its samples gather at most about
// 100 cells of the pooled field and the field, 8 a trilinear sample, and
// neighbouring rays gather neighbouring cells, which L1 and L2 serve. The
// time goes to the dependent chain of a ray's samples (each step's position
// depends on the last sample) and to divergence inside a warp, whose rays
// take different numbers of steps. The field and the pooled field are read
// through the read-only data path.
//
// Built for the host too (g++, without __CUDACC__) as sdf_march_host, the
// same per-ray code looped over the rays: the CPU tests hold it against
// _march bitwise.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MARCH_FN __device__ __forceinline__
#define LDG(p) __ldg(p)
#else
#define MARCH_FN inline
#define LDG(p) (*(p))
#endif
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int FACTOR = 8;  // the coarse pool's stride (render.coarse_min_pool)
constexpr int ROUNDS = 3;
constexpr int TRI_STEPS = 6;
constexpr int BISECT_STEPS = 6;

// torch.maximum: NaN if either is NaN
MARCH_FN float tmax(float a, float b) { return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b); }
MARCH_FN float tmin(float a, float b) { return (isnan(a) || isnan(b)) ? NAN : fminf(a, b); }

// grid.floor_to_int32: floor, NaN -> 0, saturated to the int32 limits
MARCH_FN int floor_i32(float x) {
    const float f = floorf(x);
    if (isnan(f)) return 0;
    if (f >= 2147483648.0f) return 2147483647;
    return static_cast<int>(fmaxf(f, -2147483648.0f));
}

MARCH_FN int clampi(int i, int n) { return i < 0 ? 0 : (i > n - 1 ? n - 1 : i); }

MARCH_FN int64_t flat_index(int ix, int iy, int iz, int ny, int nz) {
    return (static_cast<int64_t>(ix) * ny + iy) * nz + iz;
}

struct March {
    const float* values;
    const float* pooled;  // nullptr: no coarse skip
    float r[9], tr[3];  // the inverse transform's rotation (row-major) and translation
    int nx, ny, nz, cx, cy, cz;
    float res, inv_res, inv_c, half, two_res, slack, ms, t_min, t_max, eps, oob;
    int coarse_steps, nn_steps;
    float ox, oy, oz, vx, vy, vz;  // this ray
};

// GridMeta.world_to_grid of o + t v: rotate_points, then + the translation
MARCH_FN void grid_point(const March& m, float t, float* g, float* p) {
    p[0] = m.ox + t * m.vx;
    p[1] = m.oy + t * m.vy;
    p[2] = m.oz + t * m.vz;
    for (int a = 0; a < 3; ++a) g[a] = ((p[0] * m.r[3 * a] + p[1] * m.r[3 * a + 1]) + p[2] * m.r[3 * a + 2]) + m.tr[a];
}

// query._axis_interp_indices along one axis
MARCH_FN void interp_indices(int i, int n, float offset, int* lo, int* up) {
    const int ip = i + 1 >= n ? i : i + 1;
    const int im = i - 1 < 0 ? i : i - 1;
    if (offset >= 0.0f) {
        *lo = i + 1 >= n ? im : i;
        *up = ip;
    } else {
        *lo = im;
        *up = i - 1 < 0 ? ip : i;
    }
}

// query._distance_at of o + t v: (the trilinear distance, or oob out of
// bounds; in bounds)
MARCH_FN float dist_at(const March& m, float t, bool* in_bounds) {
    float g[3], p[3];
    grid_point(m, t, g, p);
    const int n[3] = {m.nx, m.ny, m.nz};
    bool ok = isfinite(p[0]) && isfinite(p[1]) && isfinite(p[2]);
    int lo[3], up[3];
    for (int a = 0; a < 3; ++a) {
        const int i = floor_i32(g[a] / m.res);
        ok = ok && i >= 0 && i < n[a];
        const int safe = clampi(i, n[a]);
        const float offset = g[a] - (static_cast<float>(safe) + 0.5f) * m.res;
        interp_indices(safe, n[a], offset, &lo[a], &up[a]);
    }
    float w[3][2];
    for (int a = 0; a < 3; ++a) {
        const float ap = (g[a] - (static_cast<float>(lo[a]) + 0.5f) * m.res) * m.inv_res;
        w[a][0] = 1.0f - ap;
        w[a][1] = ap;
    }
    float value = 0.0f;
    for (int i = 0; i < 2; ++i) {
        const int ix = i ? up[0] : lo[0];
        for (int j = 0; j < 2; ++j) {
            const int iy = j ? up[1] : lo[1];
            for (int l = 0; l < 2; ++l) {
                const int iz = l ? up[2] : lo[2];
                const float v = LDG(m.values + flat_index(ix, iy, iz, m.ny, m.nz));
                const float c = v >= 0.0f ? v - m.half : v + m.half;
                const float wt = w[0][i] * w[1][j] * w[2][l];
                value = value + wt * c;
            }
        }
    }
    *in_bounds = ok;
    return ok ? value : m.oob;
}

// _march's nn_dist: the nearest cell's value (res out of bounds; in bounds)
MARCH_FN float nn_dist(const March& m, float t, bool* ok) {
    float g[3], p[3];
    grid_point(m, t, g, p);
    const int ix = floor_i32(g[0] * m.inv_res), iy = floor_i32(g[1] * m.inv_res), iz = floor_i32(g[2] * m.inv_res);
    *ok = ix >= 0 && ix < m.nx && iy >= 0 && iy < m.ny && iz >= 0 && iz < m.nz;
    const float v = LDG(m.values + flat_index(clampi(ix, m.nx), clampi(iy, m.ny), clampi(iz, m.nz), m.ny, m.nz));
    return *ok ? v : m.res;
}

// _march's coarse_at: the nearest block's bound, the block clamped into the
// pooled grid
MARCH_FN float coarse_at(const March& m, float t) {
    float g[3], p[3];
    grid_point(m, t, g, p);
    const int ix = clampi(floor_i32(g[0] * m.inv_c), m.cx);
    const int iy = clampi(floor_i32(g[1] * m.inv_c), m.cy);
    const int iz = clampi(floor_i32(g[2] * m.inv_c), m.cz);
    return LDG(m.pooled + flat_index(ix, iy, iz, m.cy, m.cz)) - m.slack;
}

// One ray's (depth, hit, steps).
MARCH_FN void march_ray(const March& m, float* depth_out, bool* hit_out, int* steps_out) {
    // ray/AABB entry in the grid frame
    const float o[3] = {m.ox, m.oy, m.oz}, v[3] = {m.vx, m.vy, m.vz};
    const float sizes[3] = {static_cast<float>(m.nx) * m.res, static_cast<float>(m.ny) * m.res,
                            static_cast<float>(m.nz) * m.res};
    float t_entry = 0.0f, t_exit = 0.0f;
    bool finite = true;
    for (int a = 0; a < 3; ++a) {
        const float og = ((o[0] * m.r[3 * a] + o[1] * m.r[3 * a + 1]) + o[2] * m.r[3 * a + 2]) + m.tr[a];
        const float vg = (v[0] * m.r[3 * a] + v[1] * m.r[3 * a + 1]) + v[2] * m.r[3 * a + 2];
        finite = finite && isfinite(og) && isfinite(vg);
        const float safe_v = fabsf(vg) > 1e-12f ? vg : 1e-12f;
        const float t_a = (0.0f - og) / safe_v;
        const float t_b = (sizes[a] - og) / safe_v;
        const float lo = tmin(t_a, t_b), hi = tmax(t_a, t_b);
        t_entry = a == 0 ? lo : tmax(t_entry, lo);
        t_exit = a == 0 ? hi : tmin(t_exit, hi);
    }
    if (t_entry > t_exit || t_exit < m.t_min || !finite) {  // misses the box: no step at all
        *depth_out = m.t_max;
        *hit_out = false;
        *steps_out = 0;
        return;
    }
    const float exit_lim = t_exit + m.res;
    float t = tmax(m.t_min, t_entry);
    int steps = 0;

    // coarse empty-space skipping on the min-pooled lower bound
    if (m.pooled != nullptr) {
        const float sw = 2.0f * m.res;
        for (int k = 0; k < m.coarse_steps; ++k) {
            const float dc = coarse_at(m, t);
            const bool skip = dc > sw;
            const float t_new = skip ? t + tmax(dc, m.res) : t;
            steps += skip;
            const bool out = t_new > m.t_max || t_new > exit_lim;
            t = t_new;
            if (!skip || out) break;  // not alive: t stays
        }
    }

    // nearest-neighbour and trilinear rounds
    float t_prev = t;
    bool in_box = true, hit = false;
    for (int round = 0; round < ROUNDS && in_box && !hit; ++round) {
        bool near = false;
        for (int k = 0; k < m.nn_steps; ++k) {
            bool ok;
            const float dnn = nn_dist(m, t, &ok);
            const bool near_now = ok && dnn < m.two_res;
            const bool advance = in_box && !near && !near_now;  // hit is false here
            steps += advance;
            const float t_new = advance ? t + tmax(dnn - m.slack, m.ms) : t;
            if (advance) t_prev = t;
            in_box = in_box && !(t_new > m.t_max || t_new > exit_lim);
            near = near || (in_box && near_now);
            t = t_new;
            if (!advance) break;  // the same step again would change nothing
        }
        if (!(near && in_box)) continue;  // the trilinear phase cannot advance or hit
        bool unused;
        float d = dist_at(m, t, &unused);
        for (int k = 0; k < TRI_STEPS; ++k) {
            const bool advance = in_box && d >= m.eps;
            if (!advance) break;
            ++steps;
            const float t_new = t + tmax(d, m.ms);
            t_prev = t;
            d = dist_at(m, t_new, &unused);
            in_box = !(t_new > m.t_max || t_new > exit_lim);
            t = t_new;
        }
        hit = in_box && d < m.eps;
    }

    if (hit) {
        bool ok_final;
        const float d_final = dist_at(m, t, &ok_final);
        hit = ok_final && d_final < m.eps && t <= m.t_max;
    }
    *steps_out = steps;
    *hit_out = hit;
    if (!hit) {
        *depth_out = m.t_max;
        return;
    }
    // bisection: the crossing lies in [t_prev, t]
    float lo = t_prev, hi = t;
    for (int k = 0; k < BISECT_STEPS; ++k) {
        const float mid = 0.5f * (lo + hi);
        bool unused;
        const bool outside = dist_at(m, mid, &unused) > 0.0f;
        lo = outside ? mid : lo;
        hi = outside ? hi : mid;
    }
    *depth_out = hi;
}

struct Params {
    const float* values;
    const float* pooled;
    const float* inv_tf;
    const float* oob;
    const float* min_step;
    const float* origins;
    const float* directions;
    int n, nx, ny, nz, cx, cy, cz;
    float res, t_min, t_max, eps;
    int max_steps;
    float* depth;
    bool* hit;
    int* steps;
};

// The per-call constants, each the float32 expression _march computes it by.
MARCH_FN void set_up(March& m, const Params& p, int64_t i) {
    m.values = p.values;
    m.pooled = p.pooled;
    for (int a = 0; a < 3; ++a) {
        for (int b = 0; b < 3; ++b) m.r[3 * a + b] = LDG(p.inv_tf + 4 * a + b);
        m.tr[a] = LDG(p.inv_tf + 4 * a + 3);
    }
    m.nx = p.nx;
    m.ny = p.ny;
    m.nz = p.nz;
    m.cx = p.cx;
    m.cy = p.cy;
    m.cz = p.cz;
    m.res = p.res;
    m.inv_res = 1.0f / p.res;
    m.inv_c = 1.0f / (p.res * static_cast<float>(FACTOR));
    m.half = p.res * 0.5f;
    m.two_res = 2.0f * p.res;
    m.slack = p.res * 0.87f;
    m.ms = p.min_step != nullptr ? LDG(p.min_step) : p.res * 0.5f;
    m.t_min = p.t_min;
    m.t_max = p.t_max;
    m.eps = p.eps;
    m.oob = LDG(p.oob);
    m.coarse_steps = p.max_steps / 8 > 8 ? p.max_steps / 8 : 8;
    m.nn_steps = p.max_steps / ROUNDS > 4 ? p.max_steps / ROUNDS : 4;
    m.ox = LDG(p.origins + 3 * i);
    m.oy = LDG(p.origins + 3 * i + 1);
    m.oz = LDG(p.origins + 3 * i + 2);
    m.vx = LDG(p.directions + 3 * i);
    m.vy = LDG(p.directions + 3 * i + 1);
    m.vz = LDG(p.directions + 3 * i + 2);
}

MARCH_FN void march_one(const Params& p, int64_t i) {
    March m;
    set_up(m, p, i);
    march_ray(m, p.depth + i, p.hit + i, p.steps + i);
}

Params make_params(const float* values, const float* pooled, const float* inv_tf, const float* oob,
                   const float* min_step, const float* origins, const float* directions, int n, int nx, int ny, int nz,
                   int cx, int cy, int cz, float res, float t_min, float t_max, float eps, int max_steps, float* depth,
                   bool* hit, int* steps) {
    return Params{values, pooled, inv_tf, oob, min_step, origins, directions, n, nx, ny, nz, cx, cy, cz,
                  res, t_min, t_max, eps, max_steps, depth, hit, steps};
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(THREADS) march_kernel(const Params p) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i < p.n) march_one(p, i);
}
#endif

}  // namespace

#ifdef __CUDACC__
// values [nx, ny, nz] f32; pooled [cx, cy, cz] f32 or NULL (no coarse skip);
// inv_tf the 4x4 inverse origin transform, oob one f32, min_step one f32 or
// NULL (res / 2), all on the device; origins, directions [n, 3] f32; depth
// [n] f32, hit [n] bool, steps [n] int32 out. One launch, a thread a ray.
extern "C" int sdf_march(const float* values, const float* pooled, const float* inv_tf, const float* oob,
                         const float* min_step, const float* origins, const float* directions, int n, int nx, int ny,
                         int nz, int cx, int cy, int cz, float res, float t_min, float t_max, float eps, int max_steps,
                         float* depth, bool* hit, int* steps, cudaStream_t stream) {
    if (n <= 0) return 0;
    const Params p = make_params(values, pooled, inv_tf, oob, min_step, origins, directions, n, nx, ny, nz, cx, cy, cz,
                                 res, t_min, t_max, eps, max_steps, depth, hit, steps);
    march_kernel<<<static_cast<unsigned>((static_cast<int64_t>(n) + THREADS - 1) / THREADS), THREADS, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}
#else
// The same rays marched one after another on the host (the CPU tests'
// build), arguments as sdf_march's without the stream.
extern "C" int sdf_march_host(const float* values, const float* pooled, const float* inv_tf, const float* oob,
                              const float* min_step, const float* origins, const float* directions, int n, int nx,
                              int ny, int nz, int cx, int cy, int cz, float res, float t_min, float t_max, float eps,
                              int max_steps, float* depth, bool* hit, int* steps) {
    const Params p = make_params(values, pooled, inv_tf, oob, min_step, origins, directions, n, nx, ny, nz, cx, cy, cz,
                                 res, t_min, t_max, eps, max_steps, depth, hit, steps);
    for (int64_t i = 0; i < n; ++i) march_one(p, i);
    return 0;
}
#endif
