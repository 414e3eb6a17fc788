"""K8's reads and launch order (``csrc/render_plane.cu``) emulated on the CPU.

Each thread of the kernel streams a slab's 17 planes in its marching order
and reads the 4 corner cells of every valid plane straight from the field;
the entry and exit models re-read the corners of one pair of valid planes.
This file walks each slab each row executes (the ``exec`` counts of
``plane_sweep_rows_plain``, on port-side tables from ``plane_sweep_tables``)
the kernel's way, lane by lane and plane by plane, and asserts with no
tolerance:

- every corner read, the entry and exit re-reads included, lies inside the
  volume and inside the slab's box of ``render_plane.slab_footprints``
  (whose distinct cells give K8's byte bound), and the box is the reads'
  hull;
- ``slab_footprints``' valid samples and valid pairs (the pairs that run
  the three model probes, K8's operation bound) are the kernel's counts;
- the kernel's row order (a counting sort by slot count) launches every
  row once, most slots first.

Scenes: ``plane_scenes.k8_edge_case``, which the card's run holds the kernel
to as well: the two-sphere field of the plane tests marching +x and -x; a
grid with ``nx % 16 != 0`` (the shifted last slab) and ``nz % 4 != 0``; one
launch of rows marching axes 1 and 2; rays starting inside an obstacle
(entry models); steep rows near ``SLOPE_CAP``.
"""
import numpy as np
import pytest
import torch

from plane_scenes import K8_EDGE_CASES, K8_EDGE_T_MAX, k8_edge_case
from sdf_tools_tpu_torch import GridMeta, SdfGrid
from sdf_tools_tpu_torch.ops import render_plane as rp

EPS = 1e-3  # SdfEngine's default, as the card's run uses


def sweep(values, res, o, v, oob=np.inf):
    """(tables, plain outputs) for rays (o, v) [..., 3] over ``values``."""
    meta = GridMeta.create(torch.eye(4), res, values.shape, device="cpu")
    sdf = SdfGrid.create(torch.as_tensor(values), meta, oob)
    rays = rp.prepare_rays(torch.as_tensor(o), torch.as_tensor(v))
    tables = rp.plane_sweep_tables(sdf.values, meta, rays.origins, rays.directions, 0.0, K8_EDGE_T_MAX)
    return tables, rp.plane_sweep_rows_plain(tables.tab, tables.ch, tables.vols, EPS, K8_EDGE_T_MAX)


def emulate(tables, exec_rows):
    """Per executed slab, in ``slab_footprints``' order: (xb, the planes,
    rows and cells of every corner read as (min, max) pairs, or None when
    the slab reads nothing; valid samples; valid pairs), after checking
    that every read lies inside the volume."""
    tab, ch = tables.tab.numpy(), tables.ch.numpy()
    f32 = np.float32
    out = []
    for r in range(tab.shape[0]):
        axis, nx, ny, nz = (int(x) for x in tab[r, 1:5])
        y0c, sy, z0c, sz, tc0, tc1, t_start, t_end = (ch[r, k][:, None] for k in range(8))
        dirpos = tc1[:, 0] > 0
        lanes = np.arange(rp.LANES)
        for s in range(int(exec_rows[r])):
            pack = int(tab[r, rp.HDR + s])
            zb, yb, slab = (pack % 32) * 128, ((pack // 32) % 256) * 8, pack // (32 * 256)
            xb = min(slab * rp.SLAB, nx - rp.PB)
            gx = xb + np.arange(rp.PB)[None, :]  # [lanes, 17]
            ux = gx.astype(f32) + f32(0.5)
            ty = tc0 + tc1 * ux
            uy = y0c + sy * ux
            uz = z0c + sz * ux
            valid = (ty >= t_start) & (ty <= t_end) & (gx >= 0) & (gx <= nx - 1) & (uy >= 0) & (uy < f32(ny))
            valid &= (uz >= 0) & (uz < f32(nz))
            f2i = lambda a: np.clip(a, -2147483648.0, 2147483520.0).astype(np.int64)  # noqa: E731
            loy = np.clip(f2i(np.floor(uy - f32(0.5))), 0, ny - 2)
            loz = np.clip(f2i(np.floor(uz - f32(0.5))), 0, nz - 2)
            valid &= (loy - yb >= 0) & (loy - yb <= rp.BY - 2) & (loz - zb >= 0) & (loz - zb <= rp.BZ - 2)

            # the sweep in each lane's marching order: every valid plane's
            # corners, and the pairs (q, q + 1) that run the model probes
            reads = []
            pairs = 0
            first = np.full(rp.LANES, -1)
            last = np.full(rp.LANES, -1)
            for k in range(rp.PB):
                p = np.where(dirpos, k, rp.PB - 1 - k)
                on = valid[lanes, p]
                reads.append((lanes[on], p[on]))
                first = np.where(on & (first < 0), p, first)
                last = np.where(on, p, last)
                if k > 0:
                    q = np.where(dirpos, p - 1, p)
                    own = (xb + q >= slab * rp.SLAB) & (xb + q < slab * rp.SLAB + rp.SLAB)
                    pairs += int((own & valid[lanes, q] & valid[lanes, q + 1]).sum())
            # the entry and exit models re-read one pair of valid planes each
            for q in (np.where(dirpos, first, first - 1), np.where(dirpos, last - 1, last)):
                q = np.clip(q, 0, rp.SLAB - 1)
                ok = (first >= 0) & valid[lanes, q] & valid[lanes, q + 1]
                reads += [(lanes[ok], q[ok]), (lanes[ok], q[ok] + 1)]
            li = np.concatenate([a for a, _ in reads])
            pp = np.concatenate([b for _, b in reads])
            ly, lz, lx = loy[li, pp], loz[li, pp], xb + pp
            assert (lx >= 0).all() and (lx <= nx - 1).all()
            assert (ly >= 0).all() and (ly + 1 <= ny - 1).all(), "a corner row outside the volume"
            assert (lz >= 0).all() and (lz + 1 <= nz - 1).all(), "a corner cell outside the volume"
            box = None
            if li.size:
                box = ((int(pp.min()), int(pp.max())), (int(ly.min()), int(ly.max()) + 1),
                       (int(lz.min()), int(lz.max()) + 1))
            out.append((xb, box, int(valid.sum()), pairs))
    return out


CASES = list(K8_EDGE_CASES)


@pytest.fixture(scope="module")
def edge_cases():
    out = {}
    for case in CASES:
        values, res, o, v = k8_edge_case(case)
        tables, plain = sweep(values, res, o, v)
        out[case] = (tables, plain[5][:, 0])
    return out


@pytest.mark.parametrize("case", CASES)
def test_reads_lie_in_slab_footprints(case, edge_cases):
    """Every executed slab's reads, samples and pairs (module docstring)
    against the package's ``slab_footprints``."""
    tables, exec_rows = edge_cases[case]
    assert int(exec_rows.sum()) > 0
    slabs = emulate(tables, exec_rows)
    fp = rp.slab_footprints(tables.tab, tables.ch, tables.vols, exec_rows)
    assert fp["row"].numel() == len(slabs) == int(exec_rows.sum())
    np.testing.assert_array_equal(fp["xb"].numpy(), [x for x, _, _, _ in slabs])
    np.testing.assert_array_equal(fp["samples"].numpy(), [n for _, _, n, _ in slabs])
    np.testing.assert_array_equal(fp["pairs"].numpy(), [n for _, _, _, n in slabs])
    read = np.array([box is not None for _, box, _, _ in slabs])
    np.testing.assert_array_equal((fp["p1"] >= fp["p0"]).numpy(), read)
    assert read.any()
    got = np.stack([fp[k].numpy() for k in ("p0", "p1", "y0", "y1", "z0", "z1")], 1)[read]
    want = np.array([np.ravel(box) for _, box, _, _ in slabs if box is not None])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_scene_exercises_its_path(case, edge_cases):
    """Each scene reaches what it is here for: the marching direction and
    axes, the shifted last slab, entry hits, and steep rows whose slabs
    span many corner rows."""
    tables, exec_rows = edge_cases[case]
    tab, ch = tables.tab, tables.ch
    fp = rp.slab_footprints(tab, ch, tables.vols, exec_rows)
    live = tab[:, 0] > 0
    if case == "forward":
        assert bool((ch[live, 5] > 0).all())
    elif case == "backward":
        assert bool((ch[live, 5] < 0).all())
    elif case == "shifted":
        nx = int(tab[0, 2])
        assert nx % rp.SLAB and tables.vols[0].shape[2] % 4
        assert bool((fp["xb"] == nx - rp.PB).any()) and bool((fp["xb"] % rp.SLAB != 0).any())
    elif case == "axes12":
        assert set(tab[live, 1].tolist()) == {1, 2}
    elif case == "inside":
        plain = rp.plane_sweep_rows_plain(tab, ch, tables.vols, EPS, K8_EDGE_T_MAX)
        assert bool(((plain[3] & 1) > 0).any() or (plain[0] == ch[:, 6]).any())
    else:
        assert 3.0 < float(ch[live, 1].abs().max()) <= rp.SLOPE_CAP
        assert int((fp["y1"] - fp["y0"]).max()) > rp.SLAB


def row_order(n_act):
    """K8's row order as ``row_order_kernel`` computes it: a counting sort
    of the slot counts into 256 buckets, most slots first (counts from 255
    up share the first bucket); within a bucket the kernel's atomics decide,
    here the table's order."""
    bucket = 255 - np.clip(n_act, 0, 255)
    start = np.concatenate([[0], np.cumsum(np.bincount(bucket, minlength=256))[:-1]])
    order = np.empty(len(n_act), np.int64)
    for i, b in enumerate(bucket):
        order[start[b]] = i
        start[b] += 1
    return order


@pytest.mark.parametrize("case", ["edge cases", "counts past the buckets"])
def test_row_order_is_a_permutation_most_slots_first(case, edge_cases):
    """Every row is launched once, rows with more slots (up to 255) first."""
    if case == "edge cases":
        n_act = np.concatenate([t.tab[:, 0].numpy() for t, _ in edge_cases.values()])
    else:
        n_act = np.random.default_rng(0).choice([0, 1, 7, 254, 255, 256, 4000], 3000)
    order = row_order(n_act)
    assert np.array_equal(np.sort(order), np.arange(len(n_act)))
    assert (np.diff(np.minimum(n_act[order], 255)) <= 0).all()
