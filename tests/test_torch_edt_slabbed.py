"""The port's routes for volumes near or beyond device memory
(``signed_field_lowmem``, ``squared_edt_slabbed``, ``signed_field_slabbed``)
against the JAX package, and the slice as a whole, on the CPU.

Backends: the port's ``"auto"`` against JAX ``"pallas"`` (interpret mode),
and ``"stencil"`` against ``"stencil"``. Fields bitwise (int32 equal, f32 as
uint32 bit patterns). The slice at 32^3 (a ``make_scene``-style mask ->
slab build of the signed field into one buffer -> a 32x32 render) against
the same sequence in JAX with its march run eagerly: the field bitwise, the
render within ``tests/test_torch_render.py``'s march tolerances.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bench import make_scene
from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, SdfGrid as JaxSdfGrid, make_origin_transform as jax_origin
from sdf_tools_tpu.ops import edt as jedt, render as jrender
from sdf_tools_tpu_torch import GridMeta, SdfGrid, make_origin_transform
from sdf_tools_tpu_torch.ops import edt, render
from test_torch_render import assert_march_agrees

RES = 0.05
# port backend -> JAX backend
BACKENDS = {"auto": "pallas", "stencil": "stencil"}


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.fixture(scope="module")
def mask():
    m = np.random.default_rng(12).random((16, 12, 8)) < 0.15
    m[0, 0, 0] = True
    m[4:8, 2, :] = False  # seedless across two slabs of four
    return m


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_signed_field_lowmem_matches_jax(mask, backend):
    want = np.asarray(jedt.signed_field_lowmem(jnp.asarray(mask), RES, BACKENDS[backend]))
    got = edt.signed_field_lowmem(mask, RES, backend, device="cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n_slabs", [1, 2, 4])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_squared_edt_slabbed_matches_jax(mask, backend, n_slabs):
    for m in (mask, ~mask):
        want = [np.asarray(s) for s in jedt.squared_edt_slabbed(jnp.asarray(m), n_slabs, BACKENDS[backend])]
        got = list(edt.squared_edt_slabbed(torch.as_tensor(m), n_slabs, backend))
        assert len(got) == len(want) == n_slabs
        for g, w in zip(got, want):
            assert g.shape == (m.shape[0] // n_slabs,) + m.shape[1:]
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n_slabs", [1, 2, 4])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_signed_field_slabbed_matches_jax(mask, backend, n_slabs):
    want = jedt.signed_field_slabbed(mask, RES, n_slabs=n_slabs, backend=BACKENDS[backend])
    got = edt.signed_field_slabbed(mask, RES, n_slabs=n_slabs, backend=backend, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    fused, _, _ = edt.signed_field_from_masks(torch.as_tensor(mask), RES)
    np.testing.assert_array_equal(_bits(got), _bits(fused.numpy()))


def test_slabbed_rejects_non_divisible_slab_count():
    m = np.zeros((10, 8, 8), bool)
    m[0, 0, 0] = True
    with pytest.raises(ValueError, match="divisible"):
        list(edt.squared_edt_slabbed(m, n_slabs=3, device="cpu"))
    with pytest.raises(ValueError, match="divisible"):
        edt.signed_field_slabbed(m, RES, n_slabs=3, device="cpu")


def test_slice_32_slab_build_and_render():
    """bench_render_1024.py's sequence at 32^3: slab-built signed field in
    one buffer, then a render from the bench camera."""
    n, n_slabs, hw = 32, 4, (32, 32)
    m = make_scene(n)
    sl = n // n_slabs
    jm = jnp.asarray(m)
    jvals = jnp.zeros((n, n, n), jnp.float32)
    for i, (a, b) in enumerate(zip(jedt.squared_edt_slabbed(jm, n_slabs, "pallas"),
                                   jedt.squared_edt_slabbed(~jm, n_slabs, "pallas"))):
        v = jedt.d2_to_distance(a, RES) - jedt.d2_to_distance(b, RES)
        jvals = jax.lax.dynamic_update_slice(jvals, v, (i * sl, 0, 0))
    t = torch.as_tensor(m)
    vals = torch.empty((n, n, n), dtype=torch.float32)
    for i, (a, b) in enumerate(zip(edt.squared_edt_slabbed(t, n_slabs), edt.squared_edt_slabbed(~t, n_slabs))):
        vals[i * sl : (i + 1) * sl] = edt.d2_to_distance(a, RES) - edt.d2_to_distance(b, RES)
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(np.asarray(jvals)))

    center = np.full(3, 0.5 * n * RES)
    cam = center + np.array([-1.2 * n * RES, 0.0, 0.4 * n * RES])
    kw = dict(t_max=4.0 * n * RES, max_steps=96)
    jmeta = JaxGridMeta.create(jax_origin([0.0, 0.0, 0.0]), RES, (n, n, n))
    jsdf = JaxSdfGrid(values=jvals, meta=jmeta, oob_value=jnp.float32(1e3))
    with jax.disable_jit():
        jo, jd = jrender.camera_rays(jnp.asarray(cam, jnp.float32), jnp.asarray(center, jnp.float32),
                                     jnp.asarray([0.0, 0.0, 1.0]), 50.0, *hw)
        jr = jrender.render_depth(jsdf, jo, jd, **kw)
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0], device="cpu"), RES, (n, n, n), device="cpu")
    o, d = render.camera_rays(cam, center, (0.0, 0.0, 1.0), 50.0, *hw, device="cpu")
    r = render.render_depth(SdfGrid.create(vals, meta, 1e3), o, d, **kw)
    assert r.depth.shape == hw and 0 < int(r.hit.sum()) < r.hit.numel()
    assert_march_agrees(r.hit.numpy(), r.depth.numpy(), np.asarray(jr.hit), np.asarray(jr.depth))
