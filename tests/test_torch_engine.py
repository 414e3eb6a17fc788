"""The port's whole serving slice against the JAX package, on the CPU, and
the port's guards.

``sdf_tools_tpu_torch.SdfEngine(device="cpu")`` against
``sdf_tools_tpu.engine.SdfEngine(backend="pallas", render_backend="march")``
on make_scene(64). Tolerances: signed fields bitwise; query in-bounds masks
exact and distances within rtol=atol=1e-6; query gradients within
rtol=atol=1e-5; render hit masks agree on >= 99.5% of rays and common-hit
depths within 2e-3.

The JAX engine's render is run with jit disabled. Jitted, XLA fuses the
march's float steps and rounds them differently: on this scene the JAX
package's jitted march disagrees with its own eager march on about 1.6% of
the rays, and agrees less well with a dense reference march than the eager
one does. The port runs the eager op sequence, one PyTorch op per JAX op.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bench import make_scene
from sdf_tools_tpu.engine import SdfEngine as JaxSdfEngine
from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, make_origin_transform as jax_origin
from sdf_tools_tpu_torch import SdfEngine, convert, make_origin_transform
from test_torch_render import assert_march_agrees

REPO = pathlib.Path(__file__).resolve().parents[1]
N = 64
RES = 0.05
ENGINE_KW = dict(
    shape=(N, N, N), resolution=RES, image_hw=(64, 64), render_max_steps=64,
    render_t_max=4 * N * RES, oob_value=1e3,
)


@pytest.fixture(scope="module")
def engines():
    jax_engine = JaxSdfEngine(backend="pallas", render_backend="march", **ENGINE_KW)
    port = SdfEngine(device="cpu", **ENGINE_KW)
    mask = make_scene(N)
    return jax_engine, port, jax_engine.sdf_from_occupancy(mask), port.sdf_from_occupancy(mask)


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


def _queries(seed, n=10_000):
    return np.random.default_rng(seed).uniform(-0.2, N * RES + 0.2, (n, 3)).astype(np.float32)


def test_engine_sdf_from_occupancy(engines):
    _, _, jsdf, sdf = engines
    np.testing.assert_array_equal(_bits(sdf.values.numpy()), _bits(np.asarray(jsdf.values)))
    assert sdf.values.shape == (N, N, N) and float(sdf.oob_value) == 1e3


def test_engine_sdf_from_points(engines):
    jax_engine, port, _, _ = engines
    pts = np.random.default_rng(7).uniform(0.0, N * RES, (2000, 3)).astype(np.float32)
    want = jax_engine.sdf_from_points(pts)
    got = port.sdf_from_points(pts)
    np.testing.assert_array_equal(_bits(got.values.numpy()), _bits(np.asarray(want.values)))


def test_engine_query(engines):
    jax_engine, port, jsdf, sdf = engines
    q = _queries(8)
    jd, jok = jax_engine.query(jsdf, q)
    d, ok = port.query(sdf, q)
    assert 0 < ok.sum() < len(q)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


def test_engine_query_with_grad(engines):
    jax_engine, port, jsdf, sdf = engines
    q = _queries(9)
    jd, jg, jok = jax_engine.query_with_grad(jsdf, q)
    d, g, ok = port.query_with_grad(sdf, q)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    assert (g.numpy()[~ok.numpy()] == 0).all()


def test_engine_render(engines):
    jax_engine, port, jsdf, sdf = engines
    center = np.full(3, 0.5 * N * RES)
    cam = center + np.array([-1.2 * N * RES, 0.0, 0.4 * N * RES])
    with jax.disable_jit():
        jdepth, jhit = jax_engine.render(jsdf, cam, center)
    depth, hit = port.render(sdf, cam, center)
    assert depth.shape == hit.shape == (64, 64)
    assert_march_agrees(hit.numpy(), depth.numpy(), np.asarray(jhit), np.asarray(jdepth))


def test_engine_warmup():
    port = SdfEngine(shape=(32, 32, 32), resolution=0.1, device="cpu", image_hw=(8, 8))
    sdf = port.warmup(n_points=256, n_queries=64)
    assert sdf.values.shape == (32, 32, 32) and torch.isfinite(sdf.values).all()


def test_convert_round_trip_rotated():
    """A rotated, translated JAX GridMeta carried into the port gives the
    same frame transforms and cell indices, exactly, on 10^4 points."""
    a = np.deg2rad(35.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
    b = np.deg2rad(-20.0)
    rot = rot @ np.array([[1.0, 0.0, 0.0], [0.0, np.cos(b), -np.sin(b)], [0.0, np.sin(b), np.cos(b)]])
    jmeta = JaxGridMeta.create(jax_origin([0.4, -1.1, 0.25], rot), 0.03, (40, 50, 60))
    meta = convert.grid_meta_from_numpy(
        np.asarray(jmeta.origin_transform), np.asarray(jmeta.inv_origin_transform),
        np.asarray(jmeta.resolution), jmeta.shape, jmeta.frame, device="cpu",
    )
    assert meta.shape == jmeta.shape and meta.frame == jmeta.frame
    assert meta.resolution.dtype == torch.float32 and meta.resolution.ndim == 0
    assert meta.resolution_float == float(meta.resolution) == float(np.float32(0.03))
    np.testing.assert_array_equal(meta.inv_origin_transform.numpy(), np.asarray(jmeta.inv_origin_transform))
    pts = np.random.default_rng(10).uniform(-2.0, 3.0, (10_000, 3)).astype(np.float32)
    p = torch.tensor(pts)
    np.testing.assert_array_equal(
        _bits(meta.world_to_grid(p).numpy()), _bits(np.asarray(jmeta.world_to_grid(jnp.asarray(pts))))
    )
    np.testing.assert_array_equal(
        meta.location_to_index(p).numpy(), np.asarray(jmeta.location_to_index(jnp.asarray(pts)))
    )
    # the port's own GridMeta.create inverts the same way
    own = type(meta).create(
        make_origin_transform([0.4, -1.1, 0.25], rot, device="cpu"), 0.03, (40, 50, 60), device="cpu"
    )
    np.testing.assert_array_equal(_bits(own.inv_origin_transform.numpy()), _bits(np.asarray(jmeta.inv_origin_transform)))
    assert own.resolution_float == meta.resolution_float


def test_import_does_not_load_jax():
    """Importing the port and running its native reference backend loads
    neither jax nor the JAX package."""
    code = (
        "import sys, torch, sdf_tools_tpu_torch\n"
        "from sdf_tools_tpu_torch import native, squared_edt\n"
        "if native.available():\n"
        "    squared_edt(torch.ones((3, 4, 5), dtype=torch.bool), 'reference')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sdf_tools_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def _port_files():
    return sorted((REPO / "sdf_tools_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """No file of the port (nor chip_smoke.py) imports jax or the JAX package."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "sdf_tools_tpu"), f"{path}: imports {name}"


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the guard is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        SdfEngine(device="cuda", **ENGINE_KW)
