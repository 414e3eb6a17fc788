"""The signed field in every dtype, and numpy masks with ``device=``, on the
CPU against the JAX package.

``d2_to_distance``, ``signed_field_from_masks`` and
``signed_field_virtual_border`` in float64, bfloat16 and float16 against the
JAX functions of the same dtype (float64 under ``jax.enable_x64``, which is
off again after each call), ``make_origin_transform`` in float64, and the
float64 and float32 roots against numpy's. Tolerance everywhere: bitwise
(fields and extrema compared as bit patterns). The float32 fields are held
to JAX by ``test_torch_edt.py``; the card's dtype routes to the plain path
by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_tools_tpu import grid as jgrid
from sdf_tools_tpu.ops import edt as jedt
from sdf_tools_tpu_torch import grid
from sdf_tools_tpu_torch.ops import edt
from tools.sqrt_midpoints import least_margin

RES = 0.05
DTYPES = {
    "float64": (torch.float64, jnp.float64),
    "bfloat16": (torch.bfloat16, jnp.bfloat16),
    "float16": (torch.float16, jnp.float16),
}
MASKS = {
    "random": ((20, 24, 28), 0.15),
    "dense": ((5, 7, 9), 0.6),
    "empty": ((8, 9, 10), 0.0),
    "full": ((8, 9, 10), 1.0),
    # distances of up to 299 cells: d^2 past float16's largest finite value
    "long": ((1, 3, 300), 0.002),
}


def _mask(name):
    shape, p = MASKS[name]
    m = np.random.default_rng(sum(shape)).random(shape) < p
    if name == "long":
        m[0, 0, 0] = True
    return m


def _bits(x):
    """The bit pattern of a JAX or numpy array, or of a torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[x.element_size()]).numpy()
    x = np.asarray(x)
    return x.view({8: np.int64, 4: np.int32, 2: np.int16}[x.dtype.itemsize])


def _jax(fn, dtype_name):
    """A JAX call in the dtype's precision, its outputs as numpy arrays."""
    with jax.enable_x64(dtype_name == "float64"):
        out = fn()
        return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _assert_same_bits(got, want):
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _d2_values():
    """Integers 0 ... 3 * 32^2, squares past float16's range, values just
    below INF_D2, and INF_D2 itself."""
    rng = np.random.default_rng(7)
    v = np.concatenate([
        np.arange(3 * 32 * 32 + 1), np.arange(250, 300) ** 2, rng.integers(0, edt.INF_D2, 4000),
        edt.INF_D2 - np.arange(1, 9),
    ])
    return np.pad(v, (0, 8 + -len(v) % 8), constant_values=edt.INF_D2).astype(np.int32)


@pytest.mark.parametrize("resolution", [RES, "vector"], ids=["scalar", "vector"])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_d2_to_distance_matches_jax(dtype_name, resolution):
    tdt, jdt = DTYPES[dtype_name]
    d2 = _d2_values().reshape(-1, 8)
    if resolution == "vector":
        resolution = np.linspace(0.01, 0.3, 8).astype(np.float32)
    want = _jax(lambda: jedt.d2_to_distance(jnp.asarray(d2), resolution, jdt), dtype_name)
    _assert_same_bits(edt.d2_to_distance(torch.as_tensor(d2), resolution, tdt), want)


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("fn", ["signed_field_from_masks", "signed_field_virtual_border"])
def test_signed_field_matches_jax(fn, dtype_name, mask_name):
    """The field and both extrema, bitwise (+-inf for the empty and the
    full mask; float16's inf past its range on the long lines)."""
    tdt, jdt = DTYPES[dtype_name]
    m = _mask(mask_name)
    want = _jax(lambda: getattr(jedt, fn)(m, RES, "auto", jdt), dtype_name)
    got = getattr(edt, fn)(torch.as_tensor(m), RES, "auto", tdt)
    for g, w in zip(got, want):
        _assert_same_bits(g, w)
    if fn == "signed_field_from_masks" and mask_name in ("empty", "full"):
        assert torch.isinf(got[0]).all()
    if fn == "signed_field_from_masks" and mask_name == "long" and dtype_name == "float16":
        assert torch.isinf(got[0]).any() and torch.isfinite(got[0]).any()


@pytest.mark.parametrize("dtype_name", sorted(DTYPES) + ["float32"])
def test_signed_field_resolution_vector_matches_jax(dtype_name):
    """A resolution per z plane (the JAX package's unfused route, whatever
    the dtype)."""
    tdt, jdt = DTYPES.get(dtype_name, (torch.float32, jnp.float32))
    m = _mask("random")
    res = np.linspace(0.02, 0.09, m.shape[2]).astype(np.float32)
    want = _jax(lambda: jedt.signed_field_from_masks(m, res, "auto", jdt), dtype_name)
    got = edt.signed_field_from_masks(torch.as_tensor(m), res, "auto", tdt)
    for g, w in zip(got, want):
        _assert_same_bits(g, w)


@pytest.mark.parametrize("backend", ["plain", "stencil"])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_signed_field_backends_agree(dtype_name, backend):
    """Every backend gives the "auto" field in every dtype (the d^2 fields
    are exact)."""
    tdt, _ = DTYPES[dtype_name]
    m = torch.as_tensor(_mask("random"))
    want = edt.signed_field_from_masks(m, RES, "auto", tdt)
    got = edt.signed_field_from_masks(m, RES, backend, tdt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("rotation", [None, "rotated"])
def test_origin_transform_float64_matches_jax(rotation):
    c, s = np.cos(0.3), np.sin(0.3)
    rot = None if rotation is None else np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t = [0.1, -2.7, 1.0 / 3.0]
    want = _jax(lambda: jgrid.make_origin_transform(t, rot, jnp.float64), "float64")
    _assert_same_bits(grid.make_origin_transform(t, rot, torch.float64, device="cpu"), want)
    f32 = _jax(lambda: jgrid.make_origin_transform(t, rot), "float32")
    _assert_same_bits(grid.make_origin_transform(t, rot, device="cpu"), f32)


def test_float64_root_is_numpy():
    """The float64 root is the correctly rounded one (numpy's, and XLA's)
    for every integer 0 ... 3 * 64^2 and 10^5 seeded integers below INF_D2."""
    n = np.concatenate([np.arange(3 * 64 * 64 + 1), np.random.default_rng(3).integers(0, edt.INF_D2, 100_000)])
    got = edt.d2_to_distance(torch.as_tensor(n.astype(np.int32)), 1.0, torch.float64)
    np.testing.assert_array_equal(_bits(got), _bits(np.sqrt(n.astype(np.float64))))


def test_float32_root_is_numpy():
    """The float32 root (taken in float64, rounded once) is numpy's float32
    root for every integer 0 ... 3 * 1024^2, the largest d^2 of a 1024^3
    field, and so is its product with the resolution."""
    n = np.arange(3 * 1024 * 1024 + 1, dtype=np.int32)
    root = np.sqrt(n.astype(np.float32))
    np.testing.assert_array_equal(_bits(edt.d2_to_distance(torch.as_tensor(n), 1.0, torch.float32)), _bits(root))
    scaled = edt.d2_to_distance(torch.as_tensor(n), RES, torch.float32)
    np.testing.assert_array_equal(_bits(scaled), _bits(root * np.float32(RES)))


def test_float32_root_midpoint_margin():
    """The docstring's proof, counted: the root of every integer 1 ...
    3 * 1024^2 lies more than 4 float64 ulps from every float32 rounding
    midpoint, so a float64 root one ulp off still rounds right."""
    least, at = least_margin(1, 3 * 1024 * 1024 + 1)
    assert least > 4, (least, at)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float8_e4m3fn, torch.complex64], ids=str)
def test_other_dtypes_raise(dtype):
    m = torch.as_tensor(_mask("dense"))
    with pytest.raises(TypeError):
        edt.d2_to_distance(torch.zeros(3, dtype=torch.int32), RES, dtype)
    with pytest.raises(TypeError):
        edt.signed_field_from_masks(m, RES, "auto", dtype)
    with pytest.raises(TypeError):
        edt.signed_field_virtual_border(m, RES, "auto", dtype)


@pytest.mark.parametrize("dtype_name", ["float32"] + sorted(DTYPES))
@pytest.mark.parametrize("fn", ["squared_edt_both", "signed_field_from_masks", "signed_field_virtual_border"])
def test_numpy_mask_with_device(fn, dtype_name):
    """A numpy mask with ``device="cpu"`` gives the tensor call's outputs;
    without a device it raises, and a CUDA device without CUDA raises."""
    m = _mask("random")
    tdt = DTYPES.get(dtype_name, (torch.float32,))[0]
    extra = () if fn == "squared_edt_both" else (RES, "auto", tdt)
    call = getattr(edt, fn)
    got = call(m, *extra, device="cpu")
    want = call(torch.as_tensor(m), *extra)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    with pytest.raises(ValueError, match="device="):
        call(m, *extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(m, *extra, device="cuda")
