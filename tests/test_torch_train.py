"""One step of the training path against the JAX package, on the CPU:
``examples/carve_occupancy.py``'s step (24^3 grid, four cameras of 20x20
rays, logits -> sigmoid -> signed field -> sphere-traced depth -> L2 loss)
through the port and through JAX ``backend="pallas"``.

The JAX step is chained by hand from ``jax.vjp`` pieces so that its march
runs eagerly (``jax.disable_jit()``; the port follows the eager op
sequence, tests/test_torch_render.py) while its EDT kernels run jitted in
interpret mode.

Tolerances: the loss within rtol 1e-5. With the straight-through surrogate
the logits gradient within rtol 1e-5 (atol 1e-5 * max|grad|). With the FT
surrogate, whose routing may differ at tied features, the total logits
gradient within rtol 1e-4 of JAX's and the gradient within rtol 1e-4,
atol 1e-5 * max|grad| on cells that receive no cotangent from a cell with
tied nearest opposite-side cells.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, SdfGrid as JaxSdfGrid, make_origin_transform as jax_origin
from sdf_tools_tpu.ops import diff as jdiff, render as jrender
from sdf_tools_tpu_torch import GridMeta, SdfGrid, make_origin_transform, render_depth
from sdf_tools_tpu_torch.ops import diff, render
from test_torch_diff import _tied_features

N, RES, T_MAX, MAX_STEPS = 24, 0.1, 10.0, 48


def _cameras():
    center = np.full(3, 0.5 * N * RES)
    cams = [
        center - np.array([1.5 * N * RES, 0.0, 0.0]),
        center + np.array([1.5 * N * RES, 0.0, 0.0]),
        center - np.array([0.0, 1.5 * N * RES, 0.0]),
        center + np.array([0.0, 0.3, 1.5 * N * RES]),
    ]
    ups = [[0.0, 0.0, 1.0] if abs(c[2] - center[2]) < 1 else [0.0, 1.0, 0.0] for c in cams]
    return center, cams, ups


def _scene():
    ii = np.arange(N)
    d2 = ((ii[:, None, None] - (N - 1) / 2) ** 2 + (ii[None, :, None] - (N - 1) / 2) ** 2
          + (ii[None, None, :] - (N - 1) / 2) ** 2)
    occ_true = (d2 <= (0.7 / RES) ** 2).astype(np.float32)
    logits = np.full((N, N, N), -3.0, np.float32)
    logits[6:18, 6:18, 6:18] = 3.0
    return occ_true, logits


def _jax_render_all(values):
    meta = JaxGridMeta.create(jax_origin([0.0, 0.0, 0.0]), RES, (N, N, N))
    center, cams, ups = _cameras()
    sdf = JaxSdfGrid.create(values, meta, oob_value=1e3)
    out = []
    for c, u in zip(cams, ups):
        o, d = jrender.camera_rays(
            jnp.asarray(c, jnp.float32), jnp.asarray(center, jnp.float32), jnp.asarray(u), 40.0, 20, 20
        )
        r = jrender.render_depth(sdf, o, d, t_max=T_MAX, max_steps=MAX_STEPS)
        out.append(jnp.where(r.hit, r.depth, T_MAX))
    return out


@pytest.fixture(scope="module")
def jax_targets():
    """The depth images of the true sphere (the same for both surrogates,
    whose forwards are the same field)."""
    occ_true, _ = _scene()
    values = jdiff.sdf_from_occupancy_st(jnp.asarray(occ_true), jnp.float32(RES), "pallas")
    with jax.disable_jit():
        return _jax_render_all(values)


def _jax_step(logits, targets, surrogate):
    sdf_fn = jdiff.sdf_from_occupancy_ft if surrogate == "ft" else jdiff.sdf_from_occupancy_st
    occ, vjp_sig = jax.vjp(jax.nn.sigmoid, jnp.asarray(logits))
    values, vjp_sdf = jax.vjp(lambda o: sdf_fn(o, jnp.float32(RES), "pallas"), occ)
    render_all = _jax_render_all
    with jax.disable_jit():
        loss, vjp_render = jax.vjp(
            lambda v: sum(jnp.mean((p - t) ** 2) for p, t in zip(render_all(v), targets)), values
        )
        (g_values,) = vjp_render(jnp.float32(1.0))
    (g_occ,) = vjp_sdf(g_values)
    (g_logits,) = vjp_sig(g_occ)
    return float(loss), np.asarray(g_logits), np.asarray(g_values)


def _port_step(logits, occ_true, surrogate):
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0], device="cpu"), RES, (N, N, N), device="cpu")
    center, cams, ups = _cameras()
    rays = [render.camera_rays(c, center, u, 40.0, 20, 20, device="cpu") for c, u in zip(cams, ups)]
    sdf_fn = diff.sdf_from_occupancy_ft if surrogate == "ft" else diff.sdf_from_occupancy_st

    def render_all(values):
        sdf = SdfGrid.create(values, meta, oob_value=1e3)
        outs = [render_depth(sdf, o, d, t_max=T_MAX, max_steps=MAX_STEPS) for o, d in rays]
        return [torch.where(r.hit, r.depth, T_MAX) for r in outs]

    targets = render_all(sdf_fn(torch.tensor(occ_true), RES))
    lg = torch.tensor(logits, requires_grad=True)
    values = sdf_fn(torch.sigmoid(lg), RES)
    values.retain_grad()
    loss = sum(torch.mean((p - t) ** 2) for p, t in zip(render_all(values), targets))
    loss.backward()
    return float(loss.detach()), lg.grad.numpy(), values.grad.numpy()


@pytest.mark.parametrize("surrogate", ["st", "ft"])
def test_carve_step_matches_jax(surrogate, jax_targets):
    occ_true, logits = _scene()
    jloss, jgrad, jg_values = _jax_step(logits, jax_targets, surrogate)
    loss, grad, g_values = _port_step(logits, occ_true, surrogate)
    assert np.isfinite(loss) and loss > 0 and np.isfinite(grad).all() and (grad != 0).any()
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(g_values, jg_values, rtol=1e-5, atol=1e-5 * np.abs(jg_values).max())
    atol = 1e-5 * np.abs(jgrad).max()
    if surrogate == "st":
        np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=atol)
        return
    np.testing.assert_allclose(grad.sum(), jgrad.sum(), rtol=1e-4)
    # cells that may receive a cotangent routed differently at a tie: the
    # cotangent's source has tied features, so its target is one of them
    mask = logits > 0
    tied = _tied_features(mask) & (g_values != 0)
    targets = np.zeros(mask.shape, bool)
    cells = np.argwhere(np.ones(mask.shape, bool))
    for src in np.argwhere(tied):
        d2 = ((cells - src) ** 2).sum(-1).reshape(mask.shape)
        d2 = np.where(mask != mask[tuple(src)], d2, np.iinfo(np.int64).max)
        targets |= d2 == d2.min()
    assert targets.sum() < 0.5 * (grad != 0).sum()
    np.testing.assert_allclose(grad[~targets], jgrad[~targets], rtol=1e-4, atol=atol)
