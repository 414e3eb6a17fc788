"""Plain PyTorch reference of the occupancy training step (BASELINE config
#4's pixel gradients with respect to occupancy):

    logits -> sigmoid -> occupancy > 0.5 -> the exact signed field ->
    sphere-traced depth of one view -> mean squared error to a target depth
    -> gradient -> SGD

The field's gradient with respect to occupancy is the feature-transform
surrogate: each cell's cotangent, times -2 resolution, goes to its nearest
cell on the other side (a free cell to its nearest filled cell, a filled
cell to its nearest free cell). The depth's gradient with respect to the
field is the implicit function theorem's at the hit point: dt/dvalues =
-(dF/dvalues) / (dF/dt) with F the trilinear distance along the ray;
missed rays give none. ``dtype`` runs every float of the step in another
precision: the control.
"""
from __future__ import annotations

import torch

from . import edt as ref_edt
from . import march as ref_march
from . import query as ref_query


def stencil(values, res, p):
    """(flat corner indices [P, 8], weights [P, 8], grid-frame gradient of the
    interpolated distance [P, 3], in_bounds [P]) at points p [P, 3]."""
    shape = values.shape
    idx = [ref_march._cell(p[:, a] / res) for a in range(3)]
    ok = torch.isfinite(p).all(dim=-1)
    for a in range(3):
        ok &= (idx[a] >= 0) & (idx[a] < shape[a])
    lo, up = [], []
    for a in range(3):
        safe = idx[a].clamp(0, shape[a] - 1)
        l_, u_ = ref_query._corners(safe, shape[a], p[:, a] - (safe.to(p.dtype) + 0.5) * res)
        lo.append(l_)
        up.append(u_)
    flat = values.reshape(-1)
    half = res * 0.5
    w = [(p[:, a] - (lo[a].to(p.dtype) + 0.5) * res) / res for a in range(3)]
    wx, wy, wz = ((1.0 - w[a], w[a]) for a in range(3))
    idx8, w8 = [], []
    grad = torch.zeros(p.shape, dtype=p.dtype, device=p.device)
    for i, cx in enumerate((lo[0], up[0])):
        for j, cy in enumerate((lo[1], up[1])):
            for k, cz in enumerate((lo[2], up[2])):
                f = (cx * shape[1] + cy) * shape[2] + cz
                v = flat[f]
                c = torch.where(v >= 0.0, v - half, v + half)
                idx8.append(f)
                w8.append(wx[i] * wy[j] * wz[k])
                grad[:, 0] += (1.0 if i else -1.0) * wy[j] * wz[k] * c
                grad[:, 1] += wx[i] * (1.0 if j else -1.0) * wz[k] * c
                grad[:, 2] += wx[i] * wy[j] * (1.0 if k else -1.0) * c
    return torch.stack(idx8, -1), torch.stack(w8, -1), grad / res, ok


def ift_backward(values, res, o, v, depth, hit, g_depth):
    """d loss / d values from the depth cotangent ``g_depth`` [P]."""
    p = o + depth[:, None] * v
    idx8, w8, n, ok = stencil(values, res, p)
    dfdt = (n * v).sum(dim=-1)
    safe = torch.where(dfdt.abs() > 1e-6, dfdt, torch.where(dfdt >= 0, 1e-6, -1e-6).to(dfdt.dtype))
    scale = torch.where(hit & ok, -g_depth / safe, 0.0)
    d = torch.zeros(values.numel(), dtype=values.dtype, device=values.device)
    d.index_add_(0, idx8.reshape(-1), (w8 * scale[:, None]).reshape(-1))
    return d.reshape(values.shape)


class Field:
    """The signed field of ``mask`` with both feature transforms."""

    def __init__(self, mask, res: float, dtype, block_elems=ref_edt.BLOCK_ELEMS):
        self.mask = mask
        d2_f, self.feat_f = ref_edt.feature_transform(mask, block_elems)  # nearest filled cell
        d2_g, self.feat_g = ref_edt.feature_transform(~mask, block_elems)  # nearest free cell
        self.values = ref_edt.distance(d2_f, res, dtype) - ref_edt.distance(d2_g, res, dtype)

    def backward(self, g, res):
        """d loss / d occupancy from the field's cotangent ``g``."""
        slope = (g * (-2.0 * torch.tensor(res, dtype=torch.float32).to(g.dtype))).reshape(-1)
        out = torch.zeros_like(slope)
        free = (~self.mask).reshape(-1) & (self.feat_f.reshape(-1) >= 0)
        filled = self.mask.reshape(-1) & (self.feat_g.reshape(-1) >= 0)
        out.index_add_(0, self.feat_f.reshape(-1)[free], slope[free])
        out.index_add_(0, self.feat_g.reshape(-1)[filled], slope[filled])
        return out.reshape(g.shape)


def step(logits, target, o, v, res: float, oob: float, kw: dict, lr: float, dtype=torch.float32,
         block_elems=ref_edt.BLOCK_ELEMS, ray_block: int = 1 << 20):
    """One SGD step: (loss, gradient with respect to the logits, new logits),
    all in ``dtype``. ``o``, ``v``: one view's rays [h, w, 3]; ``target``
    [h, w]."""
    lg = logits.to(dtype)
    sig = torch.sigmoid(lg)
    field = Field(sig > 0.5, res, dtype, block_elems)
    of, vf = o.reshape(-1, 3).to(dtype), v.reshape(-1, 3).to(dtype)
    depth, hit = ref_march.march_blocks(field.values, res, oob, of, vf, kw | {"t_min": 0.0}, ray_block, dtype)
    depth = depth.to(dtype)
    diff = depth - target.reshape(-1).to(dtype)
    loss = (diff * diff).mean()
    g_depth = 2.0 * diff / diff.numel()
    res_t = torch.tensor(res, dtype=torch.float32, device=o.device).to(dtype)
    g_values = ift_backward(field.values, res_t, of, vf, depth, hit, g_depth)
    g_occ = field.backward(g_values, res)
    grad = g_occ * (1.0 - sig) * sig
    return loss, grad, lg - lr * grad
