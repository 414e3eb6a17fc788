"""2-D image SDF (counterpart of ``sdf_tools_tpu/ops/image_sdf.py``).

The reference's ``image_2d_sdf_node`` (image_2d_sdf_node.cpp): a binary
image gives the distance to the filled pixels, the distance to the free
pixels (in pixels, no resolution scaling, :100-117), their signed
combination, and a false-colour preview (:228-308). The distances are the
exact EDT, not the node's approximate 8SSEDT.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..grid import as_tensor_on
from . import edt


def image_sdf(image, threshold: float = 0.5, *, device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """image [h, w] (> threshold = filled) -> (signed, d_plus, d_minus), each
    [h, w] f32 in pixels: d_plus the distance to the nearest filled pixel,
    d_minus to the nearest free one, signed = d_plus - d_minus. A tensor
    stays on its device; numpy input goes to ``device``.

    Both squared fields come from one ``squared_edt_both`` (K1 -> K2 along
    axis 1 -> K2 along axis 2 on the card); every exact backend gives the
    same int32 d^2, so this equals the JAX package's two stencil EDTs."""
    img = as_tensor_on(image, device)
    filled = (img > threshold)[:, :, None]
    d2_filled, d2_free = edt.squared_edt_both(filled, "auto")
    d_plus = edt.d2_to_distance(d2_filled, 1.0)[:, :, 0]
    d_minus = edt.d2_to_distance(d2_free, 1.0)[:, :, 0]
    return d_plus - d_minus, d_plus, d_minus


def false_color_preview(signed) -> np.ndarray:
    """uint8 [h, w, 3] preview: blue outside scaled by distance, red inside,
    white at the zero crossing (image_2d_sdf_node.cpp:228-308 styling)."""
    s = signed.detach().cpu().numpy() if isinstance(signed, torch.Tensor) else np.asarray(signed)
    finite = np.isfinite(s)
    vmax = max(float(s[finite & (s > 0)].max(initial=1e-6)), 1e-6)
    vmin = min(float(s[finite & (s < 0)].min(initial=-1e-6)), -1e-6)
    out = np.zeros(s.shape + (3,), np.float32)
    pos = s > 0
    neg = s < 0
    out[pos, 2] = 0.2 + 0.8 * (s[pos] / vmax)
    out[neg, 0] = 0.2 + 0.8 * (s[neg] / vmin)
    out[~pos & ~neg] = 1.0
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
