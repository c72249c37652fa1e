"""DINOv2-style PCA visualisation of predicted features (port of
theia_tpu/decoding/dinov2.py:9-62; reference: src/theia/decoding/dinov2.py:12-69),
without sklearn: the fit, the projection and the per-channel min-max run
in torch on the features' device."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from theia_tpu_torch.ops.image import bicubic_resize


class PCA:
    """Exact PCA: the centred data's SVD (in float64), sklearn's ``svd_flip``
    sign rule (``u_based_decision=False``: each component's entry of largest
    magnitude is positive), ``components_`` and ``mean_`` in float32, as
    sklearn's ``PCA(svd_solver="full")`` fits float32 data."""

    def __init__(self, n_components: int = 3) -> None:
        self.n_components = n_components

    def fit(self, x: torch.Tensor) -> "PCA":
        mean = x.double().mean(dim=0)
        _, _, vt = torch.linalg.svd(x.double() - mean, full_matrices=False)
        vt = vt[: self.n_components]
        signs = torch.sign(vt.gather(1, vt.abs().argmax(dim=1, keepdim=True)))
        self.mean_, self.components_ = mean.float(), (vt * signs).float()
        return self

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean_.to(x.device)) @ self.components_.to(x.device).T


def _project(pca: Any, x: torch.Tensor) -> torch.Tensor:
    """The port's PCA on the device; any other fitted object with a
    ``transform`` (sklearn's) through its own method on the host."""
    if isinstance(pca, PCA):
        return pca.transform(x)
    return torch.as_tensor(np.asarray(pca.transform(x.cpu().numpy()), np.float32), device=x.device)


def _minmax_columns(x: torch.Tensor) -> torch.Tensor:
    """sklearn ``minmax_scale`` of each column, (x - min) / (max - min), a
    range under 10 float32 eps taken as 1. sklearn computes it as
    x * scale + (-min * scale), which can round above 1: by an ulp, more
    where a column's offset dwarfs its spread. Here the difference stays in
    [0, max - min] and the quotient in [0, 1]."""
    lo, hi = x.amin(dim=0), x.amax(dim=0)
    span = hi - lo
    span = torch.where(span < 10 * torch.finfo(x.dtype).eps, torch.ones_like(span), span)
    return (x - lo) / span


def decode_dinov2(
    features: Any,
    threshold: float = -100,
    interpolation: bool = False,
    pca: Any = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, Any]:
    """PCA(3) over tokens -> fg/bg split on the first component -> per-channel
    min-max -> upsample to 224² (nearest blocks, or bilinear with
    ``interpolation``), on ``device``.

    ``pca``: a fitted PCA to reuse across samples, the port's own or any
    object with ``transform`` (a fitted sklearn PCA). Without one, the port
    fits its exact PCA. The JAX function's default ``PCA(3)`` lets sklearn
    pick its solver, which for B·256 × 1024 features is the randomized one:
    its components depend on a random state, so the port fits exactly
    instead, which equals sklearn's ``svd_solver="full"`` fit.

    Returns (images [B, 224, 224, 3] float32 in [0, 1], the PCA).
    """
    feats = torch.as_tensor(features, device=device).float()
    b, n, c = feats.shape
    h = w = int(n ** 0.5)
    flat = feats.reshape(-1, c)
    if pca is None:
        pca = PCA(3).fit(flat)
    comps = _project(pca, flat)
    fg = ~(comps[:, 0] < threshold)
    rgb = torch.zeros_like(comps)
    if bool(fg.any()):
        rgb[fg] = _minmax_columns(_project(pca, flat[fg]))
    rgb = rgb.reshape(b, h, w, 3)

    out_size = 224
    if not interpolation:
        scale = out_size // h
        rgb = rgb.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
        if rgb.shape[1] != out_size:  # not divisible: repeat the edge
            pad = out_size - rgb.shape[1]
            rgb = torch.cat([rgb, rgb[:, -1:].expand(-1, pad, -1, -1)], dim=1)
            rgb = torch.cat([rgb, rgb[:, :, -1:].expand(-1, -1, pad, -1)], dim=2)
    else:
        rgb = bicubic_resize(rgb, out_size, out_size, kernel="linear")
    return rgb.cpu().numpy(), pca
