"""The port's distillation losses and ``prepare_targets`` against the JAX package.

Tolerance: float32 atol 1e-6 and rtol 1e-6 (the same float32 reductions in
another order, over at most a few thousand elements a sample here: a few
ulps of values up to ~2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.models import losses as jlosses
from theia_tpu.train.step import prepare_targets as jprepare
from theia_tpu_torch.models import losses as tlosses
from theia_tpu_torch.train.step import prepare_targets

SIZES = {"a": (2, 16, 24), "b": (2, 64, 12), "c_cls": (2, 24)}


def _features(seed):
    rng = np.random.default_rng(seed)
    return {t: rng.standard_normal(s).astype(np.float32) for t, s in SIZES.items()}


@pytest.mark.parametrize("fn", ["mse_loss", "smooth_l1_loss", "cosine_loss"])
def test_loss_terms_match_jax(fn):
    p, t = _features(0)["b"], _features(1)["b"] * 0.5
    p[0, 0, :3] = t[0, 0, :3] + np.array([0.2, -3.0, 1.0], np.float32)  # both sides of SmoothL1's beta
    want = float(getattr(jlosses, fn)(jnp.asarray(p), jnp.asarray(t)))
    got = getattr(tlosses, fn)(torch.from_numpy(p), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, atol=1e-6, rtol=1e-6)


def test_cosine_loss_zero_vector_is_finite():
    z = np.zeros((2, 8), np.float32)
    t = np.ones((2, 8), np.float32)
    want = float(jlosses.cosine_loss(jnp.asarray(z), jnp.asarray(t)))
    np.testing.assert_allclose(float(tlosses.cosine_loss(torch.from_numpy(z), torch.from_numpy(t))), want, atol=1e-6)


@pytest.mark.parametrize(
    "weights, masks",
    [
        (None, None),
        ({"a": 0.5, "b": 0.3, "c_cls": 0.2}, None),
        (0.25, None),
        (None, {"a": 1.0, "b": 0.0, "c_cls": 1.0}),
        ({"a": 0.5, "b": 0.3, "c_cls": 0.2}, {"a": 0.0, "b": 1.0, "c_cls": 0.0}),
        (None, {"a": 0.0, "b": 0.0, "c_cls": 0.0}),  # n_active clamps to 1
    ],
)
@pytest.mark.parametrize("main_loss", ["cos_l1", "mse"])
def test_get_loss_matches_jax(weights, masks, main_loss):
    preds, targets = _features(2), _features(3)
    jm = None if masks is None else {k: jnp.asarray(v) for k, v in masks.items()}
    want = jlosses.get_loss({k: jnp.asarray(v) for k, v in preds.items()},
                            {k: jnp.asarray(v) for k, v in targets.items()}, weights, jm)
    tm = None if masks is None else {k: torch.tensor(v) for k, v in masks.items()}
    got = tlosses.get_loss({k: torch.from_numpy(v) for k, v in preds.items()},
                           {k: torch.from_numpy(v) for k, v in targets.items()}, weights, tm)
    for k in ("mse_loss", "cos_loss", "l1_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6, rtol=1e-6, err_msg=k)
    for k in ("mse_losses_per_model", "cos_losses_per_model", "l1_losses_per_model"):
        for t in SIZES:
            np.testing.assert_allclose(float(got[k][t]), float(want[k][t]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.main_loss_from_terms(got, main_loss)),
                               float(jlosses.main_loss_from_terms(want, main_loss)), atol=1e-6, rtol=1e-6)


def test_bf16_loss_dtype_matches_jax():
    preds, targets = _features(4), _features(5)
    want = jlosses.get_loss({k: jnp.asarray(v) for k, v in preds.items()},
                            {k: jnp.asarray(v) for k, v in targets.items()}, compute_dtype=jnp.bfloat16)
    got = tlosses.get_loss({k: torch.from_numpy(v) for k, v in preds.items()},
                           {k: torch.from_numpy(v) for k, v in targets.items()}, compute_dtype=torch.bfloat16)
    for k in ("mse_loss", "cos_loss", "l1_loss"):  # bf16 elementwise: bf16's 2^-8 relative
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-2, err_msg=k)


def test_unknown_main_loss_raises():
    with pytest.raises(NotImplementedError):
        tlosses.main_loss_from_terms({}, "l2")


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_targets_matches_jax(with_stats, dtype):
    rng = np.random.default_rng(7)
    raw = {"a": rng.standard_normal((2, 24, 4, 4)).astype(np.float32),  # raw [B, C, H, W]
           "b": rng.standard_normal((2, 16, 12)).astype(np.float32)}  # already [B, HW, C]
    stats = None
    if with_stats:
        stats = {"a": (rng.standard_normal(24).astype(np.float32), (1 + rng.random(24)).astype(np.float32)),
                 "b": (None, None)}
    want = jprepare({k: jnp.asarray(v) for k, v in raw.items()}, stats, dtype=getattr(jnp, dtype))
    got = prepare_targets({k: torch.from_numpy(v) for k, v in raw.items()}, stats, dtype=getattr(torch, dtype))
    for k in raw:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == getattr(torch, dtype)
        tol = 1e-6 if dtype == "float32" else 2 ** -7  # bf16 (x - mean) / std rounds twice
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32), atol=tol, rtol=tol)
