"""The port's fused distillation loss (``ops/fused_loss.py``, K5/K6) against the JAX package.

Tolerances:
  - the five sums against ``loss_sums_reference`` and against the Pallas
    kernels run in interpret mode: rtol 1e-5 (float32 sums in another order
    over at most a few thousand elements a sample; a bf16 input converts to
    float32 exactly in both);
  - d pred through ``LossSums`` against ``jax.grad`` through
    ``loss_sums_reference``: atol 1e-6, the bound of tests/test_fused_loss.py
    (gradients ~1e-4 here);
  - ``get_loss(fused=True)`` against the JAX ``get_loss(fused=False)``:
    float32 atol and rtol 1e-6, as tests/test_torch_losses.py; bf16
    ``loss_dtype`` rtol 1e-2 (JAX rounds p − t and its square to bf16 in the
    unfused terms, the sums take them in float32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.models import losses as jlosses
from theia_tpu.ops import fused_loss as jfl
from theia_tpu_torch.models import losses as tlosses
from theia_tpu_torch.ops import fused_loss as tfl

# fused in both packages' rule (D >= 1024, D % 128 == 0): "a", "b"; not: "c_cls", "d"
SIZES = {"a": (2, 64, 24), "b": (2, 16, 128), "c_cls": (2, 24), "d": (2, 40, 30)}
TERMS = ("mse_loss", "cos_loss", "l1_loss")
PER_MODEL = ("mse_losses_per_model", "cos_losses_per_model", "l1_losses_per_model")


def _pair(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    t = (rng.standard_normal(shape) * scale).astype(np.float32)
    n = min(3, p.size)
    p.reshape(-1)[:n] = t.reshape(-1)[:n] + np.array([0.2, -3.0, 1.0], np.float32)[:n]  # both sides of beta
    return p, t


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("shape", [(3, 2048), (2, 1), (4, 127), (1, 4096)])
@pytest.mark.parametrize("pdt, tdt", [("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32")])
def test_loss_sums_plain_matches_jax_reference(shape, pdt, tdt):
    p, t = _pair(shape, seed=0)
    want = np.asarray(jfl.loss_sums_reference(_jax(p, DTYPES[pdt][0]), _jax(t, DTYPES[tdt][0])))
    got = tfl.loss_sums_plain(_torch(p, DTYPES[pdt][1]), _torch(t, DTYPES[tdt][1]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0], 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _pallas_interpret(p, t, g, beta=1.0):
    """The JAX package's Pallas kernels ``_fwd_kernel`` and ``_bwd_kernel``
    in interpret mode, on the [B, D/128, 128] tiling of ``_loss_sums_impl``."""
    import jax.experimental.pallas as pl

    b, d = p.shape
    rows = d // jfl.LANE
    rb = jfl._row_block(rows)
    p3, t3 = (jnp.asarray(x).reshape(b, rows, jfl.LANE) for x in (p, t))
    in_spec = pl.BlockSpec((1, rb, jfl.LANE), lambda i, j: (i, j, 0))
    sums = pl.pallas_call(
        functools.partial(jfl._fwd_kernel, beta=beta),
        grid=(b, rows // rb),
        in_specs=[in_spec, in_spec],
        out_specs=pl.BlockSpec((1, 8, jfl.LANE), lambda i, j: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, 8, jfl.LANE), jnp.float32),
        interpret=True,
    )(p3, t3)[:, 0, :5]
    gpad = jnp.zeros((b, jfl.LANE), jnp.float32).at[:, :5].set(jnp.asarray(g))
    dp = pl.pallas_call(
        functools.partial(jfl._bwd_kernel, beta=beta),
        grid=(b, rows // rb),
        in_specs=[in_spec, in_spec, pl.BlockSpec((b, jfl.LANE), lambda i, j: (0, 0))],
        out_specs=in_spec,
        out_shape=jax.ShapeDtypeStruct(p3.shape, p3.dtype),
        interpret=True,
    )(p3, t3, gpad)
    return np.asarray(sums), np.asarray(dp).reshape(b, d)


@pytest.mark.parametrize("shape", [(2, 1024), (3, 2048)])
def test_plain_matches_pallas_kernels_interpret(shape):
    p, t = _pair(shape, seed=1)
    g = np.random.default_rng(2).standard_normal((shape[0], 5)).astype(np.float32)
    sums, dp = _pallas_interpret(p, t, g)
    np.testing.assert_allclose(tfl.loss_sums_plain(torch.from_numpy(p), torch.from_numpy(t)).numpy(), sums,
                               rtol=1e-5, atol=1e-5)
    got = tfl.loss_sums_bwd_plain(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), dp, rtol=1e-6, atol=1e-6)


def _main_from_sums(sums, d, xp):
    """0.9·cos + 0.1·l1 from the sums, as ``_losses_fused`` forms them."""
    l1 = sums[:, 1].mean() / d
    if xp is jnp:
        denom = jnp.maximum(jnp.sqrt(sums[:, 3]), 1e-12) * jnp.maximum(jnp.sqrt(sums[:, 4]), 1e-12)
    else:
        denom = sums[:, 3].sqrt().clamp_min(1e-12) * sums[:, 4].sqrt().clamp_min(1e-12)
    return 0.9 * (1.0 - sums[:, 2] / denom).mean() + 0.1 * l1


@pytest.mark.parametrize("shape", [(3, 4096), (2, 1000)])
def test_loss_sums_backward_matches_jax_grad(shape):
    """d(0.9cos + 0.1l1)/d pred through ``LossSums`` (its plain backward on
    CPU) against jax.grad through ``loss_sums_reference``."""
    p, t = _pair(shape, seed=3)
    d = shape[1]
    want = jax.grad(lambda x: _main_from_sums(jfl.loss_sums_reference(x, jnp.asarray(t)), d, jnp))(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_(True)
    loss = _main_from_sums(tfl.LossSums.apply(tp, torch.from_numpy(t), 1.0), d, torch)
    (got,) = torch.autograd.grad(loss, tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_loss_sums_backward_in_bf16_is_the_vjp_of_the_cast():
    """bf16 pred read in place by the sums: d pred is the float32 gradient of
    the cast-first form, rounded once to bf16 (JAX: float32 dp, then the VJP
    of ``astype``)."""
    p, t = _pair((2, 2048), seed=4)
    pb = torch.from_numpy(p).to(torch.bfloat16)
    direct = pb.clone().requires_grad_(True)
    cast = pb.clone().requires_grad_(True)
    tt = torch.from_numpy(t)
    (g_direct,) = torch.autograd.grad(_main_from_sums(tfl.LossSums.apply(direct, tt, 1.0), 2048, torch), direct)
    (g_cast,) = torch.autograd.grad(_main_from_sums(tfl.LossSums.apply(cast.float(), tt, 1.0), 2048, torch), cast)
    assert g_direct.dtype == torch.bfloat16
    assert torch.equal(g_direct, g_cast)


@pytest.mark.parametrize(
    "weights, masks",
    [
        (None, None),
        ({"a": 0.5, "b": 0.3, "c_cls": 0.2, "d": 0.1}, None),
        (None, {"a": 1.0, "b": 0.0, "c_cls": 1.0, "d": 1.0}),
        (None, {"a": 0.0, "b": 1.0, "c_cls": 0.0, "d": 0.0}),
    ],
)
@pytest.mark.parametrize("loss_dtype", ["float32", "bfloat16"])
def test_get_loss_fused_matches_jax_unfused(weights, masks, loss_dtype):
    rng = np.random.default_rng(5)
    preds = {k: rng.standard_normal(s).astype(np.float32) for k, s in SIZES.items()}
    targets = {k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in SIZES.items()}
    jdt, tdt = DTYPES[loss_dtype]
    jm = None if masks is None else {k: jnp.asarray(v) for k, v in masks.items()}
    want = jlosses.get_loss({k: jnp.asarray(v) for k, v in preds.items()},
                            {k: jnp.asarray(v) for k, v in targets.items()}, weights, jm, fused=False,
                            compute_dtype=jdt)
    tm = None if masks is None else {k: torch.tensor(v) for k, v in masks.items()}
    got = tlosses.get_loss({k: torch.from_numpy(v) for k, v in preds.items()},
                           {k: torch.from_numpy(v) for k, v in targets.items()}, weights, tm, fused=True,
                           compute_dtype=tdt)
    tol = dict(atol=1e-6, rtol=1e-6) if loss_dtype == "float32" else dict(rtol=1e-2)
    for k in TERMS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **tol)
    for k in PER_MODEL:
        for t in SIZES:
            np.testing.assert_allclose(float(got[k][t]), float(want[k][t]), err_msg=f"{k}[{t}]", **tol)
    np.testing.assert_allclose(float(tlosses.main_loss_from_terms(got, "cos_l1")),
                               float(jlosses.main_loss_from_terms(want, "cos_l1")), **tol)


def test_fused_selection_follows_the_jax_rule(monkeypatch):
    """fused=True, and fused=None with FUSED_LOSS, take exactly the teachers
    with D >= 1024 and D % 128 == 0; fused=False and FUSED_LOSS = False none."""
    seen = []
    real = tlosses._losses_fused
    monkeypatch.setattr(tlosses, "_losses_fused", lambda p, t, dt: seen.append(p[0].numel()) or real(p, t, dt))
    f = {k: torch.randn(s, generator=torch.Generator().manual_seed(6)) for k, s in SIZES.items()}
    for fused, default, want in [(True, False, [1536, 2048]), (None, True, [1536, 2048]), (False, True, []),
                                 (None, False, [])]:
        seen.clear()
        monkeypatch.setattr(tlosses, "FUSED_LOSS", default)
        tlosses.get_loss(f, f, fused=fused)
        assert seen == want, (fused, default)


def test_fused_loss_keeps_bf16_predictions_and_matches_the_unfused_gradient():
    """loss_dtype float32 with bf16 predictions: the fused path reads them
    without a float32 copy and gives the unfused path's gradient in bf16."""
    rng = np.random.default_rng(7)
    preds = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16) for k, s in SIZES.items()}
    targets = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in SIZES.items()}
    grads = {}
    for fused in (True, False):
        ps = {k: v.clone().requires_grad_(True) for k, v in preds.items()}
        loss = tlosses.main_loss_from_terms(tlosses.get_loss(ps, targets, fused=fused), "cos_l1")
        grads[fused] = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    for k in SIZES:
        assert grads[True][k].dtype == torch.bfloat16
        # the same float32 gradient up to sum order, each rounded once to bf16
        torch.testing.assert_close(grads[True][k].float(), grads[False][k].float(), rtol=1e-2, atol=1e-7)


def test_flat_rows_counts_the_copies_it_makes():
    before = tfl.LOSS_INPUT_COPIES
    x = torch.zeros(2, 8, 16)
    assert tfl.flat_rows(x).data_ptr() == x.data_ptr() and tfl.LOSS_INPUT_COPIES == before
    y = tfl.flat_rows(torch.zeros(2, 16, 8).transpose(1, 2))  # a [B, HW, C] view of [B, C, HW]
    assert y.is_contiguous() and tuple(y.shape) == (2, 128) and tfl.LOSS_INPUT_COPIES == before + 1


def test_kernel_wrappers_refuse_tensors_neither_on_cpu_nor_on_cuda():
    pred = target = torch.zeros(2, 8, device="meta")
    before = (tfl.LOSS_SUMS_FWD_LAUNCHES, tfl.LOSS_SUMS_BWD_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfl.loss_sums_fwd(pred, target)
    with pytest.raises(ValueError, match="CUDA"):
        tfl.loss_sums_bwd(pred, target, torch.zeros(2, 5, device="meta"))
    assert (tfl.LOSS_SUMS_FWD_LAUNCHES, tfl.LOSS_SUMS_BWD_LAUNCHES) == before


@pytest.mark.parametrize(
    "shape_p, shape_t, dtype, contiguous, err",
    [
        ((2, 8), (2, 8), torch.float16, True, TypeError),
        ((2, 8), (2, 9), torch.float32, True, ValueError),
        ((2, 4, 2), (2, 4, 2), torch.float32, True, ValueError),  # not [B, D]
        ((8, 2), (8, 2), torch.float32, False, ValueError),  # not contiguous rows
    ],
)
def test_kernel_input_check(shape_p, shape_t, dtype, contiguous, err):
    """What ``_check_kernel_inputs`` refuses (the device check aside)."""
    pred = torch.zeros(shape_p, dtype=dtype, device="meta")
    target = torch.zeros(shape_t, dtype=dtype, device="meta")
    if not contiguous:
        pred, target = pred.t(), target.t()
    with pytest.raises(err):
        tfl._check_kernel_inputs(pred, target)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 256 * 1280), (16, 4096 * 32), (1, 1), (16, 127), (1, 1024)])
@pytest.mark.parametrize("pdt, tdt", [(torch.bfloat16, torch.float32), (torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
def test_cuda_kernels_match_plain(cuda, shape, pdt, tdt):
    gen = torch.Generator().manual_seed(8)
    p = torch.randn(shape, generator=gen).to(cuda, pdt)
    t = torch.randn(shape, generator=gen).to(cuda, tdt)
    g = torch.randn(shape[0], 5, generator=gen).to(cuda)
    before = (tfl.LOSS_SUMS_FWD_LAUNCHES, tfl.LOSS_SUMS_BWD_LAUNCHES)
    sums, dp = tfl.loss_sums_fwd(p, t), tfl.loss_sums_bwd(p, t, g)
    torch.cuda.synchronize()
    assert (tfl.LOSS_SUMS_FWD_LAUNCHES, tfl.LOSS_SUMS_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = tfl.loss_sums_plain(p, t)
    # sum order: within 1e-5 of the sum of the terms' magnitudes
    scale = tfl.loss_sums_plain(p.abs(), -t.abs()).abs() + 1.0
    assert bool(((sums - want).abs() <= 1e-5 * scale).all())
    assert dp.dtype == pdt
    torch.testing.assert_close(dp, tfl.loss_sums_bwd_plain(p, t, g), atol=0, rtol=0)
