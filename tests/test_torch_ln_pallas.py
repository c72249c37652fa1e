"""The port's LayerNormSpatial backward against the JAX package: the plain
version against ``ln_pallas._autodiff_bwd``, against ``jax.vjp`` of
``ln_spatial_pallas`` (which takes that path off the TPU) and against the
Pallas kernel bodies ``_stats_kernel`` and ``_dx_kernel`` run in interpret
mode; the autograd function (gradcheck in float64); ``LN_STATS_IMPL``
"pallas" against "vpu"; the wrappers' checks; and (on a card) the CUDA
kernels K3 and K4 against the plain version.

Tolerances: float32 atol 1e-5 (the same float32 math, sums over up to
C·H·W elements in another order); the TPU kernel bodies do their
elementwise work in the input's dtype, in float32 here, so the same.
"pallas" and "vpu" forwards are the same ops, so bit for bit equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from theia_tpu.models import layers as jlayers
from theia_tpu.ops import ln_pallas as jln
from theia_tpu_torch.models import layers as tlayers
from theia_tpu_torch.ops import ln_pallas as tln

EPS = 1e-5
SHAPES = [(2, 16, 8, 8), (3, 24, 7, 5), (2, 8, 16, 16)]  # [B, C, H, W]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, c, h, w = shape
    x = (1.0 + 2.0 * rng.standard_normal((b, h, w, c))).astype(np.float32)  # NHWC, as JAX holds it
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    weight = rng.standard_normal((c, h, w)).astype(np.float32)
    bias = rng.standard_normal((c, h, w)).astype(np.float32)
    return x, g, weight, bias


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _torch_stats(x):
    mean, r = tln.ln_spatial_stats(_nchw(x), EPS)
    return mean, r


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_autodiff_bwd(shape):
    x, g, weight, _ = _inputs(shape)
    w_hwc = jnp.asarray(weight.transpose(1, 2, 0))
    _, (jmean, jr) = jln._fwd_impl(jnp.asarray(x), w_hwc, w_hwc, EPS, jnp.float32)
    want = jln._autodiff_bwd(jnp.asarray(x), w_hwc, jmean, jr, EPS, jnp.float32, jnp.asarray(g))
    mean, r = _torch_stats(x)
    np.testing.assert_allclose(mean.reshape(-1).numpy(), np.asarray(jmean).reshape(-1), atol=1e-6)
    np.testing.assert_allclose(r.reshape(-1).numpy(), np.asarray(jr).reshape(-1), rtol=1e-5)
    dx, dw, db = tln.ln_spatial_bwd(_nchw(x), torch.from_numpy(weight), mean, r, _nchw(g))
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dw.permute(1, 2, 0).numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(db.permute(1, 2, 0).numpy(), np.asarray(want[2]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_function_matches_jax_vjp(shape):
    x, g, weight, bias = _inputs(shape, seed=1)
    fn = lambda a, w, b: jln.ln_spatial_pallas(a, w.transpose(1, 2, 0), b.transpose(1, 2, 0), EPS, jnp.float32)
    y, vjp = jax.vjp(fn, *map(jnp.asarray, (x, weight, bias)))
    want = vjp(jnp.asarray(g))
    tx = _nchw(x).requires_grad_(True)
    tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (weight, bias))
    out = tln.LNSpatialFunction.apply(tx, tw, tb, EPS)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), atol=1e-5, rtol=0)
    got = torch.autograd.grad(out, (tx, tw, tb), _nchw(g))
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5, rtol=0)


def _pallas_interpret(x, g, weight, mean, r):
    """The TPU kernel bodies on the CPU, in the [S, B, C] view and chunking
    of ``_bwd_kernels`` (whose TPU compiler parameters interpret mode does
    not take)."""
    from jax.experimental.pallas import tpu as pltpu

    bsz, h, w, c = x.shape
    s = h * w
    ch = jln._chunk_rows(s, bsz, c)
    g3 = jnp.asarray(g).reshape(bsz, s, c).transpose(1, 0, 2)
    x3 = jnp.asarray(x).reshape(bsz, s, c).transpose(1, 0, 2)
    w2 = jnp.asarray(weight).transpose(1, 2, 0).reshape(s, c)
    mean3, r3 = mean.reshape(1, bsz, 1), r.reshape(1, bsz, 1)
    map_spec = pl.BlockSpec((ch, bsz, c), lambda k: (k, 0, 0))
    w_spec = pl.BlockSpec((ch, c), lambda k: (k, 0))
    b_spec = pl.BlockSpec((1, bsz, 1), lambda k: (0, 0, 0))
    s1, s2, dw, db = pl.pallas_call(
        jln._stats_kernel,
        grid=(s // ch,),
        in_specs=[map_spec, map_spec, w_spec, b_spec, b_spec],
        out_specs=[b_spec, b_spec, w_spec, w_spec],
        out_shape=[jax.ShapeDtypeStruct((1, bsz, 1), jnp.float32)] * 2 + [jax.ShapeDtypeStruct((s, c), jnp.float32)] * 2,
        scratch_shapes=[pltpu.VMEM((1, bsz, 1), jnp.float32)] * 2,
        interpret=True,
    )(g3, x3, w2, mean3, r3)
    dx = pl.pallas_call(
        functools.partial(jln._dx_kernel, inv_n=1.0 / (s * c)),
        grid=(s // ch,),
        in_specs=[map_spec, map_spec, w_spec] + [b_spec] * 4,
        out_specs=map_spec,
        out_shape=jax.ShapeDtypeStruct(x3.shape, x3.dtype),
        interpret=True,
    )(g3, x3, w2, mean3, r3, s1, s2)
    return (np.asarray(s1).reshape(-1), np.asarray(s2).reshape(-1), np.asarray(dw), np.asarray(db),
            np.asarray(dx).transpose(1, 0, 2).reshape(x.shape))


@pytest.mark.parametrize("shape", [(2, 16, 8, 8), (2, 8, 16, 16)])
def test_plain_matches_pallas_kernels_interpret(shape):
    x, g, weight, _ = _inputs(shape, seed=2)
    mean, r = _torch_stats(x)
    s1, s2, dw, db, dx = _pallas_interpret(x, g, weight, jnp.asarray(mean.numpy()), jnp.asarray(r.numpy()))
    gs1, gs2, gdw, gdb = tln.ln_bwd_stats_plain(_nchw(x), torch.from_numpy(weight), mean, r, _nchw(g))
    np.testing.assert_allclose(gs1.numpy(), s1, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(gs2.numpy(), s2, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(gdw.permute(1, 2, 0).reshape(-1, shape[1]).numpy(), dw, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gdb.permute(1, 2, 0).reshape(-1, shape[1]).numpy(), db, atol=1e-5, rtol=0)
    gdx = tln.ln_bwd_dx_plain(_nchw(x), torch.from_numpy(weight), mean, r, _nchw(g), gs1, gs2)
    np.testing.assert_allclose(gdx.permute(0, 2, 3, 1).numpy(), dx, atol=1e-5, rtol=0)


def test_autograd_function_gradcheck_f64():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 3, 3, dtype=torch.float64, generator=gen).contiguous(memory_format=torch.channels_last)
    w, b = (torch.randn(8, 3, 3, dtype=torch.float64, generator=gen) for _ in range(2))
    args = tuple(t.requires_grad_(True) for t in (x, w, b))
    assert torch.autograd.gradcheck(lambda *a: tln.LNSpatialFunction.apply(*a, EPS), args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_spatial_pallas_vs_vpu(dtype):
    """The module under both LN_STATS_IMPL values: the same forward bit for
    bit (the same ops) and the same gradients within 1e-5 (float32)."""
    x, g, weight, bias = _inputs((2, 16, 8, 8), seed=4)
    m = tlayers.LayerNormSpatial((16, 8, 8), compute_dtype=dtype)
    m.load_state_dict({"weight": torch.from_numpy(weight), "bias": torch.from_numpy(bias)})
    outs, grads = {}, {}
    saved = tlayers.LN_STATS_IMPL
    try:
        for impl in ("pallas", "vpu"):
            tlayers.LN_STATS_IMPL = impl
            tx = _nchw(x).requires_grad_(True)
            out = m(tx)
            outs[impl] = out.detach()
            grads[impl] = torch.autograd.grad(out, (tx, m.weight, m.bias), _nchw(g).to(dtype))
    finally:
        tlayers.LN_STATS_IMPL = saved
    assert outs["pallas"].dtype == dtype
    assert torch.equal(outs["pallas"], outs["vpu"])
    if dtype == torch.float32:
        for a, b in zip(grads["pallas"], grads["vpu"]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert all(gr.dtype == torch.float32 for gr in grads["pallas"][1:])  # float32 params, float32 grads


def test_layer_norm_spatial_matches_jax_pallas_module():
    """The port's module against the JAX module with LN_STATS_IMPL = "pallas"."""
    x, g, weight, bias = _inputs((2, 16, 8, 8), seed=5)
    saved = jlayers.LN_STATS_IMPL
    jlayers.LN_STATS_IMPL = "pallas"
    try:
        jm = jlayers.LayerNormSpatial((16, 8, 8))
        y, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a),
                         {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias)}, jnp.asarray(x))
        dparams, dx = vjp(jnp.asarray(g))
    finally:
        jlayers.LN_STATS_IMPL = saved
    tm = tlayers.LayerNormSpatial((16, 8, 8))
    tm.load_state_dict({"weight": torch.from_numpy(weight), "bias": torch.from_numpy(bias)})
    tx = _nchw(x).requires_grad_(True)
    out = tm(tx)
    got = torch.autograd.grad(out, (tx, tm.weight, tm.bias), _nchw(g))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), np.asarray(dx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(dparams["weight"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dparams["bias"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "shape, dtype, memory_format, err",
    [
        ((2, 8, 4, 4), torch.float16, torch.channels_last, TypeError),
        ((2, 12, 4, 4), torch.float32, torch.channels_last, ValueError),  # C % 8
        ((2, 8, 4, 4), torch.float32, torch.contiguous_format, ValueError),  # not channels_last
    ],
)
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(shape, dtype, memory_format, err):
    x = torch.zeros(shape, dtype=dtype).contiguous(memory_format=memory_format)
    with pytest.raises(err):
        tln._check_kernel_inputs(x, x, torch.zeros(shape[1:]), torch.zeros(shape[0]))


def test_kernel_wrappers_refuse_cpu_tensors():
    x, g, weight, _ = _inputs((2, 8, 4, 4))
    mean, r = _torch_stats(x)
    with pytest.raises(ValueError, match="CUDA"):
        tln.ln_bwd_stats(_nchw(x), torch.from_numpy(weight), mean, r, _nchw(g))
    before = (tln.LN_BWD_STATS_LAUNCHES, tln.LN_BWD_DX_LAUNCHES)
    tln.ln_spatial_bwd(_nchw(x), torch.from_numpy(weight), mean, r, _nchw(g))  # CPU: the plain version
    assert (tln.LN_BWD_STATS_LAUNCHES, tln.LN_BWD_DX_LAUNCHES) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s", (16, 31, 64))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_kernels_match_plain(cuda, s, dtype):
    gen = torch.Generator().manual_seed(6)
    x = (torch.randn(4, 64, s, s, generator=gen) * 2 + 1).to(cuda, dtype).contiguous(memory_format=torch.channels_last)
    g = torch.randn(4, 64, s, s, generator=gen).to(cuda, dtype).contiguous(memory_format=torch.channels_last)
    w = torch.randn(64, s, s, generator=gen).to(cuda)
    mean, r = tln.ln_spatial_stats(x, EPS)
    before = (tln.LN_BWD_STATS_LAUNCHES, tln.LN_BWD_DX_LAUNCHES)
    s1, s2, dw, db = tln.ln_bwd_stats(x, w, mean, r, g)
    dx = tln.ln_bwd_dx(x, w, mean, r, g, s1, s2)
    torch.cuda.synchronize()
    assert (tln.LN_BWD_STATS_LAUNCHES, tln.LN_BWD_DX_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = tln.ln_bwd_stats_plain(x, w, mean, r, g)
    for a, b in zip((s1, s2, dw, db), want):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-5)
    want_dx = tln.ln_bwd_dx_plain(x, w, mean, r, g, *want[:2])
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=1e-5 if dtype == torch.float32 else 2e-2, rtol=0)
