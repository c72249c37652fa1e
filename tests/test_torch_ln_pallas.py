"""The port's LayerNormSpatial backward against the JAX package: the plain
version against ``ln_pallas._autodiff_bwd``, against ``jax.vjp`` of
``ln_spatial_pallas`` (which takes that path off the TPU) and against the
Pallas kernel bodies ``_stats_kernel`` and ``_dx_kernel`` run in interpret
mode; the autograd function (gradcheck in float64); ``LN_STATS_IMPL``
"pallas" against "vpu"; the wrappers' checks; the plain version against
both JAX references at K3's edges (a batch of 1 and 3, 7x7 and 31x31, 8 and
24 channels); the plain dx against ``_autodiff_bwd`` at K4's edges (B not
a multiple of its batch split, S = 1, C = 60 and 2048, N twice the row);
and (on a card) the CUDA kernels K3 and K4 against the plain version, each
over its edges, bit-identical across calls and back to back, one launch a
call, K3's dw and db in the parameter's layout, K4 on misaligned maps and a
bf16-stored weight.

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
    """The TPU kernel bodies on the CPU, in the [S, B, C] view, zero padding
    of S to a multiple of 8 and chunking of ``_vjp_bwd`` and ``_bwd_kernels``
    (whose TPU compiler parameters interpret mode does not take)."""
    from jax.experimental.pallas import tpu as pltpu

    bsz, h, w, c = x.shape
    s = h * w
    s_pad = -(-s // 8) * 8
    ch = jln._chunk_rows(s_pad, bsz, c)
    pad3 = [(0, s_pad - s), (0, 0), (0, 0)]
    g3 = jnp.pad(jnp.asarray(g).reshape(bsz, s, c).transpose(1, 0, 2), pad3)
    x3 = jnp.pad(jnp.asarray(x).reshape(bsz, s, c).transpose(1, 0, 2), pad3)
    w2 = jnp.pad(jnp.asarray(weight).transpose(1, 2, 0).reshape(s, c), [(0, s_pad - s), (0, 0)])
    mean3, r3 = mean.reshape(1, bsz, 1), r.reshape(1, bsz, 1)
    map_spec = pl.BlockSpec((ch, bsz, c), lambda k: (k, 0, 0))
    w_spec = pl.BlockSpec((ch, c), lambda k: (k, 0))
    b_spec = pl.BlockSpec((1, bsz, 1), lambda k: (0, 0, 0))
    s1, s2, dw, db = pl.pallas_call(
        jln._stats_kernel,
        grid=(s_pad // ch,),
        in_specs=[map_spec, map_spec, w_spec, b_spec, b_spec],
        out_specs=[b_spec, b_spec, w_spec, w_spec],
        out_shape=[jax.ShapeDtypeStruct((1, bsz, 1), jnp.float32)] * 2 + [jax.ShapeDtypeStruct((s, c), jnp.float32)] * 2,
        scratch_shapes=[pltpu.VMEM((1, bsz, 1), jnp.float32)] * 2,
        interpret=True,
    )(g3, x3, w2, mean3, r3)
    dx = pl.pallas_call(
        functools.partial(jln._dx_kernel, inv_n=1.0 / (s * c)),
        grid=(s_pad // ch,),
        in_specs=[map_spec, map_spec, w_spec] + [b_spec] * 4,
        out_specs=map_spec,
        out_shape=jax.ShapeDtypeStruct(x3.shape, x3.dtype),
        interpret=True,
    )(g3, x3, w2, mean3, r3, s1, s2)
    return (np.asarray(s1).reshape(-1), np.asarray(s2).reshape(-1), np.asarray(dw)[:s], np.asarray(db)[:s],
            np.asarray(dx)[:s].transpose(1, 0, 2).reshape(x.shape))


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


# K3's edges at narrow widths: a batch of 1 and 3, the 7x7 ladder and
# 31x31 (at 768 channels the CUDA kernel's last 16-position tile holds one
# position; the TPU kernel pads S to 968), one vector of 8 channels and
# three
EDGES = [(b, side, c) for b in (1, 3) for side in (7, 31) for c in (8, 24)]


@pytest.mark.parametrize("b, side, c", EDGES)
def test_stats_plain_matches_jax_at_kernel_edges(b, side, c):
    """``ln_bwd_stats_plain`` (and ``ln_bwd_dx_plain``) against
    ``_autodiff_bwd`` and against the interpret-mode ``_stats_kernel`` and
    ``_dx_kernel`` at the CUDA kernel's edges, as the tests above do."""
    shape = (b, c, side, side)
    x, g, weight, _ = _inputs(shape, seed=7)
    mean, r = _torch_stats(x)
    w_hwc = jnp.asarray(weight.transpose(1, 2, 0))
    want = jln._autodiff_bwd(jnp.asarray(x), w_hwc, jnp.asarray(mean.numpy()), jnp.asarray(r.numpy()), EPS,
                             jnp.float32, jnp.asarray(g))
    gs1, gs2, gdw, gdb = tln.ln_bwd_stats_plain(_nchw(x), torch.from_numpy(weight), mean, r, _nchw(g))
    gdx = tln.ln_bwd_dx_plain(_nchw(x), torch.from_numpy(weight), mean, r, _nchw(g), gs1, gs2)
    np.testing.assert_allclose(gdx.permute(0, 2, 3, 1).numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gdw.permute(1, 2, 0).numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gdb.permute(1, 2, 0).numpy(), np.asarray(want[2]), atol=1e-5, rtol=0)
    s1, s2, dw, db, dx = _pallas_interpret(x, g, weight, jnp.asarray(mean.numpy()), jnp.asarray(r.numpy()))
    np.testing.assert_allclose(gs1.numpy(), s1, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(gs2.numpy(), s2, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(gdw.permute(1, 2, 0).reshape(-1, c).numpy(), dw, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gdb.permute(1, 2, 0).reshape(-1, c).numpy(), db, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gdx.permute(0, 2, 3, 1).numpy(), dx, atol=1e-5, rtol=0)


# K4's edges: B not a multiple of the kernel's batch split (7 samples), S =
# 1 (1x1 maps), C = 2048 at a 2x2 side, C = 60 (one element a thread), and
# N twice the row (each half of the channels with s1 and s2 summed over
# both halves, as two ranks of a model group compute a split sample)
DX_EDGES = [((7, 16, 4, 4), 1), ((3, 24, 1, 1), 1), ((2, 60, 1, 1), 1), ((2, 2048, 2, 2), 1), ((3, 60, 7, 7), 1),
            ((3, 16, 5, 5), 2), ((2, 120, 3, 3), 2)]


@pytest.mark.parametrize("shape, split", DX_EDGES)
def test_dx_plain_matches_autodiff_bwd_at_k4_edges(shape, split):
    """``ln_bwd_dx_plain`` against ``_autodiff_bwd``'s dx at the edges of K4's
    tiling; with ``split`` > 1 the sample's channels are cut into that many
    slices, each slice's s1, s2 summed over the slices and N the whole
    sample's (parallel/tp.py's split LayerNormSpatial)."""
    x, g, weight, _ = _inputs(shape, seed=9)
    mean, r = _torch_stats(x)
    w_hwc = jnp.asarray(weight.transpose(1, 2, 0))
    want = jln._autodiff_bwd(jnp.asarray(x), w_hwc, jnp.asarray(mean.numpy()), jnp.asarray(r.numpy()), EPS,
                             jnp.float32, jnp.asarray(g))
    tx, tg, tw = _nchw(x), _nchw(g), torch.from_numpy(weight)
    c = shape[1] // split
    parts = [slice(i * c, (i + 1) * c) for i in range(split)]
    stats = [tln.ln_bwd_stats_plain(tx[:, p], tw[p], mean, r, tg[:, p]) for p in parts]
    s1, s2 = (sum(st[k] for st in stats) for k in (0, 1))
    count = tx[0].numel() if split > 1 else None
    dx = torch.cat([tln.ln_bwd_dx_plain(tx[:, p], tw[p], mean, r, tg[:, p], s1, s2, count) for p in parts], dim=1)
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)


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
        ((2, 16, 4, 4), torch.float32, "misaligned", ValueError),  # the 16-byte path (C % 8 == 0)
        ((2, 8, 4, 4), torch.float32, torch.contiguous_format, ValueError),  # not channels_last
    ],
)
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(shape, dtype, memory_format, err):
    x = _misaligned(shape, dtype) if memory_format == "misaligned" else \
        torch.zeros(shape, dtype=dtype).contiguous(memory_format=memory_format)
    with pytest.raises(err):
        tln._check_kernel_inputs(x, x, torch.zeros(shape[1:]), torch.zeros(shape[0]))


def _misaligned(shape, dtype):
    """A channels_last [B, C, H, W] view one element past a 16-byte boundary."""
    b, c, h, w = shape
    return torch.zeros(b * c * h * w + 1, dtype=dtype)[1:].view(b, h, w, c).permute(0, 3, 1, 2)


@pytest.mark.parametrize("c", (12, 60, 13))
def test_kernel_wrappers_take_any_channel_count(c):
    """C that is not a multiple of 8 takes the kernels' one-element path,
    at any alignment."""
    for x in (torch.zeros(2, c, 3, 3).contiguous(memory_format=torch.channels_last), _misaligned((2, c, 3, 3),
                                                                                               torch.float32)):
        tln._check_kernel_inputs(x, x, torch.zeros(c, 3, 3), torch.zeros(2))


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


def _k3_inputs(cuda, b, c, side, dtype, seed=8):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, c, side, side, generator=gen) * 2 + 1).to(cuda, dtype)
    g = torch.randn(b, c, side, side, generator=gen).to(cuda, dtype)
    w = torch.randn(c, side, side, generator=gen).to(cuda)
    x, g = (t.contiguous(memory_format=torch.channels_last) for t in (x, g))
    mean, r = tln.ln_spatial_stats(x, EPS)
    return x, w, mean, r, g


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.gpu
@pytest.mark.parametrize("c", (8, 768))
@pytest.mark.parametrize("side", (7, 16, 31))
@pytest.mark.parametrize("b", (1, 3, 9, 16))
def test_cuda_stats_matches_plain_at_edges(cuda, b, side, c):
    """K3 against the plain version in float64 on the same inputs, bf16 and
    float32: each of s1, s2, dw, db within relative L2 1e-5 (float32 sums in
    another order), dw and db contiguous (C, H, W)."""
    for dtype in (torch.bfloat16, torch.float32):
        x, w, mean, r, g = _k3_inputs(cuda, b, c, side, dtype)
        got = tln.ln_bwd_stats(x, w, mean, r, g)
        want = tln.ln_bwd_stats_plain(*(t.double() for t in (x, w, mean, r, g)))
        for a, bb in zip(got, want):
            assert _rel_l2(a, bb) < 1e-5
        assert all(t.shape == w.shape and t.is_contiguous() for t in got[2:])


@pytest.mark.gpu
def test_cuda_stats_bit_identical_across_calls(cuda):
    x, w, mean, r, g = _k3_inputs(cuda, 16, 768, 31, torch.bfloat16)
    first, second = (tln.ln_bwd_stats(x, w, mean, r, g) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_cuda_stats_back_to_back_calls_agree(cuda):
    """50 calls without a synchronize between them give the first call's
    results: the ticket counter resets itself at the end of each launch."""
    x, w, mean, r, g = _k3_inputs(cuda, 16, 768, 16, torch.bfloat16)
    first = tln.ln_bwd_stats(x, w, mean, r, g)
    runs = [tln.ln_bwd_stats(x, w, mean, r, g) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for run in runs for a, b in zip(first, run))


@pytest.mark.gpu
def test_cuda_stats_on_two_streams_at_once_agree(cuda):
    """Calls in flight on two streams at once each give the one-stream
    result: each stream has its own ticket counters, so the launches'
    tickets never interleave."""
    x, w, mean, r, g = _k3_inputs(cuda, 16, 768, 16, torch.bfloat16)
    want = tln.ln_bwd_stats(x, w, mean, r, g)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    runs = []
    for _ in range(20):
        for stream in streams:
            with torch.cuda.stream(stream):
                runs.append(tln.ln_bwd_stats(x, w, mean, r, g))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for run in runs for a, b in zip(want, run))


@pytest.mark.gpu
def test_cuda_stats_weight_grads_come_back_in_the_parameters_layout(cuda):
    x, w, mean, r, g = _k3_inputs(cuda, 3, 64, 16, torch.bfloat16)
    _, _, dw, db = tln.ln_bwd_stats(x, w, mean, r, g)
    assert dw.shape == db.shape == w.shape and dw.is_contiguous() and db.is_contiguous()
    _, dw2, db2 = tln.ln_spatial_bwd(x, w, mean, r, g)
    assert dw2.is_contiguous() and db2.is_contiguous()


@pytest.mark.gpu
def test_cuda_stats_is_one_kernel_launch(cuda):
    """A K3 call launches one kernel and nothing else: no copy of the
    weight, no finishing kernel, no memset (torch.profiler)."""
    from theia_tpu_torch.tools.timing import device_ops

    x, w, mean, r, g = _k3_inputs(cuda, 16, 768, 16, torch.bfloat16)
    ops = device_ops(lambda: tln.ln_bwd_stats(x, w, mean, r, g))
    assert len(ops) == 1 and next(iter(ops)).startswith("ln_bwd_stats_sm90") and list(ops.values()) == [1.0]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 60, 7, 7), (32, 60, 3, 3), (32, 256, 1, 1), (3, 13, 5, 5)])
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_kernels_take_any_channel_count_and_one_position(cuda, shape, dtype):
    """K3 and K4 where C is not a multiple of 8 (one element a thread; the
    policy heads' C = 60) and at S = H*W = 1, against the plain version in
    float64: s1, s2, dw, db within relative L2 1e-5, dx 1e-6 in float32
    and 1e-2 in bf16 (its rounding)."""
    b, c, side = shape[0], shape[1], shape[2]
    x, w, mean, r, g = _k3_inputs(cuda, b, c, side, dtype)
    before = (tln.LN_BWD_STATS_LAUNCHES, tln.LN_BWD_DX_LAUNCHES)
    got = tln.ln_bwd_stats(x, w, mean, r, g)
    want = tln.ln_bwd_stats_plain(*(t.double() for t in (x, w, mean, r, g)))
    for a, bb in zip(got, want):
        assert _rel_l2(a, bb) < 1e-5
    dx = tln.ln_bwd_dx(x, w, mean, r, g, want[0].float(), want[1].float())
    want_dx = tln.ln_bwd_dx_plain(*(t.double() for t in (x, w, mean, r, g)), want[0], want[1])
    assert _rel_l2(dx, want_dx) < (1e-6 if dtype == torch.float32 else 1e-2)
    assert (tln.LN_BWD_STATS_LAUNCHES, tln.LN_BWD_DX_LAUNCHES) == (before[0] + 1, before[1] + 1)


def test_bwd_dx_plain_takes_the_normaliser_count():
    """K4's plain version divides by ``count`` (the whole sample's N where
    the channels are split over ranks), by default the row length."""
    x, g, weight, _ = _inputs((2, 8, 4, 4))
    mean, r = _torch_stats(x)
    x, g, w = _nchw(x), _nchw(g), torch.from_numpy(weight)
    s1, s2, _, _ = tln.ln_bwd_stats_plain(x, w, mean, r, g)
    n = x[0].numel()
    assert torch.equal(tln.ln_bwd_dx_plain(x, w, mean, r, g, s1, s2),
                       tln.ln_bwd_dx_plain(x, w, mean, r, g, s1, s2, n))
    m, rr, a, c = (t.reshape(-1, 1, 1, 1) for t in (mean, r, s1, s2))
    want = rr * (g * w - (a + (x - m) * rr * c) / (3 * n))
    torch.testing.assert_close(tln.ln_bwd_dx_plain(x, w, mean, r, g, s1, s2, 3 * n), want, rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("s", (31, 64))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_dx_takes_the_normaliser_count(cuda, s, dtype):
    """K4 with a normaliser's count of twice the row length (a sample whose
    channels two ranks split) against its plain version in float64: relative
    L2 1e-6 in float32, 1e-2 in bf16 (its rounding)."""
    x, w, mean, r, g = _k3_inputs(cuda, 4, 64, s, dtype)
    s1, s2, _, _ = tln.ln_bwd_stats_plain(*(t.double() for t in (x, w, mean, r, g)))
    count = 2 * x[0].numel()
    before = tln.LN_BWD_DX_LAUNCHES
    dx = tln.ln_bwd_dx(x, w, mean, r, g, s1.float(), s2.float(), count)
    want = tln.ln_bwd_dx_plain(*(t.double() for t in (x, w, mean, r, g)), s1, s2, count)
    assert tln.LN_BWD_DX_LAUNCHES == before + 1
    assert _rel_l2(dx, want) < (1e-6 if dtype == torch.float32 else 1e-2)


# K4's edges on the card ([B, C, H, W], N over the row): B not a multiple
# of the batch split (at 16x16 and 768 channels 96 tiles, 3 runs of 3 and
# one of 1 at B = 7), S = 1, C = 2048 at a small side, C = 60 and 13 (one
# element a thread), N twice the row
CUDA_DX_EDGES = [((7, 768, 16, 16), 1), ((13, 768, 16, 16), 1), ((3, 24, 1, 1), 1), ((32, 256, 1, 1), 1),
                 ((5, 2048, 4, 4), 1), ((32, 60, 7, 7), 1), ((3, 13, 5, 5), 1), ((4, 64, 31, 31), 2),
                 ((7, 768, 16, 16), 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape, mult", CUDA_DX_EDGES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_dx_matches_plain_at_k4_edges(cuda, shape, mult, dtype):
    """K4 against its plain version in float64 at its edges: relative L2
    1e-6 in float32, 1e-2 in bf16 (its rounding); one launch a call."""
    b, c, side = shape[0], shape[1], shape[2]
    x, w, mean, r, g = _k3_inputs(cuda, b, c, side, dtype, seed=10)
    s1, s2, _, _ = tln.ln_bwd_stats_plain(*(t.double() for t in (x, w, mean, r, g)))
    count = mult * x[0].numel()
    before = tln.LN_BWD_DX_LAUNCHES
    dx = tln.ln_bwd_dx(x, w, mean, r, g, s1.float(), s2.float(), count)
    want = tln.ln_bwd_dx_plain(*(t.double() for t in (x, w, mean, r, g)), s1, s2, count)
    assert tln.LN_BWD_DX_LAUNCHES == before + 1
    assert _rel_l2(dx, want) < (1e-6 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("c", (13, 60))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_dx_takes_misaligned_maps(cuda, c, dtype):
    """K4 on maps one element past a 16-byte boundary (C not a multiple of
    8: the one-element path), against its plain version in float64."""
    x, w, mean, r, g = _k3_inputs(cuda, 3, c, 5, dtype, seed=11)
    x, g = (torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:].view(3, 5, 5, c).permute(0, 3, 1, 2).copy_(t)
            for t in (x, g))
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    s1, s2, _, _ = tln.ln_bwd_stats_plain(*(t.double() for t in (x, w, mean, r, g)))
    dx = tln.ln_bwd_dx(x, w, mean, r, g, s1.float(), s2.float())
    want = tln.ln_bwd_dx_plain(*(t.double() for t in (x, w, mean, r, g)), s1, s2)
    assert _rel_l2(dx, want) < (1e-6 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
def test_cuda_dx_bit_identical_across_calls(cuda):
    """Two calls, and 50 back to back without a synchronize, give the same
    bits: each element is one thread's, no atomics."""
    x, w, mean, r, g = _k3_inputs(cuda, 16, 768, 16, torch.bfloat16)
    s1, s2, _, _ = tln.ln_bwd_stats_plain(x, w, mean, r, g)
    first, second = (tln.ln_bwd_dx(x, w, mean, r, g, s1, s2) for _ in range(2))
    assert torch.equal(first, second)
    runs = [tln.ln_bwd_dx(x, w, mean, r, g, s1, s2) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, run) for run in runs)


@pytest.mark.gpu
def test_cuda_dx_is_one_kernel_launch(cuda):
    """A K4 call launches one kernel and nothing else: the weight is read in
    its own (C, H, W) layout, not copied (torch.profiler)."""
    from theia_tpu_torch.tools.timing import device_ops

    x, w, mean, r, g = _k3_inputs(cuda, 16, 768, 16, torch.bfloat16)
    s1, s2, _, _ = tln.ln_bwd_stats_plain(x, w, mean, r, g)
    ops = device_ops(lambda: tln.ln_bwd_dx(x, w, mean, r, g, s1, s2))
    assert len(ops) == 1 and next(iter(ops)).startswith("ln_bwd_dx_sm90") and list(ops.values()) == [1.0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_dx_takes_a_bf16_stored_weight(cuda, dtype):
    """A weight stored in bf16 (a served model's) gives the bits of the same
    weight in float32, and agrees with the plain version."""
    x, w, mean, r, g = _k3_inputs(cuda, 4, 64, 16, dtype, seed=12)
    wb = w.to(torch.bfloat16)
    s1, s2, _, _ = tln.ln_bwd_stats_plain(x, wb, mean, r, g)
    dx = tln.ln_bwd_dx(x, wb, mean, r, g, s1, s2)
    assert torch.equal(dx, tln.ln_bwd_dx(x, wb.float(), mean, r, g, s1, s2))
    want = tln.ln_bwd_dx_plain(*(t.double() for t in (x, wb, mean, r, g)), s1.double(), s2.double())
    assert _rel_l2(dx, want) < (1e-6 if dtype == torch.float32 else 1e-2)
