"""The port's attention against the JAX package: the plain forward against
``_einsum_attention`` and against the Pallas kernel body ``_mha_fwd_kernel``
run in interpret mode; the plain backward against ``jax.vjp`` of
``_einsum_attention`` and against ``_mha_bwd_kernel`` in interpret mode;
the autograd function (gradcheck in float64); the dispatch, the wrappers'
checks, and (on a card) the CUDA kernels against the plain versions.

Tolerances: float32 atol 1e-5 (same math, sums in another order); bf16
inputs relative L2 < 1e-2 forward and < 2e-2 backward at the encoder's
token counts, < 1e-2 backward at the kernel's tile edges (the
probabilities, dS and the outputs round to bf16, one bf16 ulp is 2^-8
relative, and a rounding may land either side; the backward chains two
such roundings).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from theia_tpu.ops import attention as jattn
from theia_tpu_torch.ops import attention as tattn

H, HD = 3, 64
TOKENS = (196, 197, 204)  # nocls, cls, reg (7 registers)
# the bf16 kernel's tile edges: its key chunks of 64 (one key, one short of a
# chunk, a whole one, one past) and its limit of 256; head dims 16, 64 (the
# main path's), 80 (a partial 64-column atom) and 128
EDGE_TOKENS = (1, 63, 64, 65, 256)
EDGE_HEAD_DIMS = (16, 64, 80, 128)
# the float32 kernel's tile edges: its 8-key tiles and 16-row groups (one
# short of a group, a whole one, one past) and its row blocks (one past
# 128); and its largest staging: Q, K and V whole at hd 96, T = 197 and hd
# 128, T = 153, and V restaged into K's place at hd 128, T = 256 (past 184)
F32_EDGE_CASES = ((15, 64), (16, 64), (17, 64), (15, 128), (129, 16), (153, 128), (256, 128), (197, 96))
# the card's sweep: every head dim the kernel takes, T at those edges and at
# the encoder's token counts
SWEEP_TOKENS = (1, 15, 16, 17, 63, 64, 65, 128, 129, 197, 204, 255, 256)
# the backward's tile edges: its 8-key (8-query) tiles and 16-row warps (one
# token, one short of a tile, whole ones, one past) and its limit of 256;
# head dims 16, 64 (the main path's), 80 and 128 (float32: the column pass
# in two sweeps)
BWD_EDGE_TOKENS = (1, 15, 16, 17, 64, 65, 256)
# the bf16 backward's wgmma tiles: 64 query rows a row-pass block and 64-key
# chunks (one short of a tile, two whole ones, one past, and the last block
# of 1 live row), and 32-query steps of the column pass (193 = 6 steps and
# one query); head dims 32 (a part-empty swizzle atom) and 128 (two)
BWD_BF16_TILE_TOKENS = (63, 128, 129, 193)
BWD_BF16_TILE_HEAD_DIMS = (32, 128)
# the card's sweep of the backward, and the largest T whose float32 passes
# fit a block's 227 KB (csrc/mha_bwd.cu smem_bytes_f32)
BWD_SWEEP_TOKENS = (1, 8, 15, 16, 17, 63, 64, 65, 130, 197, 255, 256)
BWD_F32_MAX_T = {112: 240, 128: 216}


def _qkv(t, b=2, h=H, hd=HD, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, hd), dtype=np.float32) for _ in range(3)]


def _pack(x):  # [B,T,H,hd] -> [B*H,T,hd], the Pallas kernel's layout
    b, t, h, hd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, hd))


def _unpack(x, b):  # [B*H,T,hd] -> [B,T,H,hd]
    bh, t, hd = x.shape
    return x.reshape(b, bh // b, t, hd).transpose(0, 2, 1, 3)


def _pallas_kernel_interpret(q, k, v):
    """The TPU kernel body on the CPU: one grid cell per (batch*head)."""
    bh, t, hd = q.shape
    spec = pl.BlockSpec((1, t, hd), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(jattn._mha_fwd_kernel, scale=1.0 / math.sqrt(hd)),
        grid=(bh,),
        in_specs=[spec] * 3,
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        interpret=True,
    )(q, k, v)


def _pallas_bwd_interpret(q, k, v, do):
    """The TPU backward kernel body on the CPU: one grid cell per (batch*head)."""
    bh, t, hd = q.shape
    spec = pl.BlockSpec((1, t, hd), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(jattn._mha_bwd_kernel, scale=1.0 / math.sqrt(hd)),
        grid=(bh,),
        in_specs=[spec] * 4,
        out_specs=(spec, spec, spec),
        out_shape=tuple(jax.ShapeDtypeStruct(q.shape, q.dtype) for _ in range(3)),
        interpret=True,
    )(q, k, v, do)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("t", TOKENS)
def test_plain_matches_jax_einsum_f32(t):
    q, k, v = _qkv(t)
    want = np.asarray(jattn._einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.float32))
    got = tattn.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), implementation="einsum"
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", TOKENS)
def test_plain_matches_pallas_kernel_f32(t):
    q, k, v = _qkv(t, seed=1)
    packed = (jnp.asarray(_pack(x)) for x in (q, k, v))
    want = _unpack(np.asarray(_pallas_kernel_interpret(*packed)), b=2)
    got = tattn.mha_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", TOKENS)
def test_plain_matches_both_references_bf16(t):
    q, k, v = _qkv(t, seed=2)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (_bf16(x) for x in (q, k, v))
    got = tattn.multi_head_attention(tq, tk, tv, implementation="einsum")
    assert got.dtype == torch.bfloat16
    want = jattn._einsum_attention(jq, jk, jv, jnp.bfloat16)
    assert _rel_l2(got.float().numpy(), np.asarray(want, np.float32)) < 1e-2

    packed = [jnp.asarray(_pack(x), jnp.bfloat16) for x in (q, k, v)]
    want_kernel = _unpack(np.asarray(_pallas_kernel_interpret(*packed), np.float32), b=2)
    got_kernel_path = tattn.mha_fwd(tq, tk, tv)
    assert _rel_l2(got_kernel_path.float().numpy(), want_kernel) < 1e-2


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("hd", EDGE_HEAD_DIMS)
@pytest.mark.parametrize("t", EDGE_TOKENS)
def test_plain_matches_pallas_kernel_at_tile_edges(t, hd, dtype):
    """The reference the card holds the kernel to (``mha_fwd`` on CPU
    tensors) against the TPU kernel body in interpret mode, at the shapes
    where the kernel's tiles end."""
    q, k, v = _qkv(t, b=1, h=2, hd=hd, seed=13)
    if dtype == "float32":
        want = _pallas_kernel_interpret(*(jnp.asarray(_pack(x)) for x in (q, k, v)))
        got = tattn.mha_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
        np.testing.assert_allclose(got.numpy(), _unpack(np.asarray(want), b=1), atol=1e-5, rtol=0)
    else:
        want = _pallas_kernel_interpret(*(jnp.asarray(_pack(x), jnp.bfloat16) for x in (q, k, v)))
        got = tattn.mha_fwd(*(_bf16(x) for x in (q, k, v)))
        assert got.dtype == torch.bfloat16
        assert _rel_l2(got.float().numpy(), _unpack(np.asarray(want, np.float32), b=1)) < 1e-2


@pytest.mark.parametrize("t, hd", F32_EDGE_CASES)
def test_plain_matches_pallas_kernel_f32_at_the_3xtf32_kernels_edges(t, hd):
    """The float32 reference the card holds the kernel to, against the TPU
    kernel body in interpret mode, at the float32 kernel's tile edges and at
    the shapes where its staging changes or which it newly takes."""
    q, k, v = _qkv(t, b=1, h=2, hd=hd, seed=17)
    want = _pallas_kernel_interpret(*(jnp.asarray(_pack(x)) for x in (q, k, v)))
    got = tattn.mha_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), _unpack(np.asarray(want), b=1), atol=1e-5, rtol=0)


def test_dispatch_on_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(197, seed=3))
    before = tattn.MHA_FWD_LAUNCHES, tattn.FLASH_FWD_LAUNCHES
    pallas = tattn.multi_head_attention(q, k, v, implementation="pallas")
    einsum = tattn.multi_head_attention(q, k, v, implementation="einsum")
    assert pallas.shape == q.shape
    torch.testing.assert_close(pallas, einsum, atol=1e-6, rtol=0)
    flash = tattn.multi_head_attention(q, k, v, implementation="flash")
    torch.testing.assert_close(flash, einsum, atol=1e-6, rtol=0)
    assert (tattn.MHA_FWD_LAUNCHES, tattn.FLASH_FWD_LAUNCHES) == before  # CPU tensors never reach a kernel
    with pytest.raises(ValueError, match="unknown attention"):
        tattn.multi_head_attention(q, k, v, implementation="xla")


@pytest.mark.parametrize(
    "shape, dtype, err",
    [
        ((2, 197, 3, 64), torch.float16, TypeError),
        ((2, 300, 3, 64), torch.float32, ValueError),
        ((2, 197, 3, 60), torch.float32, ValueError),
        ((2, 197, 3, 40), torch.bfloat16, ValueError),
        ((2, 197, 3, 256), torch.float32, ValueError),
        ((6, 197, 64), torch.float32, ValueError),
    ],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(shape, dtype, err):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(err):
        tattn._check_kernel_inputs(q, q, q)


@pytest.mark.parametrize("b, t", [(1, 197), (2, 197), (2, 1), (1, 1)])
def test_kernel_takes_views_into_the_packed_projection(b, t):
    """The encoder hands the kernel q, k, v as views of its packed QKV
    projection [B, T, 3*H*hd]; those must pass the checks without a copy,
    whatever stride torch gives a dimension of size 1."""
    qkv = torch.randn(b, t, 3 * H * HD)
    q, k, v = (y.view(b, t, H, HD) for y in qkv.split(H * HD, dim=-1))
    tattn._check_kernel_inputs(q, k, v)
    tattn._check_kernel_inputs(*(torch.randn(b, t, H, HD) for _ in range(3)))
    assert tattn._outer_strides(q) == (t * 3 * H * HD if b > 1 else 0, 3 * H * HD if t > 1 else 0)


def test_kernel_wrapper_rejects_strided_inputs():
    q = torch.zeros(2, H, 197, HD).transpose(1, 2)  # heads not hd apart
    with pytest.raises(ValueError, match="strides"):
        tattn._check_kernel_inputs(q, q, q)


@pytest.mark.parametrize("t", TOKENS)
def test_bwd_plain_matches_jax_vjp_f32(t):
    q, k, v = _qkv(t, seed=5)
    do = np.random.default_rng(6).standard_normal(q.shape, dtype=np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jattn._einsum_attention(a, b, c, jnp.float32), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = tattn.mha_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, do)))
    assert tuple(got.shape) == (2, t, 3, H, HD)
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[:, :, i].numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", TOKENS)
def test_bwd_plain_matches_pallas_kernel_f32(t):
    q, k, v = _qkv(t, seed=7)
    do = np.random.default_rng(8).standard_normal(q.shape, dtype=np.float32)
    want = _pallas_bwd_interpret(*(jnp.asarray(_pack(x)) for x in (q, k, v, do)))
    got = tattn.mha_bwd(*(torch.from_numpy(x) for x in (q, k, v, do)))
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[:, :, i].numpy(), _unpack(np.asarray(w), b=2), atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", TOKENS)
def test_bwd_plain_matches_pallas_kernel_bf16(t):
    q, k, v = _qkv(t, seed=9)
    do = np.random.default_rng(10).standard_normal(q.shape, dtype=np.float32)
    want = _pallas_bwd_interpret(*(jnp.asarray(_pack(x), jnp.bfloat16) for x in (q, k, v, do)))
    got = tattn.mha_bwd(*(_bf16(x) for x in (q, k, v, do)))
    assert got.dtype == torch.bfloat16
    for i, w in enumerate(want):
        assert _rel_l2(got[:, :, i].float().numpy(), _unpack(np.asarray(w, np.float32), b=2)) < 2e-2


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("hd", EDGE_HEAD_DIMS)
@pytest.mark.parametrize("t", BWD_EDGE_TOKENS)
def test_bwd_plain_matches_pallas_kernel_at_tile_edges(t, hd, dtype):
    """The reference the card holds the backward kernel to (``mha_bwd`` on
    CPU tensors) against the TPU kernel body in interpret mode, at the shapes
    where the kernel's tiles end. At T = 1, dQ and dK are exactly 0 on both
    sides (softmax over one key)."""
    q, k, v = _qkv(t, b=1, h=2, hd=hd, seed=14)
    do = np.random.default_rng(15).standard_normal(q.shape, dtype=np.float32)
    if dtype == "float32":
        want = _pallas_bwd_interpret(*(jnp.asarray(_pack(x)) for x in (q, k, v, do)))
        got = tattn.mha_bwd(*(torch.from_numpy(x) for x in (q, k, v, do)))
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[:, :, i].numpy(), _unpack(np.asarray(w), b=1), atol=1e-5, rtol=0)
    else:
        want = _pallas_bwd_interpret(*(jnp.asarray(_pack(x), jnp.bfloat16) for x in (q, k, v, do)))
        got = tattn.mha_bwd(*(_bf16(x) for x in (q, k, v, do)))
        assert got.dtype == torch.bfloat16
        for i, w in enumerate(want):
            g, w = got[:, :, i].float().numpy(), _unpack(np.asarray(w, np.float32), b=1)
            if not np.any(w):
                np.testing.assert_array_equal(g, w)
            else:
                assert _rel_l2(g, w) < 1e-2, (i, _rel_l2(g, w))


@pytest.mark.parametrize("hd", BWD_BF16_TILE_HEAD_DIMS)
@pytest.mark.parametrize("t", BWD_BF16_TILE_TOKENS)
def test_bwd_plain_matches_pallas_kernel_bf16_at_wgmma_tile_edges(t, hd):
    """The bf16 reference of the backward kernel (``mha_bwd`` on CPU
    tensors) against the TPU kernel body in interpret mode, at the shapes
    where the bf16 kernel's 64-row and 64-key wgmma tiles and its 32-query
    steps end."""
    q, k, v = _qkv(t, b=1, h=2, hd=hd, seed=16)
    do = np.random.default_rng(17).standard_normal(q.shape, dtype=np.float32)
    want = _pallas_bwd_interpret(*(jnp.asarray(_pack(x), jnp.bfloat16) for x in (q, k, v, do)))
    got = tattn.mha_bwd(*(_bf16(x) for x in (q, k, v, do)))
    assert got.dtype == torch.bfloat16
    for i, w in enumerate(want):
        g, w = got[:, :, i].float().numpy(), _unpack(np.asarray(w, np.float32), b=1)
        assert _rel_l2(g, w) < 1e-2, (i, _rel_l2(g, w))


def test_autograd_function_gradcheck_f64():
    b, t, h, hd = 2, 5, 2, 16
    qkv = torch.randn(b, t, 3 * h * hd, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    qkv.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: tattn.MHAFunction.apply(x, h), (qkv,))


def test_autograd_function_matches_autodiff_of_plain():
    """MHAFunction's gradient (the plain backward on CPU) equals autograd
    through the plain forward, on views into a packed projection."""
    b, t, h, hd = 2, 197, 3, 64
    qkv = torch.randn(b, t, 3 * h * hd, generator=torch.Generator().manual_seed(1), requires_grad=True)
    g = torch.randn(b, t, h * hd, generator=torch.Generator().manual_seed(2))
    out = tattn.packed_attention(qkv, h)
    (got,) = torch.autograd.grad(out, qkv, g)
    out_plain = tattn.packed_attention(qkv, h, implementation="einsum")
    (want,) = torch.autograd.grad(out_plain, qkv, g)
    torch.testing.assert_close(out, out_plain, atol=1e-6, rtol=0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_mha_fwd_refuses_to_drop_gradients():
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv(197, seed=11))
    with pytest.raises(RuntimeError, match="MHAFunction"):
        tattn.mha_fwd(q, k, v)
    with torch.no_grad():
        assert tattn.mha_fwd(q, k, v).shape == q.shape


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t", (197, 204))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_kernel_matches_plain(cuda, t, dtype):
    qkv = torch.randn(4, t, 3 * 12 * HD, generator=torch.Generator().manual_seed(4)).to(cuda, dtype)
    q, k, v = (y.view(4, t, 12, HD) for y in qkv.split(12 * HD, dim=-1))
    before = tattn.MHA_FWD_LAUNCHES
    got = tattn.mha_fwd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.MHA_FWD_LAUNCHES == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, tattn.mha_fwd_plain(q, k, v), atol=2e-5, rtol=0)
    else:
        want = tattn.mha_fwd_plain(q.float(), k.float(), v.float())
        assert _rel_l2(got.float().cpu().numpy(), want.cpu().numpy()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("hd", range(16, 129, 16))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_kernel_matches_plain_over_the_sweep(cuda, dtype, hd):
    """K1 against its plain version at every head dim and every T of the
    sweep, on views of a packed projection."""
    gen = torch.Generator().manual_seed(hd)
    for t in SWEEP_TOKENS:
        qkv = torch.randn(2, t, 3 * 2 * hd, generator=gen).to(cuda, dtype)
        q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
        before = tattn.MHA_FWD_LAUNCHES
        got = tattn.mha_fwd(q, k, v)
        torch.cuda.synchronize()
        assert tattn.MHA_FWD_LAUNCHES == before + 1
        want = tattn.mha_fwd_plain(q.float(), k.float(), v.float())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        else:
            assert _rel_l2(got.float().cpu().numpy(), want.cpu().numpy()) < 1e-2, (t, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", (64, 128))
@pytest.mark.parametrize("t", (197, 256))
def test_cuda_kernel_bf16_with_vanishing_probabilities(cuda, t, hd):
    """Scores spread over hundreds, so that some p = exp(S - max) fall below
    2^-90 and the bf16 kernel takes the IEEE division for their rows."""
    qkv = torch.randn(2, t, 3 * 2 * hd, generator=torch.Generator().manual_seed(t + hd))
    qkv[..., : 2 * hd] *= 40
    q, k, v = (y.view(2, t, 2, hd) for y in qkv.to(cuda, torch.bfloat16).split(2 * hd, dim=-1))
    got = tattn.mha_fwd(q, k, v)
    want = tattn.mha_fwd_plain(q.float(), k.float(), v.float())
    assert _rel_l2(got.float().cpu().numpy(), want.cpu().numpy()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("hd", (16, 64))
@pytest.mark.parametrize("t", (197, 256))
def test_cuda_kernel_f32_with_vanishing_probabilities(cuda, t, hd):
    """Integer Q and K: scores spread over hundreds, so that some p fall
    below 2^-90 and the float32 kernel takes the IEEE division for their
    rows; S is exact in both versions (the scale is a power of two), so only
    the softmax's roundings differ."""
    gen = torch.Generator().manual_seed(t + hd)
    qk = torch.randint(-8, 9, (2, t, 2 * 2 * hd), generator=gen).float()
    qkv = torch.cat([qk, torch.randn(2, t, 2 * hd, generator=gen)], dim=-1).to(cuda)
    q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
    torch.testing.assert_close(tattn.mha_fwd(q, k, v), tattn.mha_fwd_plain(q, k, v), atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_cuda_kernel_f32_takes_what_passes_its_shared_memory(cuda):
    """float32 [2, 256, 1, 128]: Q, K and V whole would pass a block's 227 KB
    of shared memory; the kernel restages V into K's place and matches the
    plain version."""
    q, k, v = torch.randn(3, 2, 256, 1, 128, generator=torch.Generator().manual_seed(5)).to(cuda).unbind(0)
    got = tattn.mha_fwd(q, k, v)
    torch.testing.assert_close(got, tattn.mha_fwd_plain(q, k, v), atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("t", (197, 204))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_bwd_kernel_matches_plain(cuda, t, dtype):
    gen = torch.Generator().manual_seed(12)
    qkv = torch.randn(4, t, 3 * 12 * HD, generator=gen).to(cuda, dtype)
    q, k, v = (y.view(4, t, 12, HD) for y in qkv.split(12 * HD, dim=-1))
    do = torch.randn(4, t, 12, HD, generator=gen).to(cuda, dtype)
    before = tattn.MHA_BWD_LAUNCHES
    got = tattn.mha_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert tattn.MHA_BWD_LAUNCHES == before + 1
    want = tattn.mha_bwd_plain(q, k, v, do)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        assert _rel_l2(got.float().cpu().numpy(), want.float().cpu().numpy()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("hd", range(16, 129, 16))
def test_cuda_bwd_kernel_f32_matches_plain_over_the_sweep(cuda, hd):
    """K2 float32 (3xTF32) against its plain version at every head dim and
    every T of the sweep, on views of a packed projection; a shape past the
    passes' shared memory raises."""
    gen = torch.Generator().manual_seed(100 + hd)
    for t in BWD_SWEEP_TOKENS:
        qkv = torch.randn(2, t, 3 * 2 * hd, generator=gen).to(cuda)
        q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
        do = torch.randn(2, t, 2, hd, generator=gen).to(cuda)
        if t > BWD_F32_MAX_T.get(hd, t):
            with pytest.raises(RuntimeError, match="launch failed"):
                tattn.mha_bwd(q, k, v, do)
            continue
        before = tattn.MHA_BWD_LAUNCHES
        got = tattn.mha_bwd(q, k, v, do)
        torch.cuda.synchronize()
        assert tattn.MHA_BWD_LAUNCHES == before + 1
        torch.testing.assert_close(got, tattn.mha_bwd_plain(q, k, v, do), atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", range(16, 129, 16))
def test_cuda_bwd_kernel_bf16_matches_plain_over_the_sweep(cuda, hd):
    """K2 bf16 (wgmma) against its plain version at every head dim and every
    T of the sweep, on views of a packed projection: relative L2 below 1e-2
    (P and dS round to bf16 before their products; a rounding may land
    either side), one launch a call."""
    gen = torch.Generator().manual_seed(200 + hd)
    for t in BWD_SWEEP_TOKENS:
        qkv = torch.randn(2, t, 3 * 2 * hd, generator=gen).to(cuda, torch.bfloat16)
        q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
        do = torch.randn(2, t, 2, hd, generator=gen).to(cuda, torch.bfloat16)
        before = tattn.MHA_BWD_LAUNCHES
        got = tattn.mha_bwd(q, k, v, do)
        torch.cuda.synchronize()
        assert tattn.MHA_BWD_LAUNCHES == before + 1
        want = tattn.mha_bwd_plain(q, k, v, do)
        assert _rel_l2(got.float().cpu().numpy(), want.float().cpu().numpy()) < 1e-2, (t, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", (64, 128))
@pytest.mark.parametrize("t", (197, 256))
def test_cuda_bwd_kernel_bf16_with_vanishing_probabilities(cuda, t, hd):
    """Scores spread over hundreds, so that some p = exp(S - max) fall below
    2^-90 and both bf16 passes take the IEEE division for them."""
    gen = torch.Generator().manual_seed(300 + t + hd)
    qkv = torch.randn(2, t, 3 * 2 * hd, generator=gen)
    qkv[..., : 2 * hd] *= 40
    q, k, v = (y.view(2, t, 2, hd) for y in qkv.to(cuda, torch.bfloat16).split(2 * hd, dim=-1))
    do = torch.randn(2, t, 2, hd, generator=gen).to(cuda, torch.bfloat16)
    got = tattn.mha_bwd(q, k, v, do)
    want = tattn.mha_bwd_plain(q, k, v, do)
    assert _rel_l2(got.float().cpu().numpy(), want.float().cpu().numpy()) < 1e-2
