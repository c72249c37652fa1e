"""The port's flash attention against the JAX package: the plain versions of
K7 (forward), K9 (dQ) and K8 (dK, dV) against the TPU flash attention
library that ``theia_tpu.ops.attention._flash_attention`` calls, run on the
CPU in interpret mode, forward (O, and lse from the library's saved row
statistics) and ``jax.vjp``; against ``_einsum_attention``
at T = 785, where the reference's flash path refuses its block sizes; the
autograd function (gradcheck in float64); the dispatch, the wrappers'
checks, and (on a card) the CUDA kernels against the plain versions.

Tolerances: float32 atol 1e-5 (the same math, sums in another order, the
library's max and sum of one block against one pass here); bf16 inputs
relative L2 < 1e-2 forward and < 2e-2 backward (P, dS and the outputs round
to bf16, one bf16 ulp is 2^-8 relative, and a rounding may land either
side; the backward chains two such roundings), as tests/test_torch_attention.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as flash_library

from theia_tpu.ops import attention as jattn
from theia_tpu_torch.ops import attention as tattn

H, HD = 2, 64
COUNTERS = ("MHA_FWD_LAUNCHES", "MHA_BWD_LAUNCHES", "FLASH_FWD_LAUNCHES", "FLASH_DKV_LAUNCHES", "FLASH_DQ_LAUNCHES")


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _close(got, want, dtype, rel):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert _rel_l2(got, want) < rel


@pytest.mark.parametrize("t, dtype", [(197, "float32"), (401, "float32"), (197, "bfloat16"), (401, "bfloat16")])
def test_plain_matches_the_tpu_flash_kernels_in_interpret_mode(t, dtype):
    """Forward and jax.vjp of the reference's flash path, its Pallas kernels
    run in interpret mode (T padded to 256 and 512, one block each)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    q, k, v, do = _arrays((1, t, H, HD), 4, seed=t)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a, b, c: jattn._flash_attention(a, b, c, jdt),
                            *(jnp.asarray(x, jdt) for x in (q, k, v)))
        want_grads = vjp(jnp.asarray(do, jdt))
    tq, tk, tv, tdo = (_torch(x, tdt) for x in (q, k, v, do))
    o, lse = tattn.flash_fwd_plain(tq, tk, tv)
    assert o.dtype == tdt and lse.dtype == torch.float32 and tuple(lse.shape) == (H, t)
    _close(o, want, tdt, 1e-2)
    grads = tattn.flash_bwd_plain(tq, tk, tv, o, lse, tdo)
    assert grads.dtype == tdt and tuple(grads.shape) == (1, t, 3, H, HD)
    for i, w in enumerate(want_grads):
        _close(grads[:, :, i], w, tdt, 2e-2)
    # di comes from the output, in K7's [B*H, T] layout
    _, di = tattn.flash_dq_plain(tq, tk, tv, o, lse, tdo)
    want_di = (o.float() * tdo.float()).sum(-1).transpose(1, 2).reshape(H, t)
    torch.testing.assert_close(di, want_di, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hd", (16, 80, 128))
@pytest.mark.parametrize("t", (1, 65, 130))
def test_plain_backward_matches_the_tpu_flash_kernels_across_head_dims(t, hd):
    """The float32 flash backward (K9's and K8's plain versions) against
    jax.vjp of the reference's flash path in interpret mode, at head dims
    beside 64 and at T = 1 (dQ and dK exactly 0), one past a 64-row tile and
    two tiles and two rows: the shapes the float32 kernels are held to on the
    card."""
    q, k, v, do = _arrays((1, t, H, hd), 4, seed=t * 1000 + hd)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a, b, c: jattn._flash_attention(a, b, c, jnp.float32), *map(jnp.asarray, (q, k, v)))
        want_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tattn.flash_fwd_plain(tq, tk, tv)
    _close(o, want, torch.float32, None)
    grads = tattn.flash_bwd_plain(tq, tk, tv, o, lse, tdo)
    for i, w in enumerate(want_grads):
        _close(grads[:, :, i], w, torch.float32, None)


def _library_o_lse(q, k, v, monkeypatch, dtype=jnp.float32):
    """O of the reference's flash path in interpret mode on inputs of
    ``dtype``, and lse = m + log(l) (float32) from the row statistics its
    library call keeps: the same call with ``save_residuals``, which returns
    O beside l and m."""
    saved = []

    def with_residuals(q, k, v, ab=None, segment_ids=None, *, causal=False, sm_scale=1.0, block_sizes=None,
                       debug=False):
        o, l, m = flash_library._flash_attention(q, k, v, ab, segment_ids, True, causal, sm_scale, block_sizes, debug)
        saved.append((l, m))
        return o

    monkeypatch.setattr(flash_library, "flash_attention", with_residuals)
    b, t, h, _ = q.shape
    with pltpu.force_tpu_interpret_mode():
        o = jattn._flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)), dtype)
    ((l, m),) = saved
    return np.asarray(o.astype(jnp.float32)), np.asarray((m + jnp.log(l))[:, :, :t]).reshape(b * h, t)


@pytest.mark.parametrize("hd", (32, 128))
@pytest.mark.parametrize("t", (15, 16, 63, 64))
def test_plain_forward_matches_the_tpu_flash_kernel_at_the_tile_edges(t, hd, monkeypatch):
    """The float32 flash forward's plain version (O and lse) against the
    reference's flash path in interpret mode at the edges of float32 K7's
    16-row groups and 64-key tiles, beside and at its widest head dim."""
    q, k, v = _arrays((1, t, H, hd), 3, seed=t * 1000 + hd + 7)
    want_o, want_lse = _library_o_lse(q, k, v, monkeypatch)
    o, lse = tattn.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)))
    _close(o, want_o, torch.float32, None)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t, hd", [(127, 64), (129, 128), (255, 128), (257, 64)])
def test_plain_bf16_forward_matches_the_tpu_flash_kernel_at_the_block_edges(t, hd, monkeypatch):
    """The bf16 flash forward's plain version (O and lse) against the
    reference's flash path in interpret mode, on bf16 inputs, at the edges
    of bf16 K7's 128-row blocks (one row short of and past one and two of
    them), at its main path's and widest head dims."""
    q, k, v = _arrays((1, t, H, hd), 3, seed=t * 1000 + hd + 11)
    want_o, want_lse = _library_o_lse(q, k, v, monkeypatch, jnp.bfloat16)
    o, lse = tattn.flash_fwd_plain(*(_torch(x, torch.bfloat16) for x in (q, k, v)))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(o, want_o, torch.bfloat16, 1e-2)
    assert _rel_l2(lse.numpy(), want_lse) <= 1e-5


@pytest.mark.parametrize("t, hd", [(127, 64), (129, 128), (255, 128), (257, 64)])
def test_plain_bf16_backward_matches_the_tpu_flash_kernels_at_the_block_edges(t, hd):
    """The bf16 flash backward's plain versions (K9's dQ, K8's dK and dV)
    against jax.vjp of the reference's flash path in interpret mode, on bf16
    inputs, at the edges of bf16 K9's 128-row blocks and K8's 128-key blocks
    (one row short of and past one and two of them; T = 257 pads to 384 in
    the reference), at the main path's and the widest head dims."""
    q, k, v, do = _arrays((1, t, H, hd), 4, seed=t * 1000 + hd + 13)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jattn._flash_attention(a, b, c, jnp.bfloat16),
                         *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        want_grads = vjp(jnp.asarray(do, jnp.bfloat16))
    tq, tk, tv, tdo = (_torch(x, torch.bfloat16) for x in (q, k, v, do))
    o, lse = tattn.flash_fwd_plain(tq, tk, tv)
    grads = tattn.flash_bwd_plain(tq, tk, tv, o, lse, tdo)
    assert grads.dtype == torch.bfloat16 and tuple(grads.shape) == (1, t, 3, H, hd)
    for i, w in enumerate(want_grads):
        _close(grads[:, :, i], w, torch.bfloat16, 2e-2)


def test_plain_matches_einsum_where_the_reference_flash_path_refuses():
    """T = 785 (448² images): the reference pads to 896 and asks for blocks of
    512, which its library refuses; the port's plain versions (and kernels)
    take any T and agree with ``_einsum_attention`` and its jax.vjp."""
    t = 785
    q, k, v, do = _arrays((1, t, H, HD), 4, seed=3)
    with pltpu.force_tpu_interpret_mode(), pytest.raises(ValueError, match="divisible by block_k_major=512"):
        jattn._flash_attention(*(jnp.asarray(x) for x in (q, k, v)), jnp.float32)
    want, vjp = jax.vjp(lambda a, b, c: jattn._einsum_attention(a, b, c, jnp.float32), *map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tattn.flash_fwd_plain(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    grads = tattn.flash_bwd_plain(tq, tk, tv, o, lse, tdo)
    for i, w in enumerate(vjp(jnp.asarray(do))):
        np.testing.assert_allclose(grads[:, :, i].numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_flash_function_gradcheck_f64():
    b, t, h, hd = 2, 5, 2, 16
    qkv = torch.randn(b, t, 3 * h * hd, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    qkv.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: tattn.FlashFunction.apply(x, h), (qkv,))


def test_flash_function_matches_autodiff_of_plain():
    """FlashFunction's gradient (the plain flash backward on CPU) equals
    autograd through the plain einsum forward, on views of a packed projection."""
    b, t, h, hd = 2, 197, 3, 64
    qkv = torch.randn(b, t, 3 * h * hd, generator=torch.Generator().manual_seed(1), requires_grad=True)
    g = torch.randn(b, t, h * hd, generator=torch.Generator().manual_seed(2))
    out = tattn.packed_attention(qkv, h, implementation="flash")
    (got,) = torch.autograd.grad(out, qkv, g)
    out_plain = tattn.packed_attention(qkv, h, implementation="einsum")
    (want,) = torch.autograd.grad(out_plain, qkv, g)
    torch.testing.assert_close(out, out_plain, atol=1e-6, rtol=0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _counts():
    return {name: getattr(tattn, name) for name in COUNTERS}


def test_dispatch_on_cpu_tensors(monkeypatch):
    """"flash" and, past K1's and K2's MAX_T, "pallas" take the flash route
    (the shape of the port's T > 256 gap: 448² images, T = 785); on CPU
    tensors that is the plain version, and no counter moves."""
    calls = []
    real = tattn.flash_fwd
    monkeypatch.setattr(tattn, "flash_fwd", lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    before = _counts()
    for t, impl in ((197, "flash"), (785, "flash"), (785, "pallas")):
        qkv = torch.randn(1, t, 3 * H * HD, generator=torch.Generator().manual_seed(t), requires_grad=True)
        got = tattn.packed_attention(qkv, H, implementation=impl)
        want = tattn.packed_attention(qkv, H, implementation="einsum")
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
        (g_got,) = torch.autograd.grad(got.sum(), qkv)
        (g_want,) = torch.autograd.grad(want.sum(), qkv)
        torch.testing.assert_close(g_got, g_want, atol=1e-5, rtol=0)
        with torch.no_grad():
            q, k, v = tattn._split_heads(qkv, H)
            torch.testing.assert_close(tattn.multi_head_attention(q, k, v, implementation=impl),
                                       tattn.mha_fwd_plain(q, k, v), atol=1e-6, rtol=0)
    assert calls == [(1, 197, H, HD), (1, 197, H, HD), (1, 785, H, HD), (1, 785, H, HD), (1, 785, H, HD),
                     (1, 785, H, HD)]
    calls.clear()
    with torch.no_grad():
        tattn.packed_attention(torch.randn(1, tattn.MAX_T, 3 * H * HD), H, implementation="pallas")
    assert calls == []  # K1/K2 keep T <= MAX_T
    assert _counts() == before  # CPU tensors never reach a kernel


@pytest.mark.parametrize(
    "shape, dtype, err",
    [
        ((2, 785, 2, 64), torch.float16, TypeError),
        ((2, 785, 2, 60), torch.float32, ValueError),
        ((2, 785, 2, 40), torch.bfloat16, ValueError),
        ((2, 785, 2, 256), torch.float32, ValueError),
        ((2, 0, 2, 64), torch.float32, ValueError),
        ((6, 785, 64), torch.float32, ValueError),
    ],
)
def test_flash_checks_reject_what_the_kernels_do_not_take(shape, dtype, err):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(err):
        tattn._check_kernel_inputs(q, q, q, max_t=None, what="flash_fwd")


def test_flash_checks_take_any_token_count_and_check_the_rest():
    for t in (1, 257, 785, 4096):
        qkv = torch.zeros(2, t, 3 * H * HD)
        q, k, v = tattn._split_heads(qkv, H)
        tattn._check_kernel_inputs(q, k, v, max_t=None, what="flash_fwd")
    with pytest.raises(ValueError, match="T <= 256"):
        tattn._check_kernel_inputs(q, k, v)  # K1's own limit stays
    lse = torch.zeros(2 * H, 4096)
    tattn._check_stats("lse", lse, q, "flash_dq")
    for bad in (lse[:, :-1], lse.double(), lse.t().contiguous().t(), torch.zeros(2, H, 4096)):
        with pytest.raises(ValueError, match="lse"):
            tattn._check_stats("lse", bad, q, "flash_dq")
    with pytest.raises(ValueError, match="do like q"):
        tattn._check_rows("do", torch.zeros(2, 4096, H, HD, dtype=torch.bfloat16), q, "flash_dq")
    with pytest.raises(ValueError, match="heads hd apart"):
        tattn._check_rows("do", torch.zeros(2, H, 4096, HD).transpose(1, 2), q, "flash_dq")


def test_flash_fwd_refuses_to_drop_gradients():
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _arrays((1, 300, H, HD), 3, seed=4))
    with pytest.raises(RuntimeError, match="FlashFunction"):
        tattn.flash_fwd(q, k, v)
    with torch.no_grad():
        o, lse = tattn.flash_fwd(q, k, v)
    assert o.shape == q.shape and o.is_contiguous() and tuple(lse.shape) == (H, 300)


def test_wrappers_write_into_given_outputs_on_cpu():
    """flash_dq and flash_dkv write into the slices of one packed gradient, as
    flash_bwd hands them on the card."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays((2, 70, H, HD), 4, seed=5))
    o, lse = tattn.flash_fwd(q, k, v)
    grads = torch.zeros(2, 70, 3, H, HD)
    dq, dk, dv = grads.unbind(2)
    _, di = tattn.flash_dq(q, k, v, o, lse, do, dq=dq)
    tattn.flash_dkv(q, k, v, lse, di, do, dk=dk, dv=dv)
    torch.testing.assert_close(grads, tattn.flash_bwd(q, k, v, o, lse, do), atol=0, rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t", (1, 197, 785))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cuda_kernels_match_plain(cuda, t, dtype):
    gen = torch.Generator().manual_seed(t)
    qkv = torch.randn(2, t, 3 * 12 * HD, generator=gen).to(cuda, dtype)
    q, k, v = (y.view(2, t, 12, HD) for y in qkv.split(12 * HD, dim=-1))
    do = torch.randn(2, t, 12, HD, generator=gen).to(cuda, dtype)
    before = _counts()
    o, lse = tattn.flash_fwd(q, k, v)
    grads = tattn.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    after = _counts()
    assert {n: after[n] - before[n] for n in COUNTERS} == {
        "MHA_FWD_LAUNCHES": 0, "MHA_BWD_LAUNCHES": 0, "FLASH_FWD_LAUNCHES": 1, "FLASH_DKV_LAUNCHES": 1,
        "FLASH_DQ_LAUNCHES": 1}
    want_o, want_lse = tattn.flash_fwd_plain(q, k, v)
    want = tattn.flash_bwd_plain(q, k, v, o, lse, do)
    if dtype == torch.float32:
        torch.testing.assert_close(o, want_o, atol=2e-5, rtol=0)
        torch.testing.assert_close(grads, want, atol=2e-5, rtol=0)
    else:
        assert _rel_l2(o.float().cpu(), want_o.float().cpu()) < 1e-2
        assert _rel_l2(grads.float().cpu(), want.float().cpu()) < 1e-2
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_cuda_pallas_past_max_t_runs_the_flash_kernels(cuda):
    qkv = torch.randn(1, 785, 3 * 12 * HD, device=cuda, requires_grad=True)
    before = _counts()
    tattn.packed_attention(qkv, 12, implementation="pallas").sum().backward()
    torch.cuda.synchronize()
    after = _counts()
    assert [after[n] - before[n] for n in COUNTERS] == [0, 0, 1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("t", (1, 15, 16, 17, 63, 64, 65, 130, 197, 257, 785))
@pytest.mark.parametrize("hd", (16, 32, 48, 64, 80, 96, 112, 128))
def test_cuda_float32_forward_kernel_matches_plain(cuda, hd, t):
    """Float32 K7 (3xTF32) against its plain version at every head dim and
    at the edges of its 16-row groups, 8-key tiles and 64-key tiles, on
    views of a packed projection; one launch a call."""
    gen = torch.Generator().manual_seed(hd * 1000 + t + 1)
    qkv = torch.randn(2, t, 3 * 2 * hd, generator=gen).to(cuda)
    q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
    before = _counts()
    o, lse = tattn.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    after = _counts()
    assert {n: after[n] - before[n] for n in COUNTERS} == {
        "MHA_FWD_LAUNCHES": 0, "MHA_BWD_LAUNCHES": 0, "FLASH_FWD_LAUNCHES": 1, "FLASH_DKV_LAUNCHES": 0,
        "FLASH_DQ_LAUNCHES": 0}
    want_o, want_lse = tattn.flash_fwd_plain(q, k, v)
    torch.testing.assert_close(o, want_o, atol=2e-5, rtol=0)
    assert _rel_l2(lse.cpu(), want_lse.cpu()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("t", (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 130, 197, 255, 256, 257, 785))
@pytest.mark.parametrize("hd", (16, 32, 48, 64, 80, 96, 112, 128))
def test_cuda_bf16_forward_kernel_matches_plain(cuda, hd, t):
    """bf16 K7 (wgmma) against its plain version at every head dim and at
    the edges of its 16-row warps, 64-row warpgroups, 64-key tiles and
    128-row blocks, on views of a packed projection: O within relative L2
    1e-2, lse within 1e-5; one launch a call."""
    gen = torch.Generator().manual_seed(hd * 1000 + t + 2)
    qkv = torch.randn(2, t, 3 * 2 * hd, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
    before = _counts()
    o, lse = tattn.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    after = _counts()
    assert {n: after[n] - before[n] for n in COUNTERS} == {
        "MHA_FWD_LAUNCHES": 0, "MHA_BWD_LAUNCHES": 0, "FLASH_FWD_LAUNCHES": 1, "FLASH_DKV_LAUNCHES": 0,
        "FLASH_DQ_LAUNCHES": 0}
    want_o, want_lse = tattn.flash_fwd_plain(q, k, v)
    assert _rel_l2(o.float().cpu(), want_o.float().cpu()) < 1e-2
    assert _rel_l2(lse.cpu(), want_lse.cpu()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("rising max", "scores x 40"))
@pytest.mark.parametrize("hd", (64, 128))
def test_cuda_bf16_forward_kernel_where_the_online_softmax_works_hardest(cuda, hd, case):
    """bf16 K7 at [2, 785, 2, hd] against its plain version: K scaled up
    along the keys (1x to ~12x), so that each 64-key tile raises the row
    maxima and rescales O and l; or Q scaled by 40, so that most p
    underflow to 0. O within relative L2 1e-2, lse within 1e-5."""
    t = 785
    qkv = torch.randn(2, t, 3 * 2 * hd, generator=torch.Generator().manual_seed(hd + len(case)))
    if case == "rising max":
        qkv[..., 2 * hd: 4 * hd] *= torch.linspace(1, t / 64, t)[None, :, None]
    else:
        qkv[..., : 2 * hd] *= 40
    q, k, v = (y.view(2, t, 2, hd) for y in qkv.to(cuda, torch.bfloat16).split(2 * hd, dim=-1))
    o, lse = tattn.flash_fwd(q, k, v)
    want_o, want_lse = tattn.flash_fwd_plain(q, k, v)
    assert _rel_l2(o.float().cpu(), want_o.float().cpu()) < 1e-2
    assert _rel_l2(lse.cpu(), want_lse.cpu()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("t", (1, 15, 16, 17, 63, 64, 65, 130, 197, 257, 785))
@pytest.mark.parametrize("hd", (16, 32, 48, 64, 80, 96, 112, 128))
def test_cuda_float32_backward_kernels_match_plain(cuda, hd, t):
    """Float32 K9 and K8 (3xTF32) against their plain versions at every head
    dim and at the edges of their 16-row groups, 8-column tiles and 64-row
    tiles, on views of a packed projection; one launch each."""
    gen = torch.Generator().manual_seed(hd * 1000 + t)
    qkv = torch.randn(2, t, 3 * 2 * hd, generator=gen).to(cuda)
    q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
    do = torch.randn(2, t, 2, hd, generator=gen).to(cuda)
    o, lse = tattn.flash_fwd(q, k, v)
    before = _counts()
    dq, di = tattn.flash_dq(q, k, v, o, lse, do)
    dk, dv = tattn.flash_dkv(q, k, v, lse, di, do)
    torch.cuda.synchronize()
    after = _counts()
    assert {n: after[n] - before[n] for n in COUNTERS} == {
        "MHA_FWD_LAUNCHES": 0, "MHA_BWD_LAUNCHES": 0, "FLASH_FWD_LAUNCHES": 0, "FLASH_DKV_LAUNCHES": 1,
        "FLASH_DQ_LAUNCHES": 1}
    want_dq, want_di = tattn.flash_dq_plain(q, k, v, o, lse, do)
    want_dk, want_dv = tattn.flash_dkv_plain(q, k, v, lse, di, do)
    assert float(want_di.norm()) == 0 or _rel_l2(di.cpu(), want_di.cpu()) <= 1e-5
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("t", (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 130, 197, 255, 256, 257, 785))
@pytest.mark.parametrize("hd", (16, 32, 48, 64, 80, 96, 112, 128))
def test_cuda_bf16_backward_kernels_match_plain(cuda, hd, t):
    """bf16 K9 and K8 (wgmma) against their plain versions at every head dim
    and at the edges of their 16-row warps, 64-row warpgroups, 64-key and
    32-query tiles and 128-row blocks, on views of a packed projection: dQ,
    dK and dV within relative L2 1e-2, di within 1e-5; one launch each."""
    gen = torch.Generator().manual_seed(hd * 1000 + t + 3)
    qkv = torch.randn(2, t, 3 * 2 * hd, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
    do = torch.randn(2, t, 2, hd, generator=gen).to(cuda, torch.bfloat16)
    o, lse = tattn.flash_fwd(q, k, v)
    before = _counts()
    dq, di = tattn.flash_dq(q, k, v, o, lse, do)
    dk, dv = tattn.flash_dkv(q, k, v, lse, di, do)
    torch.cuda.synchronize()
    after = _counts()
    assert {n: after[n] - before[n] for n in COUNTERS} == {
        "MHA_FWD_LAUNCHES": 0, "MHA_BWD_LAUNCHES": 0, "FLASH_FWD_LAUNCHES": 0, "FLASH_DKV_LAUNCHES": 1,
        "FLASH_DQ_LAUNCHES": 1}
    want_dq, want_di = tattn.flash_dq_plain(q, k, v, o, lse, do)
    want_dk, want_dv = tattn.flash_dkv_plain(q, k, v, lse, di, do)
    assert float(want_di.norm()) == 0 or _rel_l2(di.cpu(), want_di.cpu()) <= 1e-5
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        got, want = got.float().cpu(), want.float().cpu()
        # at T = 1 dQ and dK are 0 but for float32 rounding on both sides
        assert _rel_l2(got, want) < 1e-2 or float((got - want).abs().max()) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("rising max", "scores x 40"))
@pytest.mark.parametrize("hd", (64, 128))
def test_cuda_bf16_backward_kernels_where_p_and_ds_concentrate(cuda, hd, case):
    """bf16 K9 and K8 at [2, 785, 2, hd] against their plain versions, on
    K7's O and lse: K scaled up along the keys (1x to ~12x), or Q scaled by
    40, so that most p underflow to 0 and dS gathers on a few keys. dQ, dK
    and dV within relative L2 1e-2, di within 1e-5."""
    t = 785
    qkv = torch.randn(2, t, 3 * 2 * hd, generator=torch.Generator().manual_seed(hd + len(case) + 1))
    if case == "rising max":
        qkv[..., 2 * hd: 4 * hd] *= torch.linspace(1, t / 64, t)[None, :, None]
    else:
        qkv[..., : 2 * hd] *= 40
    q, k, v = (y.view(2, t, 2, hd) for y in qkv.to(cuda, torch.bfloat16).split(2 * hd, dim=-1))
    do = torch.randn(2, t, 2, hd, generator=torch.Generator().manual_seed(hd)).to(cuda, torch.bfloat16)
    o, lse = tattn.flash_fwd(q, k, v)
    dq, di = tattn.flash_dq(q, k, v, o, lse, do)
    dk, dv = tattn.flash_dkv(q, k, v, lse, di, do)
    want_dq, want_di = tattn.flash_dq_plain(q, k, v, o, lse, do)
    want_dk, want_dv = tattn.flash_dkv_plain(q, k, v, lse, di, do)
    assert _rel_l2(di.cpu(), want_di.cpu()) <= 1e-5
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert _rel_l2(got.float().cpu(), want.float().cpu()) < 1e-2
