"""K12, SAM's attention with its decomposed relative-position bias
(``csrc/relpos_attn.cu``), on the card against the plain version
``ops/attention.py`` ``relpos_attention_plain`` on the same packed projection:
rel L2 within 1e-5 at SAM-H's shapes at the extraction's batch of 32
([800, 196, 16, 80], the windows, and [32, 4096, 16, 80], the global layers)
and over a sweep of grids and head widths whose last key tile is partial,
one K12 launch a call among at most 8 kernels (the tables' two products),
bf16 sent to the plain version and grad refused, and, in the same process,
K1 and K7 float32 still within 2e-5 of their plain versions. Needs a CUDA device; imports no JAX, so it runs on the card's
machine without the JAX-importing conftest:
``python -m pytest --noconftest tests/test_torch_relpos_attn_gpu.py``."""

import pytest
import torch

from theia_tpu_torch.ops import attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(entries, side, heads, hd, device, seed=0):
    """A packed projection as the encoder's dense layer returns it and two
    tables, at SAM-H's magnitudes (q, k, v ~0.7, tables 0.1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = 0.7 * torch.randn(entries, side * side, 3 * heads * hd, generator=gen, device=device)
    rh = 0.1 * torch.randn(2 * side - 1, hd, generator=gen, device=device)
    rw = 0.1 * torch.randn(2 * side - 1, hd, generator=gen, device=device)
    return qkv, rh, rw


def _rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def _check(entries, side, heads, hd, device):
    qkv, rh, rw = _inputs(entries, side, heads, hd, device, seed=side * hd)
    before = attention.RELPOS_ATTN_LAUNCHES
    with torch.no_grad():
        got = attention.relpos_attention(qkv, rh, rw, heads, side)
        q, k, v = qkv.split(heads * hd, dim=-1)
        want = attention.relpos_attention_plain(q, k, v, rh, rw, heads, side, side, torch.float32)
    torch.cuda.synchronize()
    assert attention.RELPOS_ATTN_LAUNCHES == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    return _rel(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("entries, side", [(800, 14), (32, 64)], ids=["windows", "global"])
def test_k12_matches_the_plain_version_at_sam_h(cuda, entries, side):
    assert _check(entries, side, 16, 80, cuda) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("side", [1, 2, 7, 8, 9, 15, 23])
@pytest.mark.parametrize("hd", [16, 64, 80, 128])
def test_k12_over_grids_and_head_widths(cuda, side, hd):
    assert _check(3, side, 2, hd, cuda) <= 1e-5


@pytest.mark.gpu
def test_one_k12_launch_a_call(cuda):
    from theia_tpu_torch.tools.timing import device_ops

    qkv, rh, rw = _inputs(800, 14, 16, 80, cuda)
    with torch.no_grad():
        ops = device_ops(lambda: attention.relpos_attention(qkv, rh, rw, 16, 14))
    k12 = {name: n for name, n in ops.items() if "relpos_attn" in name}
    assert list(k12.values()) == [1.0], ops
    assert sum(ops.values()) <= 8, ops


@pytest.mark.gpu
def test_k12_refuses_bf16_and_grad(cuda):
    """K12 takes float32 alone: bf16 goes to the plain version, with no K12
    launch; an input that requires grad is refused."""
    qkv, rh, rw = _inputs(2, 4, 2, 16, cuda)
    x, th, tw = qkv.bfloat16(), rh.bfloat16(), rw.bfloat16()
    before = attention.RELPOS_ATTN_LAUNCHES
    got = attention.relpos_attention(x, th, tw, 2, 4)
    want = attention.relpos_attention_plain(*x.split(32, dim=-1), th, tw, 2, 4, 4, torch.bfloat16)
    assert attention.RELPOS_ATTN_LAUNCHES == before and torch.equal(got, want)
    with pytest.raises(RuntimeError):
        attention.relpos_attention(qkv.requires_grad_(), rh, rw, 2, 4)


@pytest.mark.gpu
def test_k1_and_k7_float32_unchanged(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    k7, k7_plain = (lambda *x: attention.flash_fwd(*x)[0]), (lambda *x: attention.flash_fwd_plain(*x)[0])
    for b, t, fn, plain in ((64, 197, attention.mha_fwd, attention.mha_fwd_plain), (16, 785, k7, k7_plain)):
        qkv = torch.randn(b, t, 3 * 768, generator=gen, device=cuda)
        q, k, v = (y.view(b, t, 12, 64) for y in qkv.split(768, dim=-1))
        with torch.no_grad():
            got, want = fn(q, k, v), plain(q, k, v)
        assert float((got - want).abs().max()) <= 2e-5
