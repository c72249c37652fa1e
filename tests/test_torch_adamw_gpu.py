"""K10, the masked AdamW step in one launch (``csrc/adamw.cu``), on the card
against its plain version ``MaskedAdamW.update_plain`` run on copies of the
same tensors: bit for bit (``torch.equal``, NaN where both are NaN) over 6
steps at Theia-Base cddsv's 268 parameter shapes, for parameters, moments
and counts, with the recipe's strided gradients read in place; its bias
corrections against torch's ``1 - b**count``; no synchronize; one launch;
and the recipe step's gradients read in place. Needs a CUDA device; imports
no JAX, so it runs on the card's machine without the JAX-importing
conftest: ``python -m pytest --noconftest tests/test_torch_adamw_gpu.py``."""

import warnings

import pytest
import torch

from theia_tpu_torch.foundation.common import get_model_feature_size
from theia_tpu_torch.models.hub import TEACHER_SETS
from theia_tpu_torch.models.rvfm import Theia
from theia_tpu_torch.models.translators import head_key
from theia_tpu_torch.train import optim
from theia_tpu_torch.train.state import TrainState
from theia_tpu_torch.train.step import make_train_step
from theia_tpu_torch.utils import profiling

BASE = "facebook/deit-base-patch16-224"
TEACHERS = {t: get_model_feature_size(t, keep_spatial=True) for t in TEACHER_SETS["cddsv"]}
STEPS = 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _base(dtype=torch.float32, **kw) -> Theia:
    with torch.device("meta"):
        return Theia(backbone=BASE, translator="lconv", target_feature_sizes=TEACHERS, dtype=dtype, **kw)


def _tensors(device, dtype, gen):
    """Base's 268 parameters, drawn, plus a 1-element, an empty and two odd
    tensors and one whose address is 4 bytes off 16-byte alignment (a view)."""
    params = {n: torch.randn(p.shape, generator=gen, device=device).mul_(0.05).to(dtype)
              for n, p in _base().named_parameters()}
    params["extra.one"] = torch.randn(1, generator=gen, device=device).to(dtype)
    params["extra.empty.weight"] = torch.empty(0, 3, device=device, dtype=dtype)
    params["extra.odd.weight"] = torch.randn(5, 819, generator=gen, device=device).to(dtype)
    params["translator.extra.odd.bias"] = torch.randn(4097, generator=gen, device=device).to(dtype)
    buf = torch.randn(1 + 3 * 1001, generator=gen, device=device).to(dtype)
    params["extra.misaligned.weight"] = buf[1:].view(3, 1001)
    assert params["extra.misaligned.weight"].data_ptr() % 16
    return params


def _grads(params, gen, dtype):
    """Random grads laid out as the recipe's backward lays them out: a
    translator conv's weight gradient in channels_last memory (cuDNN's), the
    patch embedding's as [kh][c][o][kw] (a matmul over unfolded patches);
    and one 2-d grad transposed."""
    out = {}
    for n, p in params.items():
        g = torch.randn(p.shape, generator=gen, device=p.device).to(dtype)
        if p.dim() == 4 and n.startswith("translator."):
            g = g.contiguous(memory_format=torch.channels_last)
        elif "patch_embeddings" in n and p.dim() == 4:
            g = g.permute(2, 1, 0, 3).contiguous().permute(2, 1, 0, 3)
        elif n == "extra.odd.weight":
            g = g.t().contiguous().t()
        out[n] = g
    return out


def _masks(names, k, device, teacher_masks, freeze):
    """step.py's update mask at step k: a teacher's loss mask over its head,
    times the freeze mask (1 for steps 0-2, then 0) over the translator."""
    if not teacher_masks and not freeze:
        return None
    unfrozen = torch.tensor(float(k < 3), device=device) if freeze else None
    heads = {f"translator.translator_heads.{head_key(t)}.": torch.tensor(m, device=device)
             for t, m in teacher_masks.items()}
    mask = {}
    for n in names:
        if not n.startswith("translator."):
            continue
        m = unfrozen
        for prefix, hm in heads.items():
            if n.startswith(prefix):
                m = hm if m is None else m * hm
        if m is not None:
            mask[n] = m
    return mask


def _same(a, b) -> bool:
    """Equal, NaN where both are NaN: with bf16 storage b2 = 0.999 rounds
    to 1, so 1 - b2**count is 0 and an exactly zero grad (randn draws some
    among 188M) makes nu / 0 = 0/0, in the plain loop as in K10."""
    return torch.equal(a, b) or bool(((a == b) | (a.isnan() & b.isnan())).all())


def _differ(name, a, b) -> str:
    """How many elements of a and b differ, and the first few, for a failure's message."""
    bad = (~((a == b) | (a.isnan() & b.isnan()))).flatten().nonzero().flatten()
    i = bad[:4]
    return (f"{name}: {bad.numel()} of {a.numel()} differ, at {i.tolist()}: {a.flatten()[i].float().tolist()} "
            f"against {b.flatten()[i].float().tolist()}")


def _teacher_masks(teachers):
    return {t: float(i % 2) for i, t in enumerate(teachers)}  # 0, 1, 0, 1, 0


CASES = {
    "recipe": dict(),
    "float32_moments": dict(moment_dtype=torch.float32),
    "bf16_storage": dict(dtype=torch.bfloat16),
    "bf16_storage_float32_moments": dict(dtype=torch.bfloat16, moment_dtype=torch.float32),
    "bf16_storage_host_lr": dict(dtype=torch.bfloat16, host_lr=True, masked=True),
    "translator_factor": dict(translator_lr_factor=0.5),
    "masked": dict(masked=True, freeze=True),
    "masked_bf16_storage": dict(dtype=torch.bfloat16, masked=True, freeze=True, translator_lr_factor=0.5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_k10_equals_the_plain_loop(cuda, case):
    kw = CASES[case]
    dtype = kw.get("dtype", torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = _tensors(cuda, dtype, gen)
    plain = {n: p.clone() for n, p in params.items()}
    lr = 2e-3 if kw.get("host_lr") else optim.constant_with_warmup(2e-3, 3)
    tx = optim.make_optimizer(lr, weight_decay=0.01, translator_lr_factor=kw.get("translator_lr_factor", 1.0),
                              moment_dtype=kw.get("moment_dtype", torch.bfloat16))
    state, plain_state = tx.init(params), tx.init(plain)
    teacher_masks = _teacher_masks(TEACHERS) if kw.get("masked") else {}
    launches = optim.ADAMW_FUSED_LAUNCHES
    for k in range(STEPS):
        grads = _grads(params, gen, dtype)
        mask = _masks(list(params), k, cuda, teacher_masks, kw.get("freeze", False))
        tx.update(grads, state, params, mask=mask)
        tx.update_plain(grads, plain_state, plain, mask=mask)
    torch.cuda.synchronize()
    assert optim.ADAMW_FUSED_LAUNCHES - launches == STEPS
    masked = [n for n in params if kw.get("masked") and n.startswith("translator.translator_heads.")
              and any(n.startswith(f"translator.translator_heads.{head_key(t)}.") and not m
                      for t, m in teacher_masks.items())]
    assert not kw.get("masked") or masked
    for n in params:
        for what, got, want in (("p", params[n], plain[n]), ("mu", state.mu[n], plain_state.mu[n]),
                                ("nu", state.nu[n], plain_state.nu[n])):
            assert _same(got, want), _differ(f"{n} {what}", got, want)
        assert int(state.count[n]) == int(plain_state.count[n]), n
    for n in masked:  # a teacher masked at every step: nothing moved
        assert int(state.count[n]) == 0 and not state.mu[n].any(), n
    assert int(state.sched_count) == int(plain_state.sched_count) == STEPS


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_corrections_match_torch(cuda, dtype):
    from theia_tpu_torch.kernels import build

    lib = build.load()
    count = torch.arange(1, 100_001, dtype=torch.int32, device=cuda)
    for b in (0.9, 0.999):
        got = torch.empty(count.shape, dtype=torch.float32, device=cuda)
        err = lib.theia_adamw_bias_corrections(count.data_ptr(), got.data_ptr(), count.numel(), b,
                                               0 if dtype == torch.float32 else 1,
                                               torch.cuda.current_stream().cuda_stream)
        assert err == 0
        want = torch.where(count > 0, 1.0 - b ** count.to(dtype), 1.0)
        assert torch.equal(got, want.float()), (b, dtype)


@pytest.mark.gpu
def test_update_makes_no_synchronize_and_one_launch(cuda):
    from theia_tpu_torch.tools.timing import device_ops

    gen = torch.Generator(device=cuda).manual_seed(1)
    params = {n: torch.randn(p.shape, generator=gen, device=cuda) for n, p in _base().named_parameters()}
    assert len(params) == 268
    tx = optim.make_optimizer(optim.constant_with_warmup(2e-3, 3), moment_dtype=torch.bfloat16)
    state = tx.init(params)
    grads = _grads(params, gen, torch.float32)
    mask = _masks(list(params), 0, cuda, _teacher_masks(TEACHERS), True)
    tx.update(grads, state, params, mask=mask)  # the build and the first launch outside the checks
    torch.cuda.synchronize()
    launches = optim.ADAMW_FUSED_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profiling.recording():
            tx.update(grads, state, params, mask=mask)
            tx.update(grads, state, params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert optim.ADAMW_FUSED_LAUNCHES - launches == 2
    ops = device_ops(lambda: tx.update(grads, state, params))
    k10 = {name: n for name, n in ops.items() if name.startswith("adamw_sm90")}
    assert list(k10.values()) == [1.0], ops
    assert sum(ops.values()) <= 16, ops  # K10, the schedule's few ops and sched_count += 1


@pytest.mark.gpu
def test_recipe_gradients_need_no_copy(cuda):
    """One recipe step of Theia-Base cddsv (bf16 compute over float32
    parameters, fast math, fused preprocessing, bf16 moments) at B = 2:
    every gradient reaches K10 contiguous or in a layout it gathers in
    place (K10 copies none: it raises on a grad it cannot gather)."""
    model = _base(dtype=torch.bfloat16, fast_math=True, fuse_preprocessing=True)
    model.to_empty(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=cuda) * 0.02 + float(n.endswith("norm.weight")))
    images = torch.randint(0, 256, (2, 224, 224, 3), dtype=torch.uint8, device=cuda, generator=gen)
    targets = {t: torch.randn((2, *s), generator=gen, device=cuda).to(torch.bfloat16) for t, s in TEACHERS.items()}
    tx = optim.make_optimizer(optim.constant_with_warmup(2e-3, 3), moment_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, main_loss="cos_l1")
    launches = optim.ADAMW_FUSED_LAUNCHES
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step(state, images, targets)
    torch.cuda.synchronize()
    assert optim.ADAMW_FUSED_LAUNCHES - launches == 1
