"""The fused distillation-loss reductions: the CUDA kernels K5 and K6 and their plain versions.

Port of theia_tpu/ops/fused_loss.py. Per teacher the loss needs five
per-sample float32 sums over the flattened features, Σ(p−t)², Σ smoothL1(p−t;
β), Σp·t, Σp², Σt² (mse, smoothL1 and the cosine are scalar functions of
them). ``LossSums`` is the ``loss_sums`` custom_vjp: its forward is
``loss_sums_fwd`` (K5, ``csrc/fused_loss.cu``, replacing ``_fwd_kernel``),
one pass over pred and target; its backward ``loss_sums_bwd`` (K6,
replacing ``_bwd_kernel``), one more pass that writes d pred (the target
gets no gradient). On CPU tensors both run their plain versions.

Inputs are [B, D] with D contiguous and rows D apart (``flat_rows`` makes
them so). pred and target may differ in dtype, float32 or bf16 each; all
arithmetic is float32 (a bf16 input is read as the float32 value it
converts to exactly), and d pred comes back in pred's dtype. Unlike the
TPU kernel, any B >= 1 and D >= 1 are taken: no 128-lane tiling.
"""

from __future__ import annotations

import torch

# Launches of the CUDA kernels in this process; each is incremented only
# where its kernel is launched.
LOSS_SUMS_FWD_LAUNCHES = 0
LOSS_SUMS_BWD_LAUNCHES = 0
# Copies ``flat_rows`` made because a feature map was not laid out as
# contiguous rows (the loss section's hidden traffic, if any).
LOSS_INPUT_COPIES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
N_SUMS = 5


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or float64 where it is that (the plain math's dtype)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def flat_rows(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [B, D] with contiguous rows; a view where the memory
    allows it, else one copy, counted in ``LOSS_INPUT_COPIES``."""
    if not x.is_contiguous():
        global LOSS_INPUT_COPIES
        LOSS_INPUT_COPIES += 1
        x = x.contiguous()
    return x.view(x.shape[0], -1)


def loss_sums_plain(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """K5's function in plain PyTorch (the JAX ``loss_sums_reference``):
    [B, D] pred, target -> [B, 5] float32 (sq_diff, smooth_l1, dot, p_sq, t_sq)."""
    p, t = _acc(pred), _acc(target)
    d = p - t
    ad = d.abs()
    return torch.stack(
        [
            (d * d).sum(dim=1),
            torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta).sum(dim=1),
            (p * t).sum(dim=1),
            (p * p).sum(dim=1),
            (t * t).sum(dim=1),
        ],
        dim=1,
    )


def loss_sums_bwd_plain(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """K6's function in plain PyTorch: d pred = g₀·2(p−t) + g₁·clip((p−t)/β,
    −1, 1) + g₂·t + g₃·2p for g [B, 5], in pred's dtype (each operation
    rounded to float32 in this order, as the kernel computes it)."""
    p, t, gf = _acc(pred), _acc(target), _acc(g)
    d = p - t
    g0, g1, g2, g3 = (gf[:, i : i + 1] for i in range(4))
    dp = (g0 * 2.0) * d + g1 * torch.clamp(d / beta, -1.0, 1.0) + g2 * t + (g3 * 2.0) * p
    return dp.to(pred.dtype)


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _check_kernel_inputs(pred: torch.Tensor, target: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: float32 or bf16 [B, D]
    pred and target of one shape on one device, contiguous."""
    if target.device != pred.device:
        raise ValueError(f"pred and target on different devices: {pred.device}, {target.device}")
    if pred.dim() != 2 or target.shape != pred.shape or pred.numel() == 0:
        raise ValueError(f"the loss-sum kernels take pred and target [B, D] with B, D >= 1, got "
                         f"{tuple(pred.shape)}, {tuple(target.shape)}")
    if pred.dtype not in _DTYPE_CODES or target.dtype not in _DTYPE_CODES:
        raise TypeError(f"the loss-sum kernels take float32 or bfloat16, got {pred.dtype}, {target.dtype}")
    if not (pred.is_contiguous() and target.is_contiguous()):
        raise ValueError("the loss-sum kernels take contiguous [B, D] rows (see flat_rows)")


def _require_cuda(*xs: torch.Tensor) -> None:
    if any(x.device.type != "cuda" for x in xs):
        raise ValueError(f"the loss-sum kernels run on CUDA tensors, got {[str(x.device) for x in xs]}")


def _raise_on(err: int, lib, what: str, pred: torch.Tensor, target: torch.Tensor) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed for {tuple(pred.shape)} {pred.dtype}/{target.dtype}: "
                           f"{lib.theia_cuda_error_string(err).decode()}")


def loss_sums_fwd(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """The five per-sample sums [B, 5] float32 of [B, D] pred and target.

    On CUDA tensors: K5, or a raise on inputs it does not take or on a
    failed launch. On CPU tensors: the plain version.
    """
    if _on_cpu(pred, target):
        return loss_sums_plain(pred, target, beta)
    _require_cuda(pred, target)
    _check_kernel_inputs(pred, target)
    from theia_tpu_torch.kernels import build

    lib = build.load()
    b, d = pred.shape
    part = torch.empty((b, lib.theia_loss_sums_partials(d), N_SUMS), dtype=torch.float32, device=pred.device)
    out = torch.empty((b, N_SUMS), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        err = lib.theia_loss_sums_fwd(
            pred.data_ptr(), target.data_ptr(), part.data_ptr(), out.data_ptr(), b, d,
            _DTYPE_CODES[pred.dtype], _DTYPE_CODES[target.dtype], beta, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib, "loss_sums_fwd", pred, target)
    global LOSS_SUMS_FWD_LAUNCHES
    LOSS_SUMS_FWD_LAUNCHES += 1
    return out


def loss_sums_bwd(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """d pred [B, D] in pred's dtype from the sums' cotangent g [B, 5].

    On CUDA tensors: K6, or a raise on inputs it does not take or on a
    failed launch. On CPU tensors: the plain version.
    """
    if _on_cpu(pred, target, g):
        return loss_sums_bwd_plain(pred, target, g, beta)
    _require_cuda(pred, target, g)
    _check_kernel_inputs(pred, target)
    if g.shape != (pred.shape[0], N_SUMS) or g.device != pred.device:
        raise ValueError(f"loss_sums_bwd needs g [B, 5] on {pred.device}, got {tuple(g.shape)} on {g.device}")
    g = g.float().contiguous()
    from theia_tpu_torch.kernels import build

    lib = build.load()
    b, d = pred.shape
    dp = torch.empty_like(pred)
    with torch.cuda.device(pred.device):
        err = lib.theia_loss_sums_bwd(
            pred.data_ptr(), target.data_ptr(), g.data_ptr(), dp.data_ptr(), b, d,
            _DTYPE_CODES[pred.dtype], _DTYPE_CODES[target.dtype], beta, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib, "loss_sums_bwd", pred, target)
    global LOSS_SUMS_BWD_LAUNCHES
    LOSS_SUMS_BWD_LAUNCHES += 1
    return dp


class LossSums(torch.autograd.Function):
    """The ``loss_sums`` custom_vjp: ``apply(pred, target, beta)`` with
    [B, D] pred and target -> [B, 5] float32; K5 forward, K6 backward on
    CUDA tensors. Saves pred and target; the target gets no gradient."""

    @staticmethod
    def forward(ctx, pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
        ctx.beta = beta
        ctx.save_for_backward(pred, target)
        return loss_sums_fwd(pred, target, beta)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        pred, target = ctx.saved_tensors
        return loss_sums_bwd(pred, target, g, ctx.beta), None, None
