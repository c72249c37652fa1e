"""LayerNormSpatial with a hand-written backward: the plain forward, the CUDA
kernels K3 and K4 and their plain version.

Port of theia_tpu/ops/ln_pallas.py:105-230 (``_fwd_impl``,
``_autodiff_bwd``, ``_bwd_kernels``, ``ln_spatial_pallas``). The layer
normalises each sample of an NCHW map over all of (C, H, W) with a
per-element (C, H, W) affine. ``LNSpatialFunction`` is the custom_vjp: the
forward is plain PyTorch and saves (x, weight, mean, r); the backward runs
``ln_bwd_stats`` (K3, ``csrc/ln_bwd.cu``, replacing ``_stats_kernel``) and
``ln_bwd_dx`` (K4, replacing ``_dx_kernel``) on CUDA tensors, and
``ln_spatial_bwd_plain`` (the math of ``_autodiff_bwd``) on CPU tensors.

The kernels read the maps in channels_last memory, [B, S = H*W, C] with C
contiguous, as the head ladders hold them; a gradient that arrives in
another memory format is copied into channels_last first. K3 and K4 are
one launch each: both read the weight in its own (C, H, W) layout, and K3
writes dw and db there, so autograd receives them in the parameter's
layout. Any C: where
C is a multiple of 8 the kernels move 16-byte vectors (the maps must then
be 16-byte aligned), else one element a thread (the policy heads' C = 60).

Tensor parallelism (``parallel/tp.py``): on a map whose channels are split
over a model group (``grid``), the forward's per-sample sums of x and x²
are all-reduced over the group before the mean and r, which are then the
whole sample's; in the backward K3 runs on the rank's slice, its s1 and s2
are all-reduced, and K4 divides by the whole sample's count N (its
``count`` argument), not by the slice's row length. dw and db are per
position and stay the rank's.
"""

from __future__ import annotations

from typing import Optional

import torch

from theia_tpu_torch.parallel.mesh import Grid
from theia_tpu_torch.parallel.tp import model_sum, sum_over_model

# Launches of the CUDA kernels in this process; each is incremented only
# where its kernel is launched.
LN_BWD_STATS_LAUNCHES = 0
LN_BWD_DX_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DIMS = (1, 2, 3)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or float64 where it is that (the plain math's dtype)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _count(x: torch.Tensor, grid: Optional[Grid]) -> int:
    """The whole sample's element count N: the row length, times the model
    group's size where the channels are split."""
    return x[0].numel() * (1 if grid is None else grid.n_model)


def ln_spatial_stats(x: torch.Tensor, eps: float, grid: Optional[Grid] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample float32 mean and r = rsqrt(var + eps) of an NCHW map, as
    [B, 1, 1, 1], with var = E[x²] − E[x]² (the JAX "vpu" numerics); with
    ``grid``, of the whole sample whose channels the model group splits."""
    acc = torch.promote_types(x.dtype, torch.float32)
    if grid is None:
        mean = x.mean(dim=_DIMS, keepdim=True, dtype=acc)
        mean_sq = _acc(x).square().mean(dim=_DIMS, keepdim=True)
    else:
        sums = torch.stack([x.sum(dim=_DIMS, dtype=acc), _acc(x).square().sum(dim=_DIMS)], dim=1)
        sums = sum_over_model(sums, grid).view(-1, 2, 1, 1, 1) / _count(x, grid)
        mean, mean_sq = sums[:, 0], sums[:, 1]
    return mean, torch.rsqrt(mean_sq - mean.square() + eps)


def ln_spatial_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     grid: Optional[Grid] = None) -> torch.Tensor:
    """The forward in plain PyTorch: float32 stats, the elementwise
    normalise and affine in x's dtype (weight, bias (C, H, W) cast to it)."""
    mean, r = ln_spatial_stats(x, eps, grid)
    return _affine(x, mean, r, weight, bias)


def _affine(x, mean, r, weight, bias):
    y = (x - mean.to(x.dtype)) * r.to(x.dtype)
    return y * weight.to(x.dtype) + bias.to(x.dtype)


def ln_bwd_stats_plain(
    x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor, r: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: s1 = Σ g·w, s2 = Σ g·w·x̂ per sample
    ([B]) and dw = Σ_b g·x̂, db = Σ_b g ((C, H, W)), all float32."""
    mean, r = (t.reshape(-1, 1, 1, 1) for t in (mean, r))
    xh = (_acc(x) - mean) * r
    gf = _acc(g)
    gw = gf * _acc(weight)
    return gw.sum(dim=_DIMS), (gw * xh).sum(dim=_DIMS), (gf * xh).sum(dim=0), gf.sum(dim=0)


def ln_bwd_dx_plain(
    x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
    s1: torch.Tensor, s2: torch.Tensor, count: Optional[int] = None,
) -> torch.Tensor:
    """K4's function in plain PyTorch: dx = r·(g·w − (s1 + x̂·s2)/N) in x's
    dtype; N is ``count``, by default the row length C·H·W."""
    mean, r, s1, s2 = (t.reshape(-1, 1, 1, 1) for t in (mean, r, s1, s2))
    xh = (_acc(x) - mean) * r
    gw = _acc(g) * _acc(weight)
    n = x[0].numel() if count is None else count
    return (r * (gw - (s1 + xh * s2) / n)).to(x.dtype)


def ln_spatial_bwd_plain(
    x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor, r: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX ``_autodiff_bwd`` in plain PyTorch (the kernels' reference).

    x, g: [B, C, H, W]; weight (C, H, W); mean, r: float32, one per sample.
    Returns dx in x's dtype and dw, db (C, H, W) in weight's dtype; all the
    arithmetic is float32.
    """
    s1, s2, dw, db = ln_bwd_stats_plain(x, weight, mean, r, g)
    return ln_bwd_dx_plain(x, weight, mean, r, g, s1, s2), dw.to(weight.dtype), db.to(weight.dtype)


def _vector_path(x: torch.Tensor) -> bool:
    """True where K3 reads the maps by 16-byte vectors: C a multiple of 8."""
    return x.shape[1] % 8 == 0


def _check_kernel_inputs(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: float32 or bf16 NCHW maps
    in channels_last memory, 16-byte aligned where C is a multiple of 8."""
    if x.dim() != 4 or g.shape != x.shape or tuple(weight.shape) != tuple(x.shape[1:]):
        raise ValueError(f"ln_bwd takes x, g [B,C,H,W] and weight (C,H,W), got {x.shape}, {g.shape}, {weight.shape}")
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"ln_bwd takes float32 or bfloat16 maps, got {x.dtype}, {g.dtype}")
    if any(t.device != x.device for t in (g, weight, mean)):
        raise ValueError("ln_bwd inputs on different devices")
    for name, t in (("x", x), ("g", g)):
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"ln_bwd needs {name} in channels_last memory")
        if _vector_path(x) and t.data_ptr() % 16:
            raise ValueError(f"ln_bwd needs {name} 16-byte aligned where C is a multiple of 8 (C={x.shape[1]})")


# K3's ticket counters, one int32 buffer a (device index, stream), zeroed
# once at creation. The kernel's last blocks reset them to 0, so calls in
# order on one stream share a buffer, and calls on two streams never do
# (their tickets would interleave). Counters that need no reset between
# calls also keep the launch capturable by a CUDA graph.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _ticket_counters(lib, device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(lib.theia_ln_bwd_stats_counter_words(), dtype=torch.int32,
                                    device=torch.device("cuda", key[0]))
    return _TICKETS[key]


def ln_bwd_stats(
    x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor, r: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors, one launch: per sample s1 = Σ g·w, s2 = Σ g·w·x̂
    ([B] float32) and per position dw = Σ_b g·x̂, db = Σ_b g (contiguous
    (C, H, W) float32), with the weight in float32 as ``_autodiff_bwd``
    takes it. Raises on inputs the kernel does not take or on a refused or
    failed launch."""
    if x.device.type != "cuda":
        raise ValueError(f"ln_bwd_stats runs on CUDA tensors, got {x.device}")
    _check_kernel_inputs(x, g, weight, mean)
    from theia_tpu_torch.kernels import build

    lib = build.load()
    b, c, h, w = x.shape
    weight = weight.detach().float().contiguous()
    mean, r = (t.reshape(b).float().contiguous() for t in (mean, r))
    sums = torch.empty((2, b), dtype=torch.float32, device=x.device)
    dw, db = torch.empty((2, *weight.shape), dtype=torch.float32, device=x.device).unbind(0)
    # the blocks' s1, s2 partials, then their groups'
    part = torch.empty((2, b, lib.theia_ln_bwd_stats_parts(b, h * w, c)), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.theia_ln_bwd_stats(
            g.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(), r.data_ptr(), part.data_ptr(),
            _ticket_counters(lib, x.device, stream).data_ptr(), sums.data_ptr(), dw.data_ptr(), db.data_ptr(),
            b, h * w, c, _DTYPE_CODES[x.dtype], stream,
        )
    if err:
        raise RuntimeError(f"ln_bwd_stats launch failed for {tuple(x.shape)} {x.dtype}: "
                           f"{lib.theia_cuda_error_string(err).decode()}")
    global LN_BWD_STATS_LAUNCHES
    LN_BWD_STATS_LAUNCHES += 1
    return sums[0], sums[1], dw, db


def ln_bwd_dx(
    x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
    s1: torch.Tensor, s2: torch.Tensor, count: Optional[int] = None,
) -> torch.Tensor:
    """K4 on CUDA tensors, one launch: dx = r·(g·w − (s1 + x̂·s2)/N) in x's
    dtype and channels_last memory; N is ``count``, by default the row
    length C·H·W. The kernel reads the weight in float32 in its own
    (C, H, W) layout, as ``ln_bwd_stats`` does. Raises on inputs the kernel
    does not take or on a refused or failed launch."""
    if x.device.type != "cuda":
        raise ValueError(f"ln_bwd_dx runs on CUDA tensors, got {x.device}")
    _check_kernel_inputs(x, g, weight, mean)
    from theia_tpu_torch.kernels import build

    lib = build.load()
    b, c, h, w = x.shape
    weight = weight.detach().float().contiguous()
    mean, r, s1, s2 = (t.reshape(b).float().contiguous() for t in (mean, r, s1, s2))
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        err = lib.theia_ln_bwd_dx(
            g.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(), r.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), dx.data_ptr(), b, h * w, c,
            x[0].numel() if count is None else count, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"ln_bwd_dx launch failed for {tuple(x.shape)} {x.dtype}: "
                           f"{lib.theia_cuda_error_string(err).decode()}")
    global LN_BWD_DX_LAUNCHES
    LN_BWD_DX_LAUNCHES += 1
    return dx


def ln_spatial_bwd(
    x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
    grid: Optional[Grid] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dx, dw, db: K3 then K4 on CUDA tensors, the plain version on CPU
    tensors; with ``grid``, K3's s1 and s2 summed over the model group
    between them and K4's N the whole sample's."""
    if all(t.device.type == "cpu" for t in (x, weight, g)):
        stats, dx_of = ln_bwd_stats_plain, ln_bwd_dx_plain
    else:
        x, g = (t.contiguous(memory_format=torch.channels_last) for t in (x, g))
        stats, dx_of = ln_bwd_stats, ln_bwd_dx
    s1, s2, dw, db = stats(x, weight, mean, r, g)
    if grid is not None:
        s1, s2 = model_sum(torch.stack([s1, s2]), grid).unbind(0)
    dx = dx_of(x, weight, mean, r, g, s1, s2, _count(x, grid))
    return dx, dw.to(weight.dtype), db.to(weight.dtype)


class LNSpatialFunction(torch.autograd.Function):
    """The ``ln_spatial_pallas`` custom_vjp: ``apply(x, weight, bias, eps,
    grid=None)``.

    x: [B, C, H, W] in the compute dtype; weight, bias (C, H, W) as stored
    (cast to x's dtype for the affine, as the JAX module casts its float32
    params). Saves (x, weight, mean, r); the gradients of weight and bias
    come back in their own dtype, computed in float32. ``grid``: the model
    group that splits the channels (see the module docstring).
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                grid: Optional[Grid] = None) -> torch.Tensor:
        mean, r = ln_spatial_stats(x, eps, grid)
        ctx.grid = grid
        ctx.save_for_backward(x, weight, mean, r)
        return _affine(x, mean, r, weight, bias)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight, mean, r = ctx.saved_tensors
        dx, dw, db = ln_spatial_bwd(x, weight, mean, r, g, ctx.grid)
        return dx, dw, db, None, None
