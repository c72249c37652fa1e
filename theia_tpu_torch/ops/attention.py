"""Multi-head attention for the ViT encoder: the CUDA kernels and their plain versions.

Port of theia_tpu/ops/attention.py:33-38,46-206 and of the JAX flash
attention library its "flash" path calls
(jax/experimental/pallas/ops/tpu/flash_attention.py). Tensors are
[B, T, H, hd], as in the JAX package. ``implementation`` keeps the JAX
package's names:
  - "pallas": the hand-written kernels on CUDA tensors, the plain versions
    on CPU tensors. ``csrc/mha_fwd.cu`` (K1) replaces the Pallas forward
    ``_mha_fwd_kernel``, ``csrc/mha_bwd.cu`` (K2) the backward
    ``_mha_bwd_kernel``; ``MHAFunction`` ties them together as the
    ``_pallas_mha`` custom_vjp does, saving only Q, K and V. K1 and K2 keep
    a whole score row on the SM and take T <= ``MAX_T``; the JAX kernel has
    no such limit, so for longer sequences (448² images: T = 785) "pallas"
    dispatches by shape to the flash kernels, which take any T. The choice
    is made from T before anything runs; no failure is caught;
  - "flash": the tiled online-softmax kernels of ``csrc/flash_attn.cu``,
    which replace the library's three Pallas kernels: K7 the forward
    (``_flash_attention_kernel``), K9 dQ (``_flash_attention_dq_kernel``)
    and K8 dK, dV (``_flash_attention_dkv_kernel``). ``FlashFunction`` ties
    them together as the library's custom_vjp does, saving Q, K, V, O and
    the rows' log-sum-exp;
  - "einsum": the plain forward on any device, differentiated by autograd.

Importing this module registers K1's and K7's forwards as the operators
``theia::mha_attention`` and ``theia::flash_attention`` (with shape
functions for tracing): ``torch.export`` sees them in place of the ctypes
launches, and a saved export (``export.py``) needs them registered to load.

The plain forward has the numerics of the JAX ``_einsum_attention``: float32
scores and softmax, probabilities cast to V's dtype, P·V, output in Q's
dtype. The plain backward has those of ``_mha_bwd_kernel``. The flash plain
versions have the library kernels': float32 scores times the scale,
P = exp(S - max) rounded to V's dtype before P·V with the sum taken over
the unrounded P, O divided by the sum at the end, lse = max + log(sum); the
backward rebuilds P = exp(S - lse), takes di = rowsum(O ∘ dO) in float32
from the output, dS = (dP - di) ∘ P · scale, and rounds P and dS to the
input dtype before their products.
"""

from __future__ import annotations

import math

import torch

MAX_T = 256
MAX_HD = 128

# Launches of the CUDA kernels in this process; each is incremented only
# where its kernel is launched.
MHA_FWD_LAUNCHES = 0
MHA_BWD_LAUNCHES = 0
FLASH_FWD_LAUNCHES = 0
FLASH_DKV_LAUNCHES = 0
FLASH_DQ_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or float64 where it is that (the plain versions' math)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def mha_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, T, H, hd] -> [B, T, H, hd] in plain PyTorch (the kernel's reference)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k))
    probs = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The JAX ``_mha_bwd_kernel`` in plain PyTorch (the kernel's reference).

    q, k, v, do: [B, T, H, hd] -> [B, T, 3, H, hd] holding dQ, dK, dV. P and
    dS round to the input dtype before their products (the identity in
    float32); every product runs in float32.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (_acc(x) for x in (q, k, v, do))
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", _acc(probs.to(v.dtype)), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = _acc((probs * (dp - (dp * probs).sum(dim=-1, keepdim=True)) * scale).to(q.dtype))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return torch.stack([dq, dk, dv], dim=2).to(q.dtype)


def _outer_strides(x: torch.Tensor) -> tuple[int, int]:
    """Batch and token strides of [B, T, H, hd]; 0 for a dimension of size 1,
    whose stride torch leaves arbitrary and the kernel never uses."""
    return tuple(x.stride(i) if x.shape[i] > 1 else 0 for i in (0, 1))


def _check_rows(name: str, x: torch.Tensor, like: torch.Tensor, what: str) -> None:
    """Raise unless x is [B, T, H, hd] like ``like`` (shape, dtype, device)
    with hd contiguous, heads hd apart and 16-byte aligned rows."""
    if x.shape != like.shape or x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"{what} needs {name} like q, got {x.shape} {x.dtype} {x.device}")
    if x.stride(3) != 1 or (x.shape[2] > 1 and x.stride(2) != x.shape[3]):
        raise ValueError(f"{what} needs {name} with hd contiguous and heads hd apart, got strides {x.stride()}")
    if x.data_ptr() % 16 or any(s * x.element_size() % 16 for s in _outer_strides(x)):
        raise ValueError(f"{what} needs 16-byte aligned rows of {name}")


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, max_t: int | None = MAX_T,
                         what: str = "mha_fwd") -> None:
    """Raise on anything the kernel does not take.

    It takes float32 or bf16 [B, T, H, hd] with hd contiguous, heads hd
    apart, batch and token strides shared by Q, K and V (views into a packed
    QKV projection qualify), 16-byte aligned rows, hd a multiple of 16 up to
    ``MAX_HD`` and 1 <= T <= ``max_t`` (any T where it is None).
    """
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what} takes three [B, T, H, hd] tensors, got {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    _, t, h, hd = q.shape
    if not (1 <= t <= (max_t or t) and 16 <= hd <= MAX_HD and hd % 16 == 0):
        raise ValueError(f"{what} needs 1 <= T{f' <= {max_t}' if max_t else ''} and hd a multiple of 16 up to "
                         f"{MAX_HD}, got T={t}, hd={hd}")
    outer = _outer_strides(q)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, x, q, what)
        if _outer_strides(x) != outer:
            raise ValueError(f"{what} needs batch and token strides shared by q, k, v; {name} has strides "
                             f"{x.stride()}")


def _check_stats(name: str, x: torch.Tensor, q: torch.Tensor, what: str) -> None:
    """Raise unless x is a contiguous float32 [B*H, T] on q's device (lse, di)."""
    b, t, h, _ = q.shape
    if x.shape != (b * h, t) or x.dtype != torch.float32 or x.device != q.device or not x.is_contiguous():
        raise ValueError(f"{what} needs {name} as contiguous float32 [{b * h}, {t}] on {q.device}, got "
                         f"{tuple(x.shape)} {x.dtype} {x.device}")


def _launch(fn: str, device: torch.device, what: str, *args) -> None:
    """Call the library's ``fn`` with ``args`` and the current stream of
    ``device``; raise if the launch failed."""
    from theia_tpu_torch.kernels import build

    lib = build.load()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.theia_cuda_error_string(err).decode()}")


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused attention forward over [B, T, H, hd] -> contiguous [B, T, H, hd].

    On CUDA tensors: launches the kernel, or raises on inputs it does not
    take or on a failed launch. On CPU tensors: the plain version. Its
    output has no gradient, so it raises for an input that requires one
    while grad is enabled; ``MHAFunction`` is the differentiable form.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "mha_fwd does not differentiate its inputs; use MHAFunction (packed_attention) "
            "or call it under torch.no_grad()"
        )
    if _on_cpu(q, k, v):
        return mha_fwd_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"mha_fwd runs on CUDA or CPU tensors, got {q.device}")
    _check_kernel_inputs(q, k, v)
    b, t, h, hd = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("theia_mha_fwd", q.device, f"mha_fwd for [{b}, {t}, {h}, {hd}] {q.dtype}",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, t, hd, *_outer_strides(q), *_outer_strides(out), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd))
    global MHA_FWD_LAUNCHES
    MHA_FWD_LAUNCHES += 1
    return out


def mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Fused attention backward: q, k, v, do [B, T, H, hd] -> [B, T, 3, H, hd]
    holding dQ, dK, dV (contiguous, so also the gradient of a packed QKV
    projection [B, T, 3*H*hd]).

    On CUDA tensors: launches the kernel, or raises on inputs it does not
    take or on a failed launch. On CPU tensors: the plain version.
    """
    if _on_cpu(q, k, v, do):
        return mha_bwd_plain(q, k, v, do)
    if q.device.type != "cuda":
        raise ValueError(f"mha_bwd runs on CUDA or CPU tensors, got {q.device}")
    _check_kernel_inputs(q, k, v)
    _check_rows("do", do, q, "mha_bwd")
    b, t, h, hd = q.shape
    grads = torch.empty((b, t, 3, h, hd), dtype=q.dtype, device=q.device)
    stats = torch.empty((b * h, 3, t), dtype=torch.float32, device=q.device)
    dq, dk, dv = grads.unbind(2)
    _launch("theia_mha_bwd", q.device, f"mha_bwd for [{b}, {t}, {h}, {hd}] {q.dtype}",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b, h, t, hd, *_outer_strides(q), *_outer_strides(do), *_outer_strides(dq),
            _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd))
    global MHA_BWD_LAUNCHES
    MHA_BWD_LAUNCHES += 1
    return grads


def _split_heads(qkv: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, T, 3*C] -> q, k, v [B, T, H, C/H], views into the packed projection."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    return tuple(y.view(b, t, heads, c // heads) for y in qkv.split(c, dim=-1))


class MHAFunction(torch.autograd.Function):
    """Attention over a packed QKV projection, K1 forward and K2 backward.

    The port of the ``_pallas_mha`` custom_vjp: ``apply(qkv, heads)`` with
    qkv [B, T, 3*C] returns the context [B, T, C]; it saves only qkv (Q, K
    and V), and its backward writes dQ, dK and dV straight into one
    [B, T, 3*C] gradient.
    """

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        b, t, c3 = qkv.shape
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        return mha_fwd(*_split_heads(qkv, heads)).reshape(b, t, c3 // 3)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor) -> tuple[torch.Tensor, None]:
        (qkv,) = ctx.saved_tensors
        b, t, c3 = qkv.shape
        heads = ctx.heads
        do = grad_out.contiguous().view(b, t, heads, c3 // 3 // heads)
        return mha_bwd(*_split_heads(qkv, heads), do).view(b, t, c3), None


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 in plain PyTorch: [B, T, H, hd] -> O [B, T, H, hd] in Q's dtype
    (contiguous) and lse [B*H, T] in float32 (float64 for float64 inputs)."""
    b, t, h, hd = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * (1.0 / math.sqrt(hd))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", _acc(p.to(v.dtype)), _acc(v)) / l
    return o.transpose(1, 2).contiguous().to(q.dtype), (m + torch.log(l)).reshape(b * h, t)


def _flash_p_ds(q, k, v, lse, di, do) -> tuple[torch.Tensor, torch.Tensor]:
    """P = exp(S - lse) and dS = (dP - di) ∘ P · scale, [B, H, Tq, Tk] in float32."""
    b, t, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * scale - lse.reshape(b, h, t, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", _acc(do), _acc(v))
    return p, (dp - di.reshape(b, h, t, 1)) * p * scale


def flash_dq_plain(q, k, v, o, lse, do) -> tuple[torch.Tensor, torch.Tensor]:
    """K9 in plain PyTorch: dQ [B, T, H, hd] in Q's dtype, and di =
    rowsum(O ∘ dO) [B*H, T] in float32, which K8 takes."""
    b, t, h, _ = q.shape
    di = (_acc(o) * _acc(do)).sum(dim=-1).transpose(1, 2).reshape(b * h, t)
    _, ds = _flash_p_ds(q, k, v, lse, di, do)
    return torch.einsum("bhqk,bkhd->bqhd", _acc(ds.to(q.dtype)), _acc(k)).to(q.dtype), di


def flash_dkv_plain(q, k, v, lse, di, do) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 in plain PyTorch: dK and dV [B, T, H, hd] in Q's dtype."""
    p, ds = _flash_p_ds(q, k, v, lse, di, do)
    dv = torch.einsum("bhqk,bqhd->bkhd", _acc(p.to(do.dtype)), _acc(do))
    dk = torch.einsum("bhqk,bqhd->bkhd", _acc(ds.to(q.dtype)), _acc(q))
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_plain(q, k, v, o, lse, do) -> torch.Tensor:
    """The flash backward in plain PyTorch: [B, T, 3, H, hd] holding dQ, dK, dV."""
    dq, di = flash_dq_plain(q, k, v, o, lse, do)
    return torch.stack([dq, *flash_dkv_plain(q, k, v, lse, di, do)], dim=2)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward (K7): [B, T, H, hd] -> O (contiguous [B, T, H,
    hd]) and lse (float32 [B*H, T]), for any T.

    On CUDA tensors: launches the kernel, or raises on inputs it does not
    take or on a failed launch. On CPU tensors: the plain version. Raises
    for an input that requires grad while grad is enabled, as ``mha_fwd``;
    ``FlashFunction`` is the differentiable form.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_fwd does not differentiate its inputs; use FlashFunction (packed_attention) "
            "or call it under torch.no_grad()"
        )
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, got {q.device}")
    _check_kernel_inputs(q, k, v, max_t=None, what="flash_fwd")
    b, t, h, hd = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    _launch("theia_flash_fwd", q.device, f"flash_fwd for [{b}, {t}, {h}, {hd}] {q.dtype}",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, t, hd, *_outer_strides(q), *_outer_strides(o), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd))
    global FLASH_FWD_LAUNCHES
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def flash_dq(q, k, v, o, lse, do, dq: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention dQ (K9): dQ [B, T, H, hd] (into ``dq`` where given)
    and di = rowsum(O ∘ dO) (float32 [B*H, T]) for K8.

    On CUDA tensors: launches the kernel, or raises on inputs it does not
    take or on a failed launch. On CPU tensors: the plain version.
    """
    if _on_cpu(q, k, v, o, lse, do):
        got, di = flash_dq_plain(q, k, v, o, lse, do)
        return (got if dq is None else dq.copy_(got)), di
    what = f"flash_dq for [{', '.join(map(str, q.shape))}] {q.dtype}"
    _check_kernel_inputs(q, k, v, max_t=None, what=what)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) if dq is None else dq
    for name, x in (("o", o), ("do", do), ("dq", dq)):
        _check_rows(name, x, q, what)
    _check_stats("lse", lse, q, what)
    b, t, h, hd = q.shape
    di = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    _launch("theia_flash_dq", q.device, what,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
            dq.data_ptr(), b, h, t, hd, *_outer_strides(q), *_outer_strides(o), *_outer_strides(do),
            *_outer_strides(dq), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd))
    global FLASH_DQ_LAUNCHES
    FLASH_DQ_LAUNCHES += 1
    return dq, di


def flash_dkv(q, k, v, lse, di, do, dk: torch.Tensor | None = None,
              dv: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention dK and dV (K8) [B, T, H, hd] (into ``dk``, ``dv``
    where given), from K7's lse and K9's di.

    On CUDA tensors: launches the kernel, or raises on inputs it does not
    take or on a failed launch. On CPU tensors: the plain version.
    """
    if _on_cpu(q, k, v, lse, di, do):
        gk, gv = flash_dkv_plain(q, k, v, lse, di, do)
        return (gk if dk is None else dk.copy_(gk)), (gv if dv is None else dv.copy_(gv))
    what = f"flash_dkv for [{', '.join(map(str, q.shape))}] {q.dtype}"
    _check_kernel_inputs(q, k, v, max_t=None, what=what)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device) if dk is None else dk
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device) if dv is None else dv
    for name, x in (("do", do), ("dk", dk), ("dv", dv)):
        _check_rows(name, x, q, what)
    if _outer_strides(dv) != _outer_strides(dk):
        raise ValueError(f"{what} needs dk and dv with the same strides, got {dk.stride()}, {dv.stride()}")
    _check_stats("lse", lse, q, what)
    _check_stats("di", di, q, what)
    b, t, h, hd = q.shape
    _launch("theia_flash_dkv", q.device, what,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, t, hd, *_outer_strides(q), *_outer_strides(do), *_outer_strides(dk),
            _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd))
    global FLASH_DKV_LAUNCHES
    FLASH_DKV_LAUNCHES += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do) -> torch.Tensor:
    """Flash attention backward: [B, T, 3, H, hd] holding dQ, dK, dV
    (contiguous, so also the gradient of a packed QKV projection [B, T,
    3*H*hd]). On CUDA tensors K9 writes dQ and di, then K8 dK and dV, each
    straight into its slice; on CPU tensors: the plain version."""
    if _on_cpu(q, k, v, o, lse, do):
        return flash_bwd_plain(q, k, v, o, lse, do)
    b, t, h, hd = q.shape
    grads = torch.empty((b, t, 3, h, hd), dtype=q.dtype, device=q.device)
    dq, dk, dv = grads.unbind(2)
    _, di = flash_dq(q, k, v, o, lse, do, dq=dq)
    flash_dkv(q, k, v, lse, di, do, dk=dk, dv=dv)
    return grads


class FlashFunction(torch.autograd.Function):
    """Attention over a packed QKV projection, K7 forward, K9 and K8 backward.

    The port of the flash library's custom_vjp: ``apply(qkv, heads)`` with
    qkv [B, T, 3*C] returns the context [B, T, C]; it saves qkv, the output
    and the rows' lse, and its backward writes dQ, dK and dV straight into
    one [B, T, 3*C] gradient.
    """

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        b, t, c3 = qkv.shape
        o, lse = flash_fwd(*_split_heads(qkv, heads))
        out = o.view(b, t, c3 // 3)
        ctx.heads = heads
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor) -> tuple[torch.Tensor, None]:
        qkv, out, lse = ctx.saved_tensors
        b, t, c3 = qkv.shape
        heads = ctx.heads
        hd = c3 // 3 // heads
        do = grad_out.contiguous().view(b, t, heads, hd)
        return flash_bwd(*_split_heads(qkv, heads), out.view(b, t, heads, hd), lse, do).view(b, t, c3), None


@torch.library.custom_op("theia::mha_attention", mutates_args=())
def _mha_attention_op(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """K1 over a packed QKV projection [B, T, 3*C] -> [B, T, C], as a graph
    operator: ``torch.export`` cannot trace into the kernel's ctypes launch."""
    b, t, c3 = qkv.shape
    return mha_fwd(*_split_heads(qkv, heads)).reshape(b, t, c3 // 3)


@torch.library.custom_op("theia::flash_attention", mutates_args=())
def _flash_attention_op(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """K7 over a packed QKV projection [B, T, 3*C] -> [B, T, C] (the output
    only), as a graph operator."""
    b, t, c3 = qkv.shape
    return flash_fwd(*_split_heads(qkv, heads))[0].reshape(b, t, c3 // 3)


@_mha_attention_op.register_fake
@_flash_attention_op.register_fake
def _attention_op_fake(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, c3 = qkv.shape
    return qkv.new_empty((b, t, c3 // 3))


def _flash_route(implementation: str, t: int) -> bool:
    """Whether attention over T tokens runs the flash kernels: always for
    "flash"; for "pallas" past K1's and K2's ``MAX_T``."""
    return implementation == "flash" or (implementation == "pallas" and t > MAX_T)


def packed_attention(qkv: torch.Tensor, heads: int, *, implementation: str = "pallas") -> torch.Tensor:
    """Attention over a packed QKV projection [B, T, 3*C] -> [B, T, C].

    "flash", and "pallas" past ``MAX_T`` tokens, go through
    ``FlashFunction``; "pallas" otherwise through ``MHAFunction`` (both
    differentiable, kernels on CUDA tensors); "einsum" through
    ``multi_head_attention`` on views. While ``torch.export`` traces (an
    inference graph), the kernels' paths are the operators
    ``theia::mha_attention`` and ``theia::flash_attention`` instead, which
    launch the same kernels when the exported program runs; eager calls
    never go through them.
    """
    if implementation != "einsum" and torch.compiler.is_exporting():
        flash = _flash_route(implementation, qkv.shape[1])
        return (torch.ops.theia.flash_attention if flash else torch.ops.theia.mha_attention)(qkv, heads)
    if _flash_route(implementation, qkv.shape[1]):
        return FlashFunction.apply(qkv, heads)
    if implementation == "pallas":
        return MHAFunction.apply(qkv, heads)
    b, t, c3 = qkv.shape
    return multi_head_attention(*_split_heads(qkv, heads), implementation=implementation).reshape(b, t, c3 // 3)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    implementation: str = "pallas",
) -> torch.Tensor:
    """Attention over [B, T, H, hd] tensors -> [B, T, H, hd] in Q's dtype."""
    if implementation == "einsum":
        return mha_fwd_plain(q, k, v)
    if implementation not in ("pallas", "flash"):
        raise ValueError(f"unknown attention implementation {implementation!r}")
    if _flash_route(implementation, q.shape[1]):
        return flash_fwd(q, k, v)[0]
    return mha_fwd(q, k, v)
