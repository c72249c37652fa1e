"""Multi-head attention for the ViT encoder: the fused CUDA kernels and their plain versions.

Port of theia_tpu/ops/attention.py:33-38,46-135,188-206. Tensors are
[B, T, H, hd], as in the JAX package. ``implementation`` keeps the JAX
package's names:
  - "pallas": the hand-written kernels on CUDA tensors, the plain versions
    on CPU tensors. ``csrc/mha_fwd.cu`` (K1) replaces the Pallas forward
    ``_mha_fwd_kernel``, ``csrc/mha_bwd.cu`` (K2) the backward
    ``_mha_bwd_kernel``; ``MHAFunction`` ties them together as the
    ``_pallas_mha`` custom_vjp does, saving only Q, K and V;
  - "einsum": the plain forward on any device, differentiated by autograd;
  - "flash": not ported yet (ROADMAP Queue 2, K7).

The plain forward has the numerics of the JAX ``_einsum_attention``: float32
scores and softmax, probabilities cast to V's dtype, P·V, output in Q's
dtype. The plain backward has those of ``_mha_bwd_kernel``.
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


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernel does not take.

    It takes float32 or bf16 [B, T, H, hd] with hd contiguous, heads hd
    apart, batch and token strides shared by Q, K and V (views into a packed
    QKV projection qualify), and 16-byte aligned rows.
    """
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mha_fwd takes three [B, T, H, hd] tensors, got {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mha_fwd takes float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    _, t, h, hd = q.shape
    if not (1 <= t <= MAX_T and 16 <= hd <= MAX_HD and hd % 16 == 0):
        raise ValueError(f"mha_fwd needs 1 <= T <= {MAX_T} and hd a multiple of 16 up to {MAX_HD}, got T={t}, hd={hd}")
    outer = _outer_strides(q)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or (h > 1 and x.stride(2) != hd) or _outer_strides(x) != outer:
            raise ValueError(f"mha_fwd needs [B, T, H, hd] with hd contiguous, heads hd apart and batch and "
                             f"token strides shared by q, k, v; {name} has strides {x.stride()}")
        if x.data_ptr() % 16 or any(s * x.element_size() % 16 for s in outer):
            raise ValueError(f"mha_fwd needs 16-byte aligned rows; {name} is not")


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
    from theia_tpu_torch.kernels import build

    lib = build.load()
    b, t, h, hd = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.theia_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, t, hd, *_outer_strides(q), *_outer_strides(out),
            _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"mha_fwd launch failed for [{b}, {t}, {h}, {hd}] {q.dtype}: "
            f"{lib.theia_cuda_error_string(err).decode()}"
        )
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
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"mha_bwd needs do like q, got {do.shape} {do.dtype} {do.device}")
    if do.stride(3) != 1 or (q.shape[2] > 1 and do.stride(2) != q.shape[3]):
        raise ValueError(f"mha_bwd needs do with hd contiguous and heads hd apart, got strides {do.stride()}")
    if do.data_ptr() % 16 or any(s * do.element_size() % 16 for s in _outer_strides(do)):
        raise ValueError("mha_bwd needs 16-byte aligned rows of do")
    from theia_tpu_torch.kernels import build

    lib = build.load()
    b, t, h, hd = q.shape
    grads = torch.empty((b, t, 3, h, hd), dtype=q.dtype, device=q.device)
    stats = torch.empty((b * h, 3, t), dtype=torch.float32, device=q.device)
    dq, dk, dv = grads.unbind(2)
    with torch.cuda.device(q.device):
        err = lib.theia_mha_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b, h, t, hd, *_outer_strides(q), *_outer_strides(do), *_outer_strides(dq),
            _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"mha_bwd launch failed for [{b}, {t}, {h}, {hd}] {q.dtype}: "
            f"{lib.theia_cuda_error_string(err).decode()}"
        )
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


def packed_attention(qkv: torch.Tensor, heads: int, *, implementation: str = "pallas") -> torch.Tensor:
    """Attention over a packed QKV projection [B, T, 3*C] -> [B, T, C].

    "pallas" goes through ``MHAFunction`` (differentiable, kernels on CUDA
    tensors); the other names through ``multi_head_attention`` on views.
    """
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
    if implementation == "pallas":
        return mha_fwd(q, k, v)
    if implementation == "flash":
        raise NotImplementedError(
            "attention_impl='flash' is not ported: the tiled online-softmax kernel is "
            "ROADMAP Queue 2 item K7"
        )
    raise ValueError(f"unknown attention implementation {implementation!r}")
