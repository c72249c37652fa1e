"""Multi-head attention for the ViT encoder: the fused CUDA forward kernel and its plain version.

Port of theia_tpu/ops/attention.py:33-38,188-206. Tensors are [B, T, H, hd],
as in the JAX package. ``implementation`` keeps the JAX package's names:
  - "pallas": the hand-written kernel ``csrc/mha_fwd.cu`` (it replaces the
    Pallas kernel ``_mha_fwd_kernel``) on CUDA tensors, the plain version
    on CPU tensors;
  - "einsum": the plain version on any device;
  - "flash": not ported yet (ROADMAP Queue 2, K7).

The plain version has the numerics of the JAX ``_einsum_attention``: float32
scores and softmax, probabilities cast to V's dtype, P·V, output in Q's dtype.
"""

from __future__ import annotations

import math

import torch

MAX_T = 256
MAX_HD = 128

# Launches of the CUDA kernel in this process; incremented only where the
# kernel is launched.
MHA_FWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mha_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, T, H, hd] -> [B, T, H, hd] in plain PyTorch (the kernel's reference)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


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


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused attention forward over [B, T, H, hd] -> contiguous [B, T, H, hd].

    On CUDA tensors: launches the kernel, or raises on inputs it does not
    take or on a failed launch. On CPU tensors: the plain version.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
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
