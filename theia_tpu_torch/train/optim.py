"""Optimizer and LR schedules of the reference recipe (port of theia_tpu/train/optim.py:26-189).

- AdamW (betas 0.9/0.999) with no weight decay for parameters of ndim <= 1
  and for biases, decay otherwise (the (C,H,W) LayerNorm weights decay);
- LR scaling lr = base_lr * (batch*world) / (base_batch*base_world);
- schedules: linear warmup (start factor 1e-2), then constant or cosine
  annealing with warm restarts (T_mult=1);
- an optional translator LR factor, applied as an update scale.

Plain functions over dicts of tensors keyed by parameter name, not
``torch.optim.AdamW``: that has neither the JAX package's masking (a masked
parameter keeps its value, its moments and its own step count) nor a step
count per parameter under a mask. Unlike the JAX package, which returns new
parameters and state, ``MaskedAdamW.update`` updates both in place: on CUDA
tensors in one launch of K10 (``csrc/adamw.cu``) over every tensor, bit for
bit what ``MaskedAdamW.update_plain``, the plain loop that CPU tensors take,
computes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from theia_tpu_torch.parallel.tp import model_sum

Schedule = Callable[[Any], torch.Tensor]

# K10's launches in this process
ADAMW_FUSED_LAUNCHES = 0

# K10's plan, as csrc/adamw.cu reads it: chunks of CHUNK elements, one
# TensorDesc (DESC) a tensor with these flags
CHUNK = 2048
DECAY, SCALE, MASKED, STRIDED = 1, 2, 4, 8
DESC = np.dtype([("p", np.uint64), ("g", np.uint64), ("mu", np.uint64), ("nu", np.uint64), ("count", np.uint64),
                 ("mask", np.uint64), ("n", np.int64), ("chunk0", np.int32), ("flags", np.int32),
                 ("mask_value", np.float32), ("size", np.int32, (3,)), ("stride", np.int32, (4,))], align=True)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def scaled_lr(base_lr: float, batch_size: int, world_size: int,
              base_batch_size: int = 64, base_world_size: int = 8) -> float:
    return base_lr * (batch_size * world_size) / (base_batch_size * base_world_size)


def _step_f32(step: Any) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_with_warmup(lr: float, warm_up_steps: int, warm_up_lr_start_factor: float = 1e-2) -> Schedule:
    """Linear warmup to lr, then constant; the step may be an int or a device tensor."""

    def schedule(step: Any) -> torch.Tensor:
        step = _step_f32(step)
        frac = torch.clamp(step / max(warm_up_steps, 1), max=1.0)
        factor = warm_up_lr_start_factor + (1.0 - warm_up_lr_start_factor) * frac
        return lr * torch.where(step < warm_up_steps, factor, 1.0)

    return schedule


def cosine_restarts_with_warmup(
    lr: float,
    warm_up_steps: int,
    cos_lrs_T_0: int,
    warm_up_lr_start_factor: float = 1e-2,
    eta_min: float = 0.0,
) -> Schedule:
    """Linear warmup, then CosineAnnealingWarmRestarts(T_0, T_mult=1)."""

    def schedule(step: Any) -> torch.Tensor:
        step = _step_f32(step)
        frac = torch.clamp(step / max(warm_up_steps, 1), max=1.0)
        warm = lr * (warm_up_lr_start_factor + (1.0 - warm_up_lr_start_factor) * frac)
        t_cur = torch.remainder(step - warm_up_steps, cos_lrs_T_0)
        cos = eta_min + (lr - eta_min) * (1.0 + torch.cos(math.pi * t_cur / cos_lrs_T_0)) / 2.0
        return torch.where(step < warm_up_steps, warm, cos)

    return schedule


def _decays(name: str, ndim: int) -> bool:
    return ndim > 1 and not name.endswith("bias")


def no_weight_decay_mask(params: Mapping[str, torch.Tensor]) -> dict[str, bool]:
    """True where weight decay applies: ndim > 1 and a name not ending in "bias"."""
    return {name: _decays(name, p.ndim) for name, p in params.items()}


@dataclasses.dataclass(frozen=True)
class AdamWLaunch:
    """One K10 launch: tensors [lo, hi) of a call, their descriptors with
    every pointer 0 (filled in a copy at each call) and the chunks they span."""

    lo: int
    hi: int
    rows: np.ndarray
    chunks: int


@functools.lru_cache(maxsize=8)
def adamw_plan(specs: tuple, max_tensors: int, scale_translator: bool) -> tuple[AdamWLaunch, ...]:
    """K10's launches for ``specs``, one (name, shape, strides) a tensor in
    the call's order (``strides``: None, or the element strides of a
    gradient laid out otherwise than its contiguous parameter, up to 4-d,
    which K10 gathers): ``max_tensors`` descriptors a launch, each
    with its decay and translator-factor flags and its first chunk (a
    prefix over the tensors' chunks of CHUNK elements; chunk c of a tensor
    updates its elements [c·CHUNK, min(n, (c + 1)·CHUNK))). Cached: a
    model's shapes repeat every step."""
    launches = []
    for lo in range(0, len(specs), max_tensors):
        group = specs[lo:lo + max_tensors]
        rows = np.zeros(len(group), DESC)
        chunk0 = 0
        for row, (name, shape, strides) in zip(rows, group):
            n = math.prod(shape)
            row["n"], row["chunk0"] = n, chunk0
            row["flags"] = ((DECAY if _decays(name, len(shape)) else 0)
                            | (SCALE if scale_translator and name.startswith("translator.") else 0)
                            | (STRIDED if strides is not None else 0))
            if strides is not None:
                pad = 4 - len(shape)
                row["size"] = ((1,) * pad + tuple(shape))[1:]
                row["stride"] = (0,) * pad + tuple(strides)
            chunk0 += -(-n // CHUNK)
        launches.append(AdamWLaunch(lo, lo + len(group), rows, chunk0))
    return tuple(launches)


# K10's ticket counters, one word a (device index, stream), zeroed once; each
# launch leaves its counter 0 (ops/ln_pallas.py's _TICKETS)
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _kernel(device: torch.device):
    """The built library, its checked layout, and the stream and counter of ``device``."""
    from theia_tpu_torch.kernels import build

    lib = build.load()
    chunk, max_tensors, desc_bytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.theia_adamw_layout(ctypes.byref(chunk), ctypes.byref(max_tensors), ctypes.byref(desc_bytes))
    if (chunk.value, desc_bytes.value) != (CHUNK, DESC.itemsize):
        raise RuntimeError(f"csrc/adamw.cu's layout ({chunk.value}, {desc_bytes.value} bytes) is not "
                           f"train/optim.py's ({CHUNK}, {DESC.itemsize} bytes)")
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return lib, max_tensors.value, stream, _COUNTERS[key]


def _one_dtype(tensors, what: str) -> int:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= _DTYPE_CODES.keys():
        raise TypeError(f"K10 takes {what} all float32 or all bfloat16, got {sorted(map(str, dtypes))}")
    return _DTYPE_CODES[dtypes.pop()]


@dataclasses.dataclass
class MaskedAdamWState:
    """AdamW state with a step count per parameter.

    ``sched_count`` drives the LR schedule and advances every step; ``count``
    advances only for the parameters a step updates (torch.optim.AdamW's
    per-parameter ``state["step"]``, which skips parameters without a grad).
    """

    sched_count: torch.Tensor
    count: dict[str, torch.Tensor]
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MaskedAdamW:
    """AdamW with the reference's decay mask and masking that freezes a parameter completely.

    ``update(grads, state, params, mask=None)``: ``mask`` maps some names to
    {0, 1} scalars; a 0 leaves that parameter, its moments and its count
    untouched, as torch leaves a parameter without a grad. Names not in
    ``mask`` update. ``moment_dtype`` stores the moments narrower (bf16);
    the update math runs in the grad's dtype and only the carried state
    rounds. The translator LR factor scales the update of parameters under
    ``translator.``: exact for AdamW, whose Adam term and decoupled decay
    both scale with lr.
    """

    learning_rate: float | Schedule
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    translator_lr_factor: float = 1.0
    moment_dtype: Optional[torch.dtype] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> MaskedAdamWState:
        device = next(iter(params.values())).device

        def zeros(p: torch.Tensor) -> torch.Tensor:
            return torch.zeros(p.shape, dtype=self.moment_dtype or p.dtype, device=p.device)

        return MaskedAdamWState(
            sched_count=torch.zeros((), dtype=torch.int32, device=device),
            count={n: torch.zeros((), dtype=torch.int32, device=p.device) for n, p in params.items()},
            mu={n: zeros(p) for n, p in params.items()},
            nu={n: zeros(p) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(
        self,
        grads: Mapping[str, torch.Tensor],
        state: MaskedAdamWState,
        params: Mapping[str, torch.Tensor],
        *,
        mask: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """One step over ``grads``; updates ``params`` and ``state`` in place.
        CUDA tensors take K10, one launch (more only past its parameter
        limit) that neither synchronizes nor reads a device value on the
        host, and advances the counts in place; CPU tensors take
        ``update_plain``."""
        if not grads or not next(iter(grads.values())).is_cuda:
            self.update_plain(grads, state, params, mask=mask)
            return
        self._update_k10(grads, state, params, mask)
        state.sched_count += 1

    def _update_k10(self, grads, state: MaskedAdamWState, params, mask) -> None:
        names = list(grads)
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        mus, nus, counts = [state.mu[n] for n in names], [state.nu[n] for n in names], [state.count[n] for n in names]
        device = ps[0].device
        if len({t.get_device() for ts in (ps, gs, mus, nus, counts) for t in ts}) != 1:
            raise ValueError(f"K10 needs every parameter, grad, moment and count on {device}")
        if any(c.dtype != torch.int32 for c in counts) or not all(
                t.is_contiguous() for ts in (ps, mus, nus) for t in ts):
            raise ValueError("K10 needs int32 counts, and parameters and moments contiguous")
        specs = []
        for name, p, g in zip(names, ps, gs):
            if g.shape != p.shape:
                raise ValueError(f"K10 needs {name}'s grad shaped as its parameter, got {tuple(g.shape)}")
            strides = None
            if not g.is_contiguous():
                if g.dim() > 4 or g.numel() >= 2**31 or sum((n - 1) * st for n, st in zip(g.shape, g.stride())) >= 2**31:
                    raise ValueError(f"K10 gathers a strided grad of up to 4 dimensions and offsets below 2^31, got "
                                     f"{name}'s of shape {tuple(g.shape)} and strides {g.stride()}")
                strides = g.stride()
            specs.append((name, p.shape, strides))
        dtype, moment_dtype = _one_dtype(ps + gs, "parameters and grads"), _one_dtype(mus + nus, "moments")

        b1, b2 = self.betas
        lr = self.learning_rate(state.sched_count) if callable(self.learning_rate) else self.learning_rate
        lr_ptr, neg_lr = None, 0.0
        if isinstance(lr, torch.Tensor) and lr.is_cuda:
            lr = lr if lr.dtype == torch.float32 else lr.float()
            lr_ptr = lr.data_ptr()
        else:
            neg_lr = -float(lr)
        keep = [lr]  # the device scalars the launches read, alive until they are enqueued
        lib, max_tensors, stream, counter = _kernel(device)
        global ADAMW_FUSED_LAUNCHES
        for launch in adamw_plan(tuple(specs), max_tensors, self.translator_lr_factor != 1.0):
            lo, hi = launch.lo, launch.hi
            rows = launch.rows.copy()
            for col, ts in (("p", ps), ("g", gs), ("mu", mus), ("nu", nus), ("count", counts)):
                rows[col] = [t.data_ptr() for t in ts[lo:hi]]
            if mask is not None:
                for i in range(lo, hi):
                    if names[i] in mask:
                        m = mask[names[i]]
                        rows["flags"][i - lo] |= MASKED
                        if isinstance(m, torch.Tensor) and m.is_cuda:
                            if m.numel() != 1:
                                raise ValueError(f"K10 takes a scalar mask, got {tuple(m.shape)} for {names[i]}")
                            m = m if m.dtype == torch.float32 else m.float()
                            keep.append(m)
                            rows["mask"][i - lo] = m.data_ptr()
                        else:
                            rows["mask_value"][i - lo] = float(m)
            with torch.cuda.device(device):
                err = lib.theia_adamw(rows.ctypes.data, hi - lo, launch.chunks, lr_ptr, neg_lr, b1, b2, 1.0 - b1,
                                      1.0 - b2, self.eps, self.weight_decay, self.translator_lr_factor, dtype,
                                      moment_dtype, counter.data_ptr(), stream)
            if err:
                raise RuntimeError(f"K10 launch failed over {hi - lo} tensors: {lib.theia_cuda_error_string(err).decode()}")
            ADAMW_FUSED_LAUNCHES += 1

    @torch.no_grad()
    def update_plain(
        self,
        grads: Mapping[str, torch.Tensor],
        state: MaskedAdamWState,
        params: Mapping[str, torch.Tensor],
        *,
        mask: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """K10's function in plain PyTorch, about 34 ops a tensor: one step
        over ``grads``; updates ``params`` and ``state`` in place (each
        count replaced by a new tensor)."""
        b1, b2 = self.betas
        lr = self.learning_rate(state.sched_count) if callable(self.learning_rate) else self.learning_rate
        decay = no_weight_decay_mask(params)
        for name, g in grads.items():
            p, mu, nu = params[name], state.mu[name], state.nu[name]
            mu_g, nu_g = mu.to(g.dtype), nu.to(g.dtype)
            m = None if mask is None or name not in mask else torch.as_tensor(mask[name], dtype=g.dtype, device=g.device)
            if m is None:
                count = state.count[name] + 1
                mu1 = b1 * mu_g + (1.0 - b1) * g
                nu1 = b2 * nu_g + (1.0 - b2) * g * g
            else:
                count = state.count[name] + m.to(torch.int32)
                mu1 = m * (b1 * mu_g + (1.0 - b1) * g) + (1.0 - m) * mu_g
                nu1 = m * (b2 * nu_g + (1.0 - b2) * g * g) + (1.0 - m) * nu_g
            cf = count.to(g.dtype)
            # a parameter never updated (count 0) would divide by 0
            bc1 = torch.where(count > 0, 1.0 - b1**cf, 1.0)
            bc2 = torch.where(count > 0, 1.0 - b2**cf, 1.0)
            step = (mu1 / bc1) / (torch.sqrt(nu1 / bc2) + self.eps)
            if decay[name]:
                step = step + self.weight_decay * p
            u = -lr * step if m is None else -lr * m * step
            if self.translator_lr_factor != 1.0 and name.startswith("translator."):
                u = u * self.translator_lr_factor
            p.add_(u)
            mu.copy_(mu1)
            nu.copy_(nu1)
            state.count[name] = count
        state.sched_count += 1


def make_optimizer(
    learning_rate: float | Schedule,
    weight_decay: float = 0.01,
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    translator_lr_factor: float = 1.0,
    moment_dtype: Optional[torch.dtype] = None,
) -> MaskedAdamW:
    """The JAX ``make_optimizer``: masked AdamW (see ``MaskedAdamW``)."""
    return MaskedAdamW(learning_rate, weight_decay, tuple(betas), eps, translator_lr_factor, moment_dtype)


def clip_grad_norm(grads: Mapping[str, torch.Tensor], max_norm: float | torch.Tensor, layout: Any = None
                   ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """torch ``clip_grad_norm_`` semantics, scale = min(1, max_norm / (norm + 1e-6));
    returns the scaled grads and the global norm, both on the device.
    ``layout``: a cut model's ``parallel.tp.TPLayout``; the squares of its
    split gradients are summed over the model group, the replicated
    gradients counted once."""
    squares = [g.float().square().sum() for n, g in grads.items() if layout is None or not layout.is_split(n)]
    norm_sq = torch.stack(squares).sum()
    if layout is not None:
        split = [g.float().square().sum() for n, g in grads.items() if layout.is_split(n)]
        norm_sq = norm_sq + model_sum(torch.stack(split).sum(), layout.grid)
    norm = norm_sq.sqrt()
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm
