"""Tensor parallelism over a model group of processes (port of theia_tpu/parallel/tp.py).

The JAX package shards parameters with PartitionSpecs over the mesh's
"model" axis and lets the SPMD partitioner insert the collectives. The
port runs one process a card, so the cut is made by hand, Megatron's way:
each rank of a model group (``parallel/mesh.py``) keeps its slice of every
split parameter (``shard_module``), and the forward passes the activations
through two autograd functions over the group, the collectives GSPMD
inserts for the JAX package:

  ``copy_to_model``      identity forward, all-reduce backward: the input
                         of a column-parallel layer (each rank's slice of
                         the output features sends back a part of dx);
  ``reduce_from_model``  all-reduce forward, identity backward: the output
                         of a row-parallel layer, a partial sum over the
                         rank's input features, summed before its bias.

The cut (the JAX ``_backbone_spec``, ``_ladder_plan`` and
``_head_divisible``, tp.py:68-180), as dimensions of the port's layouts
(``Linear`` [out, in], ``Conv2d`` [O, I, k, k], ``ConvTranspose2d`` [I, O,
k, k], ``LayerNormSpatial`` (C, H, W)):

  block query/key/value    column: weight and bias on out, by head ranges;
                           the packed QKV of a rank is [q_r; k_r; v_r]
  block attention output   row: weight on in; bias after the reduce
  block intermediate       column
  block output             row
  head ladders             conv and dense layers alternate column and row
                           in ``adapter.<i>`` order; a LayerNormSpatial is
                           split on C where the running activation is; the
                           ``pad`` pre-conv is replicated

A head whose dimensions the model axis does not divide stays replicated,
with a warning, and the backbone still shards. Everything else (embedding,
LayerNorms, unsplit head layers) is replicated: every rank of the group
computes it whole. A LayerNormSpatial on a channel-split map all-reduces
its per-sample sums (``ops/ln_pallas.py``); a prediction whose features
stay split reaches the loss split, and the loss all-reduces its
per-sample sums (``models/losses.py``). Every collective here is float32
on the wire, whatever the compute dtype (the JAX package's model-axis
all-reduces are float32 on the CPU, where its bf16 matmuls and convs run
in float32).

Only the lconv translator is cut: the mlp, conv and transformer
translators raise under ``model_axis > 1`` (their plans are the JAX
package's all the same, ``tp_plan``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping, Optional

import torch
from torch import nn

from theia_tpu_torch.parallel.distributed import all_gather, all_reduce
from theia_tpu_torch.parallel.mesh import Grid

# the block's dense layers: (weight dim, bias dim) of the split, None replicated
_BLOCK_SPLITS = {
    "attention.attention.query": (0, 0),
    "attention.attention.key": (0, 0),
    "attention.attention.value": (0, 0),
    "attention.output.dense": (1, None),
    "intermediate.dense": (0, 0),
    "output.dense": (1, None),
}
_BLOCK_PREFIX = "backbone.model.encoder.layer."
_HEADS_PREFIX = "translator.translator_heads."


def validate_tp(num_heads: int, intermediate_size: int, n_model: int) -> None:
    if n_model <= 1:
        return
    if num_heads % n_model or intermediate_size % n_model:
        raise ValueError(
            f"model axis {n_model} must divide num_heads={num_heads} and "
            f"intermediate_size={intermediate_size} for tensor parallelism"
        )


# ---------------------------------------------------------------- the plan


def _is_layer_norm_spatial(m: nn.Module) -> bool:
    w = getattr(m, "weight", None)
    return isinstance(w, torch.Tensor) and w.ndim == 3


def ladder_roles(head: nn.Module) -> dict[str, str]:
    """Role per parameterised submodule of a head, by its name in the head:
    "col" | "row" | "ln_shard" | "repl" (the JAX ``_ladder_plan``)."""
    roles: dict[str, str] = {}
    if getattr(head, "pad", None) is not None:
        roles["pad"] = "repl"
    ordinal = 0  # conv/dense counter: even -> column parallel, odd -> row
    shard_c = False  # is the running activation channel-split here?
    for i, m in enumerate(head.adapter):
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            col = ordinal % 2 == 0
            roles[f"adapter.{i}"] = "col" if col else "row"
            shard_c = col
            ordinal += 1
        elif _is_layer_norm_spatial(m):
            roles[f"adapter.{i}"] = "ln_shard" if shard_c else "repl"
    return roles


def _param_dim(m: nn.Module, pname: str, role: str) -> Optional[int]:
    """The dimension ``role`` splits ``m``'s parameter ``pname`` on."""
    transposed = isinstance(m, nn.ConvTranspose2d)  # [I, O, k, k]
    if role == "col":
        return 0 if pname == "bias" else int(transposed)
    if role == "row":
        return None if pname == "bias" else 1 - int(transposed)
    if role == "ln_shard":
        return 0
    return None


def _head_divisible(head: nn.Module, roles: Mapping[str, str], n_model: int) -> bool:
    """True iff every dimension the roles would split divides n_model."""
    for name, role in roles.items():
        m = head.get_submodule(name)
        for pname, p in m.named_parameters(recurse=False):
            d = _param_dim(m, pname, role)
            if d is not None and p.shape[d] % n_model:
                return False
    return True


@dataclasses.dataclass(frozen=True)
class Plan:
    """``dims``: the split dimension of every parameter of the model, by
    name (None: replicated); ``roles``: the role of every split layer and
    split LayerNormSpatial, by module name; ``split_heads``: the head keys
    whose output features stay split."""

    dims: dict[str, Optional[int]]
    roles: dict[str, str]
    split_heads: tuple[str, ...]


def tp_plan(model: nn.Module, n_model: int) -> Plan:
    """The cut of ``model`` (a ``Theia``) over ``n_model`` ranks; an
    indivisible head is replicated with a warning."""
    dims: dict[str, Optional[int]] = {n: None for n, _ in model.named_parameters()}
    for name in dims:
        if name.startswith(_BLOCK_PREFIX):
            sub, _, pname = name[len(_BLOCK_PREFIX):].partition(".")[2].rpartition(".")
            if sub in _BLOCK_SPLITS:
                dims[name] = _BLOCK_SPLITS[sub][pname == "bias"]
    roles: dict[str, str] = {}
    split_heads = []
    heads = getattr(getattr(model, "translator", None), "translator_heads", None) or {}
    for key, head in heads.items():
        head_roles = ladder_roles(head)
        if n_model > 1 and not _head_divisible(head, head_roles, n_model):
            warnings.warn(
                f"head TP: {key} has dimensions not divisible by model_axis={n_model}; "
                "replicating this head (backbone TP unaffected)"
            )
            continue
        last = None
        for name, role in head_roles.items():
            full = f"{_HEADS_PREFIX}{key}.{name}"
            m = head.get_submodule(name)
            for pname, _ in m.named_parameters(recurse=False):
                dims[f"{full}.{pname}"] = _param_dim(m, pname, role)
            if role != "repl":
                roles[full] = role
            if role in ("col", "row"):
                last = role
        if last == "col":
            split_heads.append(key)
    return Plan(dims, roles, tuple(split_heads))


# -------------------------------------------- collectives as autograd functions


def model_sum(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The sum of ``t`` over the model group, float32, in a new tensor (no
    autograd: the functions below are the differentiable forms)."""
    return all_reduce(t.to(torch.float32, copy=True), group=grid.model_group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, grid: Grid) -> torch.Tensor:
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return model_sum(g, ctx.grid).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, grid: Grid) -> torch.Tensor:
        ctx.dtype = x.dtype
        return model_sum(x, grid)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.to(ctx.dtype), None


class _SumOverModel(torch.autograd.Function):
    """All-reduce forward and backward: a sum over the group consumed by
    each rank's own slice (a LayerNormSpatial's statistics)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, grid: Grid) -> torch.Tensor:
        ctx.grid, ctx.dtype = grid, x.dtype
        return model_sum(x, grid).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return model_sum(g, ctx.grid).to(ctx.dtype), None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' slices of the last dimension, whole, in rank order;
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, grid: Grid) -> torch.Tensor:
        ctx.grid, ctx.width = grid, x.shape[-1]
        return torch.cat(all_gather(x, grid.model_group), dim=-1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.narrow(-1, ctx.grid.model_index * ctx.width, ctx.width), None


def copy_to_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Identity; the gradient is summed over the model group."""
    return _CopyToModel.apply(x, grid)


def reduce_from_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The float32 sum of the ranks' partial ``x``; the gradient passes as it is."""
    return _ReduceFromModel.apply(x, grid)


def sum_over_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The sum of ``x`` over the model group, forward and backward."""
    return _SumOverModel.apply(x, grid)


def gather_from_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The whole last dimension from the ranks' slices of it."""
    return _GatherFromModel.apply(x, grid)


def row_parallel_out(partial: torch.Tensor, bias: Optional[torch.Tensor], grid: Grid, dtype: torch.dtype,
                     channel_dim: int = -1) -> torch.Tensor:
    """A row-parallel layer's output: its partial sum reduced over the model
    group in float32, plus the bias (on ``channel_dim``), in ``dtype``."""
    y = reduce_from_model(partial, grid)
    if bias is not None:
        shape = [1] * y.dim()
        shape[channel_dim] = -1
        y = y + bias.float().view(shape)
    return y.to(dtype)


# ------------------------------------------------------------- the cut itself


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """A sharded model's split dimensions and grid: what checkpoints and the
    step need. ``split_outputs`` maps a teacher to True where its predicted
    features stay split over the model group."""

    grid: Grid
    dims: dict[str, Optional[int]]
    split_outputs: dict[str, bool]

    def is_split(self, name: str) -> bool:
        return self.dims.get(name) is not None

    def slice(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor of parameter ``name`` (or of
        a moment shaped like it)."""
        d = self.dims.get(name)
        if d is None:
            return whole
        size = whole.shape[d] // self.grid.n_model
        return whole.narrow(d, self.grid.model_index * size, size).contiguous()

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from the model group's slices of it (a collective
        for split names; every rank of the group must call it)."""
        d = self.dims.get(name)
        if d is None:
            return local.detach()
        return torch.cat(all_gather(local.detach(), self.grid.model_group), dim=d)


def slice_state(tree: Mapping[str, torch.Tensor], layout: TPLayout) -> dict[str, torch.Tensor]:
    """A whole state dict (parameters, or moments by parameter name) -> this rank's slices."""
    return {n: layout.slice(n, t) for n, t in tree.items()}


def gather_state(tree: Mapping[str, torch.Tensor], layout: TPLayout) -> dict[str, torch.Tensor]:
    """This rank's slices -> the whole tensors, gathered over the model group."""
    return {n: layout.gather(n, t) for n, t in tree.items()}


def shard_module(model: nn.Module, grid: Grid) -> Optional[TPLayout]:
    """Cut ``model`` (a ``Theia`` with the lconv translator, or none) over
    ``grid``'s model group, in place: every split parameter keeps this
    rank's slice, and the blocks, the split layers and the split
    LayerNormSpatials learn the grid. Run after ``broadcast_module`` (every
    rank must start from the same whole parameters) and before the
    optimizer's state is made. Returns the layout, also kept as
    ``model.tp_layout``; None (and nothing done) where ``n_model`` is 1."""
    n = grid.n_model
    if n <= 1:
        return None
    from theia_tpu_torch.models.translators import LightConvFeatureTranslator, head_key

    translator = getattr(model, "translator", None)
    if translator is not None and not isinstance(translator, LightConvFeatureTranslator):
        raise NotImplementedError(
            f"training.model_axis={n}: tensor parallelism cuts the lconv translator only, "
            f"not {type(translator).__name__}"
        )
    cfg = model.backbone.cfg
    validate_tp(cfg.num_heads, cfg.intermediate_size, n)
    plan = tp_plan(model, n)
    teachers = translator.target_feature_sizes if translator is not None else {}
    layout = TPLayout(grid, plan.dims, {t: head_key(t) in plan.split_heads for t in teachers})
    with torch.no_grad():
        for name, p in model.named_parameters():
            if plan.dims[name] is not None:
                p.data = layout.slice(name, p.data).clone()
    for block in model.backbone.model.encoder["layer"]:
        block.tp = grid
    for name, role in plan.roles.items():
        m = model.get_submodule(name)
        m.tp = grid
        if role in ("col", "row"):
            m.tp_role = role
    model.tp_layout = layout
    return layout


def split_outputs(model: nn.Module) -> dict[str, Grid]:
    """Teacher -> grid for every prediction of ``model`` whose features stay
    split over the model group; empty for a model that is not cut."""
    layout: Optional[TPLayout] = getattr(model, "tp_layout", None)
    if layout is None:
        return {}
    return {t: layout.grid for t, split in layout.split_outputs.items() if split}

