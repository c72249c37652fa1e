"""The numbers that decide ``correct``: the program against the plain reference.

Training (one trajectory a side, from the same parameters over the same
batches):
  - ``loss_gap``: the widest relative gap of a step's loss;
  - ``grad_gap``: the worst parameter's gap between the norms of the first
    gradient (the program's read back from Adam's first moment after one
    step), over the larger of that parameter's reference norm and the
    median parameter's;
  - ``update_gap``: the same for the norm of each parameter's change over
    the checked steps;
  - ``grad_diff``: the worst parameter's norm of the difference of the two
    first gradients, over the same denominator. A gap of norms moves only
    to second order under rounding that is random, so it cannot tell bf16
    from fp8; the norm of the difference does.
A parameter whose reference gradient is under a thousandth of the median
parameter's (a key's bias, which the softmax cancels) moves by round-off
alone and is left out of the gradients' and changes' numbers.

Serving: ``feature_rel_l2``, the worst sampled batch's relative L2 distance
of the served features from the reference's on the same images.
"""

from __future__ import annotations

import math
import statistics

import torch

SKIP_BELOW = 1e-3


def train_numbers(prog: dict, ref: dict) -> tuple[dict[str, float], dict[str, str]]:
    """(numbers, the parameter each norm's gap is worst at)."""
    index = {n: i for i, n in enumerate(prog["names"])}
    order = [index[n] for n in ref["names"]]
    pg = [prog["grad_norm"][i] for i in order]
    pd = [prog["change_norm"][i] for i in order]
    rg, rd = ref["grad_norm"], ref["change_norm"]
    med_g = statistics.median(rg)
    keep = [i for i, g in enumerate(rg) if g >= SKIP_BELOW * med_g]
    med_d = statistics.median(rd[i] for i in keep)

    def worst(a: list[float], b: list[float], med: float) -> tuple[float, str]:
        gaps = [(abs(a[i] - b[i]) / max(b[i], med), ref["names"][i]) for i in keep]
        return max(gaps)

    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    grad_gap, grad_at = worst(pg, rg, med_g)
    update_gap, update_at = worst(pd, rd, med_d)
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap}
    where = {"grad_gap": grad_at, "update_gap": update_at}
    diffs = []
    for i in keep:
        name = ref["names"][i]
        want = ref["first_grad"][name]
        got = prog["first_grad"][name].to(want.device, torch.float32)
        diffs.append((float((got - want).norm()) / max(rg[i], med_g), name))
    numbers["grad_diff"], where["grad_diff"] = max(diffs)
    return numbers, where


def rel_l2(a, b) -> float:
    """||a − b|| / ||b|| over whole tensors, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Correct where every number the cell limits is there, finite and
    within its limit (a cell may leave a number that separates nothing
    uncompared); a cell without limits is never correct."""
    return bool(limits) and all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= v
                                for k, v in limits.items())
