"""The numbers that decide ``correct``: the program's outputs against the reference's.

Training (a record from ``reference/train.py`` or from the program's run):

* ``logit_err``: the largest relative L2 error ||logits - reference|| /
  ||reference|| of a step's train-mode logits over the steps the reference
  follows (a DANN step's source logits);
* ``loss_gap``: the largest |loss - reference| / |reference| over those
  steps;
* ``grad_norm_gap``: over the leaves, the largest gap between the norm of
  the first step's gradient as the optimizer holds it and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf;
* ``update_norm_gap``: the same of each leaf's change after the first
  update.

Both leave out the leaves whose reference gradient is under a thousandth of
the median leaf's: the conv biases that feed a train-mode BatchNorm, whose
exact gradient is 0. The program's is its round-off (in bf16 the first
conv's bias reads up to 0.9 of the median leaf's norm), and Adam moves them
by that round-off normalised.
"""

from __future__ import annotations

import statistics

from gpubench.common import say

ZERO_GRAD_SHARE = 1e-3


def worst_leaf_gap(prog: dict, ref: dict, keep=None, label: str = "") -> float:
    leaves = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in ref)
    gaps = sorted(((abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30), k)
                   for k in leaves), reverse=True)
    if label:
        say(f"gpubench: {label} worst leaves (gap, leaf, program, reference; median "
            f"{median:.4g}): " + "; ".join(f"{g:.4g} {k} {prog.get(k, 0.0):.4g} {ref[k]:.4g}"
                                          for g, k in gaps[:3]))
    return gaps[0][0]


def _moving(grad_norms: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's (a conv bias that feeds a
    train-mode BatchNorm has the exact gradient 0)."""
    floor = ZERO_GRAD_SHARE * statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v >= floor}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``ref`` is the reference's record made with the program's logits to
    judge (``reference.train.Logits(other=...)``)."""
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    logit_err = ref["logits"] if len(ref["logits"]) == len(ref["losses"]) else [float("inf")]
    say(f"gpubench: loss gaps {[f'{x:.3g}' for x in losses]}, logit errors "
        f"{[f'{x:.3g}' for x in logit_err]}")
    return {"loss_gap": max(losses), "logit_err": max(logit_err),
            "grad_norm_gap": worst_leaf_gap(prog["first_grad"], ref["first_grad"],
                                            _moving(ref["first_grad"]), "first gradient"),
            "update_norm_gap": worst_leaf_gap(prog["update"], ref["update"],
                                              _moving(ref["applied_grad"]), "first update")}


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {value, limit}} for every limit the cell states."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"the cell limits {missing}, which its loop does not compare")
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}
