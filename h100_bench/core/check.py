"""The numbers that decide ``correct``, each held against its limit.

A training cell compares, over the first three steps that set-up drives
through the window's own call and again over the first three of the
window's last epoch (the reference there starts from the program's
parameters and optimizer state as that epoch began), each number taken
at the worse of the two: each step's loss (``loss_gap``, the
largest relative gap), the norm of the first gradient as the optimizer
holds it after one step (``grad_gap``) and the norm of the parameters'
change after three steps (``update_gap``), both by the worst leaf: the
gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf. The same gaps
of the input layer's weight, the leaf that multiplies the frames
(``grad_gap_input``, ``update_gap_input``), are steady from seed to seed
where the worst leaf's swing with the rounding of the output layer's
gradient: at initialisation the embeddings are nearly parallel, and the
cosine's gradient there is a difference of nearly equal terms (PERF.md,
section 2). The change
leaves out leaves whose reference gradient is under a thousandth of the
median leaf's (none is, in these configurations: every weight and bias
of a sigmoid tower gets a gradient). ``bad_pairs`` counts pairs of those
batches that are not input pairs with their label.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np


def _leaf_gaps(side: Dict[str, float], ref: Dict[str, float], keys):
    """Per leaf: |program's norm - reference's| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return [abs(side[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


TRAIN_NUMBERS = ("loss_gap", "grad_gap", "update_gap", "grad_gap_input",
                 "update_gap_input")


def train_numbers(side: dict, ref: dict, input_leaf: str) -> Dict[str, float]:
    losses = [abs(a - b) / abs(b) for a, b in zip(side["losses"],
                                                   ref["losses"])]
    if len(side["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    g = ref["grad_norms"]
    med_g = float(np.median(list(g.values())))
    moved = [k for k, v in g.items() if v >= 1e-3 * med_g]
    grad = _leaf_gaps(side["grad_norms"], g, g)
    update = _leaf_gaps(side["update_norms"], ref["update_norms"], moved)
    at = list(g).index(input_leaf)
    return {"loss_gap": max(losses),
            "grad_gap": max(grad), "update_gap": max(update),
            "grad_gap_input": grad[at],
            "update_gap_input": update[moved.index(input_leaf)]}


def worst(parts) -> Dict[str, float]:
    """Each number at its largest over ``parts`` (a NaN wins)."""
    out = {}
    for part in parts:
        for k, v in part.items():
            have = out.get(k, v)
            out[k] = v if (v != v or v > have) else have
    return out


def decide(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every limited number within its
    limit (a NaN is never within)."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        ok = ok and bool(v <= limit)
        out[name] = {"value": v, "limit": limit}
    return ok, out


def print_checks(table: dict) -> None:
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for name, e in table.items():
        print(f"check {name}: {e['value']!r} (limit {e['limit']!r})",
              file=sys.stderr, flush=True)
