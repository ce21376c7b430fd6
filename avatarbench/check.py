"""The numbers that decide `correct`, and their limits.

Train cells compare the first steps after an epoch start of the measured
window (the program's state restored to the initial one) with the
reference's steps on the same views from the same inputs:

- `loss_gap`: the largest relative gap between the two total losses over
  the checked steps; `loss1_gap`: the same for the first step alone,
  steadier from seed to seed (the later steps carry Adam's first update,
  which moves every element by a full learning rate whatever its
  gradient's size, round-off near zero included);
- `grad_gap`: over the leaves (every trained tensor, and the
  densification statistic after step 1), the largest gap between the
  program's gradient norm, read from its first Adam moment after step 1,
  and the reference's, relative to the reference leaf's norm or the
  median leaf's, whichever is larger;
- `change_gap`: the same for the norm of each leaf's change over the
  checked steps. Leaves whose reference gradient is under a thousandth of
  the median leaf's move under Adam by round-off alone and are left out.

Replay cells compare the sampled frames on the host with the reference's
frames, converted the same way: `level_gap_max`, the largest gap in uint8
levels, and `level_gap_mean`, the mean gap over every value compared.
"""

from __future__ import annotations

import statistics

import numpy as np

TINY_GRAD = 1e-3


def _gap(p, r, floor):
    return abs(p - r) / max(r, floor, 1e-30)


def train_numbers(prog: dict, ref: dict) -> dict:
    if "grad" not in prog or "grad" not in ref:
        return dict(loss_gap=None, loss1_gap=None, grad_gap=None,
                    change_gap=None, _detail=dict(reading="none"))
    losses = [_gap(p, abs(r), 0.0) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    med_g = statistics.median(ref["grad"])
    grads = [_gap(p, r, med_g) for p, r in zip(prog["grad"], ref["grad"])]
    names = ref["names"] + ["stats.grad_accum"]
    moved = [i for i, g in enumerate(ref["grad"][:len(ref["names"])])
             if g >= TINY_GRAD * med_g]
    med_c = statistics.median([ref["change"][i] for i in moved])
    change = {i: _gap(prog["change"][i], ref["change"][i], med_c)
              for i in moved}
    worst_g = max(range(len(grads)), key=grads.__getitem__)
    worst_c = max(change, key=change.get)
    return dict(loss_gap=max(losses), loss1_gap=losses[0],
                grad_gap=grads[worst_g],
                change_gap=change[worst_c],
                _detail=dict(k0=prog.get("k0"), grad_leaf=names[worst_g],
                             change_leaf=names[worst_c],
                             left_out=[names[i] for i in range(
                                 len(ref["names"])) if i not in moved]))


def frame_numbers(prog: dict, ref: dict) -> dict:
    gaps = [np.abs(prog[i].astype(np.int16) - ref[i].astype(np.int16))
            for i in sorted(ref) if i in prog]
    if not gaps:
        return dict(level_gap_max=None, level_gap_mean=None,
                    _detail=dict(frames=0))
    return dict(level_gap_max=float(max(g.max() for g in gaps)),
                level_gap_mean=float(np.mean([g.mean() for g in gaps])),
                _detail=dict(frames=len(gaps)))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and finite."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and bool(np.isfinite(value)) \
            and value <= limit
        ok = ok and good
        finite = value is not None and bool(np.isfinite(value))
        out[name] = {"value": value if finite else None, "limit": limit}
    return ok, out
