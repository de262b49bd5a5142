"""The comparison that decides ``correct``.

The program's first steps against the plain reference's from the same
initial parameters and draws. Adam's first update moves each parameter
entry by about the learning rate in the direction of that entry's
gradient, whatever its size, so an entry whose gradient all but cancels
moves one way or the other with the order of the sum. The hash table's
first gradient is exactly 0 under the geometric init (the first layer
starts with zero weights on the table's features), and its second is
proportional to those weights after that first update: from the second
step on, the table's gradient and everything after it carry this
round-off. So:

- ``loss_gap``: the largest |program - reference| / |reference| of the
  total loss of the first two steps;
- ``grad_gap``: the worst leaf's | |g_program| - |g_reference| |, over
  the larger of the reference's |g| of that leaf and of the median leaf,
  of the first step's gradient (both sides from the same start) and of
  the second step's (the reference's taken at the program's own state
  after its first step: the first gradient that reaches the hash table
  through the ordered scatter). Both as the optimizer took them, worked
  out from its first moment after and before the step;
- ``change_gap``: | |dp_program| - |dp_reference| | / |dp_reference| of
  the median leaf's change in the first step, the median taken over the
  leaves whose first reference gradient is a thousandth of the median
  leaf's or more (a leaf whose gradient is nought moves by round-off
  alone: the hash table, here). Adam's first update of an entry is
  lr * g / (|g| + eps): the worst leaf's change carries the entries
  whose gradient is near eps, the median leaf's does not;
- ``pose_err_deg`` (the init): the relative pose the program estimated
  for its pair, against the scene's: the larger of the rotation error and
  the translation direction's error, in degrees. The reference takes the
  two poses from the program; this checks that stage by itself.

Each number is held to its own limit, which the cell's traffic file
states (``limits``).
"""
import math
import statistics

import numpy as np


def _rel_gap(p, r, floor):
    return abs(p - r) / max(abs(r), floor)


def _worst(gp, gr):
    """(gap, leaf) of the worst leaf of two {leaf: norm} by the measure."""
    med = statistics.median(gr.values())
    return max((_rel_gap(gp[k], g, med), k) for k, g in gr.items())


def gaps(prog, ref):
    """The numbers compared, from the program's {"loss", "grads",
    "change"} and the reference's (with "grads_at2", its second step's
    gradient at the program's state)."""
    moved = {k: g for k, g in ref["grads"][0].items()
             if g >= 1e-3 * statistics.median(ref["grads"][0].values())}
    return {"loss_gap": max(_rel_gap(p, r, 1e-12) for p, r in
                            list(zip(prog["loss"], ref["loss"]))[:2]),
            "grad_gap": max(_worst(prog["grads"][0], ref["grads"][0])[0],
                            _worst(prog["grads"][1], ref["grads_at2"])[0]),
            "change_gap": _median_leaf_gap(prog["change"][0],
                                           {k: ref["change"][0][k] for k in moved})}


def _median_leaf_gap(cp, cr):
    """The relative gap of the leaf whose reference value is the median
    (the lower middle one of an even count)."""
    k = sorted(cr, key=cr.get)[(len(cr) - 1) // 2]
    return _rel_gap(cp[k], cr[k], 1e-30)


def per_step(prog, ref):
    """The look behind the numbers: each step's loss gap; the worst leaf
    (name, gap) of each step's gradient with both sides run on their own,
    and of the second step's at the program's state; the same of each
    step's change."""
    return {"loss_steps": [_rel_gap(p, r, 1e-12) for p, r in zip(prog["loss"], ref["loss"])],
            "grad_steps": [_worst(p, r)[::-1] for p, r in zip(prog["grads"], ref["grads"])],
            "grad_at2": _worst(prog["grads"][1], ref["grads_at2"])[::-1],
            "change_steps": [_worst(p, r)[::-1] for p, r in zip(prog["change"], ref["change"])]}


def pose_error_deg(w2c0, w2c1, gt0, gt1):
    """Rotation and translation-direction error (the larger, degrees) of
    the relative pose w2c1 * w2c0^-1 against the GT one."""
    def rel(a, b):
        Ra, ta, Rb, tb = a[:, :3], a[:, 3], b[:, :3], b[:, 3]
        R = Rb @ Ra.T
        return R, tb - R @ ta
    R, t = rel(np.asarray(w2c0, np.float64), np.asarray(w2c1, np.float64))
    Rg, tg = rel(np.asarray(gt0, np.float64), np.asarray(gt1, np.float64))
    c = np.clip((np.trace(R @ Rg.T) - 1) / 2, -1.0, 1.0)
    ct = np.clip(t @ tg / (np.linalg.norm(t) * np.linalg.norm(tg) + 1e-12), -1.0, 1.0)
    return float(max(math.degrees(math.acos(c)), math.degrees(math.acos(ct))))


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit and finite; a number without a limit fails."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(lim is not None and math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
