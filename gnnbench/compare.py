"""The comparison that decides ``correct``: the numbers read from the
program's outputs against the plain reference's, each held to its limit
(the limits live in each cell's workload file, with the readings they
were set from in ``PERF.md``).

The first steps (the job that set-up drives through the window's own
call, one step and then two resumed from its optimizer state):

* ``loss_gap`` — the largest ``|L - L_ref| / |L_ref|`` over those steps,
  and over the same first steps of every job the run timed;
* ``grad_gap`` — by the worst leaf, the gap between the norms of the
  program's and the reference's first gradient as the optimizer gets it
  (clipped, with the decay), over the larger of that leaf's reference
  norm and the median leaf's;
* ``change_gap`` — the same of each leaf's change over the steps, leaves
  whose reference gradient is under a thousandth of the median leaf's
  left out (they move by round-off alone); ``change_gap_median`` the
  median leaf's, steady where one small leaf's entries, moved by Adam
  about ±lr whatever their gradient's size, swing from seed to seed;
* ``ypred_gap`` — the largest logit gap after the steps over the largest
  reference logit.

Whole jobs (every job the run timed, against one reference job of the
same epochs from the same weights; all of them start alike):

* ``job_loss_gap`` — ``loss_gap`` over every epoch;
* ``job_change_gap_median`` — ``change_gap_median`` of the whole job's
  change.

The closing logits and the worst leaf's change of a whole job are not
compared: the program's own runs spread as far from the reference there
as the control and the planted faults do (``PERF.md``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

_NEGLIGIBLE = 1e-3  # of the median leaf's reference gradient norm


def _norms(leaves: Dict[str, np.ndarray]) -> Dict[str, float]:
    return {k: float(np.linalg.norm(np.asarray(v, dtype=np.float64)))
            for k, v in leaves.items()}


def leaf_norm_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                   keys: Iterable[str]) -> Dict[str, float]:
    """Each leaf of ``keys``: ``|‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖)``."""
    keys = list(keys)
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = float(np.median([rn[k] for k in keys]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def moving_leaves(ref_grad: Dict[str, np.ndarray]):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    rg = _norms(ref_grad)
    med = float(np.median(list(rg.values())))
    return [k for k, v in rg.items() if v >= _NEGLIGIBLE * med]


def loss_gap(losses: Sequence[Sequence[float]], ref_losses: Sequence[float]) -> float:
    """The largest relative gap of ``losses`` (one sequence a job, each
    compared as far as it goes) from ``ref_losses``; a sequence longer
    than the reference's, or one that ends early, fails."""
    ref_l = np.asarray(ref_losses, dtype=np.float64)
    gap = 0.0
    for seq in losses:
        seq = np.asarray(seq, dtype=np.float64)
        if seq.size == 0 or seq.size > ref_l.size:
            return float("inf")
        k = seq.size
        gap = max(gap, float(np.max(np.abs(seq - ref_l[:k]) / np.abs(ref_l[:k]))))
    return gap


def change_gaps(change: Dict[str, np.ndarray], ref_change: Dict[str, np.ndarray],
                ref_grad: Dict[str, np.ndarray]) -> Tuple[float, float]:
    """(worst, median) leaf's change gap over the moving leaves."""
    gaps = list(leaf_norm_gaps(change, ref_change, moving_leaves(ref_grad)).values())
    return max(gaps), float(np.median(gaps))


def logit_gap(ypred: np.ndarray, ref_ypred: np.ndarray) -> float:
    ref_y = np.asarray(ref_ypred, dtype=np.float64)
    y = np.asarray(ypred, np.float64)
    if y.shape != ref_y.shape:
        return float("inf")
    return float(np.max(np.abs(y - ref_y)) / max(float(np.max(np.abs(ref_y))), 1e-30))


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The training numbers of ``prog`` against ``ref``, both as
    ``gnnbench/drivers/train_node.py`` gives them: ``first_losses`` (one
    sequence a job), ``grad``, ``change``, ``ypred`` of the first steps,
    and ``jobs``, each with ``losses`` and ``change`` (the reference has
    one).  A cell's limits name the ones it compares."""
    worst, median = change_gaps(prog["change"], ref["change"], ref["grad"])
    out = {
        "loss_gap": loss_gap(prog["first_losses"], ref["first_losses"][0]),
        "grad_gap": max(leaf_norm_gaps(prog["grad"], ref["grad"], ref["grad"]).values()),
        "change_gap": worst,
        "change_gap_median": median,
        "ypred_gap": logit_gap(prog["ypred"], ref["ypred"]),
    }
    rjob = ref["jobs"][0]
    jobs = prog["jobs"]
    if not jobs:
        return dict(out, job_loss_gap=float("inf"), job_change_gap_median=float("inf"))
    # a job that stops short of the reference's epochs fails job_loss_gap
    out["job_loss_gap"] = max(
        loss_gap([j["losses"]], rjob["losses"]) if len(j["losses"]) == len(rjob["losses"])
        else float("inf") for j in jobs)
    out["job_change_gap_median"] = max(
        change_gaps(j["change"], rjob["change"], ref["grad"])[1] for j in jobs)
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit (a number that is not finite fails)."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = float(readings.get(name, float("inf")))
        out[name] = {"value": value, "limit": float(limit)}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, out
