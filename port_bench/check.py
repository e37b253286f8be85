"""The numbers that decide ``correct``: what the program's timed path
produced against what the plain reference computes from the same inputs.

Training (every step of the first epoch, as the program's own epoch ran
them: the eager warm-up steps and the CUDA graph's replays, which the
window then replays):
  loss_gap    the largest relative gap of a step's loss;
  logit_gap   the largest relative gap of a step's joint-head logits
              (the norm of their difference over the reference's norm);
  grad_gap    the worst leaf's gap between the norms of the first
              gradient as Adam takes it (read from the program's first
              moments after one step: m / (1 - beta1)), over the larger of
              the reference leaf's norm and the median leaf's;
  update_gap  the same for the parameters' change over the epoch, leaves
              whose reference gradient is under a thousandth of the median
              leaf's left out (they move by round-off alone);
  count_gap   the largest gap of an evaluator counter, as a share of the
              pixels counted;
  vote_gap    the share of the anomaly votes that differ;
  steps_off   the steps, pixels and timeline coverage counted, and the
              steps recorded, which must agree exactly.
Evaluation (every epoch the program ran, against one pass of the
reference over every sample): loss_gap over each loss component's epoch
sum, count_gap, and vote_gap and steps_off of the last epoch; and of the
first epoch, step by step against the sample the step read: logit_gap
and sample_loss_gap (the largest relative gap of a sample's loss).
"""

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

COUNTS = ("correct", "seen", "iou_de", "predicted")


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-12)


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The worst leaf's gap of norms, over the larger of the reference
    leaf's norm and the median leaf's."""
    med = float(np.median(list(ref.values())))
    return max(abs(prog[k] - r) / max(r, med, 1e-30) for k, r in ref.items())


def _worst(prog: Dict[str, float], ref: Dict[str, float]):
    """The three leaves with the largest gaps (leaf_gap's measure)."""
    med = float(np.median(list(ref.values())))
    gaps = {k: abs(prog[k] - r) / max(r, med, 1e-30) for k, r in ref.items()}
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]


def _count_gap(counts: Dict[str, float], ref) -> float:
    return max(abs(float(counts[k]) - ref.counts[k])
               / ref.counts["seen_all"] for k in COUNTS)


def _counters(counts: Dict[str, float], vote_sum, vote_cnt, n_steps,
              ref) -> Dict[str, float]:
    seen_all = ref.counts["seen_all"]
    count_gap = _count_gap(counts, ref)
    rv = ref.vote_sum.cpu().numpy().astype(np.int64)
    pv = np.asarray(vote_sum).astype(np.int64)
    V, _, H, W = rv.shape
    voted = V * H * W * int(ref.vote_cnt.sum())
    vote_gap = float(np.abs(pv - rv).sum()) / max(voted, 1)
    steps_off = (abs(int(n_steps) - ref.n_steps)
                 + abs(int(counts["seen_all"]) - seen_all)
                 + int(np.abs(np.asarray(vote_cnt).astype(np.int64)
                              - ref.vote_cnt.cpu().numpy()).sum()))
    return {"count_gap": count_gap, "vote_gap": vote_gap,
            "steps_off": float(steps_off)}


def _step_losses(record: dict) -> List[float]:
    """Each recorded step's loss, from the epoch's running sums."""
    totals = [float(r["loss"]) for r in record["losses"]]
    return [b - a for a, b in zip([0.0] + totals[:-1], totals)]


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The norm of the logits' difference over the reference's norm."""
    p, r = prog.double(), ref.double()
    return float((p - r).norm() / r.norm().clamp(min=1e-30))


def train_numbers(record: dict, ref: dict, P0: Dict[str, torch.Tensor],
                  beta1: float, detail: Optional[dict] = None
                  ) -> Dict[str, float]:
    """``record``: the program's first epoch step by step (system.py), on
    the host; ``ref``: reference/steps.py::train_steps, on the host.
    ``detail`` gets the worst leaves' names and each step's gaps."""
    n = len(ref["losses"])
    got = _step_losses(record)
    k = min(n, len(got))
    steps = [_rel(got[i], ref["losses"][i]["loss"]) for i in range(k)]
    logits = [logit_gap(record["z"][i], ref["z"][i]) for i in range(k)]
    g_prog = {key: v / (1.0 - beta1) for key, v in record["exp_avg"].items()}
    grad_gap = leaf_gap(_norms(g_prog), _norms(ref["first_grad"]))
    gn = ref["grad_norm"]
    med = float(np.median(list(gn.values())))
    moved = [key for key, v in gn.items() if v >= 1e-3 * med]
    d_prog = {key: record["params"][key] - P0[key] for key in moved}
    d_ref = {key: ref["params"][key] - P0[key] for key in moved}
    update_gap = leaf_gap(_norms(d_prog), _norms(d_ref))
    if detail is not None:
        detail.update(step_loss_gaps=steps, step_logit_gaps=logits,
                      left_out=sorted(set(gn) - set(moved)),
                      grad_worst=_worst(_norms(g_prog),
                                        _norms(ref["first_grad"])),
                      update_worst=_worst(_norms(d_prog), _norms(d_ref)))
    out = {"loss_gap": max(steps, default=math.inf),
           "logit_gap": max(logits, default=math.inf),
           "grad_gap": grad_gap, "update_gap": update_gap}
    m = record["metrics"]
    out.update(_counters(m["counts"], m["vote_sum"], m["vote_cnt"],
                         m["n_steps"], ref["counters"]))
    out["steps_off"] += abs(len(got) - n) + abs(len(record["z"]) - n)
    return out


def eval_numbers(record: dict, epochs: List[dict], last: dict, ref: dict,
                 order: Sequence[int], detail: Optional[dict] = None
                 ) -> Dict[str, float]:
    """``record``: the program's first epoch step by step; ``epochs``:
    each epoch's loss sums, counts and step count (host); ``last``: the
    last epoch's whole metrics; ``ref``: reference/steps.py::eval_epoch,
    on the host; ``order``: the sample each step of the first epoch
    reads. ``detail`` gets each loss component's largest gap and each
    step's gaps."""
    loss_gap = 0.0
    count_gap = 0.0
    for m in epochs:
        for k, r in ref["loss_sums"].items():
            p = float(m["loss_sums"][k])
            gap = 0.0 if p == r == 0.0 else _rel(p, r)
            loss_gap = max(loss_gap, gap)
            if detail is not None:
                detail[k] = max(detail.get(k, 0.0), gap)
        count_gap = max(count_gap, _count_gap(m["counts"], ref["counters"]))
    got = _step_losses(record)
    n = len(order)
    k = min(n, len(got))
    samples = [_rel(got[i], ref["losses"][int(order[i])]["loss"])
               for i in range(k)]
    logits = [logit_gap(record["z"][i], ref["z"][int(order[i])])
              for i in range(k)]
    if detail is not None:
        detail.update(sample_loss_gaps=samples, step_logit_gaps=logits)
    out = _counters(last["counts"], last["vote_sum"], last["vote_cnt"],
                    last["n_steps"], ref["counters"])
    out["steps_off"] += abs(len(got) - n) + abs(len(record["z"]) - n)
    out.update(loss_gap=loss_gap, count_gap=count_gap,
               sample_loss_gap=max(samples, default=math.inf),
               logit_gap=max(logits, default=math.inf))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that the cell compares (those with a limit) within its
    limit; a number that is not finite is not."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items())
