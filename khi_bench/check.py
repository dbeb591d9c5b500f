"""The comparison that decides ``correct``: the program's answers for a
seeded sample of the window's requests against the plain reference.

Each number is compared with its limit from the cell's file
(``cells/<workload>.json``):

* ``dist_rel_gap``: the widest relative gap, over every returned id of the
  sample, between the distance the program reported and the float64
  distance of that id's row to the query;
* ``short_lanes``: sampled lanes that return fewer distinct ids than
  min(k, rows in the box) (limit 0);
* ``exact_lane_misses``: sampled lanes that the planner sent to the exact
  scan and that miss a hit (limit 0): a returned id is a hit when its
  exact distance is within a relative 1e-5 of the k-th exact distance in
  its box, so ties count;
* ``box_violations``: returned ids outside [0, n) or outside their box
  (limit 0);
* ``order_violations``: answers with a repeated id, distances out of
  ascending order, or a -1 before a valid id (limit 0);
* ``recall_miss``: 1 - the sample's mean recall@k (hits out of min(k,
  rows in the box)), the share of the true neighbours that the search
  did not find. It judges which ids the router and the hop loop return:
  its limit lies between sound runs and a search cut short (``ef = k``,
  one hop). The mean recall itself is the end-to-end metric
  ``recall_at_k``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import reference

__all__ = ["TIE_RTOL", "NUMBERS", "judge", "compare"]

TIE_RTOL = 1e-5
NUMBERS = ("dist_rel_gap", "short_lanes", "exact_lane_misses",
           "box_violations", "order_violations", "recall_miss")


def judge(vecs: torch.Tensor, attrs: torch.Tensor, q: np.ndarray,
          lo: np.ndarray, hi: np.ndarray, ids: np.ndarray, dists: np.ndarray,
          k: int, scan_lane: Optional[np.ndarray] = None) -> Dict:
    """Numbers of one sample: q/lo/hi the sampled requests, ids/dists the
    program's answers (B, k), ``scan_lane`` (B,) bool which lanes the
    planner scanned exactly. -> {number: value} plus ``recall_at_k``,
    ``lanes`` and ``box_rows`` (quantiles of the sample's box sizes)."""
    dev = vecs.device
    n = vecs.shape[0]
    qt = torch.as_tensor(q, device=dev)
    lt = torch.as_tensor(lo, device=dev)
    ht = torch.as_tensor(hi, device=dev)
    _, t_d, count = reference.exact_topk(vecs, attrs, qt, lt, ht, k)
    pid = torch.as_tensor(ids.astype(np.int64), device=dev)
    pd = torch.as_tensor(dists.astype(np.float64), device=dev)
    valid = pid >= 0
    safe = torch.where(valid & (pid < n), pid, torch.zeros_like(pid))
    d64 = reference.dist64(vecs, qt, pid)
    # ids out of range or outside the box
    inside = reference.in_box(attrs[safe], lt[:, None], ht[:, None])
    bad_box = valid & ((pid >= n) | ~inside)
    bad_box |= (pid < -1)
    box_violations = int(bad_box.sum())
    # order: no repeats, ascending distances, -1 (with +inf) only at the end
    srt = torch.sort(torch.where(valid, pid, torch.full_like(pid, -1)),
                     dim=1).values
    repeat = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
    descending = (torch.where(valid[:, 1:] & valid[:, :-1],
                              pd[:, 1:] < pd[:, :-1],
                              torch.zeros_like(valid[:, 1:]))).any(1)
    hole = (~valid[:, :-1] & valid[:, 1:]).any(1)
    pad_not_inf = (~valid & ~torch.isinf(pd)).any(1) | (
        valid & ~torch.isfinite(pd)).any(1)
    order_violations = int((repeat | descending | hole | pad_not_inf).sum())
    # reported against exact distances of the same ids
    ok = valid & ~bad_box & torch.isfinite(d64)
    gap = (pd - d64).abs() / d64.clamp_min(1e-30)
    dist_rel_gap = float(gap[ok].max()) if bool(ok.any()) else 0.0
    # recall with ties: hits within TIE_RTOL of the k-th exact distance
    need = count.clamp(max=k)
    kth = t_d.gather(1, (need - 1).clamp_min(0)[:, None])[:, 0]
    distinct_ids = (srt >= 0)
    distinct_ids[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    short_lanes = int((distinct_ids.sum(1) < need).sum())
    # count each id once: distinct hit ids of a lane
    hit = ok & (d64 <= kth[:, None] * (1 + TIE_RTOL))
    hs = torch.sort(torch.where(hit, pid, torch.full_like(pid, -1)),
                    dim=1).values
    distinct = hs >= 0
    distinct[:, 1:] &= hs[:, 1:] != hs[:, :-1]
    uniq_hit = distinct.sum(1)
    has = need > 0
    rec = torch.where(has, uniq_hit.clamp(max=k).double()
                      / need.clamp_min(1).double(),
                      torch.ones_like(need, dtype=torch.float64))
    recall = float(rec[has].mean()) if bool(has.any()) else 1.0
    exact_misses = 0
    if scan_lane is not None:
        sl = torch.as_tensor(scan_lane, device=dev)
        exact_misses = int((sl & has & (uniq_hit < need)).sum())
    cq = torch.quantile(count.double(), torch.tensor(
        [0.0, 0.05, 0.5, 0.95, 1.0], dtype=torch.float64, device=dev))
    return {"dist_rel_gap": dist_rel_gap,
            "short_lanes": short_lanes,
            "exact_lane_misses": exact_misses,
            "box_violations": box_violations,
            "order_violations": order_violations,
            "recall_miss": 1.0 - recall,
            "recall_at_k": recall,
            "lanes": int(pid.shape[0]),
            "scan_lanes_sampled": (int(np.sum(scan_lane))
                                   if scan_lane is not None else 0),
            "box_rows": [int(x) for x in cq.tolist()]}


def compare(numbers: Dict, limits: Dict) -> Dict:
    """{name: {"value", "limit", "ok"}} for every number of ``NUMBERS``;
    a number passes at or under its limit."""
    out = {}
    for name in NUMBERS:
        v, lim = numbers[name], limits[name]
        out[name] = {"value": v, "limit": lim, "ok": bool(v <= lim)}
    return out
