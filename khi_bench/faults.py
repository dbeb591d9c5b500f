"""Faults planted under the timed path, for the tests that show ``correct``
coming out false. Each takes the cell and its service and returns a
stand-in for ``svc.search``."""

from __future__ import annotations

import numpy as np

__all__ = ["FAULTS", "SHORT_SEARCHES", "half_batch", "altered", "stale",
           "ef_k", "one_hop"]

# searches cut short, as {name: changed search parameters}: the graph
# program returns ids from the box at their exact distances, but fewer of
# the true neighbours. ``ef = k`` keeps a pool of k; one hop expands the
# routed entries once.
SHORT_SEARCHES = {"ef_k": lambda k: {"ef": k, "c_e": k},
                  "one_hop": lambda k: {"max_hops": 1}}


def half_batch(cell, svc):
    """Half of every batch left out: its second half comes back empty."""
    def search(q, lo, hi):
        ids, dists = svc.search(q, lo, hi)
        ids, dists = ids.copy(), dists.copy()
        h = len(q) // 2
        ids[h:], dists[h:] = -1, np.inf
        return ids, dists
    return search


def altered(cell, svc):
    """An answer altered where it is produced: every distance the fused
    gather kernel returns is 2**-10 too large."""
    from repro_torch.kernels import ops

    def search(q, lo, hi):
        orig = ops.gather_l2_filter
        ops.gather_l2_filter = lambda *a: orig(*a) * (1.0 + 2.0 ** -10)
        try:
            return svc.search(q, lo, hi)
        finally:
            ops.gather_l2_filter = orig
    return search


def stale(cell, svc):
    """A step that returns its state unchanged: every burst is served, and
    gets the answers of a burst served before the window."""
    q, lo, hi = cell.warm_stream.next_chunk()
    B = int(cell.traffic["burst"])
    before = svc.search(q[:B], lo[:B], hi[:B])

    def search(q, lo, hi):
        svc.search(q, lo, hi)
        return before
    return search


def _cut_short(cell, name: str):
    k = int(cell.cfg["search"]["k"])
    return cell.service(**SHORT_SEARCHES[name](k)).search


def ef_k(cell, svc):
    """The hop loop's pool cut to k: the window is served by a service
    whose search keeps k candidates."""
    return _cut_short(cell, "ef_k")


def one_hop(cell, svc):
    """The hop loop cut to one hop from the routed entries."""
    return _cut_short(cell, "one_hop")


# the faults that the tests plant at a size the CPU holds; ``ef_k`` is read
# on the card at the cell's size only (``readings.py``): on 4,000 rows a
# pool of k still finds most neighbours
FAULTS = {"half_batch": half_batch, "altered": altered, "stale": stale,
          "one_hop": one_hop}
