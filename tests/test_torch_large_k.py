"""The engine's paths at the k and m the narrow scan kernels do not take
(ROADMAP F8), against the JAX package on the CPU: the service under
``auto`` at k = 100, under ``int8`` at k = 20 (an over-fetch kq = 80),
and a 12-attribute corpus under ``auto``, ``scan`` and ``hybrid``, plus
the bitmask path of a filter expression at k = 100. On the CPU every
kernel wrapper runs its plain version, so these hold the engine (the
planner's dispatch, the over-fetch and rerank, the merge of graph and
scan lanes); the CUDA wide forms are held to the plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Ids and hops are equal; distances within rtol = atol = 1e-5 (the two
reduce orders differ), and bit-equal on a 1/32-grid corpus, where every
f32 sum is exact in any order.
"""

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.predicate import parse_expr as jparse
from repro.data import DatasetSpec, make_dataset, make_queries
from repro.serve import KHIService as JService, ServeConfig as JServeConfig

from repro_torch.core import engine as teng
from repro_torch.core.predicate import parse_expr as tparse
from repro_torch.serve import KHIService, ServeConfig

BACKEND = "pallas_gather_l2_filter"


def _close(got, want, exact=False):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    if exact:
        np.testing.assert_array_equal(got[fin], want[fin])
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _queries(vecs, attrs, n=12, seed=40):
    q1, p1 = make_queries(vecs, attrs, n_queries=n, sigma=1 / 2, seed=seed)
    q2, p2 = make_queries(vecs, attrs, n_queries=n, sigma=1 / 32,
                          seed=seed + 1)
    lo = np.stack([p.lo for p in p1 + p2]).astype(np.float32)
    hi = np.stack([p.hi for p in p1 + p2]).astype(np.float32)
    return np.concatenate([q1, q2]), lo, hi


def _planners(index, **kw):
    return (jeng.Planner(index, jeng.SearchParams(backend=BACKEND, **kw)),
            teng.Planner(teng.device_put_index(index, device="cpu"),
                         teng.SearchParams(backend=BACKEND, **kw)))


def _same_search(index, Q, lo, hi, exact=False, **kw):
    jp, tp = _planners(index, **kw)
    wi, wd, wh, wplan = jp.search(Q, lo, hi)
    gi, gd, gh, gplan = tp.search(Q, lo, hi)
    np.testing.assert_array_equal(gplan.use_scan, wplan.use_scan)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gh, wh)
    _close(gd, wd, exact)
    return gplan


@pytest.mark.parametrize("k,quant", [(100, "none"), (20, "int8")])
def test_service_at_large_k_matches_reference(tiny_index, tiny_data, k,
                                              quant):
    """auto at k = 100 (the box scan's k > 64), int8 at k = 20 (the int8
    scan's over-fetch kq = 80): the planner's ids, distances and hops,
    then the service over bursts of 5, 13 and 6 requests."""
    vecs, attrs = tiny_data
    Q, lo, hi = _queries(vecs, attrs)
    kw = dict(k=k, ef=max(32, k), c_n=16, expand_width=4, strategy="auto",
              scan_threshold=200, quant=quant)
    plan = _same_search(tiny_index, Q, lo, hi, **kw)
    assert plan.use_scan.any() and not plan.use_scan.all()
    js = JService(tiny_index, jeng.SearchParams(backend=BACKEND, **kw),
                  config=JServeConfig(buckets=(32,)))
    ts = KHIService(tiny_index, teng.SearchParams(backend=BACKEND, **kw),
                    config=ServeConfig(buckets=(32,)), device="cpu")
    s = 0
    for b in (5, 13, 6):
        wi, wd = js.search(Q[s:s + b], lo[s:s + b], hi[s:s + b])
        gi, gd = ts.search(Q[s:s + b], lo[s:s + b], hi[s:s + b])
        assert gi.shape == (b, k)
        np.testing.assert_array_equal(gi, wi)
        _close(gd, wd)
        s += b
    assert ts.snapshot()["scan_lanes"] > 0


def test_bitmask_expression_at_k100_matches_reference(tiny_index,
                                                      tiny_data):
    """A filter expression over more boxes than the budget lowers to the
    bitmask scan, here at k = 100."""
    vecs, attrs = tiny_data
    Q, _, _ = _queries(vecs, attrs, n=4)
    expr = "a0 in [2000, 2003, 2006, 2009, 2012, 2015, 2018] or a2 > 0.9"
    kw = dict(k=100, ef=100, c_n=16, expand_width=4, strategy="auto",
              scan_threshold=200, box_budget=2)
    jp, tp = _planners(tiny_index, **kw)
    wi, wd, wh = jp.search_expr(Q, jparse(expr, 3))[:3]
    gi, gd, gh = tp.search_expr(Q, tparse(expr, 3))[:3]
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gh, wh)
    _close(gd, wd)


def _m12(grid: bool):
    if grid:
        rng = np.random.default_rng(12)
        vecs = (rng.integers(-64, 65, (700, 16)) / 32).astype(np.float32)
        attrs = rng.random((700, 12)).astype(np.float32)
    else:
        vecs, attrs = make_dataset(DatasetSpec("m12", n=700, d=16, m=12,
                                               n_clusters=8, seed=3))
    return vecs, attrs, JIndex.build(vecs, attrs, JConfig(M=8))


@pytest.mark.parametrize("grid,strategy", [(False, "auto"),
                                           (False, "hybrid"),
                                           (True, "scan"), (True, "hybrid")])
def test_twelve_attributes_match_reference(grid, strategy):
    """A 12-attribute corpus (the box and windowed scans' m > 8): the
    strategies that scan, at k = 10 and k = 100; bit-equal distances on
    the grid corpus."""
    vecs, attrs, index = _m12(grid)
    rng = np.random.default_rng(5)
    Q = vecs[rng.choice(len(vecs), 16, replace=False)] + np.float32(1 / 32)
    lo = np.quantile(attrs, 0.1, axis=0) + rng.random((16, 12)) * 0.2
    hi = lo + 0.3 + rng.random((16, 12)) * 0.6
    lo[:4], hi[:4] = -1.0, 2.0                          # wide lanes
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    for k in (10, 100):
        _same_search(index, Q.astype(np.float32), lo, hi, exact=grid,
                     k=k, ef=max(32, k), c_n=16, expand_width=4,
                     strategy=strategy, scan_threshold=300,
                     node_scan_threshold=60)
