"""The port's predicate compiler (``core/predicate.py``, a copy of the JAX
package's) and its serving path against the JAX package's: 210 random
expressions through ``normalize``, ``canonical_key``, ``compile_expr``,
``eval_expr`` and the dict round trip; the text grammar;
``Planner.search_expr`` and ``KHIService.search_expr`` /
``Request(expr=...)`` under ``auto`` and ``hybrid`` in boxes and bitmask
mode; and the validation errors. Inputs come from numpy seeds and every
expected value is computed live by the JAX package.

Tolerances: the serving corpus is on a 1/32 grid, so every squared
distance is exact in f32 whatever the reduce order and distances are
compared bit for bit. Ids, masks, boxes and key bytes are always equal.
"""

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import predicate as jpred
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.serve import (KHIService as JService, Request as JRequest,
                         ServeConfig as JServeConfig)

from repro_torch.core import engine as teng
from repro_torch.core import predicate as tpred
from repro_torch.core.query_ref import brute_force_expr
from repro_torch.serve import KHIService, Request, ServeConfig

M = 3


# --------------------------------------------------------- random ASTs

def _rand_leaf(rng, m, P):
    a = int(rng.integers(0, m))
    kind = int(rng.integers(0, 4))
    if kind == 0:                                   # two-sided range
        lo = float(rng.integers(-1, 8))
        return P.Range(a, lo, lo + float(rng.integers(0, 5)))
    if kind == 1:                                   # one-sided range
        v = float(rng.integers(0, 8))
        return (P.Range(a, v, None) if rng.random() < 0.5
                else P.Range(a, None, v))
    if kind == 2:
        return P.Eq(a, float(rng.integers(0, 8)))
    vals = rng.choice(8, size=int(rng.integers(1, 5)), replace=False)
    return P.In(a, tuple(float(v) for v in vals))


def _rand_expr(rng, m, P, depth=3):
    """One random AST built from module ``P``'s IR classes; the same
    ``rng`` state gives the same tree in either module."""
    r = rng.random()
    if depth == 0 or r < 0.45:
        return _rand_leaf(rng, m, P)
    if r < 0.62:
        return P.Not(_rand_expr(rng, m, P, depth - 1))
    op = P.And if r < 0.84 else P.Or
    return op(tuple(_rand_expr(rng, m, P, depth - 1)
                    for _ in range(int(rng.integers(2, 4)))))


def _pair(seed):
    """The same random expression in both packages' IR."""
    return (_rand_expr(np.random.default_rng(seed), M, jpred),
            _rand_expr(np.random.default_rng(seed), M, tpred))


def _dict(e, P):
    return P.expr_to_dict(e) if e is not None else None


@pytest.mark.parametrize("block", range(6))
def test_fuzz_compiler_matches_reference(block):
    """35 expressions a block, 210 in all: normalized form, key bytes,
    masks (with a NaN row and f32 attrs off the integer grid), the
    compiled program at two budgets, and the dict round trip."""
    rng = np.random.default_rng(0xC0 + block)
    attrs = rng.integers(-1, 9, size=(96, M)).astype(np.float32)
    attrs[::5] += np.float32(0.5)
    attrs[-1] = np.nan
    for i in range(35):
        je, te = _pair(1000 * block + i)
        jpred.validate_expr(je, M)
        tpred.validate_expr(te, M)
        assert tpred.canonical_key(te) == jpred.canonical_key(je)
        assert tpred.expr_to_dict(te) == jpred.expr_to_dict(je)
        jn, tn = jpred.normalize(je, M), tpred.normalize(te, M)
        assert _dict(tn, tpred) == _dict(jn, jpred)
        assert tpred.canonical_key(tn) == jpred.canonical_key(jn)
        np.testing.assert_array_equal(tpred.eval_expr(te, attrs),
                                      jpred.eval_expr(je, attrs))
        for budget in (8, 2):
            jp = jpred.compile_expr(je, M, box_budget=budget)
            tp = tpred.compile_expr(te, M, box_budget=budget)
            assert (tp.mode, tp.n_boxes) == (jp.mode, jp.n_boxes)
            np.testing.assert_array_equal(tp.lo, jp.lo)
            np.testing.assert_array_equal(tp.hi, jp.hi)
            assert tpred.canonical_key(tp.expr) == \
                jpred.canonical_key(jp.expr)
        rt = tpred.expr_from_dict(jpred.expr_to_dict(je))
        assert rt == te


def test_parse_and_nextafter_match_reference():
    texts = ["a0 >= 2015 and (a1 in [1, 4] or a2 > 0.5)",
             "not (a0 < 3 or a2 == 7) and 1 <= a1 <= 2",
             "a0 in [2005, 2007, 2009] and not a1 > 0.1",
             "a2 < -1e-30 or a2 > 3.4e38"]
    for text in texts:
        je, te = jpred.parse_expr(text, M), tpred.parse_expr(text, M)
        assert tpred.canonical_key(te) == jpred.canonical_key(je)
        jp = jpred.compile_expr(je, M)
        tp = tpred.compile_expr(te, M)
        assert tp.mode == jp.mode
        np.testing.assert_array_equal(tp.lo.view(np.int32),
                                      jp.lo.view(np.int32))
        np.testing.assert_array_equal(tp.hi.view(np.int32),
                                      jp.hi.view(np.int32))
    with pytest.raises(ValueError):
        tpred.parse_expr("a0 >= ", M)


# ------------------------------------------------------ serving corpus

N, D = 1500, 16
YEARS = np.arange(2005, 2025, dtype=np.float32)
# lowers to 3 disjoint boxes; 10 non-adjacent years exceed box_budget=8
E1 = "a0 in [2019, 2021, 2023] and a1 <= 0.5"
E2 = "a0 in [2005, 2007, 2009, 2011, 2013, 2015, 2017, 2019, 2021, 2023]"


@pytest.fixture(scope="module")
def expr_case():
    rng = np.random.default_rng(0xE5)
    vecs = (rng.integers(-64, 64, size=(N, D)) / 32).astype(np.float32)
    attrs = np.stack([rng.choice(YEARS, N),
                      rng.uniform(0, 1, N), rng.uniform(0, 1, N)],
                     1).astype(np.float32)
    index = JIndex.build(vecs, attrs, JConfig(M=8, builder="device"))
    q = (rng.integers(-64, 64, size=(6, D)) / 32).astype(np.float32)
    return vecs, attrs, index, q


def _params(mod, strategy, backend):
    kw = dict(k=10, ef=32, c_n=16, expand_width=4, backend=backend,
              strategy=strategy, scan_threshold=100, box_budget=8)
    if strategy == "hybrid":
        kw["node_scan_threshold"] = 64
    return mod.SearchParams(**kw)


@pytest.mark.parametrize("strategy,backend",
                         [("auto", "pallas_gather_l2_filter"),
                          ("hybrid", "pallas_gather_l2_filter"),
                          ("hybrid", "jnp")])
def test_planner_search_expr_matches_reference(expr_case, strategy, backend):
    vecs, attrs, index, q = expr_case
    jp = jeng.Planner(index, _params(jeng, strategy, backend))
    tp = teng.Planner(teng.device_put_index(index, device="cpu"),
                      _params(teng, strategy, backend))
    for text, mode in ((E1, "boxes"), (E2, "bitmask")):
        wi, wd, wh, wplan = jp.search_expr(q, jpred.parse_expr(text, M))
        gi, gd, gh, gplan = tp.search_expr(q, tpred.parse_expr(text, M))
        assert gplan.mode == wplan.mode == mode
        assert gplan.n_boxes == wplan.n_boxes == (3 if mode == "boxes"
                                                   else 0)
        assert gplan.lanes == wplan.lanes
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gh, wh)
        np.testing.assert_array_equal(gd, wd)
        for gpl, wpl in zip(gplan.box_plans, wplan.box_plans):
            np.testing.assert_array_equal(gpl.use_scan, wpl.use_scan)
            if strategy == "hybrid":
                np.testing.assert_array_equal(gpl.mode, wpl.mode)
        if mode == "bitmask":
            # the fallback is exact: the mask-then-top-k's ids
            expr = tpred.parse_expr(text, M)
            for i in range(len(q)):
                want = brute_force_expr(vecs, attrs, q[i], expr, 10)
                np.testing.assert_array_equal(gi[i][: len(want)], want)
    if strategy == "hybrid":
        lanes = tp.search_expr(q, tpred.parse_expr(E1, M))[3].lanes
        assert lanes["window"] > 0


@pytest.mark.parametrize("strategy", ["auto", "hybrid"])
def test_service_predicates_match_reference(expr_case, strategy):
    """``search_expr`` and a mixed flush (box requests and two predicate
    groups, one written twice in different forms) through both services:
    equal ids and dists, lane counters and request counts."""
    vecs, attrs, index, q = expr_case
    backend = "pallas_gather_l2_filter"
    js = JService(index, _params(jeng, strategy, backend),
                  config=JServeConfig(buckets=(1, 8)))
    ts = KHIService(index, _params(teng, strategy, backend),
                    config=ServeConfig(buckets=(1, 8)), device="cpu")
    for text in (E1, E2):
        wi, wd = js.search_expr(q, jpred.parse_expr(text, M))
        gi, gd = ts.search_expr(q, tpred.parse_expr(text, M))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
    lo = np.full((2, M), -np.inf, np.float32)
    hi = np.full((2, M), np.inf, np.float32)
    lo[:, 0], hi[:, 0] = 2010, 2012
    alt = "a0 in [2023, 2021, 2019] and a1 <= 0.5"   # E1, other order

    def reqs(P, R):
        return ([R(q[0], lo[0], hi[0])]
                + [R(q[i], expr=P.parse_expr(E1, M)) for i in (1, 2)]
                + [R(q[3], expr=P.parse_expr(E2, M)), R(q[1], lo[1], hi[1])]
                + [R(q[4], expr=P.parse_expr(alt, M))])

    jt = [js.submit(r) for r in reqs(jpred, JRequest)]
    tt = [ts.submit(r) for r in reqs(tpred, Request)]
    jr, tr = js.flush(), ts.flush()
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(tr[b].ids, jr[a].ids)
        np.testing.assert_array_equal(tr[b].dists, jr[a].dists)
        assert tr[b].cached == jr[a].cached
    ws, gs = js.snapshot(), ts.snapshot()
    assert gs["predicate_lanes"] == ws["predicate_lanes"]
    for key in ("requests", "batches", "pad_lanes", "scan_lanes",
                "cache_hits", "device_queries"):
        assert gs[key] == ws[key], key
    assert gs["predicate_lanes"]["bitmask"] == len(q) + 1


def test_request_validation():
    q = np.zeros(D, np.float32)
    box = np.zeros(M, np.float32)
    for P, R in ((jpred, JRequest), (tpred, Request)):
        with pytest.raises(ValueError, match="exactly one filter form"):
            R(q, box, box, expr=P.Range(0, 0, 1))
        with pytest.raises(ValueError, match="needs a filter"):
            R(q)
        with pytest.raises(ValueError, match="needs a filter"):
            R(q, lo=box)
        assert R(q, box, box).expr is None
        assert R(q, expr=P.Range(0, 0, 1)).lo is None


def test_box_budget_validated(expr_case):
    _, _, index, q = expr_case
    for mod, P in ((jeng, jpred), (teng, tpred)):
        with pytest.raises(ValueError, match="box_budget"):
            mod.SearchParams(box_budget=0)
        with pytest.raises(ValueError, match="box_budget"):
            P.compile_expr(P.Range(0, 0, 1), M, box_budget=0)
    di = teng.device_put_index(index, device="cpu")
    # malformed expressions fail at validation time, as in the reference
    for bad in (tpred.Range(M, 0, 1), tpred.In(0, ())):
        with pytest.raises((ValueError, TypeError)):
            teng.validate_search_params(teng.SearchParams(), di, expr=bad)
    svc = KHIService(di, teng.SearchParams(), device="cpu")
    with pytest.raises((ValueError, TypeError)):
        svc.search_expr(q, tpred.Range(M, 0, 1))


@pytest.mark.parametrize("strategy,text,mode", [
    ("hybrid", "a0 >= 2015 and (a1 in [1, 4] or a1 > 500)", "boxes"),
    ("scan", "a0 in [2008, 2010, 2012, 2014, 2016, 2018, 2020, 2022, 2024] "
             "or a0 == 2009", "bitmask")])
def test_serve_launcher_filter_expr(strategy, text, mode, capsys):
    """``repro_torch.launch.serve --filter-expr`` on the CPU: it serves
    the expression and checks it against the numpy mask-then-top-k
    (exactly under ``--strategy scan``)."""
    from repro_torch.launch.serve import main

    snap = main(["--n", "1500", "--d", "32", "--batch", "16", "--iters",
                 "1", "--device", "cpu", "--strategy", strategy,
                 "--node-scan-threshold", "64", "--filter-expr", text])
    out = capsys.readouterr().out
    assert f"-> {mode} program" in out
    lanes = snap["predicate_lanes"]
    assert (lanes.get("bitmask", 0) == 16) == (mode == "bitmask")
