"""The port's streaming write path (insert, delete, compact) against the
reference's, side by side: the port's ``KHIService(device="cpu")`` and
the JAX ``KHIService`` take the same writes and queries, and
``repro.core.query_ref.StreamingOracle`` rebuilds the live corpus from
scratch. The corpus is the JAX streaming tests' grid (d = 16, m = 2,
values on a 1/32 grid), so every squared distance is exact in f32 in
any order and ids, distances and hops must be equal, not close. Both
sides build with ``KHIConfig(M=8, builder="device")``, whose port is bit
equal on this grid.

The reference's ``compact`` under ``auto`` and ``hybrid`` hands the new
epoch's planner the OLD epoch's tombstones (its ``_build_search_fn``
refreshes with ``deleted_locals()`` before ``reset``): the dead rows'
ids then count against the wrong nodes, or, past the new corpus size,
raise ``IndexError``. The port refreshes the new epoch with none.
``_jax_compact`` runs the reference's own ``compact`` with its
``deleted_locals`` reporting no tombstones for that call, so both sides
publish the same epoch (ROADMAP Queue 3, F5)."""

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                    # pragma: no cover
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import engine as jeng
from repro.core.delta import DeltaSegment as JDeltaSegment
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.predicate import Range
from repro.core.query_ref import Predicate, StreamingOracle as JOracle
from repro.serve import KHIService as JService, ServeConfig as JServeConfig

from repro_torch.core import engine as teng
from repro_torch.core.delta import DeltaSegment
from repro_torch.core.khi import KHIConfig, KHIIndex
from repro_torch.core.predicate import Range as TRange
from repro_torch.core.query_ref import StreamingOracle
from repro_torch.serve import KHIService, ServeConfig

D, M = 16, 2
KW = dict(k=8, ef=32, c_n=16, expand_width=4)


def _grid_vecs(rng, n):
    return (rng.integers(-64, 64, size=(n, D)) / 32).astype(np.float32)


def _grid_attrs(rng, n):
    return rng.integers(0, 16, size=(n, M)).astype(np.float32)


def _boxes(rng, b):
    """Mixed-selectivity integer boxes: wide, narrow, provably empty."""
    lo = rng.integers(0, 12, size=(b, M)).astype(np.float32)
    hi = lo + rng.integers(0, 10, size=(b, M)).astype(np.float32)
    kind = rng.integers(0, 4, size=b)
    lo[kind == 0], hi[kind == 0] = 0.0, 15.0
    hi[kind == 3] = lo[kind == 3] - 1.0
    return lo, hi


class Pair:
    """The JAX service and the port's over one corpus, streaming, with the
    reference's oracle beside them."""

    def __init__(self, vecs, attrs, capacity, *, strategy="scan",
                 backend="pallas_gather_l2_filter", buckets=(4, 8),
                 cache_size=64, **extra):
        kw = dict(KW, strategy=strategy, **extra)
        self.jcfg = JConfig(M=8, builder="device")
        self.tcfg = KHIConfig(M=8, builder="device")
        self.js = JService(JIndex.build(vecs, attrs, self.jcfg),
                           jeng.SearchParams(backend="jnp", **kw),
                           config=JServeConfig(buckets=buckets,
                                               cache_size=cache_size))
        self.ts = KHIService(KHIIndex.build(vecs, attrs, self.tcfg,
                                            device="cpu"),
                             teng.SearchParams(backend=backend, **kw),
                             config=ServeConfig(buckets=buckets,
                                                cache_size=cache_size),
                             device="cpu")
        self.js.enable_streaming(capacity=capacity, build_config=self.jcfg)
        self.ts.enable_streaming(capacity=capacity, build_config=self.tcfg)
        self.oracle = JOracle(vecs, attrs)
        self.strategy = strategy
        self._jfns: dict = {}

    def insert(self, nv, na):
        want = self.oracle.insert(nv, na)
        np.testing.assert_array_equal(self.js.insert(nv, na), want)
        got = self.ts.insert(nv, na)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)

    def delete(self, pick):
        n = self.oracle.delete(pick)
        assert self.js.delete(pick) == n
        assert self.ts.delete(pick) == n

    def compact(self):
        _jax_compact(self.js)
        self.ts.compact()
        assert self.ts.epoch == self.js.epoch

    def hops(self, svc, jax_side, Q, lo, hi):
        if jax_side and self.strategy == "graph":
            # the reference's graph program, jitted once per params
            fn = self._jfns.get(repr(svc.params))
            if fn is None:
                fn = self._jfns[repr(svc.params)] = jax.jit(
                    jeng.make_search_fn(svc.params))
            return np.asarray(fn(svc.index, Q, lo, hi)[2])
        return svc._planner.search(Q, lo, hi)[2]

    def check(self, rng, nq=4):
        """One query batch: the port's ids, distances and hops equal the
        reference's; on exact lanes (scan) both equal the oracle's, with
        each distance the f32 of its float64 recomputation."""
        Q = _grid_vecs(rng, nq)
        lo, hi = _boxes(rng, nq)
        wi, wd = self.js.search(Q, lo, hi)
        gi, gd = self.ts.search(Q, lo, hi)
        assert gi.dtype == np.int64
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(self.hops(self.ts, False, Q, lo, hi),
                                      self.hops(self.js, True, Q, lo, hi))
        tsnap, jsnap = self.ts.snapshot(), self.js.snapshot()
        for key in ("n_live", "delta_fill", "tombstones", "streaming",
                    "epoch", "compactions", "inserts", "deletes"):
            assert tsnap[key] == jsnap[key], key
        assert tsnap["n_live"] == len(self.oracle)
        if self.strategy != "scan":
            return
        for i in range(nq):
            want = self.oracle.query(Q[i], Predicate(lo[i], hi[i]),
                                     self.ts.params.k)
            np.testing.assert_array_equal(gi[i][gi[i] >= 0], want)
            assert np.all(gi[i][len(want):] == -1)
            assert np.all(np.isinf(gd[i][len(want):]))
            for j, e in enumerate(want):
                v = self.oracle._rows[int(e)][0].astype(np.float64)
                d2 = np.float32(((v - Q[i].astype(np.float64)) ** 2).sum())
                assert gd[i][j] == d2, (i, j, e)


def _jax_compact(js):
    """The reference's ``compact``, its new epoch's planner refreshed with
    no tombstones (module docstring)."""
    stream = js._stream
    stream.deleted_locals = lambda: [np.zeros(0, np.int64)] * stream.S
    try:
        js.compact()
    finally:
        del stream.deleted_locals


def _run_interleaving(seed, strategy="scan", n_ops=12, n0=96, capacity=32,
                      pair_cls=None, **kw):
    rng = np.random.default_rng(seed)
    vecs, attrs = _grid_vecs(rng, n0), _grid_attrs(rng, n0)
    pair = (pair_cls or Pair)(vecs, attrs, capacity, strategy=strategy, **kw)
    pair.check(np.random.default_rng(seed ^ 0xA5))
    for step in range(n_ops):
        op = ("insert", "dup", "delete", "delete", "query",
              "compact")[rng.integers(0, 6)]
        if op in ("insert", "dup"):
            b = int(rng.integers(1, 9))
            nv, na = _grid_vecs(rng, b), _grid_attrs(rng, b)
            if op == "dup" and len(pair.oracle):
                # an exact duplicate of a live row: a distance tie that
                # only the (dist, ext) order resolves
                le, lv, la = pair.oracle.corpus()
                j = int(rng.integers(0, len(le)))
                nv[0], na[0] = lv[j], la[j]
            pair.insert(nv, na)
        elif op == "delete":
            # any past ext: dead and unknown ids are skipped alike
            pair.delete(rng.choice(pair.oracle.next_ext,
                                   size=int(rng.integers(1, 5)),
                                   replace=False))
        elif op == "query":
            pair.check(np.random.default_rng(seed * 1000 + step))
        else:
            pair.compact()
            pair.check(np.random.default_rng(seed * 77 + step))
    pair.compact()
    pair.check(np.random.default_rng(seed ^ 0x5A))
    return pair


@pytest.mark.parametrize("strategy", ["scan", "graph"])
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_interleaving_matches_reference(strategy, seed):
    """Random interleavings of insert, duplicate insert, delete of any
    past ext, query and compact (``tests/test_torch_streaming_pins.py``
    runs them under auto)."""
    _run_interleaving(seed, strategy, scan_threshold=12)


@pytest.mark.parametrize("quant", ["none", "bf16", "int8"])
def test_delta_segment_scan_matches_reference(quant):
    """``DeltaSegment.scan`` at capacity < k (k' = capacity), with a
    deleted slot, against the reference's segment; None before any
    append."""
    rng = np.random.default_rng(23)
    cap, k = 5, 8
    j = JDeltaSegment(cap, D, M, backend="jnp", quant=quant)
    t = DeltaSegment(cap, D, M, backend="pallas_gather_l2_filter",
                     device="cpu", quant=quant)
    Q = _grid_vecs(rng, 3)
    lo = np.zeros((3, M), np.float32)
    hi = np.full((3, M), 15.0, np.float32)
    hi[2] = -1.0                                       # empty box
    assert t.scan(Q, lo, hi, k) is None and j.scan(Q, lo, hi, k) is None
    v, a = _grid_vecs(rng, 4), _grid_attrs(rng, 4)
    for seg in (j, t):
        np.testing.assert_array_equal(seg.insert(v, a, np.arange(4) + 40),
                                      np.arange(4))
        seg.delete(np.array([1]))
    (ws, wd), (gs, gd) = j.scan(Q, lo, hi, k), t.scan(Q, lo, hi, k)
    assert gs.shape == (3, cap)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gd, wd)
    assert set(gs[0][gs[0] >= 0].tolist()) == {0, 2, 3}
    assert np.all(gs[2] == -1)
    for got, want in zip(t.live_rows(), j.live_rows()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.vecs.numpy(), np.asarray(j.vecs))
    np.testing.assert_array_equal(t.attrs.numpy(), np.asarray(j.attrs))
    if quant != "none":
        np.testing.assert_array_equal(
            t.qvecs.float().numpy(), np.asarray(j.qvecs, np.float32))
    if quant == "int8":
        np.testing.assert_array_equal(t.qscale.numpy(), np.asarray(j.qscale))
    with pytest.raises(ValueError, match="full"):
        t.insert(v[:2], a[:2], np.arange(2))


def test_streaming_oracle_matches_reference():
    rng = np.random.default_rng(29)
    vecs, attrs = _grid_vecs(rng, 40), _grid_attrs(rng, 40)
    j, t = JOracle(vecs, attrs), StreamingOracle(vecs, attrs)
    for step in range(20):
        if step % 3 == 0:
            nv, na = _grid_vecs(rng, 3), _grid_attrs(rng, 3)
            np.testing.assert_array_equal(t.insert(nv, na), j.insert(nv, na))
        elif step % 3 == 1:
            pick = rng.choice(j.next_ext, size=4, replace=False)
            assert t.delete(pick) == j.delete(pick)
        assert len(t) == len(j)
        for got, want in zip(t.corpus(), j.corpus()):
            np.testing.assert_array_equal(got, want)
        q = _grid_vecs(rng, 1)[0]
        lo, hi = _boxes(rng, 1)
        pred = Predicate(lo[0], hi[0])
        np.testing.assert_array_equal(t.query(q, pred, 6),
                                      j.query(q, pred, 6))
        expr, texpr = Range(1, lo[0, 1], hi[0, 1]), TRange(1, lo[0, 1],
                                                           hi[0, 1])
        np.testing.assert_array_equal(t.query_expr(q, texpr, 6),
                                      j.query_expr(q, expr, 6))
