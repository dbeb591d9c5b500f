"""The port's ``KHIService`` over a ``ShardedKHI`` against the JAX
package's, side by side on the CPU: search under auto, graph and hybrid
with a degradation ladder and an int8 tier, compiled predicates, and the
streaming write path (per-shard deltas routed by ``ext % S``, stacked
tombstones, ``compact`` through ``build_sharded``) at every step; then
``elastic_reshard`` and the launcher's ``--shards``.

The search cases serve the JAX package's stacked per-shard indexes
(``tiny_data``, n = 1,200 over 3 shards) on both sides; ids are equal and
distances within rtol = atol = 1e-5. The streaming cases build each side
with its own package's ``build_sharded`` on the 1/32 grid of
``tests/test_torch_streaming.py`` (``KHIConfig(M=8, builder="device")``,
whose port is bit-equal there), so ids, distances and hops are equal,
and the reference's ``compact`` runs as ``_jax_compact`` (ROADMAP F5)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import sharded as jsh
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.predicate import parse_expr as jparse
from repro.data import make_queries
from repro.distributed import elastic as jel
from repro.serve import (KHIService as JService, ServeConfig as JServeConfig,
                         TierSpec as JTierSpec)

from repro_torch.core import engine as teng
from repro_torch.core import sharded as tsh
from repro_torch.core.khi import KHIConfig, KHIIndex
from repro_torch.core.predicate import parse_expr as tparse
from repro_torch.distributed import elastic as tel
from repro_torch.serve import KHIService, ServeConfig, TierSpec

from test_torch_streaming import (KW as SKW, Pair, _grid_attrs, _grid_vecs,
                                  _run_interleaving)

S = 3
BUCKETS = (1, 8, 32)
KW = dict(k=10, ef=48, c_n=16, expand_width=4, scan_threshold=150)
LADDER = "ef=24,ef=12+expand_width=1"
E_BOXES = "a0 in [2019, 2021, 2023] and a1 <= 50"          # 3 boxes
E_MASK = ("a0 in [2009, 2011, 2013, 2015, 2017, 2019, 2021, 2023, 2024] "
          "and a2 > 0.2")                                   # 9 > box_budget


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch intra-op thread: the test run shares the host's cores
    among its worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sharded(tiny_data):
    """The reference's stacked index and the port's stack of the same
    per-shard indexes, and 24 mixed-selectivity requests."""
    vecs, attrs = tiny_data
    shard_of = np.arange(len(vecs)) % S
    shards = [JIndex.build(vecs[shard_of == s], attrs[shard_of == s],
                           JConfig(M=16, builder="bulk")) for s in range(S)]
    q1, p1 = make_queries(vecs, attrs, n_queries=12, sigma=1 / 2, seed=51)
    q2, p2 = make_queries(vecs, attrs, n_queries=12, sigma=1 / 64, seed=52)
    Q = np.concatenate([q1, q2])
    lo = np.stack([p.lo for p in p1 + p2]).astype(np.float32)
    hi = np.stack([p.hi for p in p1 + p2]).astype(np.float32)
    perm = np.random.default_rng(5).permutation(len(Q))
    return (jsh.stack_shards(shards), tsh.stack_shards(shards, device="cpu"),
            Q[perm], lo[perm], hi[perm])


def _params(mod, backend, strategy, **kw):
    base = dict(KW, strategy=strategy, backend=backend, **kw)
    if strategy == "hybrid":
        base["node_scan_threshold"] = 4
    return mod.SearchParams(**base)


def _services(jk, tk, strategy="auto", ladder=LADDER):
    jp = _params(jeng, "jnp", strategy)
    tp = _params(teng, "pallas_gather_l2_filter", strategy)
    js = JService(jk, jp, config=JServeConfig(buckets=BUCKETS, cache_size=64),
                  tiers=[s.apply(jp) for s in JTierSpec.parse_ladder(ladder)])
    ts = KHIService(tk, tp, config=ServeConfig(buckets=BUCKETS, cache_size=64),
                    device="cpu",
                    tiers=[s.apply(tp) for s in TierSpec.parse_ladder(ladder)])
    return js, ts


def _same(got, want, exact=False):
    gi, gd = got
    wi, wd = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    if exact:
        np.testing.assert_array_equal(gd, wd)
        return
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strategy,ladder", [
    ("auto", LADDER), ("hybrid", LADDER),
    ("auto", LADDER + "+quant=int8"),
])
def test_sharded_service_tiers_match_reference(sharded, strategy, ladder):
    jk, tk, Q, lo, hi = sharded
    js, ts = _services(jk, tk, strategy, ladder)
    for t in range(3):
        _same(ts.search(Q, lo, hi, tier=t), js.search(Q, lo, hi, tier=t))
        _same(ts.search(Q[:5], lo[:5], hi[:5], tier=t),      # cache hits
              js.search(Q[:5], lo[:5], hi[:5], tier=t))
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    for key in ("tier_lanes", "requests", "cache_hits", "batches",
                "pad_lanes", "device_queries", "scan_lanes"):
        assert tsnap[key] == jsnap[key], key
    assert ts.index.num_shards == S
    if ladder.endswith("int8"):
        assert ts.index.di.qvecs is not None
        assert all(ts._get_planner(t).index.di.qvecs is ts.index.di.qvecs
                   for t in range(3))


@pytest.mark.parametrize("text,mode", [(E_BOXES, "boxes"),
                                       (E_MASK, "bitmask")])
@pytest.mark.parametrize("strategy", ["auto", "hybrid"])
def test_sharded_service_search_expr_matches_reference(sharded, text, mode,
                                                       strategy):
    jk, tk, Q, _lo, _hi = sharded
    js, ts = _services(jk, tk, strategy)
    m = _lo.shape[1]
    for t in (0, 2):
        _same(ts.search_expr(Q[:6], tparse(text, m), tier=t),
              js.search_expr(Q[:6], jparse(text, m), tier=t))
    assert ts.snapshot()["predicate_lanes"] == \
        js.snapshot()["predicate_lanes"]
    assert mode in ts.snapshot()["predicate_lanes"] or mode == "boxes"


def test_sharded_service_mesh_still_raises(sharded):
    """``mesh=`` takes a query mesh (``launch.mesh.make_query_mesh``);
    anything else raises before a collective is built."""
    _, tk, *_ = sharded
    with pytest.raises(TypeError, match="make_query_mesh") as e:
        KHIService(tk, teng.SearchParams(), device="cpu", mesh=object())
    assert "QueryMesh" in str(e.value)


class ShardPair(Pair):
    """``Pair`` over S = 3 grid shards: each side builds its corpus with
    its own package's ``build_sharded``."""

    def __init__(self, vecs, attrs, capacity, *, strategy="scan",
                 backend="pallas_gather_l2_filter", buckets=(4, 8),
                 cache_size=64, **extra):
        from repro.core.query_ref import StreamingOracle as JOracle

        kw = dict(SKW, strategy=strategy, **extra)
        self.jcfg = JConfig(M=8, builder="device")
        self.tcfg = KHIConfig(M=8, builder="device")
        jk = jsh.build_sharded(vecs, attrs, S, self.jcfg)
        tk = tsh.build_sharded(vecs, attrs, S, self.tcfg, device="cpu")
        for f in dataclasses.fields(jk.di):
            want = getattr(jk.di, f.name)
            if want is not None:
                np.testing.assert_array_equal(
                    np.asarray(getattr(tk.di, f.name)), np.asarray(want))
        self.js = JService(jk, jeng.SearchParams(backend="jnp", **kw),
                           config=JServeConfig(buckets=buckets,
                                               cache_size=cache_size))
        self.ts = KHIService(tk, teng.SearchParams(backend=backend, **kw),
                             config=ServeConfig(buckets=buckets,
                                                cache_size=cache_size),
                             device="cpu")
        self.js.enable_streaming(capacity=capacity, build_config=self.jcfg)
        self.ts.enable_streaming(capacity=capacity, build_config=self.tcfg)
        self.oracle = JOracle(vecs, attrs)
        self.strategy = strategy
        self._jfns = {}

    def hops(self, svc, jax_side, Q, lo, hi):
        if jax_side and self.strategy == "graph":
            # the reference's graph fan-out: per-shard hops, max over S
            hops = jsh.search_sharded_emulated(svc.index, Q, lo, hi,
                                               svc.params)[2]
            return np.asarray(hops).max(0)
        return svc._planner.search(Q, lo, hi)[2]

    def check(self, rng, nq=4):
        super().check(rng, nq)
        for svc in (self.ts, self.js):
            assert svc.index.num_shards == S
        st = self.ts._stream
        assert len(st.deltas) == S
        for e, (s, _slot) in st.delta_loc.items():
            assert s == e % S
        dead = st.deleted_locals()
        want = self.js._stream.deleted_locals()
        assert len(dead) == len(want) == S
        for a, b in zip(dead, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy,seed,extra", [
    ("scan", 3, {}), ("graph", 5, {}), ("auto", 8, dict(scan_threshold=12)),
    ("scan", 13, dict(quant="int8", rerank_mult=64)),
])
def test_sharded_streaming_matches_reference(strategy, seed, extra):
    """Random interleavings of inserts, duplicate inserts, deletes of any
    past ext, queries and compactions: the port's sharded service equals
    the reference's at every step (ids, distances and hops, the per-shard
    delta fills, tombstones and live count), and on exact lanes both
    equal the oracle's rebuild from scratch."""
    pair = _run_interleaving(seed, strategy, n_ops=10, capacity=16,
                             pair_cls=ShardPair, **extra)
    snap = pair.ts.snapshot()
    assert len(snap["delta_fill"]) == S
    assert snap["compactions"] >= 1


def test_sharded_live_corpus_and_auto_compaction():
    """``live_corpus`` gathers base rows at (shard, local) and every
    segment's live rows, sorted by ext; an insert that no per-shard delta
    can take compacts first, through ``build_sharded``."""
    rng = np.random.default_rng(21)
    vecs, attrs = _grid_vecs(rng, 60), _grid_attrs(rng, 60)
    pair = ShardPair(vecs, attrs, 4)
    pair.insert(_grid_vecs(rng, 9), _grid_attrs(rng, 9))
    pair.delete(np.asarray([0, 7, 61, 65]))
    lv, la, le = pair.ts._stream.live_corpus(pair.ts.index)
    ov_e, ov_v, ov_a = pair.oracle.corpus()
    np.testing.assert_array_equal(le, ov_e)
    np.testing.assert_array_equal(lv, ov_v)
    np.testing.assert_array_equal(la, ov_a)
    pair.insert(_grid_vecs(rng, 3), _grid_attrs(rng, 3))  # fills all 4
    assert pair.ts.snapshot()["compactions"] == 0
    assert pair.ts.snapshot()["delta_fill"] == [4, 4, 4]
    nv, na = _grid_vecs(rng, 3), _grid_attrs(rng, 3)      # cannot fit
    want = pair.oracle.insert(nv, na)
    np.testing.assert_array_equal(pair.ts.insert(nv, na), want)
    from test_torch_streaming import _jax_compact
    _jax_compact(pair.js)
    np.testing.assert_array_equal(pair.js.insert(nv, na), want)
    assert pair.ts.snapshot()["compactions"] == 1
    assert pair.ts.epoch == 1
    pair.check(np.random.default_rng(2))


def _grid_index_equal(ti, ji):
    np.testing.assert_array_equal(ti.vecs, ji.vecs)
    np.testing.assert_array_equal(ti.nbrs_numpy(), np.asarray(ji.nbrs))
    np.testing.assert_array_equal(ti.tree.order, ji.tree.order)


@pytest.mark.parametrize("n_old,n_new", [(4, 8), (4, 4)])
def test_elastic_reshard_matches_reference(n_old, n_new):
    """4 -> 8 rebuilds every new shard over its round-robin object set;
    4 -> 4 reuses the old shard objects as they are. Each side builds with
    its own device builder on the grid; the new shard maps and their
    stacks are equal."""
    rng = np.random.default_rng(17)
    vecs, attrs = _grid_vecs(rng, 160), _grid_attrs(rng, 160)
    np.testing.assert_array_equal(tel.shard_assignments(160, 8),
                                  jel.shard_assignments(160, 8))
    jcfg, tcfg = JConfig(M=8, builder="device"), KHIConfig(M=8,
                                                           builder="device")
    own = np.arange(160) % n_old
    jold = {s: JIndex.build(vecs[own == s], attrs[own == s], jcfg)
            for s in range(n_old)}
    told = {s: KHIIndex.build(vecs[own == s], attrs[own == s], tcfg,
                              device="cpu") for s in range(n_old)}
    jnew = jel.elastic_reshard(vecs, attrs, jold, n_old, n_new, jcfg)
    tnew = tel.elastic_reshard(vecs, attrs, told, n_old, n_new, tcfg,
                               device="cpu")
    assert sorted(tnew) == sorted(jnew) == list(range(n_new))
    for s in range(n_new):
        _grid_index_equal(tnew[s], jnew[s])
        assert (tnew[s] is told.get(s)) == (jnew[s] is jold.get(s))
        assert (tnew[s] is told.get(s)) == (n_new == n_old)
    jk = jsh.stack_shards([jnew[s] for s in range(n_new)])
    tk = tsh.stack_shards([tnew[s] for s in range(n_new)], device="cpu")
    assert tk.pad_waste == jk.pad_waste
    np.testing.assert_array_equal(tk.di.nbrs.numpy(), np.asarray(jk.di.nbrs))
    # a custom build_fn sees each moved shard's rows
    seen = []
    tel.elastic_reshard(vecs, attrs, told, n_old, n_new,
                        build_fn=lambda v, a: seen.append(len(v)) or told[0])
    assert seen == ([] if n_new == n_old else [20] * 8)


def test_launcher_shards_matches_direct_planner(monkeypatch, capsys):
    """``--shards 2 --device cpu`` exits 0 (its stream smoke included),
    and the requests it served equal a direct ``Planner`` over the index
    it served them from."""
    import repro_torch.serve as serve_mod
    from repro_torch.launch import serve as launcher

    served = []

    class Recording(serve_mod.KHIService):
        def serve_stream(self, requests):
            reqs = list(requests)
            index, params = self.index, self.params
            out = list(super().serve_stream(iter(reqs)))
            served.append((index, params, reqs, out))
            return iter(out)

    monkeypatch.setattr(serve_mod, "KHIService", Recording)
    snap = launcher.main(["--mode", "khi", "--n", "800", "--d", "16",
                          "--batch", "16", "--shards", "2", "--device",
                          "cpu", "--stream-smoke"])
    assert "shards=2" in capsys.readouterr().out
    assert snap["compactions"] == 1 and len(snap["delta_fill"]) == 2
    index, params, reqs, out = served[0]
    assert index.num_shards == 2 and len(reqs) == 48
    Q = np.stack([r.query for r in reqs])
    lo = np.stack([r.lo for r in reqs])
    hi = np.stack([r.hi for r in reqs])
    ids, dists, _hops, _plan = teng.Planner(index, params).search(Q, lo, hi)
    np.testing.assert_array_equal(np.stack([r.ids for r in out]), ids)
    np.testing.assert_array_equal(np.stack([r.dists for r in out]), dists)
