"""The port's sharded index (``repro_torch.core.sharded``) and its planner
fan-out against the JAX package's, in one process on the CPU.

The inputs are the JAX package's per-shard indexes (``KHIIndex.build``
over the round-robin split of ``tiny_data``, n = 1,200, d = 24) and its
stacked arrays, for S in {2, 3, 4} and one uneven split (n = 1,198 over 3
shards of unequal size and height). The reference runs ``backend="jnp"``;
the port its production backend, whose kernels run their plain versions
on the CPU. Ids and hops must be equal; distances agree within rtol =
atol = 1e-5 (the two packages sum in other orders), and bit for bit on
the 1/32-grid corpus, where every squared distance is exact in f32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import sharded as jsh
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.predicate import parse_expr as jparse
from repro.data import make_queries

from repro_torch.core import engine as teng
from repro_torch.core import sharded as tsh
from repro_torch.core.predicate import parse_expr as tparse

CASES = {"S2": (2, 1200), "S3": (3, 1200), "S4": (4, 1200),
         "uneven": (3, 1198)}
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


@dataclasses.dataclass
class Case:
    shards: list          # the JAX package's per-shard KHIIndex
    jk: object            # its ShardedKHI
    tk: object            # the port's stack_shards of the same shards
    Q: np.ndarray
    lo: np.ndarray
    hi: np.ndarray


def _split(vecs, attrs, S, cfg):
    shard_of = np.arange(len(vecs)) % S
    return [JIndex.build(vecs[shard_of == s], attrs[shard_of == s], cfg)
            for s in range(S)]


@pytest.fixture(scope="module")
def cases(tiny_data):
    vecs, attrs = tiny_data
    q1, p1 = make_queries(vecs, attrs, n_queries=8, sigma=1 / 2, seed=51)
    q2, p2 = make_queries(vecs, attrs, n_queries=8, sigma=1 / 16, seed=52)
    Q = np.concatenate([q1, q2])
    lo = np.stack([p.lo for p in p1 + p2]).astype(np.float32)
    hi = np.stack([p.hi for p in p1 + p2]).astype(np.float32)
    out = {}
    for name, (S, n) in CASES.items():
        shards = _split(vecs[:n], attrs[:n], S,
                        JConfig(M=16, builder="bulk"))
        out[name] = Case(shards, jsh.stack_shards(shards),
                         tsh.stack_shards(shards, device="cpu"), Q, lo, hi)
    return out


def _same(got, want, exact=False):
    gi, gd = got[:2]
    wi, wd = (np.asarray(a) for a in want[:2])
    np.testing.assert_array_equal(gi, wi)
    if exact:
        np.testing.assert_array_equal(gd, wd)
        return
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)


def _leaves(jk):
    return {f.name: None if getattr(jk.di, f.name) is None
            else np.asarray(getattr(jk.di, f.name))
            for f in dataclasses.fields(jk.di)}


def _assert_stack_equal(tk, jk):
    for name, want in _leaves(jk).items():
        got = getattr(tk.di, name)
        if want is None:
            assert got is None, name
            continue
        got = np.asarray(got) if name == "root" else got.float().numpy() \
            if got.dtype == torch.bfloat16 else got.numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)
    np.testing.assert_array_equal(tk.offsets.numpy(), np.asarray(jk.offsets))
    assert tk.pad_waste == pytest.approx(jk.pad_waste, abs=0)
    assert tk.num_shards == jk.num_shards


@pytest.mark.parametrize("case", list(CASES))
def test_stack_shards_equals_reference(cases, case):
    """Field by field, padding included, and ``pad_waste``; the carry-
    across from the reference's stacked arrays gives the same index."""
    c = cases[case]
    _assert_stack_equal(c.tk, c.jk)
    if case == "uneven":
        assert c.jk.pad_waste[0] > 0 and max(c.jk.pad_waste) > 0
    carried = tsh.sharded_from_stacked(_leaves(c.jk), np.asarray(c.jk.offsets),
                                       c.jk.pad_waste, device="cpu")
    _assert_stack_equal(carried, c.jk)


def test_carry_across_keeps_the_replica(cases):
    c = cases["S3"]
    for quant in ("int8", "bf16"):
        jdi = jeng.with_quant_replica(c.jk.di, quant)
        jk = dataclasses.replace(c.jk, di=jdi)
        carried = tsh.sharded_from_stacked(_leaves(jk),
                                           np.asarray(jk.offsets),
                                           jk.pad_waste, device="cpu")
        _assert_stack_equal(carried, jk)
        # and equal to the port's own replica of the stacked corpus
        own = teng.with_quant_replica(c.tk.di, quant)
        assert torch.equal(own.qvecs, carried.di.qvecs)


def test_merge_topk_equals_reference_random_and_ties():
    """Random lists, then planted cross-shard ties: equal distances come
    out in (shard, rank) order, not by global id, and pads stay last."""
    rng = np.random.default_rng(0)
    S, B, k = 4, 6, 5
    gids = rng.integers(0, 1000, (S, B, k)).astype(np.int32)
    dists = np.sort(rng.random((S, B, k)).astype(np.float32), axis=-1)
    dists[:, :2] = np.round(dists[:, :2] * 4) / 4          # ties
    dists[:, 0] = 1.0                                      # lane 0: ties
    gids[1, 0, 0], dists[1, 0, 0] = 3, 0.5
    gids[0, 0, 1], dists[0, 0, 1] = 999, 0.5                # shard 0 first
    gids[2, 3], dists[2, 3] = -1, np.inf                   # pads
    want = jsh._merge_topk(jnp.asarray(gids), jnp.asarray(dists), k)
    got = tsh._merge_topk(torch.as_tensor(gids).long(),
                          torch.as_tensor(dists), k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0][0, 0] == 999 and got[0][0, 1] == 3
    # global ids from local ones keep -1
    loc = torch.tensor([[0, 5, -1]])
    assert tsh._local_to_global(loc, 2, 3).tolist() == [[2, 17, -1]]


@pytest.mark.parametrize("case,kw", [
    ("S2", dict(expand_width=4)), ("S3", dict(expand_width=1)),
    ("S4", dict(expand_width=4)), ("uneven", dict(expand_width=1)),
    ("uneven", dict(expand_width=4)),
    ("S4", dict(expand_width=4, router="dfs")),
    ("uneven", dict(expand_width=1, router="dfs"))])
def test_graph_fanout_equals_reference(cases, case, kw):
    """``search_sharded_emulated`` under ``graph``: merged ids, (S, B)
    hops per shard and distances equal to the reference's, for E = 1 and
    4 and both routers."""
    c = cases[case]
    p = dict(k=10, ef=48, c_n=16, **kw)
    want = jsh.search_sharded_emulated(
        c.jk, c.Q, c.lo, c.hi, jeng.SearchParams(backend="jnp", **p))
    got = tsh.search_sharded_emulated(
        c.tk, c.Q, c.lo, c.hi,
        teng.SearchParams(backend="pallas_gather_l2_filter", **p))
    _same(got, want)
    assert got[2].shape == (c.jk.num_shards, len(c.Q))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))


@pytest.mark.parametrize("strategy,quant,case", [
    ("scan", "none", "S4"), ("scan", "int8", "uneven"),
    ("scan", "bf16", "S2"), ("auto", "none", "uneven"),
    ("auto", "int8", "S3"), ("auto", "bf16", "S4"),
    ("hybrid", "none", "uneven"), ("hybrid", "int8", "S4"),
    ("graph", "int8", "uneven"), ("graph", "bf16", "S3"),
])
def test_planner_over_sharded_index_equals_reference(cases, strategy, quant,
                                                     case):
    """The ``Planner`` fan-out under every strategy and quant tier: ids,
    hops (max over shards for graph lanes, 0 for exact lanes), the
    routing bound ``plan.card`` summed over the shards' estimators, and
    the dispatch."""
    c = cases[case]
    p = dict(k=10, ef=48, c_n=16, expand_width=4, strategy=strategy,
             scan_threshold=150, quant=quant)
    if strategy == "hybrid":
        p["node_scan_threshold"] = 4           # mixed and pure-window lanes
    jp = jeng.Planner(c.jk, jeng.SearchParams(backend="jnp", **p))
    tp = teng.Planner(c.tk, teng.SearchParams(
        backend="pallas_gather_l2_filter", **p), device="cpu")
    want = jp.search(c.Q, c.lo, c.hi)
    got = tp.search(c.Q, c.lo, c.hi)
    _same(got, want)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].card, want[3].card)
    np.testing.assert_array_equal(got[3].use_scan, want[3].use_scan)
    if strategy == "auto":
        assert 0 < got[3].use_scan.sum() < len(c.Q)
    if strategy == "hybrid":
        np.testing.assert_array_equal(got[3].mode, want[3].mode)
        np.testing.assert_array_equal(got[3].n_windows, want[3].n_windows)
        assert len(set(got[3].mode.tolist())) > 1
    assert tp.n_total == jp.n_total


@pytest.mark.parametrize("text,mode", [(E_BOXES, "boxes"),
                                       (E_MASK, "bitmask")])
@pytest.mark.parametrize("strategy", ["auto", "hybrid"])
def test_search_expr_over_sharded_index(cases, text, mode, strategy):
    c = cases["uneven"]
    m = c.lo.shape[1]
    p = dict(k=10, ef=48, c_n=16, expand_width=4, strategy=strategy,
             scan_threshold=150)
    jp = jeng.Planner(c.jk, jeng.SearchParams(backend="jnp", **p))
    tp = teng.Planner(c.tk, teng.SearchParams(
        backend="pallas_gather_l2_filter", **p), device="cpu")
    want = jp.search_expr(c.Q[:6], jparse(text, m))
    got = tp.search_expr(c.Q[:6], tparse(text, m))
    assert got[3].mode == want[3].mode == mode
    _same(got, want)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert got[3].lanes == want[3].lanes


def _grid(rng, n, d=16):
    return (rng.integers(-64, 64, size=(n, d)) / 32).astype(np.float32)


@pytest.fixture(scope="module")
def grid_case():
    """The 1/32 grid (integer attrs, d = 16) over 3 shards of unequal
    size: every f32 distance is exact and ties are common."""
    rng = np.random.default_rng(4)
    n, S = 301, 3
    vecs = _grid(rng, n)
    vecs[1::7] = vecs[0::7][: len(vecs[1::7])]            # exact copies
    attrs = rng.integers(0, 16, size=(n, 2)).astype(np.float32)
    shards = _split(vecs, attrs, S, JConfig(M=8, builder="bulk"))
    Q = _grid(rng, 12)
    Q[:4] = vecs[:4]
    lo = rng.integers(0, 8, size=(12, 2)).astype(np.float32)
    hi = lo + rng.integers(2, 9, size=(12, 2)).astype(np.float32)
    return Case(shards, jsh.stack_shards(shards),
                tsh.stack_shards(shards, device="cpu"), Q, lo, hi)


@pytest.mark.parametrize("strategy", ["graph", "scan", "hybrid"])
def test_grid_corpus_bit_equal(grid_case, strategy):
    """On the grid the merge's tie order shows: ids in (dist, shard,
    local) order and distances bit-equal to the reference's."""
    c = grid_case
    p = dict(k=8, ef=32, c_n=16, expand_width=4, strategy=strategy)
    if strategy == "hybrid":
        p.update(scan_threshold=60, node_scan_threshold=12)
    want = jsh.search_sharded_emulated(
        c.jk, c.Q, c.lo, c.hi, jeng.SearchParams(backend="jnp", **p))
    got = tsh.search_sharded_emulated(
        c.tk, c.Q, c.lo, c.hi,
        teng.SearchParams(backend="pallas_gather_l2_filter", **p))
    _same(got, want, exact=True)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    if strategy == "scan":
        # the tie order is not the (dist, global id) order
        d, i = got[1], got[0].astype(np.int64)
        tied = (d[:, 1:] == d[:, :-1]) & (i[:, 1:] >= 0)
        assert tied.any()
        assert (i[:, 1:][tied] < i[:, :-1][tied]).any()


def test_validation_over_stacked_planes(cases):
    """The index-dependent bounds come from the stacked planes: the
    frontier cap is the max over shards, the scan budget over every
    shard's nodes, the stack cap from the padded height."""
    c = cases["uneven"]
    p = jeng.derive_search_params(jeng.SearchParams(), c.jk.di)
    q = teng.derive_search_params(teng.SearchParams(), c.tk.di)
    assert (q.frontier_cap, q.scan_budget, q.stack_cap) == \
        (p.frontier_cap, p.scan_budget, p.stack_cap)
    with pytest.raises(ValueError, match="undersized"):
        teng.validate_search_params(teng.SearchParams(frontier_cap=1),
                                    c.tk.di)


def test_smoke_reference_shard_merge_matches_reference(cases):
    """``smoke_reference.merge_shards``, the numpy merge ``chip_smoke.py``
    holds the card's sharded answers to, equals the reference's
    ``_local_to_global`` + ``_merge_topk`` on planted ties, and the numpy
    per-shard DFS + beam search merged by it equals the reference's graph
    fan-out."""
    import smoke_reference as sref

    rng = np.random.default_rng(3)
    S, B, k = 3, 5, 6
    loc = rng.integers(0, 50, (S, B, k)).astype(np.int32)
    d = np.round(rng.random((S, B, k)) * 4).astype(np.float32) / 4
    d = np.sort(d, axis=-1)
    loc[1, 2, 3:], d[1, 2, 3:] = -1, np.inf
    g = jsh._local_to_global(jnp.asarray(loc),
                             jnp.arange(S)[:, None, None], S)
    wd = jnp.where(g >= 0, jnp.asarray(d), jnp.inf)
    wi, wd = jsh._merge_topk(g, wd, k)
    gi, gd = sref.merge_shards(loc, d, S, k)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_array_equal(gd, np.asarray(wd))

    c = cases["uneven"]
    p = jeng.validate_search_params(
        jeng.SearchParams(k=10, ef=48, c_n=16, expand_width=4,
                          backend="jnp"), c.jk.di, on_undersized="adjust")
    want = jsh.search_sharded_emulated(c.jk, c.Q, c.lo, c.hi, p)
    per_i, per_d, per_h = [], [], []
    for s, ix in enumerate(c.shards):
        nbrs = np.asarray(c.jk.di.nbrs[s])              # padded height
        out = []
        for i in range(len(c.Q)):
            e = sref.dfs_entries(ix.tree, ix.attrs, c.lo[i], c.hi[i],
                                 p.c_e, p.scan_budget)
            out.append(sref.beam_search(ix.vecs, ix.attrs, nbrs, e, c.Q[i],
                                        c.lo[i], c.hi[i], k=p.k, ef=p.ef,
                                        c_n=p.c_n, E=p.expand_width,
                                        max_hops=p.hops()))
        per_i.append(np.stack([o[0] for o in out]))
        per_d.append(np.stack([o[1] for o in out]))
        per_h.append([o[2] for o in out])
    mi, md = sref.merge_shards(np.stack(per_i), np.stack(per_d),
                               len(c.shards), p.k)
    np.testing.assert_array_equal(mi, np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(per_h), np.asarray(want[2]))
    np.testing.assert_allclose(md, np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5)
