"""``smoke_reference.py`` (the plain numpy reference ``chip_smoke.py``
holds the port to at full shard size) against the JAX package on the
CPU: the DFS router, the wide-frontier beam search with its hop cap, the
bulk builder's graph rows (also with near-ties taken a build's way), the
int8 score path (replica, graph-lane
rerank, scan-lane over-fetch and rerank), the hybrid path's antichain and
windowed scan, the predicate pass's row masks and masked top-k, and
one node's Algorithm 5 merge (``merge_node``). Ids
and hops are equal; distances within rtol = atol = 1e-5 (reduce
order)."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import router as jr
from repro.core import predicate as jpred
from repro.core import query_ref as jref
from repro.core.build_device import build_graphs_device as j_build
from repro.kernels import quant as jq

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import smoke_reference as sref  # noqa: E402


def _nhm(index):
    return np.ascontiguousarray(np.asarray(index.nbrs).transpose(1, 0, 2))


@pytest.mark.parametrize("scan_budget", [8, 10 ** 9])
def test_dfs_entries_match_reference(tiny_index, tiny_queries, scan_budget):
    _, preds = tiny_queries
    vecs, attrs = tiny_index.vecs, tiny_index.attrs
    for pr in preds:
        want = jref.range_filter(tiny_index, pr, 10, scan_budget=scan_budget)
        got = sref.dfs_entries(tiny_index.tree, attrs, pr.lo, pr.hi, 10,
                               scan_budget)
        assert got == want
    assert vecs.shape[0] == tiny_index.n


@pytest.mark.parametrize("max_steps", [1, 3, 17, 60])
def test_dfs_entries_pop_cap_matches_reference(tiny_index, tiny_queries,
                                               max_steps):
    """With a pop cap the numpy DFS stops where the reference's
    ``route_dfs`` stops at the same ``max_steps``."""
    _, preds = tiny_queries
    di = jeng.device_put_index(tiny_index)
    p = dataclasses.replace(jeng.derive_search_params(
        jeng.SearchParams(c_e=10, router="dfs"), di), max_steps=max_steps)
    lo = np.stack([pr.lo for pr in preds])
    hi = np.stack([pr.hi for pr in preds])
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b: jr.route_dfs(di, a, b, p)[0]))(lo, hi))
    cut = 0
    for i, pr in enumerate(preds):
        got = sref.dfs_entries(tiny_index.tree, tiny_index.attrs, pr.lo,
                               pr.hi, 10, p.scan_budget, max_steps)
        assert got == want[i][want[i] >= 0].tolist()
        cut += got != sref.dfs_entries(tiny_index.tree, tiny_index.attrs,
                                       pr.lo, pr.hi, 10, p.scan_budget)
    if max_steps < 60:
        assert cut > 0


@pytest.mark.parametrize("E", [1, 4])
def test_beam_search_matches_reference(tiny_index, tiny_queries, E):
    Q, preds = tiny_queries
    nbrs = _nhm(tiny_index)
    for q, pr in zip(Q, preds):
        want, st = jref.query(tiny_index, q, pr, 10, ef=32, c_e=10, c_n=16,
                              pool="beam", expand_width=E, router="dfs",
                              return_stats=True)
        entries = jref.range_filter(tiny_index, pr, 10)
        ids, dists, hops = sref.beam_search(
            tiny_index.vecs, tiny_index.attrs, nbrs, entries, q, pr.lo,
            pr.hi, k=10, ef=32, c_n=16, E=E, max_hops=10 ** 6)
        np.testing.assert_array_equal(ids[ids >= 0], want)
        assert hops == st["hops"]
        assert (np.diff(dists[ids >= 0]) >= 0).all()


def test_beam_search_hop_cap_matches_engine(tiny_index, tiny_queries):
    Q, preds = tiny_queries
    p = jeng.SearchParams(k=10, ef=32, c_n=16, expand_width=4, max_hops=3,
                          backend="jnp")
    w_ids, w_d, w_hops = jeng.search_batch(tiny_index, Q, preds, p)
    nbrs = _nhm(tiny_index)
    for i, (q, pr) in enumerate(zip(Q, preds)):
        entries = jref.range_filter_level(tiny_index, pr, 10)
        ids, dists, hops = sref.beam_search(
            tiny_index.vecs, tiny_index.attrs, nbrs, entries, q, pr.lo,
            pr.hi, k=10, ef=32, c_n=16, E=4, max_hops=3)
        np.testing.assert_array_equal(ids, w_ids[i])
        np.testing.assert_allclose(dists, w_d[i], rtol=1e-5, atol=1e-5)
        assert hops == w_hops[i]


def test_graph_rows_match_device_builder(tiny_index):
    t, vecs = tiny_index.tree, tiny_index.vecs
    M = 16
    want = j_build(t, vecs, M=M, dist="jnp", large_node=256, row_block=128)
    count = np.asarray(t.count)
    nodes = np.nonzero(count > 1)[0]
    # the root (row-blocked path), a mid-size node and the smallest classes
    picks = {int(nodes[np.argmax(count[nodes])])}
    for target in (300, 100, 40, 5, 2):
        picks.add(int(nodes[np.argmin(np.abs(count[nodes] - target))]))
    for p in sorted(picks):
        s, c = int(t.start[p]), int(t.count[p])
        members = np.asarray(t.order[s:s + c], np.int64)
        d_rows = sref.sq_dists_f64(vecs, vecs[members], chunk=500)[:, members]
        got = sref.graph_rows(vecs, members, np.arange(c), d_rows, M=M,
                              ef_b=2 * M)
        np.testing.assert_array_equal(got, want[int(t.level[p]), members])


def test_graph_rows_take_near_ties_the_builds_way(tiny_data):
    """A corpus holding exact and 1e-3 copies of its rows ties on many of
    the rule's decisions: the fp32 device builder breaks them its own way.
    Guided by its rows, ``graph_rows`` reproduces every row, while a
    corrupted row still differs; guided by the float64 rule's own rows,
    it returns them and reports no decision taken against the rule."""
    from repro.core.khi import KHIConfig, KHIIndex

    vecs, attrs = tiny_data
    rng = np.random.default_rng(4)
    pick = rng.choice(len(vecs), 200, replace=False)
    noise = rng.normal(0, 1e-3, (200, vecs.shape[1])).astype(np.float32)
    noise[:60] = 0
    vecs = np.concatenate([vecs, vecs[pick] + noise])
    attrs = np.concatenate([attrs, attrs[pick]])
    M = 16
    index = KHIIndex.build(vecs, attrs, KHIConfig(M=M, builder="device"))
    t = index.tree
    built = np.asarray(index.nbrs)
    count = np.asarray(t.count)
    nodes = np.nonzero(count > 1)[0]
    for target in (count.max(), 300, 40):
        p = int(nodes[np.argmin(np.abs(count[nodes] - target))])
        s, c = int(t.start[p]), int(t.count[p])
        members = np.asarray(t.order[s:s + c], np.int64)
        pos = np.arange(min(c, 160))
        d_rows = sref.sq_dists_f64(vecs, vecs[members[pos]],
                                   chunk=500)[:, members]
        got = built[int(t.level[p]), members[pos]]
        want, _ = sref.graph_rows(vecs, members, pos, d_rows, M=M,
                                  ef_b=2 * M, rel_tol=4e-6, guide=got)
        np.testing.assert_array_equal(want, got)
        bad = got.copy()
        bad[:, 0] = bad[:, 1]
        again, _ = sref.graph_rows(vecs, members, pos, d_rows, M=M,
                                   ef_b=2 * M, rel_tol=4e-6, guide=bad)
        assert (again != bad).any(1).all()
        plain = sref.graph_rows(vecs, members, pos, d_rows, M=M, ef_b=2 * M)
        same, n_tie = sref.graph_rows(vecs, members, pos, d_rows, M=M,
                                      ef_b=2 * M, rel_tol=4e-6, guide=plain)
        np.testing.assert_array_equal(same, plain)
        assert not n_tie.any()


def test_graph_shape_classes():
    assert sref.graph_shape(2, 32, 64) == (8, 7)
    assert sref.graph_shape(40, 32, 64) == (64, 32)
    assert sref.graph_shape(1_000_000, 32, 64) == (65, 32)


def test_quantize_rows_i8_matches_reference():
    rng = np.random.default_rng(9)
    v = (rng.standard_normal((300, 24))
         * rng.uniform(1e-3, 30, (300, 1))).astype(np.float32)
    v[::17] = 0.0
    v[3, :3] = [0.5, 1.5, -2.5]
    q, s = sref.quantize_rows_i8(v)
    wq, ws = jq.quantize_rows_i8(v)
    np.testing.assert_array_equal(q, np.asarray(wq))
    np.testing.assert_array_equal(s, np.asarray(ws))
    np.testing.assert_array_equal(sref.dequant_rows(q, s),
                                  np.asarray(jq.dequant_rows(wq, ws)))


def test_int8_graph_rerank_matches_engine(tiny_index, tiny_queries):
    """beam_search over the dequantized corpus keeps the top rr pool
    slots; rerank takes their exact (dist, id) top-k: the engine's
    quantized graph lanes."""
    Q, preds = tiny_queries
    p = jeng.SearchParams(k=10, ef=32, c_n=16, expand_width=4,
                          backend="jnp", quant="int8", rerank_mult=2)
    w_ids, w_d, w_hops = jeng.search_batch(
        jeng.device_put_index(tiny_index, quant="int8"), Q, preds, p)
    rr = max(p.k, min(p.ef, p.k * p.rerank_mult))
    deq = sref.dequant_rows(*sref.quantize_rows_i8(tiny_index.vecs))
    nbrs = _nhm(tiny_index)
    for i, (q, pr) in enumerate(zip(Q, preds)):
        entries = jref.range_filter_level(tiny_index, pr, 10)
        cand, _, hops = sref.beam_search(
            deq, tiny_index.attrs, nbrs, entries, q, pr.lo, pr.hi, k=rr,
            ef=32, c_n=16, E=4, max_hops=p.hops())
        ids, dists = sref.rerank(tiny_index.vecs, cand, q, p.k)
        np.testing.assert_array_equal(ids, w_ids[i])
        np.testing.assert_allclose(dists, w_d[i], rtol=1e-5, atol=1e-5)
        assert hops == w_hops[i]


def test_int8_scan_rerank_matches_engine(tiny_index, tiny_queries):
    Q, preds = tiny_queries
    p = jeng.SearchParams(k=10, ef=32, backend="jnp", quant="int8",
                          strategy="scan", rerank_mult=3)
    w_ids, w_d, _ = jeng.search_batch(tiny_index, Q, preds, p)
    deq = sref.dequant_rows(*sref.quantize_rows_i8(tiny_index.vecs))
    for i, (q, pr) in enumerate(zip(Q, preds)):
        ids, dists = sref.scan_rerank(deq, tiny_index.vecs,
                                      tiny_index.attrs, q, pr.lo, pr.hi,
                                      k=p.k, kq=p.k * p.rerank_mult)
        np.testing.assert_array_equal(ids, w_ids[i])
        fin = np.isfinite(w_d[i])
        np.testing.assert_allclose(dists[fin], w_d[i][fin], rtol=1e-5,
                                   atol=1e-5)


def _boxes(tiny_queries, m):
    _, preds = tiny_queries
    lo = np.stack([p.lo for p in preds]).astype(np.float32)
    hi = np.stack([p.hi for p in preds]).astype(np.float32)
    lo = np.concatenate([lo, np.full((2, m), -np.inf, np.float32)])
    hi = np.concatenate([hi, np.full((2, m), np.inf, np.float32)])
    lo[-1], hi[-1] = np.inf, -np.inf                 # an empty box
    return lo, hi


def test_antichain_matches_reference_estimator(tiny_index, tiny_queries):
    from repro.core.router import HostCardEstimator

    t = tiny_index.tree
    m = tiny_index.attrs.shape[1]
    root = int(np.nonzero(np.asarray(t.parent) < 0)[0][0])
    est = HostCardEstimator(np.asarray(t.left), np.asarray(t.right),
                            np.asarray(t.dim), np.asarray(t.bl),
                            np.asarray(t.lo), np.asarray(t.hi),
                            np.asarray(t.count), root)
    lo, hi = _boxes(tiny_queries, m)
    want = est.antichain(lo, hi)
    for i in range(len(lo)):
        got = sref.antichain(t, lo[i], hi[i])
        assert sorted(got) == np.nonzero(want[i])[0].tolist()
    assert sref.antichain(t, lo[-2], hi[-2]).tolist() == [root]


def test_window_scan_matches_hybrid_window_lanes(tiny_index, tiny_queries):
    """Pure-window lanes of the reference's hybrid planner: every node of
    the numpy antichain is small, and the numpy windowed scan over those
    nodes gives the planner's ids."""
    Q, _ = tiny_queries
    t = tiny_index.tree
    lo, hi = _boxes(tiny_queries, tiny_index.attrs.shape[1])
    Q = np.concatenate([Q, Q[:2]])
    thr = 120
    p = jeng.SearchParams(k=10, ef=32, c_n=16, backend="jnp",
                          strategy="hybrid", node_scan_threshold=thr)
    ids, dists, _, plan = jeng.Planner(tiny_index, p).search(Q, lo, hi)
    lanes = np.nonzero(plan.mode == 1)[0]
    assert len(lanes) >= 3
    count = np.asarray(t.count)
    for i in range(len(Q)):
        nodes = sref.antichain(t, lo[i], hi[i])
        small = all(count[nodes] <= thr)
        assert (plan.mode[i] == 1) == (small and plan.card[i] > 0)
        if plan.mode[i] != 1:
            continue
        got, gd = sref.window_scan(tiny_index.vecs, tiny_index.attrs, t,
                                   nodes, Q[i], lo[i], hi[i], 10)
        np.testing.assert_array_equal(got, ids[i])
        fin = np.isfinite(dists[i])
        np.testing.assert_allclose(gd[fin], dists[i][fin], rtol=1e-5,
                                   atol=1e-5)


def test_year_mask_matches_predicate_compiler(tiny_index):
    attrs = tiny_index.attrs.copy()
    attrs[::29, 0] = np.nan
    years = np.unique(attrs[:, 0][np.isfinite(attrs[:, 0])])
    a1_max = float(np.float32(np.median(attrs[:, 1])))
    e1 = years[::3][:3].tolist()
    e2 = years[::2].tolist()
    cases = ((e1, a1_max, "a0 in [{}] and a1 <= {!r}"),
             (e2, None, "a0 in [{}]"))
    for ys, amax, form in cases:
        text = form.format(", ".join(repr(float(y)) for y in ys), amax)
        expr = jpred.parse_expr(text, attrs.shape[1])
        want = jpred.eval_expr(expr, attrs)
        got = sref.year_mask(attrs, ys, amax)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(attrs)


def test_live_topk_and_merge_match_streaming_oracle():
    """live_topk over the base rows and over the inserted rows, merged by
    merge_dist_ext, equals the reference's StreamingOracle after inserts
    (exact duplicates of live rows among them: (dist, ext) ties) and
    deletes, on the 1/32 grid where every distance is exact."""
    rng = np.random.default_rng(41)
    n0, d, m, k = 120, 16, 2, 8
    vecs = (rng.integers(-64, 64, size=(n0, d)) / 32).astype(np.float32)
    attrs = rng.integers(0, 16, size=(n0, m)).astype(np.float32)
    oracle = jref.StreamingOracle(vecs, attrs)
    nv = (rng.integers(-64, 64, size=(60, d)) / 32).astype(np.float32)
    na = rng.integers(0, 16, size=(60, m)).astype(np.float32)
    nv[:20], na[:20] = vecs[:20], attrs[:20]
    oracle.insert(nv, na)
    oracle.delete(rng.choice(n0 + 60, size=40, replace=False))
    exts, lv, la = oracle.corpus()
    base, delta = exts < n0, exts >= n0
    Q = (rng.integers(-64, 64, size=(12, d)) / 32).astype(np.float32)
    for i, q in enumerate(Q):
        lo = rng.integers(0, 10, size=m).astype(np.float32)
        hi = lo + rng.integers(0, 9, size=m).astype(np.float32)
        if i % 4 == 0:
            lo[:], hi[:] = 0.0, 15.0
        parts = [sref.live_topk(lv[s], la[s], exts[s], q, lo, hi, k)
                 for s in (base, delta)]
        got_e, got_d = sref.merge_dist_ext(
            [(e[None], dd[None]) for e, dd in parts], k)
        want = oracle.query(q, jref.Predicate(lo, hi), k)
        np.testing.assert_array_equal(got_e[0][got_e[0] >= 0], want)
        assert (got_e[0] >= 0).sum() == len(want)
        for j, e in enumerate(want):
            v = lv[exts == e][0].astype(np.float64)
            assert got_d[0][j] == np.float32(((v - q) ** 2).sum())


@pytest.mark.parametrize("merge_chunk,symmetric_reverse", [(64, False),
                                                           (8, True)])
def test_merge_node_replays_the_reference_build(monkeypatch, merge_chunk,
                                                symmetric_reverse):
    """Every internal node's Algorithm 5 merge, replayed from the
    reference's rows one level down on a 1/32-grid corpus (exact
    distances), gives the reference's rows; the reference's visited mark
    is repaired (ROADMAP F6)."""
    from repro.core import beam as jbeam
    from repro.core import hnsw as jh
    from repro.core.tree import build_tree
    from test_torch_hnsw import _marked_visited_fresh

    monkeypatch.setattr(jbeam, "np_visited_fresh_mark", _marked_visited_fresh)
    rng = np.random.default_rng(13)
    n, M = 700, 8
    vecs = (rng.integers(-64, 64, size=(n, 16)) / 32).astype(np.float32)
    tree = build_tree(rng.integers(0, 16, size=(n, 3)).astype(np.float32))
    nbrs = jh.build_graphs(tree, vecs, M=M, merge_chunk=merge_chunk,
                           symmetric_reverse=symmetric_reverse)
    loc = np.full(n, -1, np.int64)
    replayed = 0
    for p in np.nonzero((tree.left >= 0) & (tree.count >= 8))[0]:
        lvl = int(tree.level[p])
        mem = tree.node_objects(int(p)).astype(np.int64)
        loc[mem] = np.arange(len(mem))
        low = nbrs[lvl + 1][mem]
        low = np.where(low >= 0, loc[np.maximum(low, 0)], -1)
        diff = vecs[mem][:, None] - vecs[mem][None]
        dist = np.einsum("abd,abd->ab", diff, diff).astype(np.float32)
        rows, ties = sref.merge_node(
            low, int(tree.count[tree.left[p]]), dist, M=M, ef_b=M,
            merge_chunk=merge_chunk, symmetric_reverse=symmetric_reverse,
            rel_tol=4e-6)
        got = np.where(rows >= 0, mem[np.maximum(rows, 0)], -1)
        np.testing.assert_array_equal(got, nbrs[lvl][mem], err_msg=str(p))
        assert ties >= 0
        loc[mem] = -1
        replayed += 1
    assert replayed > 20


def test_round_bf16_matches_jax_cast():
    """``round_bf16``'s bit arithmetic is the JAX cast to bfloat16 and
    back: random values, exact ties (both parities), subnormals, values
    past the range, infinities and NaN."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
            -30, 30, 4096),
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1e-40,
                  -3e-39, 3.4e38, -3.39e38, 0.0, -0.0, np.inf, -np.inf,
                  np.nan], np.float32)]).astype(np.float32)
    want = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    got = sref.round_bf16(x)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


def test_topk_f64_matches_brute_force(tiny_index, tiny_queries):
    Q, preds = tiny_queries
    rows = np.nonzero(preds[0].matches(tiny_index.attrs))[0]
    ids, dd = sref.topk_f64(tiny_index.vecs, rows, Q[:6], 10, chunk=64)
    for i in range(6):
        d64 = ((tiny_index.vecs[rows].astype(np.float64) - Q[i]) ** 2).sum(1)
        o = np.lexsort((rows, d64))[:10]
        np.testing.assert_array_equal(ids[i][:len(o)], rows[o])
        np.testing.assert_allclose(dd[i][:len(o)], d64[o], rtol=1e-6)
