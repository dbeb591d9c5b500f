"""The port's Algorithm 5 builder, greedy search, RNG prune and bulk builder
against the JAX package's ``repro.core.hnsw``.

Incremental builds run on a 1/32-grid corpus, where every squared distance
is exact in f32 whatever the reduce order, so ``nbrs`` must agree bit for
bit, ties included. The reference's numpy search drops object 0's visited
mark when an expanded row has pad slots (its pads clamp to id 0 and the
fancy-index ``|=`` keeps the last write, a pad's; ROADMAP Queue 3, F6): the
comparisons run it with that mark repaired, which is what the port does."""

import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core import hnsw as jh
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.tree import build_tree as jbuild_tree

from repro_torch.core import beam as tbeam
from repro_torch.core import hnsw as th
from repro_torch.core.khi import KHIConfig, KHIIndex
from repro_torch.core.tree import build_tree


_RAW_MARK = jbeam.np_visited_fresh_mark


def _marked_visited_fresh(visited, rows, nbr_ids, valid):
    """``np_visited_fresh_mark`` with every valid id marked (F6)."""
    fresh = valid & ~visited[rows[:, None], nbr_ids]
    r, c = np.nonzero(valid)
    visited[rows[r], nbr_ids[r, c]] = True
    return fresh


@pytest.fixture(autouse=True)
def _repaired_reference(monkeypatch):
    monkeypatch.setattr(jbeam, "np_visited_fresh_mark", _marked_visited_fresh)


def _grid(seed, n=400, d=16, m=3, skew=False):
    rng = np.random.default_rng(seed)
    vecs = (rng.integers(-64, 64, size=(n, d)) / 32).astype(np.float32)
    attrs = rng.integers(0, 16, size=(n, m)).astype(np.float32)
    if skew:                       # a heavy value: leaves at several levels
        attrs[: n // 3, 0] = 3.0
    return vecs, attrs


def _random_case(n, d, m, seed):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    attrs = rng.random((n, m)).astype(np.float32)
    return vecs, attrs, build_tree(attrs)


def test_visited_mark_fault_is_real():
    """F6 as the unrepaired reference has it: id 0 in a row with a pad
    slot is reported fresh and left unmarked."""
    visited = np.zeros((1, 8), bool)
    nbr = np.array([[5, 0, 0]])                  # the last lane a pad -> 0
    valid = np.array([[True, True, False]])
    fresh = _RAW_MARK(visited, np.array([0]), nbr, valid)
    assert fresh.tolist() == [[True, True, False]]
    assert visited[0, 5] and not visited[0, 0]
    visited = np.zeros((1, 8), bool)
    jbeam.np_visited_fresh_mark(visited, np.array([0]), nbr, valid)
    assert visited[0, 0] and visited[0, 5]


def test_pool_top_unexpanded_width1_is_the_argmin_slot():
    rng = np.random.default_rng(0)
    B, ef, size = 64, 12, 20
    d = rng.integers(0, 6, size=(B, size)).astype(np.float32)
    d[rng.random((B, size)) < 0.2] = np.inf
    d = np.sort(d, axis=1)
    ids = np.where(np.isfinite(d), rng.integers(0, 99, (B, size)), -1)
    exp = (rng.random((B, size)) < 0.5) | ~np.isfinite(d)
    exp[:4, :ef] = True                           # rows with no frontier
    want, alive = jbeam.np_pool_best_unexpanded(ids, d, exp, ef)
    pool = tbeam.Pool(torch.as_tensor(ids), torch.as_tensor(d),
                      torch.as_tensor(exp))
    slots, got_ids, valid = tbeam.pool_top_unexpanded(pool, ef, 1)
    np.testing.assert_array_equal(valid[:, 0].numpy(), alive)
    np.testing.assert_array_equal(slots[alive, 0].numpy(), want[alive])
    np.testing.assert_array_equal(got_ids[alive, 0].numpy(),
                                  ids[np.arange(B), want][alive])


def test_rng_prune_equal_with_repeated_ids():
    vecs, _ = _grid(1, n=200)
    rng = np.random.default_rng(2)
    X, K = 24, 40
    own = rng.integers(0, 200, X)
    cand = rng.integers(-1, 200, (X, K))
    cand[:, 5] = cand[:, 2]                       # a repeated id per list
    cand[:3, 7] = own[:3]                         # the object itself
    diff = vecs[np.maximum(cand, 0)] - vecs[own][:, None]
    cd = np.einsum("xkd,xkd->xk", diff, diff).astype(np.float32)
    cd[:, 5] = cd[:, 2]
    got = th.rng_prune(vecs, own, cand, cd, 8, device="cpu").numpy()
    for x in range(X):
        keep = cand[x] >= 0
        want = jh.rng_prune(vecs, int(own[x]), cand[x][keep], cd[x][keep], 8)
        row = got[x][got[x] >= 0]
        np.testing.assert_array_equal(row, want, err_msg=f"row {x}")


def test_greedy_search_batch_equal():
    vecs, attrs = _grid(3, n=500)
    tree = jbuild_tree(attrs)
    adj = jh.build_graphs_bulk(tree, vecs, M=12)[0]
    rng = np.random.default_rng(4)
    q = (rng.integers(-64, 64, size=(16, 16)) / 32).astype(np.float32)
    ent = rng.integers(0, 500, 16).astype(np.int32)
    want_ids, want_d = jh.greedy_search_batch(vecs, adj, q, ent, ef=24)
    ids, d = th.greedy_search_batch(vecs, adj, q, ent, 24, device="cpu")
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(d.numpy(), want_d)


@pytest.mark.parametrize("merge_chunk,symmetric_reverse,n", [
    (1, False, 240), (1, True, 240), (16, False, 500), (16, True, 500)])
def test_build_graphs_equal_on_grid(merge_chunk, symmetric_reverse, n):
    vecs, attrs = _grid(5, n=n, skew=True)
    tree = jbuild_tree(attrs)
    leaf_levels = np.unique(tree.level[tree.left < 0])
    assert len(leaf_levels) >= 3, "the tree should have uneven levels"
    want = jh.build_graphs(tree, vecs, M=8, merge_chunk=merge_chunk,
                           symmetric_reverse=symmetric_reverse)
    stats = []
    got = th.build_graphs(tree, vecs, M=8, merge_chunk=merge_chunk,
                          symmetric_reverse=symmetric_reverse, device="cpu",
                          stats=stats)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert [s["level"] for s in stats] == list(range(tree.height - 1, -1, -1))
    assert sum(s["lanes"] for s in stats) > 0


@pytest.mark.parametrize("n,d,m,M,ef_b,seed", [
    (600, 16, 2, 8, None, 1),
    (900, 24, 3, 8, None, 0),
    (700, 24, 3, 8, 24, 0),
])
def test_build_graphs_bulk_equal(n, d, m, M, ef_b, seed):
    """The reference's own fixed float seeds (its device builder's parity
    test): the bulk builders agree bit for bit there."""
    vecs, attrs, tree = _random_case(n, d, m, seed)
    want = jh.build_graphs_bulk(tree, vecs, M=M, ef_b=ef_b)
    got = th.build_graphs_bulk(tree, vecs, M=M, ef_b=ef_b, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_khi_build_default_and_bulk_equal():
    vecs, attrs = _grid(11, n=450)
    want = JIndex.build(vecs, attrs, JConfig(M=8))
    got = KHIIndex.build(vecs, attrs, KHIConfig(M=8), device="cpu")
    assert got.config.builder == "incremental" and got.build_seconds > 0
    np.testing.assert_array_equal(got.nbrs_numpy(), want.nbrs)
    assert got.graph_size_bytes() == want.graph_size_bytes()
    assert got.total_size_bytes() == want.total_size_bytes()
    vecs, attrs, _ = _random_case(600, 16, 2, 1)
    want = JIndex.build(vecs, attrs, JConfig(M=8, builder="bulk"))
    got = KHIIndex.build(vecs, attrs, KHIConfig(M=8, builder="bulk"),
                         device="cpu")
    np.testing.assert_array_equal(got.nbrs_numpy(), want.nbrs)
    assert got.graph_size_bytes() == want.graph_size_bytes()


def test_insert_incremental_equal_in_place():
    """One node's merge with a lower plane, left set and extras (the
    Postfiltering and internal-node call), on a numpy plane in place."""
    vecs, attrs = _grid(9, n=300)
    tree = jbuild_tree(attrs)
    lower = jh.build_graphs(tree, vecs, M=8)[1]
    left = np.arange(0, 300, 2)
    right = np.arange(1, 300, 2)
    left_set = np.zeros(300, bool)
    left_set[left] = True
    for sym in (False, True):
        want = np.full((300, 8), -1, np.int32)
        want[left] = lower[left]
        got = want.copy()
        kw = dict(M=8, ef_b=8, right_plane=lower, left_set=left_set,
                  merge_chunk=16, symmetric_reverse=sym)
        jh._insert_incremental(vecs, want, left, right, **kw)
        th._insert_incremental(vecs, got, left, right, device="cpu", **kw)
        np.testing.assert_array_equal(got, want)


# ---- the reference's graph invariants (tests/test_hnsw.py), on the port


@pytest.fixture(scope="module")
def port_index(tiny_data):
    vecs, attrs = tiny_data
    return KHIIndex.build(vecs, attrs, KHIConfig(M=16, merge_chunk=32),
                          device="cpu")


def test_degree_bound(port_index):
    nb = port_index.nbrs_numpy()
    assert (nb >= -1).all() and (nb < port_index.n).all()
    assert (nb >= 0).sum(axis=-1).max() <= port_index.config.M


def test_rows_defined_exactly_on_path(port_index):
    nb = port_index.nbrs_numpy()
    t = port_index.tree
    for lvl in range(port_index.height):
        assert (nb[lvl][t.path[:, lvl] < 0] == -1).all()


def test_neighbors_stay_in_node(port_index):
    nb = port_index.nbrs_numpy()
    t = port_index.tree
    for lvl in range(port_index.height):
        p = t.path[:, lvl]
        rows = nb[lvl]
        ok = rows >= 0
        src = np.broadcast_to(p[:, None], rows.shape)[ok]
        assert (t.path[rows[ok], lvl] == src).all()


def test_no_self_loops_no_dups(port_index):
    nb = port_index.nbrs_numpy()
    for lvl in range(port_index.height):
        rows = nb[lvl]
        assert not (rows == np.arange(rows.shape[0])[:, None]).any()
        srt = np.sort(rows, axis=1)
        assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()


def test_space_complexity_lemma2(port_index):
    occ = int((port_index.nbrs_numpy() >= 0).sum())
    assert occ <= port_index.n * port_index.config.M * port_index.height


def test_rng_prune_shielding():
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((64, 8)).astype(np.float32)
    cand = np.arange(1, 64)
    d = np.einsum("nd,nd->n", vecs[cand] - vecs[0], vecs[cand] - vecs[0])
    kept = th.rng_prune(vecs, [0], cand[None], d[None], 8,
                        device="cpu").numpy()[0]
    kept = kept[kept >= 0]
    assert 0 < len(kept) <= 8
    for i, e in enumerate(kept):
        de_o = np.sum((vecs[e] - vecs[0]) ** 2)
        for r in kept[:i]:
            assert np.sum((vecs[e] - vecs[r]) ** 2) >= de_o - 1e-5


def test_greedy_search_finds_near_exact_on_full_graph():
    rng = np.random.default_rng(4)
    n, d = 400, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    tree = build_tree(rng.random((n, 2)).astype(np.float32))
    nbrs = th.build_graphs_bulk(tree, vecs, M=16, device="cpu")
    q = rng.standard_normal((8, d)).astype(np.float32)
    ids, _ = th.greedy_search_batch(vecs, nbrs[0], q, np.zeros(8, np.int64),
                                    32, device="cpu")
    for b in range(8):
        d2 = np.einsum("nd,nd->n", vecs - q[b], vecs - q[b])
        gt = set(np.argsort(d2)[:10].tolist())
        assert len(gt & set(ids[b][ids[b] >= 0].tolist())) >= 8


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    vecs, attrs = _grid(1, n=50)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        th.build_graphs(jbuild_tree(attrs), vecs, M=4)
