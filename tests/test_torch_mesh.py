"""Single-process pins of the collective sharded search's parts against
the JAX package, on the CPU: the device-side routing sweeps
(``route_level_card``, ``route_level_windows``) against the reference's
and the port's own host planner, the device dedup merge, the halving
merge simulated round by round, the merge's byte accounting and choice,
the shape-only input specs, and the argument errors of
``make_sharded_search_fn``, ``make_query_mesh``, ``KHIService(mesh=)``
and ``--mesh``. A gloo process group of one rank (``file://`` under a
temporary directory) stands in for the mesh where one is needed; at S = 1
the collective also answers as the reference's one-process fan-out does.
The multi-rank worlds run in ``test_torch_mesh_collective.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import router as jrt
from repro.core import sharded as jsh
from repro.core.khi import KHIConfig as JConfig
from repro.core.util import pow2_at_least
from repro.data import make_queries

from repro_torch.core import engine as teng
from repro_torch.core import router as trt
from repro_torch.core import sharded as tsh
from repro_torch.core.predicate import parse_expr


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def boxes(tiny_data):
    vecs, attrs = tiny_data
    _, p1 = make_queries(vecs, attrs, n_queries=12, sigma=1 / 2, seed=61)
    _, p2 = make_queries(vecs, attrs, n_queries=12, sigma=1 / 16, seed=62)
    lo = np.stack([p.lo for p in p1 + p2]).astype(np.float32)
    hi = np.stack([p.hi for p in p1 + p2]).astype(np.float32)
    lo[0], hi[0] = np.inf, -np.inf                  # the empty pad box
    lo[1], hi[1] = attrs.min(0) - 1, attrs.max(0) + 1
    return lo, hi


@pytest.fixture(scope="module")
def stacks(tiny_data):
    """The reference's and the port's stack of an uneven 3-shard split
    (unequal sizes and heights: padded shards)."""
    vecs, attrs = tiny_data
    n = 1198
    own = np.arange(n) % 3
    from repro.core.khi import KHIIndex as JIndex
    shards = [JIndex.build(vecs[:n][own == s], attrs[:n][own == s],
                           JConfig(M=16, builder="bulk")) for s in range(3)]
    return jsh.stack_shards(shards), tsh.stack_shards(shards, device="cpu")


def _views(tiny_index, stacks, which):
    """(JAX DeviceIndex, port DeviceIndex) of one index: the unsharded
    tiny index or a shard of the padded stack."""
    if which == "single":
        return (jeng.device_put_index(tiny_index),
                teng.device_put_index(tiny_index, device="cpu"))
    s = int(which[-1])
    jk, tk = stacks
    return jax.tree.map(lambda x: x[s], jk.di), tk.di.shard(s)


VIEWS = ["single", "shard0", "shard2"]


def _jvmap(fn, qlo, qhi):
    return jax.vmap(fn)(jnp.asarray(qlo), jnp.asarray(qhi))


@pytest.mark.parametrize("which", VIEWS)
def test_route_level_card_equals_reference_and_planner(tiny_index, stacks,
                                                       boxes, which):
    lo, hi = boxes
    jdi, tdi = _views(tiny_index, stacks, which)
    p = teng.validate_search_params(teng.SearchParams(strategy="auto"), tdi,
                                    on_undersized="adjust")
    jp = jeng.validate_search_params(jeng.SearchParams(strategy="auto"), jdi,
                                     on_undersized="adjust")
    assert p.frontier_cap == jp.frontier_cap
    got = trt.route_level_card(tdi, torch.as_tensor(lo), torch.as_tensor(hi),
                               p).numpy()
    want = _jvmap(lambda a, b: jrt.route_level_card(jdi, a, b, jp), lo, hi)
    np.testing.assert_array_equal(got, np.asarray(want))
    plan = teng.Planner(tdi, p, device="cpu").plan(lo, hi)
    np.testing.assert_array_equal(got, plan.card)
    # and route_level_sync's bound
    np.testing.assert_array_equal(got, trt.route_level_sync(
        tdi, torch.as_tensor(lo), torch.as_tensor(hi), p)[1].numpy())
    assert got[0] == 0 and got[1] > 0 and (got > 0).sum() > 12


def _windows(tdi, jdi, p, jp, lo, hi, node_thr, W):
    got = trt.route_level_windows(tdi, torch.as_tensor(lo),
                                  torch.as_tensor(hi), p, node_thr=node_thr,
                                  W=W)
    want = _jvmap(lambda a, b: jrt.route_level_windows(
        jdi, a, b, jp, node_thr=node_thr, W=W), lo, hi)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("which", VIEWS)
@pytest.mark.parametrize("node_thr", [8, 64])
def test_route_level_windows_equals_reference_and_planner(
        tiny_index, stacks, boxes, which, node_thr):
    """The bounds, the counts and the windows: the port returns the
    reference's first ``Wb`` columns (the rest are its pads)."""
    lo, hi = boxes
    jdi, tdi = _views(tiny_index, stacks, which)
    kw = dict(strategy="hybrid", node_scan_threshold=node_thr)
    p = teng.validate_search_params(teng.SearchParams(**kw), tdi,
                                    on_undersized="adjust")
    jp = jeng.validate_search_params(jeng.SearchParams(**kw), jdi,
                                     on_undersized="adjust")
    W = pow2_at_least(int(tdi.start.shape[0]))
    got, want = _windows(tdi, jdi, p, jp, lo, hi, node_thr, W)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    Wb = got[3].shape[1]
    assert Wb < W and Wb == pow2_at_least(int(got[1].max()))
    np.testing.assert_array_equal(got[3], want[3][:, :Wb])
    np.testing.assert_array_equal(got[4], want[4][:, :Wb])
    assert (want[3][:, Wb:] == -1).all() and (want[4][:, Wb:] == 0).all()
    # the port's host planner: counts, and the same windows per lane
    planner = teng.Planner(tdi, p, device="cpu")
    plan = planner.plan(lo, hi)
    np.testing.assert_array_equal(got[0], plan.card)
    np.testing.assert_array_equal(got[1], plan.n_windows)
    starts, counts, _ = planner._build_windows(plan.small_nodes,
                                               np.arange(len(lo)), len(lo))
    w = min(Wb, starts.shape[2])
    np.testing.assert_array_equal(got[3][:, :w], starts[0].numpy()[:, :w])
    np.testing.assert_array_equal(got[4][:, :w], counts[0].numpy()[:, :w])
    assert (got[1] > 0).any() and (got[2] > 0).any()


def test_route_level_windows_overflow_clamp(tiny_index, boxes):
    """A W below a lane's small-node count keeps its first W in sweep
    order, then sorts them, as the reference does."""
    lo, hi = boxes
    jdi, tdi = _views(tiny_index, None, "single")
    kw = dict(strategy="hybrid", node_scan_threshold=64)
    p = teng.validate_search_params(teng.SearchParams(**kw), tdi,
                                    on_undersized="adjust")
    jp = jeng.validate_search_params(jeng.SearchParams(**kw), jdi,
                                     on_undersized="adjust")
    got, want = _windows(tdi, jdi, p, jp, lo, hi, 64, 2)
    assert (got[1] > 2).any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _sorted_stream(rng, B, k, n_ids):
    ids = rng.integers(-1, n_ids, (B, k)).astype(np.int32)
    d = np.where(ids < 0, np.inf, rng.integers(0, 5, (B, k))).astype(
        np.float32)
    o = np.lexsort((ids, d), axis=-1)
    return np.take_along_axis(ids, o, 1), np.take_along_axis(d, o, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_dedup_jnp_bit_equal(seed):
    """Planted duplicates (an id in both streams, at different and at
    equal distances) and distance ties: the torch twin equals the JAX
    twin and the numpy form, ids and distances."""
    rng = np.random.default_rng(seed)
    B, k = 6, 8
    ia, da = _sorted_stream(rng, B, k, 40)
    ib, db = _sorted_stream(rng, B, k, 40)
    ib[0, 0], db[0, 0] = ia[0, 1], da[0, 1]           # the same entry
    ib[1, 2], db[1, 2] = ia[1, 0], da[1, 0] + 1       # a worse copy
    hi_, hd = teng._merge_dedup(ia, da, ib, db, k)
    ji, jd = jeng._merge_dedup_jnp(*(jnp.asarray(x) for x in (ia, da, ib,
                                                              db)), k)
    ti, td = teng._merge_dedup_jnp(*(torch.as_tensor(x) for x in (ia, da, ib,
                                                                  db)), k)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    for got in ((ti.numpy(), td.numpy()), (np.asarray(ji), np.asarray(jd))):
        np.testing.assert_array_equal(got[0], hi_)
        np.testing.assert_array_equal(got[1], hd)
    for b in range(B):
        real = hi_[b][hi_[b] >= 0]
        assert len(set(real.tolist())) == len(real)


def _halving_sim(gids, dists, k, pair_merge, to_np):
    """The halving rounds on a (S, B, k) stack: shard s's buffers evolve
    as rank s's do, with partner s ^ 2^r. Returns every round's stack."""
    S = gids.shape[0]
    tie = np.broadcast_to((np.arange(S)[:, None, None] * k
                           + np.arange(k)[None, None, :]).astype(np.int32),
                          gids.shape).copy()
    ids, d, t = gids.copy(), dists.copy(), tie
    rounds = []
    for rnd in range(S.bit_length() - 1):
        perm = np.arange(S) ^ (1 << rnd)
        out = [pair_merge(ids[s], d[s], t[s], ids[perm[s]], d[perm[s]],
                          t[perm[s]], k) for s in range(S)]
        ids, d, t = (np.stack([to_np(o[j]) for o in out]) for j in range(3))
        rounds.append((ids, d, t))
    return rounds


@pytest.mark.parametrize("S", [2, 4, 8])
def test_halving_simulation_equals_merge_topk(S):
    """Round by round equal to the JAX ``_pair_merge_k``, and every shard
    ends with ``_merge_topk``'s answer (the tie order included)."""
    rng = np.random.default_rng(S)
    B, k = 5, 10
    dists = np.sort(rng.integers(0, 6, (S, B, k)).astype(np.float32), -1)
    gids = rng.integers(0, 10_000, (S, B, k)).astype(np.int32)
    dists[:, :, -2:], gids[:, :, -2:] = np.inf, -1

    def tpm(*a):
        *xs, k_ = a
        return tsh._pair_merge_k(*(torch.as_tensor(x) for x in xs), k_)

    def jpm(*a):
        *xs, k_ = a
        return jsh._pair_merge_k(*(jnp.asarray(x) for x in xs), k_)

    got = _halving_sim(gids, dists, k, tpm, lambda x: x.numpy())
    want = _halving_sim(gids, dists, k, jpm, np.asarray)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    ei, ed = tsh._merge_topk(torch.as_tensor(gids).long(),
                             torch.as_tensor(dists), k)
    ji, jd = jsh._merge_topk(jnp.asarray(gids), jnp.asarray(dists), k)
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))
    for s in range(S):
        np.testing.assert_array_equal(got[-1][0][s], ei.numpy())
        np.testing.assert_array_equal(got[-1][1][s], ed.numpy())


@pytest.mark.parametrize("k,S,merge", [(10, 1, "halving"), (10, 4, "halving"),
                                       (10, 4, "allgather"), (7, 8, "halving"),
                                       (7, 8, "allgather"),
                                       (3, 64, "halving")])
def test_merge_bytes_per_device_equals_reference(k, S, merge):
    assert tsh.merge_bytes_per_device(k, S, merge) == \
        jsh.merge_bytes_per_device(k, S, merge)


@pytest.mark.parametrize("merge,S", [("auto", 4), ("auto", 3), ("auto", 1),
                                     ("auto", 2), ("allgather", 3),
                                     ("halving", 8), ("halving", 3),
                                     ("halving", 1), ("bogus", 4)])
def test_resolve_merge_equals_reference(merge, S):
    try:
        want = jsh._resolve_merge(merge, S)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsh._resolve_merge(merge, S)
        assert str(got.value) == str(e)
        return
    assert tsh._resolve_merge(merge, S) == want


@pytest.mark.parametrize("quant", ["none", "bf16", "int8"])
def test_sharded_input_specs_equal_reference(quant):
    kw = dict(n_per_shard=64, d=16, m=2, height=3, nodes_per_shard=31, M=8,
              n_shards=4, batch=8, quant=quant)
    tk, tq = tsh.sharded_input_specs(**kw)
    jk, jq = jsh.sharded_input_specs(**kw)
    for f in dataclasses.fields(jk.di):
        j, t = getattr(jk.di, f.name), getattr(tk.di, f.name)
        if j is None:
            assert t is None, f.name
            continue
        assert t.device.type == "meta", f.name
        assert tuple(t.shape) == tuple(j.shape), f.name
        assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name, f.name
    assert tuple(tk.offsets.shape) == tuple(jk.offsets.shape)
    for name in jq:
        assert tuple(tq[name].shape) == tuple(jq[name].shape)
    with pytest.raises(ValueError, match="quant"):
        tsh.sharded_input_specs(**dict(kw, quant="fp4"))


# ---------------------------------------------------------------------------
# one rank: argument errors, the service's refusals, S = 1 answers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    import torch.distributed as dist
    from repro_torch.launch.mesh import (init_query_process_group,
                                         make_query_mesh)

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_query_mesh(1, 1)
    f = tmp_path_factory.mktemp("mesh1") / "rendezvous"
    dev = init_query_process_group("cpu", init_method=f"file://{f}", rank=0,
                                   world_size=1, timeout_s=60)
    assert dev.type == "cpu"
    try:
        yield make_query_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def one_shard(tiny_index):
    return (jsh.stack_shards([tiny_index]),
            tsh.stack_shards([tiny_index], device="cpu"))


def test_make_query_mesh_layout_and_errors(mesh1):
    from repro_torch.launch.mesh import make_query_mesh

    assert mesh1.shape == {"data": 1, "model": 1}
    assert (mesh1.rank, mesh1.data_index, mesh1.model_index) == (0, 0, 0)
    assert mesh1.backend == "gloo" and mesh1.device.type == "cpu"
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_query_mesh(2, 2)
    with pytest.raises(ValueError, match="gloo"):
        make_query_mesh(1, 1, device="cuda")


def test_collective_argument_errors(mesh1, one_shard, tiny_index):
    """As ``test_collective_auto_requires_threshold_source``, and the
    port's other argument checks."""
    _, tk = one_shard
    SP = teng.SearchParams
    with pytest.raises(ValueError, match="skhi"):
        tsh.make_sharded_search_fn(SP(strategy="auto"), mesh1)
    with pytest.raises(ValueError, match="skhi"):
        tsh.make_sharded_search_fn(SP(strategy="hybrid"), mesh1)
    fn = tsh.make_sharded_search_fn(SP(strategy="auto", scan_threshold=32),
                                    mesh1)
    assert callable(fn) and fn.static["scan_threshold"] == 32
    with pytest.raises(ValueError, match="power-of-two"):
        tsh.make_sharded_search_fn(SP(), mesh1, merge="halving")
    with pytest.raises(ValueError, match="merge"):
        tsh.make_sharded_search_fn(SP(), mesh1, merge="ring")
    with pytest.raises(ValueError, match="replica"):
        tsh.make_sharded_search_fn(SP(strategy="scan", quant="int8"), mesh1,
                                   skhi=tk, on_undersized="adjust")
    with pytest.raises(ValueError, match="undersized"):
        tsh.make_sharded_search_fn(SP(frontier_cap=1), mesh1, skhi=tk)
    with pytest.raises(TypeError, match="QueryMesh"):
        tsh.make_sharded_search_fn(SP(), object())
    two = tsh.stack_shards([tiny_index, tiny_index], device="cpu")
    with pytest.raises(ValueError, match="2 shards"):
        tsh.make_sharded_search_fn(SP(), mesh1, skhi=two)
    with pytest.raises(ValueError, match="pallas_l2"):
        tsh.make_sharded_search_fn(SP(strategy="scan", backend="pallas_l2"),
                                   mesh1)


@pytest.mark.parametrize("strategy,quant", [("graph", "none"),
                                            ("auto", "none"),
                                            ("auto", "int8"),
                                            ("hybrid", "none")])
def test_one_rank_collective_equals_reference(mesh1, one_shard, tiny_queries,
                                              strategy, quant):
    """At S = 1 (one rank on one card) the global ids are the local ones and
    the collective answers as the reference's one-process fan-out."""
    jk, tk = one_shard
    Q, preds = tiny_queries
    lo = np.stack([p.lo for p in preds]).astype(np.float32)
    hi = np.stack([p.hi for p in preds]).astype(np.float32)
    kw = dict(k=10, ef=48, c_n=16, strategy=strategy, quant=quant,
              node_scan_threshold=32)
    if quant != "none":
        jk = dataclasses.replace(jk, di=jeng.with_quant_replica(jk.di, quant))
        tk = dataclasses.replace(tk, di=teng.with_quant_replica(tk.di, quant))
    want = jsh.search_sharded_emulated(jk, Q, lo, hi,
                                       jeng.SearchParams(backend="jnp", **kw))
    fn = tsh.make_sharded_search_fn(
        teng.SearchParams(backend="pallas_gather_l2_filter", **kw), mesh1,
        skhi=tk, on_undersized="adjust")
    ids, dists = fn(tk, Q, lo, hi)
    assert ids.dtype == torch.int32 and ids.shape == (len(Q), 10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(dists.numpy(), np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5)


def test_stack_shards_of_one_device_index_is_a_view(one_shard):
    _, tk = one_shard
    di = tk.di.shard(0)
    sk = tsh.stack_shards([di])
    assert sk.num_shards == 1 and sk.di.root == (di.root,)
    assert sk.di.vecs.data_ptr() == di.vecs.data_ptr()
    with pytest.raises(ValueError, match="alone"):
        tsh.stack_shards([di, di])


def test_service_mesh_refusals(mesh1, one_shard, tiny_index, tiny_queries):
    from repro_torch.serve import KHIService

    _, tk = one_shard
    with pytest.raises(ValueError, match="ShardedKHI"):
        KHIService(tiny_index, teng.SearchParams(), mesh=mesh1, device="cpu")
    svc = KHIService(tk, teng.SearchParams(strategy="auto"), mesh=mesh1)
    Q, _ = tiny_queries
    with pytest.raises(ValueError, match="compiled predicates"):
        svc.search_expr(Q[:2], parse_expr("a0 >= 2015", 3))
    with pytest.raises(ValueError, match="streaming with mesh"):
        svc.enable_streaming(capacity=64)
    snap = svc.snapshot()
    assert snap["scan_lanes"] == 0 and snap["batches"] == 0


def test_launcher_mesh_refuses_the_smokes():
    from repro_torch.launch import serve as launcher
    for flag in (["--filter-expr", "a0 >= 1"], ["--stream-smoke"],
                 ["--load-smoke"]):
        with pytest.raises(ValueError, match="does not run under --mesh"):
            launcher.main(["--n", "200", "--device", "cpu", "--mesh"] + flag)
