"""The port's quantized score path against the JAX package's: the replica,
the q8 and bf16 kernels' plain versions (against the Pallas kernels in
interpret mode), the engine's quantized graph, scan and auto search, the
rerank contract and the quantized KHIService. Inputs come from numpy
seeds and every expected value is computed live by the JAX package.

Tolerances: the int8 and bf16 replicas are bit-equal. Ids and hops are
always equal. Distances on float inputs are within rtol = atol = 1e-5
(the two reduce orders differ); on integer int8 rows whose scale is 1
with a 1/32-grid query every squared distance is exact in f32 whatever
the order, so those distances are compared bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jeng
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.data import make_queries
from repro.kernels import quant as jq
from repro.kernels.gather_l2_filter import (gather_l2_filter_blocked_raw,
                                            gather_l2_filter_q8_blocked_raw)
from repro.kernels.ref import scan_topk_ref as j_scan_topk_ref
from repro.kernels.scan_topk import scan_topk_q8_raw, scan_topk_raw
from repro.serve import KHIService as JService, ServeConfig as JServeConfig

from repro_torch.core import engine as teng
from repro_torch.core.query_ref import Predicate
from repro_torch.kernels import ops, quant as tq, ref
from repro_torch.serve import KHIService, ServeConfig

BACKENDS = ("jnp", "pallas_gather_l2_filter")
QUANTS = ("int8", "bf16")


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _close(got, want, exact=False):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    if exact:
        np.testing.assert_array_equal(got[fin], want[fin])
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _bits(x):
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return x.view(np.uint16)
    return x


# ------------------------------------------------------------- replica

@pytest.mark.parametrize("quant", QUANTS)
def test_quant_replica_bit_equal_to_reference(quant):
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((3, 200, 40))
         * rng.uniform(1e-3, 50, (3, 200, 1))).astype(np.float32)
    v[0, ::13] = 0.0                                     # all-zero rows
    v[1, 5, :4] = [0.5, -1.5, 2.5, 127.0]                # halves to even
    for x in (v[0], v):                                  # (n, d), (S, n, d)
        wq, ws = jq.quant_replica(jnp.asarray(x), quant)
        gq, gs = tq.quant_replica(torch.as_tensor(x), quant)
        np.testing.assert_array_equal(
            _bits(gq.view(torch.int16).numpy().view(np.uint16)
                  if quant == "bf16" else gq.numpy()), _bits(wq))
        if quant == "int8":
            assert gq.dtype == torch.int8 and gs.shape == x.shape[:-1] + (1,)
            np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        else:
            assert gq.dtype == torch.bfloat16 and gs is None and ws is None
    q, s = tq.quantize_rows_i8(torch.zeros((4, 8)))
    assert (q == 0).all() and (s == 1).all()


def test_dequant_and_bytes_per_row():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    wq, ws = jq.quantize_rows_i8(jnp.asarray(x))
    got = tq.dequant_rows(*_t(wq, ws)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.dequant_rows(wq, ws)))
    assert np.abs(got - x).max() <= np.abs(x).max(1).max() / 127
    for quant in ("none", "bf16", "int8"):
        assert tq.quant_bytes_per_row(768, quant) == jq.quant_bytes_per_row(
            768, quant)
    assert tq.QUANTS == jq.QUANTS == teng.QUANTS
    with pytest.raises(ValueError, match="quant"):
        tq.quant_replica(torch.zeros((2, 2)), "fp4")


# ------------------------------------------------------------- kernels

def _gather_case(rng, N, d, m, B, C, exact):
    if exact:
        # integer rows that reach +-127 have scale 1: exact dequant
        corpus = rng.integers(-127, 128, size=(N, d)).astype(np.float32)
        corpus[:, 0] = 127.0
        q = (rng.integers(-64, 64, size=(B, d)) / 32).astype(np.float32)
    else:
        corpus = rng.standard_normal((N, d)).astype(np.float32)
        q = rng.standard_normal((B, d)).astype(np.float32)
    attrs = rng.integers(0, 16, size=(N, m)).astype(np.float32)
    attrs[::11, 1] = np.nan                              # tombstone rows
    lo = rng.integers(0, 12, size=(B, m)).astype(np.float32)
    hi = lo + rng.integers(0, 6, size=(B, m)).astype(np.float32)
    lo[2], hi[2] = 100.0, 200.0                          # all out of range
    idx = rng.integers(0, N, size=(B, C)).astype(np.int32)
    idx[:, ::7] = -1                                     # pad lanes
    idx[4] = -1
    return corpus, attrs, q, lo, hi, idx


@pytest.mark.parametrize("exact", [True, False])
def test_gather_l2_filter_q8_matches_pallas(exact):
    rng = np.random.default_rng(2)
    corpus, attrs, q, lo, hi, idx = _gather_case(rng, 300, 24, 3, 5, 40,
                                                 exact)
    qv, qs = jq.quantize_rows_i8(jnp.asarray(corpus))
    want = gather_l2_filter_q8_blocked_raw(
        jnp.asarray(idx), qv, qs, jnp.asarray(attrs), jnp.asarray(q),
        jnp.asarray(lo), jnp.asarray(hi), c_blk=16, interpret=True)
    got = ops.gather_l2_filter_q8(*_t(idx, qv, qs, attrs, q, lo, hi))
    _close(got.numpy(), want, exact)
    assert np.isinf(got.numpy()[[2, 4]]).all()


def test_gather_l2_filter_bf16_matches_pallas():
    """The bf16 replica through kernel 1, with the query rounded to bf16
    as the reference's kernel scorer sends it."""
    rng = np.random.default_rng(3)
    corpus, attrs, q, lo, hi, idx = _gather_case(rng, 300, 24, 3, 5, 40,
                                                 False)
    cb = jnp.asarray(corpus).astype(jnp.bfloat16)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    want = gather_l2_filter_blocked_raw(
        jnp.asarray(idx), cb, jnp.asarray(attrs), qb, jnp.asarray(lo),
        jnp.asarray(hi), c_blk=16, interpret=True)
    tc = torch.as_tensor(corpus).to(torch.bfloat16)
    tqb = torch.as_tensor(q).to(torch.bfloat16).to(torch.float32)
    got = ops.gather_l2_filter(*_t(idx), tc, *_t(attrs), tqb, *_t(lo, hi))
    _close(got.numpy(), want)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("k", [1, 10, 40])
def test_scan_topk_replicas_match_pallas(quant, k):
    rng = np.random.default_rng(20 + k)
    N, d, m, B = 300, 16, 3, 6
    corpus = rng.standard_normal((N, d)).astype(np.float32)
    corpus[150:170] = corpus[30:50]                      # duplicate rows
    attrs = rng.integers(0, 8, size=(N, m)).astype(np.float32)
    attrs[5::13, 0] = np.nan
    q = rng.standard_normal((B, d)).astype(np.float32)
    lo = rng.integers(0, 4, size=(B, m)).astype(np.float32)
    hi = lo + rng.integers(0, 5, size=(B, m)).astype(np.float32)
    lo[1], hi[1] = 50.0, 60.0                            # nothing in range
    lo[3], hi[3] = -np.inf, np.inf                       # all but NaN rows
    jargs = [jnp.asarray(a) for a in (attrs, q, lo, hi)]
    if quant == "int8":
        qv, qs = jq.quantize_rows_i8(jnp.asarray(corpus))
        wi, wd = scan_topk_q8_raw(qv, qs, *jargs, k=k, n_blk=64,
                                  interpret=True)
        gi, gd = ops.scan_topk_q8(*_t(qv, qs, attrs, q, lo, hi), k=k)
    else:
        wi, wd = scan_topk_raw(jnp.asarray(corpus).astype(jnp.bfloat16),
                               *jargs, k=k, n_blk=64, interpret=True)
        gi, gd = ops.scan_topk(torch.as_tensor(corpus).to(torch.bfloat16),
                               *_t(attrs, q, lo, hi), k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gd.numpy(), wd)
    assert (gi.numpy()[1] == -1).all()


def test_q8_wrappers_count_and_check():
    rng = np.random.default_rng(4)
    qv, qs = tq.quantize_rows_i8(torch.as_tensor(
        rng.standard_normal((40, 8)).astype(np.float32)))
    attrs = torch.zeros((40, 2))
    q = torch.zeros((3, 8))
    lo, hi = torch.full((3, 2), -1.0), torch.full((3, 2), 1.0)
    ops.reset_launches()
    ref.reset_calls()
    ops.gather_l2_filter_q8(torch.arange(12).reshape(3, 4), qv, qs, attrs,
                            q, lo, hi)
    ops.scan_topk_q8(qv, qs, attrs, q, lo, hi, k=5)
    assert ref.CALLS["gather_l2_filter_q8"]["cpu"] == 1
    assert ref.CALLS["scan_topk_q8"]["cpu"] == 1
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(TypeError, match="int8"):
        ops.scan_topk_q8(qv.float(), qs, attrs, q, lo, hi, k=5)
    with pytest.raises(ValueError, match="qscale"):
        ops.scan_topk_q8(qv, qs[:20], attrs, q, lo, hi, k=5)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.scan_topk(qv, attrs, q, lo, hi, k=5)


# -------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def workload(tiny_data):
    vecs, attrs = tiny_data
    q1, p1 = make_queries(vecs, attrs, n_queries=10, sigma=1 / 2, seed=41)
    q2, p2 = make_queries(vecs, attrs, n_queries=10, sigma=1 / 64, seed=42)
    Q = np.concatenate([q1, q2])
    lo = np.stack([p.lo for p in p1 + p2]).astype(np.float32)
    hi = np.stack([p.hi for p in p1 + p2]).astype(np.float32)
    return Q, lo, hi


def _params(mod, **kw):
    base = dict(k=10, ef=32, c_n=16, expand_width=4, scan_threshold=120)
    base.update(kw)
    return mod.SearchParams(**base)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("strategy", ["graph", "scan", "auto"])
def test_quant_planner_matches_reference(tiny_index, workload, backend,
                                         quant, strategy):
    """The same backend on both sides: the kernel backend's bf16 scorer
    rounds the query, the plain one does not (as in the reference)."""
    Q, lo, hi = workload
    kw = dict(backend=backend, quant=quant, strategy=strategy)
    wi, wd, wh, wplan = jeng.Planner(tiny_index,
                                     _params(jeng, **kw)).search(Q, lo, hi)
    tp = teng.Planner(teng.device_put_index(tiny_index, device="cpu"),
                      _params(teng, **kw))
    gi, gd, gh, gplan = tp.search(Q, lo, hi)
    np.testing.assert_array_equal(gplan.use_scan, wplan.use_scan)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gh, wh)
    _close(gd, wd)
    _close(gd, wd)
    assert (gi >= 0).any()
    assert tp.index.qvecs.dtype == (torch.int8 if quant == "int8"
                                    else torch.bfloat16)


def test_kernel_bf16_scorer_rounds_the_query(tiny_index, workload):
    """The trap the reference sets: on the kernel backend the bf16 graph
    scorer sees a bf16 query, on the plain backend an f32 one, so their
    loop distances differ, and each port backend matches its own."""
    Q, lo, hi = workload
    di = teng.with_quant_replica(
        teng.device_put_index(tiny_index, device="cpu"), "bf16")
    ids = torch.as_tensor(np.arange(40).reshape(2, 20))
    q, ql, qh = _t(Q[:2], np.full((2, 3), -np.inf, np.float32),
                   np.full((2, 3), np.inf, np.float32))
    kern = teng.resolve_scorer("pallas_gather_l2_filter", quant="bf16")
    plain = teng.resolve_scorer("jnp", quant="bf16")
    dk, dp = kern.score(di, q, ql, qh, ids), plain.score(di, q, ql, qh, ids)
    assert not torch.equal(dk, dp)
    qb = q.to(torch.bfloat16).to(torch.float32)
    torch.testing.assert_close(dk, plain.score(di, qb, ql, qh, ids),
                               rtol=0, atol=0)


def test_make_search_fn_reranks_like_reference(tiny_index, workload):
    Q, lo, hi = workload
    p = dict(backend="pallas_gather_l2_filter", quant="int8")
    jdi = jeng.device_put_index(tiny_index, quant="int8")
    pj = jeng.validate_search_params(_params(jeng, **p), jdi,
                                     on_undersized="adjust")
    wi, wd, wh = jeng.make_search_fn(pj)(jdi, jnp.asarray(Q),
                                         jnp.asarray(lo), jnp.asarray(hi))
    tdi = teng.device_put_index(tiny_index, device="cpu", quant="int8")
    pt = teng.validate_search_params(_params(teng, **p), tdi,
                                     on_undersized="adjust")
    gi, gd, gh = teng.make_search_fn(pt)(tdi, *_t(Q, lo, hi))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    _close(gd.numpy(), wd)
    with pytest.raises(ValueError, match="replica"):
        teng.make_search_fn(pt)(dataclasses.replace(tdi, qvecs=None),
                                *_t(Q, lo, hi))


def test_lex_topk_matches_reference():
    rng = np.random.default_rng(5)
    ids = rng.permutation(64)[:48].reshape(3, 16).astype(np.int32)
    ids[0, 3] = ids[1, 7] = -1
    d = rng.integers(0, 5, size=(3, 16)).astype(np.float32)  # many ties
    d[0, 3] = d[1, 7] = np.inf
    d[2, 10:] = np.inf
    wi, wd = jeng._lex_topk(jnp.asarray(ids), jnp.asarray(d), 12)
    gi, gd = teng._lex_topk(*_t(ids, d), 12)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


# ------------------------------------------ rerank contract (test_quant)

def _quant_workload(B, N, D, M, seed):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    attrs = rng.uniform(0, 10, (N, M)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    qlo = rng.uniform(0, 6, (B, M)).astype(np.float32)
    qhi = qlo + rng.uniform(0, 5, (B, M)).astype(np.float32)
    return corpus, attrs, q, qlo, qhi


def _oracle_topk(corpus, attrs, q, qlo, qhi, k):
    i, d = j_scan_topk_ref(*[jnp.asarray(a) for a in (corpus, attrs, q,
                                                       qlo, qhi)], k)
    return np.asarray(i), np.asarray(d)


def _planner(corpus, attrs, **kw):
    index = JIndex.build(corpus, attrs, JConfig(M=8))
    p = teng.SearchParams(router="level", strategy="scan", **kw)
    return teng.Planner(teng.device_put_index(index, device="cpu"), p)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("quant", QUANTS)
def test_scan_strategy_ids_bitwise_vs_f32_oracle(backend, quant):
    corpus, attrs, q, qlo, qhi = _quant_workload(6, 400, 16, 2, seed=42)
    qlo[0], qhi[0] = 0.0, 10.0                       # whole corpus
    qhi[1] = qlo[1] - 1.0                            # empty box
    pl = _planner(corpus, attrs, k=8, ef=64, backend=backend, quant=quant)
    ids, dists, hops, _ = pl.search(q, qlo, qhi)
    oid, od = _oracle_topk(corpus, attrs, q, qlo, qhi, 8)
    np.testing.assert_array_equal(ids, oid)
    fin = np.isfinite(od)
    np.testing.assert_allclose(dists[fin], od[fin], rtol=1e-5, atol=1e-6)
    assert np.all(hops == 0)


def test_rerank_fixes_k_boundary_inversion():
    """A seed where the raw int8 scan order is wrong at the k boundary;
    the reranked path returns the f32 oracle's ids anyway."""
    k = 5
    inverted = None
    for seed in range(40):
        corpus, attrs, q, qlo, qhi = _quant_workload(4, 256, 16, 2, seed)
        qlo[:], qhi[:] = 0.0, 10.0                   # every row in range
        qv, qs = tq.quant_replica(torch.as_tensor(corpus), "int8")
        ri, _ = ref.scan_topk_q8_ref(qv, qs, *_t(attrs, q, qlo, qhi), k)
        oi, _ = _oracle_topk(corpus, attrs, q, qlo, qhi, k)
        if not np.array_equal(ri.numpy(), oi):
            inverted = (corpus, attrs, q, qlo, qhi, oi)
            break
    assert inverted is not None, "no int8 k-boundary inversion in 40 seeds"
    corpus, attrs, q, qlo, qhi, oi = inverted
    pl = _planner(corpus, attrs, k=k, ef=64, backend="jnp", quant="int8")
    ids, _, _, _ = pl.search(q, qlo, qhi)
    np.testing.assert_array_equal(ids, oi)


@pytest.mark.parametrize("quant", QUANTS)
def test_rerank_duplicate_ties_lowest_id(quant):
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((64, 8)).astype(np.float32)
    corpus[41] = corpus[7]                            # exact duplicate pair
    attrs = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    attrs[41] = attrs[7]
    q = corpus[7][None] + np.float32(0.01)
    qlo = np.zeros((1, 2), np.float32)
    qhi = np.ones((1, 2), np.float32)
    pl = _planner(corpus, attrs, k=4, ef=32, backend="jnp", quant=quant)
    ids, dists, _, _ = pl.search(q, qlo, qhi)
    oid, _ = _oracle_topk(corpus, attrs, q, qlo, qhi, 4)
    np.testing.assert_array_equal(ids, oid)
    pos7, pos41 = list(ids[0]).index(7), list(ids[0]).index(41)
    assert pos7 < pos41 and dists[0][pos7] == dists[0][pos41]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("quant", QUANTS)
def test_rerank_all_out_of_range_lanes(backend, quant):
    corpus, attrs, q, qlo, qhi = _quant_workload(3, 120, 8, 2, seed=8)
    qlo[:], qhi[:] = 1.0, 0.0                        # provably empty boxes
    pl = _planner(corpus, attrs, k=6, ef=32, backend=backend, quant=quant)
    ids, dists, _, _ = pl.search(q, qlo, qhi)
    np.testing.assert_array_equal(ids, np.full((3, 6), -1, np.int32))
    assert np.all(np.isinf(dists))


@pytest.mark.parametrize("quant", QUANTS)
def test_nan_tombstones_masked_through_quant_replica(quant):
    """A tombstoned row keeps its replica data, but its NaN attr row keeps
    it out of every quantized top-k. The port has no refresh_index yet,
    so the tombstoned index (replica kept) goes to a new Planner."""
    rng = np.random.default_rng(4)
    corpus = rng.standard_normal((96, 8)).astype(np.float32)
    attrs = rng.uniform(0, 1, (96, 2)).astype(np.float32)
    q = corpus[10][None]                              # row 10 is the 1-NN
    qlo = np.zeros((1, 2), np.float32)
    qhi = np.ones((1, 2), np.float32)
    planner = _planner(corpus, attrs, k=4, ef=32, backend="jnp",
                       quant=quant)
    ids0, _, _, _ = planner.search(q, qlo, qhi)
    assert 10 in ids0[0]
    di = planner.index
    tattrs = di.attrs.clone()
    tattrs[10] = float("nan")
    tomb = dataclasses.replace(di, attrs=tattrs)
    p2 = teng.Planner(tomb, planner.params)
    assert p2.index.qvecs is di.qvecs                 # replica not rebuilt
    ids1, _, _, _ = p2.search(q, qlo, qhi)
    assert 10 not in ids1[0]
    masked = attrs.copy()
    masked[10] = np.nan
    oid, _ = _oracle_topk(corpus, masked, q, qlo, qhi, 4)
    np.testing.assert_array_equal(ids1, oid)


def test_quant_param_validation():
    with pytest.raises(ValueError, match="quant"):
        teng.SearchParams(quant="fp4")
    with pytest.raises(ValueError, match="rerank_mult"):
        teng.SearchParams(rerank_mult=0)
    with pytest.raises(ValueError, match="quant"):
        teng._check_strategy_combo(
            teng.SearchParams(backend="pallas_l2", quant="int8"))
    with pytest.raises(ValueError, match="quant"):
        teng.resolve_scorer("pallas_l2", quant="int8")


# -------------------------------------------------------------- service

@pytest.mark.parametrize("quant", QUANTS)
def test_service_quant_matches_reference(tiny_index, workload, quant):
    Q, lo, hi = workload
    kw = dict(k=10, ef=32, c_n=16, expand_width=4, strategy="auto",
              scan_threshold=120, quant=quant)
    js = JService(tiny_index, jeng.SearchParams(
        backend="pallas_gather_l2_filter", **kw),
        config=JServeConfig(buckets=(32,)))
    ts = KHIService(tiny_index, teng.SearchParams(
        backend="pallas_gather_l2_filter", **kw),
        config=ServeConfig(buckets=(32,)), device="cpu")
    assert ts.index.qvecs is not None
    s = 0
    for b in (5, 13, 2):
        wi, wd = js.search(Q[s:s + b], lo[s:s + b], hi[s:s + b])
        gi, gd = ts.search(Q[s:s + b], lo[s:s + b], hi[s:s + b])
        np.testing.assert_array_equal(gi, wi)
        _close(gd, wd)
        s += b
    assert ts.snapshot()["scan_lanes"] > 0
    # a swap to a bare f32 index derives the replica again
    ts.swap_index(teng.device_put_index(tiny_index, device="cpu"))
    assert ts.index.qvecs is not None and ts.epoch == 1
    gi, _ = ts.search(Q[:8], lo[:8], hi[:8])
    wi, _ = js.search(Q[:8], lo[:8], hi[:8])
    np.testing.assert_array_equal(gi, wi)


def test_search_batch_with_predicates(tiny_index, workload):
    Q, lo, hi = workload
    preds = [Predicate(a, b) for a, b in zip(lo, hi)]
    p = _params(teng, backend="pallas_gather_l2_filter", quant="int8",
                strategy="auto")
    gi, gd, gh = teng.search_batch(
        teng.device_put_index(tiny_index, device="cpu"), Q, preds, p)
    wi, wd, wh = jeng.search_batch(
        tiny_index, Q, preds,
        _params(jeng, backend="pallas_gather_l2_filter", quant="int8",
                strategy="auto"))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gh, wh)
    _close(gd, wd)
