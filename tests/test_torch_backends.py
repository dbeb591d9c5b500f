"""The port's unfused scoring backends and DFS router against the JAX
package, the counterpart of ``tests/test_engine_backends.py``.

For ``backend`` in {jnp, pallas_l2, pallas_gather_l2} x ``router`` in
{level, dfs} x E in {1, 4}, the graph strategy must give the reference's
ids and hops on the same backend and router (the JAX package's Pallas
kernels in interpret mode; the port's plain versions, since the tensors
lie on the CPU). Distances: within rtol = atol = 1e-4 on the float
fixture (reduce orders and the l2dist expansion differ) and bit-equal on
a 1/32-grid corpus, where every partial sum is exact. Also: the legacy
``dist_fn(q, rows)`` override wins over the backend, and every
combination the reference rejects raises ``ValueError`` in both
packages."""

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.serve import KHIService as JService, ServeConfig as JServeConfig

from repro_torch.core import engine as teng
from repro_torch.core.query_ref import Predicate
from repro_torch.serve import KHIService, ServeConfig

UNFUSED = ("jnp", "pallas_l2", "pallas_gather_l2")


def _kw(**kw):
    base = dict(k=10, ef=32, c_n=16, strategy="graph")
    base.update(kw)
    return base


def _compare(got, want, exact):
    gi, gd, gh = got
    wi, wd, wh = want
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gh, wh)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    if exact:
        np.testing.assert_array_equal(gd[fin], wd[fin])
    else:
        np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tdi(tiny_index):
    return teng.device_put_index(tiny_index, device="cpu")


@pytest.mark.parametrize("E", [1, 4])
@pytest.mark.parametrize("router", ["level", "dfs"])
@pytest.mark.parametrize("backend", UNFUSED)
def test_backend_router_matches_reference(tiny_index, tdi, tiny_queries,
                                          backend, router, E):
    Q, preds = tiny_queries
    kw = _kw(backend=backend, router=router, expand_width=E)
    want = jeng.search_batch(tiny_index, Q, preds, jeng.SearchParams(**kw))
    got = teng.search_batch(tdi, Q, [Predicate(p.lo, p.hi) for p in preds],
                            teng.SearchParams(**kw))
    _compare(got, want, exact=False)
    assert (got[0] >= 0).any() and (got[2] > 0).any()


@pytest.fixture(scope="module")
def grid_case():
    rng = np.random.default_rng(0x6A1D)
    n, d, m = 800, 16, 3
    vecs = (rng.integers(-64, 64, size=(n, d)) / 32).astype(np.float32)
    attrs = rng.integers(0, 16, size=(n, m)).astype(np.float32)
    index = JIndex.build(vecs, attrs, JConfig(M=8, builder="device"))
    q = (rng.integers(-64, 64, size=(16, d)) / 32).astype(np.float32)
    lo = rng.integers(0, 8, size=(16, m)).astype(np.float32)
    hi = lo + rng.integers(2, 12, size=(16, m)).astype(np.float32)
    return index, q, lo, hi


@pytest.mark.parametrize("E", [1, 4])
@pytest.mark.parametrize("router", ["level", "dfs"])
@pytest.mark.parametrize("backend", UNFUSED)
def test_grid_corpus_bit_equal(grid_case, backend, router, E):
    index, q, lo, hi = grid_case
    kw = _kw(backend=backend, router=router, expand_width=E)
    jp = jeng.Planner(index, jeng.SearchParams(**kw))
    tp = teng.Planner(index, teng.SearchParams(**kw), device="cpu")
    wi, wd, wh, _ = jp.search(q, lo, hi)
    gi, gd, gh, _ = tp.search(q, lo, hi)
    _compare((gi, gd, gh), (wi, wd, wh), exact=True)
    assert (gi >= 0).any()


def test_legacy_dist_fn_override_wins(tiny_index, tdi, tiny_queries):
    """``dist_fn(q, rows)`` routes around the backend field in
    ``search_batch``, ``make_search_fn``, ``Planner`` and ``KHIService``,
    as in the reference; ``_dist_jnp`` takes the reference's per-query
    shapes and the port's batched ones alike."""
    Q, preds = tiny_queries
    Q, preds = Q[:6], preds[:6]
    tpreds = [Predicate(p.lo, p.hi) for p in preds]
    p_j = jeng.SearchParams(**_kw(k=5, backend="pallas_gather_l2"))
    p_t = teng.SearchParams(**_kw(k=5, backend="pallas_gather_l2"))
    want = jeng.search_batch(tiny_index, Q, preds, p_j,
                             dist_fn=jeng._dist_jnp)
    got = teng.search_batch(tdi, Q, tpreds, p_t, dist_fn=teng._dist_jnp)
    _compare(got, want, exact=False)
    plain = teng.search_batch(tdi, Q, tpreds,
                              teng.SearchParams(**_kw(k=5, backend="jnp")))
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[1], plain[1])

    # an override that scores every row 0 shows it really wins
    def zero(q, rows):
        return rows[..., 0] * 0.0

    lo = np.stack([p.lo for p in preds]).astype(np.float32)
    hi = np.stack([p.hi for p in preds]).astype(np.float32)
    jz = jeng.search_batch(tiny_index, Q, preds, p_j, dist_fn=zero)
    tz = teng.search_batch(tdi, Q, tpreds, p_t, dist_fn=zero)
    _compare(tz, jz, exact=True)
    assert (tz[1][tz[0] >= 0] == 0).all()
    import torch
    fn = teng.make_search_fn(p_t, dist_fn=zero, di=tdi,
                             on_undersized="adjust")
    ids, dd, _ = fn(tdi, torch.as_tensor(Q), torch.as_tensor(lo),
                    torch.as_tensor(hi))
    np.testing.assert_array_equal(ids.numpy(), tz[0])
    js = JService(tiny_index, p_j, config=JServeConfig(buckets=(8,)),
                  dist_fn=zero)
    ts = KHIService(tiny_index, p_t, config=ServeConfig(buckets=(8,)),
                    device="cpu", dist_fn=zero)
    np.testing.assert_array_equal(ts.search(Q, lo, hi)[0],
                                  js.search(Q, lo, hi)[0])


def test_every_backend_resolves():
    for backend in teng.BACKENDS:
        s = teng.resolve_scorer(backend)
        assert s.name == backend
        assert s.fused_filter == (backend == "pallas_gather_l2_filter")
    for backend in UNFUSED:
        assert callable(teng.resolve_dist_ids(backend))
    with pytest.raises(ValueError, match="unknown distance backend"):
        teng.resolve_dist_ids("mosaic_tf32")
    with pytest.raises(ValueError, match="no dist-only form"):
        teng.resolve_dist_ids("pallas_gather_l2_filter")
    with pytest.raises(ValueError, match="unknown scoring backend"):
        teng.resolve_scorer("mosaic_tf32")
    with pytest.raises(ValueError, match="quantized replica"):
        teng.resolve_scorer("jnp", dist_fn=teng._dist_jnp, quant="int8")
    with pytest.raises(ValueError, match="requires a backend"):
        teng.resolve_scorer("pallas_l2", quant="bf16")


REJECTED = (
    [dict(strategy=s, backend=b) for s in ("scan", "auto", "hybrid")
     for b in ("pallas_l2", "pallas_gather_l2")]
    + [dict(strategy=s, router="dfs") for s in ("auto", "hybrid")]
    + [dict(quant=qt, backend=b) for qt in ("int8", "bf16")
       for b in ("pallas_l2", "pallas_gather_l2")]
)


@pytest.mark.parametrize("combo", REJECTED,
                         ids=["-".join(map(str, c.values()))
                              for c in REJECTED])
def test_rejected_combinations_raise(tiny_index, tdi, combo):
    """Whatever the reference rejects, the port rejects with a
    ValueError naming the same offending fields."""
    kw = _kw(scan_threshold=120)
    kw.update(combo)
    word = {"strategy": "incompatible with backend", "router":
            "requires router='level'", "quant": "incompatible with backend"}
    match = (word["router"] if "router" in combo else
             word["quant"] if "quant" in combo else word["strategy"])
    with pytest.raises(ValueError, match=match):
        jeng.Planner(tiny_index, jeng.SearchParams(**kw))
    with pytest.raises(ValueError, match=match):
        teng.Planner(tdi, teng.SearchParams(**kw))
    with pytest.raises(ValueError, match=match):
        KHIService(tdi, teng.SearchParams(**kw))
