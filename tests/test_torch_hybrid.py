"""The port's per-node hybrid dispatch (``strategy="hybrid"``) against the
JAX package's: the windowed scan's plain version against the Pallas
kernel (interpret mode) and the reference oracle, the bitmask scan's
plain version likewise, the planner's modes, windows, ids and hops,
``_merge_dedup``, the service, and the validation rules. Inputs come
from numpy seeds; every expected value is computed live by the JAX
package.

Tolerances: the corpora are on a 1/32 grid, so every squared distance is
exact in f32 whatever the reduce order and distances are compared bit
for bit. Ids, positions, hops, modes and windows are always equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jeng
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.kernels.ref import scan_topk_mask_ref as j_mask_ref
from repro.kernels.ref import scan_topk_windows_ref as j_windows_ref
from repro.kernels.scan_topk import scan_topk_mask_raw, scan_topk_windows_raw
from repro.serve import KHIService as JService, ServeConfig as JServeConfig

from repro_torch.core import engine as teng
from repro_torch.kernels import ops, ref
from repro_torch.serve import KHIService, ServeConfig

BACKENDS = ("jnp", "pallas_gather_l2_filter")


def _grid(rng, shape):
    return (rng.integers(-64, 64, size=shape) / 32).astype(np.float32)


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _equal(got, want):
    """Ids/positions equal; distances bit-equal (grid inputs)."""
    gi, gd = (np.asarray(x) for x in got)
    wi, wd = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)


# ------------------------------------------------------ windowed scan

def _windows_case(B, N, D, M, W, w_cap, seed):
    """The shapes of the reference's windowed-kernel tests, plus an empty
    lane and a lane whose last window ends at N."""
    rng = np.random.default_rng(seed)
    corpus = _grid(rng, (N, D))
    corpus[5] = corpus[9]                       # a tie: equal distances
    attrs = rng.uniform(0, 10, (N, M)).astype(np.float32)
    attrs[::17, 0] = np.nan                      # NaN fails every box
    q = _grid(rng, (B, D))
    qlo = rng.uniform(0, 6, (B, M)).astype(np.float32)
    qhi = qlo + rng.uniform(0, 5, (B, M)).astype(np.float32)
    qlo[1], qhi[1] = -np.inf, np.inf             # every window row passes
    qlo[-1], qhi[-1] = -np.inf, np.inf
    starts = np.full((B, W), -1, np.int32)
    counts = np.zeros((B, W), np.int32)
    for b in range(B):
        nw = rng.integers(1, W + 1)
        pos = np.sort(rng.choice(N // w_cap, size=nw, replace=False))
        starts[b, :nw] = pos * w_cap
        counts[b, :nw] = rng.integers(1, w_cap + 1, size=nw)
    starts[0], counts[0] = -1, 0                 # lane 0: no windows
    starts[-1, :2] = [N - 2 * w_cap, N - w_cap]  # ends exactly at N
    counts[-1, :2] = [w_cap, w_cap]
    starts[-1, 2:], counts[-1, 2:] = -1, 0
    return corpus, attrs, q, qlo, qhi, starts, counts


@pytest.mark.parametrize("B,N,D,M,k,W,w_cap", [(3, 128, 8, 2, 4, 4, 16),
                                               (4, 300, 16, 3, 8, 8, 32)])
def test_scan_topk_windows_plain_matches_pallas(B, N, D, M, k, W, w_cap):
    case = _windows_case(B, N, D, M, W, w_cap, seed=B + N)
    a = [jnp.asarray(x) for x in case]
    want = scan_topk_windows_raw(*a, k=k, w_cap=w_cap, interpret=True)
    _equal(want, j_windows_ref(*a, k))
    ref.reset_calls()
    got = ops.scan_topk_windows(*_t(*case), k=k)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    _equal(got, want)
    # small chunks: several row groups and single-lane groups
    _equal(ref.scan_topk_windows_ref(*_t(*case), k, budget=D * 7), want)
    assert ref.CALLS["scan_topk_windows"]["cpu"] == 2
    assert ops.LAUNCHES["scan_topk_windows"] == 0   # no card, no launch
    gi = got[0].numpy()
    assert (gi[0] == -1).all() and np.isinf(got[1].numpy()[0]).all()
    assert (gi[-1] >= case[0].shape[0] - 2 * w_cap).all()   # k rows pass


def test_scan_topk_windows_order_and_overlap_free():
    """Rows outside every window never appear; the answer does not depend
    on the order the windows arrive in (the plain version takes their
    union); k larger than the covered rows pads with (-1, +inf)."""
    corpus, attrs, q, qlo, qhi, starts, counts = _windows_case(
        3, 128, 8, 2, 4, 16, seed=3)
    qlo[:], qhi[:] = -np.inf, np.inf
    starts[:] = -1
    counts[:] = 0
    starts[2, :2], counts[2, :2] = [40, 8], [4, 6]     # descending starts
    got = ops.scan_topk_windows(*_t(corpus, attrs, q, qlo, qhi, starts,
                                    counts), k=12)
    want = j_windows_ref(*[jnp.asarray(x) for x in (
        corpus, attrs, q, qlo, qhi, starts, counts)], 12)
    _equal(got, want)
    pos = got[0].numpy()[2]
    assert sorted(pos[pos >= 0]) == list(range(8, 14)) + list(range(40, 44))
    assert (pos[10:] == -1).all()


def test_scan_topk_windows_wrapper_checks():
    case = _t(*_windows_case(2, 64, 8, 2, 2, 8, seed=4))
    with pytest.raises(ValueError, match="k must be"):
        ops.scan_topk_windows(*case, k=0)
    with pytest.raises(TypeError, match="starts"):
        ops.scan_topk_windows(*case[:5], case[5].long(), case[6], k=4)
    with pytest.raises(ValueError, match="mismatch"):
        ops.scan_topk_windows(*case[:5], case[5][:1], case[6][:1], k=4)


# -------------------------------------------------------- bitmask scan

@pytest.mark.parametrize("N,D,B,k,flat", [(300, 16, 3, 8, False),
                                          (1031, 24, 5, 10, True)])
def test_scan_topk_mask_plain_matches_pallas(N, D, B, k, flat):
    rng = np.random.default_rng(N)
    corpus = _grid(rng, (N, D))
    corpus[3] = corpus[11]                       # a tie
    q = _grid(rng, (B, D))
    mask = rng.uniform(-1, 1, (N, 1)).astype(np.float32)
    mask[::13] = np.nan                          # NaN fails
    mask[::7] = 0.0                              # 0 fails
    mask[3] = mask[11] = 1.0
    if flat:
        mask = mask.reshape(N)
    want = scan_topk_mask_raw(*[jnp.asarray(x) for x in (corpus, mask, q)],
                              k=k, interpret=True)
    _equal(want, j_mask_ref(*[jnp.asarray(x) for x in (corpus, mask, q)],
                            k))
    got = ops.scan_topk_mask(*_t(corpus, mask, q), k=k)
    _equal(got, want)
    _equal(ref.scan_topk_mask_ref(*_t(corpus, mask, q), k, budget=D * 5),
           want)
    # a mask no row passes: (-1, +inf) everywhere
    none = np.zeros_like(mask)
    ids, dd = ops.scan_topk_mask(*_t(corpus, none, q), k=k)
    assert (ids == -1).all() and torch.isinf(dd).all()
    with pytest.raises(ValueError, match="mask"):
        ops.scan_topk_mask(*_t(corpus, mask[:5], q), k=k)
    with pytest.raises(ValueError, match="k must be"):
        ops.scan_topk_mask(*_t(corpus, mask, q), k=N + 1)


# ---------------------------------------------------------- the planner

N_H, D_H, M_H = 1500, 16, 2


@pytest.fixture(scope="module")
def hybrid_case():
    """A grid corpus and boxes of three widths (narrow: pure-window,
    medium and wide: mixed), one whole-corpus box (the root: a large node
    and nothing small, a graph lane) and one empty box (card 0, graph)."""
    rng = np.random.default_rng(0xB1)
    vecs = _grid(rng, (N_H, D_H))
    attrs = rng.uniform(0, 1, (N_H, M_H)).astype(np.float32)
    index = JIndex.build(vecs, attrs, JConfig(M=8, builder="device"))
    B = 24
    q = _grid(rng, (B, D_H))
    c = rng.uniform(0.1, 0.9, (B, M_H)).astype(np.float32)
    half = np.array([0.05, 0.3, 0.7], np.float32)[np.arange(B) % 3]
    lo = (c - half[:, None]).astype(np.float32)
    hi = (c + half[:, None]).astype(np.float32)
    lo[-2], hi[-2] = -np.inf, np.inf
    lo[-1], hi[-1] = 1.0, 0.0
    return index, q, lo, hi


def _hybrid_params(mod, backend, E, quant):
    return mod.SearchParams(k=10, ef=32, c_n=16, expand_width=E,
                            backend=backend, strategy="hybrid",
                            node_scan_threshold=64, quant=quant)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("E,quant", [(1, "none"), (4, "none"), (1, "int8"),
                                     (4, "int8")])
def test_hybrid_planner_matches_reference(hybrid_case, backend, E, quant):
    index, q, lo, hi = hybrid_case
    jp = jeng.Planner(index, _hybrid_params(jeng, backend, E, quant))
    tp = teng.Planner(teng.device_put_index(index, device="cpu"),
                      _hybrid_params(teng, backend, E, quant))
    wi, wd, wh, wplan = jp.search(q, lo, hi)
    gi, gd, gh, gplan = tp.search(q, lo, hi)
    # every mode is present (pinned like the reference's own tests)
    assert set(np.unique(wplan.mode)) == {0, 1, 2}
    assert wplan.mode[-2] == 0 and wplan.card[-2] == N_H
    assert wplan.mode[-1] == 0 and wplan.card[-1] == 0
    np.testing.assert_array_equal(gplan.mode, wplan.mode)
    np.testing.assert_array_equal(gplan.n_windows, wplan.n_windows)
    np.testing.assert_array_equal(gplan.card, wplan.card)
    np.testing.assert_array_equal(gplan.use_scan, wplan.use_scan)
    assert gplan.node_threshold == wplan.node_threshold == 64
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gh, wh)
    np.testing.assert_array_equal(gd, wd)
    assert (gh[gplan.mode == 1] == 0).all()
    for mode in (1, 2):
        idx = np.nonzero(wplan.mode == mode)[0]
        bp = 1 << max(0, int(len(idx)) - 1).bit_length()
        ws, wc, wcap = jp._build_windows(wplan.small_nodes, idx, bp)
        gs, gc, gcap = tp._build_windows(gplan.small_nodes, idx, bp)
        assert gs.dtype == gc.dtype == torch.int32
        np.testing.assert_array_equal(gs.numpy(), ws)
        np.testing.assert_array_equal(gc.numpy(), wc)
        assert gcap == wcap


def test_hybrid_windows_unsorted_lane_subset(hybrid_case):
    """``_build_windows`` for any lane subset, in any order, with padding
    rows past it: the reference's arrays."""
    index, q, lo, hi = hybrid_case
    p = dict(backend="jnp", E=1, quant="none")
    jp = jeng.Planner(index, _hybrid_params(jeng, **p))
    tp = teng.Planner(teng.device_put_index(index, device="cpu"),
                      _hybrid_params(teng, **p))
    wplan, gplan = jp.plan(lo, hi), tp.plan(lo, hi)
    idx = np.array([7, 2, 19, 0, 4])
    ws, wc, wcap = jp._build_windows(wplan.small_nodes, idx, 8)
    gs, gc, gcap = tp._build_windows(gplan.small_nodes, idx, 8)
    np.testing.assert_array_equal(gs.numpy(), ws)
    np.testing.assert_array_equal(gc.numpy(), wc)
    assert gcap == wcap and (ws[0, 5:] == -1).all()


def test_hybrid_pure_window_lanes_exact(hybrid_case):
    """Mode-1 lanes equal the masked brute force (the f32 scan oracle)."""
    index, q, lo, hi = hybrid_case
    tp = teng.Planner(teng.device_put_index(index, device="cpu"),
                      _hybrid_params(teng, "pallas_gather_l2_filter", 4,
                                     "int8"))
    ids, dists, hops, plan = tp.search(q, lo, hi)
    w = plan.mode == 1
    oi, od = ref.scan_topk_ref(*_t(index.vecs, index.attrs, q, lo, hi), 10)
    np.testing.assert_array_equal(ids[w], oi.numpy()[w])
    np.testing.assert_array_equal(dists[w], od.numpy()[w])


# ------------------------------------------------------------ merge

@pytest.mark.parametrize("out_dtype", [np.int32, np.int64])
def test_merge_dedup_bit_equal_to_reference(out_dtype):
    rng = np.random.default_rng(7)
    for trial in range(20):
        B, ka, kb, k = 6, int(rng.integers(1, 12)), int(rng.integers(1, 12)), \
            int(rng.integers(1, 16))
        ia = rng.integers(-1, 20, (B, ka))
        ib = rng.integers(-1, 20, (B, kb))
        if out_dtype == np.int64:
            ia = np.where(ia >= 0, ia + (1 << 40), ia)
            ib = np.where(ib >= 0, ib + (1 << 40), ib)
        ia, ib = ia.astype(out_dtype), ib.astype(out_dtype)
        # distances on a coarse grid: many ties, some ids found twice
        da = (rng.integers(0, 6, (B, ka)) / 4).astype(np.float32)
        db = (rng.integers(0, 6, (B, kb)) / 4).astype(np.float32)
        da[ia < 0] = np.inf
        db[ib < 0] = np.inf
        got = teng._merge_dedup(ia, da, ib, db, k, out_dtype=out_dtype)
        want = jeng._merge_dedup(ia, da, ib, db, k, out_dtype=out_dtype)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------- service and rules

def test_service_hybrid_matches_reference(hybrid_case):
    index, q, lo, hi = hybrid_case
    p = dict(backend="pallas_gather_l2_filter", E=4, quant="none")
    js = JService(index, _hybrid_params(jeng, **p),
                  config=JServeConfig(buckets=(8, 32)))
    ts = KHIService(index, _hybrid_params(teng, **p),
                    config=ServeConfig(buckets=(8, 32)), device="cpu")
    wi, wd = js.search(q, lo, hi)
    gi, gd = ts.search(q, lo, hi)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    ws, gs = js.snapshot(), ts.snapshot()
    for key in ("scan_lanes", "pad_lanes", "batches", "device_queries"):
        assert gs[key] == ws[key], key
    assert gs["scan_lanes"] > 0


def test_hybrid_validation_rejections():
    for mod in (jeng, teng):
        with pytest.raises(ValueError, match="router"):
            mod._check_strategy_combo(
                mod.SearchParams(strategy="hybrid", router="dfs"))
        with pytest.raises(ValueError, match="strategy"):
            mod._check_strategy_combo(
                mod.SearchParams(strategy="hybrid", backend="pallas_l2"))
        with pytest.raises(ValueError, match="node_scan_threshold"):
            mod.SearchParams(strategy="hybrid", node_scan_threshold=-1)
