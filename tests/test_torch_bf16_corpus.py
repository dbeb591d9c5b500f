"""An index whose corpus is stored in bf16 (``device_put_index(vec_dtype=
torch.bfloat16)``) against the reference's (``vec_dtype=jnp.bfloat16``).

On a corpus and queries of values k/8 in [-1, 1] every bf16 difference
and square, and every f32 sum of them up to d = 768, is exact, so the
port's ids, distances and hops must equal the reference's bit for bit
under every strategy, graph backend, quant tier, ``search_expr`` form,
streaming and the stacked fan-out (the reference runs its ``jnp``
backend, whose ids its own tests pin to its kernels). On float corpora
the reference's jitted ``jnp`` distance keeps XLA's excess precision
through the bf16 chain (``test_xla_excess_precision_gap`` measures it),
so those compare the kernel forms: ids equal outside near-ties, distances
within rtol 1e-5 (reduce order). Each call site's query rounding is
pinned on its own: the gathers, the unfused gather and ``pallas_l2``
round the query to bf16, the scans, the windowed and bitmask scans and
the quantized tiers' scan rerank pass it unrounded."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.predicate import And as JAnd, Or as JOr, Range as JRange
from repro.core.sharded import build_sharded as jbuild_sharded
from repro.serve import KHIService as JService, ServeConfig as JServeConfig

from repro_torch.core import engine as teng
from repro_torch.core.khi import KHIConfig
from repro_torch.core.predicate import And, Or, Range
from repro_torch.core.sharded import sharded_from_stacked
from repro_torch.kernels import ops, ref
from repro_torch.serve import KHIService, ServeConfig

N, D, M, B = 600, 16, 2, 8
KW = dict(k=6, ef=16, c_n=8, scan_threshold=150)
BF = torch.bfloat16


def _grid(rng, shape):
    return (rng.integers(-8, 9, size=shape) / 8).astype(np.float32)


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(25)
    vecs = _grid(rng, (N, D))
    attrs = rng.integers(0, 16, size=(N, M)).astype(np.float32)
    jidx = JIndex.build(vecs, attrs, JConfig(M=8, builder="device"))
    q = _grid(rng, (B, D))
    lo = rng.integers(0, 8, size=(B, M)).astype(np.float32)
    hi = lo + rng.integers(2, 12, size=(B, M)).astype(np.float32)
    hi[0] = lo[0] - 1                         # an empty box
    jdi = jeng.device_put_index(jidx, vec_dtype=jnp.bfloat16)
    tdi = teng.device_put_index(jidx, device="cpu", vec_dtype=BF)
    return dict(vecs=vecs, attrs=attrs, jidx=jidx, jdi=jdi, tdi=tdi, q=q,
                lo=lo, hi=hi)


def _bits(x) -> np.ndarray:
    """The 16 bits of a bf16 array (JAX) or tensor (port)."""
    if torch.is_tensor(x):
        return x.cpu().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _assert_fields(tdi, jdi):
    assert tdi.vecs.dtype == BF and jdi.vecs.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(tdi.vecs), _bits(jdi.vecs))
    for f in dataclasses.fields(teng.DeviceIndex):
        if f.name in ("vecs", "qvecs", "qscale"):
            continue
        got, want = getattr(tdi, f.name), getattr(jdi, f.name)
        got = np.asarray(got) if not torch.is_tensor(got) else got.numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f.name)


@pytest.mark.parametrize("corpus", ["grid", "float"])
@pytest.mark.parametrize("pad", [False, True])
def test_device_put_index_fields(grid, corpus, pad):
    jidx = grid["jidx"]
    if corpus == "float":
        rng = np.random.default_rng(3)
        jidx = dataclasses.replace(
            jidx, vecs=rng.standard_normal(jidx.vecs.shape).astype(
                np.float32) * 3)
    kw = dict(pad_n=N + 40, pad_nodes=jidx.tree.num_nodes + 9,
              pad_height=jidx.height + 1) if pad else {}
    jdi = jeng.device_put_index(jidx, vec_dtype=jnp.bfloat16, **kw)
    tdi = teng.device_put_index(jidx, device="cpu", vec_dtype=BF, **kw)
    _assert_fields(tdi, jdi)
    # f32 stays the default, and other dtypes are refused
    assert teng.device_put_index(jidx, device="cpu").vecs.dtype == \
        torch.float32
    with pytest.raises(ValueError, match="vec_dtype"):
        teng.device_put_index(jidx, device="cpu", vec_dtype=torch.float16)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_quant_replica_over_bf16(grid, quant):
    """The reference's replica of a bf16 corpus: the corpus itself for
    bf16, int8 quantized from its f32 upcast."""
    jdi = jeng.with_quant_replica(grid["jdi"], quant)
    tdi = teng.with_quant_replica(grid["tdi"], quant)
    if quant == "bf16":
        np.testing.assert_array_equal(_bits(tdi.qvecs), _bits(jdi.qvecs))
        assert tdi.qscale is None and jdi.qscale is None
    else:
        np.testing.assert_array_equal(tdi.qvecs.numpy(),
                                      np.asarray(jdi.qvecs))
        np.testing.assert_array_equal(tdi.qscale.numpy(),
                                      np.asarray(jdi.qscale))


def _compare(got, want):
    gi, gd, gh = got[:3]
    wi, wd, wh = want[:3]
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gh, wh)


# what the reference serves over a bf16 corpus (it raises for the unfused
# pallas backends under a quant tier or a scanning strategy)
PLANS = ([("graph", be, "none", "level") for be in teng.BACKENDS]
         + [("graph", "jnp", "none", "dfs"),
            ("graph", "pallas_gather_l2", "none", "dfs")]
         + [("graph", be, qt, "level")
            for be in ("jnp", "pallas_gather_l2_filter")
            for qt in ("bf16", "int8")]
         + [(st, be, qt, "level") for st in ("scan", "auto", "hybrid")
            for be in ("jnp", "pallas_gather_l2_filter")
            for qt in ("none", "bf16", "int8")])


@pytest.mark.parametrize("strategy,backend,quant,router", PLANS)
def test_planner_grid_bit_equal(grid, strategy, backend, quant, router):
    kw = dict(KW, strategy=strategy, quant=quant, router=router,
              expand_width=2)
    jp = jeng.Planner(grid["jdi"], jeng.SearchParams(backend="jnp", **kw))
    tp = teng.Planner(grid["tdi"], teng.SearchParams(backend=backend, **kw))
    args = (grid["q"], grid["lo"], grid["hi"])
    want, got = jp.search(*args), tp.search(*args)
    _compare(got, want)
    assert (got[0] >= 0).any()
    if strategy == "hybrid":
        assert (got[3].mode == 1).any()


@pytest.mark.parametrize("strategy", ["auto", "hybrid"])
@pytest.mark.parametrize("budget", [8, 1])
def test_search_expr_grid_bit_equal(grid, strategy, budget):
    """Box covers through the service, and past ``box_budget`` the
    bitmask scan of the bf16 corpus."""
    kw = dict(KW, strategy=strategy, box_budget=budget)
    js = JService(grid["jdi"], jeng.SearchParams(backend="jnp", **kw),
                  config=JServeConfig(buckets=(8,)))
    ts = KHIService(grid["tdi"],
                    teng.SearchParams(backend="pallas_gather_l2_filter",
                                      **kw),
                    config=ServeConfig(buckets=(8,)), device="cpu")
    jexpr = JOr((JAnd((JRange(0, 2, 6), JRange(1, 0, 9))),
                 JRange(0, 10, 12)))
    texpr = Or((And((Range(0, 2, 6), Range(1, 0, 9))), Range(0, 10, 12)))
    wi, wd = js.search_expr(grid["q"], jexpr)
    ref.reset_calls()
    gi, gd = ts.search_expr(grid["q"], texpr)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    assert (ref.CALLS["scan_topk_mask"]["cpu"] > 0) == (budget == 1)


@pytest.mark.parametrize("strategy,quant", [("scan", "none"),
                                            ("scan", "int8"),
                                            ("graph", "none"),
                                            ("graph", "bf16")])
def test_streaming_grid_bit_equal(grid, strategy, quant):
    """Writes into a bf16-stored index: the delta stays f32, tombstones
    NaN the attrs, and a compaction rebuilds from the upcast corpus into
    an f32 epoch, as the reference's does."""
    kw = dict(KW, strategy=strategy, quant=quant)
    cfg_j, cfg_t = JConfig(M=8, builder="device"), KHIConfig(
        M=8, builder="device")
    js = JService(grid["jdi"], jeng.SearchParams(backend="jnp", **kw),
                  config=JServeConfig(buckets=(8,)))
    ts = KHIService(grid["tdi"],
                    teng.SearchParams(backend="pallas_gather_l2_filter",
                                      **kw),
                    config=ServeConfig(buckets=(8,)), device="cpu")
    js.enable_streaming(capacity=64, build_config=cfg_j)
    ts.enable_streaming(capacity=64, build_config=cfg_t)
    rng = np.random.default_rng(9)
    args = (grid["q"], grid["lo"], grid["hi"])
    for step in range(2):
        nv = _grid(rng, (12, D))
        na = rng.integers(0, 16, size=(12, M)).astype(np.float32)
        np.testing.assert_array_equal(ts.insert(nv, na), js.insert(nv, na))
        pick = rng.integers(0, N + 12 * (step + 1), 9)
        assert ts.delete(pick) == js.delete(pick)
        for got, want in zip(ts.search(*args), js.search(*args)):
            np.testing.assert_array_equal(got, want)
    js.compact()
    ts.compact()
    assert ts.index.vecs.dtype == torch.float32
    assert js.index.vecs.dtype == jnp.float32
    for got, want in zip(ts.search(*args), js.search(*args)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def stacked(grid):
    sk = jbuild_sharded(grid["vecs"], grid["attrs"], 3,
                        JConfig(M=8, builder="device"))
    jsk = dataclasses.replace(sk, di=dataclasses.replace(
        sk.di, vecs=sk.di.vecs.astype(jnp.bfloat16)))
    leaves = {f.name: getattr(jsk.di, f.name)
              for f in dataclasses.fields(jsk.di)}
    tsk = sharded_from_stacked(leaves, np.asarray(jsk.offsets),
                               jsk.pad_waste, device="cpu")
    assert tsk.di.vecs.dtype == BF
    np.testing.assert_array_equal(_bits(tsk.di.vecs), _bits(jsk.di.vecs))
    return jsk, tsk


@pytest.mark.parametrize("strategy,quant", [("graph", "none"),
                                            ("scan", "none"),
                                            ("auto", "int8"),
                                            ("hybrid", "none"),
                                            ("hybrid", "bf16")])
def test_stacked_fanout_grid_bit_equal(grid, stacked, strategy, quant):
    jsk, tsk = stacked
    kw = dict(KW, strategy=strategy, quant=quant, expand_width=2)
    js = JService(jsk, jeng.SearchParams(backend="jnp", **kw),
                  config=JServeConfig(buckets=(8,)))
    ts = KHIService(tsk, teng.SearchParams(
        backend="pallas_gather_l2_filter", **kw),
        config=ServeConfig(buckets=(8,)), device="cpu")
    args = (grid["q"], grid["lo"], grid["hi"])
    for got, want in zip(ts.search(*args), js.search(*args)):
        np.testing.assert_array_equal(got, want)
    jp = jeng.Planner(jsk, jeng.SearchParams(backend="jnp", box_budget=1,
                                             **kw))
    tp = teng.Planner(tsk, teng.SearchParams(
        backend="pallas_gather_l2_filter", box_budget=1, **kw))
    jexpr = JOr((JRange(0, 2, 6), JRange(1, 10, 12)))
    texpr = Or((Range(0, 2, 6), Range(1, 10, 12)))
    _compare(tp.search_expr(grid["q"], texpr),
             jp.search_expr(grid["q"], jexpr))


def test_errors_where_the_reference_raises(grid):
    """Over a bf16 corpus the reference raises only what it raises over
    an f32 one: the unfused pallas backends under a quant tier or a
    scanning strategy. The port raises the same type with the same
    statement of the fault (the text up to the colon; the explanation
    after it names the port's own paths), and refuses a planner refresh
    that changes the corpus dtype."""
    for kw in (dict(quant="bf16", backend="pallas_l2"),
               dict(quant="int8", backend="pallas_gather_l2"),
               dict(strategy="scan", backend="pallas_l2"),
               dict(strategy="hybrid", backend="pallas_gather_l2")):
        with pytest.raises(ValueError) as je:
            JService(grid["jdi"], jeng.SearchParams(**KW, **kw)).search(
                grid["q"], grid["lo"], grid["hi"])
        with pytest.raises(ValueError) as te:
            KHIService(grid["tdi"], teng.SearchParams(**KW, **kw),
                       device="cpu").search(grid["q"], grid["lo"],
                                            grid["hi"])
        assert str(te.value).split(":")[0] == \
            str(je.value).split(":")[0], kw
    tp = teng.Planner(grid["tdi"], teng.SearchParams(**KW, strategy="auto"))
    f32 = teng.device_put_index(grid["jidx"], device="cpu")
    with pytest.raises(ValueError, match="corpus dtype"):
        tp.refresh_index(f32)


# ---------------------------------------------------- query rounding pins

@pytest.fixture(scope="module")
def floaty():
    """A float corpus and queries whose bf16 rounding moves distances."""
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    attrs = rng.integers(0, 16, size=(N, M)).astype(np.float32)
    jidx = JIndex.build(vecs, attrs, JConfig(M=8, builder="device"))
    q = rng.standard_normal((B, D)).astype(np.float32)
    lo = rng.integers(0, 6, size=(B, M)).astype(np.float32)
    hi = lo + rng.integers(4, 12, size=(B, M)).astype(np.float32)
    return jidx, q, lo, hi


def _t(*a):
    return [torch.as_tensor(x) for x in a]


def test_call_site_query_rounding(floaty):
    """Each scorer against its plain formula, with the query rounded to
    bf16 (the gathers, ``pallas_l2``) or not (scans, windows, bitmask),
    bit for bit; and the rounding matters on this corpus."""
    jidx, q, lo, hi = floaty
    di = teng.device_put_index(jidx, device="cpu", vec_dtype=BF)
    tq, tlo, thi = _t(q, lo, hi)
    qr = tq.to(BF).float()
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        -1, N, size=(B, 24)))
    want_r = ref.gather_l2_filter_ref(ids, di.vecs, di.attrs, qr, tlo, thi)
    want_u = ref.gather_l2_filter_ref(ids, di.vecs, di.attrs, tq, tlo, thi)
    assert not torch.equal(want_r, want_u)
    got = teng.resolve_scorer("pallas_gather_l2_filter").score(
        di, tq, tlo, thi, ids)
    assert torch.equal(got, want_r)
    safe = ids.clamp_min(0)
    for be, fn in (("pallas_gather_l2",
                    lambda: ref.gather_l2_ref(safe, di.vecs, qr)),
                   ("pallas_l2",
                    lambda: ref.l2dist_qc_ref(qr, di.vecs[safe]))):
        got = teng.resolve_scorer(be).score(di, tq, tlo, thi, ids)
        w = fn()
        w = torch.where(ids >= 0, w, torch.full_like(w, float("inf")))
        assert torch.equal(got, w), be
    # jnp: subtract and square in bf16, sum in f32
    got = teng.resolve_scorer("jnp").score(di, tq, tlo, thi, ids)
    diff = di.vecs[safe] - tq.to(BF)[:, None, :]
    w = (diff * diff).sum(-1, dtype=torch.float32)
    assert torch.equal(got, torch.where(ids >= 0, w,
                                        torch.full_like(w, float("inf"))))
    # the scan, unrounded
    nan_attrs = di.attrs
    p = teng.SearchParams(**KW)
    gi, gd = teng._scan_shard_topk(di, nan_attrs, tq, tlo, thi, p,
                                   use_kernel=True)
    wi, wd = ref.scan_topk_ref(di.vecs, nan_attrs, tq, tlo, thi, p.k)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    # the windowed and bitmask scans, unrounded, on the bf16 corpus
    starts = torch.tensor([[0, 200]] * B, dtype=torch.int32)
    counts = torch.tensor([[150, 300]] * B, dtype=torch.int32)
    pi, pd = ops.scan_topk_windows(di.vecs, di.attrs, tq, tlo, thi, starts,
                                   counts, k=6)
    f32 = di.vecs.float()
    wi, wd = ref.scan_topk_windows_ref(f32, di.attrs, tq, tlo, thi, starts,
                                       counts, 6)
    assert torch.equal(pi, wi) and torch.equal(pd, wd)
    mask = (di.attrs[:, 0] > 7).float()
    mi, md = ops.scan_topk_mask(di.vecs, mask, tq, k=6)
    wi, wd = ref.scan_topk_mask_ref(f32, mask, tq, 6)
    assert torch.equal(mi, wi) and torch.equal(md, wd)


@pytest.mark.parametrize("strategy", ["scan", "graph", "hybrid"])
def test_float_corpus_kernel_forms(floaty, strategy):
    """Float corpus, the reference's own kernel backend (interpreted):
    ids equal except where two distances lie within rtol 1e-5 of each
    other (a near-tie that reduce order may flip), distances within
    rtol 1e-5."""
    jidx, q, lo, hi = floaty
    kw = dict(KW, strategy=strategy, backend="pallas_gather_l2_filter")
    jdi = jeng.device_put_index(jidx, vec_dtype=jnp.bfloat16)
    tdi = teng.device_put_index(jidx, device="cpu", vec_dtype=BF)
    wi, wd, _, _ = jeng.Planner(jdi, jeng.SearchParams(**kw)).search(
        q, lo, hi)
    gi, gd, _, _ = teng.Planner(tdi, teng.SearchParams(**kw)).search(
        q, lo, hi)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5)
    for b in range(B):
        if np.array_equal(gi[b], wi[b]):
            continue
        d = np.sort(np.concatenate([gd[b], wd[b]]))
        d = d[np.isfinite(d)]
        gaps = np.diff(d) <= 1e-5 * np.maximum(d[1:], 1e-30)
        assert gaps.any(), f"lane {b}: {gi[b]} vs {wi[b]}"


def test_xla_excess_precision_gap():
    """The reference's jitted ``_dist_jnp`` over bf16 rows keeps excess
    precision through the bf16 subtract and square on the CPU (XLA's
    ``xla_allow_excess_precision``), where PyTorch rounds each op: on
    normal data at d = 128 the two differ by up to ~1e-3 relative, while
    the reference run eagerly equals PyTorch to 5e-7. On the k/8 grid
    both are exact and equal."""
    rng = np.random.default_rng(0)
    cand = rng.standard_normal((2048, 128)).astype(np.float32)
    q = rng.standard_normal(128).astype(np.float32)
    jc = jnp.asarray(cand, jnp.bfloat16)
    jit_d = np.asarray(jax.jit(jeng._dist_jnp)(jnp.asarray(q), jc))
    eager_d = np.asarray(jeng._dist_jnp(jnp.asarray(q), jc))
    tc = torch.as_tensor(cand).to(BF)
    td = teng._dist_jnp(torch.as_tensor(q)[None], tc[None])[0].numpy()
    eager_gap = np.max(np.abs(eager_d - td) / td)
    jit_gap = np.max(np.abs(jit_d - td) / td)
    assert eager_gap < 5e-7
    assert 1e-5 < jit_gap < 3e-3
    g = _grid(rng, (256, 128))
    gq = _grid(rng, (128,))
    jg = np.asarray(jax.jit(jeng._dist_jnp)(
        jnp.asarray(gq), jnp.asarray(g, jnp.bfloat16)))
    tg = teng._dist_jnp(torch.as_tensor(gq)[None],
                        torch.as_tensor(g).to(BF)[None])[0].numpy()
    np.testing.assert_array_equal(jg, tg)
