"""The port's collective sharded search (``make_sharded_search_fn`` over
``torch.distributed``) against the JAX package's
``search_sharded_emulated``, which the reference pins bit-identical to
its ``shard_map`` program. Each world, ``(n_data, n_model)`` = (1, 2),
(1, 4) and (2, 2), is one spawn of gloo ranks on the CPU
(``_torch_mesh_worker.py``, which imports no JAX), running every case:

* graph, scan, scan+int8, auto, auto+int8 and hybrid on the float corpus
  (the reference's 640-object p2 set, 6 of 16 boxes widened), each under
  the halving and the all-gather merge: ids equal to the reference's,
  distances within rtol = atol = 1e-5 (the two packages sum in other
  orders), and the two merges bit-equal to each other;
* a batch whose data rows take different dispatch branches (wide boxes
  in the first half, tiny ones in the second) under auto;
* boxes whose shards' routing bounds each stay under the dispatch
  threshold while their sum passes it, under auto and hybrid with a
  short walk (the dispatch must follow the all-reduced bound);
* ``KHIService(mesh=)`` serving the batch under auto;
* graph, scan and hybrid on the 1/32-grid corpus (every squared
  distance exact in f32): distances bit-equal;
* an ``elastic_reshard`` round trip on the grid, answered through the
  collective: bit-equal before and after, and to the reference;
* a rank out of step (another batch size): every rank raises.

Every rank must return the same full answer. A hang must fail, not
stall the suite: the process group times out at 60 s, rendezvous goes
through a ``file://`` under ``tmp_path`` (apart from other test
workers), and the parent waits on its queue and joins its ranks with
time limits, then terminates them."""

import dataclasses
import multiprocessing as mp
import os
import queue as queue_mod
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import sharded as jsh
from repro.core.khi import KHIConfig as JConfig
from repro.data import DatasetSpec, make_dataset, make_queries

sys.path.insert(0, os.path.dirname(__file__))
import _torch_mesh_worker as W  # noqa: E402

WORLDS = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
WORLD_TIMEOUT_S = 150
P2 = DatasetSpec("p2", n=640, d=16, m=2, seed=0)
GRID_N, GRID_D, GRID_M = 320, 16, 2


JAX_MESH = r"""
import os, sys
import numpy as np
import jax
from repro.core import engine as jeng, sharded as jsh
from repro.core.khi import KHIConfig
from repro.data import DatasetSpec, make_dataset
from repro.launch.mesh import make_query_mesh
assert len(jax.devices()) == 4, jax.devices()
inp = np.load(sys.argv[1])
vecs, attrs = make_dataset(DatasetSpec("p2", n=640, d=16, m=2, seed=0))
skhi = jsh.build_sharded(vecs, attrs, 4, KHIConfig(M=16, builder="bulk"))
mesh = make_query_mesh(4, 1)
out = {}
for strategy in ("auto", "hybrid"):
    p = jeng.SearchParams(k=10, ef=48, c_n=16, strategy=strategy)
    fn = jsh.make_sharded_search_fn(p, mesh, skhi=skhi,
                                    on_undersized="adjust")
    ids, d = jax.device_get(fn(skhi, inp["Q"], inp["lo"], inp["hi"]))
    out[strategy + "__ids"], out[strategy + "__dists"] = ids, d
np.savez(sys.argv[2], **out)
"""


def _jparams(p):
    """The JAX package's SearchParams for the port's ``p`` (plain
    backend)."""
    kw = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    kw["backend"] = "jnp"
    return jeng.SearchParams(**kw)


def _leaves(jk, tag, out):
    for f in W.FIELDS:
        out[f"{tag}__{f}"] = np.asarray(getattr(jk.di, f))
    out[f"{tag}__offsets"] = np.asarray(jk.offsets)


def _straddle_boxes(vecs, attrs, data, n: int = 16):
    """``n`` boxes around corpus objects whose routing bound passes
    ``W.STRADDLE_THR`` in sum while every shard's stays under it, at S = 2
    and at S = 4 (the port's ``route_level_card`` on each shard of the
    reference's stacks). Dispatching on a shard's own bound would send
    them to the scan, the group's sum to the walk."""
    import torch

    from repro_torch.core.engine import validate_search_params
    from repro_torch.core.router import route_level_card

    rng = np.random.default_rng(29)
    centre = attrs[rng.choice(len(attrs), 2048)]
    half = rng.uniform(0.02, 0.4, (2048, 1)) * (attrs.max(0) - attrs.min(0))
    lo = (centre - half).astype(np.float32)
    hi = (centre + half).astype(np.float32)
    ok = np.ones(2048, bool)
    for S in (2, 4):
        sk = W._index(data, f"f{S}")
        cards = []
        for s in range(S):
            di = sk.di.shard(s)
            p = validate_search_params(W.weak_params("auto"), di,
                                       on_undersized="adjust")
            cards.append(route_level_card(di, torch.as_tensor(lo),
                                          torch.as_tensor(hi), p).numpy())
        cards = np.stack(cards)
        ok &= (cards.sum(0) > W.STRADDLE_THR) & (cards.max(0)
                                                 <= W.STRADDLE_THR)
    pick = np.nonzero(ok)[0][:n]
    assert len(pick) == n, f"only {ok.sum()} straddling boxes"
    Q = vecs[rng.choice(len(vecs), n)] + np.float32(0.01)
    return dict(straddle_Q=Q.astype(np.float32), straddle_lo=lo[pick],
                straddle_hi=hi[pick])


def _emulated(jk, Q, lo, hi, p):
    if p.quant != "none":
        jk = dataclasses.replace(jk, di=jeng.with_quant_replica(jk.di,
                                                                p.quant))
    ids, d, _ = jsh.search_sharded_emulated(jk, Q, lo, hi, _jparams(p))
    return np.asarray(ids), np.asarray(d)


class World:
    """One world's spawned ranks, started at once and collected with a
    time limit: ``results()`` -> every rank's result dict."""

    def __init__(self, tmp, name, n_data, n_model):
        self.name, self.size = name, n_data * n_model
        self.out_dir = tmp / name
        self.out_dir.mkdir()
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        self.procs = [ctx.Process(target=W.run, args=(
            r, self.size, n_data, n_model, str(tmp / "inputs.npz"),
            str(self.out_dir / "rendezvous"), str(self.out_dir), self.q),
            daemon=True) for r in range(self.size)]
        self.deadline = time.monotonic() + WORLD_TIMEOUT_S
        for p in self.procs:
            p.start()
        self._res = None

    def results(self):
        if self._res is None:
            self._res = self._collect()
        return self._res

    def _collect(self):
        status = {}
        try:
            while len(status) < self.size:
                left = self.deadline - time.monotonic()
                try:
                    rank, ok, tb = self.q.get(timeout=max(0.1, left))
                except queue_mod.Empty:
                    break
                status[rank] = (ok, tb)
                if ok != "ok":
                    break
        finally:
            self.stop()
        errors = [tb for ok, tb in status.values() if ok != "ok"]
        assert not errors, f"world {self.name}: a rank failed:\n{errors[0]}"
        assert len(status) == self.size, (
            f"world {self.name}: {self.size - len(status)} ranks did not "
            f"finish within {WORLD_TIMEOUT_S} s (a collective out of step "
            f"hangs)")
        res = []
        for r in range(self.size):
            with np.load(self.out_dir / f"rank{r}.npz") as f:
                res.append({k: f[k] for k in f.files})
        return res

    def stop(self):
        for p in self.procs:
            p.join(timeout=max(0.1, self.deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(5)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """Writes the inputs (the JAX package's indexes for S = 2 and 4,
    queries and boxes) to one .npz, starts every world's ranks and the
    reference's shard_map subprocess on it, then computes the reference's
    answers per (S, case) while they run."""
    tmp = tmp_path_factory.mktemp("mesh")
    vecs, attrs = make_dataset(P2)
    Q, preds = make_queries(vecs, attrs, n_queries=16, sigma=1 / 4, seed=3)
    lo = np.stack([p.lo for p in preds]).astype(np.float32)
    hi = np.stack([p.hi for p in preds]).astype(np.float32)
    lo[:6], hi[:6] = attrs.min(0) - 1, attrs.max(0) + 1
    mlo, mhi = lo.copy(), hi.copy()
    mlo[:8], mhi[:8] = attrs.min(0) - 1, attrs.max(0) + 1
    mlo[8:], mhi[8:] = attrs[0] - 1e-3, attrs[0] + 1e-3
    rng = np.random.default_rng(23)
    gv = (rng.integers(-64, 64, size=(GRID_N, GRID_D)) / 32).astype(
        np.float32)
    gv[1::7] = gv[0::7][: len(gv[1::7])]                  # exact copies
    ga = rng.integers(0, 16, size=(GRID_N, GRID_M)).astype(np.float32)
    Qg = (rng.integers(-64, 64, size=(12, GRID_D)) / 32).astype(np.float32)
    Qg[:4] = gv[:4]
    glo = rng.integers(0, 8, size=(12, GRID_M)).astype(np.float32)
    ghi = glo + rng.integers(2, 9, size=(12, GRID_M)).astype(np.float32)
    data = dict(Q=Q, lo=lo, hi=hi, mixed_lo=mlo, mixed_hi=mhi, Qg=Qg,
                glo=glo, ghi=ghi, grid_vecs=gv, grid_attrs=ga)
    jks, gks = {}, {}
    for S in (2, 4):
        jks[S] = jsh.build_sharded(vecs, attrs, S,
                                   JConfig(M=16, builder="bulk"))
        _leaves(jks[S], f"f{S}", data)
        gks[S] = jsh.build_sharded(gv, ga, S, JConfig(M=8, builder="device"))
        _leaves(gks[S], f"g{S}", data)
    data.update(_straddle_boxes(vecs, attrs, data))
    np.savez(tmp / "inputs.npz", **data)
    worlds = {name: World(tmp, name, *shape)
              for name, shape in WORLDS.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"),
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_mesh = subprocess.Popen(
        [sys.executable, "-c", JAX_MESH, str(tmp / "inputs.npz"),
         str(tmp / "jax_mesh.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        want = {}
        for S in (2, 4):
            for strategy, quant in W.STRATS:
                want[S, f"{strategy}-{quant}"] = _emulated(
                    jks[S], Q, lo, hi, W.float_params(strategy, quant))
            want[S, "mixed"] = _emulated(jks[S], Q, mlo, mhi,
                                         W.float_params("auto"))
            for strategy in W.GRID_STRATS:
                want[S, f"grid-{strategy}"] = _emulated(
                    gks[S], Qg, glo, ghi, W.grid_params(strategy))
            for strategy in W.STRADDLE_STRATS:
                want[S, f"straddle-{strategy}"] = _emulated(
                    jks[S], data["straddle_Q"], data["straddle_lo"],
                    data["straddle_hi"], W.weak_params(strategy))
        yield tmp, want, worlds, jax_mesh
    finally:
        for w in worlds.values():
            w.stop()
        if jax_mesh.poll() is None:
            jax_mesh.kill()
            jax_mesh.communicate()


@pytest.fixture(scope="module")
def runs(bundle):
    worlds = bundle[2]
    return lambda name: worlds[name].results()


def _check(got, want, exact):
    gi, gd = got
    wi, wd = want
    np.testing.assert_array_equal(gi, wi)
    if exact:
        np.testing.assert_array_equal(gd, wd)
        return
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)


def _per_rank(ranks, case):
    """Every rank's answer to ``case``; they must be equal."""
    got = [(r[f"{case}__ids"], r[f"{case}__dists"]) for r in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(g[0], got[0][0])
        np.testing.assert_array_equal(g[1], got[0][1])
    return got[0]


@pytest.mark.parametrize("case", W.FLOAT_CASES)
@pytest.mark.parametrize("world", list(WORLDS))
def test_collective_equals_emulated(bundle, runs, world, case):
    want = bundle[1]
    S = WORLDS[world][1]
    strat_quant, merge = case.rsplit("-", 1)
    got = _per_rank(runs(world), case)
    _check(got, want[S, strat_quant], exact=False)
    other = "allgather" if merge == "halving" else "halving"
    twin = _per_rank(runs(world), f"{strat_quant}-{other}")
    np.testing.assert_array_equal(got[0], twin[0])
    np.testing.assert_array_equal(got[1], twin[1])


@pytest.mark.parametrize("world", list(WORLDS))
def test_mixed_branches_across_data_rows(bundle, runs, world):
    """Under (2, 2) the two data rows take different dispatch branches
    (all graph, all scan) and still meet in every collective."""
    want = bundle[1]
    _check(_per_rank(runs(world), "mixed"), want[WORLDS[world][1], "mixed"],
           exact=False)


@pytest.mark.parametrize("strategy", ["auto", "hybrid"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_dispatch_on_the_groups_bound(bundle, runs, world, strategy):
    """Boxes whose shards' bounds each stay under the threshold while their
    sum passes it, under a short walk whose answers differ from the
    scan's: equal to the reference only if every rank dispatches on the
    model group's all-reduced bound."""
    want = bundle[1][WORLDS[world][1], f"straddle-{strategy}"]
    _check(_per_rank(runs(world), f"straddle-{strategy}"), want,
           exact=False)


@pytest.mark.parametrize("world", list(WORLDS))
def test_service_mesh_serving(bundle, runs, world):
    want = bundle[1]
    ranks = runs(world)
    _check(_per_rank(ranks, "service"),
           want[WORLDS[world][1], "auto-none"], exact=False)
    assert all(int(r["service__batches"]) == 1 for r in ranks)


@pytest.mark.parametrize("case", W.GRID_CASES)
@pytest.mark.parametrize("world", list(WORLDS))
def test_grid_corpus_bit_equal(bundle, runs, world, case):
    want = bundle[1]
    _check(_per_rank(runs(world), case), want[WORLDS[world][1], case],
           exact=True)


@pytest.mark.parametrize("world", list(WORLDS))
def test_elastic_reshard_round_trip(bundle, runs, world):
    """Shards built by the port's device builder, shard 1 rebuilt by
    ``elastic_reshard``: the collective's answers are bit-equal before and
    after, and to the reference's on its own build of the same grid."""
    want = bundle[1]
    ranks = runs(world)
    after = _per_rank(ranks, "elastic")
    before = _per_rank(ranks, "elastic-before")
    _check(after, before, exact=True)
    _check(after, want[WORLDS[world][1], "grid-graph"], exact=True)




@pytest.mark.parametrize("world", list(WORLDS))
def test_rank_out_of_step_raises_on_every_rank(runs, world):
    assert all(bool(r["desync__raised"]) for r in runs(world))


def test_against_the_reference_shard_map_program(bundle, runs):
    """The reference's own collective (``make_sharded_search_fn`` under
    ``shard_map`` on 4 emulated CPU devices, backend jnp), run in a
    subprocess on the same inputs, against the port's (1, 4) gloo world:
    auto and hybrid."""
    tmp, _, _, proc = bundle
    try:
        _, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    ranks = runs("1x4")
    with np.load(tmp / "jax_mesh.npz") as f:
        for strategy in ("auto", "hybrid"):
            got = _per_rank(ranks, f"{strategy}-none-halving")
            _check(got, (f[f"{strategy}__ids"], f[f"{strategy}__dists"]),
                   exact=False)
