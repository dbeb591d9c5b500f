"""``repro_torch.launch.op_cost`` and ``launch.roofline`` against the JAX
package's ``hlo_cost`` and ``roofline``: the counterparts of
``tests/test_roofline.py``'s seven tests (loops counted in full, a
matmul's bytes, the ring formulas, the model FLOPs and the dominant
term), each arch's step counted the same over fake tensors as over real
CPU tensors, the tracker's peak against a hand-computed live set, and the
port's prefill FLOPs against ``hlo_cost`` of the reference's compiled
prefill (the training step's for qwen1.5-4b)."""

import importlib.util
import os

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import roofline as jroof
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import roofline as troof
from repro_torch.launch.op_cost import CountingMode, count
from repro_torch.launch.specs import SMOKE_CELLS, build_cell, cell_supported

HERE = os.path.dirname(os.path.abspath(__file__))


def test_loop_of_matmuls_counts_every_iteration():
    x = torch.ones((128, 128))
    w = torch.ones((10, 128, 128))

    def ten(x, w):
        for i in range(10):
            x = torch.tanh(x @ w[i])
        return x

    _, c = count(ten, x, w)
    assert c.flops == 10 * 2 * 128 ** 3

    def nested(x, w):
        for i in range(4):
            for j in range(3):
                x = x @ w[i, j]
        return x

    _, c = count(nested, torch.ones((64, 64)), torch.ones((4, 3, 64, 64)))
    assert c.flops == 12 * 2 * 64 ** 3


@pytest.mark.parametrize("M,K,N,dt", [(512, 512, 512, torch.float32),
                                      (96, 40, 200, torch.bfloat16)])
def test_matmul_bytes(M, K, N, dt):
    a, b = torch.ones((M, K), dtype=dt), torch.ones((K, N), dtype=dt)
    _, c = count(torch.matmul, a, b)
    assert c.bytes_accessed == (M * K + K * N + M * N) * a.element_size()
    assert c.flops == 2 * M * K * N
    assert c.peak_bytes == c.end_bytes == M * N * a.element_size()


_HLO = ("ENTRY %main (p0: f32[1024]) -> f32[1024] {{\n"
        "  %p0 = f32[1024]{{0}} parameter(0)\n"
        "  ROOT %c = f32[1024]{{0}} {kind}(%p0), replica_groups=[4,8]<=[32]"
        "{extra}\n}}\n")


@pytest.mark.parametrize("kind", troof.KINDS)
def test_collective_bytes_equal_reference(kind):
    extra = {"all-reduce": ", to_apply=%add",
             "all-gather": ", dimensions={0}",
             "reduce-scatter": ", dimensions={0}, to_apply=%add",
             "all-to-all": ", dimensions={0}",
             "collective-permute": ", source_target_pairs={{0,1}}"}[kind]
    want = jroof.collective_bytes(_HLO.format(kind=kind, extra=extra))
    got = troof.collective_bytes([(kind, 1024 * 4, 8, False)])
    assert got[kind] == pytest.approx(want[kind], rel=1e-12)
    assert got[f"{kind}_count"] == want[f"{kind}_count"] == 1
    assert got["total"] == pytest.approx(want["total"], rel=1e-12)
    assert got["network"] == 0.0
    spans = troof.collective_bytes([(kind, 4096, 8, True)] * 3)
    assert spans["network"] == spans["total"] == pytest.approx(
        3 * want["total"], rel=1e-12)


@pytest.mark.parametrize("kind,n_active", [("train", 0), ("prefill", 0),
                                           ("decode", int(2e8)),
                                           ("serve", 0)])
def test_model_flops_equal_reference(kind, n_active):
    args = dict(n_params=int(1e9), n_active=n_active, batch=128, seq=32768)
    assert troof.model_flops(kind, **args) == jroof.model_flops(kind, **args)


@pytest.mark.parametrize("flops,nbytes,coll", [
    (197e12, 1e9, 1e9), (1e9, 819e9, 1e9), (1e9, 1e9, 50e9)])
def test_roofline_dominant_term_equal_reference(flops, nbytes, coll):
    # each term dominates by a wide margin under both sets of constants
    kw = dict(flops=flops, bytes_accessed=nbytes, coll_bytes=coll,
              n_chips=1, model_flops_global=100e12)
    want, got = jroof.terms_from(**kw), troof.terms_from(**kw)
    assert got.dominant == want.dominant
    assert got.compute_s == pytest.approx(flops / 989.4e12)
    assert got.memory_s == pytest.approx(nbytes / 3.35e12)
    assert got.collective_s == pytest.approx(coll / 450e9)
    assert got.useful_fraction == pytest.approx(100e12 / flops)
    net = troof.terms_from(**kw, coll_network_bytes=coll)
    assert net.collective_s == pytest.approx(coll / 50e9)


def test_tracker_peak_equals_hand_computed_live_set():
    x = torch.ones(1000)                       # an input: not counted

    def prog(x):
        t1 = x * 2                             # 4 kB live
        t2 = t1 + 1                            # 8 kB
        del t1                                 # 4 kB
        v = t2.view(10, 100)                   # a view: no storage
        t3 = v * v                             # 8 kB
        t4 = torch.cat([t2, t3.flatten()])     # 16 kB: the peak
        t4.add_(1)                             # in place: no storage
        return t4[:500]                        # a view of t4's 8 kB

    out, c = count(prog, x)
    assert c.peak_bytes == 16000
    assert c.end_bytes == 8000
    # reads and writes, views not counted, the in-place add once
    assert c.bytes_accessed == (4000 + 4000) + (4000 + 4000) \
        + (4000 + 4000) + (4000 + 4000 + 8000) + 8000
    assert out.shape == (500,)


def _cases():
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        for cell in ("train_4k", "prefill_32k", "decode_32k"):
            if cell_supported(cfg, cell)[0]:
                yield arch, cell


def _real_inputs(cb, seed: int):
    """The fake inputs' real twins on the CPU, random from a seed."""
    g = torch.Generator().manual_seed(seed)

    def real(t):
        if t.dtype.is_floating_point:
            return (0.02 * torch.randn(t.shape, generator=g)).to(t.dtype)
        if t.dtype == torch.bool:
            return torch.rand(t.shape, generator=g) > 0.5
        return torch.randint(0, 7, t.shape, generator=g).to(t.dtype)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        return real(x) if isinstance(x, torch.Tensor) else x

    return walk(cb.inputs)


@pytest.mark.parametrize("arch,cell", list(_cases()))
def test_fake_count_equals_real_count(arch, cell):
    cells = {k: dict(v, batch=4 if v["batch"] > 1 else 1)
             for k, v in SMOKE_CELLS.items()}
    cb = build_cell(arch, cell, {"data": 1, "model": 1}, device="cpu",
                    n_micro=2 if cell == "train_4k" else None,
                    config=get_smoke_config(arch), cells=cells)
    with cb.mode():
        _, fake = count(cb.step, *cb.inputs)
    inputs = _real_inputs(cb, seed=3)
    _, real = count(cb.step, *inputs)
    assert (real.flops, real.bytes_accessed) == (fake.flops,
                                                 fake.bytes_accessed)
    assert (real.peak_bytes, real.end_bytes) == (fake.peak_bytes,
                                                 fake.end_bytes)
    assert real.flops > 0 and real.peak_bytes > 0


def _parity():
    spec = importlib.util.spec_from_file_location(
        "dryrun_parity", os.path.join(HERE, "..", "scripts",
                                      "dryrun_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# every arch without MoE; none computes a layer another way than the
# reference at the smoke configs (every ratio is 1.000000 there)
DENSE = [a for a in ARCH_IDS if get_smoke_config(a).moe is None]


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_flops_match_hlo_cost(arch):
    p = _parity()
    ref, port = p.reference_flops(arch, "prefill"), p.port_flops(arch,
                                                                 "prefill")
    assert ref > 0 and abs(port / ref - 1) <= 0.02, (port, ref)


def test_train_flops_match_hlo_cost():
    p = _parity()
    ref = p.reference_flops("qwen1.5-4b", "train", rows=4)
    port = p.port_flops("qwen1.5-4b", "train", rows=4)
    assert ref > 0 and abs(port / ref - 1) <= 0.10, (port, ref)


def test_fake_mode_tensors_stay_fake():
    """The count makes no real tensor: every tensor the step builds in
    the cell's fake mode is fake (nothing allocated at a cell's shapes)."""
    seen = []

    class Spy(CountingMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    seen.append(type(t).__name__)
            return out

    cb = build_cell("qwen1.5-4b", "train_4k", {"data": 16, "model": 16},
                    device="cpu", config=get_smoke_config("qwen1.5-4b"),
                    cells=SMOKE_CELLS)
    with cb.mode(), Spy():
        cb.step(*cb.inputs)
    assert seen and set(seen) == {"FakeTensor"}
    assert isinstance(cb.fake_mode, FakeTensorMode)
