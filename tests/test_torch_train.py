"""Training of the port's LM substrate (``repro_torch.data.lm``,
``repro_torch.optim``, ``repro_torch.models.model.loss_fn`` and its remat
wrapper, ``repro_torch.train``, ``repro_torch.launch.train``) against the
JAX package on the CPU at smoke widths: the reference's ``init_params(cfg,
PRNGKey(0))`` goes through ``params_from_numpy`` into the port, and the
same batches, made with numpy by ``lm_batch``, go through both.

Tolerances: the data stream and ``quantize_int8`` bit for bit; the int8
all-reduce over 2 gloo ranks bit for bit (a sum of two f32 values, then a
division by 2, in either package); ``schedule`` and AdamW on f32 leaves
within rtol 2e-6 (schedule) and 1e-5 (the updates: XLA fuses the moment
updates into FMAs and its pow, sqrt and cos differ by an ulp or so, which
three steps compound), bf16 leaves within one bf16 ulp; the loss within rtol 1e-5 and
its gradients within rtol 1e-4, atol 1e-6 (f32 forward and backward that
sum in other orders and whose exp, rsqrt and logistic differ by a few
ulps, through a few layers); two training steps' parameters within rtol
1e-4, atol 1e-6 and their moments within rtol 1e-4 and the gradients'
atol (x 0.1 for the first moment, squared for the second), with AdamW's
eps at 1e-3 (``STEP_OPT``). The SSM arch (mamba2) runs the reference's SSD
with ROADMAP F9 repaired (``tests/_torch_lm_reference.py``) over two
chunks.
"""

import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.lm import lm_batch as j_lm_batch
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.train import compressed as jcomp
from repro.train.step import make_train_step as j_make_train_step

import _torch_lm_reference as lm_reference
import _torch_train_worker as worker

from repro_torch import configs as tconfigs
from repro_torch.data.lm import lm_batch, to_device
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.train import (compressed_psum, dequantize_int8,
                               make_train_step, quantize_int8)

# one arch of each family: dense, MoE, MLA, SSM, vision, audio encoder
FAMILIES = ("qwen1.5-4b", "granite-moe-3b-a800m", "minicpm3-4b",
            "mamba2-780m", "qwen2-vl-72b", "hubert-xlarge")
B, S = 4, 24


@pytest.fixture(autouse=True)
def _reference_ssd_repaired(monkeypatch):
    """The reference's mamba_block runs the SSD with F9 repaired."""
    monkeypatch.setattr(jssm, "ssd_chunked", lm_reference.repaired)


def _pair(arch, seed=0):
    """(reference config, port config, reference params, port params)."""
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jc, tc, jp, tp


def _batch(tc, step=0, batch=B, seq=S):
    nb = lm_batch(tc, batch=batch, seq=seq, step=step, seed=3)
    return nb, {k: jnp.asarray(v) for k, v in nb.items()}, to_device(nb,
                                                                     "cpu")


def _leaves(tree):
    return tadamw.tree_leaves(tree)


def _close_tree(got, want, rtol, atol, what):
    gl, wl = _leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(
            np.asarray(g.detach().float()), np.asarray(w, dtype=np.float32),
            rtol=rtol, atol=atol, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2-vl-72b",
                                  "hubert-xlarge"])
@pytest.mark.parametrize("host", [(0, 1), (1, 2)])
def test_lm_batch_bit_equal(arch, host):
    """Every frontend's stream (tokens; tokens, patches and M-RoPE
    positions; audio features, targets and mask) equal bit for bit, for a
    host's slice too."""
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    for step in (0, 7):
        want = j_lm_batch(jc, batch=4, seq=20, step=step, seed=5,
                          host_id=host[0], host_count=host[1])
        got = lm_batch(tc, batch=4, seq=20, step=step, seed=5,
                       host_id=host[0], host_count=host[1])
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="split"):
        lm_batch(tc, batch=3, seq=4, step=0, host_count=2)


def test_schedule_matches():
    cfg = jadamw.AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    tcfg = tadamw.AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    steps = np.array([0, 1, 5, 9, 10, 11, 50, 99, 100, 150], np.int32)
    want = np.asarray(jadamw.schedule(cfg, jnp.asarray(steps)))
    got = tadamw.schedule(tcfg, torch.as_tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    assert got[0] == 0.0 and abs(got[4] - 3e-3) < 1e-9


def _random_tree(rng, scale):
    """A parameter tree as the models' (dicts, a list of stages), f32 and
    bf16 leaves, and gradients at ``scale``."""
    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)
    p = {"embed": f32(11, 6), "final_norm": f32(6),
         "stages": [{"l0": {"w": f32(2, 6, 5), "b": f32(2, 5)}},
                    {"l0": {"w": f32(1, 5, 6)}}]}
    bf = {"half": rng.standard_normal((4, 8)).astype(jnp.bfloat16)}
    g = jax.tree.map(lambda x: (scale * rng.standard_normal(x.shape)
                                ).astype(x.dtype), {**p, **bf})
    return {**p, **bf}, g


def _to_port(tree):
    return TM.params_from_numpy(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("scale", [1e-3, 10.0])      # no clip, clipped
def test_adamw_update_matches(scale):
    """Three updates on random trees (f32 and bf16 leaves), the moments,
    the step, the learning rate and the global norm; at scale 10 the
    gradients' norm is past the clip."""
    rng = np.random.default_rng(int(scale * 1000))
    cfg = jadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    tcfg = tadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jp, _ = _random_tree(rng, scale)
    tp = _to_port(jp)
    js, ts = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    for it in range(3):
        _, jg = _random_tree(np.random.default_rng(it), scale)
        tg = _to_port(jg)
        jp, js, jm = jadamw.adamw_update(jp, jg, js, cfg)
        tp, ts, tm = tadamw.adamw_update(tp, tg, ts, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=2e-6)
        assert int(ts["step"]) == int(js["step"]) == it + 1
        assert ts["step"].dtype == torch.int32
        for t, j in zip(_leaves(tp), jax.tree.leaves(jp)):
            assert t.dtype == TM.params_from_numpy(
                {"x": np.asarray(j)})["x"].dtype
            tol = 1e-5 if t.dtype == torch.float32 else 2 ** -7
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32),
                                       rtol=tol, atol=1e-7)
        for name in ("mu", "nu"):
            _close_tree(ts[name], js[name], 1e-5, 1e-9, name)
    if scale > 1:
        assert float(jm["grad_norm"]) > cfg.grad_clip


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match(arch):
    """``loss_fn`` (causal CE + aux; hubert's masked CE) and its gradients
    against ``jax.value_and_grad`` of the reference's."""
    jc, tc, jp, tp = _pair(arch)
    seq = 24 if arch != "qwen2-vl-72b" else tc.n_patches + 8
    _, jb, tb = _batch(tc, seq=seq)
    (jt, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jc, jb), has_aux=True)(jp)
    live = tadamw.tree_map(lambda p: p.clone().requires_grad_(True), tp)
    tt, tm = TM.loss_fn(live, tc, tb)
    tg = torch.autograd.grad(tt, _leaves(live), allow_unused=True,
                             materialize_grads=True)
    for a, b in ((tt, jt), (tm["loss"], jm["loss"]), (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5,
                                   atol=1e-7)
    assert float(tt) > 0.5 * np.log(tc.vocab)          # near-uniform logits
    for i, (g, w) in enumerate(zip(tg, jax.tree.leaves(jg))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{arch} grad {i}")


# the training steps' AdamW: eps 1e-3 keeps an update lr x m / (sqrt(v) +
# eps) within 1e3 x lr of its gradient's rounding (at 1e-8 an entry whose
# gradient is near 0 moves by a share of lr on a rounding difference);
# test_adamw_update_matches holds the default eps
STEP_OPT = dict(peak_lr=3e-3, warmup_steps=1, total_steps=10, eps=1e-3)


def _j_step(jc, n_micro):
    cfg = jadamw.AdamWConfig(**STEP_OPT)
    return jax.jit(j_make_train_step(jc, cfg, n_micro=n_micro))


def _t_step(tc, n_micro):
    return make_train_step(tc, tadamw.AdamWConfig(**STEP_OPT),
                           n_micro=n_micro)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "granite-moe-3b-a800m",
                                  "mamba2-780m"])
@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_step_matches(arch, n_micro):
    """Two training steps against the reference's ``make_train_step``:
    the metrics, the parameters, the moments and the step."""
    jc, tc, jp, tp = _pair(arch)
    js, ts = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    jstep, tstep = _j_step(jc, n_micro), _t_step(tc, n_micro)
    for step in range(2):
        _, jb, tb = _batch(tc, step=step)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert sorted(tm) == sorted(jm) == ["aux", "grad_norm", "loss", "lr"]
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        _close_tree(tp, jp, 1e-4, 1e-6, f"{arch} params")
        _close_tree(ts["mu"], js["mu"], 1e-4, 1e-7, f"{arch} mu")
        _close_tree(ts["nu"], js["nu"], 1e-4, 1e-12, f"{arch} nu")
        assert int(ts["step"]) == step + 1


def test_n_micro_4_equals_n_micro_1():
    """Four f32-accumulated microbatches give the whole batch's gradients:
    the loss, the gradient norm and the updated parameters agree (the sums
    differ only in their order)."""
    _, tc, _, tp = _pair("qwen1.5-4b")
    _, _, tb = _batch(tc)
    outs = []
    for n in (1, 4):
        st = tadamw.init_opt_state(tp)
        outs.append(_t_step(tc, n)(tp, st, tb))
    (p1, s1, m1), (p4, s4, m4) = outs
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m4[k]), float(m1[k]), rtol=1e-5)
    for a, b in zip(_leaves(p4), _leaves(p1)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    for a, b in zip(_leaves(s4["nu"]), _leaves(s1["nu"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-12)
    with pytest.raises(ValueError, match="microbatches"):
        _t_step(tc, 3)(tp, tadamw.init_opt_state(tp), tb)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "granite-moe-3b-a800m",
                                  "mamba2-780m"])
def test_remat_modes_give_equal_gradients(arch):
    """remat "none", "dots" and "full" change what is kept for the
    backward pass, not a value: the loss and every gradient equal bit for
    bit; an unknown mode is refused."""
    _, tc, _, tp = _pair(arch)
    _, _, tb = _batch(tc)
    out = {}
    for mode in ("none", "dots", "full"):
        cfg = tconfigs.get_smoke_config(arch).__class__(
            **{**tc.__dict__, "remat": mode})
        live = tadamw.tree_map(lambda p: p.clone().requires_grad_(True), tp)
        total, _ = TM.loss_fn(live, cfg, tb)
        out[mode] = (total.detach(), torch.autograd.grad(
            total, _leaves(live), allow_unused=True, materialize_grads=True))
    for mode in ("dots", "full"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for a, b in zip(out[mode][1], out["none"][1]):
            assert torch.equal(a, b), mode
    bad = tc.__class__(**{**tc.__dict__, "remat": "some"})
    with pytest.raises(ValueError, match="remat"):
        TM.loss_fn(tp, bad, tb)


def test_quantize_int8_bit_equal():
    """Per-tensor int8 with half-to-even rounding: random tensors, one
    whose scale is exactly 1 with entries on .5 (2.5 -> 2, -3.5 -> -4),
    an all-zero one (the 1e-12 floor)."""
    rng = np.random.default_rng(8)
    cases = [rng.standard_normal((37, 5)).astype(np.float32) * 3,
             np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -127.0],
                      np.float32),
             np.zeros((4,), np.float32),
             rng.standard_normal((9,)).astype(jnp.bfloat16)]
    for x in cases:
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = quantize_int8(TM.params_from_numpy({"x": x})["x"])
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts) == np.float32(js)
        np.testing.assert_array_equal(
            dequantize_int8(tq, ts).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))
    assert quantize_int8(torch.tensor([2.5, -3.5, 127.0]))[0].tolist() == \
        [2, -4, 127]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_psum_two_gloo_ranks(tmp_path):
    """Two gloo ranks, each with its own gradients and residuals: every
    rank's mean equals the mean over the ranks of the reference's
    ``dequantize_int8(quantize_int8(g + r))``, and its new residual is its
    own ``g + r`` less that, bit for bit."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(r), "2",
                               str(port), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            p.kill()
    deq, vs = {}, {}
    for r in range(2):
        g, res = worker.inputs(r)
        for k in g:
            v = jnp.asarray(g[k]) + jnp.asarray(res[k])
            vs[r, k] = v
            deq[r, k] = jcomp.dequantize_int8(*jcomp.quantize_int8(v))
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for k in worker.inputs(r)[0]:
            want = (deq[0, k] + deq[1, k]) / 2
            np.testing.assert_array_equal(got[f"mean/{k}"], np.asarray(want))
            np.testing.assert_array_equal(got[f"res/{k}"],
                                          np.asarray(vs[r, k] - deq[r, k]))


def test_launcher_resume_reproduces_the_run(tmp_path, capsys):
    """The launcher on the CPU: an uninterrupted run's losses, then a run
    that checkpoints every 3 steps, whose final checkpoint is removed (a
    job that died after step 3's) and which is started again: it resumes
    at step 3 and its losses are the uninterrupted run's, bit for bit. The
    watchdog and the resume are logged; the default device is the card."""
    base = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu", "--steps",
            "6", "--batch", "4", "--seq", "16", "--n-micro", "2"]
    full = tlaunch.main(base)
    ck = str(tmp_path / "ck")
    first = tlaunch.main(base + ["--ckpt-dir", ck, "--ckpt-every", "3"])
    assert first == full and len(full) == 6
    assert sorted(os.listdir(ck)) == ["step_3", "step_6"]
    shutil.rmtree(os.path.join(ck, "step_6"))
    again = tlaunch.main(base + ["--ckpt-dir", ck, "--ckpt-every", "3"])
    assert again == full[3:]
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out
    assert "[train] step     0 loss" in out
    cut = tlaunch.cut_depth(tconfigs.get_config("qwen1.5-4b"), 4)
    assert cut.n_layers == 4 and cut.d_model == 2560
    assert tlaunch.parse_args(["--arch", "x"]).device is None
