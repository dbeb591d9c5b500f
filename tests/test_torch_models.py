"""The port's LM substrate (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package on the CPU, for every ``ARCH_ID`` at its smoke
config in f32: the reference's ``init_params(cfg, PRNGKey(0))`` goes
through ``params_from_numpy`` into the port, and the same tokens, made
with numpy, go through both. Compared: ``forward`` logits and the MoE aux
loss, ``prefill``'s last logits and every cache leaf, 8 ``decode_step``s
after it (logits and caches), and the teacher-forced decode path against
``forward``. Tolerance: rtol 1e-5, atol 1e-5 everywhere (f32; the two sum
in other orders and XLA's exp, rsqrt and logistic differ from PyTorch's
by a few ulps).

Also: the configs field by field; ``count_params`` (total and active) of
the full configs; ``param_logical_axes`` with and without fsdp; bf16
leaves carried across by their bits; the ring cache past the window
(gemma3's smoke window is 8, the prompts run to 20); the q-chunked
attention (S = 2048, causal with and without a window, and
bidirectional) and MLA's chunked scores (S = 512); MoE token dropping at
a capacity that drops. The reference's functions run under ``jax.jit``
with the config static (f32 throughout, so XLA's excess precision on bf16
chains does not enter).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as jssm

import _torch_lm_reference as lm_reference

from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models.config import MoEConfig

RTOL = ATOL = 1e-5
B, S, NEW = 2, 12, 8


@pytest.fixture(autouse=True)
def _reference_ssd_repaired(monkeypatch):
    """The reference's mamba_block runs the SSD with F9 repaired."""
    monkeypatch.setattr(jssm, "ssd_chunked", lm_reference.repaired)


def _jits(cfg):
    """The reference's forward, prefill and decode step under ``jax.jit``
    with ``cfg`` closed over: fresh functions, so no trace is shared with
    another test (or with a trace made without the repair)."""
    return (jax.jit(lambda p, b: JM.forward(p, cfg, b)),
            jax.jit(lambda p, b, n: JM.prefill(p, cfg, b, cache_len=n),
                    static_argnums=2),
            jax.jit(lambda p, c, t, pos: JM.decode_step(p, cfg, c, t, pos)))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _tree_close(got, want, what):
    # the port's tree has the reference's structure: flatten both alike
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = jax.tree_util.tree_leaves(got)
    assert len(jl) == len(tl), what
    for (path, w), t in zip(jl, tl):
        assert tuple(t.shape) == tuple(w.shape), (what, path)
        _close(t, w, f"{what} {jax.tree_util.keystr(path)}")


def _pair(arch, **over):
    jc = jconfigs.get_smoke_config(arch)
    tc = tconfigs.get_smoke_config(arch)
    if over:
        jc, tc = jc.scaled(**over), tc.scaled(**over)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jc, tc, jp, tp


def _batches(cfg, n_tok, seed=0):
    """The same batch for both packages: tokens (and audio features,
    M-RoPE positions on text, vision patches) from numpy."""
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32)}
    if cfg.frontend == "audio":
        nb["features"] = rng.standard_normal(
            (B, n_tok, cfg.frontend_dim)).astype(np.float32)
    if cfg.mrope_sections is not None:
        nb["mrope_pos"] = np.broadcast_to(
            np.arange(n_tok, dtype=np.int32), (B, 3, n_tok)).copy()
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.as_tensor(v) for k, v in nb.items()})


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_configs_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), (arch, get)
        assert t.torch_dtype == {"float32": torch.float32,
                                 "bfloat16": torch.bfloat16}[j.dtype]
    full = tconfigs.get_config(arch)
    jfull = jconfigs.get_config(arch)
    assert TM.count_params(full) == JM.count_params(jfull)
    assert (TM.count_params(full, active_only=True)
            == JM.count_params(jfull, active_only=True))
    for fsdp in (False, True):
        ja = JM.param_logical_axes(jfull, fsdp=fsdp)
        ta = TM.param_logical_axes(full, fsdp=fsdp)
        flat_j = jax.tree_util.tree_leaves(
            ja, is_leaf=lambda x: isinstance(x, tuple))
        flat_t = jax.tree_util.tree_leaves(
            ta, is_leaf=lambda x: isinstance(x, tuple))
        assert flat_j == flat_t, (arch, fsdp)
    assert tconfigs.get_config("khi-serve").name == "khi-serve"


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_forward_prefill_decode_match_reference(arch):
    """forward on S + NEW = 20 tokens; prefill of the first S = 12 into a
    cache of 20 (gemma3's window-8 layers get ring caches), then NEW
    teacher-forced decode steps (the ring wraps), each against the
    reference; then the port's own decode path from an empty cache over
    all 20 positions against its forward and its prefill + decode."""
    jc, tc, jp, tp = _pair(arch)
    jfwd, jpre, jdec = _jits(jc)
    jb, tb = _batches(jc, S + NEW)
    with torch.no_grad():
        jl, ja = jfwd(jp, jb)
        tl, ta = TM.forward(tp, tc, tb)
        _close(tl, jl, f"{arch} forward logits")
        _close(ta, ja, f"{arch} moe aux")
        if jc.encoder_only:
            return
        jlog, jcache = jpre(jp, {k: v[..., :S] for k, v in jb.items()},
                            S + NEW)
        tlog, tcache = TM.prefill(tp, tc, {k: v[..., :S]
                                           for k, v in tb.items()},
                                  cache_len=S + NEW)
        _close(tlog, jlog, f"{arch} prefill logits")
        _tree_close(tcache, jcache, f"{arch} prefill cache")
        _close(tlog[:, 0], jl[:, S - 1], f"{arch} prefill vs forward")
        steps = []
        for t in range(S, S + NEW):
            tok = tb["tokens"][:, t:t + 1]
            jlog, jcache = jdec(jp, jcache, jnp.asarray(tok.numpy()),
                                jnp.int32(t))
            tlog, tcache = TM.decode_step(tp, tc, tcache, tok, t)
            _close(tlog, jlog, f"{arch} decode step {t}")
            steps.append(tlog)
        _tree_close(tcache, jcache, f"{arch} cache after decode")
        # the port alone: all-decode from position 0 = forward, and =
        # prefill + decode at the last NEW positions
        cache = TM.init_cache(tc, B, S + NEW)
        for t in range(S + NEW):
            lg, cache = TM.decode_step(tp, tc, cache,
                                       tb["tokens"][:, t:t + 1], t)
            _close(lg[:, 0], jl[:, t], f"{arch} all-decode vs forward at {t}")
            if t >= S:
                torch.testing.assert_close(lg, steps[t - S], rtol=RTOL,
                                           atol=ATOL)


def test_reference_ssd_fault_pinned():
    """ROADMAP F9: the reference's chunked SSD sums B and C over the
    repeated heads, so its carried state is nh times the recurrence's and,
    past one chunk, its output leaves the recurrence too; within one
    chunk the off-diagonal term is zero and the outputs agree. The port's
    ``ssd_chunked`` is the repaired one."""
    rng = np.random.default_rng(9)
    b, h, p, g, n, L = 1, 4, 3, 1, 5, 8
    original = jax.jit(lm_reference.original, static_argnums=5)
    repaired = jax.jit(lm_reference.repaired, static_argnums=5)
    for s_len, differs in ((L, False), (2 * L + 3, True)):
        x = rng.standard_normal((b, s_len, h, p)).astype(np.float32)
        dt = rng.random((b, s_len, h)).astype(np.float32)
        A = -rng.random(h).astype(np.float32)
        Bm = rng.standard_normal((b, s_len, g, n)).astype(np.float32)
        Cm = rng.standard_normal((b, s_len, g, n)).astype(np.float32)
        args = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
        yo, ho = original(*args, L)
        yr, hr = repaired(*args, L)
        yt, ht = TSSM.ssd_chunked(*[torch.as_tensor(a)
                                    for a in (x, dt, A, Bm, Cm)], L)
        _close(yt, yr, "port ssd vs repaired reference")
        _close(ht, hr, "port ssd state vs repaired reference")
        np.testing.assert_allclose(np.asarray(ho), h * np.asarray(hr),
                                   rtol=1e-5, atol=1e-5)
        same = np.allclose(np.asarray(yr), np.asarray(yo), rtol=1e-5,
                           atol=1e-5)
        assert same is not differs, s_len


def test_bf16_leaves_carried_by_their_bits():
    """A tree shaped as the reference's, with bf16 leaves (numpy's
    ``bfloat16`` extension type, as ``np.asarray`` gives them) beside f32
    ones: every leaf arrives with its dtype and its bits."""
    rng = np.random.default_rng(3)
    f = rng.standard_normal((2, 6, 5)).astype(np.float32)
    tree = {"embed": np.asarray(jnp.asarray(f[0]).astype(jnp.bfloat16)),
            "stages": [{"l0": {"moe": {
                "router": f[1],
                "wi": np.asarray(jnp.asarray(f).astype(jnp.bfloat16))}}}]}
    tp = TM.params_from_numpy(tree)
    jl = jax.tree_util.tree_leaves(tree)
    tl = jax.tree_util.tree_leaves(tp)
    assert len(jl) == len(tl) == 3
    for w, t in zip(jl, tl):
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[w.dtype.name]
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), w)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None)])
def test_q_chunked_attention_matches_reference(causal, window):
    """S = 2048 > Q_CHUNK and a multiple of it: the blockwise path (the
    window path slices the KV stream per block)."""
    rng = np.random.default_rng(7)
    Sx, H, KV, hd = 2048, 4, 2, 8
    q, k, v = (rng.standard_normal((1, Sx, h, hd)).astype(np.float32)
               for h in (H, KV, KV))
    want = JL._attn_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window)
    got = TL._attn_core(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), causal=causal, window=window)
    _close(got, want, f"q-chunked attention {causal} {window}")
    # the blockwise path equals the one-block path
    full = TL._sdpa(torch.as_tensor(q), torch.as_tensor(k),
                    torch.as_tensor(v),
                    TL._mask_bias(Sx, Sx, causal=causal, window=window))
    torch.testing.assert_close(got, full, rtol=RTOL, atol=ATOL)


def test_mla_chunked_scores_match_reference():
    """MLA's prefill at S = 512 takes its 256-query chunks."""
    jc, tc, jp, tp = _pair("minicpm3-4b")
    jb, tb = _batches(jc, 512, seed=2)
    jb = {k: v[:1] for k, v in jb.items()}
    tb = {k: v[:1] for k, v in tb.items()}
    with torch.no_grad():
        _close(TM.forward(tp, tc, tb)[0], _jits(jc)[0](jp, jb)[0],
               "minicpm3 S=512")


@pytest.mark.parametrize("cf", [0.5, 1.0])
def test_moe_token_dropping_matches_reference(cf):
    """A capacity that drops tokens (0.5 and 1.0 of the mean load, 24
    tokens top-2 of 8 experts, padded to 10): the stable expert sort
    decides which tokens keep their slots."""
    rng = np.random.default_rng(11)
    D, E, Fe = 16, 8, 12
    moe = MoEConfig(n_experts=E, top_k=2, d_expert=Fe, capacity_factor=cf,
                    pad_to=10)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    p = {"router": rng.standard_normal((D, 10)).astype(np.float32),
         "wi": rng.standard_normal((10, D, Fe)).astype(np.float32) * 0.1,
         "wg": rng.standard_normal((10, D, Fe)).astype(np.float32) * 0.1,
         "wo": rng.standard_normal((10, Fe, D)).astype(np.float32) * 0.1}
    jo, ja = jax.jit(lambda xx, pp: JL.moe_ffn(xx, pp, moe))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    to, ta = TL.moe_ffn(torch.as_tensor(x), {k: torch.as_tensor(v)
                                             for k, v in p.items()}, moe)
    _close(to, jo, f"moe out cf={cf}")
    _close(ta, ja, f"moe aux cf={cf}")
    # the 8 live experts hold fewer slots than the 48 assignments, so
    # tokens drop
    C = int(np.ceil(24 * 2 / 10 * cf))
    assert C * moe.n_experts < 24 * 2
