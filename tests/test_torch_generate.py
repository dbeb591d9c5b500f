"""The port's decode serving (``repro_torch.serve.generate`` and the
launcher's ``--mode generate``) against the JAX package on the CPU: for
every decode-capable ``ARCH_ID`` at its smoke config in f32, the
reference's ``init_params(cfg, PRNGKey(0))`` carried across with
``params_from_numpy``, the same numpy prompts, and greedy ``generate``
tokens that must be equal (the reference's mamba_block runs with ROADMAP
F9 repaired, as in ``test_torch_models.py``). The encoder-only arch raises
in both. Sampling takes an explicit generator and repeats with its seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.serve.generate import generate as jgenerate

import _torch_lm_reference as lm_reference

from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve.generate import generate as tgenerate

DECODERS = [a for a in tconfigs.ARCH_IDS
            if not tconfigs.get_smoke_config(a).encoder_only]


@pytest.fixture(autouse=True)
def _reference_ssd_repaired(monkeypatch):
    monkeypatch.setattr(jssm, "ssd_chunked", lm_reference.repaired)


def _setup(arch, B=2, S=10, seed=0):
    jc = jconfigs.get_smoke_config(arch)
    tc = tconfigs.get_smoke_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp))
    prompt = np.random.default_rng(seed).integers(
        0, jc.vocab, (B, S)).astype(np.int32)
    extra = {}
    if jc.mrope_sections is not None:       # text positions on all streams
        extra["mrope_pos"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (B, 3, S)).copy()
    return jc, tc, jp, tp, prompt, extra


@pytest.mark.parametrize("arch", DECODERS)
def test_greedy_generate_matches_reference(arch):
    jc, tc, jp, tp, prompt, extra = _setup(arch)
    want = jgenerate(jp, jc, jnp.asarray(prompt), max_new_tokens=8,
                     batch={k: jnp.asarray(v) for k, v in extra.items()})
    got = tgenerate(tp, tc, torch.as_tensor(prompt), max_new_tokens=8,
                    batch={k: torch.as_tensor(v) for k, v in extra.items()})
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encoder_only_has_no_decode():
    jc = jconfigs.get_smoke_config("hubert-xlarge")
    tc = tconfigs.get_smoke_config("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        jgenerate({}, jc, jnp.zeros((1, 4), jnp.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="encoder-only"):
        tgenerate({}, tc, torch.zeros((1, 4), dtype=torch.int32),
                  max_new_tokens=2)


def test_sampling_takes_an_explicit_generator():
    tc = tconfigs.get_smoke_config("qwen1.5-4b")
    tp = TM.init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    prompt = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="Generator"):
        tgenerate(tp, tc, prompt, max_new_tokens=3, temperature=1.0)
    a, b = (tgenerate(tp, tc, prompt, max_new_tokens=6, temperature=0.8,
                      generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b) and bool(((a >= 0) & (a < tc.vocab)).all())


def test_launcher_generate_mode(capsys):
    gen = tserve.main(["--mode", "generate", "--arch", "gemma3-4b",
                       "--new-tokens", "5", "--device", "cpu"])
    assert gen.shape == (4, 5)
    assert "[serve] generated (4, 5) tokens on cpu" in capsys.readouterr().out
    with pytest.raises(ValueError, match="encoder-only"):
        tserve.main(["--mode", "generate", "--arch", "hubert-xlarge",
                     "--device", "cpu"])


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_bf16_models_run(arch):
    """Every arch in bf16 (the dtype the card serves), port only: the
    reference's bf16 chains keep f32 under XLA's CPU jit (ROADMAP, excess
    precision), so the packages are compared in f32 above. forward gives
    finite bf16 logits; a decode arch's prefill logits equal its
    all-decode path's within bf16 noise (2e-2 of the largest logit), and
    ``generate`` gives in-range tokens."""
    cfg = tconfigs.get_smoke_config(arch).scaled(dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator().manual_seed(2),
                            device="cpu")
    B, S, new = 2, 10, 6
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                       dtype=torch.int32)}
    if cfg.frontend == "audio":
        batch["features"] = torch.as_tensor(
            rng.standard_normal((B, S, cfg.frontend_dim)), dtype=torch.float32)
    if cfg.mrope_sections is not None:
        batch["mrope_pos"] = torch.arange(S, dtype=torch.int32).expand(
            B, 3, S)
    with torch.no_grad():
        logits, _ = TM.forward(params, cfg, batch)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits.float()).all())
        if cfg.encoder_only:
            return
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        got = tgenerate(params, cfg, batch["tokens"], max_new_tokens=new,
                        batch=extra)
        cache = TM.init_cache(cfg, B, S + new)
        for t in range(S):
            lg, cache = TM.decode_step(params, cfg, cache,
                                       batch["tokens"][:, t:t + 1], t)
        pl, _ = TM.prefill(params, cfg, batch, cache_len=S + new)
        scale = float(lg.float().abs().max())
        assert float((pl.float() - lg.float()).abs().max()) <= 2e-2 * scale
    assert got.shape == (B, new)
    assert bool(((got >= 0) & (got < cfg.vocab)).all())
