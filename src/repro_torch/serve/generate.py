"""Serving loop of the LM substrate: prefill once, then token-by-token
decode; the counterpart of ``repro.serve.generate``. ``prefill`` builds
the ring/latent/SSM caches in one pass and ``decode_step`` continues at
pos = S, writing them in place. Greedy, or temperature sampling from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import model as M
from ..models.config import ModelConfig

__all__ = ["generate"]


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor, *,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             batch: Optional[dict] = None) -> torch.Tensor:
    """prompt (B, S) int -> generated (B, max_new_tokens) int32, on the
    prompt's device. ``temperature > 0`` samples each token from
    softmax(logits / temperature) with ``generator`` (required then); the
    reference draws from a JAX key, so sampled tokens differ between the
    packages and only greedy ones are compared."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    B, S = prompt.shape
    full = dict(batch or {})
    full["tokens"] = prompt
    logits, cache = M.prefill(params, cfg, full,
                              cache_len=S + max_new_tokens)

    def pick(lg):
        last = lg[:, -1].float()
        if temperature <= 0.0:
            return torch.argmax(last, dim=-1).to(torch.int32)
        probs = torch.softmax(last / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    out = []
    cur = pick(logits)[:, None]
    for t in range(S, S + max_new_tokens):
        out.append(cur)
        logits, cache = M.decode_step(params, cfg, cache, cur, t)
        cur = pick(logits)[:, None]
    return torch.cat(out, dim=1)
