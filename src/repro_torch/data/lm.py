"""Deterministic synthetic LM data, the counterpart of ``repro.data.lm``
(a copy of its numpy, so the stream is the reference's bit for bit).

Batch contents are a pure function of (seed, step, arch): a resumed or
re-sharded job regenerates exactly the same stream with no data-loader
state to checkpoint. Each host materializes only its slice
(host_id / host_count). Tokens follow a Zipfian unigram draw with
short-range repetition, so a model has a learnable signal. The batch is
numpy; ``to_device`` puts it on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig

__all__ = ["lm_batch", "to_device"]


def _zipf_tokens(rng, shape, vocab: int):
    u = rng.random(shape)
    ranks = np.minimum((u ** -1.2).astype(np.int64), vocab) - 1
    perm = rng.permutation(vocab)
    toks = perm[np.minimum(ranks, vocab - 1)]
    # short-range copy structure: token t repeats at t+1 with p=0.3
    rep = rng.random(shape) < 0.3
    toks[..., 1:] = np.where(rep[..., 1:], toks[..., :-1], toks[..., 1:])
    return toks.astype(np.int32)


def lm_batch(cfg: ModelConfig, *, batch: int, seq: int, step: int,
             seed: int = 0, host_id: int = 0, host_count: int = 1) -> dict:
    """Returns the batch dict (numpy arrays) for this host's slice."""
    if batch % host_count:
        raise ValueError(f"batch {batch} does not split over {host_count} "
                         f"hosts")
    b_local = batch // host_count
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, host_id]))
    out: dict = {}
    if cfg.frontend == "audio":
        out["features"] = rng.standard_normal(
            (b_local, seq, cfg.frontend_dim)).astype(np.float32)
        out["targets"] = rng.integers(0, cfg.vocab, (b_local, seq),
                                      dtype=np.int32)
        out["mask"] = rng.random((b_local, seq)) < 0.2
        return out
    out["tokens"] = _zipf_tokens(rng, (b_local, seq), cfg.vocab)
    if cfg.frontend == "vision":
        out["patches"] = (0.02 * rng.standard_normal(
            (b_local, cfg.n_patches, cfg.d_model))).astype(np.float32)
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32),
                              (b_local, 3, seq)).copy()
        out["mrope_pos"] = pos
    return out


def to_device(batch: dict, device) -> dict:
    """The numpy batch as tensors on ``device`` (dtypes kept)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
