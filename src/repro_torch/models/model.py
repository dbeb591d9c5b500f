"""Model assembly: parameter init, the stage-stacked forward (each
repeat of a stage under the config's remat policy), the training loss,
prefill and decode with caches. One code path serves all 10
architectures via ModelConfig: the counterpart of ``repro.models.model``.

Parameters are a nested dict of tensors shaped as the reference's tree:
``{"embed", "final_norm", "lm_head"?, "frontend"?: {"proj"},
"stages": [{"l0": {...}, ...}, ...]}``, every stage leaf stacked with a
leading (repeat,) axis. A stage runs its body ``repeat`` times over slice r
of each leaf, as the reference's ``lax.scan`` does.
``params_from_numpy`` carries the reference's ``init_params`` tree across.

Batch dict keys (tensors on the model's device):
  tokens    (B, S) int          LM input
  positions (B, S) int          optional, default arange(S)
  mrope_pos (B, 3, S) int       qwen2-vl only
  patches   (B, P, D)           vision stub embeddings (qwen2-vl)
  features  (B, S, F)           audio stub frame features (hubert)
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as Fn
from torch.utils import checkpoint as ckpt

from . import layers as L
from . import ssm as SSM
from .config import LayerSpec, ModelConfig
from .sharding import constrain

__all__ = ["init_params", "forward", "loss_fn", "prefill", "init_cache",
           "decode_step", "count_params", "param_logical_axes",
           "param_specs", "params_from_numpy"]

F32 = torch.float32


# ------------------------------------------------------------------- init

def _attn_specs(cfg: ModelConfig, R: int, dt):
    H, KV, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        return {
            "wq_a": ("normal", (R, D, m.q_lora_rank), dt),
            "wq_b": ("normal", (R, m.q_lora_rank, H, qk), dt),
            "wkv_a": ("normal", (R, D, m.kv_lora_rank + m.qk_rope_dim), dt),
            "wkv_b_k": ("normal", (R, m.kv_lora_rank, H, m.qk_nope_dim), dt),
            "wkv_b_v": ("normal", (R, m.kv_lora_rank, H, m.v_head_dim), dt),
            "wo": ("normal", (R, H, m.v_head_dim, D), dt),
        }
    p = {"wq": ("normal", (R, D, H, hd), dt),
         "wk": ("normal", (R, D, KV, hd), dt),
         "wv": ("normal", (R, D, KV, hd), dt),
         "wo": ("normal", (R, H, hd, D), dt)}
    if cfg.qkv_bias:
        p["bq"] = ("zeros", (R, H, hd), dt)
        p["bk"] = ("zeros", (R, KV, hd), dt)
        p["bv"] = ("zeros", (R, KV, hd), dt)
    return p


def _ssm_specs(cfg: ModelConfig, R: int, dt):
    s = cfg.ssm
    D = cfg.d_model
    d_inner = s.expand * D
    nh = d_inner // s.head_dim
    gN = s.n_groups * s.d_state
    ch = d_inner + 2 * gN
    proj_out = 2 * d_inner + 2 * gN + nh
    return {
        "in_proj": ("normal", (R, D, proj_out), dt),
        "conv_w": ("normal", (R, s.d_conv, ch), dt),
        "conv_b": ("zeros", (R, ch), dt),
        "dt_bias": ("zeros", (R, nh), dt),
        "A_log": ("zeros", (R, nh), F32),
        "D": ("ones", (R, nh), dt),
        "norm": ("zeros", (R, d_inner), dt),
        "out_proj": ("normal", (R, d_inner, D), dt),
    }


def _ffn_specs(cfg: ModelConfig, R: int, kind: str, dt):
    D = cfg.d_model
    if kind == "dense":
        F = cfg.d_ff
        return {"wi": ("normal", (R, D, F), dt),
                "wg": ("normal", (R, D, F), dt),
                "wo": ("normal", (R, F, D), dt)}
    E, Fe = cfg.moe.n_padded, cfg.moe.d_expert
    return {"router": ("normal", (R, D, E), F32),
            "wi": ("normal", (R, E, D, Fe), dt),
            "wg": ("normal", (R, E, D, Fe), dt),
            "wo": ("normal", (R, E, Fe, D), dt)}


def _layer_specs(cfg: ModelConfig, spec: LayerSpec, R: int, dt):
    p: Dict[str, Any] = {"ln1": ("zeros", (R, cfg.d_model), dt)}
    if spec.mixer == "attn":
        p["attn"] = _attn_specs(cfg, R, dt)
    else:
        p["ssm"] = _ssm_specs(cfg, R, dt)
    if spec.ffn is not None:
        p["ln2"] = ("zeros", (R, cfg.d_model), dt)
        p[spec.ffn] = _ffn_specs(cfg, R, spec.ffn, dt)
    return p


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree with a leaf (init, shape, dtype) in each tensor's
    place: init is "normal" (0.02 x N(0, 1)), "zeros" or "ones", as the
    reference's ``init_params`` draws it."""
    dt = cfg.torch_dtype
    specs: Dict[str, Any] = {
        "embed": ("normal", (cfg.vocab, cfg.d_model), dt),
        "final_norm": ("zeros", (cfg.d_model,), dt),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("normal", (cfg.d_model, cfg.vocab), dt)
    if cfg.frontend == "audio":
        specs["frontend"] = {
            "proj": ("normal", (cfg.frontend_dim, cfg.d_model), dt)}
    specs["stages"] = [
        {f"l{j}": _layer_specs(cfg, spec, stage.repeat, dt)
         for j, spec in enumerate(stage.body)}
        for stage in cfg.stages]
    return specs


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(tree, path)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None) -> Dict[str, Any]:
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``), each normal leaf 0.02 x N(0, 1) drawn in the config's
    dtype. The draws are not the reference's: carry its tree across with
    ``params_from_numpy`` where the two must agree."""
    dev = torch.device(device) if device is not None else generator.device

    def make(leaf, _):
        init, shape, dt = leaf
        if init == "normal":
            return 0.02 * torch.randn(shape, generator=generator, dtype=dt,
                                      device=dev)
        fill = torch.zeros if init == "zeros" else torch.ones
        return fill(shape, dtype=dt, device=dev)

    return _map(param_specs(cfg), make)


def params_from_numpy(tree, *, device=None) -> Dict[str, Any]:
    """The reference's ``init_params`` tree, its leaves as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's: the same nested
    dicts and stage list, the stacked (R, ...) leaves and the ``l{j}``
    keys kept, each leaf a tensor of the same dtype on ``device`` (bf16
    leaves, numpy's ``bfloat16`` extension type, by their bits)."""
    def conv(a, _):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device) if device is not None else t

    return _map(tree, conv)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    specs = param_specs(cfg)
    total = sum(int(np.prod(leaf[1])) for _, leaf in _leaves(specs))
    if active_only and cfg.moe is not None:
        # subtract the inactive share of expert weights
        e = sum(int(np.prod(leaf[1])) for path, leaf in _leaves(specs)
                if "moe" in path and path[-1] in ("wi", "wg", "wo"))
        total -= int(e * (1 - cfg.moe.top_k / cfg.moe.n_experts))
    return total


# ------------------------------------------------------------------- apply

def _slice(tree, r: int):
    """Repeat r of a stage's stacked leaves."""
    return {k: (_slice(v, r) if isinstance(v, dict) else v[r])
            for k, v in tree.items()}


def _apply_block(x, p, spec: LayerSpec, cfg: ModelConfig, positions,
                 mrope_pos, aux, *, collect_cache: bool = False):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        if cfg.mla is not None:
            out, state = L.mla_attention(h, p["attn"], cfg, positions)
        else:
            out, state = L.attention(h, p["attn"], cfg, positions,
                                     window=spec.window, mrope_pos=mrope_pos)
    else:
        out, state = SSM.mamba_block(h, p["ssm"], cfg)
    x = x + out
    if spec.ffn is not None:
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.ffn == "dense":
            x = x + L.dense_ffn(h, p["dense"])
        else:
            y, a = L.moe_ffn(h, p["moe"], cfg.moe)
            x = x + y
            aux = aux + a
    return x, aux, (state if collect_cache else None)


def _embed_inputs(params, cfg: ModelConfig, batch):
    if cfg.frontend == "audio":
        return torch.einsum("bsf,fd->bsd",
                            batch["features"].to(cfg.torch_dtype),
                            params["frontend"]["proj"])
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    if cfg.frontend == "vision" and "patches" in batch:
        P = batch["patches"].shape[1]
        S = tokens.shape[1]
        pat = torch.nn.functional.pad(batch["patches"].to(cfg.torch_dtype),
                                      (0, 0, 0, S - P))
        is_pat = (torch.arange(S, device=x.device) < P)[None, :, None]
        x = torch.where(is_pat, pat, x)
    return x


def _positions(batch, B: int, S: int, device):
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device).expand(B, S)
    return positions


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# the matmuls whose outputs remat="dots" keeps (jax's checkpoint_dots:
# every dot_general; an einsum runs as one of these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, cfg: ModelConfig):
    """One repeat's body under the config's remat policy, as the
    reference's ``_remat_wrap`` around its scan step: "none" keeps every
    activation, "full" recomputes the body in the backward pass, "dots"
    keeps the matmul outputs and recomputes the rest. Only memory
    changes: the recomputation runs the same ops on the same inputs."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"remat must be none, dots or full, got "
                         f"{cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def _run_stages(params, cfg: ModelConfig, x, positions, mrope_pos, *,
                pack=None):
    """Every stage's body, repeat by repeat (under the remat policy where
    no cache is collected). With ``pack`` also returns the caches: per
    stage {"l{j}": leaves stacked over the repeats}."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    caches = []
    for si, stage in enumerate(cfg.stages):
        sp = params["stages"][si]
        per = []

        def body(xx, a, lp, _stage=stage):
            for j, spec in enumerate(_stage.body):
                xx, a, _ = _apply_block(xx, lp[f"l{j}"], spec, cfg,
                                        positions, mrope_pos, a)
            return xx, a

        step = _remat_wrap(body, cfg)
        for r in range(stage.repeat):
            lp = _slice(sp, r)
            if pack is None:
                x, aux = step(x, aux, lp)
                continue
            out = {}
            for j, spec in enumerate(stage.body):
                x, aux, st = _apply_block(x, lp[f"l{j}"], spec, cfg,
                                          positions, mrope_pos, aux,
                                          collect_cache=True)
                out[f"l{j}"] = pack(spec, st)
            per.append(out)
        if pack is not None:
            caches.append({f"l{j}": {name: torch.stack(
                [o[f"l{j}"][name] for o in per]) for name in per[0][f"l{j}"]}
                for j in range(len(stage.body))})
    return x, aux, caches


def forward(params, cfg: ModelConfig, batch):
    """Returns (logits (B,S,V), moe_aux_loss)."""
    x = _embed_inputs(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    x = constrain(x, "batch", None, None)
    positions = _positions(batch, B, S, x.device)
    x, aux, _ = _run_stages(params, cfg, x, positions,
                            batch.get("mrope_pos"))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, _head(params, cfg))
    return constrain(logits, "batch", None, "vocab"), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """The training loss, as the reference's: causal next-token
    cross-entropy over the logits in f32 (hubert, encoder-only: the
    cross-entropy at the masked positions against ``targets``), plus the
    MoE auxiliary loss. Returns (loss + aux, {"loss": loss, "aux":
    aux})."""
    logits, aux = forward(params, cfg, batch)
    logits = logits.to(F32)
    if cfg.encoder_only:
        targets = batch["targets"].long()
        mask = batch["mask"].to(F32)
        lp = Fn.log_softmax(logits, dim=-1)
        nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        tokens = batch["tokens"].long()
        lp = Fn.log_softmax(logits[:, :-1], dim=-1)
        nll = -torch.gather(lp, -1, tokens[:, 1:, None])[..., 0]
        loss = torch.mean(nll)
    return loss + aux, {"loss": loss, "aux": aux}


def _fit_cache(arr, T: int):
    """Pad (or trim) the sequence axis (axis 1 of (B, S, ...)) to T."""
    S = arr.shape[1]
    if S == T:
        return arr
    if S > T:
        return arr[:, S - T:]
    pad = [0, 0] * (arr.dim() - 2) + [0, T - S]
    return torch.nn.functional.pad(arr, pad)


def prefill(params, cfg: ModelConfig, batch, *,
            cache_len: Optional[int] = None):
    """Serving prefill: run the full sequence once, return ONLY the last
    position's logits plus the populated decode cache (window layers get
    ring-rotated caches so decode_step can continue at pos = S)."""
    x = _embed_inputs(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    x = constrain(x, "batch", None, None)
    positions = _positions(batch, B, S, x.device)
    T = cache_len or S
    dt = cfg.torch_dtype

    def pack(spec: LayerSpec, state):
        if spec.mixer == "ssm":
            conv, hT = state
            return {"conv": conv.to(dt), "ssm": hT.to(dt)}
        if cfg.mla is not None:
            c, kr = state
            return {"c": _fit_cache(c, T), "kr": _fit_cache(kr, T)}
        k, v = state
        if spec.window and spec.window < S:
            # ring layout: position p lives at slot p % window
            w = spec.window
            k = torch.roll(k[:, S - w:], S % w, dims=1)
            v = torch.roll(v[:, S - w:], S % w, dims=1)
            return {"k": k.to(dt), "v": v.to(dt)}
        return {"k": _fit_cache(k, T), "v": _fit_cache(v, T)}

    x, _, caches = _run_stages(params, cfg, x, positions,
                               batch.get("mrope_pos"), pack=pack)
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, _head(params, cfg))
    return logits, caches


# ------------------------------------------------------------------- decode

def _cache_for_spec(cfg: ModelConfig, spec: LayerSpec, R: int, B: int,
                    T: int, dt, device):
    def z(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    if spec.mixer == "ssm":
        cs, ss = SSM.mamba_state_shapes(cfg, B)
        return {"conv": z(R, *cs), "ssm": z(R, *ss)}
    if cfg.mla is not None:
        m = cfg.mla
        return {"c": z(R, B, T, m.kv_lora_rank),
                "kr": z(R, B, T, m.qk_rope_dim)}
    Tc = min(spec.window, T) if spec.window else T
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": z(R, B, Tc, KV, hd), "v": z(R, B, Tc, KV, hd)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> List[Dict[str, Any]]:
    dt = cfg.torch_dtype
    return [{f"l{j}": _cache_for_spec(cfg, spec, stage.repeat, batch,
                                      max_len, dt, device)
             for j, spec in enumerate(stage.body)}
            for stage in cfg.stages]


def _decode_block(x, p, c, spec: LayerSpec, cfg: ModelConfig, pos: int):
    """One layer's decode; ``c`` is the layer's cache at this repeat (views
    of the stacked cache), updated in place."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "ssm":
        out, (cs, ss) = SSM.mamba_decode(h, p["ssm"], cfg, c["conv"],
                                         c["ssm"])
        c["conv"].copy_(cs)
        c["ssm"].copy_(ss)
    elif cfg.mla is not None:
        out, _, _ = L.mla_decode(h, p["attn"], cfg, c["c"], c["kr"], pos)
    elif spec.window and c["k"].shape[1] == spec.window:
        # ring cache: write slot pos % window; mask slot <= pos is exact
        out, _, _ = L.attn_decode(h, p["attn"], cfg, c["k"], c["v"], pos,
                                  window=None, write_idx=pos % spec.window)
    else:
        out, _, _ = L.attn_decode(h, p["attn"], cfg, c["k"], c["v"], pos,
                                  window=spec.window)
    x = x + out
    if spec.ffn is not None:
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.ffn == "dense":
            x = x + L.dense_ffn(h, p["dense"])
        else:
            y, _ = L.moe_ffn(h, p["moe"], cfg.moe, return_aux=False)
            x = x + y
    return x


def decode_step(params, cfg: ModelConfig, cache, tokens, pos: int):
    """One decode step. tokens (B, 1) int; pos = the absolute position
    being written. Writes ``cache`` in place (the reference returns a new
    one) and returns (logits (B, 1, V), cache)."""
    x = params["embed"][tokens.long()]
    x = constrain(x, "batch", None, None)
    pos = int(pos)
    for si, stage in enumerate(cfg.stages):
        sp, sc = params["stages"][si], cache[si]
        for r in range(stage.repeat):
            lp, lc = _slice(sp, r), _slice(sc, r)
            for j, spec in enumerate(stage.body):
                x = _decode_block(x, lp[f"l{j}"], lc[f"l{j}"], spec, cfg,
                                  pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, _head(params, cfg))
    return logits, cache


def param_logical_axes(cfg: ModelConfig, *, fsdp: bool = False):
    """Logical sharding names per param leaf (resolved in sharding.py), as
    the reference's. ``fsdp=True`` additionally names the first free dim
    of every weight ``fsdp`` (ZeRO-3-style fully-sharded params)."""
    def attn_ax():
        if cfg.mla is not None:
            return {"wq_a": (None, None), "wq_b": (None, "heads", None),
                    "wkv_a": (None, None), "wkv_b_k": (None, "heads", None),
                    "wkv_b_v": (None, "heads", None),
                    "wo": ("heads", None, None)}
        ax = {"wq": (None, "heads", None), "wk": (None, "kv_heads", None),
              "wv": (None, "kv_heads", None), "wo": ("heads", None, None)}
        if cfg.qkv_bias:
            ax.update({"bq": ("heads", None), "bk": ("kv_heads", None),
                       "bv": ("kv_heads", None)})
        return ax

    def ssm_ax():
        return {"in_proj": (None, "ffn"), "conv_w": (None, "ffn"),
                "conv_b": ("ffn",), "dt_bias": ("heads",),
                "A_log": ("heads",), "D": ("heads",), "norm": ("ffn",),
                "out_proj": ("ffn", None)}

    def ffn_ax(kind):
        if kind == "dense":
            return {"wi": (None, "ffn"), "wg": (None, "ffn"),
                    "wo": ("ffn", None)}
        return {"router": (None, None), "wi": ("experts", None, "expert_ffn"),
                "wg": ("experts", None, "expert_ffn"),
                "wo": ("experts", "expert_ffn", None)}

    def layer_ax(spec: LayerSpec):
        ax = {"ln1": (None,)}
        if spec.mixer == "attn":
            ax["attn"] = attn_ax()
        else:
            ax["ssm"] = ssm_ax()
        if spec.ffn is not None:
            ax["ln2"] = (None,)
            ax[spec.ffn] = ffn_ax(spec.ffn)
        return ax

    def prepend_scan(leaf, _):
        # stage params carry a leading repeat dim: never sharded
        return (None,) + tuple(leaf)

    axes: Dict[str, Any] = {"embed": ("vocab", None), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = (None, "vocab")
    if cfg.frontend == "audio":
        axes["frontend"] = {"proj": (None, None)}
    stages = [{f"l{j}": _map(layer_ax(spec), prepend_scan)
               for j, spec in enumerate(stage.body)}
              for stage in cfg.stages]
    if fsdp:
        axes = _map(axes, lambda ax, _: _add_fsdp(ax, start=0))
        stages = _map(stages, lambda ax, _: _add_fsdp(ax, start=1))
    axes["stages"] = stages
    return axes


def _add_fsdp(ax: tuple, start: int) -> tuple:
    """Insert the `fsdp` logical name at the first free (None) dim past any
    leading scan dim; divisibility is checked downstream by maybe_axis."""
    for i in range(start, len(ax)):
        if ax[i] is None:
            return ax[:i] + ("fsdp",) + ax[i + 1:]
    return ax
