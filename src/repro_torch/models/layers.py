"""Layer primitives: norms, RoPE (incl. M-RoPE), attention variants
(GQA / sliding-window / bidirectional / MLA), dense FFN, MoE. The
counterpart of ``repro.models.layers``, as plain functions on tensors.

Weight layout conventions (the reference's; leading stage axis removed):
  attention: wq (D, H, hd) / wk,wv (D, KV, hd) / wo (H, hd, D)
  mlp:       wi (D, F) wg (D, F) wo (F, D)        (SwiGLU)
  moe:       router (D, E), wi/wg (E, D, Fe), wo (E, Fe, D)
  mla:       wq_a (D, rq) wq_b (rq, H, nope+rope)
             wkv_a (D, rkv + rope) wkv_b_k (rkv, H, nope)
             wkv_b_v (rkv, H, v) wo (H, v, D)

Caches are updated in place (the reference returns new arrays): a decode
step writes one position of each layer's cache and returns the same
tensors, so a step never copies the cache.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import MLAConfig, ModelConfig
from .sharding import constrain

__all__ = ["rms_norm", "rope_angles", "apply_rope", "apply_mrope",
           "attention", "mla_attention", "dense_ffn", "moe_ffn",
           "attn_decode", "mla_decode"]

NEG = -1e30                      # the additive mask's blocked value, in f32


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------- RoPE

def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dim/2), f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope(q, k, positions, theta):
    """Standard RoPE. positions (B, S)."""
    cos, sin = rope_angles(positions, q.shape[-1], theta)
    return (_rotate(q, cos, sin).to(q.dtype),
            _rotate(k, cos, sin).to(k.dtype))


def apply_mrope(q, k, positions3, sections, theta):
    """M-RoPE (Qwen2-VL): positions3 (B, 3, S); ``sections`` are half-dim
    section sizes (t, h, w) summing to head_dim/2. Each frequency band takes
    its angle from the section's positional stream."""
    hd = q.shape[-1]
    cs = [rope_angles(positions3[:, i], hd, theta) for i in range(3)]
    sec = torch.as_tensor(np.repeat(np.arange(3), np.asarray(sections)),
                          device=q.device)                 # (hd/2,)
    cos = torch.stack([c for c, _ in cs], -1)[..., torch.arange(
        sec.numel(), device=q.device), sec]
    sin = torch.stack([s for _, s in cs], -1)[..., torch.arange(
        sec.numel(), device=q.device), sec]
    return (_rotate(q, cos, sin).to(q.dtype),
            _rotate(k, cos, sin).to(k.dtype))


# ---------------------------------------------------------------- attention

def _bias(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, 0.0, NEG).to(torch.float32)


def _mask_bias(S_q: int, S_kv: int, *, causal: bool, window: Optional[int],
               device=None) -> torch.Tensor:
    """(S_q, S_kv) additive bias in f32."""
    qi = torch.arange(S_q, device=device)[:, None]
    ki = torch.arange(S_kv, device=device)[None, :]
    ok = torch.ones((S_q, S_kv), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (ki <= qi)
    if window is not None:
        ok = ok & (ki > qi - window)
    return _bias(ok)


def _sdpa(q, k, v, bias):
    """q (B,S,H,hd), k/v (B,T,KV,hd) with GQA head grouping. The scores are
    cast to f32 before the scale and the bias, the probabilities back to
    v's dtype, as the reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / np.float32(np.sqrt(hd)) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, hd)


# Query blocks above this length are processed by the chunked (blockwise)
# path so the (S x T) score matrix never materializes (exact softmax per
# row; O(q_chunk x T) live scores instead of O(S x T)).
Q_CHUNK = 1024


def _attn_core(q, k, v, *, causal: bool, window: Optional[int],
               q_chunk: int = Q_CHUNK):
    """Dispatch full vs q-chunked attention. Sliding-window layers slice the
    KV stream per block (kv length = q_chunk + window), so local-attention
    FLOPs scale with the window, not the sequence."""
    B, S, H, hd = q.shape
    dev = q.device
    if S <= q_chunk or S % q_chunk != 0:
        return _sdpa(q, k, v, _mask_bias(S, S, causal=causal, window=window,
                                         device=dev))
    nq = S // q_chunk
    outs = []
    if window is not None and causal:
        w = ((window + q_chunk - 1) // q_chunk) * q_chunk  # align slice
        kv_len = q_chunk + w
        kp = F.pad(k, (0, 0, 0, 0, w, 0))
        vp = F.pad(v, (0, 0, 0, 0, w, 0))
        for i in range(nq):
            start = i * q_chunk   # in padded coords the block is at start+w
            ks = kp[:, start:start + kv_len]
            vs = vp[:, start:start + kv_len]
            # absolute positions: query rows start+arange(qc); keys
            # (start - w + arange(kv_len)), negatives = padding
            qpos = start + torch.arange(q_chunk, device=dev)[:, None]
            kpos = start - w + torch.arange(kv_len, device=dev)[None, :]
            ok = (kpos >= 0) & (kpos <= qpos) & (kpos > qpos - window)
            outs.append(_sdpa(q[:, start:start + q_chunk], ks, vs, _bias(ok)))
    else:
        for i in range(nq):
            start = i * q_chunk
            qpos = start + torch.arange(q_chunk, device=dev)[:, None]
            kpos = torch.arange(S, device=dev)[None, :]
            ok = (kpos <= qpos) if causal else torch.ones(
                (1, S), dtype=torch.bool, device=dev)
            outs.append(_sdpa(q[:, start:start + q_chunk], k, v, _bias(ok)))
    return torch.cat(outs, dim=1)


def _qkv(x, p, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def attention(x, p, cfg: ModelConfig, positions, *, window, mrope_pos=None):
    """Full-sequence attention (training / prefill). Returns (out, (k, v))."""
    q, k, v = _qkv(x, p, cfg)
    if cfg.mrope_sections is not None:
        q, k = apply_mrope(q, k, mrope_pos, cfg.mrope_sections, cfg.rope_theta)
    else:
        q, k = apply_rope(q, k, positions, cfg.rope_theta)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, None, None)
    out = _attn_core(q, k, v, causal=not cfg.encoder_only, window=window)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return constrain(out, "batch", None, None), (k, v)


def attn_decode(x, p, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                window, mrope_pos=None, write_idx: Optional[int] = None):
    """One-token decode. x (B, 1, D); cache_k/v (B, T, KV, hd); pos = the
    absolute position (drives RoPE + mask). ``write_idx`` is the cache slot
    to write (defaults to pos; sliding-window layers pass pos % window into
    a window-sized ring cache: RoPE bakes absolute positions into k, so slot
    order is irrelevant, and the mask ``slot <= pos`` is exact for both
    layouts). Writes the caches in place; returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    T = cache_k.shape[1]
    if write_idx is None:
        write_idx = pos
    q, k, v = _qkv(x, p, cfg)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:
        # decode: all three streams advance with the text position
        p3 = posb[:, None, :].expand(B, 3, 1)
        q, k = apply_mrope(q, k, p3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q, k = apply_rope(q, k, posb, cfg.rope_theta)
    cache_k[:, write_idx] = k[:, 0].to(cache_k.dtype)
    cache_v[:, write_idx] = v[:, 0].to(cache_v.dtype)
    ki = torch.arange(T, device=x.device)
    ok = ki <= pos
    if window is not None:
        ok = ok & (ki > pos - window)
    out = _sdpa(q, cache_k, cache_v, _bias(ok)[None, :])
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache_k, cache_v


# ---------------------------------------------------------------- MLA

def _mla_qk(x, p, mla: MLAConfig):
    cq = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])  # (B,S,H,nope+rope)
    q_nope = q[..., :mla.qk_nope_dim]
    q_rope = q[..., mla.qk_nope_dim:]
    ckv_full = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv = ckv_full[..., :mla.kv_lora_rank]
    k_rope = ckv_full[..., mla.kv_lora_rank:]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(mla: MLAConfig):
    return np.float32(1.0 / np.sqrt(mla.qk_nope_dim + mla.qk_rope_dim))


def mla_attention(x, p, cfg: ModelConfig, positions):
    """Training/prefill MLA in the absorbed form: scores live in latent
    space, so the cacheable state is (c_kv, k_rope) only."""
    mla = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qk(x, p, mla)
    # rope on the rope-slices (shared single-head k_rope)
    cos, sin = rope_angles(positions, mla.qk_rope_dim, cfg.rope_theta)
    q_rope = _rotate(q_rope, cos, sin).to(x.dtype)
    k_rope = _rotate(k_rope[..., None, :], cos, sin)[..., 0, :].to(x.dtype)
    # absorb: q_lat (B,S,H,rkv) = q_nope @ wkv_b_k^T
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wkv_b_k"])
    scale = _mla_scale(mla)

    def blk(start, ql, qr):
        scores = (torch.einsum("bshr,btr->bhst", ql, c_kv)
                  + torch.einsum("bshk,btk->bhst", qr, k_rope))
        qpos = start + torch.arange(ql.shape[1], device=x.device)[:, None]
        ok = torch.arange(S, device=x.device)[None, :] <= qpos
        probs = torch.softmax(scores.float() * scale + _bias(ok), dim=-1)
        return torch.einsum("bhst,btr->bshr", probs.to(x.dtype), c_kv)

    qc = 256  # latent scores are (B,H,qc,S) f32: chunk q to bound them
    if S <= qc or S % qc != 0:
        lat = blk(0, q_lat, q_rope)
    else:
        lat = torch.cat([blk(s, q_lat[:, s:s + qc], q_rope[:, s:s + qc])
                         for s in range(0, S, qc)], dim=1)
    out = torch.einsum("bshr,rhv->bshv", lat, p["wkv_b_v"])
    out = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return constrain(out, "batch", None, None), (c_kv, k_rope)


def mla_decode(x, p, cfg: ModelConfig, cache_c, cache_kr, pos: int):
    """Decode with the compressed latent cache, written in place."""
    mla = cfg.mla
    B = x.shape[0]
    T = cache_c.shape[1]
    q_nope, q_rope, c_kv, k_rope = _mla_qk(x, p, mla)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_angles(posb, mla.qk_rope_dim, cfg.rope_theta)
    q_rope = _rotate(q_rope, cos, sin).to(x.dtype)
    k_rope = _rotate(k_rope[..., None, :], cos, sin)[..., 0, :].to(x.dtype)
    cache_c[:, pos] = c_kv[:, 0].to(cache_c.dtype)
    cache_kr[:, pos] = k_rope[:, 0].to(cache_kr.dtype)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wkv_b_k"])
    scores = (torch.einsum("bshr,btr->bhst", q_lat, cache_c)
              + torch.einsum("bshk,btk->bhst", q_rope, cache_kr))
    ok = torch.arange(T, device=x.device) <= pos
    probs = torch.softmax(scores.float() * _mla_scale(mla)
                          + _bias(ok)[None, :], dim=-1)
    lat = torch.einsum("bhst,btr->bshr", probs.to(x.dtype), cache_c)
    out = torch.einsum("bshr,rhv->bshv", lat, p["wkv_b_v"])
    out = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return out, cache_c, cache_kr


# ---------------------------------------------------------------- FFN

def dense_ffn(x, p):
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["wg"]))
    h = h * torch.einsum("bsd,df->bsf", x, p["wi"])
    h = constrain(h, "batch", None, "ffn")
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


def moe_ffn(x, p, moe, *, return_aux: bool = True):
    """Top-k routed MoE with static-capacity slot dispatch, as the
    reference: token-expert assignments sorted by expert (a stable sort,
    so a token's rank within its expert is its order in the batch), each
    expert's first C kept in (E, C, D) slots and the rest dropped, the
    outputs scatter-added back by token (slot E*C is the drop slot). The
    router's top-k breaks equal probabilities toward the lowest expert,
    as ``lax.top_k``."""
    B, S, D = x.shape
    T = B * S
    E, K = moe.n_padded, moe.top_k
    dev = x.device
    xt = x.reshape(T, D)

    # the reference's einsum promotes the activation to the f32 router
    logits = torch.einsum("td,de->te", xt.to(p["router"].dtype),
                          p["router"]).float()
    if moe.n_padded != moe.n_experts:
        # padded experts are dead: -inf logits, never routed to
        logits = torch.where(torch.arange(E, device=dev) < moe.n_experts,
                             logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    srt, order_k = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, experts = srt[:, :K], order_k[:, :K]      # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    C = max(1, int(np.ceil(T * K / E * moe.capacity_factor)))
    flat_e = experts.reshape(-1)                         # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_g = gate_vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)           # group by expert
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    # rank within expert = position - start(expert); each expert's start
    # is where it first appears in the sorted order (a search, not a
    # bincount: its shape does not depend on the data, so the step also
    # runs over fake tensors)
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    rank = torch.arange(T * K, device=dev) - starts[se]
    keep = rank < C                                      # token dropping
    slot = torch.where(keep, se * C + rank, E * C)
    sel_tok = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    sel_tok[slot] = st
    sel_tok = sel_tok[:E * C]
    sel_gate = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    sel_gate[slot] = sg
    sel_gate = sel_gate[:E * C]

    xs = torch.cat([xt, xt.new_zeros((1, D))])[sel_tok].reshape(E, C, D)
    xs = constrain(xs, "experts", None, None)
    h = F.silu(torch.einsum("ecd,edf->ecf", xs, p["wg"]))
    h = h * torch.einsum("ecd,edf->ecf", xs, p["wi"])
    ys = torch.einsum("ecf,efd->ecd", h, p["wo"])
    ys = ys.reshape(E * C, D) * sel_gate[:, None].to(ys.dtype)
    out = ys.new_zeros((T + 1, D)).index_add_(0, sel_tok, ys)[:T]

    if not return_aux:
        return out.reshape(B, S, D), 0.0
    # load-balance + router-z losses (Switch/ST-MoE style)
    # the experts each token routes to (``one_hot(experts).sum(1) > 0``
    # without one_hot's range check, a host sync)
    routed = (experts[..., None] == torch.arange(E, device=dev)).any(1)
    frac_tokens = routed.float().mean(0)
    frac_probs = probs.mean(0)
    aux = (moe.aux_loss_weight * E * (frac_tokens * frac_probs).sum()
           + moe.router_z_weight
           * (torch.logsumexp(logits, dim=-1) ** 2).mean())
    return out.reshape(B, S, D), aux
