"""Mamba2 (SSD, state-space duality) block, chunked matmul form: the
counterpart of ``repro.models.ssm``.

The sequence is split into chunks of length L; within a chunk the
recurrence is expanded into a masked (L x L) "attention-like" product, and
across chunks a small h <- decay * h + states recurrence runs over the
nc = S/L chunks. Decode keeps O(1) state per layer: a conv ring (d_conv - 1,
channels) and the SSM state (heads, head_dim, d_state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import constrain

__all__ = ["ssd_chunked", "mamba_block", "mamba_decode", "mamba_state_shapes"]


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to one dtype first, as
    ``jnp.einsum`` promotes them (a bf16 model's chunk terms meet f32
    decays here)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (..., L) -> (..., L, L) lower-triangular segment sums:
    out[i, j] = sum_{k=j+1..i} dA[k] for i >= j, -inf above diagonal."""
    L = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """x (b,s,h,p); dt (b,s,h) [post-softplus]; A (h,) negative;
    B,C (b,s,g,n). Returns y (b,s,h,p) and final state (b,h,p,n) f32.

    Sequence lengths that don't divide ``chunk`` are zero-padded: padded
    steps have dt = 0, so dA = 0: unit decay and zero state contribution,
    and outputs and the final state are exact. The chunk states and the
    off-diagonal term take each head's own group of B and C, so the result
    equals the recurrence ``mamba_decode`` runs; the reference sums them
    over the heads (ROADMAP F9), which shows once S exceeds one chunk."""
    b, s0, h, p = x.shape
    L = chunk
    pad = (-s0) % L
    if pad:
        def zp(a):
            return F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])
        x, dt, B, C = zp(x), zp(dt), zp(B), zp(C)
    s = s0 + pad
    g, n = B.shape[2], B.shape[3]
    nc = s // L
    rep = h // g

    xc = x.reshape(b, nc, L, h, p)
    dtc = dt.reshape(b, nc, L, h)
    Bc = B.reshape(b, nc, L, g, n)
    Cc = C.reshape(b, nc, L, g, n)
    dA = dtc * A  # (b,nc,L,h)

    # ---- intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA.movedim(-1, -2)))          # (b,nc,h,L,L)
    scores = _einsum("bcign,bcjgn->bcgij", Cc, Bc)
    scores = scores.repeat_interleave(rep, dim=2)           # groups -> heads
    xdt = xc * dtc[..., None]
    y_diag = _einsum("bchij,bcjhp->bcihp",
                          scores * Lmat.to(scores.dtype), xdt)

    # ---- per-chunk states
    dA_cs = torch.cumsum(dA, dim=2)                         # (b,nc,L,h)
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (b,nc,L,h)
    # B and C are per group; each head reads its group's (the reference's
    # labels sum over the repeated axis instead: ROADMAP F9)
    states = _einsum("bclhn,bclhp->bchpn",
                          Bc.repeat_interleave(rep, dim=3),
                          xdt * decay_to_end[..., None])

    # ---- inter-chunk recurrence (an f32 state for stability and one
    # carry dtype whatever the activation dtype)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :]).float()     # (b,nc,h)
    states = states.float()
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, dim=1).to(x.dtype)         # (b,nc,h,p,n)

    # ---- off-diagonal contribution
    decay_in = torch.exp(dA_cs)                             # (b,nc,L,h)
    y_off = _einsum("bclhn,bchpn->bclhp",
                         Cc.repeat_interleave(rep, dim=3), hprevs)
    y_off = y_off * decay_in[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y[:, :s0], hcur


def _conv1d_causal(u, w, bias):
    """u (b, s, ch); w (d_conv, ch) depthwise; causal (left) padding."""
    d_conv = w.shape[0]
    up = F.pad(u, (0, 0, d_conv - 1, 0))
    out = sum(up[:, i:i + u.shape[1], :] * w[i] for i in range(d_conv))
    return out + bias


def _split(t, sizes):
    return torch.split(t, list(sizes), dim=-1)


def _gated_norm(y, z, p, cfg: ModelConfig, dtype):
    """The gated RMSNorm before the out-projection."""
    y = y * F.silu(z)
    var = y.float().square().mean(-1, keepdim=True)
    return (y.float() * torch.rsqrt(var + cfg.norm_eps)
            * (1.0 + p["norm"].float())).to(dtype)


def mamba_block(x, p, cfg: ModelConfig):
    """Full-sequence mamba2 mixer. Returns (y (b,s,D), (conv_state,
    ssm_state))."""
    s = cfg.ssm
    b, S, D = x.shape
    d_inner = s.expand * D
    nh = d_inner // s.head_dim
    gN = s.n_groups * s.d_state
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xin, Bf, Cf, dt = _split(zxbcdt, (d_inner, d_inner, gN, gN, nh))
    conv_in = torch.cat([xin, Bf, Cf], dim=-1)
    conv_out = F.silu(_conv1d_causal(conv_in, p["conv_w"], p["conv_b"]))
    xin, Bf, Cf = _split(conv_out, (d_inner, gN, gN))
    dt = F.softplus(dt + p["dt_bias"])                      # (b,s,nh)
    A = -torch.exp(p["A_log"].float())                      # (nh,)
    xh = xin.reshape(b, S, nh, s.head_dim)
    xh = constrain(xh, "batch", None, "heads", None)
    Bh = Bf.reshape(b, S, s.n_groups, s.d_state)
    Ch = Cf.reshape(b, S, s.n_groups, s.d_state)
    y, hT = ssd_chunked(xh, dt.float(), A, Bh, Ch, s.chunk)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, S, d_inner)
    y = _gated_norm(y, z, p, cfg, x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    if S >= s.d_conv - 1:
        conv_state = conv_in[:, S - (s.d_conv - 1):, :]
    else:
        conv_state = F.pad(conv_in, (0, 0, s.d_conv - 1 - S, 0))
    return constrain(out, "batch", None, None), (conv_state, hT)


def mamba_decode(x, p, cfg: ModelConfig, conv_state, ssm_state):
    """One-token decode. x (b, 1, D); conv_state (b, d_conv-1, ch);
    ssm_state (b, nh, hp, n). Returns (out, (conv_state, ssm_state)), new
    tensors."""
    s = cfg.ssm
    b, _, D = x.shape
    d_inner = s.expand * D
    nh = d_inner // s.head_dim
    gN = s.n_groups * s.d_state
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])[:, 0]
    z, xin, Bf, Cf, dt = _split(zxbcdt, (d_inner, d_inner, gN, gN, nh))
    conv_in = torch.cat([xin, Bf, Cf], dim=-1)              # (b, ch)
    hist = torch.cat([conv_state, conv_in[:, None, :]], dim=1)
    w = p["conv_w"]                                         # (d_conv, ch)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, w) + p["conv_b"])
    xin, Bf, Cf = _split(conv_out, (d_inner, gN, gN))
    dt = F.softplus(dt + p["dt_bias"]).float()              # (b, nh)
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(b, nh, s.head_dim)
    Bh = Bf.reshape(b, s.n_groups, s.d_state)
    Ch = Cf.reshape(b, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    dA = torch.exp(dt * A)                                  # (b, nh)
    upd = (Bh.repeat_interleave(rep, dim=1)[:, :, None, :]  # (b,nh,1,n)
           * (xh * dt[..., None])[..., None])               # (b,nh,hp,n)
    ssm_state = ssm_state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", ssm_state.float(),
                     Ch.repeat_interleave(rep, dim=1).float())
    y = y.to(x.dtype) + xh * p["D"][None, :, None]
    y = _gated_norm(y.reshape(b, d_inner), z, p, cfg, x.dtype)
    out = torch.einsum("be,ed->bd", y, p["out_proj"])[:, None, :]
    return out, (hist[:, 1:, :], ssm_state)


def mamba_state_shapes(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    ch = d_inner + 2 * s.n_groups * s.d_state
    return ((batch, s.d_conv - 1, ch), (batch, nh, s.head_dim, s.d_state))
