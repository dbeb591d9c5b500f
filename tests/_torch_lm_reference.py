"""The reference's Mamba2 SSD with ROADMAP F9 repaired, for the tests that
hold the port's LM substrate to the JAX package.

``repro.models.ssm.ssd_chunked`` labels the repeated group axis of B and C
``g`` in its chunk-state and off-diagonal einsums, so each sums over the
nh repeated copies: the carried state is nh times the recurrence's, and
once a sequence spans more than one chunk ``forward`` leaves its own
``decode_step`` (by 2e-3 on the mamba2 smoke logits at position 16). The
port labels them by head. ``repaired`` is the reference's function with
only those two einsums relabelled; the tests patch it in for the
reference's ``mamba_block`` (and pin the fault with the original)."""

import jax
import jax.numpy as jnp

from repro.models import ssm as jssm

original = jssm.ssd_chunked


def repaired(x, dt, A, B, C, chunk: int):
    b, s0, h, p = x.shape
    L = chunk
    pad = (-s0) % L
    if pad:
        def zp(a):
            return jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
        x, dt, B, C = zp(x), zp(dt), zp(B), zp(C)
    s = s0 + pad
    g, n = B.shape[2], B.shape[3]
    nc = s // L
    rep = h // g
    xc = x.reshape(b, nc, L, h, p)
    dtc = dt.reshape(b, nc, L, h)
    Bc = B.reshape(b, nc, L, g, n)
    Cc = C.reshape(b, nc, L, g, n)
    dA = dtc * A
    Lmat = jnp.exp(jssm._segsum(jnp.moveaxis(dA, -1, -2)))
    scores = jnp.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    scores = jnp.repeat(scores, rep, axis=2)
    xdt = xc * dtc[..., None]
    y_diag = jnp.einsum("bchij,bcjhp->bcihp",
                        scores * Lmat.astype(scores.dtype), xdt)
    dA_cs = jnp.cumsum(dA, axis=2)
    decay_to_end = jnp.exp(dA_cs[:, :, -1:, :] - dA_cs)
    states = jnp.einsum("bclhn,bclhp->bchpn",          # was bclgn
                        jnp.repeat(Bc, rep, axis=3),
                        xdt * decay_to_end[..., None])
    chunk_decay = jnp.exp(dA_cs[:, :, -1, :])

    def step(hprev, inp):
        st, dec = inp
        return hprev * dec[..., None, None] + st, hprev

    h0 = jnp.zeros((b, h, p, n), jnp.float32)
    hT, hprevs = jax.lax.scan(
        step, h0, (jnp.moveaxis(states, 1, 0).astype(jnp.float32),
                   jnp.moveaxis(chunk_decay, 1, 0).astype(jnp.float32)))
    hprevs = jnp.moveaxis(hprevs, 0, 1).astype(x.dtype)
    decay_in = jnp.exp(dA_cs)
    y_off = jnp.einsum("bclhn,bchpn->bclhp",           # was bclgn
                       jnp.repeat(Cc, rep, axis=3), hprevs)
    y_off = y_off * decay_in[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y[:, :s0], hT
