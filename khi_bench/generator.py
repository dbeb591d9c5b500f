"""Corpus and traffic generator of the benchmark, made on the device from
the run's seed.

Vectors: a clustered Gaussian in a latent space of ``latent_dim``
dimensions whose per-dimension scales fall as ``(i + 1) ** -spectrum_decay``
(the decaying spectrum of real text and video encoders), lifted to ``d``
by a seeded orthonormal map, plus a small isotropic noise of norm
``noise_norm``. Graph search on it behaves as on real embeddings; the
near-isotropic corpus of ``repro_torch.data.synthetic`` does not.

Attributes: a frozen copy of the attribute model of
``repro_torch.data.synthetic`` (``_sample_attr``): every attribute is
driven by a standard normal tied to the object's embedding cluster, with
correlation ``attr_corr``, and shaped as a year, a lognormal count, a
zipf rank or a uniform score.

The deployment's structure, the cluster centres, the lift and each
cluster's attribute latent, is drawn once from the configuration's
``structure_seed``: it is what the deployment is. The run's seed draws
the rows from it and the requests, so that every seed asks the same
amount of work of the program, on other rows and in another order.

Traffic: a query vector is a corpus row displaced inside the latent space
by a Gaussian step whose norm is the corpus's median nearest-neighbour
distance, plus the corpus's isotropic noise. A box constrains every
attribute by a quantile window; its target selectivity is log-uniform over
the mix's range, and one global width multiplier, calibrated on a sample
of rows, turns targets into window widths. Requests come in chunks, each
from its own generator, so a run can draw as many as its window needs and
every request is fresh.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["sub_seed", "Corpus", "make_corpus", "BoxSampler",
           "RequestStream", "sample_attr", "nn_distance"]


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed and the
    stream's tags: the same seed gives the same streams."""
    h = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _gen(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def sample_attr(kind: str, z: torch.Tensor, corr: float,
                gen: torch.Generator) -> torch.Tensor:
    """One attribute column (n,) f32 from the cluster-tied latent ``z``:
    the attribute model of ``repro_torch.data.synthetic._sample_attr``."""
    eps = torch.randn(z.shape, generator=gen, device=z.device,
                      dtype=torch.float64)
    lat = corr * z + math.sqrt(max(1.0 - corr * corr, 0.0)) * eps
    if kind == "lognormal":
        out = torch.exp(1.5 * lat + 6.0)
    elif kind == "year":
        # discrete skewed years 2005..2024, recent years denser
        u = torch.sigmoid(lat)
        out = (2005 + torch.floor(20 * u.sqrt())).clamp(2005, 2024)
    elif kind == "zipf":
        u = torch.sigmoid(lat)
        out = torch.floor(1.0 / (u * 0.999 + 1e-3))
    elif kind == "uniform":
        out = 0.5 * (lat / 3.0 + 1.0).clamp(0.0, 2.0)
    else:
        raise ValueError(f"unknown attribute kind {kind!r}")
    return out.to(torch.float32)


@dataclasses.dataclass
class Corpus:
    vecs: torch.Tensor      # (n, d) f32 on the device
    attrs: torch.Tensor     # (n, m) f32 on the device
    lift: torch.Tensor      # (d, L) f32, orthonormal columns
    scales: torch.Tensor    # (L,) f32 latent per-dimension scales
    nn_dist: float          # median nearest-neighbour distance (L2)
    noise_std: float        # per-dimension std of the isotropic noise


def nn_distance(vecs: torch.Tensor, gen: torch.Generator,
                n_probe: int = 256) -> float:
    """Median over ``n_probe`` seeded rows of the distance to their nearest
    other row, exact (float64 products, blocks of 65,536 rows)."""
    n = vecs.shape[0]
    probe = torch.randperm(n, generator=gen, device=vecs.device)[:n_probe]
    p = vecs[probe].double()
    pn = (p * p).sum(1)
    best = torch.full((p.shape[0],), float("inf"), dtype=torch.float64,
                      device=vecs.device)
    for s in range(0, n, 65536):
        c = vecs[s:s + 65536].double()
        d2 = pn[:, None] + (c * c).sum(1)[None] - 2.0 * (p @ c.T)
        own = (probe >= s) & (probe < s + c.shape[0])
        d2[own.nonzero()[:, 0], probe[own] - s] = float("inf")
        best = torch.minimum(best, d2.min(1).values)
    return float(best.clamp_min(0).sqrt().median())


def make_corpus(cfg: Dict, seed: int, device) -> Corpus:
    """The configuration's corpus from ``seed``, on ``device``, in a few
    large calls. The deployment's structure (cluster centres, the lift,
    each cluster's attribute latent) comes from the configuration's
    ``structure_seed``; the rows (cluster of each object, its place in the
    cluster, its noise and attribute draws) come from ``seed``."""
    n, d, m = int(cfg["n"]), int(cfg["d"]), int(cfg["m"])
    v = cfg["vectors"]
    L, C = int(v["latent_dim"]), int(v["n_clusters"])
    if L > d:
        raise ValueError(f"latent_dim {L} exceeds d = {d}")
    gs = _gen(device, int(cfg["structure_seed"]), "structure")
    scales = (torch.arange(L, device=device, dtype=torch.float32) + 1.0
              ) ** -float(v["spectrum_decay"])
    centres = torch.randn((C, L), generator=gs, device=device) * (
        float(v["cluster_spread"]) * scales)
    lift, _ = torch.linalg.qr(torch.randn((d, L), generator=gs,
                                          device=device, dtype=torch.float64))
    lift = lift.to(torch.float32)
    cluster_z = torch.randn((C,), generator=gs, device=device,
                            dtype=torch.float64)
    g = _gen(device, seed, "corpus")
    assign = torch.randint(0, C, (n,), generator=g, device=device)
    noise_std = float(v["noise_norm"]) / math.sqrt(d)
    vecs = torch.randn((n, d), generator=g, device=device)
    vecs.mul_(noise_std)
    latent = centres[assign] + torch.randn((n, L), generator=g,
                                           device=device) * scales
    vecs.addmm_(latent, lift.T)
    del latent
    z = cluster_z[assign]
    a = cfg["attributes"]
    attrs = torch.stack([sample_attr(kind, z, float(a["attr_corr"]), g)
                         for kind in a["kinds"]], dim=1)
    if attrs.shape[1] != m:
        raise ValueError(f"{cfg['name']}: {attrs.shape[1]} attribute kinds "
                         f"for m = {m}")
    nn = nn_distance(vecs, _gen(device, seed, "nn-probe"))
    return Corpus(vecs=vecs, attrs=attrs.contiguous(), lift=lift,
                  scales=scales, nn_dist=nn, noise_std=noise_std)


class BoxSampler:
    """Boxes that constrain every attribute by a quantile window. A box of
    target selectivity ``s`` gets, on each attribute, a window of quantile
    width ``w = min(1, mult * s ** (1 / m))`` at a centre uniform in
    ``[w / 2, 1 - w / 2]``; its bounds are the attribute's values at the
    window's two quantiles, as ``repro_torch.data.synthetic.
    _calibrate_window`` reads them. ``mult`` is one global multiplier,
    calibrated so that the median of achieved over target selectivity is 1
    on a sample of rows."""

    def __init__(self, attrs: torch.Tensor, sigma_min: float,
                 sigma_max: float):
        self.sorted = torch.sort(attrs, dim=0).values        # (n, m)
        self.n, self.m = attrs.shape
        self.log_lo, self.log_hi = math.log(sigma_min), math.log(sigma_max)
        self.mult = 1.0

    def draw(self, count: int, gen: torch.Generator):
        """(target sigma (count,), window positions (count, m)) f64."""
        dev = self.sorted.device
        u = torch.rand((count,), generator=gen, device=dev,
                       dtype=torch.float64)
        sigma = torch.exp(self.log_lo + (self.log_hi - self.log_lo) * u)
        pos = torch.rand((count, self.m), generator=gen, device=dev,
                         dtype=torch.float64)
        return sigma, pos

    def bounds(self, sigma: torch.Tensor, pos: torch.Tensor,
               mult: Optional[float] = None):
        """(lo, hi) (count, m) f32 of the boxes drawn as (sigma, pos)."""
        mult = self.mult if mult is None else mult
        w = (mult * sigma ** (1.0 / self.m)).clamp(max=1.0)[:, None]
        centre = w / 2 + pos * (1.0 - w)
        q_lo = (centre - w / 2).clamp(0.0, 1.0)
        q_hi = (centre + w / 2).clamp(0.0, 1.0)
        top = self.n - 1
        i_lo = (q_lo * top).long().clamp(0, top)
        i_hi = (q_hi * top).long().clamp(0, top)
        lo = self.sorted.gather(0, i_lo)
        hi = self.sorted.gather(0, i_hi)
        return lo, hi

    @staticmethod
    def selectivity(attrs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    block: int = 64) -> torch.Tensor:
        """Share of ``attrs``' rows inside each box, (count,) f64."""
        out = []
        for s in range(0, lo.shape[0], block):
            a = attrs[None]
            ok = ((a >= lo[s:s + block, None]) & (a <= hi[s:s + block, None])
                  ).all(-1)
            out.append(ok.sum(1).double() / attrs.shape[0])
        return torch.cat(out)

    def calibrate(self, attrs: torch.Tensor, gen: torch.Generator,
                  rows: int, boxes: int, steps: int = 30) -> dict:
        """Set ``mult`` by bisection on its log so that the median of
        log(achieved / target) over ``boxes`` seeded boxes is 0 on
        ``rows`` seeded rows. Returns the calibration's record."""
        n = attrs.shape[0]
        pick = torch.randperm(n, generator=gen, device=attrs.device)[:rows]
        sample = attrs[pick]
        sigma, pos = self.draw(boxes, gen)
        lo_m, hi_m = math.log(1e-3), math.log(1e3)
        for _ in range(steps):
            mid = 0.5 * (lo_m + hi_m)
            lo, hi = self.bounds(sigma, pos, math.exp(mid))
            got = self.selectivity(sample, lo, hi).clamp_min(1.0 / rows)
            if float(torch.log(got / sigma).median()) < 0:
                lo_m = mid
            else:
                hi_m = mid
        self.mult = math.exp(0.5 * (lo_m + hi_m))
        lo, hi = self.bounds(sigma, pos)
        ratio = self.selectivity(sample, lo, hi) / sigma
        return {"mult": self.mult, "rows": int(sample.shape[0]),
                "boxes": boxes,
                "ratio_q": [float(x) for x in torch.quantile(
                    ratio, torch.tensor([0.05, 0.5, 0.95], device=ratio.device,
                                        dtype=ratio.dtype))]}


class RequestStream:
    """The mix's requests, ``chunk`` at a time: chunk ``c`` of stream
    ``tag`` comes from its own generator, so it is the same for one seed
    however many chunks a run draws. Base rows are read from
    ``host_vecs``, the corpus's host copy. Returns host numpy arrays
    (queries (B, d) f32, lo (B, m) f32, hi (B, m) f32)."""

    def __init__(self, corpus: Corpus, host_vecs: np.ndarray,
                 boxes: BoxSampler, traffic: Dict, seed: int,
                 tag: str = "window"):
        self.corpus, self.host_vecs, self.boxes = corpus, host_vecs, boxes
        self.seed, self.tag = seed, tag
        self.chunk = int(traffic["chunk_requests"])
        self.query_step = float(traffic["query_step_nn"]) * corpus.nn_dist
        self.drawn = 0

    def next_chunk(self):
        c = self.corpus
        dev = c.lift.device
        g = _gen(dev, self.seed, "requests", self.tag, self.drawn)
        self.drawn += 1
        B, L = self.chunk, c.scales.shape[0]
        base = torch.randint(0, self.host_vecs.shape[0], (B,), generator=g,
                             device=dev)
        step = torch.randn((B, L), generator=g, device=dev)
        step *= self.query_step / math.sqrt(L)
        q = torch.as_tensor(self.host_vecs[base.cpu().numpy()], device=dev)
        q += step @ c.lift.T
        q += torch.randn(q.shape, generator=g, device=dev) * c.noise_std
        sigma, pos = self.boxes.draw(B, g)
        lo, hi = self.boxes.bounds(sigma, pos)
        return (q.cpu().numpy().astype(np.float32),
                lo.cpu().numpy().astype(np.float32),
                hi.cpu().numpy().astype(np.float32))
