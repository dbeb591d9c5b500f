"""Synthetic RFANNS corpora + selectivity-targeted query workloads.

A numpy copy of ``repro.data.synthetic``: the same spec and seed give the
same arrays in both packages, so the port and the reference are fed
identical corpora and workloads.

The paper evaluates on Youtube / DBLP / MSMarco / LAION — multi-million-item
corpora with real embeddings that are unavailable offline. We generate
scaled-down stand-ins that preserve the properties the algorithms are
sensitive to:

  * clustered embedding geometry (Gaussian mixture; ANN graphs behave very
    differently on uniform vs clustered data),
  * heavy-tailed, *correlated* numeric attributes (views/likes/comments are
    log-normal and correlated; year is discrete-skewed) — the skew is what
    exercises the tree's BL(p) exclusion rule,
  * embedding/attribute correlation knob (objects in the same embedding
    cluster share attribute biases), since the hard "Youtube" behavior comes
    from attribute filters that *do* correlate with embedding locality.

Queries follow the paper §5.1: per-attribute quantile windows calibrated so
the empirical selectivity lands within [sigma*(1-tol), sigma*(1+tol)].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.query_ref import Predicate

__all__ = ["DatasetSpec", "make_dataset", "make_queries", "DATASET_PRESETS"]


@dataclasses.dataclass
class DatasetSpec:
    name: str
    n: int
    d: int
    m: int
    n_clusters: int = 32
    cluster_std: float = 0.35
    attr_kinds: Optional[tuple[str, ...]] = None  # per-attr: "lognormal"|"year"|"uniform"|"zipf"
    attr_corr: float = 0.5   # 0 = attributes independent of embedding cluster
    seed: int = 0


# Scaled-down stand-ins for the paper's four datasets (Table 1).
DATASET_PRESETS: dict[str, DatasetSpec] = {
    # Youtube: 4 attrs (PublishYear, #Views, #Likes, #Comments) — "hard":
    # strong skew + strong attribute/embedding correlation.
    "youtube": DatasetSpec("youtube", n=20_000, d=128, m=4,
                           attr_kinds=("year", "lognormal", "lognormal", "lognormal"),
                           attr_corr=0.85, n_clusters=64, seed=1),
    # DBLP: 4 attrs (PublishYear, #Citations, #References, #Authors)
    "dblp": DatasetSpec("dblp", n=20_000, d=96, m=4,
                        attr_kinds=("year", "lognormal", "lognormal", "zipf"),
                        attr_corr=0.4, seed=2),
    # MSMarco: 5 attrs (#Words, #Chars, #Sentences, #UniqueWords, TFIDF)
    "msmarco": DatasetSpec("msmarco", n=20_000, d=96, m=5,
                           attr_kinds=("lognormal", "lognormal", "lognormal",
                                       "lognormal", "uniform"),
                           attr_corr=0.3, seed=3),
    # LAION: 3 attrs (Width, Height, Similarity)
    "laion": DatasetSpec("laion", n=20_000, d=128, m=3,
                         attr_kinds=("zipf", "zipf", "uniform"),
                         attr_corr=0.2, seed=4),
}


def _sample_attr(kind: str, z: np.ndarray, corr: float,
                 rng: np.random.Generator) -> np.ndarray:
    """z: (n,) standard-normal latent tied to the embedding cluster."""
    n = z.shape[0]
    eps = rng.standard_normal(n)
    lat = corr * z + np.sqrt(max(1.0 - corr * corr, 0.0)) * eps
    if kind == "lognormal":
        return np.exp(1.5 * lat + 6.0)
    if kind == "year":
        # discrete skewed years 2005..2024, recent years denser
        u = 1.0 / (1.0 + np.exp(-lat))
        return (2005 + np.floor(20 * u**0.5)).clip(2005, 2024)
    if kind == "zipf":
        u = 1.0 / (1.0 + np.exp(-lat))
        return np.floor(1.0 / (u * 0.999 + 1e-3))
    if kind == "uniform":
        return 0.5 * (lat / 3.0 + 1.0).clip(0.0, 2.0)
    raise ValueError(f"unknown attr kind {kind!r}")


def make_dataset(spec: DatasetSpec | str):
    """Returns (vecs (n,d) f32, attrs (n,m) f32)."""
    if isinstance(spec, str):
        spec = DATASET_PRESETS[spec]
    rng = np.random.default_rng(spec.seed)
    centers = rng.standard_normal((spec.n_clusters, spec.d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, spec.n_clusters, size=spec.n)
    vecs = centers[assign] + spec.cluster_std * rng.standard_normal(
        (spec.n, spec.d)).astype(np.float32)
    # cluster-tied latent drives the attribute correlation
    cluster_z = rng.standard_normal(spec.n_clusters)
    z = cluster_z[assign]
    kinds = spec.attr_kinds or ("lognormal",) * spec.m
    attrs = np.stack(
        [_sample_attr(kinds[i], z, spec.attr_corr, rng) for i in range(spec.m)],
        axis=1).astype(np.float32)
    return vecs.astype(np.float32), attrs


def _calibrate_window(sorted_vals: np.ndarray, center_u: float,
                      width_u: float) -> tuple[float, float]:
    """Quantile window [center-width/2, center+width/2] -> value bounds."""
    n = len(sorted_vals)
    lo_q = np.clip(center_u - width_u / 2.0, 0.0, 1.0)
    hi_q = np.clip(center_u + width_u / 2.0, 0.0, 1.0)
    lo = sorted_vals[int(lo_q * (n - 1))]
    hi = sorted_vals[int(hi_q * (n - 1))]
    return float(lo), float(hi)


def make_queries(
    vecs: np.ndarray,
    attrs: np.ndarray,
    *,
    n_queries: int,
    sigma: float,
    cardinality: Optional[int] = None,
    tol: float = 0.5,
    seed: int = 0,
    max_tries: int = 64,
    query_noise: float = 0.25,
):
    """Paper §5.1 query generator.

    Query vectors are held-out-style: a random corpus vector plus noise
    (stand-in for "encode 1000 raw objects with the same model").
    Returns (queries (Q, d) f32, predicates list[Predicate]).
    """
    n, m = attrs.shape
    rng = np.random.default_rng(seed)
    base = rng.integers(0, n, size=n_queries)
    queries = (vecs[base]
               + query_noise * rng.standard_normal((n_queries, vecs.shape[1]))
               ).astype(np.float32)

    sorted_cols = [np.sort(attrs[:, j]) for j in range(m)]
    preds: list[Predicate] = []
    for _ in range(n_queries):
        card = cardinality or m
        dims = rng.permutation(m)[:card]
        # per-dim quantile width so the product of marginals ~ sigma,
        # then binary-search a global width multiplier on the joint.
        w0 = sigma ** (1.0 / card)
        centers = rng.uniform(w0 / 2, 1 - w0 / 2, size=card)
        ok_pred = None
        lo_mult, hi_mult = 0.1, 8.0
        for _try in range(max_tries):
            mult = np.sqrt(lo_mult * hi_mult)
            bounds = {}
            for j, c in zip(dims, centers):
                bounds[int(j)] = _calibrate_window(
                    sorted_cols[j], float(c), min(w0 * mult, 1.0))
            pred = Predicate.from_bounds(m, bounds)
            sel = float(pred.matches(attrs).mean())
            if sigma * (1 - tol) <= sel <= sigma * (1 + tol):
                ok_pred = pred
                break
            if sel < sigma:
                lo_mult = mult
            else:
                hi_mult = mult
            ok_pred = pred  # keep the closest so far
        preds.append(ok_pred)
    return queries, preds
