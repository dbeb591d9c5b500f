"""The paper's baselines, ported from ``repro.core.baselines``: iRangeGraph
(a segment tree over one attribute, one filtered graph per segment),
Prefiltering (exact masked top-k) and Postfiltering (one graph over all
objects, filtered after the search)."""

from .irange import IRangeGraph  # noqa: F401
from .simple import Postfiltering, Prefiltering  # noqa: F401
