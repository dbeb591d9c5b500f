"""Predicate IR + compiler: boolean filter expressions → fused kernel
plans (DESIGN.md §15), copied from ``repro.core.predicate``.

The port keeps its own copy of this numpy-only module so that it imports
nothing of the JAX package. Only the docstrings differ: the code,
the ``nextafter`` rounding, the canonical ordering and the
``canonical_key`` bytes are the reference's, which
``tests/test_torch_predicate.py`` pins on random expressions. The serving
layer groups requests by ``canonical_key``, so the bytes must match.

The engine's native predicate is ONE conjunctive box ``qlo <= a <= qhi``
(DESIGN.md §3). Real multi-attribute filters are boolean combinations —
AND/OR/NOT, IN-lists, categorical equality, one-sided ranges. This module
is the bridge: a small expression IR, a normalizer, and a lowering step
that compiles any expression onto the machinery the repo already has.

**IR** (frozen dataclasses, arbitrary nesting)::

    Range(attr, lo, hi)   closed interval over attribute ``attr``;
                          None/±inf = unbounded side; lo > hi = empty
    Eq(attr, value)       point equality (sugar for Range(a, v, v))
    In(attr, values)      membership (sugar for an Or of point Ranges)
    And(children) / Or(children) / Not(child)

**Normalization** (``normalize``): desugar ``Eq``/``In`` to ranges, push
``Not`` down to the leaves (De Morgan), eliminate ``Not`` over a range
into the complementary ranges — exact over the f32 attribute domain via
``np.nextafter`` ([lo, hi]ᶜ = [-inf, pred(lo)] ∪ [succ(hi), +inf]; NaN
attrs fail BOTH complements, so tombstones stay invisible through
negation) — then flatten, intersect same-attribute ranges inside every
``And``, constant-fold true/false leaves, dedupe and sort children by
their canonical serialization. The result is negation-free with ranges
as the only leaves; ``normalize`` is idempotent (pinned by tests).

**Lowering** (``compile_expr``): distribute to DNF, intersect every
conjunct into one box, then make the box union DISJOINT by iterated box
subtraction (each subtraction carves ≤ 2m axis-aligned fragments, again
``nextafter``-exact on the f32 grid). Disjointness is what makes the
per-disjunct execution contract trivial: every corpus row satisfies at
most one disjunct, so the cross-disjunct ``_merge_dedup`` merge
(DESIGN.md §12) can never double-count a row. When the disjoint cover
exceeds ``box_budget`` (wide IN-lists, high-arity ORs), lowering falls
back to a dense row-bitmask program: the normalized expression is
evaluated host-side over the corpus attributes into an (n,) mask and
scanned by the bitmask-fused kernel (``kernels.ops.scan_topk_mask``) —
always exact, always a full pass, documented in DESIGN.md §15.

The empty program is the engine's masked empty-box lane (lo=+inf >
hi=-inf — zero routing entries, zero in-range rows, never a crash).

``eval_expr`` is the numpy twin every compiled path is differentially
fuzzed against (tests/test_torch_predicate.py); ``parse_expr`` the small
text grammar behind ``repro_torch.launch.serve --filter-expr``::

    expr  := or ; or := and ("or" and)* ; and := unary ("and" unary)*
    unary := "not" unary | "(" expr ")" | comp
    comp  := a<i> OP num | num OP a<i> | num OP a<i> OP num
             | a<i> "in" "[" num ("," num)* "]"
    OP    := "<=" | ">=" | "<" | ">" | "=="

Strict ``<``/``>`` desugar to closed f32 ranges via ``nextafter``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["Range", "Eq", "In", "And", "Or", "Not", "Expr",
           "validate_expr", "normalize", "eval_expr", "compile_expr",
           "PredicateProgram", "parse_expr", "expr_to_dict",
           "expr_from_dict", "canonical_key", "boxes_disjoint"]

_NEG_INF = float("-inf")
_POS_INF = float("inf")


def _f32(x) -> float:
    """Round a bound onto the f32 grid (attrs are f32; bounds must live
    on the same grid for nextafter complements to be exact)."""
    return float(np.float32(x))


# Strict-bound steps skip the SUBNORMAL band entirely: XLA flushes f32
# subnormals to zero (FTZ) on the scan/kernel compare path, so a bound
# like nextafter(0, +inf) = 1.4e-45 would execute as 0.0 on device while
# the numpy oracle keeps it distinct — breaking the bit-identity
# contract around attribute value 0. Snapping outward to ±tiny (the
# smallest NORMAL f32) keeps device and numpy agreeing exactly for any
# attribute data without subnormal magnitudes (|a| = 0 or >= 1.18e-38 —
# every real attribute domain; documented in DESIGN.md §15).
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _skip_subnormal(y: float, up: bool) -> float:
    if y != 0.0 and abs(y) < _TINY_F32:
        if up:
            return _TINY_F32 if y > 0 else 0.0
        return -_TINY_F32 if y < 0 else 0.0
    return y


def _next_below(x: float) -> float:
    y = float(np.nextafter(np.float32(x), np.float32(-np.inf)))
    return _skip_subnormal(y, up=False)


def _next_above(x: float) -> float:
    y = float(np.nextafter(np.float32(x), np.float32(np.inf)))
    return _skip_subnormal(y, up=True)


@dataclasses.dataclass(frozen=True)
class Range:
    """Closed interval ``lo <= a_attr <= hi``; ``None`` (or ∓inf) leaves
    a side unbounded; ``lo > hi`` is the (legal) empty range."""

    attr: int
    lo: Optional[float] = None
    hi: Optional[float] = None

    def __post_init__(self):
        lo = _NEG_INF if self.lo is None else _f32(self.lo)
        hi = _POS_INF if self.hi is None else _f32(self.hi)
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)

    @property
    def is_empty(self) -> bool:
        return self.lo > self.hi

    @property
    def is_full(self) -> bool:
        return self.lo == _NEG_INF and self.hi == _POS_INF


@dataclasses.dataclass(frozen=True)
class Eq:
    attr: int
    value: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "value", _f32(self.value))


@dataclasses.dataclass(frozen=True)
class In:
    attr: int
    values: Tuple[float, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "values",
                           tuple(_f32(v) for v in self.values))


@dataclasses.dataclass(frozen=True)
class And:
    children: Tuple["Expr", ...] = ()


@dataclasses.dataclass(frozen=True)
class Or:
    children: Tuple["Expr", ...] = ()


@dataclasses.dataclass(frozen=True)
class Not:
    child: Optional["Expr"] = None


Expr = Union[Range, Eq, In, And, Or, Not]

# canonical constant leaves (attr 0 is always valid: m >= 1)
_FALSE = Range(0, _POS_INF, _NEG_INF)
_TRUE = Range(0, _NEG_INF, _POS_INF)


# --------------------------------------------------------------------------
# Validation — actionable rejection of malformed ASTs
# --------------------------------------------------------------------------

def validate_expr(expr, m: int, _path: str = "expr") -> None:
    """Reject a malformed AST with an actionable message naming the bad
    node's path. Checked by every compile entry point and by
    ``engine.validate_search_params(..., expr=)`` (DESIGN.md §15).
    Legal-but-empty constructs (lo > hi ranges) pass — they lower to the
    masked empty-box lane, not an error."""
    if isinstance(expr, Range):
        if not isinstance(expr.attr, (int, np.integer)) \
                or not 0 <= int(expr.attr) < m:
            raise ValueError(
                f"{_path}: Range.attr must be an int in [0, {m}) (the "
                f"index has m={m} attributes), got {expr.attr!r}")
        if np.isnan(expr.lo) or np.isnan(expr.hi):
            raise ValueError(
                f"{_path}: Range bounds must not be NaN (got lo={expr.lo}, "
                f"hi={expr.hi}); use None/±inf for an unbounded side")
        return
    if isinstance(expr, Eq):
        if not isinstance(expr.attr, (int, np.integer)) \
                or not 0 <= int(expr.attr) < m:
            raise ValueError(
                f"{_path}: Eq.attr must be an int in [0, {m}), "
                f"got {expr.attr!r}")
        if not np.isfinite(expr.value):
            raise ValueError(
                f"{_path}: Eq.value must be finite, got {expr.value!r}")
        return
    if isinstance(expr, In):
        if not isinstance(expr.attr, (int, np.integer)) \
                or not 0 <= int(expr.attr) < m:
            raise ValueError(
                f"{_path}: In.attr must be an int in [0, {m}), "
                f"got {expr.attr!r}")
        if not expr.values:
            raise ValueError(
                f"{_path}: In.values must be a non-empty tuple — an "
                f"empty IN-list is almost always a caller bug; write an "
                f"explicit empty Range(attr, lo=1, hi=0) if you mean "
                f"'match nothing'")
        if any(not np.isfinite(v) for v in expr.values):
            raise ValueError(
                f"{_path}: In.values must all be finite, "
                f"got {expr.values!r}")
        return
    if isinstance(expr, (And, Or)):
        kind = type(expr).__name__
        if not expr.children:
            raise ValueError(
                f"{_path}: {kind} needs at least one child (an empty "
                f"{kind} has no defined truth value here — be explicit)")
        for i, c in enumerate(expr.children):
            validate_expr(c, m, f"{_path}.{kind}[{i}]")
        return
    if isinstance(expr, Not):
        if expr.child is None:
            raise ValueError(f"{_path}: Not needs a child expression")
        validate_expr(expr.child, m, f"{_path}.Not")
        return
    raise ValueError(
        f"{_path}: expected a predicate node (Range/Eq/In/And/Or/Not), "
        f"got {type(expr).__name__}: {expr!r}")


# --------------------------------------------------------------------------
# Serialization — the canonical form golden snapshots pin
# --------------------------------------------------------------------------

def _num_to_json(x: float):
    if x == _POS_INF:
        return "inf"
    if x == _NEG_INF:
        return "-inf"
    return float(x)


def _num_from_json(x) -> float:
    if x == "inf":
        return _POS_INF
    if x == "-inf":
        return _NEG_INF
    return float(x)


def expr_to_dict(expr) -> dict:
    """JSON-able dict form (strict JSON: ±inf encode as strings)."""
    if isinstance(expr, Range):
        return {"op": "range", "attr": int(expr.attr),
                "lo": _num_to_json(expr.lo), "hi": _num_to_json(expr.hi)}
    if isinstance(expr, Eq):
        return {"op": "eq", "attr": int(expr.attr),
                "value": _num_to_json(expr.value)}
    if isinstance(expr, In):
        return {"op": "in", "attr": int(expr.attr),
                "values": [_num_to_json(v) for v in expr.values]}
    if isinstance(expr, And):
        return {"op": "and",
                "children": [expr_to_dict(c) for c in expr.children]}
    if isinstance(expr, Or):
        return {"op": "or",
                "children": [expr_to_dict(c) for c in expr.children]}
    if isinstance(expr, Not):
        return {"op": "not", "child": expr_to_dict(expr.child)}
    raise ValueError(f"not a predicate node: {expr!r}")


def expr_from_dict(d: dict):
    op = d.get("op")
    if op == "range":
        return Range(int(d["attr"]), _num_from_json(d["lo"]),
                     _num_from_json(d["hi"]))
    if op == "eq":
        return Eq(int(d["attr"]), _num_from_json(d["value"]))
    if op == "in":
        return In(int(d["attr"]),
                  tuple(_num_from_json(v) for v in d["values"]))
    if op == "and":
        return And(tuple(expr_from_dict(c) for c in d["children"]))
    if op == "or":
        return Or(tuple(expr_from_dict(c) for c in d["children"]))
    if op == "not":
        return Not(expr_from_dict(d["child"]))
    raise ValueError(f"unknown predicate op {op!r}")


def _key(expr) -> str:
    """Deterministic total order over expressions (canonical sort key)."""
    return json.dumps(expr_to_dict(expr), sort_keys=True)


def canonical_key(expr) -> bytes:
    """Stable identity of an expression's *semantics-preserving canonical
    form* — the serving layer's grouping/cache key component."""
    return _key(normalize(expr)).encode()


# --------------------------------------------------------------------------
# Normalization: desugar → NNF (negations eliminated) → canonical form
# --------------------------------------------------------------------------

def _desugar(expr):
    if isinstance(expr, Eq):
        return Range(expr.attr, expr.value, expr.value)
    if isinstance(expr, In):
        vals = sorted(set(expr.values))
        parts = tuple(Range(expr.attr, v, v) for v in vals)
        return parts[0] if len(parts) == 1 else Or(parts)
    if isinstance(expr, And):
        return And(tuple(_desugar(c) for c in expr.children))
    if isinstance(expr, Or):
        return Or(tuple(_desugar(c) for c in expr.children))
    if isinstance(expr, Not):
        return Not(_desugar(expr.child))
    return expr


def _nnf(expr, neg: bool):
    """Push negations to the leaves and eliminate them there: ``Not``
    over a range becomes the complementary range union (f32-exact via
    nextafter; NaN attrs fail both complements — the tombstone lane
    stays invisible through negation)."""
    if isinstance(expr, And):
        kids = tuple(_nnf(c, neg) for c in expr.children)
        return Or(kids) if neg else And(kids)
    if isinstance(expr, Or):
        kids = tuple(_nnf(c, neg) for c in expr.children)
        return And(kids) if neg else Or(kids)
    if isinstance(expr, Not):
        return _nnf(expr.child, not neg)
    # Range leaf
    if not neg:
        return expr
    if expr.is_empty:
        return _TRUE
    parts = []
    if expr.lo != _NEG_INF:
        parts.append(Range(expr.attr, None, _next_below(expr.lo)))
    if expr.hi != _POS_INF:
        parts.append(Range(expr.attr, _next_above(expr.hi), None))
    if not parts:
        return _FALSE                     # ¬(always true)
    return parts[0] if len(parts) == 1 else Or(tuple(parts))


def _canon(expr):
    """Flatten, constant-fold, intersect same-attr ranges inside ANDs,
    dedupe, sort children by canonical key. Idempotent."""
    if isinstance(expr, Range):
        if expr.is_empty:
            return _FALSE
        if expr.is_full:
            return _TRUE
        return expr
    if isinstance(expr, And):
        flat = []
        for c in expr.children:
            c = _canon(c)
            if isinstance(c, And):
                flat.extend(c.children)
            else:
                flat.append(c)
        by_attr: dict = {}
        rest = []
        for c in flat:
            if isinstance(c, Range):
                if c == _FALSE or c.is_empty:
                    return _FALSE
                if c == _TRUE:
                    continue
                lo, hi = by_attr.get(c.attr, (_NEG_INF, _POS_INF))
                by_attr[c.attr] = (max(lo, c.lo), min(hi, c.hi))
            else:
                rest.append(c)
        for a, (lo, hi) in by_attr.items():
            if lo > hi:
                return _FALSE
            r = Range(a, lo, hi)
            if not r.is_full:
                rest.append(r)
        rest = sorted(set(rest), key=_key)
        if not rest:
            return _TRUE
        return rest[0] if len(rest) == 1 else And(tuple(rest))
    if isinstance(expr, Or):
        flat = []
        for c in expr.children:
            c = _canon(c)
            if isinstance(c, Or):
                flat.extend(c.children)
            else:
                flat.append(c)
        kids = []
        for c in flat:
            if c == _TRUE:
                return _TRUE
            if c == _FALSE:
                continue
            kids.append(c)
        kids = sorted(set(kids), key=_key)
        if not kids:
            return _FALSE
        return kids[0] if len(kids) == 1 else Or(tuple(kids))
    raise ValueError(f"non-NNF node reached canonicalization: {expr!r}")


def normalize(expr, m: Optional[int] = None):
    """Canonical negation-free form (module docstring). Validates against
    ``m`` attributes when given. Idempotent: ``normalize(normalize(e)) ==
    normalize(e)`` (golden-pinned)."""
    if m is not None:
        validate_expr(expr, m)
    return _canon(_nnf(_desugar(expr), neg=False))


# --------------------------------------------------------------------------
# Numpy twin evaluator — the differential oracle's mask
# --------------------------------------------------------------------------

def _eval(expr, attrs: np.ndarray) -> np.ndarray:
    if isinstance(expr, Range):
        a = attrs[..., int(expr.attr)]
        return (a >= np.float32(expr.lo)) & (a <= np.float32(expr.hi))
    if isinstance(expr, Eq):
        return attrs[..., int(expr.attr)] == np.float32(expr.value)
    if isinstance(expr, In):
        a = attrs[..., int(expr.attr)]
        out = np.zeros(a.shape, bool)
        for v in expr.values:
            out |= a == np.float32(v)
        return out
    if isinstance(expr, And):
        out = np.ones(attrs.shape[:-1], bool)
        for c in expr.children:
            out &= _eval(c, attrs)
        return out
    if isinstance(expr, Or):
        out = np.zeros(attrs.shape[:-1], bool)
        for c in expr.children:
            out |= _eval(c, attrs)
        return out
    if isinstance(expr, Not):
        return ~_eval(expr.child, attrs)
    raise ValueError(f"not a predicate node: {expr!r}")


def eval_expr(expr, attrs: np.ndarray) -> np.ndarray:
    """attrs (..., m) f32 -> bool (...): the expression's row mask.

    NaN attrs (tombstones, structural padding — kernels/scan_topk.py's
    mask convention) fail EVERY expression, including through ``Not`` —
    the trailing all-finite guard is what makes raw (pre-normalization)
    negations tombstone-safe; normalized expressions are negation-free
    and NaN-fail at every leaf anyway."""
    attrs = np.asarray(attrs, np.float32)
    return _eval(expr, attrs) & ~np.isnan(attrs).any(axis=-1)


# --------------------------------------------------------------------------
# Lowering: DNF → boxes → disjoint boxes (or bitmask fallback)
# --------------------------------------------------------------------------

def _dnf(expr, limit: int):
    """List of conjuncts (each a list of Ranges) or None when the
    distribution exceeds ``limit`` conjuncts (→ bitmask fallback)."""
    if isinstance(expr, Range):
        return [[expr]]
    if isinstance(expr, Or):
        out = []
        for c in expr.children:
            sub = _dnf(c, limit)
            if sub is None:
                return None
            out.extend(sub)
            if len(out) > limit:
                return None
        return out
    if isinstance(expr, And):
        acc = [[]]
        for c in expr.children:
            sub = _dnf(c, limit)
            if sub is None:
                return None
            acc = [a + s for a in acc for s in sub]
            if len(acc) > limit:
                return None
        return acc
    raise ValueError(f"non-NNF node reached DNF: {expr!r}")


def _conjunct_to_box(ranges, m: int):
    """(lo (m,), hi (m,)) f32 or None when the intersection is empty."""
    lo = np.full(m, -np.inf, np.float32)
    hi = np.full(m, np.inf, np.float32)
    for r in ranges:
        a = int(r.attr)
        lo[a] = max(lo[a], np.float32(r.lo))
        hi[a] = min(hi[a], np.float32(r.hi))
    if np.any(lo > hi):
        return None
    return lo, hi


def _box_subtract(a, b):
    """A \\ B as ≤ 2m disjoint boxes (f32-grid exact: carved edges step
    one ulp past B's closed bounds). Returns [A] when disjoint."""
    alo, ahi = a
    blo, bhi = b
    if np.any(np.maximum(alo, blo) > np.minimum(ahi, bhi)):
        return [a]
    frags = []
    clo, chi = alo.copy(), ahi.copy()
    for j in range(alo.shape[0]):
        if clo[j] < blo[j]:
            flo, fhi = clo.copy(), chi.copy()
            fhi[j] = np.float32(_next_below(blo[j]))
            frags.append((flo, fhi))
            clo[j] = blo[j]
        if chi[j] > bhi[j]:
            flo, fhi = clo.copy(), chi.copy()
            flo[j] = np.float32(_next_above(bhi[j]))
            frags.append((flo, fhi))
            chi[j] = bhi[j]
    return frags                          # the (clo, chi) ⊆ B core drops


def _disjointify(boxes, budget: int):
    """Earlier boxes keep their extent; each later box loses every
    already-covered region via iterated subtraction. None when the
    disjoint cover would exceed ``budget`` boxes."""
    out = []
    for box in boxes:
        frags = [box]
        for d in out:
            frags = [f2 for f in frags for f2 in _box_subtract(f, d)]
            if len(out) + len(frags) > budget:
                return None
        out.extend(frags)
        if len(out) > budget:
            return None
    return out


def boxes_disjoint(lo: np.ndarray, hi: np.ndarray) -> bool:
    """True iff no two boxes of the (n, m) cover intersect (closed-box
    semantics) — the invariant golden tests pin."""
    n = lo.shape[0]
    for i in range(n):
        for j in range(i + 1, n):
            if np.all(np.maximum(lo[i], lo[j]) <= np.minimum(hi[i], hi[j])):
                return False
    return True


@dataclasses.dataclass(frozen=True)
class PredicateProgram:
    """One compiled predicate (DESIGN.md §15).

    ``mode="boxes"``: ``lo``/``hi`` are the (n_boxes, m) DISJOINT cover —
    each disjunct executes as a native range box through the full planner
    dispatch (graph/scan/auto/hybrid per disjunct), and the disjunct
    streams merge under the ``_merge_dedup`` best-dist-per-id contract.
    An unsatisfiable expression compiles to ONE empty box (lo=+inf >
    hi=-inf): the engine's masked pad lane, zero entries, zero rows.

    ``mode="bitmask"``: the disjoint cover would exceed ``box_budget`` —
    ``expr`` (normalized) is evaluated host-side into an (n,) row mask
    and answered by the bitmask-fused brute scan, always exact, hops 0,
    f32 score path regardless of the quant tier (the fallback trades the
    compressed replica for unconditional exactness).

    ``n_conjuncts`` is the raw DNF size before disjointification (golden
    snapshots record both)."""

    mode: str                 # "boxes" | "bitmask"
    lo: np.ndarray            # (n_boxes, m) f32 ("bitmask": (0, m))
    hi: np.ndarray
    expr: object              # normalized expression (bitmask eval + keys)
    n_conjuncts: int
    box_budget: int

    @property
    def n_boxes(self) -> int:
        return int(self.lo.shape[0])

    def to_json_dict(self) -> dict:
        return {
            "mode": self.mode,
            "n_boxes": self.n_boxes,
            "n_conjuncts": self.n_conjuncts,
            "box_budget": self.box_budget,
            "normalized": expr_to_dict(self.expr),
            "boxes": [
                {"lo": [_num_to_json(float(v)) for v in self.lo[b]],
                 "hi": [_num_to_json(float(v)) for v in self.hi[b]]}
                for b in range(self.n_boxes)],
        }


def compile_expr(expr, m: int, *, box_budget: int = 8) -> PredicateProgram:
    """expr + m attributes -> PredicateProgram (module docstring).

    The DNF distribution is capped at ``4 * box_budget`` conjuncts and
    the disjoint cover at ``box_budget`` boxes; exceeding either falls
    back to the bitmask program (explicit and tested — never an error)."""
    if box_budget < 1:
        raise ValueError(f"box_budget must be >= 1, got {box_budget}")
    validate_expr(expr, m)
    norm = normalize(expr)
    conj = _dnf(norm, limit=max(4 * box_budget, 16))
    if conj is not None:
        boxes = []
        for ranges in conj:
            box = _conjunct_to_box(ranges, m)
            if box is not None:
                boxes.append(box)
        disjoint = _disjointify(boxes, box_budget)
        if disjoint is not None:
            if not disjoint:
                # unsatisfiable: ONE masked empty-box lane (never a crash)
                lo = np.full((1, m), np.inf, np.float32)
                hi = np.full((1, m), -np.inf, np.float32)
            else:
                # byte-stable cover: sort by bounds bytes
                disjoint.sort(key=lambda b: b[0].tobytes() + b[1].tobytes())
                lo = np.stack([b[0] for b in disjoint])
                hi = np.stack([b[1] for b in disjoint])
            return PredicateProgram(mode="boxes", lo=lo, hi=hi, expr=norm,
                                    n_conjuncts=len(conj),
                                    box_budget=box_budget)
    return PredicateProgram(mode="bitmask",
                            lo=np.zeros((0, m), np.float32),
                            hi=np.zeros((0, m), np.float32), expr=norm,
                            n_conjuncts=-1 if conj is None else len(conj),
                            box_budget=box_budget)


# --------------------------------------------------------------------------
# Text grammar (launch/serve.py --filter-expr)
# --------------------------------------------------------------------------

_TOKEN = re.compile(
    r"\s*(?:(?P<num>[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)"
    r"|(?P<attr>a\d+)"
    r"|(?P<word>and|or|not|in)"
    r"|(?P<sym><=|>=|==|<|>|\(|\)|\[|\]|,))", re.IGNORECASE)


def _tokenize(text: str):
    toks, pos = [], 0
    while pos < len(text):
        mt = _TOKEN.match(text, pos)
        if mt is None:
            raise ValueError(
                f"filter-expr: cannot tokenize {text[pos:pos + 16]!r} at "
                f"offset {pos} (grammar: predicate.py module docstring)")
        pos = mt.end()
        if mt.lastgroup == "num":
            toks.append(("num", float(mt.group("num"))))
        elif mt.lastgroup == "attr":
            toks.append(("attr", int(mt.group("attr")[1:])))
        elif mt.lastgroup == "word":
            toks.append((mt.group("word").lower(), None))
        else:
            toks.append((mt.group("sym"), None))
    toks.append(("end", None))
    return toks


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i][0]

    def take(self, kind=None):
        t, v = self.toks[self.i]
        if kind is not None and t != kind:
            raise ValueError(f"filter-expr: expected {kind!r}, got {t!r} "
                             f"at token {self.i}")
        self.i += 1
        return t, v

    def expr(self):
        out = [self.conj()]
        while self.peek() == "or":
            self.take()
            out.append(self.conj())
        return out[0] if len(out) == 1 else Or(tuple(out))

    def conj(self):
        out = [self.unary()]
        while self.peek() == "and":
            self.take()
            out.append(self.unary())
        return out[0] if len(out) == 1 else And(tuple(out))

    def unary(self):
        if self.peek() == "not":
            self.take()
            return Not(self.unary())
        if self.peek() == "(":
            self.take()
            e = self.expr()
            self.take(")")
            return e
        return self.comp()

    @staticmethod
    def _one_sided(attr: int, op: str, v: float, attr_left: bool):
        # normalize to "attr OP v" orientation
        if not attr_left:
            op = {"<": ">", ">": "<", "<=": ">=", ">=": "<=",
                  "==": "=="}[op]
        if op == "==":
            return Eq(attr, v)
        if op == "<=":
            return Range(attr, None, v)
        if op == ">=":
            return Range(attr, v, None)
        if op == "<":
            return Range(attr, None, _next_below(v))
        return Range(attr, _next_above(v), None)       # ">"

    def comp(self):
        t, v = self.take()
        if t == "num":
            op, _ = self.take()
            if op not in ("<", ">", "<=", ">=", "=="):
                raise ValueError(f"filter-expr: expected a comparison "
                                 f"after number {v}, got {op!r}")
            _, attr = self.take("attr")
            left = self._one_sided(attr, op, v, attr_left=False)
            if self.peek() in ("<", ">", "<=", ">="):   # num OP attr OP num
                op2, _ = self.take()
                _, v2 = self.take("num")
                return And((left, self._one_sided(attr, op2, v2,
                                                  attr_left=True)))
            return left
        if t != "attr":
            raise ValueError(f"filter-expr: expected 'a<i>' or a number, "
                             f"got {t!r} at token {self.i - 1}")
        attr = v
        op, _ = self.take()
        if op == "in":
            self.take("[")
            vals = [self.take("num")[1]]
            while self.peek() == ",":
                self.take()
                vals.append(self.take("num")[1])
            self.take("]")
            return In(attr, tuple(vals))
        if op not in ("<", ">", "<=", ">=", "=="):
            raise ValueError(f"filter-expr: expected a comparison or "
                             f"'in' after a{attr}, got {op!r}")
        _, num = self.take("num")
        return self._one_sided(attr, op, num, attr_left=True)


def parse_expr(text: str, m: Optional[int] = None):
    """Parse the ``--filter-expr`` grammar (module docstring) into the
    IR; validates against ``m`` attributes when given."""
    p = _Parser(_tokenize(text))
    e = p.expr()
    p.take("end")
    if m is not None:
        validate_expr(e, m)
    return e
