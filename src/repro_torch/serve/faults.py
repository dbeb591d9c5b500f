"""Fault injection for the serving stack (DESIGN.md §13), a copy of
``repro.serve.faults``: the port keeps its own, importing nothing of the
reference package.

A service carrying real traffic fails in ways unit tests never exercise:
a device step errors mid-batch, a background compaction stalls the worker,
a kernel takes 100x its usual latency. ``FaultInjector`` makes those
failure modes *injectable and countable* so the scheduler's recovery
contract (retry-with-resplit, typed per-lane failure, timeout pressure —
``serve/scheduler.py``) can be pinned by tests and CI instead of waited
for in production.

The injector sits on the scheduler's device-step boundary: before every
batch the scheduler calls ``before_batch(step, tickets)``, which may

  * sleep (``latency`` / ``stall`` faults — the scheduler's per-batch
    timeout accounting and deadline-expiry rejections see the delay),
  * raise :class:`InjectedFault` (``device_error`` faults — the
    scheduler's retry/resplit path treats it exactly like a real device
    error).

Faults are *consumed*: a spec fires ``count`` times and then disarms, so
a retry of the same batch does not re-trip the ordinal fault that killed
it (lane-poison faults, which model a poisoned input rather than a
transient device error, re-fire for as long as a poisoned lane is
present). Every firing is recorded in ``fired`` — CI asserts the
scheduler's retry counters match it one-for-one.

Spec grammar (the ``--inject`` launcher flag)::

    device_error@2            fail device step 2 (0-based), once
    device_error%7            fail any batch containing ticket 7 (poison)
    latency:50ms@3            sleep 50 ms before step 3
    stall:200ms@5             alias of latency (models a compaction stall)

Multiple specs join with ``,``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence, Tuple

__all__ = ["InjectedFault", "FaultSpec", "FaultInjector"]

_KINDS = ("device_error", "latency", "stall")


class InjectedFault(RuntimeError):
    """Raised by the injector in place of a real device-step failure."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault.

    ``kind``: ``device_error`` | ``latency`` | ``stall``;
    ``step``: device-step ordinal to hit (None = any step);
    ``tickets``: poison set — fire when any of these tickets is in the
    batch (device_error only; poison specs never disarm by count);
    ``ms``: sleep duration for latency/stall; ``count``: firings before
    the spec disarms (ignored for poison specs).
    """

    kind: str
    step: Optional[int] = None
    tickets: Optional[frozenset] = None
    ms: float = 0.0
    count: int = 1

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {_KINDS}")
        if self.kind in ("latency", "stall") and self.ms <= 0:
            raise ValueError(f"{self.kind} fault needs ms > 0, got {self.ms}")
        if self.kind in ("latency", "stall") and self.tickets is not None:
            raise ValueError("latency/stall faults target steps, not lanes")
        if self.step is None and self.tickets is None:
            raise ValueError("fault needs a target: @step or %ticket")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")


def _parse_one(tok: str) -> FaultSpec:
    body = tok.strip()
    step, tickets = None, None
    if "%" in body:
        body, _, t = body.partition("%")
        tickets = frozenset(int(x) for x in t.split("+"))
    elif "@" in body:
        body, _, s = body.partition("@")
        step = int(s)
    kind, _, dur = body.partition(":")
    ms = 0.0
    if dur:
        if not dur.endswith("ms"):
            raise ValueError(f"fault duration must end in 'ms': {tok!r}")
        ms = float(dur[:-2])
    return FaultSpec(kind=kind, step=step, tickets=tickets, ms=ms)


class FaultInjector:
    """Armed fault set + firing log. Thread-compatible: only the
    scheduler worker calls ``before_batch``; readers see a snapshot via
    ``fired`` / ``counts()``."""

    def __init__(self, specs: Sequence[FaultSpec] = (), *,
                 sleep=time.sleep):
        self.specs: List[FaultSpec] = list(specs)
        self._remaining = [s.count for s in self.specs]
        self._sleep = sleep
        self.fired: List[dict] = []

    @classmethod
    def parse(cls, text: str, **kw) -> "FaultInjector":
        """Build from the ``--inject`` grammar (empty string = no faults)."""
        text = (text or "").strip()
        specs = [_parse_one(t) for t in text.split(",") if t.strip()]
        return cls(specs, **kw)

    def _matches(self, i: int, spec: FaultSpec, step: int,
                 tickets: Iterable[int]) -> bool:
        if spec.tickets is not None:
            return any(t in spec.tickets for t in tickets)
        if self._remaining[i] <= 0:
            return False
        return spec.step is None or spec.step == step

    def before_batch(self, step: int, tickets: Sequence[int]) -> None:
        """Called by the scheduler before each device step. Sleeps for
        matching latency/stall faults, then raises :class:`InjectedFault`
        if a device_error fault matches (after recording the firing)."""
        err: Optional[Tuple[FaultSpec, dict]] = None
        for i, spec in enumerate(self.specs):
            if not self._matches(i, spec, step, tickets):
                continue
            rec = dict(kind=spec.kind, step=step,
                       tickets=sorted(int(t) for t in tickets), ms=spec.ms)
            if spec.tickets is None:
                self._remaining[i] -= 1
            if spec.kind in ("latency", "stall"):
                self.fired.append(rec)
                self._sleep(spec.ms / 1e3)
            elif err is None:       # one error per step, latency still runs
                err = (spec, rec)
        if err is not None:
            spec, rec = err
            self.fired.append(rec)
            lanes = ("" if spec.tickets is None
                     else f" (poisoned lanes {sorted(spec.tickets)})")
            raise InjectedFault(
                f"injected device_error at step {step}{lanes}")

    def counts(self) -> dict:
        """Firing totals by kind (what CI reconciles against scheduler
        retry/timeout counters)."""
        out = {k: 0 for k in _KINDS}
        for rec in self.fired:
            out[rec["kind"]] += 1
        return out
