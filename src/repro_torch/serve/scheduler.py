"""SLO-aware serving: async continuous batching with admission control,
deadline degradation and fault recovery (DESIGN.md §13), ported from
``repro.serve.scheduler`` with the same names, stats and records, over
the port's ``KHIService`` and ``SearchParams``.

``KHIService`` (§3) is a *mechanism* — micro-batching, caching, fan-out.
This module is the *policy* layer that keeps that mechanism safe under
real multi-tenant load, where tail latency and overload behavior — not
peak throughput — decide whether the service is usable:

  * **Admission control with backpressure.** The queue has a bounded
    depth (``qdepth``); every request carries a deadline (its own
    ``deadline_ms`` or the configured ``slo_ms``) and a ``tenant``.
    Over-capacity or dead-on-arrival requests are answered *immediately*
    with a typed :class:`Rejected` instead of queuing forever — a full
    queue sheds load at the front door, it never grows without bound.
  * **Continuous batch formation.** Each device step is filled from
    whatever is queued, up to the service's ``max_batch``: round-robin
    across tenants (no tenant starves), oldest-deadline-first within a
    tenant. Formed batches run through the service's existing shape
    buckets, so the scheduler introduces no new batch shapes.
  * **Deadline-aware graceful degradation.** Under backlog the scheduler
    steps batches down the service's degradation-tier ladder
    (``SchedulerConfig.ladder`` of :class:`TierSpec`, installed on the
    service as per-tier ``SearchParams``): queue-depth thresholds pick a
    base tier, a batch whose tightest deadline slack cannot fit the
    tier's EMA batch latency steps further down, and every timed-out
    batch escalates pressure one tier. Answers degrade in *recall*, not
    latency; :class:`Served` records which tier answered.
  * **Fault recovery.** A failed device step (real, or injected via
    ``serve/faults.py``) is retried once after a backoff, *re-split into
    single-lane sub-batches* so only the offending lanes fail — each
    with a typed ``Rejected(reason="fault")`` — while healthy lanes
    still get answers. Batches exceeding ``batch_timeout_ms`` are
    counted and escalate the degradation tier (a blocking device call
    cannot be preempted mid-flight; the timeout is observed post-hoc and
    acts as load-shedding pressure, documented in DESIGN.md §13).
  * **Drain on shutdown.** ``shutdown(drain=True)`` stops admission and
    serves everything queued; ``drain=False`` rejects the remainder with
    ``reason="shutdown"``. Either way every submitted ticket ends in
    exactly one terminal record — nothing is silently dropped, and the
    accounting invariant ``submitted == served + rejected`` is checked
    by ``snapshot()`` and pinned in CI.

Run modes: ``autostart=True`` serves from a background worker thread
(the async serving form); ``autostart=False`` exposes ``pump()`` — one
synchronous batch-formation + execution step — for deterministic tests
and simulations. All device work happens on whichever thread pumps, so
the device programs are never entered concurrently. A failed device
step, a CUDA error included, becomes typed per-lane records here, so a
caller that must not hide a failing kernel reads ``snapshot()
["device_errors"]`` and the non-injected ``Rejected`` details.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.engine import SearchParams
from .faults import FaultInjector, InjectedFault
from .khi_service import KHIService, Request, Result

__all__ = ["TierSpec", "SchedulerConfig", "Served", "Rejected",
           "SLOScheduler", "replay_open_loop", "REJECT_REASONS"]

REJECT_REASONS = ("queue_full", "expired", "fault", "shutdown")

# TierSpec fields that parse as ints from the ladder grammar
_INT_FIELDS = ("ef", "expand_width", "c_e", "c_n", "scan_threshold",
               "node_scan_threshold", "rerank_mult")
_STR_FIELDS = ("quant", "strategy")


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One degradation-ladder step: the ``SearchParams`` fields it
    overrides relative to the service's full-quality tier 0. Grammar
    (the ``--degrade-ladder`` launcher flag): ``"ef=32+expand_width=1"``
    — fields joined by ``+``, ladder steps joined by ``,``."""

    ef: Optional[int] = None
    expand_width: Optional[int] = None
    c_e: Optional[int] = None
    c_n: Optional[int] = None
    scan_threshold: Optional[int] = None
    node_scan_threshold: Optional[int] = None
    rerank_mult: Optional[int] = None
    quant: Optional[str] = None
    strategy: Optional[str] = None

    def apply(self, base: SearchParams) -> SearchParams:
        """``base`` with this tier's overrides, re-clamping the dependent
        caps (``c_e``/``expand_width`` <= ef) so a bare ``ef=`` step
        stays constructible."""
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
              if getattr(self, f.name) is not None}
        ef = kw.get("ef", base.ef)
        if "c_e" not in kw and base.c_e > ef:
            kw["c_e"] = ef
        if "expand_width" not in kw and base.expand_width > ef:
            kw["expand_width"] = ef
        return dataclasses.replace(base, **kw)

    @classmethod
    def parse(cls, text: str) -> "TierSpec":
        kw = {}
        for part in text.split("+"):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition("=")
            if name in _INT_FIELDS:
                kw[name] = int(val)
            elif name in _STR_FIELDS:
                kw[name] = val
            else:
                raise ValueError(
                    f"unknown ladder field {name!r} in {text!r}; expected "
                    f"one of {_INT_FIELDS + _STR_FIELDS}")
        if not kw:
            raise ValueError(f"empty ladder step {text!r}")
        return cls(**kw)

    @classmethod
    def parse_ladder(cls, text: str) -> Tuple["TierSpec", ...]:
        """``"ef=64,ef=32+expand_width=1"`` -> one TierSpec per step."""
        return tuple(cls.parse(t) for t in (text or "").split(",")
                     if t.strip())


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Policy knobs (the mechanism knobs live in ServeConfig)."""

    qdepth: int = 256              # admission-queue bound (backpressure)
    slo_ms: float = 100.0          # default deadline for bare requests
    ladder: Tuple[TierSpec, ...] = ()   # degradation steps past tier 0
    # queue depth at which tier i+1 engages; () derives an even split of
    # qdepth across the ladder (e.g. 2 steps over qdepth 90 -> 30, 60)
    tier_thresholds: Tuple[int, ...] = ()
    max_retries: int = 1           # failed-batch retry passes (re-split)
    retry_backoff_ms: float = 1.0
    batch_timeout_ms: float = 0.0  # 0 disables; post-hoc, escalates tier
    drop_expired: bool = True      # reject already-dead requests unserved

    def __post_init__(self):
        if self.qdepth < 1:
            raise ValueError(f"qdepth must be >= 1, got {self.qdepth}")
        if self.slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {self.slo_ms}")
        if self.max_retries < 0 or self.retry_backoff_ms < 0 \
                or self.batch_timeout_ms < 0:
            raise ValueError("max_retries/retry_backoff_ms/batch_timeout_ms "
                             "must be >= 0")
        if self.tier_thresholds:
            if len(self.tier_thresholds) != len(self.ladder):
                raise ValueError(
                    f"tier_thresholds needs one depth per ladder step "
                    f"({len(self.ladder)}), got {self.tier_thresholds!r}")
            if list(self.tier_thresholds) != sorted(self.tier_thresholds) \
                    or self.tier_thresholds[0] < 1:
                raise ValueError(f"tier_thresholds must be positive and "
                                 f"ascending, got {self.tier_thresholds!r}")

    def resolved_thresholds(self) -> Tuple[int, ...]:
        if self.tier_thresholds or not self.ladder:
            return self.tier_thresholds
        n = len(self.ladder)
        return tuple(max(1, (self.qdepth * (i + 1)) // (n + 1))
                     for i in range(n))


@dataclasses.dataclass
class Served:
    """Terminal record: the request was answered."""

    ticket: int
    result: Result
    tier: int                      # degradation tier that answered (§13)
    tenant: str
    latency_ms: float              # submit -> completion
    retries: int = 0               # survived this many retry passes
    deadline_met: bool = True


@dataclasses.dataclass
class Rejected:
    """Terminal record: the request was NOT answered, and why — a typed
    rejection is the opposite of a silent drop."""

    ticket: int
    reason: str                    # one of REJECT_REASONS
    tenant: str
    detail: str = ""

    def __post_init__(self):
        if self.reason not in REJECT_REASONS:
            raise ValueError(f"unknown reject reason {self.reason!r}; "
                             f"expected one of {REJECT_REASONS}")


@dataclasses.dataclass(order=True)
class _QItem:
    deadline: float
    ticket: int
    req: Request = dataclasses.field(compare=False)
    tenant: str = dataclasses.field(compare=False)
    t_submit: float = dataclasses.field(compare=False)


class SLOScheduler:
    """SLO-aware front-end over a :class:`KHIService` (DESIGN.md §13).

    Construction installs ``config.ladder`` on the service as degradation
    tiers (tier 0 = the service's own params). ``submit`` returns a
    ticket; the terminal record (:class:`Served` or :class:`Rejected`)
    arrives via ``result(ticket)`` / ``take_results()``. With
    ``autostart=True`` a worker thread forms and executes batches
    continuously; with ``autostart=False`` call ``pump()`` yourself.
    """

    def __init__(self, service: KHIService,
                 config: Optional[SchedulerConfig] = None, *,
                 injector: Optional[FaultInjector] = None,
                 autostart: bool = True, clock=time.monotonic,
                 sleep=time.sleep):
        self.service = service
        self.config = config or SchedulerConfig()
        if self.config.ladder:
            want = [spec.apply(service.params)
                    for spec in self.config.ladder]
            # skip the reinstall (and its planners' rebuild) when a previous
            # scheduler already put this exact ladder on the service
            if tuple(want) != service._tier_user[1:]:
                service.set_tiers(want)
        self._thresholds = self.config.resolved_thresholds()
        self._injector = injector
        self._clock = clock
        self._sleep = sleep
        self._cond = threading.Condition()
        self._tenants: Dict[str, List[_QItem]] = {}
        self._rr: "collections.deque[str]" = collections.deque()
        self._depth = 0
        self._next_ticket = 0
        self._done: Dict[int, Union[Served, Rejected]] = {}
        self._accepting = True
        self._draining = False
        self._stopping = False
        self._timeout_pressure = 0
        self._ema_ms: Dict[int, float] = {}
        self.stats = {
            "submitted": 0, "served": 0, "batches": 0, "steps": 0,
            "rejected": collections.Counter(),
            "tier_served": collections.Counter(),
            "batch_failures": 0, "retries": 0, "lane_failures": 0,
            "injected_faults": 0, "device_errors": 0, "timeouts": 0,
            "expired_in_queue": 0, "deadline_breaches": 0,
        }
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self._thread = threading.Thread(target=self._worker,
                                            name="slo-scheduler",
                                            daemon=True)
            self._thread.start()

    # ---------------------------------------------------------- admission
    def submit(self, req: Request, *, deadline_ms: Optional[float] = None,
               tenant: str = "default") -> int:
        """Admit one request; returns its ticket. Admission control runs
        here: a full queue, a dead-on-arrival deadline, or a shut-down
        scheduler produce an immediate typed ``Rejected`` — never an
        unbounded queue."""
        now = self._clock()
        dl_ms = self.config.slo_ms if deadline_ms is None else deadline_ms
        with self._cond:
            ticket = self._next_ticket
            self._next_ticket += 1
            self.stats["submitted"] += 1
            if not self._accepting:
                self._finish(Rejected(ticket, "shutdown", tenant,
                                      detail="submitted after shutdown"))
            elif dl_ms <= 0:
                self._finish(Rejected(ticket, "expired", tenant,
                                      detail="dead on arrival"))
            elif self._depth >= self.config.qdepth:
                self._finish(Rejected(ticket, "queue_full", tenant,
                                      detail=f"qdepth={self.config.qdepth}"))
            else:
                item = _QItem(deadline=now + dl_ms / 1e3, ticket=ticket,
                              req=req, tenant=tenant, t_submit=now)
                heap = self._tenants.setdefault(tenant, [])
                if not heap and tenant not in self._rr:
                    self._rr.append(tenant)
                heapq.heappush(heap, item)
                self._depth += 1
                self._cond.notify_all()
        return ticket

    def _finish(self, rec: Union[Served, Rejected]) -> None:
        """Record a terminal state (lock held by caller)."""
        self._done[rec.ticket] = rec
        if isinstance(rec, Served):
            self.stats["served"] += 1
            self.stats["tier_served"][rec.tier] += 1
            if not rec.deadline_met:
                self.stats["deadline_breaches"] += 1
        else:
            self.stats["rejected"][rec.reason] += 1
        self._cond.notify_all()

    # ------------------------------------------------------ batch formation
    def _form_batch(self, now: float) -> Tuple[List[_QItem], List[_QItem]]:
        """Fill the next device step from the queue (lock held):
        round-robin across tenants, oldest-deadline-first within each.
        Returns (batch, expired) — expired requests are shed here rather
        than burning a device lane on an answer nobody is waiting for."""
        max_b = self.service.config.max_batch
        batch: List[_QItem] = []
        expired: List[_QItem] = []
        while len(batch) < max_b and self._depth > 0:
            while self._rr and not self._tenants.get(self._rr[0]):
                self._rr.popleft()
            if not self._rr:
                break
            tenant = self._rr[0]
            self._rr.rotate(-1)
            item = heapq.heappop(self._tenants[tenant])
            self._depth -= 1
            if self.config.drop_expired and item.deadline < now:
                expired.append(item)
            else:
                batch.append(item)
        return batch, expired

    def _pick_tier(self, depth: int, batch: List[_QItem],
                   now: float) -> int:
        """Degradation policy (§13): queue-depth thresholds pick a base
        tier, timeout pressure escalates it, and a batch whose tightest
        slack cannot fit the candidate tier's EMA latency steps further
        down. Monotone: more backlog never picks a better tier."""
        n_tiers = self.service.n_tiers
        tier = 0
        for i, th in enumerate(self._thresholds):
            if depth >= th:
                tier = i + 1
        tier = min(tier + self._timeout_pressure, n_tiers - 1)
        if batch:
            # drain-time projection: the tightest deadline must survive
            # the WHOLE backlog ahead of it at the candidate tier, not
            # just this one batch — without the multiplier the tail of a
            # burst drain falls back to expensive tiers while the queue
            # is still aging toward its deadlines
            slack_ms = (min(it.deadline for it in batch) - now) * 1e3
            max_b = self.service.config.max_batch
            ahead = max(1, -(-depth // max_b))
            while tier < n_tiers - 1 and \
                    self._ema_ms.get(tier, 0.0) * ahead > max(slack_ms, 0.0):
                tier += 1
        return tier

    # ------------------------------------------------------------ execution
    def _run(self, batch: List[_QItem], tier: int):
        qs = np.stack([it.req.query for it in batch]).astype(np.float32)
        los = np.stack([it.req.lo for it in batch]).astype(np.float32)
        his = np.stack([it.req.hi for it in batch]).astype(np.float32)
        ids, dists, hit = self.service._answer(qs, los, his, tier)
        return ids, dists, hit

    def _deliver(self, batch: List[_QItem], tier: int, ids, dists, hit,
                 retries: int) -> None:
        now = self._clock()
        with self._cond:
            for j, it in enumerate(batch):
                self._finish(Served(
                    ticket=it.ticket,
                    result=Result(ids=ids[j], dists=dists[j],
                                  cached=bool(hit[j])),
                    tier=tier, tenant=it.tenant,
                    latency_ms=(now - it.t_submit) * 1e3, retries=retries,
                    deadline_met=now <= it.deadline))

    def _execute(self, batch: List[_QItem], tier: int) -> None:
        """One device step + the §13 recovery ladder: injected hook ->
        search -> on failure, backoff + ONE re-split retry (single-lane
        sub-batches) -> typed per-lane failure for lanes that still
        fail. Exceptions are caught broadly ON PURPOSE: this is the
        layer that converts any device-step failure into typed per-lane
        results instead of a crashed front-end."""
        tickets = [it.ticket for it in batch]
        with self._cond:
            step = self.stats["steps"]
            self.stats["steps"] += 1
            self.stats["batches"] += 1
        t0 = self._clock()
        try:
            if self._injector is not None:
                self._injector.before_batch(step, tickets)
            ids, dists, hit = self._run(batch, tier)
        except Exception as e:  # noqa: BLE001 — recovery layer, see above
            with self._cond:
                self.stats["batch_failures"] += 1
                kind = ("injected_faults" if isinstance(e, InjectedFault)
                        else "device_errors")
                self.stats[kind] += 1
            self._retry(batch, tier, e)
            return
        self._observe_latency(tier, (self._clock() - t0) * 1e3)
        self._deliver(batch, tier, ids, dists, hit, retries=0)

    def _observe_latency(self, tier: int, elapsed_ms: float) -> None:
        prev = self._ema_ms.get(tier)
        self._ema_ms[tier] = (elapsed_ms if prev is None
                              else 0.7 * prev + 0.3 * elapsed_ms)
        if self.config.batch_timeout_ms \
                and elapsed_ms > self.config.batch_timeout_ms:
            with self._cond:
                self.stats["timeouts"] += 1
                self._timeout_pressure = min(self._timeout_pressure + 1,
                                             self.service.n_tiers - 1)
        else:
            self._timeout_pressure = 0

    def _retry(self, batch: List[_QItem], tier: int, err: Exception) -> None:
        """Bounded recovery: after ``retry_backoff_ms``, re-split the
        failed batch once into single-lane sub-batches — a poisoned lane
        fails alone (typed ``Rejected("fault")``), healthy lanes are
        answered. ``max_retries=0`` fails the whole batch typed."""
        if self.config.max_retries < 1:
            with self._cond:
                for it in batch:
                    self._finish(Rejected(it.ticket, "fault", it.tenant,
                                          detail=str(err)))
            return
        with self._cond:
            self.stats["retries"] += 1
        self._sleep(self.config.retry_backoff_ms / 1e3)
        for it in batch:
            with self._cond:
                step = self.stats["steps"]
                self.stats["steps"] += 1
            try:
                if self._injector is not None:
                    self._injector.before_batch(step, [it.ticket])
                ids, dists, hit = self._run([it], tier)
            except Exception as e2:  # noqa: BLE001 — same recovery contract
                with self._cond:
                    self.stats["lane_failures"] += 1
                    kind = ("injected_faults"
                            if isinstance(e2, InjectedFault)
                            else "device_errors")
                    self.stats[kind] += 1
                    self._finish(Rejected(it.ticket, "fault", it.tenant,
                                          detail=str(e2)))
                continue
            self._deliver([it], tier, ids, dists, hit, retries=1)

    # ------------------------------------------------------------- pumping
    def pump(self) -> int:
        """Form and execute ONE batch synchronously on the caller's
        thread (deterministic mode — requires ``autostart=False``).
        Returns the number of requests retired (served + shed)."""
        if self._thread is not None:
            raise RuntimeError("pump() with a live worker thread would run "
                              "device programs from two threads; construct "
                              "with autostart=False")
        return self._pump_once()

    def _pump_once(self) -> int:
        now = self._clock()
        with self._cond:
            depth = self._depth        # backlog INCLUDING this batch —
            batch, expired = self._form_batch(now)   # what we're facing
            for it in expired:
                self.stats["expired_in_queue"] += 1
                self._finish(Rejected(
                    it.ticket, "expired", it.tenant,
                    detail=f"deadline passed {1e3 * (now - it.deadline):.1f}"
                           f"ms before formation"))
            tier = self._pick_tier(depth, batch, now)
        if batch:
            self._execute(batch, tier)
        return len(batch) + len(expired)

    def _worker(self) -> None:
        while True:
            with self._cond:
                while self._depth == 0 and not (self._draining
                                                or self._stopping):
                    self._cond.wait(timeout=0.05)
                if self._depth == 0:
                    break               # draining/stopping and queue empty
                if self._stopping:
                    break               # remainder is rejected by shutdown
            self._pump_once()

    # ------------------------------------------------------------ lifecycle
    def shutdown(self, *, drain: bool = True, timeout: float = 60.0) -> dict:
        """Stop admission and terminate every in-flight ticket:
        ``drain=True`` serves the queue to empty first, ``drain=False``
        rejects the remainder with ``reason="shutdown"``. Returns the
        final ``snapshot()``; afterwards ``submitted == served +
        rejected`` always holds."""
        with self._cond:
            self._accepting = False
            if drain:
                self._draining = True
            else:
                self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"scheduler worker failed to stop within "
                                   f"{timeout}s")
            self._thread = None
        elif drain:
            while self._pump_once():
                pass
        # reject anything still queued (drain=False, or nothing pumped)
        with self._cond:
            for heap in self._tenants.values():
                while heap:
                    it = heapq.heappop(heap)
                    self._depth -= 1
                    self._finish(Rejected(it.ticket, "shutdown", it.tenant,
                                          detail="queued at shutdown"))
        return self.snapshot()

    # -------------------------------------------------------------- results
    def result(self, ticket: int,
               timeout: Optional[float] = None) -> Union[Served, Rejected]:
        """Block until ``ticket`` reaches a terminal state."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while ticket not in self._done:
                remaining = (None if deadline is None
                             else deadline - self._clock())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"ticket {ticket} not terminal after "
                                       f"{timeout}s")
                self._cond.wait(timeout=remaining if remaining is not None
                                else 0.1)
            return self._done[ticket]

    def wait_all(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted ticket is terminal."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while len(self._done) < self.stats["submitted"]:
                remaining = (None if deadline is None
                             else deadline - self._clock())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"{self.stats['submitted'] - len(self._done)} "
                        f"tickets still in flight after {timeout}s")
                self._cond.wait(timeout=remaining if remaining is not None
                                else 0.1)

    def take_results(self) -> Dict[int, Union[Served, Rejected]]:
        """Pop and return every terminal record accumulated so far."""
        with self._cond:
            out, self._done = self._done, {}
            return out

    def snapshot(self) -> dict:
        """JSON-able accounting snapshot; ``dropped`` MUST be 0 once the
        queue is drained — the §13 no-silent-drop invariant."""
        with self._cond:
            s = dict(self.stats)
            s["rejected"] = {k: int(v) for k, v in
                             sorted(s["rejected"].items())}
            s["tier_served"] = {str(t): int(v) for t, v in
                                sorted(s["tier_served"].items())}
            n_rej = sum(s["rejected"].values())
            s["terminal"] = len(self._done)
            s["queued"] = self._depth
            s["dropped"] = (s["submitted"] - s["served"] - n_rej
                            - self._depth)
            s["ema_ms"] = {str(t): round(v, 3)
                           for t, v in sorted(self._ema_ms.items())}
            s["thresholds"] = list(self._thresholds)
            return s


def replay_open_loop(submit, arrivals: Sequence[float], items, *,
                     clock=time.monotonic, sleep=time.sleep) -> list:
    """Open-loop load replay: fire ``submit(item)`` at the given arrival
    offsets (seconds from start) REGARDLESS of completion — the
    generator never waits for the system, which is what makes measured
    latency honest under overload (a closed loop would self-throttle).
    Returns ``submit``'s return values in arrival order."""
    t0 = clock()
    out = []
    for a, item in zip(arrivals, items):
        lag = a - (clock() - t0)
        if lag > 0:
            sleep(lag)
        out.append(submit(item))
    return out
