"""Serving launcher of the port: ``--mode generate --arch A
--new-tokens T`` decodes 4 prompts through the LM substrate at arch A's
smoke config (``serve_generate``); ``python -m repro_torch.launch.serve
--mode khi`` builds a KHI index on the device (``builder="device"``),
stands up a ``KHIService`` and drives it with a stream of mixed-size
request bursts, as ``repro.launch.serve --mode khi`` does.

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain
PyTorch versions of the kernels on the CPU. ``--backend
pallas_gather_l2_filter`` is the predicate-fused scorer, which on the port
is the hand-written CUDA kernel. ``--quant int8`` (or ``bf16``) serves
from the compressed corpus replica with an exact f32 rerank.
``--backend pallas_gather_l2`` (the CUDA gather without predicate) and
``--backend pallas_l2`` (a PyTorch gather, then the CUDA expansion
kernel) run under ``--strategy graph`` only, as in the reference;
``--router dfs`` routes with the legacy stack DFS, also under ``--strategy
graph`` only. ``--strategy hybrid`` scans each query's small tree nodes as windows
(``--node-scan-threshold`` rows at most) and walks the rest.
``--filter-expr 'a0 >= 3 and (a1 in [1, 4] or not a2 <= 0)'`` also serves
a boolean filter expression through ``KHIService.search_expr`` and checks
the answers against a numpy mask-then-top-k (``--box-budget`` boxes at
most before the bitmask fallback). ``--stream-smoke`` then drives the
streaming write path (insert, delete, query, compact, query again) with
a ``--delta-capacity``-row delta and checks that the answers after the
compaction equal those before it: exactly under ``--strategy scan``,
where every lane is exact, by overlap otherwise. ``--load-smoke`` drives
the SLO scheduler (DESIGN.md §13) with a bursty open-loop replay under
``--inject`` faults, at the policy ``--slo-ms``, ``--qdepth`` and
``--degrade-ladder`` set, and checks its accounting: nothing dropped,
the tiers summing to the served total, the injected faults and retries
reconciled with the injector's log. ``--shards S`` (S > 1) builds the
corpus as S round-robin shards (``build_sharded``) and serves the
stacked index through the same service, every path above included.
``--mesh`` serves the S shards through the collective program
(``make_sharded_search_fn``) on a ``(1, S)`` query mesh, one process a
shard under ``torchrun`` (``env://`` rendezvous): NCCL on
``cuda:LOCAL_RANK``, or gloo with ``--device cpu``. Every rank makes the
same data and queries from the seed, builds the whole sharded index and
serves the same requests in the same order; each then checks its answers
against the one-process fan-out (``search_sharded_emulated``) on the
index it holds, and rank 0 prints. The filter-expression, streaming and
load smokes do not run under ``--mesh``: the service refuses the first
two on a mesh, as the reference does, and the scheduler forms its
batches by arrival time, which differs between ranks.

    torchrun --nproc-per-node 2 -m -- repro_torch.launch.serve --mode khi \
        --n 1500 --d 32 --batch 16 --device cpu --shards 2 --mesh

The ``--`` after ``-m`` keeps torchrun versions whose parser takes
``--n`` and ``--d`` for abbreviations of its own options from reading
the launcher's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def serve_khi(args):
    """Build, serve and smoke-test as the module docstring says; with
    ``--mesh`` inside the rank's process group, which it ends."""
    if not args.mesh:
        return _serve(args, None)
    import torch.distributed as dist

    from repro_torch.launch.mesh import (init_query_process_group,
                                         make_query_mesh)

    for flag in ("filter_expr", "stream_smoke", "load_smoke"):
        if getattr(args, flag):
            raise ValueError(f"--{flag.replace('_', '-')} does not run under "
                             f"--mesh (see the module docstring)")
    init_query_process_group(args.device)
    try:
        snap = _serve(args, make_query_mesh(max(args.shards, 1), 1))
        dist.barrier()
        return snap
    finally:
        dist.destroy_process_group()


def _serve(args, mesh):
    from repro_torch.core import KHIConfig, KHIIndex, SearchParams
    from repro_torch.core.engine import device_put_index
    from repro_torch.core.sharded import (build_sharded,
                                          search_sharded_emulated)
    from repro_torch.core.util import resolve_device
    from repro_torch.data import DatasetSpec, make_dataset, make_queries
    from repro_torch.serve import KHIService, Request, ServeConfig

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    # under a mesh every rank runs this; rank 0 prints
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    S = max(args.shards, 1)
    spec = DatasetSpec("serve", n=args.n, d=args.d, m=3, seed=0,
                       attr_kinds=("year", "lognormal", "uniform"),
                       attr_corr=0.6)
    vecs, attrs = make_dataset(spec)
    cfg = KHIConfig(M=16, builder="device")
    say(f"[serve] building KHI over n={args.n} d={args.d} on {dev} "
        f"shards={S}" + ("" if mesh is None else
                         f" (every rank); collective mesh {mesh.shape} "
                         f"over {mesh.backend}"))
    if S > 1 or mesh is not None:
        index = build_sharded(vecs, attrs, S, cfg, device=dev)
        say(f"[serve] {S} shards of at most {index.di.n} rows; pad waste "
            f"(rows, nodes, levels) "
            f"{tuple(round(w, 4) for w in index.pad_waste)}")
    else:
        index = device_put_index(KHIIndex.build(vecs, attrs, cfg,
                                                device=dev), device=dev)
    params = SearchParams(k=10, ef=args.ef, c_e=10, c_n=16,
                          backend=args.backend,
                          expand_width=args.expand_width,
                          router=args.router, strategy=args.strategy,
                          scan_threshold=args.scan_threshold,
                          quant=args.quant, rerank_mult=args.rerank_mult,
                          node_scan_threshold=args.node_scan_threshold,
                          box_budget=args.box_budget)
    buckets = tuple(sorted({1, 8, args.batch}))
    svc = KHIService(index, params, config=ServeConfig(buckets=buckets),
                     mesh=mesh)

    Q, preds = make_queries(vecs, attrs, n_queries=args.batch * args.iters,
                            sigma=1 / 16, seed=1)
    lo = np.stack([p.lo for p in preds]).astype(np.float32)
    hi = np.stack([p.hi for p in preds]).astype(np.float32)
    # warm up with perturbed copies (same shapes, different cache keys)
    svc.search(Q[: args.batch] + np.float32(1e-3),
               lo[: args.batch], hi[: args.batch])
    reqs = (Request(Q[i], lo[i], hi[i]) for i in range(len(Q)))
    t0 = time.perf_counter()
    results = list(svc.serve_stream(reqs))
    dt = time.perf_counter() - t0
    snap = svc.snapshot()
    say(f"[serve] {len(results)} requests in {dt:.2f}s "
        f"({len(results)/dt:.0f} QPS end-to-end; "
        f"device {snap['device_qps'] and round(snap['device_qps'])} QPS)")
    say(f"[serve] backend={args.backend} E={args.expand_width} "
        f"router={args.router} strategy={args.strategy} "
        f"quant={args.quant} "
        f"batches={snap['batches']} "
        f"scan_lanes={snap['scan_lanes']} pad_lanes={snap['pad_lanes']} "
        f"cache_hits={snap['cache_hits']} "
        f"buckets={snap['traced_buckets']}")
    if mesh is not None:
        # every rank holds the whole index: the one-process fan-out on it
        ids = np.stack([r.ids for r in results])
        dists = np.stack([r.dists for r in results])
        e_ids, e_d, _ = search_sharded_emulated(svc.index, Q, lo, hi,
                                                svc.params)
        if not (np.array_equal(ids, e_ids) and np.array_equal(dists, e_d)):
            raise AssertionError(
                f"rank {mesh.rank}: the collective's answers differ from "
                f"the one-process fan-out's on "
                f"{int((ids != e_ids).any(1).sum())} lanes")
        say(f"[serve] merge={svc._get_search_fn(0).merge} on {S} ranks; "
            f"every rank's answers equal the one-process fan-out's")
    if args.filter_expr:
        filter_expr_smoke(svc, vecs, attrs, Q, args)
        snap = svc.snapshot()
    if args.stream_smoke:
        stream_smoke(svc, vecs, attrs, Q, lo, hi, args)
        snap = svc.snapshot()
    if args.load_smoke:
        load_smoke(svc, Q, lo, hi, args)
        snap = svc.snapshot()
    return snap


def filter_expr_smoke(svc, vecs, attrs, Q, args):
    """Parse ``--filter-expr``, serve it through ``KHIService.search_expr``
    and check the answers against ``brute_force_expr``, the numpy
    mask-then-top-k: every served id passes the filter; under ``--strategy
    scan`` (every lane exact) the ids equal it, otherwise recall >= 0.6."""
    from repro_torch.core.predicate import compile_expr, eval_expr, parse_expr
    from repro_torch.core.query_ref import brute_force_expr

    m = attrs.shape[-1]
    expr = parse_expr(args.filter_expr, m)
    prog = compile_expr(expr, m, box_budget=args.box_budget)
    B = min(16, len(Q))
    k = svc.params.k
    t0 = time.perf_counter()
    ids, _dists = svc.search_expr(Q[:B], expr)
    dt = time.perf_counter() - t0
    mask = eval_expr(expr, attrs)
    hits = total = 0
    for i in range(B):
        ref_ids = brute_force_expr(vecs, attrs, Q[i], expr, k)
        got = ids[i][ids[i] >= 0]
        if not mask[got].all():
            raise AssertionError(f"lane {i}: an id outside the filter was "
                                 f"served")
        if args.strategy == "scan" and got.tolist() != ref_ids.tolist():
            raise AssertionError(f"lane {i}: scan lanes must equal the "
                                 f"mask-then-top-k")
        hits += len(set(got.tolist()) & set(ref_ids.tolist()))
        total += max(len(ref_ids), 1)
    recall = hits / total
    floor = 1.0 if args.strategy == "scan" else 0.6
    if recall < floor:
        raise AssertionError(f"filter-expr recall {recall:.2f} < {floor}")
    snap = svc.snapshot()
    print(f"[serve] filter-expr: {args.filter_expr!r} -> {prog.mode} "
          f"program ({prog.n_boxes} boxes, budget {args.box_budget}); "
          f"{B} queries in {dt * 1e3:.0f}ms, recall {recall:.2f}, "
          f"predicate_lanes={snap['predicate_lanes']}")


def stream_smoke(svc, vecs, attrs, Q, lo, hi, args):
    """The streaming write path (DESIGN.md §11): insert perturbed copies of
    64 rows, delete 16 of them and 16 base rows, query the merged view,
    compact, and query again. Under ``--strategy scan`` the answers after
    the compaction must equal those before it (ids, and distances within
    rtol 1e-5); otherwise more than half the slots must agree (graph
    lanes are approximate)."""
    rng = np.random.default_rng(7)
    svc.enable_streaming(capacity=args.delta_capacity)
    t0 = time.perf_counter()
    sel = rng.choice(len(vecs), size=64, replace=False)
    exts = svc.insert(vecs[sel] + np.float32(1e-3), attrs[sel])
    n_del = svc.delete(np.concatenate([exts[:16], sel[:16]]))
    ingest_dt = time.perf_counter() - t0
    B = min(16, len(Q))
    pre_ids, pre_d = svc.search(Q[:B], lo[:B], hi[:B])
    svc.compact()
    post_ids, post_d = svc.search(Q[:B], lo[:B], hi[:B])
    if args.strategy == "scan":
        if not np.array_equal(post_ids, pre_ids):
            raise AssertionError("scan lanes changed across the compaction")
        np.testing.assert_allclose(post_d, pre_d, rtol=1e-5)
        verdict = "equal"
    else:
        agree = float((post_ids == pre_ids).mean())
        if agree <= 0.5:
            raise AssertionError(f"pre/post-compaction overlap {agree:.2f}")
        verdict = f"overlap {agree:.2f} (graph lanes are approximate)"
    snap = svc.snapshot()
    print(f"[serve] stream-smoke: +{len(exts)} inserts -{n_del} deletes "
          f"in {ingest_dt * 1e3:.0f}ms, compactions={snap['compactions']} "
          f"n_live={snap['n_live']} epoch={snap['epoch']}; "
          f"pre/post-compaction answers {verdict}")


def load_smoke(svc, Q, lo, hi, args):
    """The SLO scheduler under fault injection (DESIGN.md §13): a short
    bursty open-loop replay (a trickle, then half the requests at one
    instant, two tenants) through ``SLOScheduler`` with the ``--inject``
    faults armed, plus one request dead on arrival. Checks that nothing
    is dropped, the tier counts sum to the served total, the dead request
    is ``expired``, the scheduler's injected faults equal the injector's
    ``device_error`` firings, every failed batch got one re-split retry,
    no device error that was not injected occurred, and a transient
    ``device_error@N`` recovered every lane."""
    from repro_torch.serve import (FaultInjector, Rejected, Request,
                                   SchedulerConfig, Served, SLOScheduler,
                                   TierSpec, replay_open_loop)

    injector = FaultInjector.parse(args.inject)
    cfg = SchedulerConfig(qdepth=args.qdepth, slo_ms=args.slo_ms,
                          ladder=TierSpec.parse_ladder(args.degrade_ladder))
    # install the ladder (the scheduler then keeps it) and run every
    # tier's bucket shapes once on throwaway keys before the worker
    # thread starts, so the replay's latencies are the steady state's
    svc.set_tiers([spec.apply(svc.params) for spec in cfg.ladder])
    for t in range(svc.n_tiers):
        for b in svc.config.buckets:
            svc.search(Q[:b] + np.float32(2e-3), lo[:b], hi[:b], tier=t)
    sched = SLOScheduler(svc, cfg, injector=injector, autostart=True)

    n = min(48, len(Q))
    reqs = [Request(Q[i], lo[i], hi[i]) for i in range(n)]
    arrivals = [i * 0.01 for i in range(n // 2)]
    arrivals += [arrivals[-1]] * (n - n // 2)
    tickets = replay_open_loop(
        lambda r: sched.submit(r[1], tenant=f"t{r[0] % 2}"),
        arrivals, list(enumerate(reqs)))
    t_doa = sched.submit(reqs[0], deadline_ms=0)
    snap = sched.shutdown(drain=True)
    recs = [sched.result(t, timeout=0) for t in tickets]

    fired = injector.counts()
    n_served = sum(isinstance(r, Served) for r in recs)
    n_rej = sum(isinstance(r, Rejected) for r in recs)
    doa = sched.result(t_doa, timeout=0)
    checks = [
        (snap["dropped"] == 0, f"silent drop: {snap}"),
        (n_served + n_rej == n, "missing terminal record"),
        (sum(snap["tier_served"].values()) == snap["served"],
         f"tier accounting != served total: {snap}"),
        (isinstance(doa, Rejected) and doa.reason == "expired",
         f"the dead-on-arrival request ended {doa}"),
        (snap["injected_faults"] == fired["device_error"],
         f"scheduler saw {snap['injected_faults']} injected faults, "
         f"injector fired {fired['device_error']}"),
        (snap["retries"] == snap["batch_failures"],
         "every failed batch must get exactly one re-split retry pass"),
        (snap["device_errors"] == 0,
         "device errors that were not injected: " + "; ".join(
             r.detail for r in recs if isinstance(r, Rejected)
             and r.reason == "fault" and "injected" not in r.detail)),
    ]
    if any(s.kind == "device_error" and s.step is not None
           for s in injector.specs):
        checks += [
            (snap["batch_failures"] >= 1, "induced batch failure missed"),
            (all(isinstance(r, Served) for r in recs),
             "transient device_error must recover every lane via re-split: "
             + str([r for r in recs if isinstance(r, Rejected)])),
        ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(msg)
    print(f"[serve] load-smoke: {n + 1} submitted = {snap['served']} served"
          f" + {sum(snap['rejected'].values())} rejected (0 dropped); "
          f"tiers={snap['tier_served']} retries={snap['retries']} "
          f"faults={fired} timeouts={snap['timeouts']} slo={args.slo_ms}ms")


def serve_generate(args):
    """Decode serving of the LM substrate at the arch's smoke config, as
    the reference's ``serve_generate``: random weights from a seeded
    generator, 4 prompts of 32 tokens fed through the decode path
    (teacher-forced, which fills the caches), then ``--new-tokens``
    greedy tokens each. Prints the tokens' shape, tok/s and a sample."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.util import resolve_device
    from repro_torch.models import model as M

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    B, S = 4, 32
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                             dtype=torch.int32, device=dev)
    cache = M.init_cache(cfg, B, S + args.new_tokens, device=dev)
    with torch.no_grad():
        # teacher-forced prefill through the decode path (fills the cache)
        for t in range(S):
            logits, cache = M.decode_step(params, cfg, cache,
                                          prompt[:, t:t + 1], t)
        out = []
        cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for t in range(S, S + args.new_tokens):
            out.append(cur)
            logits, cache = M.decode_step(params, cfg, cache, cur, t)
            cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        gen = torch.cat(out, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"[serve] generated {gen.shape} tokens on {dev}, "
          f"{args.new_tokens * B / dt:.1f} tok/s; sample: {gen[0][:16]}")
    return gen


def main(argv=None):
    from repro_torch.core.engine import BACKENDS, QUANTS, ROUTERS, STRATEGIES

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["khi", "generate"], default="khi")
    ap.add_argument("--arch", default="qwen1.5-4b",
                    help="--mode generate: the architecture (its smoke "
                         "config), one of repro_torch.configs.ARCH_IDS")
    ap.add_argument("--new-tokens", type=int, default=16,
                    help="--mode generate: greedy tokens per prompt")
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--backend", default="pallas_gather_l2_filter",
                    choices=list(BACKENDS),
                    help="scoring backend; the pallas_* backends are the "
                         "CUDA kernels (their plain versions on the CPU); "
                         "pallas_l2 and pallas_gather_l2 need --strategy "
                         "graph")
    ap.add_argument("--expand-width", type=int, default=1,
                    help="frontier width E: pool entries expanded per hop")
    ap.add_argument("--router", default="level", choices=list(ROUTERS),
                    help="Phase-A tree router (level = batched sweep; dfs = "
                         "the legacy stack DFS, graph strategy only)")
    ap.add_argument("--strategy", default="auto", choices=list(STRATEGIES),
                    help="graph | scan | auto (per-query dispatch) | "
                         "hybrid (per-node windowed scan + graph walk)")
    ap.add_argument("--scan-threshold", type=int, default=0,
                    help="auto-dispatch threshold in in-range objects "
                         "(0 = 10%% of the corpus)")
    ap.add_argument("--quant", default="none", choices=list(QUANTS),
                    help="quantized score path: walk and scan a bf16/int8 "
                         "corpus replica and rerank the over-fetched top "
                         "k*rerank_mult exactly in f32")
    ap.add_argument("--rerank-mult", type=int, default=4,
                    help="quantized over-fetch factor before the exact "
                         "f32 rerank")
    ap.add_argument("--node-scan-threshold", type=int, default=0,
                    help="hybrid per-node scan threshold in rows "
                         "(0 = inherit the resolved scan threshold)")
    ap.add_argument("--filter-expr", default="",
                    help="boolean predicate to serve through the predicate "
                         "compiler, e.g. 'a0 >= 2015 and (a1 in [1, 4] or "
                         "a2 > 0.5)', checked against a numpy "
                         "mask-then-top-k")
    ap.add_argument("--box-budget", type=int, default=8,
                    help="max disjoint boxes a compiled predicate may lower "
                         "to before the bitmask fallback")
    ap.add_argument("--stream-smoke", action="store_true",
                    help="also drive the streaming write path: insert, "
                         "delete, compact, re-query")
    ap.add_argument("--delta-capacity", type=int, default=256,
                    help="delta-segment rows for --stream-smoke")
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="default per-request deadline of the SLO scheduler")
    ap.add_argument("--qdepth", type=int, default=64,
                    help="bounded admission-queue depth; over-capacity "
                         "requests get a typed queue_full rejection")
    ap.add_argument("--degrade-ladder", default="ef=16,ef=8+expand_width=1",
                    help="degradation-tier ladder, comma-separated steps of "
                         "+-joined SearchParams overrides, e.g. "
                         "'ef=32,ef=16+expand_width=1'")
    ap.add_argument("--inject", default="",
                    help="fault-injection spec for --load-smoke, e.g. "
                         "'device_error@1,latency:30ms@2' (serve/faults.py "
                         "grammar)")
    ap.add_argument("--load-smoke", action="store_true",
                    help="drive the SLO scheduler with a bursty replay under "
                         "--inject faults and check its no-drop and retry "
                         "accounting")
    ap.add_argument("--shards", type=int, default=1,
                    help="serve a corpus of this many round-robin shards "
                         "(1 = one index)")
    ap.add_argument("--mesh", action="store_true",
                    help="serve the --shards shards through the collective "
                         "program on a (1, shards) query mesh, one rank a "
                         "shard under torchrun (NCCL on the cards, gloo "
                         "with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.mode == "generate":
        return serve_generate(args)
    return serve_khi(args)


if __name__ == "__main__":
    main()
