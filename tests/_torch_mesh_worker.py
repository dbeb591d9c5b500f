"""Rank code of ``tests/test_torch_mesh_collective.py``: one spawned
process a rank of a gloo ``(n_data, n_model)`` query mesh on the CPU.

It imports only ``repro_torch``, numpy and torch (a spawned rank never
loads JAX). The parent writes the inputs to an ``.npz``: the JAX
package's stacked indexes (``<tag>__<field>``, tags ``f2``/``f4`` for
the float corpus over 2 / 4 shards, ``g2``/``g4`` for the 1/32 grid),
the raw grid corpus, the queries and boxes. Each rank answers every case
of ``cases()`` through ``make_sharded_search_fn`` (or ``KHIService(mesh=)``)
and writes ``rank<r>.npz`` of ``<case>__ids`` / ``<case>__dists``, then
reports ``(rank, "ok" | "error", traceback)`` on the queue. Every
collective runs under the process group's 60 s timeout."""

from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np

# (strategy, quant) of the float corpus, each under both merges
STRATS = [("graph", "none"), ("scan", "none"), ("scan", "int8"),
          ("auto", "none"), ("auto", "int8"), ("hybrid", "none")]
MERGES = ("halving", "allgather")
FLOAT_CASES = [f"{s}-{q}-{m}" for s, q in STRATS for m in MERGES]
GRID_STRATS = ("graph", "scan", "hybrid")
GRID_CASES = [f"grid-{s}" for s in GRID_STRATS]
FIELDS = ("vecs", "attrs", "nbrs", "left", "right", "dim", "bl", "lo", "hi",
          "start", "count", "order", "root")


def float_params(strategy: str, quant: str = "none"):
    from repro_torch.core.engine import SearchParams
    return SearchParams(k=10, ef=48, c_n=16, strategy=strategy, quant=quant,
                        backend="pallas_gather_l2_filter")


def grid_params(strategy: str):
    from repro_torch.core.engine import SearchParams
    return SearchParams(k=8, ef=32, c_n=16, expand_width=4,
                        strategy=strategy, scan_threshold=60,
                        node_scan_threshold=12,
                        backend="pallas_gather_l2_filter")


def weak_params(strategy: str):
    """A short walk (ef 10, c_n 2, 2 hops) whose answers differ from the
    exact scan's, at an explicit threshold: where a rank dispatched on its
    own shard's bound instead of the group's sum, the answers would
    change."""
    from repro_torch.core.engine import SearchParams
    return SearchParams(k=10, ef=10, c_n=2, max_hops=2, strategy=strategy,
                        scan_threshold=STRADDLE_THR, node_scan_threshold=8,
                        backend="pallas_gather_l2_filter")


STRADDLE_THR = 64
STRADDLE_STRATS = ("auto", "hybrid")


def _index(data, tag: str):
    from repro_torch.core.sharded import sharded_from_stacked
    leaves = {f: data[f"{tag}__{f}"] for f in FIELDS}
    return sharded_from_stacked(leaves, data[f"{tag}__offsets"],
                                device="cpu")


def cases(mesh, data) -> dict:
    """Every case's (ids, dists) on this rank, as numpy."""
    from repro_torch.core.engine import with_quant_replica
    from repro_torch.core.khi import KHIConfig, KHIIndex
    from repro_torch.core.sharded import (make_sharded_search_fn,
                                          stack_shards)
    from repro_torch.distributed.elastic import elastic_reshard
    from repro_torch.serve import KHIService

    S = mesh.n_model
    out = {}

    def put(name, res):
        out[f"{name}__ids"] = res[0].numpy()
        out[f"{name}__dists"] = res[1].numpy()

    sk = _index(data, f"f{S}")
    Q, lo, hi = data["Q"], data["lo"], data["hi"]
    for strategy, quant in STRATS:
        skq = sk if quant == "none" else dataclasses.replace(
            sk, di=with_quant_replica(sk.di, quant))
        for merge in MERGES:
            fn = make_sharded_search_fn(float_params(strategy, quant), mesh,
                                        skhi=skq, on_undersized="adjust",
                                        merge=merge)
            assert fn.merge == merge
            put(f"{strategy}-{quant}-{merge}", fn(skq, Q, lo, hi))
    # the data rows take different branches: wide boxes in the first
    # half (graph), tiny ones in the second (scan)
    fn = make_sharded_search_fn(float_params("auto"), mesh, skhi=sk,
                                on_undersized="adjust")
    put("mixed", fn(sk, Q, data["mixed_lo"], data["mixed_hi"]))
    # boxes whose shards' bounds each stay under the threshold while
    # their sum passes it
    for strategy in STRADDLE_STRATS:
        fn = make_sharded_search_fn(weak_params(strategy), mesh, skhi=sk,
                                    on_undersized="adjust")
        put(f"straddle-{strategy}", fn(sk, data["straddle_Q"],
                                       data["straddle_lo"],
                                       data["straddle_hi"]))
    svc = KHIService(sk, float_params("auto"), mesh=mesh)
    ids, dists = svc.search(Q, lo, hi)
    out["service__ids"], out["service__dists"] = ids, dists
    out["service__batches"] = np.asarray(svc.snapshot()["batches"])

    gk = _index(data, f"g{S}")
    Qg, glo, ghi = data["Qg"], data["glo"], data["ghi"]
    for strategy in GRID_STRATS:
        fn = make_sharded_search_fn(grid_params(strategy), mesh, skhi=gk,
                                    on_undersized="adjust")
        put(f"grid-{strategy}", fn(gk, Qg, glo, ghi))

    # elastic round trip on the grid: the port's device builder (equal to
    # the JAX package's there) builds the shards, shard 1's host is lost
    # and elastic_reshard rebuilds it; answers before and after
    vecs, attrs = data["grid_vecs"], data["grid_attrs"]
    cfg = KHIConfig(M=8, builder="device")
    own = np.arange(len(vecs)) % S
    built = {s: KHIIndex.build(vecs[own == s], attrs[own == s], cfg,
                               device="cpu") for s in range(S)}
    before = stack_shards([built[s] for s in range(S)], device="cpu")
    fn = make_sharded_search_fn(grid_params("graph"), mesh, skhi=before,
                                on_undersized="adjust")
    put("elastic-before", fn(before, Qg, glo, ghi))
    survivors = {s: ix for s, ix in built.items() if s != 1}
    rebuilt = elastic_reshard(vecs, attrs, survivors, S, S, cfg,
                              device="cpu")
    after = stack_shards([rebuilt[s] for s in range(S)], device="cpu")
    put("elastic", fn(after, Qg, glo, ghi))

    # a rank out of step (rank 0 sends 12 lanes, the others 8): the
    # batch's agreement check raises on every rank instead of hanging
    fn = make_sharded_search_fn(grid_params("scan"), mesh, skhi=gk,
                                on_undersized="adjust")
    b = 12 if mesh.rank == 0 else 8
    try:
        fn(gk, Qg[:b], glo[:b], ghi[:b])
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    out["desync__raised"] = np.asarray("disagree" in raised)
    return out


def run(rank: int, world: int, n_data: int, n_model: int, npz: str,
        init_file: str, out_dir: str, queue) -> None:
    import torch
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        from repro_torch.launch.mesh import (init_query_process_group,
                                             make_query_mesh)
        init_query_process_group("cpu", init_method=f"file://{init_file}",
                                 rank=rank, world_size=world, timeout_s=60)
        mesh = make_query_mesh(n_model, n_data, device="cpu")
        with np.load(npz) as f:
            data = {k: f[k] for k in f.files}
        res = cases(mesh, data)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        queue.put((rank, "ok", ""))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
