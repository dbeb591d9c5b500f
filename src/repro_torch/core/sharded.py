"""Corpus-sharded KHI, ported from ``repro.core.sharded`` (DESIGN.md §2
"Distribution", §14).

S independent KHI shards, shard s holding the objects whose global id is
``≡ s (mod S)`` (round-robin), each built over its own n/S objects.
Every shard answers top-k over its local ids; ``_local_to_global`` maps
local id j of shard s to ``j * S + s`` and ``_merge_topk`` merges the S
lists into the global answer. The per-shard indexes are padded to common
shapes (``device_put_index``'s ``pad_n`` / ``pad_nodes`` / ``pad_height``)
and stacked on a leading shard axis into one ``DeviceIndex``;
``ShardedKHI.pad_waste`` records what the padding costs.

``search_sharded_emulated`` is the reference's single-device fan-out: the
graph strategy returns per-shard hops (S, B); any other strategy goes
through an ``engine.Planner``, which fans every program out the same way
and returns per-query hops (B,), the max over shards for graph lanes and
0 for exact lanes.

``make_sharded_search_fn`` is the collective form over
``torch.distributed`` (one process a rank, ranks laid out by
``launch.mesh.make_query_mesh``): model rank s serves shard s, each data
row takes a slice of the batch, and every strategy and quant tier runs
as one program a rank with the planner's dispatch inside it: ``auto``
sums the shards' ``route_level_card`` bounds over the model group,
``hybrid`` their ``route_level_windows`` counts, so every rank of a
group takes the same branch. The shards' answers merge by an all-gather
(``_merge_topk``) or by recursive halving (``_merge_topk_halving``:
log2 S pairwise rounds, partner ``s ^ 2^r``, each entry carrying its
flat ``shard·k + rank`` tie key), which gives ``_merge_topk``'s answer
bit for bit. The answers equal ``search_sharded_emulated``'s.

The reference's ``shard_map`` program keeps every collective outside the
dispatch branches; here the same rule is what keeps the ranks in step:
the merges run unconditionally on every rank, the gates come only from
all-reduced quantities, and each batch starts with an all-reduce that
checks every rank called with the same batch size and program, so a
rank out of step raises instead of hanging (NCCL and gloo hang on a
collective that one rank skips).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .engine import (DEFAULT_SCAN_FRAC, DeviceIndex, Planner, SearchParams,
                     _REPLICA_DTYPE, _lexsort2, _local_to_global,
                     _merge_dedup_jnp, _merge_topk, _scan_shard_topk,
                     _shard_counts, _shard_search, _windows_one,
                     _with_replica_for, device_put_index,
                     resolve_scorer_pair, validate_search_params)
from .khi import KHIConfig, KHIIndex
from .router import route_level_card, route_level_windows
from .util import pow2_at_least, resolve_device

# ``_local_to_global``, ``_merge_topk`` and ``_shard_search`` live in
# engine.py, whose Planner runs them, and are this module's names too, as
# in the reference.

__all__ = ["ShardedKHI", "build_sharded", "stack_shards",
           "sharded_from_stacked", "make_sharded_search_fn",
           "merge_bytes_per_device", "sharded_input_specs",
           "search_sharded_emulated"]


@dataclasses.dataclass
class ShardedKHI:
    """A shard-stacked ``DeviceIndex`` (every tensor with a leading shard
    axis, one root per shard) and the shard ids. ``pad_waste`` is the
    fraction of the stacked slots that are padding, per plane: (rows,
    nodes, levels)."""

    di: DeviceIndex
    offsets: torch.Tensor    # (S,) int64: shard s's id, s
    pad_waste: tuple = ()

    @property
    def num_shards(self) -> int:
        return int(self.offsets.shape[0])


def _pad_waste(ns, ps, hs) -> tuple:
    S = len(ns)
    return (1.0 - sum(ns) / (S * max(ns)), 1.0 - sum(ps) / (S * max(ps)),
            1.0 - sum(hs) / (S * max(hs)))


def _view_one(di: DeviceIndex) -> ShardedKHI:
    """One DeviceIndex as a one-shard ShardedKHI: a view (``unsqueeze``,
    no copy). Its own padding is not known here, so ``pad_waste`` stays
    empty."""
    fields = {f.name: None if getattr(di, f.name) is None else
              getattr(di, f.name).unsqueeze(0)
              for f in dataclasses.fields(DeviceIndex) if f.name != "root"}
    return ShardedKHI(di=DeviceIndex(**fields, root=(int(di.root),)),
                      offsets=torch.arange(1, device=di.device))


def stack_shards(shards: Sequence, *, device=None) -> ShardedKHI:
    """Pad per-shard host indexes (``KHIIndex`` of either package) to
    common shapes and stack them into one ShardedKHI on ``device``
    (default ``cuda``); shard s holds the objects with global id ≡ s mod
    S, the contract ``_local_to_global`` inverts. One shard that is
    already a ``DeviceIndex`` becomes a one-shard view on its device
    (``device`` is not used)."""
    if any(isinstance(ix, DeviceIndex) for ix in shards):
        if len(shards) != 1:
            raise ValueError("stack_shards takes a DeviceIndex alone (a "
                             "one-shard view); pass host indexes to pad "
                             "and stack several")
        return _view_one(shards[0])
    dev = resolve_device(device)
    ns = [int(ix.vecs.shape[0]) for ix in shards]
    ps = [int(ix.tree.num_nodes) for ix in shards]
    hs = [int(ix.nbrs.shape[0]) for ix in shards]
    dis = [device_put_index(ix, device=dev, pad_n=max(ns),
                            pad_nodes=max(ps), pad_height=max(hs))
           for ix in shards]
    fields = {f.name: None if getattr(dis[0], f.name) is None else
              torch.stack([getattr(d, f.name) for d in dis])
              for f in dataclasses.fields(DeviceIndex) if f.name != "root"}
    di = DeviceIndex(**fields, root=tuple(d.root for d in dis))
    return ShardedKHI(di=di, offsets=torch.arange(len(shards), device=dev),
                      pad_waste=_pad_waste(ns, ps, hs))


_DTYPES = {"attrs": torch.float32,
           "nbrs": torch.int32, "lo": torch.float32, "hi": torch.float32,
           "qscale": torch.float32}


def sharded_from_stacked(leaves: dict, offsets, pad_waste=(), *,
                         device=None) -> ShardedKHI:
    """A ShardedKHI from stacked host arrays, as the JAX package's
    ``ShardedKHI`` holds them: ``leaves`` maps each ``DeviceIndex`` field
    to its (S, ...) numpy array (``nbrs`` (S, n, H, M), ``root`` (S,);
    ``vecs`` f32, or bf16 where the array is bf16; ``qvecs`` / ``qscale``
    optional, a bf16 replica as any float array),
    with the shard ids ``offsets`` and the reference's ``pad_waste``."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(DeviceIndex):
        a = leaves.get(f.name)
        if f.name == "root":
            kw["root"] = tuple(int(r) for r in np.asarray(a).ravel())
        elif a is None:
            kw[f.name] = None
        elif f.name in ("vecs", "qvecs"):
            a = np.array(a)
            if a.dtype == np.int8:
                dt = torch.int8
            elif f.name == "qvecs" or a.dtype.name == "bfloat16":
                dt = torch.bfloat16
            else:
                dt = torch.float32
            kw[f.name] = torch.as_tensor(
                a if dt == torch.int8 else a.astype(np.float32)).to(
                    device=dev, dtype=dt)
        else:
            kw[f.name] = torch.as_tensor(np.array(a)).to(
                device=dev, dtype=_DTYPES.get(f.name, torch.int64))
    return ShardedKHI(di=DeviceIndex(**kw),
                      offsets=torch.as_tensor(np.array(offsets)).to(
                          device=dev, dtype=torch.int64),
                      pad_waste=tuple(float(w) for w in pad_waste))


def build_sharded(vecs: np.ndarray, attrs: np.ndarray, n_shards: int,
                  config: Optional[KHIConfig] = None, *,
                  device=None) -> ShardedKHI:
    """Round-robin partition, one build per shard on ``device`` (default
    ``cuda``; ``KHIConfig(builder="device")`` unless a config is given),
    then ``stack_shards``."""
    config = config or KHIConfig(builder="device")
    dev = resolve_device(device)
    shard_of = np.arange(vecs.shape[0]) % n_shards
    shards = []
    for s in range(n_shards):
        ids = np.nonzero(shard_of == s)[0]
        shards.append(KHIIndex.build(vecs[ids], attrs[ids], config,
                                     device=dev))
    return stack_shards(shards, device=dev)


def search_sharded_emulated(skhi: ShardedKHI, queries, qlo, qhi,
                            params: SearchParams, *, dist_fn=None,
                            on_undersized: str = "adjust"):
    """The whole sharded search in one process -> numpy (ids (B, k)
    int32, dists (B, k) f32, hops). Under ``strategy="graph"`` ``hops``
    is per shard, (S, B); any other strategy goes through a ``Planner``
    and ``hops`` is (B,). Index-dependent buffer bounds are raised to
    what the index needs by default."""
    if params.strategy != "graph":
        planner = Planner(skhi, params, dist_fn=dist_fn,
                          on_undersized=on_undersized)
        ids, dists, hops, _ = planner.search(np.asarray(queries),
                                             np.asarray(qlo),
                                             np.asarray(qhi))
        return ids, dists, hops
    params = validate_search_params(params, skhi.di,
                                    on_undersized=on_undersized)
    di = _with_replica_for(skhi.di, params.quant)
    scorer, exact = resolve_scorer_pair(params, dist_fn=dist_fn)
    q, lo, hi = [torch.as_tensor(np.asarray(a, np.float32)).to(di.device)
                 for a in (queries, qlo, qhi)]
    gids, dists, hops = _shard_search(di, q, lo, hi, params, scorer, exact)
    mi, md = _merge_topk(gids, dists, params.k)
    return (mi.to(torch.int32).cpu().numpy(), md.cpu().numpy(),
            hops.to(torch.int32).cpu().numpy())


# --------------------------------------------------------------------------
# The collective form over torch.distributed (DESIGN.md §14)
# --------------------------------------------------------------------------

def _pair_merge_k(ids, d, tie, oids, od, otie, k: int):
    """One round of the halving merge: the k best of two (B, k) lists by
    the (dist, tie) key. The tie key is an entry's flat position
    ``shard·k + rank`` in the (S·k,) list ``_merge_topk`` sorts, which
    breaks distance ties to the lower position: the winners and their
    order are exactly ``_merge_topk``'s."""
    cd = torch.cat([d, od], 1)
    ci = torch.cat([ids, oids], 1)
    ct = torch.cat([tie, otie], 1)
    sel = _lexsort2(ct, cd)[:, :k]
    return ci.gather(1, sel), cd.gather(1, sel), ct.gather(1, sel)


def _pack(ids: torch.Tensor, d: torch.Tensor, *more) -> torch.Tensor:
    """(B, k) ids (global ids fit int32) and f32 dists, and any more int32
    (B, k) planes, as one int32 (B, ·) message; the dists' bits ride
    unchanged."""
    return torch.cat([ids.to(torch.int32), d.contiguous().view(torch.int32),
                      *more], 1).contiguous()


def _unpack(x: torch.Tensor, k: int):
    return (x[..., :k].to(torch.int64),
            x[..., k:2 * k].contiguous().view(torch.float32))


def _merge_topk_halving(gids, dists, k: int, group, n_shards: int):
    """The collective twin of ``_merge_topk`` over the model ``group``:
    log2 S rounds, in each of which model rank s swaps its (B, k) list
    of (id, dist, tie) with rank ``s ^ 2^r`` by ``batch_isend_irecv`` and
    keeps the k best (``_pair_merge_k``); every rank ends with the same
    (B, k) answer, in ``_merge_topk``'s exact order. O(k·log S) bytes a
    rank instead of the all-gather's O(k·S). S must be a power of two."""
    r = dist.get_rank(group)
    B = gids.shape[0]
    t = (r * k + torch.arange(k, dtype=torch.int32, device=gids.device)
         ).expand(B, k).contiguous()
    ids, d = gids.to(torch.int32), dists
    for rnd in range(n_shards.bit_length() - 1):
        peer = dist.get_global_rank(group, r ^ (1 << rnd))
        send = _pack(ids, d, t)
        recv = torch.empty_like(send)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, peer, group),
                dist.P2POp(dist.irecv, recv, peer, group)]):
            w.wait()
        oids, od = _unpack(recv, k)
        ids, d, t = _pair_merge_k(ids, d, t, oids.to(torch.int32), od,
                                  recv[:, 2 * k:], k)
    return ids.to(torch.int64), d


def _merge_topk_allgather(gids, dists, k: int, group, n_shards: int):
    """``_merge_topk`` over the model ``group``: one all-gather of every
    rank's (B, k) list into a concatenated (S·B, ·) buffer (gloo takes
    no stacked one), then the merge on every rank."""
    send = _pack(gids, dists)
    out = torch.empty((n_shards * send.shape[0], send.shape[1]),
                      dtype=send.dtype, device=send.device)
    dist.all_gather_into_tensor(out, send, group=group)
    ids, d = _unpack(out.view(n_shards, send.shape[0], -1), k)
    return _merge_topk(ids, d, k)


def merge_bytes_per_device(k: int, n_shards: int, merge: str) -> int:
    """Bytes each rank moves per batch row for the cross-shard merge
    (DESIGN.md §14): the all-gather receives (S-1)·k (id, dist) entries
    at 8 bytes, the halving form swaps log2(S)·k (id, dist, tie) entries
    at 12 bytes. They tie at S = 4."""
    if n_shards <= 1:
        return 0
    if merge == "halving":
        return 12 * k * (n_shards.bit_length() - 1)
    return 8 * k * (n_shards - 1)


def _resolve_merge(merge: str, n_shards: int) -> str:
    if merge not in ("auto", "halving", "allgather"):
        raise ValueError(f"merge={merge!r}: expected auto|halving|allgather")
    pow2 = n_shards >= 2 and (n_shards & (n_shards - 1)) == 0
    if merge == "halving" and not pow2:
        raise ValueError(
            f"merge='halving' needs a power-of-two model axis >= 2, got "
            f"S={n_shards}; use merge='auto' to fall back to all_gather")
    if merge == "auto":
        return "halving" if pow2 else "allgather"
    return merge


def _to_device(di: DeviceIndex, dev) -> DeviceIndex:
    return dataclasses.replace(di, **{
        f.name: getattr(di, f.name).to(dev)
        for f in dataclasses.fields(di)
        if torch.is_tensor(getattr(di, f.name))})


def _require_replica(p: SearchParams, di: DeviceIndex) -> None:
    if p.quant != "none" and (di.qvecs is None or
                              di.qvecs.dtype != _REPLICA_DTYPE[p.quant]):
        raise ValueError(
            f"quant={p.quant!r} needs the quantized replica on the sharded "
            f"index the collective fn will be called with — attach it up "
            f"front: skhi = dataclasses.replace(skhi, "
            f"di=with_quant_replica(skhi.di, {p.quant!r}))")


def _static_state(p: SearchParams, skhi: Optional[ShardedKHI]) -> dict:
    """The dispatch threshold and hybrid's window bounds, derived from the
    host count planes the same way on every rank (the reference's static
    planner state)."""
    out = dict(scan_threshold=0, node_thr=0, W=1)
    if p.strategy in ("auto", "hybrid"):
        if skhi is not None:
            n_total = int(_shard_counts(skhi.di).sum())
            out["scan_threshold"] = int(p.scan_threshold) or max(
                1, int(DEFAULT_SCAN_FRAC * n_total))
        elif p.strategy == "auto" and int(p.scan_threshold) > 0:
            out["scan_threshold"] = int(p.scan_threshold)
        else:
            hyb = p.strategy == "hybrid"
            raise ValueError(
                f"strategy={p.strategy!r} under the collective needs the "
                f"dispatch threshold{' and window bounds' if hyb else ''}, "
                f"which derive from per-shard corpus counts — pass skhi="
                f"{'' if hyb else ' or set SearchParams.scan_threshold'}"
                f" (DESIGN.md §14)")
    if p.strategy == "hybrid":
        node_thr = int(p.node_scan_threshold) or out["scan_threshold"]
        count = skhi.di.count.cpu().numpy().reshape(skhi.num_shards, -1)
        small = (count > 0) & (count <= node_thr)
        # W bounds a lane's small antichain a shard: every statically
        # small node, at most frontier_cap a level
        H = skhi.di.nbrs.shape[-2]
        max_small = int(small.sum(axis=1).max())
        out.update(node_thr=node_thr,
                   W=pow2_at_least(max(1, min(max_small,
                                              p.frontier_cap * H))))
    return out


def _agree(mesh, values) -> None:
    """The batch's agreement check: one all-reduce (MAX of v and -v) over
    every rank; ranks that disagree all raise the same error."""
    v = torch.tensor(values, dtype=torch.int64, device=mesh.device)
    both = torch.cat([v, -v])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    n = v.numel()
    if not (torch.equal(both[:n], v) and torch.equal(-both[n:], v)):
        raise RuntimeError(
            f"the collective batch's ranks disagree on (batch, tier, "
            f"program): this rank {v.tolist()}, max "
            f"{both[:n].tolist()}, min {(-both[n:]).tolist()} — every rank "
            f"must drive the same requests in the same order")


def make_sharded_search_fn(params: SearchParams, mesh, *,
                           dist_fn=None, skhi: Optional[ShardedKHI] = None,
                           on_undersized: str = "raise",
                           merge: str = "auto", tier: int = 0):
    """The collective sharded search on ``mesh`` (``launch.mesh.
    make_query_mesh``): fn(skhi, queries (B, d), qlo, qhi (B, m)) ->
    (ids (B, k) int32, dists (B, k) f32) tensors on the rank's device,
    called on every rank with the same full batch. Model rank s serves
    ``skhi.di.shard(s)`` (its slice of the stacked, padded index, moved
    to the rank's device once per index); data row i answers the i-th
    slice of the batch (padded with empty boxes to a multiple of the data
    axis), and an all-gather over the data group returns the whole batch
    to every rank.

    Every strategy runs: "graph" and "scan" run their pass on all lanes;
    "auto" sums the shards' ``route_level_card`` bounds over the model
    group and masks the losing pass's boxes to the empty box (lo = +inf >
    hi = -inf: the walk exits at once, the scan matches nothing);
    "hybrid" sums the shards' ``route_level_windows`` counts (card, small
    and large nodes, in one all-reduce of the three), merges the graph
    stream and the windowed scan's over the position-ordered replica, and
    joins them with ``_merge_dedup_jnp``. A pass runs only where some
    lane of the slice needs it; its gate comes from all-reduced numbers,
    so it is the same on every rank of the model group, and the merges
    run on every rank whatever the gates say. ``merge`` is auto |
    halving | allgather (auto: halving where S is a power of two >= 2).

    "auto" needs the dispatch threshold and "hybrid" also the window
    bounds, both derived from the shards' counts: pass ``skhi=`` (or, for
    "auto", set ``SearchParams.scan_threshold``); ``skhi`` also validates
    the index-dependent bounds (``on_undersized``) and the quant replica
    up front. ``tier`` joins the batch size and a digest of the params in
    each batch's agreement check."""
    from ..launch.mesh import QueryMesh

    if not isinstance(mesh, QueryMesh):
        raise TypeError(f"mesh= takes a QueryMesh (launch.mesh."
                        f"make_query_mesh over torch.distributed), got "
                        f"{type(mesh).__name__}")
    n_shards = mesh.n_model
    merge = _resolve_merge(merge, n_shards)
    if skhi is not None:
        if skhi.num_shards != n_shards:
            raise ValueError(
                f"skhi has {skhi.num_shards} shards but the mesh's model "
                f"axis has {n_shards}")
        params = validate_search_params(params, skhi.di,
                                        on_undersized=on_undersized)
        _require_replica(params, skhi.di)
    else:
        params = validate_search_params(params, None,
                                        on_undersized="ignore")
    p = params
    strategy = p.strategy
    static = _static_state(p, skhi)
    scan_threshold, node_thr, W = (static["scan_threshold"],
                                   static["node_thr"], static["W"])
    scorer, exact = resolve_scorer_pair(p, dist_fn=dist_fn)
    use_kernel = p.backend == "pallas_gather_l2_filter"
    dev = mesh.device
    s = mesh.model_index
    digest = int.from_bytes(hashlib.blake2b(
        f"{p!r}|{merge}".encode(), digest_size=6).digest(), "little")
    merge_fn = (_merge_topk_halving if merge == "halving"
                else _merge_topk_allgather)
    cached: dict = {}

    def merge_k(gids, dists):
        return merge_fn(gids, dists, p.k, mesh.model_group, n_shards)

    def all_reduce(x):
        dist.all_reduce(x, group=mesh.model_group)
        return x

    def shard_state(skhi: ShardedKHI) -> dict:
        """This rank's shard on its device, with the scan's NaN-masked
        attrs and hybrid's position-ordered replica, made once an index."""
        if cached.get("src") is skhi.di:
            return cached
        if skhi.num_shards != n_shards:
            raise ValueError(f"skhi has {skhi.num_shards} shards but the "
                             f"mesh's model axis has {n_shards}")
        _require_replica(p, skhi.di)
        di = _to_device(skhi.di.shard(s), dev)
        st = {"src": skhi.di, "di": di}
        if strategy != "graph":
            # padded rows fail every box (the planner's scan attrs)
            n_real = int(di.count[di.root])
            valid = torch.arange(di.n, device=dev) < n_real
            st["attrs_nan"] = torch.where(
                valid[:, None], di.attrs,
                torch.full_like(di.attrs, float("nan")))
        if strategy == "hybrid":
            st["pos_vecs"] = di.vecs[di.order].contiguous()
            st["pos_attrs"] = st["attrs_nan"][di.order].contiguous()
        cached.clear()
        cached.update(st)
        return cached

    def local(st: dict, q, qlo, qhi):
        """This rank's slice: its shard's passes, merged over the model
        group -> global (ids (Bl, k) int64, dists (Bl, k) f32)."""
        di = st["di"]
        B = q.shape[0]
        empty = (torch.full((B, p.k), -1, dtype=torch.int64, device=dev),
                 torch.full((B, p.k), float("inf"), device=dev))

        def globalize(ids, dd):
            g = _local_to_global(ids.to(torch.int64), s, n_shards)
            return g, torch.where(g >= 0, dd, torch.full_like(dd,
                                                             float("inf")))

        def graph_pass(lo, hi):
            g, dd, _ = _shard_search(di, q, lo, hi, p, scorer, exact,
                                     shard=s, n_shards=n_shards)
            return g, dd

        if strategy == "graph":
            return merge_k(*graph_pass(qlo, qhi))

        def scan_pass(lo, hi):
            return globalize(*_scan_shard_topk(
                di, st["attrs_nan"], q, lo, hi, p, use_kernel=use_kernel))

        if strategy == "scan":
            return merge_k(*scan_pass(qlo, qhi))

        def mask_box(keep):
            k2 = keep[:, None]
            return (torch.where(k2, qlo, torch.full_like(qlo, float("inf"))),
                    torch.where(k2, qhi, torch.full_like(qhi, -float("inf"))))

        def pick(sel, a, b):
            return (torch.where(sel[:, None], a[0], b[0]),
                    torch.where(sel[:, None], a[1], b[1]))

        if strategy == "auto":
            card = all_reduce(route_level_card(di, qlo, qhi, p))
            use_scan = (card > 0) & (card <= scan_threshold)
            g = (graph_pass(*mask_box(~use_scan))
                 if bool((~use_scan).any()) else empty)
            sc = (scan_pass(*mask_box(use_scan))
                  if bool(use_scan.any()) else empty)
            return merge_k(*pick(use_scan, sc, g))

        # hybrid: each lane's antichain split by node size, device-side
        card, n_small, n_large, wst, wct = route_level_windows(
            di, qlo, qhi, p, node_thr=node_thr, W=W)
        card, t_small, t_large = all_reduce(
            torch.stack([card, n_small, n_large]))
        mode1 = (t_large == 0) & (card > 0)           # pure-window: exact
        mode2 = (t_large > 0) & (t_small > 0)         # mixed
        g = graph_pass(*mask_box(~mode1)) if bool((~mode1).any()) else empty
        g = merge_k(*g)
        w = (globalize(*_windows_one(
                st["pos_vecs"], st["pos_attrs"], di.order, q, qlo, qhi,
                wst, wct, p.k, use_kernel=use_kernel))
             if bool((t_small > 0).any()) else empty)
        w = merge_k(*w)
        m_ids, m_d = _merge_dedup_jnp(g[0], g[1], w[0], w[1], p.k)
        return pick(mode1, w, pick(mode2, (m_ids.to(torch.int64), m_d), g))

    def fn(skhi: ShardedKHI, queries, qlo, qhi):
        st = shard_state(skhi)
        q, lo, hi = (torch.as_tensor(a, dtype=torch.float32).to(dev)
                     for a in (queries, qlo, qhi))
        B = q.shape[0]
        _agree(mesh, [B, tier, digest])
        nd = mesh.n_data
        pad = -B % nd
        if pad:
            q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
            lo = torch.cat([lo, lo.new_full((pad, lo.shape[1]),
                                            float("inf"))])
            hi = torch.cat([hi, hi.new_full((pad, hi.shape[1]),
                                            -float("inf"))])
        bl = (B + pad) // nd
        sl = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
        ids, d = local(st, q[sl].contiguous(), lo[sl].contiguous(),
                       hi[sl].contiguous())
        send = _pack(ids, d)
        out = torch.empty((nd * bl, send.shape[1]), dtype=send.dtype,
                          device=dev)
        dist.all_gather_into_tensor(out, send, group=mesh.data_group)
        ids, d = _unpack(out, p.k)
        return ids[:B].to(torch.int32), d[:B]

    fn.merge = merge
    fn.static = static
    return fn


def sharded_input_specs(*, n_per_shard: int, d: int, m: int, height: int,
                        nodes_per_shard: int, M: int, n_shards: int,
                        batch: int, vec_dtype=None, quant: str = "none"):
    """Shape-only stand-ins (``device="meta"`` tensors, no memory) of a
    ShardedKHI and a query batch, with the reference's shapes and dtypes:
    the tree planes and ``root`` / ``offsets`` int32, as the reference
    stacks them. ``quant`` adds the replica planes ``with_quant_replica``
    attaches: "bf16" a (S, n, d) bf16 ``qvecs``, "int8" (S, n, d) int8
    ``qvecs`` and the (S, n, 1) f32 ``qscale``."""
    f32, i32 = torch.float32, torch.int32
    vd = vec_dtype or f32

    def sd(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    S, n, Pn = n_shards, n_per_shard, nodes_per_shard
    if quant not in ("none", "bf16", "int8"):
        raise ValueError(f"unknown quant {quant!r}; expected none|bf16|int8")
    qvecs = qscale = None
    if quant == "bf16":
        qvecs = sd((S, n, d), torch.bfloat16)
    elif quant == "int8":
        qvecs = sd((S, n, d), torch.int8)
        qscale = sd((S, n, 1), f32)
    di = DeviceIndex(
        vecs=sd((S, n, d), vd), attrs=sd((S, n, m), f32),
        nbrs=sd((S, n, height, M), i32),
        left=sd((S, Pn), i32), right=sd((S, Pn), i32), dim=sd((S, Pn), i32),
        bl=sd((S, Pn), i32), lo=sd((S, Pn, m), f32), hi=sd((S, Pn, m), f32),
        start=sd((S, Pn), i32), count=sd((S, Pn), i32), order=sd((S, n), i32),
        root=sd((S,), i32), qvecs=qvecs, qscale=qscale)
    skhi = ShardedKHI(di=di, offsets=sd((S,), i32))
    return skhi, {"queries": sd((batch, d), f32),
                  "qlo": sd((batch, m), f32),
                  "qhi": sd((batch, m), f32)}
