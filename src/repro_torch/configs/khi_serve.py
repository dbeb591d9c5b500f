"""khi-serve: the paper's own serving configuration, as in
``repro.configs.khi_serve`` — a 1M-object shard (d=768, m=4 attrs, M=32)
served with batched RFANNS queries through the auto planner. The
reference serves 16 such shards on a (data, model) mesh; the port serves
them through ``core/sharded.py`` (one process, or the collective over
``torch.distributed``, one rank a card)."""

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class KHIServeConfig:
    name: str = "khi-serve"
    n_per_shard: int = 1_000_000
    d: int = 768
    m: int = 4
    M: int = 32
    height: int = 24
    nodes_per_shard: int = 1 << 20
    k: int = 10
    ef: int = 128
    c_e: int = 10
    c_n: int = 32
    expand_width: int = 4
    router: str = "level"
    # the reference's declared dry-run bound; serving raises it to the
    # index's required_frontier_cap
    frontier_cap: int = 8192
    # on the port this name selects the hand-written CUDA kernel
    backend: str = "pallas_gather_l2_filter"
    strategy: str = "auto"
    scan_threshold: int = 100_000        # 10% of the 1M-object shard
    quant: str = "none"
    rerank_mult: int = 4
    node_scan_threshold: int = 0
    box_budget: int = 8
    buckets: Tuple[int, ...] = (1, 8, 32, 128, 256)
    cache_size: int = 65536
    # Streaming write path (DESIGN.md §11): per-shard delta-segment rows
    # before inserts force a compaction. ~13% of a 1M-object shard keeps
    # the delta's exact brute scan a small fraction of query cost while
    # bounding the windowed-merge rebuild cadence.
    delta_capacity: int = 131_072
    # SLO scheduler policy (serve/scheduler.py, DESIGN.md §13): bounded
    # admission queue, default per-request deadline, and the degradation
    # ladder (TierSpec grammar; each comma-separated step overrides
    # SearchParams fields of the full-quality tier 0). The ladder halves
    # ef twice and drops the frontier to one expansion per hop at the
    # bottom: recall degrades, batch shapes do not change.
    slo_ms: float = 100.0
    qdepth: int = 1024
    degrade_ladder: str = "ef=64,ef=32+expand_width=1"
    batch_timeout_ms: float = 0.0       # 0 disables the timeout signal

    def search_params(self):
        """SearchParams for this serving cell."""
        from ..core.engine import SearchParams
        return SearchParams(k=self.k, ef=self.ef, c_e=self.c_e, c_n=self.c_n,
                            backend=self.backend,
                            expand_width=self.expand_width,
                            router=self.router,
                            frontier_cap=self.frontier_cap,
                            strategy=self.strategy,
                            scan_threshold=self.scan_threshold,
                            quant=self.quant,
                            rerank_mult=self.rerank_mult,
                            node_scan_threshold=self.node_scan_threshold,
                            box_budget=self.box_budget)

    def serve_config(self):
        from ..serve.khi_service import ServeConfig
        return ServeConfig(buckets=self.buckets, cache_size=self.cache_size)

    def scheduler_config(self):
        """SchedulerConfig for the SLO front-end (DESIGN.md §13)."""
        from ..serve.scheduler import SchedulerConfig, TierSpec
        return SchedulerConfig(qdepth=self.qdepth, slo_ms=self.slo_ms,
                               ladder=TierSpec.parse_ladder(
                                   self.degrade_ladder),
                               batch_timeout_ms=self.batch_timeout_ms)


def config() -> KHIServeConfig:
    return KHIServeConfig()


def smoke_config() -> KHIServeConfig:
    return KHIServeConfig(name="khi-serve-smoke", n_per_shard=2000, d=32,
                          m=3, M=8, height=12, nodes_per_shard=4096, ef=32,
                          backend="jnp", scan_threshold=200,
                          buckets=(1, 8, 32), cache_size=1024,
                          delta_capacity=256, qdepth=64, slo_ms=250.0,
                          degrade_ladder="ef=16,ef=8+expand_width=1")
