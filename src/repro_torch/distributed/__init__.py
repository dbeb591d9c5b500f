"""Elastic resharding of the sharded index (``elastic.py``); the query
mesh of the collective search lives in ``repro_torch.launch.mesh``."""

from .elastic import elastic_reshard, shard_assignments  # noqa: F401
