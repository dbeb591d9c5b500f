"""Elastic resharding of the sharded index and of checkpoints
(``elastic.py``); the query mesh of the collective search lives in
``repro_torch.launch.mesh``."""

from .elastic import (  # noqa: F401
    elastic_reshard,
    reshard_checkpoint,
    shard_assignments,
)
