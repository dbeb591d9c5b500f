"""Logical-axis sharding names, kept as annotations: the counterpart of
``repro.models.sharding``. The port runs a model on one device, so
``constrain`` is the identity; its arguments name the layout the
reference constrains each activation to (``batch``, ``heads``, ``ffn``,
``vocab``, ``experts``), and ``model.param_logical_axes`` names each
weight's. A slice that shards the substrate over ``torch.distributed``
resolves them to mesh axes.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["constrain"]


def constrain(x, *logical: Optional[str]):
    """The identity: a model runs on one device."""
    return x
