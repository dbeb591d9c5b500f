"""Configurations of the port: the 10 assigned LM architectures and the
paper's own serving config (``khi-serve``), the counterpart of
``repro.configs``. ``get_config(id)`` returns the full published config;
``get_smoke_config(id)`` a reduced same-family config for CPU tests."""

from __future__ import annotations

import importlib
from typing import Dict

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

ARCH_IDS = [
    "gemma3-4b",
    "phi3-mini-3.8b",
    "minicpm3-4b",
    "qwen1.5-4b",
    "jamba-v0.1-52b",
    "granite-moe-3b-a800m",
    "phi3.5-moe-42b-a6.6b",
    "qwen2-vl-72b",
    "mamba2-780m",
    "hubert-xlarge",
]

_MODULES: Dict[str, str] = {
    "gemma3-4b": "gemma3_4b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen1.5-4b": "qwen1_5_4b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-780m": "mamba2_780m",
    "hubert-xlarge": "hubert_xlarge",
    "khi-serve": "khi_serve",
}


def get_config(arch_id: str):
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.config()


def get_smoke_config(arch_id: str):
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.smoke_config()
