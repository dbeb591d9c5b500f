"""Model-zoo configuration: one composable schema covering all 10 assigned
architectures (dense / MoE / SSM / hybrid / VLM / audio-encoder).

A model is a sequence of STAGES; each stage runs `repeat` copies of a
short, possibly heterogeneous BODY of layer specs, its weights stacked
with a leading (repeat,) axis as the reference's ``lax.scan`` carries
them. Homogeneous archs have one stage with a 1-layer body; gemma3's 5:1
local:global pattern is a (5 x [5*local + global]) stage plus a trailing
4-local stage; jamba is 4 x [8-layer block]. The port's own copy of
``repro.models.config``: the same dataclasses and fields, with a torch
dtype (``torch_dtype``) in the reference's ``jdtype`` place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["MLAConfig", "MoEConfig", "SSMConfig", "LayerSpec", "Stage",
           "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 style, used by MiniCPM3)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 16
    top_k: int = 2
    d_expert: int = 6400
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3
    # Layout optimization (§Perf): pad the expert axis to this count so EP
    # divides the mesh (e.g. granite's 40 -> 48 on a 16-way axis). Padded
    # experts carry -inf router logits and zero weights — mathematically
    # identical routing, different sharding. None = no padding.
    pad_to: Optional[int] = None

    @property
    def n_padded(self) -> int:
        return self.pad_to or self.n_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One residual block: a sequence mixer + optional FFN."""
    mixer: str = "attn"          # "attn" | "ssm"
    window: Optional[int] = None  # sliding-window size (attn only)
    ffn: Optional[str] = "dense"  # "dense" | "moe" | None


@dataclasses.dataclass(frozen=True)
class Stage:
    repeat: int
    body: Tuple[LayerSpec, ...]

    @property
    def n_layers(self) -> int:
        return self.repeat * len(self.body)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|vlm|audio
    d_model: int
    vocab: int
    stages: Tuple[Stage, ...]
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    mla: Optional[MLAConfig] = None
    mrope_sections: Optional[Tuple[int, ...]] = None  # half-dim sections (t,h,w)
    rope_theta: float = 1e4
    # ffn / moe / ssm
    d_ff: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # misc
    encoder_only: bool = False
    frontend: Optional[str] = None   # None | "audio" | "vision"
    frontend_dim: int = 0            # stub feature dim (audio: 512)
    n_patches: int = 256             # vision stub patch count
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "float32"           # params/activation dtype
    remat: str = "none"              # none | dots | full
    # citation / provenance
    source: str = ""

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.dtype]

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md skip policy): any arch whose
        layers are not all full-attention."""
        kinds = [l for s in self.stages for l in s.body]
        return any(l.mixer == "ssm" or (l.mixer == "attn" and l.window)
                   for l in kinds)

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    def n_params(self) -> int:
        """Analytic parameter count (matches init_params; used for 6ND)."""
        from . import model as _m  # late import to avoid cycle
        return _m.count_params(self)

    def n_active_params(self) -> int:
        from . import model as _m
        return _m.count_params(self, active_only=True)

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)
