"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064, RoPE SwiGLU. [arXiv:2404.14219; unverified]"""

from repro_torch.models.config import LayerSpec, ModelConfig, Stage


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense", d_model=3072, vocab=32064,
        n_heads=32, n_kv_heads=32, head_dim=96, d_ff=8192,
        stages=(Stage(32, (LayerSpec("attn", None, "dense"),)),),
        dtype="bfloat16", remat="full",
        source="arXiv:2404.14219; unverified",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke", family="dense", d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        stages=(Stage(2, (LayerSpec("attn", None, "dense"),)),),
        dtype="float32",
    )
