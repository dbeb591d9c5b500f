"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (kv=8) vocab=49155,
MoE 40 experts top-8, expert d_ff=512 (config line wins over prose).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from repro_torch.models.config import LayerSpec, MoEConfig, ModelConfig, Stage


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", d_model=1536, vocab=49155,
        n_heads=24, n_kv_heads=8, head_dim=64, d_ff=512,
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
        stages=(Stage(32, (LayerSpec("attn", None, "moe"),)),),
        dtype="bfloat16", remat="full",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base (scaled family); hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="moe", d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, capacity_factor=8.0),
        stages=(Stage(2, (LayerSpec("attn", None, "moe"),)),),
        dtype="float32",
    )
