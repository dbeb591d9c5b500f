"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (kv=8) vocab=32064,
16 experts top-2, expert d_ff=6400. [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

from repro_torch.models.config import LayerSpec, MoEConfig, ModelConfig, Stage


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", d_model=4096, vocab=32064,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=6400,
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=6400),
        stages=(Stage(32, (LayerSpec("attn", None, "moe"),)),),
        dtype="bfloat16", remat="full",
        source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke", family="moe", d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, capacity_factor=8.0),
        stages=(Stage(2, (LayerSpec("attn", None, "moe"),)),),
        dtype="float32",
    )
