"""qwen1.5-4b [dense]: 40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.models.config import LayerSpec, ModelConfig, Stage


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense", d_model=2560, vocab=151936,
        n_heads=20, n_kv_heads=20, head_dim=128, d_ff=6912, qkv_bias=True,
        stages=(Stage(40, (LayerSpec("attn", None, "dense"),)),),
        dtype="bfloat16", remat="full",
        source="hf:Qwen/Qwen1.5-0.5B (scaled family); hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense", d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, qkv_bias=True,
        stages=(Stage(2, (LayerSpec("attn", None, "dense"),)),),
        dtype="float32",
    )
