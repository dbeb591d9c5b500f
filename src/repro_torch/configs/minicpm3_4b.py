"""minicpm3-4b [dense/MLA]: 62L d_model=2560 40H d_ff=6400 vocab=73448,
multi-head latent attention. [hf:openbmb/MiniCPM3-4B; hf]"""

from repro_torch.models.config import LayerSpec, MLAConfig, ModelConfig, Stage


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense", d_model=2560, vocab=73448,
        n_heads=40, n_kv_heads=40, head_dim=64, d_ff=6400,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
        stages=(Stage(62, (LayerSpec("attn", None, "dense"),)),),
        dtype="bfloat16", remat="full",
        source="hf:openbmb/MiniCPM3-4B; hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke", family="dense", d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        stages=(Stage(2, (LayerSpec("attn", None, "dense"),)),),
        dtype="float32",
    )
