"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (kv=8) d_ff=29568 vocab=152064,
M-RoPE, dynamic-resolution vision STUB (input_specs provides precomputed
patch embeddings). [arXiv:2409.12191; hf]"""

from repro_torch.models.config import LayerSpec, ModelConfig, Stage


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm", d_model=8192, vocab=152064,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568, qkv_bias=True,
        mrope_sections=(16, 24, 24),
        frontend="vision", n_patches=256,
        stages=(Stage(80, (LayerSpec("attn", None, "dense"),)),),
        dtype="bfloat16", remat="full",
        source="arXiv:2409.12191; hf",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm", d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, qkv_bias=True,
        mrope_sections=(2, 3, 3),
        frontend="vision", n_patches=8,
        stages=(Stage(2, (LayerSpec("attn", None, "dense"),)),),
        dtype="float32",
    )
