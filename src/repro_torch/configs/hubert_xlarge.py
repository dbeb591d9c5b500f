"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 (codebook
targets), encoder-only; conv feature extractor STUB — input_specs provides
512-d frame features. [arXiv:2106.07447; unverified]"""

from repro_torch.models.config import LayerSpec, ModelConfig, Stage


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio", d_model=1280, vocab=504,
        n_heads=16, n_kv_heads=16, head_dim=80, d_ff=5120,
        encoder_only=True, frontend="audio", frontend_dim=512,
        stages=(Stage(48, (LayerSpec("attn", None, "dense"),)),),
        dtype="bfloat16", remat="full",
        source="arXiv:2106.07447; unverified",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="audio", d_model=64, vocab=32,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        encoder_only=True, frontend="audio", frontend_dim=24,
        stages=(Stage(2, (LayerSpec("attn", None, "dense"),)),),
        dtype="float32",
    )
