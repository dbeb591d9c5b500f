"""mamba2-780m [ssm]: 48L d_model=1536 vocab=50280, attn-free SSD,
ssm_state=128, headdim=64, expand=2. [arXiv:2405.21060; unverified]"""

from repro_torch.models.config import LayerSpec, ModelConfig, SSMConfig, Stage


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm", d_model=1536, vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
        stages=(Stage(48, (LayerSpec("ssm", None, None),)),),
        dtype="bfloat16", remat="full", tie_embeddings=True,
        source="arXiv:2405.21060; unverified",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", d_model=64, vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1, chunk=16),
        stages=(Stage(2, (LayerSpec("ssm", None, None),)),),
        dtype="float32", tie_embeddings=True,
    )
