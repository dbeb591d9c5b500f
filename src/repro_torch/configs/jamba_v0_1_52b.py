"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba:attn 7:1 interleave (attn at block index
4), MoE every other layer. [arXiv:2403.19887; hf]"""

from repro_torch.models.config import (LayerSpec, MoEConfig, ModelConfig, SSMConfig,
                                 Stage)


def _block():
    out = []
    for i in range(8):
        mixer = "attn" if i == 4 else "ssm"
        ffn = "moe" if i % 2 == 1 else "dense"
        out.append(LayerSpec(mixer, None, ffn))
    return tuple(out)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", d_model=4096, vocab=65536,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336),
        ssm=SSMConfig(d_state=16, head_dim=64, expand=2, n_groups=1),
        stages=(Stage(4, _block()),),
        dtype="bfloat16", remat="full",
        source="arXiv:2403.19887; hf",
    )


def smoke_config() -> ModelConfig:
    body = (LayerSpec("ssm", None, "dense"), LayerSpec("attn", None, "moe"),
            LayerSpec("ssm", None, "dense"))
    return ModelConfig(
        name="jamba-smoke", family="hybrid", d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, capacity_factor=8.0),
        ssm=SSMConfig(d_state=8, head_dim=16, expand=2, n_groups=1, chunk=16),
        stages=(Stage(1, body),),
        dtype="float32",
    )
