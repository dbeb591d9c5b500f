"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local(1024):global interleave. [hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.models.config import LayerSpec, ModelConfig, Stage

_LOCAL = LayerSpec(mixer="attn", window=1024, ffn="dense")
_GLOBAL = LayerSpec(mixer="attn", window=None, ffn="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense", d_model=2560, vocab=262144,
        n_heads=8, n_kv_heads=4, head_dim=256, d_ff=10240,
        rope_theta=1e6,
        # 34 layers: 5 x (LLLLLG) + 4 trailing locals
        stages=(Stage(5, (_LOCAL,) * 5 + (_GLOBAL,)),
                Stage(1, (_LOCAL,) * 4)),
        dtype="bfloat16", remat="full",
        source="hf:google/gemma-3-1b-pt (scaled family); unverified",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense", d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        stages=(Stage(1, (LayerSpec("attn", 8, "dense"),) * 2
                      + (LayerSpec("attn", None, "dense"),)),),
        dtype="float32",
    )
