"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    d_expert=512,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="moe",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        d_head=8,
        d_ff=16,
        vocab=97,
        n_experts=4,
        top_k=2,
        d_expert=16,
    )
