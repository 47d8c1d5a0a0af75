"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared) — trillion-param MoE.
[arXiv:2501.kimi2; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=2048,
    vocab=163840,
    n_experts=384,
    top_k=8,
    d_expert=2048,
    n_shared_experts=1,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-smoke",
        family="moe",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        d_head=8,
        d_ff=16,
        vocab=97,
        n_experts=8,
        top_k=2,
        d_expert=16,
        n_shared_experts=1,
    )
