"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
Mamba-2 backbone (ssm_state=64) + shared attention block every 6 layers.
[arXiv:2411.15242; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab=32000,
    ssm_kind="mamba2",
    d_state=64,
    expand=2,
    conv_dim=4,
    ssm_head_dim=64,
    shared_attn_every=6,  # 13 groups of 6 + tail of 3
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=5,  # one group of 2 + tail of 3... (2*2+1)
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        d_head=8,
        d_ff=64,
        vocab=97,
        ssm_kind="mamba2",
        d_state=8,
        expand=2,
        conv_dim=4,
        ssm_head_dim=16,
        ssm_chunk=8,
        shared_attn_every=2,
    )
