"""falcon-mamba-7b [ssm]: 64L d_model=4096, attn-free Mamba-1, vocab 65024.

[arXiv:2410.05355; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # attn-free: attention params are never instantiated
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab=65024,
    ssm_kind="mamba1",
    d_state=16,
    expand=2,
    conv_dim=4,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke",
        family="ssm",
        n_layers=2,
        d_model=32,
        n_heads=1,
        n_kv_heads=1,
        d_head=8,
        d_ff=0,
        vocab=97,
        ssm_kind="mamba1",
        d_state=4,
        expand=2,
        conv_dim=4,
        scan_chunk=8,
    )
