"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — squared-ReLU MLP. [arXiv:2402.16819; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=256000,
    act="squared_relu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke",
        family="dense",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        d_head=8,
        d_ff=64,
        vocab=97,
        act="squared_relu",
    )
