"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — every 5th layer cross-attends to (stubbed) patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=5,  # 20 groups of (4 self + 1 cross)
    n_img_tokens=1601,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke",
        family="vlm",
        n_layers=4,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        d_head=8,
        d_ff=64,
        vocab=97,
        cross_attn_every=2,
        n_img_tokens=9,
    )
