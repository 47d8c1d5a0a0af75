"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention (window 1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab=262144,
    attn_pattern="local_global",
    window=1024,
    global_every=6,  # 5 local + 1 global per group
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        n_layers=8,  # one (5 local + 1 global) group + 2-local tail
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        d_head=8,
        d_ff=64,
        vocab=97,
        attn_pattern="local_global",
        window=8,
        global_every=6,
    )
