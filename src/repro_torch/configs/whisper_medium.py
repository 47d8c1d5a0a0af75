"""whisper-medium [audio]: 24L enc + 24L dec, d_model=1024, 16H, vocab 51865.

Encoder-decoder; the conv audio frontend is a STUB — ``input_specs`` provides
precomputed (B, 1500, d_model) frame embeddings. [arXiv:2212.04356]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    act="gelu",
    use_layernorm=True,
    enc_seq=1500,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        d_head=8,
        d_ff=64,
        vocab=97,
        act="gelu",
        use_layernorm=True,
        enc_seq=12,
    )
