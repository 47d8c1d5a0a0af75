"""Unified model configuration for the assigned architecture pool (a copy of
``repro.models.config``, plus ``torch_dtype``).

One composable ``ModelConfig`` covers the six families (dense / moe / ssm /
hybrid / encdec / vlm); per-arch configs live in ``repro_torch.configs.<id>``
and are exact transcriptions of the assignment table.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "swiglu"  # swiglu | squared_relu | gelu
    tie_embeddings: bool = False

    # attention pattern
    attn_pattern: str = "full"  # full | local_global
    window: int = 1024
    global_every: int = 6  # one global layer per this many (local_global)
    rope_theta: float = 10000.0
    use_layernorm: bool = False  # RMSNorm default; LN for whisper

    # mixture of experts
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # state-space (mamba)
    ssm_kind: str = ""  # mamba1 | mamba2
    d_state: int = 16
    expand: int = 2
    conv_dim: int = 4
    ssm_head_dim: int = 64  # mamba2
    ssm_chunk: int = 256  # mamba2 SSD chunk length
    dt_rank: int = 0  # mamba1 (0 -> d_model // 16)
    scan_chunk: int = 512  # mamba1 memory-chunked scan

    # hybrid (zamba2): one shared attention block applied every N layers
    shared_attn_every: int = 0

    # encoder-decoder (whisper): encoder depth + stub frontend frames
    n_enc_layers: int = 0
    enc_seq: int = 0

    # vlm: every Nth layer cross-attends to stubbed patch embeddings
    cross_attn_every: int = 0
    n_img_tokens: int = 0

    # numerics / memory policy
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "none"  # none | dots | full
    vocab_pad_to: int = 256

    # ---------------- derived -----------------
    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head + self.n_heads * self.d_head * d
        if self.act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe":
            e_mlp = self.n_experts * 3 * d * self.d_expert
            e_mlp += self.n_shared_experts * 3 * d * self.d_expert
            e_mlp += d * self.n_experts  # router
            per_layer = attn + e_mlp
        elif self.family == "ssm":
            di, ds = self.d_inner, self.d_state
            per_layer = (
                d * 2 * di
                + di * self.conv_dim
                + di * (self.dt_rank_eff + 2 * ds)
                + self.dt_rank_eff * di
                + di * ds
                + di
                + di * d
            )
        elif self.family == "hybrid":
            di = self.d_inner
            h = self.n_ssm_heads
            ds = self.d_state
            per_layer = (
                d * (2 * di + 2 * ds + h) + (di + 2 * ds) * self.conv_dim
                + h + h + di * d
            )
        else:
            per_layer = attn + mlp
        total = emb + self.n_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            total += attn + 2 * d  # one shared attention block
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp)
            total += self.n_layers * attn  # cross-attention blocks
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * attn  # cross blocks replace none, add x-attn
        return int(total)

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.n_params
        d = self.d_model
        dense_experts = self.top_k + self.n_shared_experts
        act_mlp = dense_experts * 3 * d * self.d_expert + d * self.n_experts
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head + self.n_heads * self.d_head * d
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return int(emb + self.n_layers * (attn + act_mlp))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of ``cfg.dtype`` or ``cfg.param_dtype`` ("float32", "bfloat16", ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{name!r} is not a torch dtype")
    return dtype


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input shape x step kind) cell of the assignment."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k only runs for O(1)-state / windowed archs (DESIGN.md §4 skips)
LONG_CTX_ARCHS = {"falcon-mamba-7b", "zamba2-7b"}


def cells_for(arch_name: str):
    out = []
    for cell in SHAPES.values():
        if cell.name == "long_500k" and arch_name not in LONG_CTX_ARCHS:
            continue
        out.append(cell)
    return out
