"""Model assembly on PyTorch for the attention families (the counterpart of
``repro.models.model``).

Every family is an ``nn.Module`` with the reference's five entry points as
methods (``Model``, the counterpart of ``ModelApi``):
  init(generator)                     -> draws every parameter
  train_loss(batch)                   -> (loss, metrics), differentiable
  prefill(batch)                      -> (last_logits, cache)
  decode_step(cache, tokens, pos)     -> (logits, cache)
  init_cache(batch_size, max_seq)     -> cache dict

The reference scans stacked parameters with ``lax.scan``; here the layers
are an ``nn.ModuleList`` in layer order (``layers.<j>``, ``enc_blocks.<i>``,
``dec_blocks.<i>``) and the entry points loop over it. The caches keep the
reference's stacked layout (``k``: (n_layers, B, max_seq, N_kv, Dh);
``lk``/``gk``/``tk`` for local/global; ``self_k``/``cross_k`` for encdec and
vlm), so they compare leaf for leaf. ``decode_step`` returns new cache
tensors and leaves the ones it was given as they were.

Every family is ported: the dense, MoE and local/global decoders
(``build_decoder``), the state-space families (``build_ssm``: falcon-mamba's
Mamba-1 or a Mamba-2 stack; ``build_hybrid``: zamba2's Mamba-2 groups with
one shared attention block), ``build_encdec`` and ``build_vlm``. The
state-space caches keep the reference's nested layout (``states``;
``g_states``, ``shared_k``/``shared_v`` and ``t_states``), each a dict of
``conv`` and ``ssm`` leaves stacked on the layer axes.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from . import ssm as S
from .config import ModelConfig, torch_dtype


# ---------------------------------------------------------------------------
# shared machinery
# ---------------------------------------------------------------------------

def embed(model: "Model", tokens, cfg: ModelConfig):
    return F.embedding(tokens, model.embed).to(torch_dtype(cfg.dtype))


def _vocab_pad_bias(cfg: ModelConfig) -> np.ndarray:
    m = np.zeros((cfg.padded_vocab,), np.float32)
    m[cfg.vocab:] = L.NEG_INF
    return m


def unembed(model: "Model", x, cfg: ModelConfig):
    """Final norm, then the (padded) vocabulary's logits in float32; the pad
    ids carry ``NEG_INF`` so argmax never picks one."""
    x = L.apply_norm(model.final_norm, x, cfg)
    w = model.unembed if model.unembed is not None else model.embed.T
    logits = x @ w.to(torch_dtype(cfg.dtype))
    return logits.float() + model.vocab_pad_bias


def xent_loss(logits, labels):
    """logits (B,S,Vp) f32; labels (B,S) integer, -1 masked."""
    mask = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1)
    return (nll * mask).sum() / denom


def sinusoidal_pos(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def _ring_fill(kv, window: int):
    """Scatter the last `window` positions of (B,S,N,Dh) into ring slots."""
    s = kv.shape[1]
    w = min(window, s)
    slots = torch.arange(s - w, s, device=kv.device) % window
    ring = torch.zeros(kv.shape[:1] + (window,) + kv.shape[2:], dtype=kv.dtype, device=kv.device)
    ring[:, slots] = kv[:, s - w:]
    return ring


class Model(nn.Module):
    """The families' base: the embeddings (``embed`` (Vp, D), ``final_norm``,
    ``unembed`` (D, Vp) unless tied) and the entry points' shared parts."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = L._param((vp, d), cfg, device)
        self.final_norm = L.Norm(cfg, device)
        self.unembed = None if cfg.tie_embeddings else L._param((d, vp), cfg, device)
        self.register_buffer("vocab_pad_bias", torch.from_numpy(_vocab_pad_bias(cfg)).to(device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (on the model's device)
        with the reference's scales; norms are ones and zeros, gates zero."""
        L._normal_(self.embed, 1.0, generator)
        if self.unembed is not None:
            L._normal_(self.unembed, 1.0 / np.sqrt(self.cfg.d_model), generator)
        for m in self.modules():
            if m is not self and hasattr(m, "draw"):
                m.draw(generator)
        return self

    def _kv(self, *shape):
        cfg = self.cfg
        return torch.zeros(shape + (cfg.n_kv_heads, cfg.d_head), dtype=torch_dtype(cfg.dtype),
                           device=self.device)

    def _input(self, x):
        return torch.as_tensor(x, device=self.device)

    def _tokens(self, tokens):
        return self._input(tokens).long()


# ===========================================================================
# dense decoder (yi, internlm2, nemotron) — also the base for moe
# ===========================================================================

class Block(nn.Module):
    """``_init_block``: ``ln1``, ``ln2``, ``attn`` and ``mlp`` (an ``Mlp`` or a ``Moe``)."""

    def __init__(self, cfg: ModelConfig, device=None, moe: bool = False):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, device)
        self.mlp = L.Moe(cfg, device) if moe else L.Mlp(cfg, device)


def _block_fwd(p: Block, x, cfg: ModelConfig, *, window=0):
    """-> (x, aux, k, v): the block's output, its MoE aux loss (0 for a dense
    block) and the roped keys and values its attention used."""
    y, k, v = L._attend(p.attn, L.apply_norm(p.ln1, x, cfg), cfg, window=window)
    x = x + y
    h = L.apply_norm(p.ln2, x, cfg)
    if isinstance(p.mlp, L.Moe):
        y, aux = L.apply_moe(p.mlp, h, cfg)
        return x + y, aux, k, v
    return x + L.apply_mlp(p.mlp, h, cfg), torch.zeros((), device=x.device), k, v


def _block_decode(p: Block, x, cfg: ModelConfig, k_c, v_c, pos, *, window=0):
    h = L.apply_norm(p.ln1, x, cfg)
    y, k_c, v_c = L.attention_decode(p.attn, h, cfg, k_c, v_c, pos, window=window)
    x = x + y
    h = L.apply_norm(p.ln2, x, cfg)
    if isinstance(p.mlp, L.Moe):
        y, _ = L.apply_moe(p.mlp, h, cfg)
    else:
        y = L.apply_mlp(p.mlp, h, cfg)
    return x + y, k_c, v_c


class Decoder(Model):
    """``build_decoder``: dense | moe | local_global dense (gemma3-style).

    For local_global, layer order is groups of ``global_every - 1`` local
    (windowed) layers and one global layer, then ``n_layers % global_every``
    local tail layers; each layer's cache lives at its place in the
    reference's stacked leaves (``lk[g, i]``, ``gk[g]``, ``tk[t]``).
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        moe = cfg.family == "moe"
        nl = cfg.n_layers
        self.layers = nn.ModuleList(Block(cfg, device, moe) for _ in range(nl))
        self.lg = cfg.attn_pattern == "local_global"
        if not self.lg:
            # (cache k leaf, cache v leaf, index in the leaf, window)
            self.cache_at = [("k", "v", (j,), 0) for j in range(nl)]
            return
        per = cfg.global_every
        self.n_groups = nl // per
        self.n_tail = nl - self.n_groups * per
        self.cache_at = []
        for g in range(self.n_groups):
            self.cache_at += [("lk", "lv", (g, i), cfg.window) for i in range(per - 1)]
            self.cache_at.append(("gk", "gv", (g,), 0))
        self.cache_at += [("tk", "tv", (t,), cfg.window) for t in range(self.n_tail)]

    def forward_blocks(self, x):
        aux_total = torch.zeros((), device=x.device)
        for p, (_, _, _, window) in zip(self.layers, self.cache_at):
            x, aux, _, _ = _block_fwd(p, x, self.cfg, window=window)
            aux_total = aux_total + aux
        return x, aux_total

    def train_loss(self, batch):
        cfg = self.cfg
        x = embed(self, self._tokens(batch["tokens"]), cfg)
        x, aux = self.forward_blocks(x)
        logits = unembed(self, x, cfg)
        loss = xent_loss(logits, self._input(batch["labels"]))
        return loss + 0.01 * aux, {"xent": loss, "aux": aux}

    def init_cache(self, batch_size: int, max_seq: int) -> Dict[str, torch.Tensor]:
        if not self.lg:
            nl = self.cfg.n_layers
            return {"k": self._kv(nl, batch_size, max_seq), "v": self._kv(nl, batch_size, max_seq)}
        w, per, ng = self.cfg.window, self.cfg.global_every, self.n_groups
        c = {
            "lk": self._kv(ng, per - 1, batch_size, w),
            "lv": self._kv(ng, per - 1, batch_size, w),
            "gk": self._kv(ng, batch_size, max_seq),
            "gv": self._kv(ng, batch_size, max_seq),
        }
        if self.n_tail:
            c["tk"] = self._kv(self.n_tail, batch_size, w)
            c["tv"] = self._kv(self.n_tail, batch_size, w)
        return c

    def prefill(self, batch):
        """Full-sequence forward; emits last-position logits + a filled cache."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        bsz, s = tokens.shape
        cache = self.init_cache(bsz, batch.get("max_seq", s))
        x = embed(self, tokens, cfg)
        for p, (kn, vn, at, window) in zip(self.layers, self.cache_at):
            x, _, k, v = _block_fwd(p, x, cfg, window=window)
            if window:
                cache[kn][at] = _ring_fill(k, window)
                cache[vn][at] = _ring_fill(v, window)
            else:
                cache[kn][at][:, :s] = k
                cache[vn][at][:, :s] = v
        logits = unembed(self, x[:, -1:, :], cfg)
        return logits[:, 0], cache

    def decode_step(self, cache, tokens, pos):
        cfg = self.cfg
        pos = int(pos)
        x = embed(self, self._tokens(tokens)[:, None], cfg)
        cache = {name: leaf.clone() for name, leaf in cache.items()}
        for p, (kn, vn, at, window) in zip(self.layers, self.cache_at):
            x, _, _ = _block_decode(p, x, cfg, cache[kn][at], cache[vn][at], pos, window=window)
        return unembed(self, x[:, 0, :], cfg), cache


def build_decoder(cfg: ModelConfig, device=None) -> Decoder:
    return Decoder(cfg, device)


# ===========================================================================
# ssm (falcon-mamba) and hybrid (zamba2)
# ===========================================================================

# the mixer module, its full-sequence forward, its decode step and its state
_MIXERS = {
    "mamba1": (S.Mamba1, S.mamba1_forward, S.mamba1_step, S.mamba1_init_state),
    "mamba2": (S.Mamba2, S.mamba2_forward, S.mamba2_step, S.mamba2_init_state),
}


class SsmBlock(nn.Module):
    """A state-space block: ``ln`` and ``mixer`` (a ``Mamba1`` or a ``Mamba2``)."""

    def __init__(self, cfg: ModelConfig, device=None, kind: str = "mamba2"):
        super().__init__()
        self.kind = kind
        self.ln = L.Norm(cfg, device)
        self.mixer = _MIXERS[kind][0](cfg, device)


def _ssm_block_fwd(bp: SsmBlock, x, cfg: ModelConfig, return_state: bool = False):
    """-> x, or (x, the decode state after the last position)."""
    h = L.apply_norm(bp.ln, x, cfg)
    if return_state:
        y, st = _MIXERS[bp.kind][1](bp.mixer, h, cfg, return_state=True)
        return x + y, st
    return x + _MIXERS[bp.kind][1](bp.mixer, h, cfg)


def _ssm_block_step(bp: SsmBlock, x, st, cfg: ModelConfig):
    h = L.apply_norm(bp.ln, x, cfg)
    y, st = _MIXERS[bp.kind][2](bp.mixer, h, st, cfg)
    return x + y, st


def _stack_states(states):
    """A list of state dicts -> one dict of leaves stacked on a new first axis."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _zero_states(st, lead):
    return {k: torch.zeros(lead + tuple(t.shape), dtype=t.dtype, device=t.device) for k, t in st.items()}


class Ssm(Model):
    """``build_ssm`` (falcon-mamba): ``layers`` of ``SsmBlock``s of
    ``cfg.ssm_kind``. The cache is ``{"states": {"conv": (L, B, K-1, C),
    "ssm": (L, B, ...)}}``; ``decode_step`` reads no position."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.layers = nn.ModuleList(SsmBlock(cfg, device, cfg.ssm_kind) for _ in range(cfg.n_layers))

    def train_loss(self, batch):
        cfg = self.cfg
        x = embed(self, self._tokens(batch["tokens"]), cfg)
        for bp in self.layers:
            x = _ssm_block_fwd(bp, x, cfg)
        logits = unembed(self, x, cfg)
        loss = xent_loss(logits, self._input(batch["labels"]))
        return loss, {"xent": loss}

    def init_cache(self, batch_size: int, max_seq: int):
        st = _MIXERS[self.cfg.ssm_kind][3](self.cfg, batch_size, self.device)
        return {"states": _zero_states(st, (self.cfg.n_layers,))}

    def prefill(self, batch):
        cfg = self.cfg
        x = embed(self, self._tokens(batch["tokens"]), cfg)
        states = []
        for bp in self.layers:
            x, st = _ssm_block_fwd(bp, x, cfg, return_state=True)
            states.append(st)
        logits = unembed(self, x[:, -1:, :], cfg)
        return logits[:, 0], {"states": _stack_states(states)}

    def decode_step(self, cache, tokens, pos):
        cfg = self.cfg
        x = embed(self, self._tokens(tokens)[:, None], cfg)[:, 0]
        states = []
        for j, bp in enumerate(self.layers):
            x, st = _ssm_block_step(bp, x, {k: v[j] for k, v in cache["states"].items()}, cfg)
            states.append(st)
        return unembed(self, x, cfg), {"states": _stack_states(states)}


def build_ssm(cfg: ModelConfig, device=None) -> Ssm:
    return Ssm(cfg, device)


class SharedAttn(nn.Module):
    """``shared_attn``: ``ln`` and ``attn``, one set of weights."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, device)


class Hybrid(Model):
    """``build_hybrid`` (zamba2): a Mamba-2 backbone and one shared attention
    block. ``layers`` are ``n_layers // shared_attn_every`` groups of
    ``shared_attn_every`` Mamba-2 blocks, ``shared_attn`` applied after each
    group, then the ``n_layers % shared_attn_every`` tail blocks. The cache
    holds ``g_states`` (G, per, B, ...), the shared block's keys and values
    of every group ``shared_k``/``shared_v`` (G, B, max_seq, N_kv, Dh) and
    ``t_states`` (T, B, ...) when there is a tail."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.per = cfg.shared_attn_every
        self.n_groups = cfg.n_layers // self.per
        self.n_tail = cfg.n_layers - self.n_groups * self.per
        self.layers = nn.ModuleList(SsmBlock(cfg, device, "mamba2") for _ in range(cfg.n_layers))
        self.shared_attn = SharedAttn(cfg, device)

    def _group(self, g: int):
        return self.layers[g * self.per:(g + 1) * self.per]

    def _tail(self):
        return self.layers[self.n_groups * self.per:]

    def train_loss(self, batch):
        cfg = self.cfg
        sp = self.shared_attn
        x = embed(self, self._tokens(batch["tokens"]), cfg)
        for g in range(self.n_groups):
            for bp in self._group(g):
                x = _ssm_block_fwd(bp, x, cfg)
            x = x + L.attention(sp.attn, L.apply_norm(sp.ln, x, cfg), cfg)
        for bp in self._tail():
            x = _ssm_block_fwd(bp, x, cfg)
        logits = unembed(self, x, cfg)
        loss = xent_loss(logits, self._input(batch["labels"]))
        return loss, {"xent": loss}

    def init_cache(self, batch_size: int, max_seq: int):
        st = S.mamba2_init_state(self.cfg, batch_size, self.device)
        ng = self.n_groups
        cache = {"g_states": _zero_states(st, (ng, self.per)),
                 "shared_k": self._kv(ng, batch_size, max_seq),
                 "shared_v": self._kv(ng, batch_size, max_seq)}
        if self.n_tail:
            cache["t_states"] = _zero_states(st, (self.n_tail,))
        return cache

    def prefill(self, batch):
        """The shared block's keys are roped at ``arange(s)``, its values are
        not; both are zero-padded to ``max_seq``."""
        cfg = self.cfg
        sp = self.shared_attn
        tokens = self._tokens(batch["tokens"])
        bsz, s = tokens.shape
        max_seq = batch.get("max_seq", s)
        cache = {"shared_k": self._kv(self.n_groups, bsz, max_seq),
                 "shared_v": self._kv(self.n_groups, bsz, max_seq)}
        x = embed(self, tokens, cfg)
        g_states = []
        for g in range(self.n_groups):
            states = []
            for bp in self._group(g):
                x, st = _ssm_block_fwd(bp, x, cfg, return_state=True)
                states.append(st)
            g_states.append(_stack_states(states))
            y, k, v = L._attend(sp.attn, L.apply_norm(sp.ln, x, cfg), cfg)
            cache["shared_k"][g, :, :s] = k
            cache["shared_v"][g, :, :s] = v
            x = x + y
        cache["g_states"] = _stack_states(g_states)
        if self.n_tail:
            states = []
            for bp in self._tail():
                x, st = _ssm_block_fwd(bp, x, cfg, return_state=True)
                states.append(st)
            cache["t_states"] = _stack_states(states)
        logits = unembed(self, x[:, -1:, :], cfg)
        return logits[:, 0], cache

    def decode_step(self, cache, tokens, pos):
        cfg = self.cfg
        sp = self.shared_attn
        pos = int(pos)
        x = embed(self, self._tokens(tokens)[:, None], cfg)[:, 0]
        sk, sv = cache["shared_k"].clone(), cache["shared_v"].clone()
        g_states = []
        for g in range(self.n_groups):
            states = []
            for i, bp in enumerate(self._group(g)):
                x, st = _ssm_block_step(bp, x, {k: v[g, i] for k, v in cache["g_states"].items()}, cfg)
                states.append(st)
            g_states.append(_stack_states(states))
            h = L.apply_norm(sp.ln, x[:, None, :], cfg)
            y, _, _ = L.attention_decode(sp.attn, h, cfg, sk[g], sv[g], pos)
            x = x + y[:, 0]
        new_cache = {"g_states": _stack_states(g_states), "shared_k": sk, "shared_v": sv}
        if self.n_tail:
            states = []
            for t, bp in enumerate(self._tail()):
                x, st = _ssm_block_step(bp, x, {k: v[t] for k, v in cache["t_states"].items()}, cfg)
                states.append(st)
            new_cache["t_states"] = _stack_states(states)
        return unembed(self, x, cfg), new_cache


def build_hybrid(cfg: ModelConfig, device=None) -> Hybrid:
    return Hybrid(cfg, device)


# ===========================================================================
# encoder-decoder (whisper) — stubbed audio frontend (frame embeddings in)
# ===========================================================================

class DecBlock(nn.Module):
    """A decoder block: ``ln1``, ``ln_x``, ``ln2``, ``self`` and ``cross``
    attention, ``mlp`` (the reference's ``dec_blocks`` keys)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.ln_x = L.Norm(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.self = L.Attention(cfg, device)
        self.cross = L.Attention(cfg, device)
        self.mlp = L.Mlp(cfg, device)


def _dec_block(bp: DecBlock, x, enc_out, cfg: ModelConfig):
    """-> (x, k, v, cross_k, cross_v)."""
    h = L.apply_norm(bp.ln1, x, cfg)
    y, k, v = L._attend(bp.self, h, cfg)
    x = x + y
    h = L.apply_norm(bp.ln_x, x, cfg)
    y, ck, cv = L._attend(bp.cross, h, cfg, kv_input=enc_out, causal=False)
    x = x + y
    h = L.apply_norm(bp.ln2, x, cfg)
    return x + L.apply_mlp(bp.mlp, h, cfg), k, v, ck, cv


class EncDec(Model):
    """``build_encdec``: ``enc_blocks``, ``dec_blocks`` and ``enc_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.enc_blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device) for _ in range(cfg.n_layers))
        self.enc_norm = L.Norm(cfg, device)

    def encode(self, frames):
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        x = self._input(frames).to(dtype)
        x = x + torch.from_numpy(sinusoidal_pos(x.shape[1], cfg.d_model)).to(self.device, dtype)
        for bp in self.enc_blocks:
            h = L.apply_norm(bp.ln1, x, cfg)
            x = x + L.attention(bp.attn, h, cfg, causal=False)
            h = L.apply_norm(bp.ln2, x, cfg)
            x = x + L.apply_mlp(bp.mlp, h, cfg)
        return L.apply_norm(self.enc_norm, x, cfg)

    def train_loss(self, batch):
        cfg = self.cfg
        enc_out = self.encode(batch["enc_embed"])
        x = embed(self, self._tokens(batch["tokens"]), cfg)
        for bp in self.dec_blocks:
            x = _dec_block(bp, x, enc_out, cfg)[0]
        logits = unembed(self, x, cfg)
        loss = xent_loss(logits, self._input(batch["labels"]))
        return loss, {"xent": loss}

    def init_cache(self, batch_size: int, max_seq: int, enc_seq: Optional[int] = None):
        se = enc_seq or self.cfg.enc_seq
        nd = self.cfg.n_layers
        return {
            "self_k": self._kv(nd, batch_size, max_seq),
            "self_v": self._kv(nd, batch_size, max_seq),
            "cross_k": self._kv(nd, batch_size, se),
            "cross_v": self._kv(nd, batch_size, se),
        }

    def prefill(self, batch):
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        bsz, s = tokens.shape
        enc_out = self.encode(batch["enc_embed"])
        cache = self.init_cache(bsz, batch.get("max_seq", s), enc_out.shape[1])
        x = embed(self, tokens, cfg)
        for i, bp in enumerate(self.dec_blocks):
            x, k, v, ck, cv = _dec_block(bp, x, enc_out, cfg)
            cache["self_k"][i, :, :s] = k
            cache["self_v"][i, :, :s] = v
            cache["cross_k"][i] = ck
            cache["cross_v"][i] = cv
        logits = unembed(self, x[:, -1:, :], cfg)
        return logits[:, 0], cache

    def decode_step(self, cache, tokens, pos):
        cfg = self.cfg
        pos = int(pos)
        x = embed(self, self._tokens(tokens)[:, None], cfg)
        sk, sv = cache["self_k"].clone(), cache["self_v"].clone()
        for i, bp in enumerate(self.dec_blocks):
            h = L.apply_norm(bp.ln1, x, cfg)
            y, _, _ = L.attention_decode(bp.self, h, cfg, sk[i], sv[i], pos)
            x = x + y
            h = L.apply_norm(bp.ln_x, x, cfg)
            x = x + L.attention_decode_cross(bp.cross, h, cfg, cache["cross_k"][i], cache["cross_v"][i])
            h = L.apply_norm(bp.ln2, x, cfg)
            x = x + L.apply_mlp(bp.mlp, h, cfg)
        return unembed(self, x[:, 0, :], cfg), dict(cache, self_k=sk, self_v=sv)


def build_encdec(cfg: ModelConfig, device=None) -> EncDec:
    return EncDec(cfg, device)


# ===========================================================================
# vlm (llama-3.2-vision): every Nth layer cross-attends to patch embeddings
# ===========================================================================

class CrossBlock(nn.Module):
    """A cross block: ``ln1``, ``ln2``, ``attn``, ``mlp`` and a scalar
    ``gate``, zero at init (the reference's ``cross_blocks`` keys)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, device)
        self.mlp = L.Mlp(cfg, device)
        self.gate = L._param((), cfg, device, 0.0)

    def draw(self, generator: torch.Generator) -> None:
        self.gate.zero_()


def _gate(bp: CrossBlock, cfg: ModelConfig):
    return torch.tanh(bp.gate).to(torch_dtype(cfg.dtype))


def _cross_block(bp: CrossBlock, x, img, cfg: ModelConfig):
    """-> (x, cross_k, cross_v)."""
    h = L.apply_norm(bp.ln1, x, cfg)
    y, ck, cv = L._attend(bp.attn, h, cfg, kv_input=img, causal=False)
    x = x + _gate(bp, cfg) * y
    h = L.apply_norm(bp.ln2, x, cfg)
    return x + L.apply_mlp(bp.mlp, h, cfg), ck, cv


class Vlm(Model):
    """``build_vlm``: ``layers`` in order, each group ``cross_attn_every - 1``
    self-attention ``Block``s and one ``CrossBlock``; a self layer's cache
    lives at ``self_k[g, i]``, a cross block's at ``cross_k[g]``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        per = cfg.cross_attn_every
        self.n_groups = cfg.n_layers // per
        self.n_self = per - 1
        self.layers = nn.ModuleList()
        self.cache_at = []  # (group, index in the group; None for the cross block)
        for g in range(self.n_groups):
            for i in range(self.n_self):
                self.layers.append(Block(cfg, device))
                self.cache_at.append((g, i))
            self.layers.append(CrossBlock(cfg, device))
            self.cache_at.append((g, None))

    def _img(self, batch):
        return self._input(batch["img_embed"]).to(torch_dtype(self.cfg.dtype))

    def train_loss(self, batch):
        cfg = self.cfg
        img = self._img(batch)
        x = embed(self, self._tokens(batch["tokens"]), cfg)
        for bp in self.layers:
            x = (_cross_block(bp, x, img, cfg) if isinstance(bp, CrossBlock)
                 else _block_fwd(bp, x, cfg))[0]
        logits = unembed(self, x, cfg)
        loss = xent_loss(logits, self._input(batch["labels"]))
        return loss, {"xent": loss}

    def init_cache(self, batch_size: int, max_seq: int, n_img: Optional[int] = None):
        ni = n_img or self.cfg.n_img_tokens
        ng, ns = self.n_groups, self.n_self
        return {
            "self_k": self._kv(ng, ns, batch_size, max_seq),
            "self_v": self._kv(ng, ns, batch_size, max_seq),
            "cross_k": self._kv(ng, batch_size, ni),
            "cross_v": self._kv(ng, batch_size, ni),
        }

    def prefill(self, batch):
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        bsz, s = tokens.shape
        img = self._img(batch)
        cache = self.init_cache(bsz, batch.get("max_seq", s), img.shape[1])
        x = embed(self, tokens, cfg)
        for bp, (g, i) in zip(self.layers, self.cache_at):
            if i is None:
                x, ck, cv = _cross_block(bp, x, img, cfg)
                cache["cross_k"][g] = ck
                cache["cross_v"][g] = cv
            else:
                x, _, k, v = _block_fwd(bp, x, cfg)
                cache["self_k"][g, i, :, :s] = k
                cache["self_v"][g, i, :, :s] = v
        logits = unembed(self, x[:, -1:, :], cfg)
        return logits[:, 0], cache

    def decode_step(self, cache, tokens, pos):
        cfg = self.cfg
        pos = int(pos)
        x = embed(self, self._tokens(tokens)[:, None], cfg)
        sk, sv = cache["self_k"].clone(), cache["self_v"].clone()
        for bp, (g, i) in zip(self.layers, self.cache_at):
            if i is None:
                h = L.apply_norm(bp.ln1, x, cfg)
                x = x + _gate(bp, cfg) * L.attention_decode_cross(
                    bp.attn, h, cfg, cache["cross_k"][g], cache["cross_v"][g])
                h = L.apply_norm(bp.ln2, x, cfg)
                x = x + L.apply_mlp(bp.mlp, h, cfg)
            else:
                x, _, _ = _block_decode(bp, x, cfg, sk[g, i], sv[g, i], pos)
        return unembed(self, x[:, 0, :], cfg), dict(cache, self_k=sk, self_v=sv)


def build_vlm(cfg: ModelConfig, device=None) -> Vlm:
    return Vlm(cfg, device)


# ===========================================================================
# dispatch
# ===========================================================================

def build_model(cfg: ModelConfig, device=None) -> Model:
    """The family's module with its parameters allocated (not drawn: call
    ``init``) on ``device``: the CUDA card when None, ``"cpu"`` on request,
    ``"meta"`` for shapes without memory."""
    device = torch.device("cuda" if device is None else device)
    if cfg.family in ("dense", "moe"):
        return build_decoder(cfg, device)
    if cfg.family == "ssm":
        return build_ssm(cfg, device)
    if cfg.family == "hybrid":
        return build_hybrid(cfg, device)
    if cfg.family == "encdec":
        return build_encdec(cfg, device)
    if cfg.family == "vlm":
        return build_vlm(cfg, device)
    raise ValueError(f"unknown family {cfg.family}")
