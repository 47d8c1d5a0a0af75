"""Shared transformer layers on PyTorch (the counterpart of ``repro.models.layers``).

Conventions (as the reference's):
  x: (B, S, D) activations in cfg.dtype; parameters in cfg.param_dtype,
  cast to cfg.dtype at use (``cast``); attention caches: k/v (B, S_cache,
  N_kv, Dh).

Each parameter group is an ``nn.Module`` (``Norm``, ``Attention``, ``Mlp``,
``Moe``: the reference's ``init_norm``, ``init_attention``, ``init_mlp`` and
``init_moe``) whose attributes carry the reference's pytree keys (``wq``,
``wk``, ``scale``, ``router``, ...), so a parameter's name says which leaf
of the reference's tree it is (``models/convert.py``). ``draw(generator)``
fills a module's parameters with the reference's initial scales.
Parameters are made with ``requires_grad=False``, so that serving records
no graph; ``launch.steps.make_train_step`` turns gradients on for the
model it trains. The functions keep the reference's names and arithmetic: the
same einsum orders, float32 softmax and norms, ``NEG_INF`` masks and
GShard capacity dispatch, on plain torch operations.

Not ported: ``ACT_RULES`` and ``constrain``, the reference's activation
sharding hints, which its TPU launch layer sets while lowering onto a
device mesh (ROADMAP A15).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig, torch_dtype

NEG_INF = -1e9  # additive mask value (bf16-safe)


def cast(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x.to(torch_dtype(cfg.dtype))


def _param(shape, cfg: ModelConfig, device, fill=None) -> nn.Parameter:
    dtype = torch_dtype(cfg.param_dtype)
    if fill is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = torch.full(shape, fill, dtype=dtype, device=device)
    return nn.Parameter(t, requires_grad=False)


def _normal_(p: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    p.normal_(0.0, scale, generator=generator)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """``init_norm``: ``scale`` (ones) and, for LayerNorm, ``bias`` (zeros)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.scale = _param((cfg.d_model,), cfg, device, 1.0)
        self.bias = _param((cfg.d_model,), cfg, device, 0.0) if cfg.use_layernorm else None

    def draw(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()



def apply_norm(p: Norm, x: torch.Tensor, cfg: ModelConfig, eps=1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.use_layernorm:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p.scale.float() + p.bias.float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p.scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, N, Dh), positions: (B, S) or (S,) integer; rotates the two
    halves of each head. The frequencies are float32, as the reference's
    numpy ones, computed on x's device (no host copy per call)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, causal / sliding-window / cross)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """``init_attention``: ``wq`` (D, Nh*Dh), ``wk``/``wv`` (D, Nkv*Dh), ``wo`` (Nh*Dh, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, nh, nk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = _param((d, nh * dh), cfg, device)
        self.wk = _param((d, nk * dh), cfg, device)
        self.wv = _param((d, nk * dh), cfg, device)
        self.wo = _param((nh * dh, d), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        sc = 1.0 / math.sqrt(self.wq.shape[0])
        for w in (self.wq, self.wk, self.wv):
            _normal_(w, sc, generator)
        _normal_(self.wo, 1.0 / math.sqrt(self.wo.shape[0]), generator)



def _qkv(p: Attention, x, cfg: ModelConfig, kv_input=None):
    b, s, _ = x.shape
    nh, nk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kv_in = x if kv_input is None else kv_input
    q = (x @ cast(p.wq, cfg)).reshape(b, s, nh, dh)
    k = (kv_in @ cast(p.wk, cfg)).reshape(b, kv_in.shape[1], nk, dh)
    v = (kv_in @ cast(p.wv, cfg)).reshape(b, kv_in.shape[1], nk, dh)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: (B,Sq,Nh,Dh), k/v: (B,Sk,Nkv,Dh), mask: (B|1, Sq, Sk) bool or None.

    Query heads are grouped contiguously per KV head; the logits' product
    runs in q's dtype and is then cast to float32; masked logits are
    ``NEG_INF``; the float32 softmax is cast back before the second product.
    """
    b, sq, nh, dh = q.shape
    nk = k.shape[2]
    g = nh // nk
    qg = q.reshape(b, sq, nk, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    logits = logits / math.sqrt(dh)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v).reshape(b, sq, nh * dh)


def causal_mask(sq: int, sk: int, offset: int = 0, window: int = 0, device=None):
    """bool (1, sq, sk): query i attends keys j with j <= i+offset
    and (window == 0 or j > i+offset-window)."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window:
        m = m & (kj > qi - window)
    return m[None]


def _attend(p: Attention, x, cfg: ModelConfig, *, window: int = 0, positions=None,
            kv_input=None, causal: bool = True):
    """``attention``, also returning the (roped) keys and the values it used."""
    s = x.shape[1]
    q, k, v = _qkv(p, x, cfg, kv_input=kv_input)
    if kv_input is None:  # self-attention: rope over shared positions
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        mask = causal_mask(s, s, 0, window, device=x.device) if causal else None
    else:
        mask = None  # cross-attention: all encoder/image tokens visible
    out = _sdpa(q, k, v, mask, cfg)
    return out @ cast(p.wo, cfg), k, v


def attention(p: Attention, x, cfg: ModelConfig, *, window: int = 0, positions=None,
              kv_input=None, causal: bool = True):
    """Full-sequence attention (training / prefill)."""
    return _attend(p, x, cfg, window=window, positions=positions, kv_input=kv_input,
                   causal=causal)[0]


def attention_decode(p: Attention, x, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                     window: int = 0):
    """One-token decode with cache update.

    x: (B, 1, D); cache_k/v: (B, C, Nkv, Dh); pos: the new token's absolute
    position. For windowed layers the cache is a ring buffer of C == window
    slots (slot = pos % C); for full layers C == max_seq. The new key and
    value are written into ``cache_k``/``cache_v`` in place (callers pass
    their own copies) at the slot clamped to [0, C-1], as the reference's
    ``dynamic_update_slice`` clamps its start.
    """
    c = cache_k.shape[1]
    q, k, v = _qkv(p, x, cfg)
    at = torch.full((1,), pos, device=x.device)
    q = rope(q, at, cfg.rope_theta)
    k = rope(k, at, cfg.rope_theta)
    slot = min(max(pos % max(c, 1) if window else pos, 0), c - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    kj = torch.arange(c, device=x.device)
    if window:
        # ring fill state: every resident slot is within the window once
        # pos >= c; before that only slots <= pos are live
        valid = (kj <= pos % c) | (pos >= c)
    else:
        valid = kj <= pos
    out = _sdpa(q, cache_k, cache_v, valid[None, None, :], cfg)
    return out @ cast(p.wo, cfg), cache_k, cache_v


def attention_decode_cross(p: Attention, x, cfg: ModelConfig, cross_k, cross_v):
    """Decode-time cross attention against precomputed encoder K/V (the
    reference projects k and v of x too and drops them; only q is needed)."""
    b, s, _ = x.shape
    q = (x @ cast(p.wq, cfg)).reshape(b, s, cfg.n_heads, cfg.d_head)
    out = _sdpa(q, cross_k, cross_v, None, cfg)
    return out @ cast(p.wo, cfg)


def cross_kv(p: Attention, enc_out, cfg: ModelConfig):
    b, se, _ = enc_out.shape
    nk, dh = cfg.n_kv_heads, cfg.d_head
    k = (enc_out @ cast(p.wk, cfg)).reshape(b, se, nk, dh)
    v = (enc_out @ cast(p.wv, cfg)).reshape(b, se, nk, dh)
    return k, v


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def _activation(h, cfg: ModelConfig):
    if cfg.act == "squared_relu":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form


class Mlp(nn.Module):
    """``init_mlp``: ``wo`` (F, D); ``wg`` and ``wi`` (D, F) for swiglu, else ``wi``."""

    def __init__(self, cfg: ModelConfig, device=None, d_ff: Optional[int] = None):
        super().__init__()
        d = cfg.d_model
        f = d_ff if d_ff is not None else cfg.d_ff
        self.wo = _param((f, d), cfg, device)
        self.wg = _param((d, f), cfg, device) if cfg.act == "swiglu" else None
        self.wi = _param((d, f), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        sc = 1.0 / math.sqrt(self.wi.shape[0])
        _normal_(self.wo, 1.0 / math.sqrt(self.wo.shape[0]), generator)
        if self.wg is not None:
            _normal_(self.wg, sc, generator)
        _normal_(self.wi, sc, generator)



def apply_mlp(p: Mlp, x, cfg: ModelConfig):
    if cfg.act == "swiglu":
        g = x @ cast(p.wg, cfg)
        h = x @ cast(p.wi, cfg)
        a = F.silu(g) * h
    else:
        a = _activation(x @ cast(p.wi, cfg), cfg)
    return a @ cast(p.wo, cfg)


# ---------------------------------------------------------------------------
# mixture of experts (GShard-style capacity dispatch)
# ---------------------------------------------------------------------------

class Moe(nn.Module):
    """``init_moe``: ``router`` (D, E); ``wg``/``wi`` (E, D, Fe); ``wo`` (E, Fe, D);
    ``shared``, an ``Mlp`` of width Fe * n_shared_experts, where configured (a
    submodule: the model's ``init`` draws it as it draws every module)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
        self.router = _param((d, e), cfg, device)
        self.wg = _param((e, d, fe), cfg, device)
        self.wi = _param((e, d, fe), cfg, device)
        self.wo = _param((e, fe, d), cfg, device)
        self.shared = (Mlp(cfg, device, d_ff=fe * cfg.n_shared_experts)
                       if cfg.n_shared_experts else None)

    def draw(self, generator: torch.Generator) -> None:
        sc = 1.0 / math.sqrt(self.router.shape[0])
        for w in (self.router, self.wg, self.wi):
            _normal_(w, sc, generator)
        _normal_(self.wo, 1.0 / math.sqrt(self.wo.shape[1]), generator)



def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    cap = int(np.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def apply_moe(p: Moe, x, cfg: ModelConfig):
    """Top-k routed experts with static capacity (overflow tokens dropped —
    standard GShard semantics; aux load-balance loss returned).

    Ties in the top-k go to the lower expert index (a stable descending
    sort), as ``jax.lax.top_k``. Overflowing (token, choice) pairs are
    written to one extra expert row that is then dropped, and their gathered
    outputs are zeroed, where the reference relies on a dropping scatter and
    a clamped gather.
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, t)
    xt = x.reshape(t, d)

    logits = (xt @ cast(p.router, cfg)).float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eidx = order.values[:, :k], order.indices[:, :k]  # (t, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert's capacity buffer:
    # an exclusive cumsum over the token-major (t, k) order
    flat_oh = F.one_hot(eidx, e).reshape(t * k, e)
    pos_in_e = torch.cumsum(flat_oh, dim=0) - flat_oh
    pos = (pos_in_e * flat_oh).sum(-1).reshape(t, k)
    fits = pos < cap

    # dispatch: scatter tokens into (e, cap, d); overflow lands in row e
    ei = torch.where(fits, eidx, e)
    pi = torch.where(fits, pos, 0)
    buf = torch.zeros((e + 1, cap, d), dtype=x.dtype, device=x.device)
    buf[ei, pi] = xt[:, None, :].expand(t, k, d)
    buf = buf[:e]

    # expert FFN over stacked experts
    if cfg.act == "swiglu":
        g = torch.bmm(buf, cast(p.wg, cfg))
        h = torch.bmm(buf, cast(p.wi, cfg))
        a = F.silu(g) * h
    else:
        a = _activation(torch.bmm(buf, cast(p.wi, cfg)), cfg)
    out_buf = torch.bmm(a, cast(p.wo, cfg))

    # combine: gather back and weight
    gathered = out_buf[torch.clamp(ei, max=e - 1), pi]  # (t, k, d)
    gathered = torch.where(fits[..., None], gathered, 0.0)
    yt = (gathered * gate_vals[..., None].to(x.dtype)).sum(1)

    if p.shared is not None:
        yt = yt + apply_mlp(p.shared, xt[None], cfg)[0]

    # load-balance aux loss (Switch): e * sum_e f_e * p_e
    me = probs.mean(0)
    frac = F.one_hot(eidx, e).float().sum((0, 1)) / (t * k)
    aux = e * (frac * me).sum()
    return yt.reshape(b, s, d), aux
