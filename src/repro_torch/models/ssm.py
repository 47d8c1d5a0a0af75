"""State-space blocks on PyTorch: Mamba-1 (selective scan) and Mamba-2 (SSD,
chunked). The counterpart of ``repro.models.ssm``.

The functions keep the reference's names and arithmetic: the same dtype at
each step (projections and the convolution in the compute dtype, the scans
in float32), the same float32 islands and the same epsilons. The reference
computes its scans with XLA operations, not Pallas kernels, so the port's
counterpart is plain torch on tensors.

Mamba-1 keeps the reference's memory-chunked scan: an outer loop over
sequence chunks carries the float32 state (B, Di, Ds), so the
(B, S, Di, Ds) tensor never materialises. Inside a chunk the linear
recurrence h_t = a_t h_{t-1} + b_t is a log-depth Hillis-Steele doubling
along the chunk axis (``_scan_linear``), the counterpart of the reference's
``lax.associative_scan``:

* torch has no public associative scan (``torch._higher_order_ops`` is
  private);
* the closed form ``cumprod(a)`` followed by a division underflows: exp(dt A)
  multiplied over 512 positions can reach 0 in float32, and dividing by it
  gives inf or NaN;
* a loop over positions would be S x n_layers Python iterations.

Mamba-2 keeps the SSD block-matmul form: the intra-chunk attention-like
products, the chunk-final states and a loop over chunks for the inter-chunk
recurrence (the reference's ``lax.scan``). Each of the reference's
three-operand einsums is written as two explicit two-operand steps (torch
contracts an einsum left to right unless ``opt_einsum`` is present).

Not ported: ``SCAN_ASSOC`` and ``_assoc_linear`` (the reference's unrolled
associative form for XLA cost analysis in its dry run) and the
``constrain(..., "ssm_scan")`` sharding hints, which its TPU launch layer
fills (ROADMAP A15).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _normal_, _param, cast


# ---------------------------------------------------------------------------
# causal depthwise conv1d (shared by both mamba variants)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (K, C), b: (C,) — depthwise causal convolution in
    x's dtype. Both this and the reference's ``conv_general_dilated`` are
    cross-correlations, so the (K, C) weight is transposed to (C, 1, K),
    not flipped; K - 1 zeros pad the left."""
    k, c = w.shape
    xt = F.pad(x.transpose(1, 2), (k - 1, 0))  # (B, C, K-1+S)
    out = F.conv1d(xt, w.t()[:, None, :].to(x.dtype), groups=c)
    return out.transpose(1, 2) + b.to(x.dtype)


def conv_step(conv_state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Decode-time conv: conv_state (B, K-1, C) FIFO, x_t (B, C)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return window[:, 1:], y


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba)
# ---------------------------------------------------------------------------

class Mamba1(nn.Module):
    """``init_mamba1``: ``in_proj`` (D, 2Di), ``conv_w`` (K, Di), ``conv_b``,
    ``x_proj`` (Di, R+2Ds), ``dt_proj`` (R, Di), ``dt_bias``, ``A_log``
    (Di, Ds), ``D`` and ``out_proj`` (Di, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di, ds, kc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.conv_dim
        dtr = cfg.dt_rank_eff
        self.in_proj = _param((d, 2 * di), cfg, device)
        self.conv_w = _param((kc, di), cfg, device)
        self.conv_b = _param((di,), cfg, device, 0.0)
        self.x_proj = _param((di, dtr + 2 * ds), cfg, device)
        self.dt_proj = _param((dtr, di), cfg, device)
        self.dt_bias = _param((di,), cfg, device, -4.6)  # softplus^-1(0.01)
        self.A_log = _param((di, ds), cfg, device)
        self.D = _param((di,), cfg, device, 1.0)
        self.out_proj = _param((di, d), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        for w in (self.in_proj, self.conv_w, self.x_proj, self.dt_proj, self.out_proj):
            _normal_(w, 1.0 / math.sqrt(w.shape[0]), generator)
        self.conv_b.zero_()
        self.dt_bias.fill_(-4.6)
        ds = self.A_log.shape[1]
        a = torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=self.A_log.device))
        self.A_log.copy_(a.expand_as(self.A_log))
        self.D.fill_(1.0)


def _scan_linear(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1, from h = 0:
    -> (a_1 ... a_t, h_t) at every t. Hillis-Steele doubling, out of place:
    log2(C) steps, each combining every position with the one k before."""
    c = a.shape[1]
    k = 1
    while k < c:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def _mamba1_inner(cfg, x_conv, dt, b_t, c_t, a, h0):
    """Linear recurrence h_t = exp(dt A) h_{t-1} + dt B x over one chunk.

    x_conv/dt: (B, C, Di); b_t/c_t: (B, C, Ds); a: (Di, Ds); h0: (B, Di, Ds).
    """
    da = torch.exp(dt[..., None] * a)  # (B, C, Di, Ds)
    dbx = (dt * x_conv)[..., None] * b_t[:, :, None, :]
    a_cum, b_cum = _scan_linear(da, dbx)
    del da, dbx
    h = b_cum + a_cum * h0[:, None]  # (B, C, Di, Ds)
    del a_cum, b_cum
    y = torch.sum(h * c_t[:, :, None, :], dim=-1)  # (B, C, Di)
    return y, h[:, -1].clone()  # a copy: a view would keep the chunk's h alive


def mamba1_forward(p: Mamba1, x, cfg: ModelConfig, return_state: bool = False):
    """Full-sequence Mamba-1 mixer. x: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns the decode state after position S-1
    (prefill -> decode handoff)."""
    b, s, d = x.shape
    di, ds, dtr = cfg.d_inner, cfg.d_state, cfg.dt_rank_eff
    xz = x @ cast(p.in_proj, cfg)
    x_in, z = xz[..., :di], xz[..., di:]
    x_conv = F.silu(causal_conv1d(x_in, p.conv_w, p.conv_b))

    dbc = x_conv @ cast(p.x_proj, cfg)
    dt_lr = dbc[..., :dtr]
    b_t = dbc[..., dtr:dtr + ds].float()
    c_t = dbc[..., dtr + ds:].float()
    dt = F.softplus((dt_lr @ cast(p.dt_proj, cfg)).float() + p.dt_bias.float())
    a = -torch.exp(p.A_log.float())
    xc32 = x_conv.float()

    chunk = min(cfg.scan_chunk, s)
    if s % chunk:
        chunk = s  # fall back to single chunk for odd smoke shapes
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, s, chunk):
        at = slice(lo, lo + chunk)
        y_c, h = _mamba1_inner(cfg, xc32[:, at], dt[:, at], b_t[:, at], c_t[:, at], a, h)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    y = y + p.D.float() * xc32
    y = y.to(x.dtype) * F.silu(z)
    out = y @ cast(p.out_proj, cfg)
    if return_state:
        kc = cfg.conv_dim
        conv_state = x_in.float()[:, s - kc + 1:, :].clone()
        return out, {"conv": conv_state, "ssm": h}
    return out


def mamba1_init_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.conv_dim - 1, cfg.d_inner), dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=device),
    }


def mamba1_step(p: Mamba1, x_t, state, cfg: ModelConfig):
    """One decode step. x_t: (B, D) -> (B, D); returns the new state."""
    di, ds, dtr = cfg.d_inner, cfg.d_state, cfg.dt_rank_eff
    xz = x_t @ cast(p.in_proj, cfg)
    x_in, z = xz[..., :di], xz[..., di:]
    conv_state, xc = conv_step(state["conv"], x_in.float(), p.conv_w, p.conv_b)
    xc = F.silu(xc)
    dbc = xc.to(x_t.dtype) @ cast(p.x_proj, cfg)
    dt_lr = dbc[..., :dtr]
    b_t = dbc[..., dtr:dtr + ds].float()
    c_t = dbc[..., dtr + ds:].float()
    dt = F.softplus((dt_lr @ cast(p.dt_proj, cfg)).float() + p.dt_bias.float())
    a = -torch.exp(p.A_log.float())
    da = torch.exp(dt[:, :, None] * a)  # (B, Di, Ds)
    h = da * state["ssm"] + (dt * xc)[:, :, None] * b_t[:, None, :]
    y = torch.sum(h * c_t[:, None, :], dim=-1) + p.D.float() * xc
    y = y.to(x_t.dtype) * F.silu(z)
    out = y @ cast(p.out_proj, cfg)
    return out, {"conv": conv_state, "ssm": h}


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2 backbone)
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    """``init_mamba2``: ``in_proj`` (D, 2Di+2Ds+H), ``conv_w`` (K, Di+2Ds),
    ``conv_b``, ``dt_bias`` and ``A_log`` (H; zeros), ``D`` (H; ones),
    ``norm_scale`` (Di; ones) and ``out_proj`` (Di, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di, ds, h, kc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, cfg.conv_dim
        conv_ch = di + 2 * ds
        self.in_proj = _param((d, 2 * di + 2 * ds + h), cfg, device)
        self.conv_w = _param((kc, conv_ch), cfg, device)
        self.conv_b = _param((conv_ch,), cfg, device, 0.0)
        self.dt_bias = _param((h,), cfg, device, 0.0)
        self.A_log = _param((h,), cfg, device, 0.0)
        self.D = _param((h,), cfg, device, 1.0)
        self.norm_scale = _param((di,), cfg, device, 1.0)
        self.out_proj = _param((di, d), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        for w in (self.in_proj, self.conv_w, self.out_proj):
            _normal_(w, 1.0 / math.sqrt(w.shape[0]), generator)
        self.conv_b.zero_()
        self.dt_bias.zero_()
        self.A_log.zero_()
        self.D.fill_(1.0)
        self.norm_scale.fill_(1.0)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., C) -> (..., C, C) with out[i, j] = sum_{k=j+1..i} x_k (i >= j),
    -inf above the diagonal (masked after the subtraction: no inf - inf)."""
    c = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    return torch.where(mask, ss, -math.inf)


def ssd_chunked(x, dt, a, b_t, c_t, chunk: int):
    """SSD (Mamba-2) block-matmul scan.

    x: (B,S,H,P), dt: (B,S,H) (post-softplus), a: (H,) negative,
    b_t/c_t: (B,S,N). Returns (y (B,S,H,P), final_state (B,H,N,P)).

    The shapes in the comments are zamba2-7b's at full width for one
    sequence of 4 chunks: H = 112, P = 64, N = 64, chunk C = Z = 256.
    """
    bsz, s, h, p = x.shape
    n = b_t.shape[-1]
    if s % chunk:
        chunk = s
    nc = s // chunk
    xdt = (x * dt[..., None]).float()
    da = (dt * a).float()  # (B,S,H)

    xc = xdt.reshape(bsz, nc, chunk, h, p)
    dac = da.reshape(bsz, nc, chunk, h)
    bc = b_t.reshape(bsz, nc, chunk, n).float()
    cc = c_t.reshape(bsz, nc, chunk, n).float()

    dac_cs = torch.cumsum(dac, dim=2)  # (B,nc,C,H)
    # intra-chunk (attention-like)
    l_mat = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))  # (B,nc,H,C,Z): (1,4,112,256,256), 117 MB
    scores = torch.einsum("bncd,bnzd->bncz", cc, bc)  # (B,nc,C,Z): (1,4,256,256)
    # "bncz,bnhcz,bnzhp->bnchp" in two steps: the decayed scores
    # (B,nc,H,C,Z), 117 MB, then their product with the inputs over z
    w = scores[:, :, None] * l_mat
    del l_mat
    y_diag = torch.einsum("bnhcz,bnzhp->bnchp", w, xc)  # (B,nc,C,H,P): (1,4,256,112,64), 29 MB
    del w

    # chunk-final states
    decay_to_end = torch.exp(dac_cs[:, :, -1:, :] - dac_cs)  # (B,nc,C,H)
    # "bnzd,bnzh,bnzhp->bnhdp" in two steps: the inputs decayed to the
    # chunk's end (B,nc,Z,H,P), 29 MB, then their product with B over z
    xd = decay_to_end[..., None] * xc
    s_chunk = torch.einsum("bnzd,bnzhp->bnhdp", bc, xd)  # (B,nc,H,N,P): (1,4,112,64,64), 7 MB
    del xd
    chunk_decay = torch.exp(dac_cs[:, :, -1, :])  # (B,nc,H)

    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    h_before = []
    for i in range(nc):
        h_before.append(state)
        state = state * chunk_decay[:, i, :, None, None] + s_chunk[:, i]
    h_before = torch.stack(h_before, dim=1)  # (B,nc,H,N,P)

    decay_from_start = torch.exp(dac_cs)  # (B,nc,C,H)
    # "bncd,bnch,bnhdp->bnchp" in two steps: C against the state at the
    # chunk's start (B,nc,C,H,P), 29 MB, then the decay from the start
    y_off = torch.einsum("bncd,bnhdp->bnchp", cc, h_before) * decay_from_start[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, state


def _gated_rmsnorm(p: Mamba2, y: torch.Tensor, dtype) -> torch.Tensor:
    yf = y.float()
    return (yf * torch.rsqrt(torch.mean(torch.square(yf), -1, keepdim=True) + 1e-6)
            * p.norm_scale.float()).to(dtype)


def mamba2_forward(p: Mamba2, x, cfg: ModelConfig, return_state: bool = False):
    """Full-sequence Mamba-2 mixer. x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    di, ds, h = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    pdim = cfg.ssm_head_dim
    proj = x @ cast(p.in_proj, cfg)
    z = proj[..., :di]
    xbc_pre = proj[..., di:di + di + 2 * ds]
    dt_raw = proj[..., di + di + 2 * ds:]
    xbc = F.silu(causal_conv1d(xbc_pre, p.conv_w, p.conv_b))
    x_in = xbc[..., :di].reshape(b, s, h, pdim)
    b_t = xbc[..., di:di + ds]
    c_t = xbc[..., di + ds:]
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    a = -torch.exp(p.A_log.float())
    y, h_last = ssd_chunked(x_in, dt, a, b_t, c_t, cfg.ssm_chunk)
    y = y + p.D.float()[None, None, :, None] * x_in.float()
    y = y.reshape(b, s, di).to(x.dtype) * F.silu(z)
    y = _gated_rmsnorm(p, y, x.dtype)  # gated RMSNorm (mamba2)
    out = y @ cast(p.out_proj, cfg)
    if return_state:
        kc = cfg.conv_dim
        conv_state = xbc_pre.float()[:, s - kc + 1:, :].clone()
        return out, {"conv": conv_state, "ssm": h_last}
    return out


def mamba2_init_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    conv_ch = cfg.d_inner + 2 * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.conv_dim - 1, conv_ch), dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, cfg.n_ssm_heads, cfg.d_state, cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
    }


def mamba2_step(p: Mamba2, x_t, state, cfg: ModelConfig):
    """One decode step. x_t: (B, D)."""
    b, d = x_t.shape
    di, ds, h = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    pdim = cfg.ssm_head_dim
    proj = x_t @ cast(p.in_proj, cfg)
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * ds]
    dt_raw = proj[..., di + di + 2 * ds:]
    conv_state, xbc = conv_step(state["conv"], xbc.float(), p.conv_w, p.conv_b)
    xbc = F.silu(xbc)
    x_in = xbc[..., :di].reshape(b, h, pdim)
    b_t = xbc[..., di:di + ds]
    c_t = xbc[..., di + ds:]
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())  # (B,H)
    a = -torch.exp(p.A_log.float())
    decay = torch.exp(dt * a)  # (B,H)
    # "bh,bd,bhp->bhdp": an outer product, no contraction
    hs = state["ssm"] * decay[..., None, None] + dt[:, :, None, None] * b_t[:, None, :, None] * x_in[:, :, None, :]
    y = torch.einsum("bd,bhdp->bhp", c_t, hs)
    y = y + p.D.float()[None, :, None] * x_in
    y = y.reshape(b, di).to(x_t.dtype) * F.silu(z)
    y = _gated_rmsnorm(p, y, x_t.dtype)
    out = y @ cast(p.out_proj, cfg)
    return out, {"conv": conv_state, "ssm": hs}
