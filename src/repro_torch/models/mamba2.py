"""Mamba2 (SSD) block: scalar-decay state-space recurrence with heads
(counterpart of ``repro/models/mamba2.py``).

State per layer: ``ssm (B, nh, hd, N)`` float32 and the causal conv's tail
``conv (B, K-1, C)`` in the config's dtype, with C = di + 2N conv channels.
Prefill runs the chunked closed form (``_ssd_chunk``, exact against the
time scan ``_mamba_prefill_scan``); decode and tree verify step one token
at a time (``mamba_step``).  The projections stay split per component
(z / x / BC / dt), as in the reference.  The SSD has no Pallas kernel in
the reference: this is plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or max(di // 64, 1)
    hd = di // nh
    return di, nh, hd, cfg.ssm_state


def mamba_init(cfg, gen):
    di, nh, hd, N = dims(cfg)
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    K = cfg.ssm_conv

    def conv_w(width):
        w = torch.randn((K, width), generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * K ** -0.5).to(dt)

    return {
        "in_z": cm.dense_init(gen, d, di, dt),
        "in_x": cm.dense_init(gen, d, di, dt),
        "in_bc": cm.dense_init(gen, d, 2 * N, dt),
        "in_dt": cm.dense_init(gen, d, nh, dt),
        "conv_wx": conv_w(di),
        "conv_wbc": conv_w(2 * N),
        "conv_bx": torch.zeros((di,), dtype=dt, device=dev),
        "conv_bbc": torch.zeros((2 * N,), dtype=dt, device=dev),
        # A = -exp(A_log) = -1
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": cm.dense_init(gen, di, d, dt),
    }


def _ssd_step(cfg, p, x_conv, bc_conv, dt_raw, state, out=None):
    """One recurrence step after the conv.  x_conv: (B, di), bc_conv:
    (B, 2N), state (B, nh, hd, N) float32.  ``out`` (a float32 tensor of
    the state's shape) receives the new state instead of a new tensor."""
    di, nh, hd, N = dims(cfg)
    x = x_conv.float().reshape(-1, nh, hd)
    Bm = bc_conv[..., :N].float()                               # (B, N)
    Cm = bc_conv[..., N:].float()                               # (B, N)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])             # (B, nh)
    a = torch.exp(-torch.exp(p["A_log"]) * dtv)                 # (B, nh)
    # upd = (x dt) (x) B, then state' = a state + upd: each element one
    # product and one sum, as the reference's einsum and add
    new = torch.mul((x * dtv[..., None])[..., None], Bm[:, None, None, :],
                    out=out)
    new.addcmul_(state, a[..., None, None])
    y = torch.einsum("bhpn,bn->bhp", new, Cm) + p["D"][None, :, None] * x
    return y.reshape(-1, di), new


def _conv_split(cfg, p, hist):
    """hist: (B, K, C) with C = di + 2N.  Returns silu'd (x_c (B, di),
    bc_c (B, 2N)) in float32."""
    di = cfg.ssm_expand * cfg.d_model
    x_c = torch.einsum("bkc,kc->bc", hist[..., :di].float(),
                       p["conv_wx"].float()) + p["conv_bx"].float()
    bc_c = torch.einsum("bkc,kc->bc", hist[..., di:].float(),
                        p["conv_wbc"].float()) + p["conv_bbc"].float()
    return F.silu(x_c), F.silu(bc_c)


def mamba_step(cfg, p, x_t, state, out=None):
    """x_t: (B, d); state: dict(ssm (B, nh, hd, N) float32, conv (B, K-1,
    C)).  Returns (out (B, d), new state); ``out`` (a dict like the state)
    receives the new ``ssm`` in place (``conv`` is a view of a new
    tensor)."""
    z = x_t @ p["in_z"]
    xin = x_t @ p["in_x"]
    bc = x_t @ p["in_bc"]
    dt_raw = x_t @ p["in_dt"]
    xbc = torch.cat([xin, bc], dim=-1)
    hist = torch.cat([state["conv"], xbc[:, None, :]], dim=1)   # (B, K, C)
    x_c, bc_c = _conv_split(cfg, p, hist)
    y, ssm = _ssd_step(cfg, p, x_c, bc_c, dt_raw, state["ssm"],
                       out=None if out is None else out["ssm"])
    y = cm.rmsnorm((y * F.silu(z.float())).to(x_t.dtype), p["norm"],
                   cfg.rmsnorm_eps)
    return y @ p["out_proj"], {"ssm": ssm, "conv": hist[:, 1:, :]}


def _ssd_chunk(cfg, p, x_c, bc_c, dt_raw, S0):
    """Closed-form parallel evaluation of one SSD chunk (the exact unroll
    of the scalar-decay recurrence; decay <= 1, so no stabilizer):

      S_t = a_t S_{t-1} + (dt_t x_t) (x) B_t ,  a_t = exp(-exp(A_log) dt_t)
      y_t = sum_{s<=t} e^{L_t - L_s} (B_s . C_t)(dt_s x_s) + e^{L_t} (C_t . S_0)
            + D x_t

    with L_t = cumsum log a.  x_c: (B,T,di) conv'd; bc_c: (B,T,2N);
    dt_raw: (B,T,nh); S0 float32.  Returns (y (B,T,di), S_T)."""
    di, nh, hd, N = dims(cfg)
    B, T, _ = x_c.shape
    xh = x_c.float().reshape(B, T, nh, hd)
    Bm = bc_c[..., :N].float()                                  # (B, T, N)
    Cm = bc_c[..., N:].float()
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])             # (B, T, nh)
    log_a = -torch.exp(p["A_log"]) * dtv                        # <= 0
    L = torch.cumsum(log_a, dim=1)                              # (B, T, nh)

    # decay matrix W_ts = exp(L_t - L_s) for s <= t -> (B, nh, T, T)
    Lh = L.transpose(1, 2)                                      # (B, nh, T)
    W = torch.exp(Lh[..., :, None] - Lh[..., None, :])
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=x_c.device))
    W = torch.where(causal, W, 0.0)
    scores = torch.einsum("btn,bsn->bts", Cm, Bm)               # (B, T, T)
    G = scores[:, None] * W                                     # (B,nh,T,T)
    xdt = xh * dtv[..., None]                                   # (B,T,nh,hd)
    y = torch.einsum("bhts,bshp->bthp", G, xdt)
    # carried initial-state contribution
    y = y + torch.exp(Lh)[..., None].transpose(1, 2) \
        * torch.einsum("bhpn,btn->bthp", S0, Cm)
    y = y + p["D"][None, None, :, None] * xh
    # chunk-end state
    wT = torch.exp(Lh[..., -1:] - Lh)                           # (B, nh, T)
    S_T = torch.exp(Lh[..., -1])[..., None, None] * S0 \
        + torch.einsum("bht,bthp,btn->bhpn", wT, xdt, Bm)
    return y.reshape(B, T, di), S_T


def _conv_prefill(cfg, p, x, state):
    """The projections and the causal depthwise conv of a prefill.  Returns
    (z, silu'd conv output (B, S, C) float32, dt_raw, hist)."""
    S = x.shape[1]
    z = x @ p["in_z"]
    xin = x @ p["in_x"]
    bc = x @ p["in_bc"]
    dt_raw = x @ p["in_dt"]
    xbc = torch.cat([xin, bc], dim=-1)
    K = cfg.ssm_conv
    hist = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
    conv_w = torch.cat([p["conv_wx"], p["conv_wbc"]], dim=-1)
    conv_b = torch.cat([p["conv_bx"], p["conv_bbc"]], dim=-1)
    wins = torch.stack([hist[:, i:i + S] for i in range(K)], dim=2)
    xbc_c = torch.einsum("bskc,kc->bsc", wins.float(), conv_w.float()) \
        + conv_b.float()
    return z, F.silu(xbc_c), dt_raw, hist


def _finish(cfg, p, x, z, y, hist):
    K = cfg.ssm_conv
    y = cm.rmsnorm((y * F.silu(z.float())).to(x.dtype), p["norm"],
                   cfg.rmsnorm_eps)
    conv = hist[:, -(K - 1):, :] if K > 1 else hist[:, :0, :]
    return y @ p["out_proj"], conv


def mamba_prefill(cfg, p, x, state=None, chunk=256):
    """x: (B, S, d).  Chunked SSD prefill (exact against the time scan;
    the scan when ``cfg.mamba_chunked`` is False).  Returns (out (B, S, d),
    state)."""
    B, S, _ = x.shape
    di = dims(cfg)[0]
    if state is None:
        state = init_state(cfg, B, dtype=x.dtype, device=x.device)
    if not getattr(cfg, "mamba_chunked", True):
        return _mamba_prefill_scan(cfg, p, x, state)
    z, xbc_c, dt_raw, hist = _conv_prefill(cfg, p, x, state)

    T = min(chunk, S)
    ssm = state["ssm"]
    ys = []
    for lo in range(0, S, T):          # whole chunks, then the ragged tail
        hi = min(lo + T, S)
        y, ssm = _ssd_chunk(cfg, p, xbc_c[:, lo:hi, :di],
                            xbc_c[:, lo:hi, di:], dt_raw[:, lo:hi], ssm)
        ys.append(y)
    out, conv = _finish(cfg, p, x, z, torch.cat(ys, dim=1), hist)
    return out, {"ssm": ssm, "conv": conv}


def _mamba_prefill_scan(cfg, p, x, state):
    """Time-scan prefill (the correctness baseline)."""
    S = x.shape[1]
    di = dims(cfg)[0]
    z, xbc_c, dt_raw, hist = _conv_prefill(cfg, p, x, state)
    ssm = state["ssm"]
    ys = []
    for t in range(S):
        y, ssm = _ssd_step(cfg, p, xbc_c[:, t, :di], xbc_c[:, t, di:],
                           dt_raw[:, t], ssm)
        ys.append(y)
    out, conv = _finish(cfg, p, x, z, torch.stack(ys, dim=1), hist)
    return out, {"ssm": ssm, "conv": conv}


def init_state(cfg, batch, dtype=torch.bfloat16, device="cuda"):
    di, nh, hd, N = dims(cfg)
    return {
        "ssm": torch.zeros((batch, nh, hd, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=dtype, device=device),
    }
