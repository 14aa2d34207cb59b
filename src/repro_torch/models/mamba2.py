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

from repro_torch.core.hcmp import sharding as shd
from repro_torch.core.hcmp.sharding import regather
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
    return _out_proj(p, y), {"ssm": ssm, "conv": hist[:, 1:, :]}


def _out_proj(p, y):
    """``y @ out_proj``; on DTensors the HCMP re-gathers around it (the
    z/x path and the SSD stay split over ``model`` until here)."""
    w = p["out_proj"]
    return regather(regather(y, w) @ w)


def _ssd_chunk(p, x_c, bc_c, dt_raw, S0):
    """Closed-form parallel evaluation of one SSD chunk (the exact unroll
    of the scalar-decay recurrence; decay <= 1, so no stabilizer):

      S_t = a_t S_{t-1} + (dt_t x_t) (x) B_t ,  a_t = exp(-exp(A_log) dt_t)
      y_t = sum_{s<=t} e^{L_t - L_s} (B_s . C_t)(dt_s x_s) + e^{L_t} (C_t . S_0)
            + D x_t

    with L_t = cumsum log a.  x_c: (B,T,di) conv'd; bc_c: (B,T,2N);
    dt_raw: (B,T,nh); S0 float32; the widths are read from the inputs
    (a rank's heads under ``_ssd_chunk_split``).  Returns (y (B,T,di),
    S_T)."""
    B, T, di = x_c.shape
    nh = dt_raw.shape[-1]
    hd, N = di // nh, bc_c.shape[-1] // 2
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


def _causal_conv(tail, u, w, b):
    """Causal depthwise conv of one channel group: ``tail`` (B, K-1, c)
    the carried inputs, ``u`` (B, S, c) the new ones, ``w`` (K, c), ``b``
    (c,).  Returns (the silu'd output (B, S, c) float32, the K-1 newest
    inputs).  Each channel is its own conv, so the x and the B/C groups
    run apart and the x channels keep their split over heads."""
    S = u.shape[1]
    K = w.shape[0]
    hist = torch.cat([tail.to(u.dtype), u], dim=1)
    wins = torch.stack([hist[:, i:i + S] for i in range(K)], dim=2)
    out = torch.einsum("bskc,kc->bsc", wins.float(), w.float()) + b.float()
    return F.silu(out), hist[:, hist.shape[1] - (K - 1):]


def _conv_prefill(cfg, p, x, state):
    """The projections and the causal depthwise conv of a prefill, the x
    channels and the B/C channels as two convs.  Returns (z, x_c (B, S,
    di), bc_c (B, S, 2N), both silu'd float32, dt_raw, the conv tail (B,
    K-1, C))."""
    di = dims(cfg)[0]
    z = x @ p["in_z"]
    xin = x @ p["in_x"]
    bc = x @ p["in_bc"]
    dt_raw = x @ p["in_dt"]
    tail = state["conv"]
    x_c, tail_x = _causal_conv(tail[..., :di], xin, p["conv_wx"],
                               p["conv_bx"])
    bc_c, tail_bc = _causal_conv(tail[..., di:], bc, p["conv_wbc"],
                                 p["conv_bbc"])
    return z, x_c, bc_c, dt_raw, torch.cat([tail_x, tail_bc], dim=-1)


def _ssd_chunk_split(p, x_c, bc_c, dt_raw, S0):
    """``_ssd_chunk`` on each rank's rows and heads when ``x_c`` is a
    DTensor: its einsums flatten batch and heads, which DTensor cannot do
    on a tensor split over both.  The heads follow ``x_c``'s split of its
    channels over ``model``; dt, the per-head parameters and the state
    are cut to match (a local slice), and B/C comes whole on that axis."""
    if not shd.is_dtensor(x_c):
        return _ssd_chunk(p, x_c, bc_c, dt_raw, S0)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    on_rows = [pl if pl == Shard(0) else Replicate()
               for pl in x_c.placements]
    if any(pl not in (Shard(0), Shard(2), Replicate())
           for pl in x_c.placements):
        raise ValueError(f"SSD chunk of x laid out as {x_c.placements}")

    def heads(dim):             # the rows' split and the heads on ``dim``
        return [Shard(dim) if pl == Shard(2) else r
                for pl, r in zip(x_c.placements, on_rows)]

    per_head = [Shard(0) if pl == Shard(2) else Replicate()
                for pl in x_c.placements]
    mesh = x_c.device_mesh
    return local_map(
        lambda x, bc, dt, s, dt_bias, A_log, D: _ssd_chunk(
            {"dt_bias": dt_bias, "A_log": A_log, "D": D}, x, bc, dt, s),
        out_placements=(heads(2), heads(1)),
        in_placements=(heads(2), on_rows, heads(2), heads(1), per_head,
                       per_head, per_head),
        device_mesh=mesh, redistribute_inputs=True)(
            x_c, bc_c, dt_raw, shd.replicated(S0, mesh),
            *(shd.replicated(p[k], mesh) for k in ("dt_bias", "A_log", "D")))


def _finish(cfg, p, x, z, y):
    y = cm.rmsnorm((y * F.silu(z.float())).to(x.dtype), p["norm"],
                   cfg.rmsnorm_eps)
    return _out_proj(p, y)


def mamba_prefill(cfg, p, x, state=None, chunk=256):
    """x: (B, S, d).  Chunked SSD prefill (exact against the time scan;
    the scan when ``cfg.mamba_chunked`` is False).  Returns (out (B, S, d),
    state)."""
    B, S, _ = x.shape
    if state is None:
        state = init_state(cfg, B, dtype=x.dtype, device=x.device)
    if not getattr(cfg, "mamba_chunked", True):
        return _mamba_prefill_scan(cfg, p, x, state)
    z, x_c, bc_c, dt_raw, conv = _conv_prefill(cfg, p, x, state)

    T = min(chunk, S)
    ssm = state["ssm"]
    ys = []
    for lo in range(0, S, T):          # whole chunks, then the ragged tail
        hi = min(lo + T, S)
        y, ssm = _ssd_chunk_split(p, x_c[:, lo:hi], bc_c[:, lo:hi],
                                  dt_raw[:, lo:hi], ssm)
        ys.append(y)
    return _finish(cfg, p, x, z, torch.cat(ys, dim=1)), \
        {"ssm": ssm, "conv": conv}


def _mamba_prefill_scan(cfg, p, x, state):
    """Time-scan prefill (the correctness baseline)."""
    S = x.shape[1]
    z, x_c, bc_c, dt_raw, conv = _conv_prefill(cfg, p, x, state)
    ssm = state["ssm"]
    ys = []
    for t in range(S):
        y, ssm = _ssd_step(cfg, p, x_c[:, t], bc_c[:, t], dt_raw[:, t], ssm)
        ys.append(y)
    return _finish(cfg, p, x, z, torch.stack(ys, dim=1)), \
        {"ssm": ssm, "conv": conv}


def init_state(cfg, batch, dtype=torch.bfloat16, device="cuda"):
    di, nh, hd, N = dims(cfg)
    return {
        "ssm": torch.zeros((batch, nh, hd, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=dtype, device=device),
    }
