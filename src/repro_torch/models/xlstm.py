"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory with recurrent gate connections), arXiv:2405.04517 (counterpart of
``repro/models/xlstm.py``).

Both expose ``*_step`` (decode and tree verify) and ``*_prefill`` (the time
scan; the mLSTM also has the closed-form chunked prefill, exact against
its scan).  States are float32; the stabilizer ``m`` starts at -1e30 and
the mLSTM's output divides by ``max(|n . q|, 1)``.  The blocks carry their
own projections (``cfg.d_ff == 0``).  The mLSTM's head width is ``2 *
d_model / num_heads``, not ``cfg.head_dim``.  The reference has no Pallas
kernel here: this is plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.hcmp.sharding import elementwise
from repro_torch.models import common as cm

NEG_M = -1e30          # the stabilizer's initial value


# --------------------------------------------------------------------------
# mLSTM: per-head matrix memory C (hd x hd), normalizer n (hd,), max-state m
# --------------------------------------------------------------------------
def mlstm_dims(cfg):
    di = 2 * cfg.d_model
    nh = cfg.num_heads
    return di, nh, di // nh


def mlstm_init(cfg, gen):
    d = cfg.d_model
    di, nh, hd = mlstm_dims(cfg)
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    return {
        "up": cm.dense_init(gen, d, 2 * di, dt),           # [x_in, gate]
        "wq": cm.dense_init(gen, di, di, dt),
        "wk": cm.dense_init(gen, di, di, dt),
        "wv": cm.dense_init(gen, di, di, dt),
        "wi": cm.dense_init(gen, di, nh, torch.float32),
        "wf": cm.dense_init(gen, di, nh, torch.float32),
        "skip": torch.ones((di,), dtype=dt, device=dev),
        "norm": torch.ones((di,), dtype=dt, device=dev),
        "down": cm.dense_init(gen, di, d, dt),
    }


def _mlstm_gates(p, xi):
    i_raw = xi.float() @ p["wi"]                            # (..., nh)
    f_raw = xi.float() @ p["wf"]
    return i_raw, elementwise(F.logsigmoid, f_raw)


def _mlstm_qkv(cfg, p, xi):
    di, nh, hd = mlstm_dims(cfg)
    shp = tuple(xi.shape[:-1]) + (nh, hd)
    q = (xi @ p["wq"]).reshape(shp)
    k = (xi @ p["wk"]).reshape(shp) * hd ** -0.5
    v = (xi @ p["wv"]).reshape(shp)
    return q, k, v


def _mlstm_out(cfg, p, h, xi, gate, dtype):
    y = cm.rmsnorm(h.to(dtype), p["norm"], cfg.rmsnorm_eps)
    y = y + xi * p["skip"]
    y = y * F.silu(gate)
    return y @ p["down"]


def mlstm_step(cfg, p, x_t, state, out=None):
    """x_t: (B, d); state: dict(C (B,nh,hd,hd), n (B,nh,hd), m (B,nh)).
    Returns (y (B, d), new state); ``out`` (a dict like the state)
    receives the new ``C`` in place (the large leaf; ``n`` and ``m`` are
    new tensors)."""
    di, nh, hd = mlstm_dims(cfg)
    up = x_t @ p["up"]
    xi, gate = up[..., :di], up[..., di:]
    q, k, v = (t.float() for t in _mlstm_qkv(cfg, p, xi))
    i_raw, f_log = _mlstm_gates(p, xi)

    m_new = torch.maximum(f_log + state["m"], i_raw)         # (B,nh)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_log + state["m"] - m_new)
    C = torch.mul(f_g[..., None, None], state["C"],
                  out=None if out is None else out["C"])
    C.add_(i_g[..., None, None] * (v[..., :, None] * k[..., None, :]))
    n = f_g[..., None] * state["n"] + i_g[..., None] * k
    h_num = torch.einsum("bhvk,bhk->bhv", C, q)
    h_den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)),
                        min=1.0)
    h = (h_num / h_den[..., None]).reshape(x_t.shape[0], di)
    return _mlstm_out(cfg, p, h, xi, gate, x_t.dtype), \
        {"C": C, "n": n, "m": m_new}


def mlstm_prefill_scan(cfg, p, x, state=None):
    """Per-step recurrence (the correctness baseline, O(S) sequential)."""
    B, S, _ = x.shape
    if state is None:
        state = mlstm_init_state(cfg, B, device=x.device)
    ys = []
    for t in range(S):
        y, state = mlstm_step(cfg, p, x[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def _mlstm_chunk(cfg, p, xi_c, state):
    """Closed-form parallel evaluation of one chunk (the exact unroll of
    the stabilized recurrence):

      m_t = max_{s<=t}( F_t - F_s + i_s , F_t + m_0 )
      C_t = sum_s e^{F_t-F_s+i_s-m_t} v_s k_s^T + e^{F_t+m_0-m_t} C_0

    One (T, T) masked matmul per head in place of the T-step scan.
    xi_c: (B, T, di), the inner activations after the up-projection."""
    di, nh, hd = mlstm_dims(cfg)
    B, T, _ = xi_c.shape
    q, k, v = (t.float().transpose(1, 2)
               for t in _mlstm_qkv(cfg, p, xi_c))            # (B,nh,T,hd)
    i_raw, f_log = _mlstm_gates(p, xi_c)                     # (B,T,nh)
    i_raw = i_raw.transpose(1, 2)                            # (B,nh,T)
    f_log = f_log.transpose(1, 2)
    Fc = torch.cumsum(f_log, dim=-1)                         # (B,nh,T)

    # decay/inject matrix (B,nh,T,T): F_t - F_s + i_s for s <= t
    Dm = Fc[..., :, None] - Fc[..., None, :] + i_raw[..., None, :]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=xi_c.device))
    Dm = torch.where(causal, Dm, -torch.inf)
    m_state = Fc + state["m"][..., None]                     # (B,nh,T)
    m = torch.maximum(torch.amax(Dm, dim=-1), m_state)       # (B,nh,T)

    S = torch.exp(Dm - m[..., None]) * torch.einsum("bhtd,bhsd->bhts", q, k)
    carry_w = torch.exp(m_state - m)                         # (B,nh,T)
    num = torch.einsum("bhts,bhsd->bhtd", S, v) \
        + carry_w[..., None] * torch.einsum("bhvk,bhtk->bhtv", state["C"], q)
    den = S.sum(dim=-1) \
        + carry_w * torch.einsum("bhk,bhtk->bht", state["n"], q)
    h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    h = h.transpose(1, 2).reshape(B, T, di)

    # chunk-end state (t = T-1)
    wT = torch.exp(Dm[..., -1, :] - m[..., -1:])             # (B,nh,T)
    C_T = torch.einsum("bhsv,bhsk->bhvk", wT[..., None] * v, k) \
        + carry_w[..., -1, None, None] * state["C"]
    n_T = torch.einsum("bhs,bhsk->bhk", wT, k) \
        + carry_w[..., -1, None] * state["n"]
    return h, {"C": C_T, "n": n_T, "m": m[..., -1]}


def mlstm_prefill(cfg, p, x, state=None, chunk=256):
    """Chunked-parallel prefill: whole chunks of ``chunk`` tokens, then the
    ragged tail as one more chunk, the state carried across them (the
    scan when ``cfg.mlstm_chunked`` is False)."""
    B, S, _ = x.shape
    if not getattr(cfg, "mlstm_chunked", True):
        return mlstm_prefill_scan(cfg, p, x, state)
    if state is None:
        state = mlstm_init_state(cfg, B, device=x.device)
    di, nh, hd = mlstm_dims(cfg)
    up = x @ p["up"]
    xi, gate = up[..., :di], up[..., di:]
    T = min(chunk, S)
    hs = []
    for lo in range(0, S, T):
        h, state = _mlstm_chunk(cfg, p, xi[:, lo:lo + T], state)
        hs.append(h)
    return _mlstm_out(cfg, p, torch.cat(hs, dim=1), xi, gate, x.dtype), state


def mlstm_init_state(cfg, batch, device="cuda"):
    di, nh, hd = mlstm_dims(cfg)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return {"C": full((batch, nh, hd, hd), 0.0),
            "n": full((batch, nh, hd), 0.0),
            "m": full((batch, nh), NEG_M)}


# --------------------------------------------------------------------------
# sLSTM: scalar memory per unit, recurrent gate connections (inherently
# sequential: the reason xLSTM keeps only a few sLSTM layers)
# --------------------------------------------------------------------------
def slstm_init(cfg, gen):
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    p = {"norm": torch.ones((d,), dtype=dt, device=dev),
         "down": cm.dense_init(gen, d, d, dt)}
    for g in ("i", "f", "z", "o"):
        p["w" + g] = cm.dense_init(gen, d, d, dt)
        p["r" + g] = cm.dense_init(gen, d, d, dt, scale=0.0)  # zero recurrence
        p["b" + g] = torch.zeros((d,), dtype=torch.float32, device=dev)
    return p


def slstm_step(cfg, p, x_t, state):
    """x_t: (B, d); state: dict(c, n, h, m) each (B, d) float32."""
    h_prev = state["h"].to(x_t.dtype)

    def gate(g):
        return (x_t @ p["w" + g] + h_prev @ p["r" + g]).float() + p["b" + g]

    i_raw, f_raw, z_raw, o_raw = gate("i"), gate("f"), gate("z"), gate("o")
    f_log = elementwise(F.logsigmoid, f_raw)
    m_new = torch.maximum(f_log + state["m"], i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_log + state["m"] - m_new)
    c = f_g * state["c"] + i_g * torch.tanh(z_raw)
    n = f_g * state["n"] + i_g
    h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1.0)
    y = cm.rmsnorm(h.to(x_t.dtype), p["norm"], cfg.rmsnorm_eps)
    return y @ p["down"], {"c": c, "n": n, "h": h, "m": m_new}


def slstm_prefill(cfg, p, x, state=None):
    B, S, _ = x.shape
    if state is None:
        state = slstm_init_state(cfg, B, device=x.device)
    ys = []
    for t in range(S):
        y, state = slstm_step(cfg, p, x[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def slstm_init_state(cfg, batch, d=None, device="cuda"):
    d = d or cfg.d_model

    def full(v):
        return torch.full((batch, d), v, dtype=torch.float32, device=device)

    return {"c": full(0.0), "n": full(0.0), "h": full(0.0), "m": full(NEG_M)}
