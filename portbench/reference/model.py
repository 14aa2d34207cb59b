"""The plain reference: the decoder's forward pass in float32 over one
request's whole sequence (prompt, then the tokens the program served),
layer by layer, with plain ``torch`` operations and nothing of the port.

It reads the configuration file's own keys (the source config's names)
and the weights the benchmark made, in the port's layout (``x @ W``,
layers stacked on a leading axis).  Each layer's weights are brought to
float32 one layer at a time, so the pass fits beside the bf16 weights on
the card.  TF32 is off.

The math, as the configuration states it:
  * token embedding; per layer ``x += attn(rmsnorm(x))``, ``x +=
    ffn(rmsnorm(x))``; ``logits = rmsnorm(x) @ lm_head``, cut to the vocab;
  * attention: GQA (query head ``h * G + g`` reads kv head ``h``), q/k
    RMSNorm over the head dim when ``qk_norm``, split-half RoPE, causal
    softmax over the whole context (every context stays inside the
    configuration's window);
  * ffn: SwiGLU, or the MoE as published: a float32 router, softmax,
    top-k, the k gates renormalised, SwiGLU experts, every choice kept
    (dropless: no expert has a capacity);
  * Medusa heads on the last layer's residual (before the final norm):
    ``(h + silu(h @ W_i)) @ O_i``.

``quant="fp8"`` is the control, the whole model in float8 (e4m3): the
embedding rows, every weight matrix (the router's too) and the activation
fed to it, and the cached K and V go through float8 (one scale per
embedding row, output column, token, and token and head); the rest as
above.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Round ``t`` (float32) through float8 e4m3, one scale per slice
    along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Ref:
    """The reference over one configuration and one set of weights."""

    def __init__(self, cfg: dict, params: dict, heads: dict, *,
                 quant: str = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.p, self.heads, self.quant = cfg, params, heads, quant
        self.d = cfg["hidden_size"]
        self.L = cfg["num_hidden_layers"]
        self.Hq = cfg["num_attention_heads"]
        self.Hkv = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or self.d // self.Hq
        self.V = cfg["vocab_size"]
        self.eps = cfg["rms_norm_eps"]
        self.E = cfg.get("num_experts") or 0
        self.K = cfg.get("num_experts_per_tok") or 0

    # ---- pieces --------------------------------------------------------
    def mm(self, x, w):
        """``x @ w`` in float32 (``w`` a bf16 weight), or through fp8."""
        w = w.float()
        if self.quant == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def q8(self, t, dim=-1):
        """``t`` through float8 in the control, else as it is."""
        return _fp8(t, dim) if self.quant == "fp8" else t

    def rms(self, x, g):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * g.float()

    def rope(self, x, pos):
        """Split-half RoPE; angles in float64."""
        hd = self.hd
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float64, device=x.device)
            / hd))
        ang = pos.double()[:, None] * inv[None]
        cos = torch.cos(ang).float()[:, None, :]
        sin = torch.sin(ang).float()[:, None, :]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attn(self, lp, i, h):
        S = h.shape[0]
        a = lp["attn"]
        q = self.mm(h, a["wq"][i]).view(S, self.Hq, self.hd)
        k = self.mm(h, a["wk"][i]).view(S, self.Hkv, self.hd)
        v = self.mm(h, a["wv"][i]).view(S, self.Hkv, self.hd)
        if self.cfg.get("qk_norm"):
            q = self.rms(q, a["q_norm"][i])
            k = self.rms(k, a["k_norm"][i])
        pos = torch.arange(S, device=h.device)
        q, k = self.rope(q, pos), self.q8(self.rope(k, pos))
        v = self.q8(v)
        G = self.Hq // self.Hkv
        qg = q.view(S, self.Hkv, G, self.hd).permute(1, 2, 0, 3)
        kk = k.permute(1, 0, 2)                        # (Hkv, S, hd)
        vv = v.permute(1, 0, 2)
        causal = torch.ones(S, S, dtype=torch.bool,
                            device=h.device).tril()
        out = torch.empty(S, self.Hkv, G, self.hd, device=h.device)
        for j in range(self.Hkv):                      # one kv head at a time
            s = qg[j] @ kk[j].T[None] / math.sqrt(self.hd)   # (G, S, S)
            s = s.masked_fill(~causal, float("-inf"))
            out[:, j] = (torch.softmax(s, -1) @ vv[j][None]).permute(1, 0, 2)
        return self.mm(out.reshape(S, -1), a["wo"][i])

    def swiglu(self, x, wg, wu, wd):
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wu), wd)

    def moe(self, lp, i, h):
        m = lp["moe"]
        probs = torch.softmax(self.mm(h, m["router"][i]), -1)
        gate, idx = torch.topk(probs, self.K, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
        out = torch.zeros_like(h)
        for e in torch.unique(idx).tolist():
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            y = self.swiglu(h[tok], m["w_gate"][i, e], m["w_up"][i, e],
                            m["w_down"][i, e])
            out.index_add_(0, tok, y * gate[tok, slot][:, None])
        return out

    # ---- the pass -------------------------------------------------------
    def forward(self, tokens, logit_from, hidden_at=()):
        """Logits (float32, cut to the vocab) at positions ``logit_from``
        onwards, and the last layer's residual at ``hidden_at``."""
        p = self.p
        tokens = torch.as_tensor(tokens, device=p["embed"].device).long()
        x = self.q8(p["embed"][tokens].float())
        lp = p["layers"]
        for i in range(self.L):
            x = x + self.attn(lp, i, self.rms(x, lp["ln1"][i]))
            h = self.rms(x, lp["ln2"][i])
            if self.E:
                x = x + self.moe(lp, i, h)
            else:
                m = lp["mlp"]
                x = x + self.swiglu(h, m["w_gate"][i], m["w_up"][i],
                                    m["w_down"][i])
        hidden = x[list(hidden_at)] if len(hidden_at) else None
        head = p["embed"].T if self.cfg.get("tie_word_embeddings") \
            else p["lm_head"]
        xs = self.rms(x[logit_from:], p["ln_f"])
        logits = self.mm(xs, head)[:, :self.V]
        return logits, hidden

    def draft_logits(self, hidden):
        """Medusa heads on residuals ``hidden`` (n, d) -> (n, H, V)."""
        H = self.heads["w"].shape[0]
        out = []
        for j in range(H):
            h = hidden + F.silu(self.mm(hidden, self.heads["w"][j]))
            out.append(self.mm(h, self.heads["out"][j])[:, :self.V])
        return torch.stack(out, 1)
