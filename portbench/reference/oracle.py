"""The numbers that decide ``correct``, each the reference's judgement of
what the program served.  Served tokens are greedy, so every one should be
the reference's best token up to rounding:

  token_gap  over sampled served requests, the widest gap by which a served
             token's reference logit lies below the reference's best logit
             at its position (the reference re-runs each prompt with the
             tokens served after it: embedding, attention over the cache
             the program committed, the MLP or MoE, the LM head);
  draft_gap  over sampled bank rows at one decode step, the widest gap by
             which the token the program's Medusa head h ranks first lies
             below the reference head's best logit, the heads run on the
             reference's own last-layer residual at the row's position;
  carry      rows whose next root token (the program's ``cur_token``) is not
             the token it went on to serve.

The control (``quant="fp8"``) is judged the same way, by the gap of the
token that it ranks first, at the same positions.
"""
from __future__ import annotations

import numpy as np
import torch


def _gaps(logits, tokens) -> torch.Tensor:
    """Best logit minus the logit of ``tokens``; a token outside the
    vocabulary has no logit and reads an infinite gap."""
    tokens = torch.as_tensor(tokens, device=logits.device).long()
    ok = (tokens >= 0) & (tokens < logits.shape[-1])
    got = logits.gather(1, tokens.clamp(0, logits.shape[-1] - 1)[:, None])
    gap = logits.max(-1).values - got[:, 0]
    return torch.where(ok, gap, torch.full_like(gap, float("inf")))


def _seq(prompt, toks, vocab):
    """The reference's input: prompt then served tokens, a token outside
    the vocabulary read as 0 (its own gap is already infinite)."""
    seq = np.concatenate([prompt, toks]).astype(np.int64)
    return np.where((seq >= 0) & (seq < vocab), seq, 0)


def served(ref, prompt, toks, control=None) -> dict:
    """Gaps of the ``n`` served tokens ``toks`` after ``prompt``: the
    reference runs prompt + toks[:n-1] and reads positions S-1 .. S+n-2.
    With ``control`` (a second ``Ref``), also the gaps of the tokens the
    control ranks first."""
    S, n = len(prompt), len(toks)
    seq = _seq(prompt, toks[:n - 1], ref.V)
    with torch.no_grad():
        logits, _ = ref.forward(seq, S - 1)
        out = {"token_gap": _gaps(logits, toks).cpu().numpy()}
        if control is not None:
            c, _ = control.forward(seq, S - 1)
            out["control_gap"] = _gaps(logits, c.argmax(-1)).cpu().numpy()
    return out


def drafts(ref, prompt, toks, m, top1, control=None) -> dict:
    """Gaps of the program's first-ranked draft tokens ``top1`` (H,) at a
    row whose request had served ``m`` tokens ``toks[:m]``: its residual
    is the one at position S + m - 2 (the position whose logits gave
    ``toks[m-1]``)."""
    seq = _seq(prompt, toks[:m - 1], ref.V)
    with torch.no_grad():
        _, hid = ref.forward(seq, len(seq) - 1, hidden_at=[len(seq) - 1])
        lg = ref.draft_logits(hid)[0]                          # (H, V)
        out = {"draft_gap": _gaps(lg, top1).cpu().numpy()}
        if control is not None:
            _, chid = control.forward(seq, len(seq) - 1,
                                      hidden_at=[len(seq) - 1])
            c = control.draft_logits(chid)[0]
            out["control_draft_gap"] = _gaps(lg, c.argmax(-1)).cpu().numpy()
    return out
