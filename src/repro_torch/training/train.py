"""LM training step (next-token CE + the model's auxiliary loss) and
Medusa-head training (counterpart of ``repro/training/train.py``).

``train_step`` is a full forward, a backward over every parameter leaf and
an AdamW update.  ``medusa_step`` trains the drafting heads against offset
targets with the base model frozen: the base forward runs under
``torch.no_grad()``, so its hidden states are constants, as under the
reference's ``value_and_grad`` with respect to the heads.  Grads take
their parameter's dtype, as JAX's do.  No attention kernel runs here: the
prefill path is plain torch, as in the reference.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.speculative.medusa import medusa_logits
from repro_torch.training.optimizer import adamw_update
from repro_torch.tree import leaves, unflatten


def _on(batch, device):
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def lm_loss(cfg, model, params, batch):
    """batch: tokens (B,S), labels (B,S) (-100 = ignore).  Returns
    ``(loss, ce)``, 0-d float32."""
    logits, extras, _ = model.prefill(params, batch, return_cache=False)
    labels = batch["labels"].long()
    if logits.shape[1] != labels.shape[1]:
        # VLM: logits cover [patch_embeds; tokens]; the loss is on the
        # text tail
        logits = logits[:, -labels.shape[1]:]
    valid = labels >= 0
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(lp, -1, labels.clamp(min=0)[..., None])[..., 0]
    n = valid.sum().clamp(min=1)
    ce = -torch.where(valid, ll, 0.0).sum() / n
    return ce + extras["aux_loss"], ce


def _value_and_grad(loss_fn, tree, *, remat=False):
    """(outputs of ``loss_fn(tree)``, grads of its first output with
    respect to every leaf of ``tree``, in ``tree``'s structure).  A leaf
    the loss does not reach gets a zero grad, as in JAX."""
    live_leaves = [p.detach().requires_grad_(True) for p in leaves(tree)]
    live = unflatten(tree, live_leaves)
    with torch.enable_grad():
        if remat:
            out = checkpoint(loss_fn, live, use_reentrant=False)
        else:
            out = loss_fn(live)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, live_leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live_leaves, grads)]
    out = tuple(o.detach() for o in out) if isinstance(out, tuple) \
        else out.detach()
    return out, unflatten(tree, grads)


def lm_value_and_grad(cfg, model, params, batch):
    """``((loss, ce), grads)`` of ``lm_loss``; with ``cfg.remat`` the loss
    is recomputed in the backward (``torch.utils.checkpoint``, as
    ``jax.checkpoint`` wraps it in the reference)."""
    batch = _on(batch, params["embed"].device)
    return _value_and_grad(lambda p: lm_loss(cfg, model, p, batch), params,
                           remat=cfg.remat)


def train_step(cfg, model, params, opt_state, batch, *, lr=3e-4):
    """One optimizer step.  Returns ``(params, opt_state, metrics)``."""
    (loss, ce), grads = lm_value_and_grad(cfg, model, params, batch)
    params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
    return params, opt_state, {"loss": loss, "ce": ce}


# --------------------------------------------------------------------------
# Medusa head training (base model frozen)
# --------------------------------------------------------------------------
def _hidden(model, params, batch):
    with torch.no_grad():
        _, extras, _ = model.prefill(params, batch, return_cache=False)
    return extras["hidden"]                                  # (B,S,d)


def _medusa_loss(cfg, heads, hidden, tokens):
    logits = medusa_logits(cfg, heads, hidden)               # (B,S,H,V)
    S = tokens.shape[1]
    lp = torch.log_softmax(logits.float(), dim=-1)
    total = 0.0
    count = 0
    for h in range(cfg.medusa_heads):
        off = h + 2                  # hidden at t predicts t+h+2 for head h+1
        if off >= S:
            break
        tgt = tokens[:, off:].long()
        pred = lp[:, :S - off, h]
        ll = torch.gather(pred, -1, tgt[..., None])[..., 0]
        total = total - ll.mean()
        count += 1
    return total / max(count, 1)


def medusa_loss(cfg, model, params, heads, batch):
    """Head h is trained to predict the token at offset h+2 from the
    hidden state at t."""
    batch = _on(batch, params["embed"].device)
    return _medusa_loss(cfg, heads, _hidden(model, params, batch),
                        batch["tokens"])


def medusa_value_and_grad(cfg, model, params, heads, batch):
    """``(loss, grads)`` of ``medusa_loss`` with respect to the heads."""
    batch = _on(batch, params["embed"].device)
    hidden = _hidden(model, params, batch)
    return _value_and_grad(
        lambda h: _medusa_loss(cfg, h, hidden, batch["tokens"]), heads)


def medusa_step(cfg, model, params, heads, opt_state, batch, *, lr=1e-3):
    loss, grads = medusa_value_and_grad(cfg, model, params, heads, batch)
    heads, opt_state = adamw_update(grads, opt_state, heads, lr=lr,
                                    weight_decay=0.0)
    return heads, opt_state, {"loss": loss}
