"""Quickstart (counterpart of ``examples/quickstart.py``): build a model
from the registry, prefill, decode 4 tokens and run one Ghidorah
speculative step over a width-8 verification tree, on the card unless
asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.quickstart \
      [--arch qwen2-0.5b-smoke] [--device cpu] [--seed 0]

Weights come from ``torch.Generator(seed)``, the prompt from ``seed + 1``
and the Medusa heads from ``seed + 2``, as the reference draws them from
``PRNGKey(0)``, ``PRNGKey(1)`` and ``PRNGKey(2)``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.speculative import tree as T
from repro_torch.core.speculative.medusa import init_medusa
from repro_torch.core.speculative.verify import spec_prefill, spec_step
from repro_torch.devices import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.api import get_model

PROMPT_LEN = 16
MAX_LEN = 128
DECODE_STEPS = 4
WIDTH = 8


def steps(model, params, heads, toks) -> dict:
    """The quickstart's three steps on ``toks`` (1, PROMPT_LEN): prefill
    logits, the greedy tokens of 4 decode steps, and one speculative
    step's accepted count and tokens."""
    cfg = model.cfg
    with torch.no_grad():
        logits, _, cache = model.prefill(params, {"tokens": toks},
                                         max_len=MAX_LEN)
        cur = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        decoded = []
        for _ in range(DECODE_STEPS):
            lg, cache = model.decode(params, cache, cur)
            cur = torch.argmax(lg[:, -1:], -1).to(torch.int32)
            decoded.append(int(cur[0, 0]))
        spec = T.build_tree(T.default_accs(cfg.medusa_heads,
                                           cfg.medusa_top_k), WIDTH)
        tree = T.Tree.from_spec(spec, toks.device)
        state = spec_prefill(model, params, heads, {"tokens": toks},
                             max_len=MAX_LEN)
        state, emitted, n = spec_step(model, params, heads, tree, state)
    n0 = int(n[0])
    return {"prefill_logits": logits, "decode_tokens": decoded,
            "n_accept": n0,
            "accepted": [int(t) for t in emitted[0][:n0].tolist()]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "quickstart")
    ap.add_argument("--arch", default="qwen2-0.5b-smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("registry:", ", ".join(list_archs()))
    cfg = get_config(args.arch)
    model = get_model(cfg)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"\n{cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"{cfg.num_heads}H(kv={cfg.num_kv_heads}) "
          f"{cfg.param_count()/1e6:.1f}M params ({model.family}) on {where}")

    def gen(offset):
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    params = model.init_params(gen(0))
    toks = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), generator=gen(1),
                         device=device, dtype=torch.int32)
    heads = init_medusa(cfg, gen(2))
    out = steps(model, params, heads, toks)
    logits = out["prefill_logits"]
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite prefill logits")
    print(f"prefill: logits {tuple(logits.shape)}")
    for i, t in enumerate(out["decode_tokens"]):
        print(f"decode step {i}: token {t}")
    print(f"speculative step: verified {WIDTH} tree nodes, accepted "
          f"{out['n_accept']} token(s): {out['accepted']}")
    out["launches"] = {name: fn.launches
                       for name, fn in dispatch.wrappers().items()}
    print(f"kernel launches: {json.dumps(out['launches'])}")
    return out


if __name__ == "__main__":
    main()
