"""The model's steps on real ranks through DTensor, held against the same
steps on plain tensors: prefill, one tree verify and two decodes, with the
weights laid out by ``core/hcmp/sharding.py`` (``hcmp`` or ``megatron``)
on a ``(world // n_model, n_model)`` mesh.

``steps`` runs the three on whatever tensors it is given; ``sharded``
lays the params and inputs out on a mesh and gathers the logits back.
Run across ranks on one host:

  PYTHONPATH=src python -m repro_torch.launch.sharded_check --world 4 \\
      --n-model 2 --backend gloo --device cpu --arch qwen2-0.5b-smoke

``--arch`` and ``--mode`` take comma lists: one group of ranks runs every
pair.  Each rank is a process of its own (spawned, one torch thread),
joined through a ``FileStore``; the launcher prints each step's largest
logit difference to the one-device run and exits non-zero past
``--tol``.  By default (``--backend nccl --device cuda``) each rank
takes the card of its rank and the one-device run is on the first card;
without a card that raises, as every entry point of the port does.
"""
from __future__ import annotations

import argparse
import datetime
import multiprocessing
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.hcmp import sharding as shd
from repro_torch.devices import resolve_device
from repro_torch.models.api import get_model


def inputs(cfg, *, B=4, P=20, W=8, seed=0, device="cpu"):
    """Seeded token inputs (numpy, then tensors): a (B, P) prompt, a W-node
    tree's (B, W) tokens and the tree, a (B, 1) decode token.  The cache
    holds P + W + 4 slots, rounded up to a multiple of 16: at the
    defaults 32, so on a model axis of 2 the prompt fills one sequence
    shard and part of the other."""
    from repro_torch.core.speculative import tree as T
    rng = np.random.default_rng(seed)
    spec = T.build_tree(T.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                        W)

    def toks(*shape):
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, shape)
                               .astype(np.int32), device=device)

    return {"prompt": toks(B, P), "tree_tokens": toks(B, W),
            "tree": T.Tree.from_spec(spec, device),
            "token": toks(B, 1), "max_len": -(-(P + W + 4) // 16) * 16}


def steps(model, params, x):
    """Prefill, a tree verify on its cache (not committed), a decode on the
    same cache, then a second decode on the cache the first committed
    (its logits read what the commit wrote).  Returns {step: logits}."""
    lp, _, cache = model.prefill(params, {"tokens": x["prompt"]},
                                 max_len=x["max_len"])
    lv, _ = model.verify(params, cache, x["tree_tokens"], x["tree"])
    ld, cache = model.decode(params, cache, x["token"])
    ld2, _ = model.decode(params, cache, x["token"])
    return {"prefill": lp, "verify": lv, "decode": ld, "decode2": ld2}


def sharded(cfg, params, mesh, mode, x):
    """``steps`` with the params and token inputs as DTensors on ``mesh``
    (whole tensors in, every rank the same; each keeps its slice).  The
    logits come back whole on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication
    dp = shd.data_axes(mesh)
    sp = shd.distribute_params(cfg, params, mode, mesh=mesh)
    sx = dict(x)
    for k in ("prompt", "tree_tokens", "token"):
        sx[k] = shd.distribute_batch(x[k], dp, mesh=mesh)
    # the tree's tensors and the model's shape-derived constants are alike
    # on every rank
    with implicit_replication():
        out = steps(get_model(cfg), sp, sx)
    return {k: v.full_tensor() for k, v in out.items()}


def max_diffs(got, want) -> dict:
    return {k: float((got[k].float() - want[k].float()).abs().max())
            for k in want}


# --------------------------------------------------------------------------
def _rank(rank, a, store_path, out_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    device = "cpu"
    if a.backend == "nccl":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group(
        a.backend, store=dist.FileStore(store_path, a.world), rank=rank,
        world_size=a.world, timeout=datetime.timedelta(seconds=a.timeout))
    torch.set_num_threads(1)
    try:
        mesh = make_smoke_mesh(a.n_model,
                               device_type="cuda" if a.backend == "nccl"
                               else "cpu")
        out = {}
        for arch, mode in cases(a):
            cfg = get_config(arch)
            params = load_params(cfg, a.params, device)
            x = inputs(cfg, B=a.batch, device=device)
            out[f"{arch}/{mode}"] = {
                k: v.cpu() for k, v in sharded(cfg, params, mesh, mode,
                                               x).items()}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def load_params(cfg, params_dir, device):
    """The params ``params_dir/<arch>.pt`` holds (``torch.save`` of the
    port's tree), or the model's own init from seed 0."""
    if params_dir:
        tree = torch.load(os.path.join(params_dir, f"{cfg.name}.pt"),
                          weights_only=True)
        from repro_torch.tree import tree_map
        return tree_map(lambda t: t.to(device), tree)
    gen = torch.Generator(device=device).manual_seed(0)
    return get_model(cfg).init_params(gen)


def cases(a):
    return [(arch, mode) for arch in a.arch.split(",")
            for mode in a.mode.split(",")]


def run_ranks(a) -> dict:
    """Spawn ``a.world`` ranks, wait for them (``a.timeout`` s), return
    rank 0's logits (CPU tensors) by ``"arch/mode"``."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=a.tmp) as tmp:
        store = os.path.join(tmp, "store")
        out = os.path.join(tmp, "logits.pt")
        procs = [ctx.Process(target=_rank, args=(r, a, store, out))
                 for r in range(a.world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(a.timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if alive or any(codes):
            raise RuntimeError(f"ranks exited with {codes}"
                               f"{' (timed out)' if alive else ''}")
        return torch.load(out, weights_only=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b-smoke")
    ap.add_argument("--mode", default="hcmp,megatron")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--n-model", type=int, default=2)
    ap.add_argument("--backend", default="nccl", choices=["gloo", "nccl"],
                    help="nccl: each rank on the card of its rank; gloo: "
                         "ranks on the CPU")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="the one-device run's device")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--params", default=None,
                    help="a directory of <arch>.pt (torch.save of the "
                         "params; default: each arch's init from seed 0)")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--tol", type=float, default=2e-5)
    ap.add_argument("--tmp", default=None,
                    help="directory for the rendezvous file")
    return ap.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    resolve_device(a.device)
    if a.backend == "nccl":
        resolve_device("cuda")
    got = run_ranks(a)
    worst = 0.0
    for arch, mode in cases(a):
        cfg = get_config(arch)
        want = steps(get_model(cfg), load_params(cfg, a.params, a.device),
                     inputs(cfg, B=a.batch, device=a.device))
        diffs = max_diffs({k: v.to(a.device) for k, v in
                           got[f"{arch}/{mode}"].items()}, want)
        worst = max(worst, *diffs.values())
        print(f"[sharded_check] {arch} {mode} on {a.world} ranks "
              f"({a.world // a.n_model} x {a.n_model}, {a.backend}): "
              f"largest logit difference to one device {diffs}", flush=True)
    return 0 if worst <= a.tol else 1


if __name__ == "__main__":
    sys.exit(main())
