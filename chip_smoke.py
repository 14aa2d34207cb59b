#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is swallowed):

1. Print the card's name and power limit (``nvidia-smi``); pin float32
   matmuls and convolutions to full precision (no TF32).
2. Build every CUDA kernel of the port from the checkout's sources.
3. Hold each kernel against its plain PyTorch version on the card: the
   reference kernel sweep (``tests/test_kernels.py`` CASES) and the main
   path's shapes, at the reference's tolerances (fp32 2e-5, bf16 2e-2).
4. Serve ``vicuna-7b`` at full width with random bf16 weights through the
   port's serve entry point, ``--mode ghidorah --width 8`` and
   ``--mode sequential``, and check the tokens, the logits and that every
   verify/decode forward went through the kernel.
5. Time each kernel at the main path's shapes with CUDA events, beside its
   plain version, one PyTorch library call and its memory/compute bound.
6. Print the ``{"kernels": [...]}`` line, then the device line last.

Without a GPU, or outside a checkout, it fails and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}

MAIN = dict(arch="vicuna-7b", width=8, batch=4, prompt_len=512, tokens=64,
            chunk=8, seed=0)
KERNEL = {
    "name": "verify_attention",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/verify_attention.cu",
    "replaces": "src/repro/kernels/tree_attention.py:96",
}

# tests/test_kernels.py CASES: B, W, Hq, Hkv, hd, S, pos, window
CASES = [
    (1, 1, 4, 4, 64, 32, 17, 0, "float32"),
    (2, 8, 4, 2, 64, 40, 33, 0, "float32"),
    (1, 16, 8, 1, 128, 128, 100, 0, "float32"),
    (2, 4, 4, 4, 32, 24, 24, 16, "float32"),
    (1, 8, 4, 2, 64, 64, 64, 0, "bfloat16"),
    (1, 32, 2, 2, 16, 8, 6, 0, "float32"),
    (4, 8, 4, 2, 32, 24, 20, 0, "float32"),
    (3, 4, 4, 4, 32, 16, 14, 8, "float32"),
]


class SmokeError(RuntimeError):
    pass


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def ring_key_pos(np, pos, S):
    """Ring-buffer key positions: slots hold [pos-S, pos) when full else
    [0, pos) (as tests/test_kernels.py)."""
    base = np.arange(S)
    if pos >= S:
        return pos - S + ((base - (pos % S)) % S)
    return np.where(base < pos, base, -1)


def rand_tree(np, W, seed):
    rng = np.random.default_rng(seed)
    parent = np.full(W, -1)
    for i in range(1, W):
        parent[i] = rng.integers(0, i)
    mask = np.zeros((W, W), bool)
    depth = np.zeros(W, np.int32)
    for i in range(W):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = parent[j]
        d, j = 0, i
        while parent[j] >= 0:
            d, j = d + 1, parent[j]
        depth[i] = d
    return mask, depth


def attention_inputs(torch, np, B, W, Hq, Hkv, hd, S, pos, window, dtype,
                     seed, tree=None):
    """Kernel operands on the card from a numpy seed: diverged per-row
    positions (each row a little behind the previous one), ring key
    positions, a random (or the given) ancestor mask."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape, np.float32)).to(
            DEVICE, dt)

    q, ck, cv = randn(B, W, Hq, hd), randn(B, S, Hkv, hd), randn(B, S, Hkv, hd)
    kn, vn = randn(B, W, Hkv, hd), randn(B, W, Hkv, hd)
    pos_b = np.array([max(pos - 2 * b, 1) for b in range(B)], np.int32)
    key_pos = np.stack([ring_key_pos(np, p, S) for p in pos_b]).astype(
        np.int32)
    mask, depth = tree if tree is not None else rand_tree(np, W, seed=S)
    q_pos = (pos_b[:, None] + depth[None, :]).astype(np.int32)
    lo = q_pos - window if window else np.full_like(q_pos, -1)
    ints = [torch.as_tensor(a).to(DEVICE) for a in (key_pos, q_pos, lo)]
    return (q, ck, cv, kn, vn, *ints, torch.as_tensor(mask).to(DEVICE))


def needed_bytes(torch, args, out):
    """Bytes the function must move: each input read once, each output
    written once.  Cache K/V count only the slots some query of the row may
    attend to (this run's data); empty or out-of-window slots need no
    read."""
    q, ck, cv, kn, vn, key_pos, q_pos, lo, mask = args
    ok = ((key_pos[:, None, :] >= 0)
          & (key_pos[:, None, :] <= q_pos[:, :, None])
          & (key_pos[:, None, :] > lo[:, :, None])).any(dim=1)   # (B, S)
    slot = ck.shape[2] * ck.shape[3] * ck.element_size()
    n = int(ok.sum())
    small = sum(t.numel() * t.element_size()
                for t in (q, kn, vn, key_pos, q_pos, lo, mask, out))
    return small + 2 * n * slot, n


def needed_ops(args):
    q, ck = args[0], args[1]
    B, W, Hq, hd = q.shape
    S = ck.shape[1]
    return 4 * B * Hq * W * (S + W) * hd      # q.k and p.v multiply-adds


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    log(f"built {list(build.SOURCES)} in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"  {name}: {line.strip()}")


def main_path_tree(np):
    """The main path's verification tree (serve --width 8) as (mask,
    depth), and its depth."""
    from repro_torch.core.speculative import tree as T
    from repro_torch.configs import get_config
    cfg = get_config(MAIN["arch"])
    spec = T.build_tree(T.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                        MAIN["width"])
    return (spec.mask, spec.depth.astype(np.int32)), spec.max_depth, cfg


def main_shapes(np):
    """(label, kwargs) of the kernel at the main path's shapes: the verify
    of --mode ghidorah and the decode of --mode sequential, with the cache
    nearly full as at the end of the serve run."""
    tree, depth, cfg = main_path_tree(np)
    B, H, hd = MAIN["batch"], cfg.num_heads, cfg.head_dim
    pl, nt = MAIN["prompt_len"], MAIN["tokens"]
    verify_S = pl + nt + depth
    decode_S = pl + nt
    return [
        ("verify W=8", dict(B=B, W=MAIN["width"], Hq=H, Hkv=cfg.num_kv_heads,
                            hd=hd, S=verify_S, pos=verify_S - depth,
                            window=0, dtype="bfloat16", tree=tree)),
        ("decode W=1", dict(B=B, W=1, Hq=H, Hkv=cfg.num_kv_heads, hd=hd,
                            S=decode_S, pos=decode_S - 1, window=0,
                            dtype="bfloat16",
                            tree=(np.ones((1, 1), bool),
                                  np.zeros((1,), np.int32)))),
    ]


def phase_kernel_check(torch, np):
    from repro_torch.kernels.plain import tree_attention_plain
    from repro_torch.kernels.verify_attention import verify_attention
    worst = 0.0
    cases = [(f"case {i}", dict(B=B, W=W, Hq=Hq, Hkv=Hkv, hd=hd, S=S,
                                pos=pos, window=win, dtype=dt))
             for i, (B, W, Hq, Hkv, hd, S, pos, win, dt) in enumerate(CASES)]
    for label, kw in cases + main_shapes(np):
        args = attention_inputs(torch, np, seed=kw["B"] * kw["W"] + kw["S"],
                                **kw)
        got = verify_attention(*args)
        want = tree_attention_plain(*args)
        torch.cuda.synchronize()
        tol = TOL[str(args[0].dtype)]
        err = float((got.float() - want.float()).abs().max())
        bad = ~torch.isclose(got.float(), want.float(), atol=tol, rtol=tol)
        log(f"kernel vs plain {label} {kw['dtype']} B={kw['B']} W={kw['W']} "
            f"Hq={kw['Hq']} Hkv={kw['Hkv']} hd={kw['hd']} S={kw['S']} "
            f"window={kw['window']}: max abs err {err:.3e} (tol {tol})")
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise SmokeError(f"verify_attention disagrees with "
                             f"tree_attention_plain at {label}: max abs err "
                             f"{err:.3e} > {tol}")
        worst = max(worst, err)
    return worst


def phase_serve(torch, np):
    from repro_torch.kernels.verify_attention import verify_attention
    from repro_torch.launch import serve

    def argv(mode):
        return ["--arch", MAIN["arch"], "--mode", mode,
                "--width", str(MAIN["width"]), "--batch", str(MAIN["batch"]),
                "--prompt-len", str(MAIN["prompt_len"]),
                "--tokens", str(MAIN["tokens"]), "--chunk", str(MAIN["chunk"]),
                "--seed", str(MAIN["seed"]), "--device", DEVICE]

    t0 = time.perf_counter()
    loaded = serve.load(serve.parse_args(argv("ghidorah")), with_heads=True)
    torch.cuda.synchronize()
    cfg = loaded.cfg
    n_params = sum(t.numel() for t in _leaves(loaded.params))
    n_heads = sum(t.numel() for t in _leaves(loaded.heads))
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.2f}B params + {n_heads / 1e9:.2f}B Medusa-head "
        f"params in {cfg.dtype}, random from seed {MAIN['seed']} "
        f"({time.perf_counter() - t0:.1f}s)")

    results, launches = {}, 0
    verify_attention.launches = 0          # counts from here on: main path
    for mode in ("ghidorah", "sequential"):
        before = verify_attention.launches
        res = serve.run(serve.parse_args(argv(mode)), loaded)
        torch.cuda.synchronize()
        stats = res["stats"]
        got = verify_attention.launches - before
        want = cfg.num_layers * stats["device_steps"]
        steps = stats["device_steps"]
        step_ms = 1e3 * sum(stats["step_times"]) / max(steps, 1)
        log(f"{mode}: {stats['emitted_total']} tokens, "
            f"{stats['emitted_total'] / res['seconds']:.1f} tok/s, "
            f"{steps} steps, mean step {step_ms:.2f} ms, acceptance length "
            f"{stats['acceptance_length']:.3f}, kernel launches {got} "
            f"(= {cfg.num_layers} layers x {steps} steps: {got == want})")
        if stats["emitted_total"] != MAIN["batch"] * MAIN["tokens"]:
            raise SmokeError(f"{mode} emitted {stats['emitted_total']} "
                             f"tokens, expected "
                             f"{MAIN['batch'] * MAIN['tokens']}")
        if got != want or got == 0:
            raise SmokeError(f"{mode}: {got} verify_attention launches, "
                             f"expected {want} (layers x steps)")
        results[mode] = dict(res, step_ms=step_ms)
        launches = verify_attention.launches
    check_outputs(torch, np, loaded, results)
    return launches, results


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def check_outputs(torch, np, loaded, results):
    """Teacher-forced logits over prompt + the sequential stream: all
    finite; report how far ghidorah and sequential agree and the logit
    margin where they first differ (reported, not gated, at bf16)."""
    seq, spec = results["sequential"]["out"], results["ghidorah"]["out"]
    prompts = results["sequential"]["prompts"]
    if seq.shape != spec.shape or (seq < 0).any() or (spec < 0).any():
        raise SmokeError(f"bad token arrays: {seq.shape} {spec.shape}")
    if (seq >= loaded.cfg.vocab_size).any():
        raise SmokeError("token id out of range")
    full = torch.as_tensor(np.concatenate([prompts, seq[:, :-1]], axis=1),
                           device=loaded.device)
    with torch.no_grad():
        logits, _, _ = loaded.model.prefill(loaded.params, {"tokens": full},
                                            return_cache=False)
    P = prompts.shape[1]
    lg = logits[:, P - 1:].float()                       # predicts seq[:, i]
    if not bool(torch.isfinite(logits).all()):
        raise SmokeError("non-finite logits on the served tokens")
    tf = lg.argmax(-1).cpu().numpy()
    log(f"logits finite over {tuple(logits.shape)}; teacher-forced greedy "
        f"agrees with the sequential stream on "
        f"{float((tf == seq).mean()):.4f} of tokens")
    agree = float((seq == spec).mean())
    margins = []
    for b in range(seq.shape[0]):
        diff = np.nonzero(seq[b] != spec[b])[0]
        if diff.size:
            i = int(diff[0])
            row = lg[b, i]
            margins.append((b, i, float(row[int(seq[b, i])]
                                        - row[int(spec[b, i])])))
    log(f"ghidorah vs sequential: {agree:.4f} of tokens agree; first "
        f"disagreement (row, index, logit margin seq-spec): "
        f"{margins if margins else 'none'}")


def phase_timing(torch, np, card):
    from repro_torch.kernels.plain import tree_attention_plain
    from repro_torch.kernels.verify_attention import verify_attention
    import torch.nn.functional as F

    def sdpa_inputs(args):
        q, ck, cv, kn, vn, key_pos, q_pos, lo, mask = args
        B, W = q.shape[:2]
        ok = ((key_pos[:, None, :] >= 0)
              & (key_pos[:, None, :] <= q_pos[:, :, None])
              & (key_pos[:, None, :] > lo[:, :, None]))       # (B, W, S)
        m = torch.cat([ok, mask[None].expand(B, W, W)], dim=2)[:, None]
        k = torch.cat([ck, kn], dim=1).transpose(1, 2).contiguous()
        v = torch.cat([cv, vn], dim=1).transpose(1, 2).contiguous()
        return q.transpose(1, 2).contiguous(), k, v, m

    def timed(fn, sets, iters=50, warm=5):
        for i in range(warm):
            fn(sets[i % len(sets)])
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(iters):
            fn(sets[i % len(sets)])
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    rows = {}
    for label, kw in main_shapes(np):
        # 4 input sets (> the 50 MB L2 together) cycled, so every launch
        # reads its cache from device memory as the serving step does
        sets = [attention_inputs(torch, np, seed=100 + r, **kw)
                for r in range(4)]
        lib_sets = [sdpa_inputs(a) for a in sets]
        ref = tree_attention_plain(*sets[0])
        lib = F.scaled_dot_product_attention(*lib_sets[0][:3],
                                             attn_mask=lib_sets[0][3])
        lib_err = float((lib.transpose(1, 2).float() - ref.float()).abs()
                        .max())
        kernel_ms = timed(lambda a: verify_attention(*a), sets)
        plain_ms = timed(lambda a: tree_attention_plain(*a), sets)
        library_ms = timed(lambda a: F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3]), lib_sets)
        nbytes, slots = needed_bytes(torch, sets[0], ref)
        ops = needed_ops(sets[0])
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / PEAK_OPS_PER_S[str(sets[0][0].dtype)]
        bound_ms = max(bytes_ms, ops_ms)
        rows[label] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by="bytes" if bytes_ms >= ops_ms
                           else "operations", bytes=nbytes, ops=ops)
        log(f"timing {label} ({card}): kernel_ms {kernel_ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms {library_ms:.4f} (sdpa, max abs "
            f"diff to plain {lib_err:.2e}) bound_ms {bound_ms:.4f} "
            f"({rows[label]['bound_by']}: {nbytes / 1e6:.2f} MB over "
            f"{slots} valid cache slots, {ops / 1e9:.3f} GFLOP); "
            f"{kernel_ms / bound_ms:.1f}x the bound")
        del sets, lib_sets
    return rows


def main():
    if not (SRC / "repro_torch").is_dir():
        raise SmokeError(f"{SRC / 'repro_torch'} not found: run chip_smoke.py "
                         f"from the root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is False: this smoke "
                         "test needs an NVIDIA GPU")

    card = phase_device(torch)
    phase_build()
    max_err = phase_kernel_check(torch, np)
    launches, served = phase_serve(torch, np)
    layers = launches // max(sum(r["stats"]["device_steps"]
                                 for r in served.values()), 1)
    log(f"verify_attention launches per serve step: {layers}")
    timing = phase_timing(torch, np, card)
    t = timing["verify W=8"]
    d = timing["decode W=1"]
    entry = dict(KERNEL, launches=launches, max_abs_err=max_err,
                 max_err=max_err, ms=t["kernel_ms"],
                 kernel_ms=t["kernel_ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                 library_ms=t["library_ms"],
                 decode_ms=d["kernel_ms"], decode_plain_ms=d["plain_ms"],
                 decode_library_ms=d["library_ms"],
                 decode_bound_ms=d["bound_ms"], card=card)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeError as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
