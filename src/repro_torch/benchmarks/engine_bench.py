"""Measured engine throughput: sequential vs speculative decoding across
batch sizes B x chunk depths K (counterpart of
``benchmarks/engine_bench.py``), on the device the port runs on.

The grid serves the chunked driver (K decode steps per host sync; on a
CUDA device the compiled chunk: one captured step replayed K times) for
the sequential and the speculative engine at every (B, K), beside the
per-step Python loop of a plain prefill + decode.  Each (B, K) holds the
speculative stream to the sequential one: greedy speculation is lossless,
so the streams are equal where the arithmetic is exact enough to keep the
argmax (float32); in bfloat16 the grid records the share of equal tokens
(random weights leave near-ties that two summation orders flip) and a
float32 copy of the same weights is held equal instead (``parity``).

The ``trained`` arm e2e-trains the bench's smoke model and its Medusa
heads on the Markov corpus (``training/train.py``, fixed seeds), builds the
tree from MEASURED head accuracies (``head_accuracies``) and records the
acceptance-weighted tokens/s; its acceptance must beat the random heads'
on the same model.  The ``hcmp`` arm serves inline against the HCMP
overlap (the draft on a second CUDA stream; one serial executor on the
CPU), holds their tokens bit-identical and records ARCA's measured
partition choice.

On the CPU the measurement runs on one core with one intra-op thread
(the reference pins XLA's threading the same way), restored afterwards.

  PYTHONPATH=src python -m repro_torch.benchmarks.engine_bench \
      [--arch vicuna-7b --width 8 --tokens 64] [--device cpu]

Writes ``results/torch/engine_bench.json`` (``--out`` to put it elsewhere)
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.benchmarks import benchlib
from repro_torch.configs import get_config
from repro_torch.core import arca
from repro_torch.core.speculative import tree as T
from repro_torch.core.speculative.medusa import head_accuracies, init_medusa
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.devices import resolve_device
from repro_torch.launch.serve import Loaded
from repro_torch.models.api import get_model
from repro_torch.runtime.engine import BatchEngine, SpeculativeEngine
from repro_torch.runtime.sampling import greedy
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train import medusa_step, train_step
from repro_torch.tree import tree_map

BATCHES = (1, 4, 8)
CHUNKS = (1, 8)
SMOKE_ARCH = "qwen2-engine-smoke"


def engine_smoke_cfg():
    """The bench's own smoke model (d=128, 2 layers): engine overheads,
    not GEMM time, dominate a step at this size."""
    return dataclasses.replace(
        get_config("qwen2-0.5b").reduced(),
        name=SMOKE_ARCH, d_model=128, num_heads=2, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=256)


def bench_config(arch):
    """``arch`` from the registry, or the bench's smoke model."""
    return engine_smoke_cfg() if arch == SMOKE_ARCH else get_config(arch)


def load(cfg, device, seed=0, dtype=None) -> Loaded:
    """Random weights from ``seed`` and heads from ``seed + 1``
    (``torch.Generator`` on the device), in ``dtype`` if given."""
    device = resolve_device(device)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = get_model(cfg)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(seed))
    heads = init_medusa(cfg, torch.Generator(device=device).manual_seed(
        seed + 1))
    return Loaded(cfg=cfg, model=model, params=params, heads=heads,
                  device=device)


@contextlib.contextmanager
def pinned(device):
    """On the CPU, measure on one core with one intra-op thread (both
    restored after): the threads the measurement starts (the router's
    replicas, the HCMP executors) inherit the core and share it, as they
    share the one card on a CUDA device, where nothing is pinned."""
    if torch.device(device).type != "cpu":
        yield
        return
    prev = torch.get_num_threads()
    cores = os.sched_getaffinity(0)
    torch.set_num_threads(1)
    os.sched_setaffinity(0, {sorted(cores)[os.getpid() % len(cores)]})
    try:
        yield
    finally:
        os.sched_setaffinity(0, cores)
        torch.set_num_threads(prev)


def prompts_for(cfg, B, prompt_len, seed=2) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, prompt_len),
                                   dtype=np.int64).astype(np.int32)}


def release(device) -> None:
    """Return a dropped engine's graphs and caches to the device."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _as_fp32(loaded: Loaded) -> Loaded:
    cast = dataclasses.replace(loaded.cfg, dtype="float32")
    return Loaded(cfg=cast, model=get_model(cast),
                  params=tree_map(lambda t: t.float(), loaded.params),
                  heads=tree_map(lambda t: t.float(), loaded.heads),
                  device=loaded.device)


def streams_agree(seq_out, spec_out) -> float:
    """Share of equal tokens between two (B, n) streams."""
    a, b = np.atleast_2d(seq_out), np.atleast_2d(spec_out)
    return float((a == b).mean())


def parity(loaded: Loaded, spec, prompt, n_tokens, max_len, K) -> dict:
    """Sequential and speculative greedy streams on the same weights in
    float32 must be equal token for token (lossless speculation)."""
    seq = BatchEngine(loaded.model, loaded.params, max_len=max_len, chunk=K)
    eng = SpeculativeEngine(loaded.model, loaded.heads, loaded.params, spec,
                            max_len=max_len, chunk=K)
    out_seq, _ = seq.generate(prompt, n_tokens)
    out_spec, st = eng.generate(prompt, n_tokens)
    agree = streams_agree(out_seq, out_spec)
    if agree != 1.0:
        raise AssertionError(
            f"speculative stream left the sequential one in float32 "
            f"({agree:.4f} of tokens equal): speculation is not lossless")
    return {"dtype": "float32", "B": int(prompt["tokens"].shape[0]),
            "K": K, "n_tokens": n_tokens, "equal": True,
            "acceptance": st["acceptance_length"]}


def grid(loaded: Loaded, spec, *, n_tokens, reps, prompt_len, device
         ) -> dict:
    """The B x K grid plus the per-step loop; every speculative stream is
    compared with the sequential one of the same (B, K)."""
    cfg, model, params = loaded.cfg, loaded.model, loaded.params
    max_len = prompt_len + n_tokens + spec.max_depth
    exact = cfg.dtype == "float32"
    record = {"arch": cfg.name, "dtype": cfg.dtype, "n_tokens": n_tokens,
              "prompt_len": prompt_len, "tree_width": spec.width,
              "tree_depth": spec.max_depth, "grid": []}
    prompts = {B: prompts_for(cfg, B, prompt_len) for B in BATCHES}

    def legacy(batch, n):
        """The seed's per-step loop: prefill, then one decode and one host
        sync per token."""
        toks = torch.as_tensor(batch["tokens"], device=device)
        logits, _, cache = model.prefill(params, {"tokens": toks},
                                         max_len=max_len)
        cur = greedy(logits[:, -1])
        out = [cur.cpu().numpy()]
        for _ in range(n - 1):
            lg, cache = model.decode(params, cache, cur[:, None])
            cur = greedy(lg[:, 0])
            out.append(cur.cpu().numpy())
        return np.stack(out, axis=1)

    t_legacy = benchlib.best_s(lambda: legacy(prompts[1], n_tokens), device,
                               reps)
    record["legacy_seq_b1_tok_s"] = n_tokens / t_legacy

    for B in BATCHES:
        # one engine of each kind per batch, driven at every chunk depth
        # (``generate(chunk=K)``); each (B, K) first runs once untimed:
        # the warm-up, and the streams the gate compares
        seq = BatchEngine(model, params, max_len=max_len,
                          chunk=max(CHUNKS))
        eng = SpeculativeEngine(model, loaded.heads, params, spec,
                                max_len=max_len, chunk=max(CHUNKS))
        for K in CHUNKS:
            out_seq, _ = seq.generate(prompts[B], n_tokens, chunk=K)
            t = benchlib.best_s(
                lambda: seq.generate(prompts[B], n_tokens, chunk=K), device,
                reps, warm=False)
            record["grid"].append({"engine": "sequential", "B": B, "K": K,
                                   "tok_s": B * n_tokens / t})
            out_spec, stats = eng.generate(prompts[B], n_tokens, chunk=K)
            t = benchlib.best_s(
                lambda: eng.generate(prompts[B], n_tokens, chunk=K), device,
                reps, warm=False)
            agree = streams_agree(out_seq, out_spec)
            if exact and agree != 1.0:
                raise AssertionError(
                    f"speculative stream left the sequential one at B={B} "
                    f"K={K} ({agree:.4f} of tokens equal)")
            record["grid"].append({"engine": "speculative", "B": B, "K": K,
                                   "tok_s": B * n_tokens / t,
                                   "acceptance": stats["acceptance_length"],
                                   "agree_with_sequential": agree})
        del seq, eng
        release(device)

    def tok_s(engine, B, K):
        return next(g["tok_s"] for g in record["grid"]
                    if (g["engine"], g["B"], g["K"]) == (engine, B, K))

    record["speedup_spec_k8_vs_legacy_b1"] = \
        tok_s("speculative", 1, 8) / record["legacy_seq_b1_tok_s"]
    record["scaleup_spec_b8_vs_b1_k8"] = \
        tok_s("speculative", 8, 8) / tok_s("speculative", 1, 8)
    record["speedup_spec_b8k8_vs_seed_b1k1"] = \
        tok_s("speculative", 8, 8) / tok_s("speculative", 1, 1)
    record["streams_equal"] = all(
        g["agree_with_sequential"] == 1.0 for g in record["grid"]
        if g["engine"] == "speculative")
    if exact:
        record["parity"] = {"dtype": "float32", "grid": True, "equal": True}
    else:
        fp32 = _as_fp32(loaded)
        record["parity"] = parity(fp32, spec, prompts[4], n_tokens, max_len,
                                  8)
        del fp32
        release(device)
    return record


def trained_arm(device, n_tokens, reps, steps, head_steps) -> dict:
    """e2e-train the smoke model's base and heads on the Markov corpus,
    build the tree from MEASURED head accuracies and record the
    acceptance-weighted tokens/s; the acceptance must beat random heads'
    on the same (untrained) model."""
    loaded = load(engine_smoke_cfg(), device)
    cfg, model = loaded.cfg, loaded.model
    prompt_len = 16
    rand_spec = T.build_tree(T.default_accs(cfg.medusa_heads,
                                            cfg.medusa_top_k), 4)
    rand = SpeculativeEngine(model, loaded.heads, loaded.params, rand_spec,
                             max_len=prompt_len + n_tokens
                             + rand_spec.max_depth, chunk=8)
    rand_prompt = prompts_for(cfg, 1, prompt_len)
    _, st = rand.generate(rand_prompt, n_tokens)
    rand_al = st["acceptance_length"]
    t_rand = benchlib.best_s(lambda: rand.generate(rand_prompt, n_tokens),
                             device, reps)
    del rand

    data = MarkovDataset(cfg.vocab_size, seed=1)
    params = loaded.params
    opt = adamw_init(params)
    for batch in data.batches(8, 64, steps):
        params, opt, _ = train_step(cfg, model, params, opt, batch, lr=1e-3)
    heads = init_medusa(cfg, torch.Generator(device=loaded.device)
                        .manual_seed(1))
    hopt = adamw_init(heads)
    for batch in data.batches(8, 64, head_steps, seed=500):
        heads, hopt, _ = medusa_step(cfg, model, params, heads, hopt, batch)

    accs = head_accuracies(
        cfg, model, params, heads,
        (data.sample(8, 96, seed=100 + s)[:, :-1] for s in range(3)))
    spec = T.build_tree(accs, 4)
    prompt = {"tokens": data.sample(1, prompt_len, seed=7)[:, :-1]
              .astype(np.int32)}
    eng = SpeculativeEngine(model, heads, params, spec,
                            max_len=prompt_len + n_tokens + spec.max_depth,
                            chunk=8)
    _, st = eng.generate(prompt, n_tokens)
    t = benchlib.best_s(lambda: eng.generate(prompt, n_tokens), device, reps)
    out = {"arch": cfg.name, "train_steps": steps, "head_steps": head_steps,
           "tree_width": 4,
           "accs_top1": [round(float(x), 4) for x in accs[:, 0]],
           "acceptance": st["acceptance_length"],
           "acceptance_random_heads": rand_al,
           "tok_s_b1_k8": n_tokens / t,
           "speedup_vs_random_heads_b1_k8": t_rand / t}
    if out["acceptance"] <= rand_al:
        raise AssertionError(
            f"trained heads did not beat random acceptance "
            f"({out['acceptance']:.2f} <= {rand_al:.2f})")
    return out


def hcmp_arm(loaded: Loaded, spec, *, n_tokens, reps, prompt_len, device
             ) -> dict:
    """Inline against the HCMP overlap (the draft of step t+1 on a second
    CUDA stream while step t commits; serial on the CPU): tokens/s, the
    bit-identity gate and ARCA's measured partition choice
    (``profile_engine`` timing both layouts through ``time_step``)."""
    cfg, model, params = loaded.cfg, loaded.model, loaded.params
    accs = T.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    max_len = prompt_len + n_tokens + spec.max_depth
    out = {"arch": cfg.name, "devices": 1, "tree_width": spec.width,
           "chunk": 8, "host_cores": os.cpu_count(),
           "streams": 2 if torch.device(device).type == "cuda" else 1,
           "grid": []}
    for B in (1, 4):
        prompt = prompts_for(cfg, B, prompt_len)
        inline = SpeculativeEngine(model, loaded.heads, params, spec,
                                   max_len=max_len, chunk=8)
        overlap = SpeculativeEngine(model, loaded.heads, params, spec,
                                    max_len=max_len, chunk=8,
                                    hcmp="overlap")
        out_i, _ = inline.generate(prompt, n_tokens)
        out_o, _ = overlap.generate(prompt, n_tokens)
        if not np.array_equal(out_i, out_o):
            raise AssertionError(
                f"overlap diverged from inline at B={B}: the arm is "
                f"meaningless without bit-identity")
        t_i = benchlib.best_s(lambda: inline.generate(prompt, n_tokens),
                              device, reps)
        t_o = benchlib.best_s(lambda: overlap.generate(prompt, n_tokens),
                              device, reps)
        tf = arca.profile_engine(overlap, accs=accs, batch=B,
                                 prompt_len=prompt_len, reps=reps)
        part = tf.partition_for(spec)
        key = (spec.width, spec.max_depth, spec.n_paths, B)
        hs = overlap.hcmp_stats
        out["grid"].append({
            "B": B, "inline_tok_s": B * n_tokens / t_i,
            "overlap_tok_s": B * n_tokens / t_o,
            "speedup_overlap_vs_inline": t_i / t_o,
            "arca_partition": part,
            "arca_step_inline_s": tf.times[key + ("inline",)],
            "arca_step_overlap_s": tf.times[key + ("overlap",)],
            "predraft_hits": hs["predraft_hits"],
            "predraft_discards": hs["predraft_discards"]})
        del inline, overlap
        release(device)
    if all(g["speedup_overlap_vs_inline"] <= 1.0 for g in out["grid"]):
        out["note"] = (
            f"overlap did not beat inline on {benchlib.label(device)} "
            f"({out['streams']} stream(s)): the draft/commit window freed "
            f"no wall time; ARCA's measured partition choice records it")
    return out


def worker(loaded: Loaded, *, width=4, n_tokens=64, reps=3, prompt_len=16,
           train_steps=120, head_steps=80, watch=benchlib.unwatched) -> dict:
    """The whole record on ``loaded``'s device: the grid and its parity,
    the trained arm (always the smoke model) and the hcmp arm."""
    device = loaded.device
    cfg = loaded.cfg
    spec = T.build_tree(T.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                        width)
    with pinned(device), torch.no_grad():
        with watch("engine grid"):
            record = grid(loaded, spec, n_tokens=n_tokens, reps=reps,
                          prompt_len=prompt_len, device=device)
        with watch("engine hcmp"):
            record["hcmp"] = hcmp_arm(loaded, spec, n_tokens=n_tokens,
                                      reps=reps, prompt_len=prompt_len,
                                      device=device)
    with pinned(device), watch("engine trained"):
        record["trained"] = trained_arm(device, n_tokens, reps, train_steps,
                                        head_steps)
    record["card"] = benchlib.card(device)
    return record


def rows_of(record) -> list:
    """The harness's CSV rows (name, us per token, derived)."""
    where = record["card"]["name"]
    rows = [("engine_legacy_seq_b1", 1e6 / record["legacy_seq_b1_tok_s"],
             f"{record['legacy_seq_b1_tok_s']:.1f} tok/s, {where}")]
    for g in record["grid"]:
        name = f"engine_{g['engine'][:4]}_b{g['B']}_k{g['K']}"
        derived = f"{g['tok_s']:.1f} tok/s agg"
        if "acceptance" in g:
            derived += (f", AL={g['acceptance']:.2f}, "
                        f"agree {g['agree_with_sequential']:.3f}")
        rows.append((name, 1e6 / g["tok_s"], derived + f", {where}"))
    rows.append(("engine_speedup_spec_k8_vs_legacy",
                 record["speedup_spec_k8_vs_legacy_b1"], "x vs per-step loop"))
    rows.append(("engine_scaleup_spec_b8_vs_b1",
                 record["scaleup_spec_b8_vs_b1_k8"], "x aggregate"))
    rows.append(("engine_speedup_b8k8_vs_seed",
                 record["speedup_spec_b8k8_vs_seed_b1k1"],
                 "x vs B=1 per-step engine"))
    tr = record["trained"]
    rows.append(("engine_trained_heads_b1_k8", 1e6 / tr["tok_s_b1_k8"],
                 f"{tr['tok_s_b1_k8']:.1f} tok/s, AL={tr['acceptance']:.2f} "
                 f"(random AL={tr['acceptance_random_heads']:.2f}), "
                 f"{tr['arch']}, {where}"))
    hc = record["hcmp"]
    for g in hc["grid"]:
        rows.append((f"engine_hcmp_overlap_b{g['B']}_k8",
                     g["speedup_overlap_vs_inline"],
                     f"x inline ({g['overlap_tok_s']:.1f} vs "
                     f"{g['inline_tok_s']:.1f} tok/s, {hc['streams']} "
                     f"stream(s), arca picks {g['arca_partition']})"))
    return rows


def run(loaded: Loaded = None, *, arch=SMOKE_ARCH, device="cuda", width=4,
        n_tokens=64, reps=3, prompt_len=16, train_steps=120, head_steps=80,
        out_dir=None, watch=benchlib.unwatched) -> dict:
    """Measure, write ``engine_bench.json`` and print the CSV rows,
    return the record; ``loaded`` reuses weights already on the device."""
    if loaded is None:
        loaded = load(bench_config(arch), device)
    t0 = time.perf_counter()
    record = worker(loaded, width=width, n_tokens=n_tokens, reps=reps,
                    prompt_len=prompt_len, train_steps=train_steps,
                    head_steps=head_steps, watch=watch)
    record["wall_s"] = time.perf_counter() - t0
    path = benchlib.write_record("engine_bench", record, out_dir)
    for name, val, derived in rows_of(record):
        print(f"{name},{val:.4f},{derived}")
    print(f"[engine_bench] wrote {path}")
    return record


def add_args(ap):
    ap.add_argument("--arch", default=SMOKE_ARCH)
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--train-steps", type=int, default=120,
                    help="base-LM steps for the trained-heads arm")
    ap.add_argument("--head-steps", type=int, default=80,
                    help="Medusa-head steps for the trained-heads arm")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks."
                                      "engine_bench")
    add_args(ap)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="record directory (default results/torch/)")
    args = ap.parse_args(argv)
    return run(arch=args.arch, device=args.device, width=args.width,
               n_tokens=args.tokens, reps=args.reps,
               prompt_len=args.prompt_len, train_steps=args.train_steps,
               head_steps=args.head_steps, out_dir=args.out)


if __name__ == "__main__":
    main()
