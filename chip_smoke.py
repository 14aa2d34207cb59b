#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is swallowed):

1. Print the card's name and power limit (``nvidia-smi``); pin float32
   matmuls and convolutions to full precision (no TF32).
2. Build every CUDA kernel of the port from the checkout's sources, one
   ``nvcc`` per source, all started together; count the tensor-core
   products (HMMA) and async copies (LDGSTS) in the SASS of the six
   tensor-core instances: B1's, B2's and B3's over a bf16 and an int8
   pool, and B5's; and in the eight instances of B4's warp route
   (``tree_warp_kernel``, fp32 multiply-adds on the CUDA cores: no HMMA)
   (``cuobjdump -sass``).
3. Hold each kernel against its plain PyTorch version on the card, at the
   reference's tolerances (fp32 2e-5, bf16 2e-2; every output finite):
   the dense verify kernel over the reference sweep (``tests/test_kernels.py``
   CASES); the paged page walk, the cache-only walk and the tree partial
   over the window-0 CASES turned into page tables and over
   PAGED_INT8_CASES (fragmented tables, -1 entries, partial last pages);
   the normalized tree kernel and the tree partial over the reference's
   sparse sweep, the Fig. 10b shape and the main path's W=8, and the tree
   partial over PARTIAL_EDGE (both of its routes in fp32 and bf16, the
   route rule's edges W = 64 / 65 and head_dim 128 / 136, G up to 7, a
   W=256 chain); the dense
   verify and the page walk at a W=256 chain (a prefill piece, four row
   tiles) and the cache-only walk there (its split carry-folded); the
   split-edge cases of B1, B2 and B3 (SPLIT_EDGE: one, two, three and one
   split per key tile; splits wholly unreserved, past the fill or cut away
   by a window; a row whose cache is all masked; a ragged last tile over
   an int8 pool; head_dim 16 to 128, 112 among them; bf16, int8 and
   fp32); all of them at the main path's shapes.  Phase 3c: B1, B2 (bf16
   and int8 pools), B3 and B4 at the attention shapes of phase 4d's
   families (``family_kernel_cases``): ``zamba2-7b``'s shared-attention
   site (Hq = Hkv = 32, head_dim 112; B1 and B4 in fp32 too) and
   ``qwen3-moe-30b-a3b``'s layer (32 query heads over 4 kv heads, G=8,
   head_dim 128), and B1 and B2 alone at ``seamless-m4t-medium``'s
   decoder layer (Hq = Hkv = 16, head_dim 64; its verify never splits),
   at W=8 and W=1.
4. Serve ``vicuna-7b`` at full width with random bf16 weights through the
   port's serve entry point: ``--mode ghidorah --width 8`` and
   ``--mode sequential`` on the dense cache, then on the paged pool (page
   size 16): ghidorah and sequential in the model's dtype, ghidorah with
   ``--kv-dtype int8``, and ghidorah with ``--kv-dtype int8 --tree-kernel
   sparse``.  Then the continuous-batching plane on the paged pool, 12
   Poisson arrivals at 4/s: (e) the continuous scheduler with
   ``--prefill-chunk 256``, (f) the static baseline, (g) two replicas
   behind the router with the seeded chaos plan (``--inject-faults 3``).
   Every kernel's launch count is set to 0 just before each run and read
   just after: each forward of a run must go through its kernel
   (``launches == layers x (steps + prefill pieces)``; at least one in
   (g)) and through no other attention kernel.  Check the tokens, the
   logits and the page pools, and report how far the runs agree.  Every
   run takes the deployed path, the compiled chunk (one decode step
   captured in a CUDA graph and replayed; the counts come through the
   replays' tallies), and must replay its captured steps; the six
   fixed-batch runs and (e) run again op by op inside ``eager()``, with
   the same gates, and their tokens must equal the graphed run's exactly
   (on a mismatch the first divergent token and its eager logit margin
   are reported).  Print each run's tok/s and step ms on both paths and
   its graphs (captured, steps replayed, capture seconds, pool bytes).
   Time ``DecodeEngine.time_step`` for dense ghidorah and sequential at
   B=4 on both paths, and profile each fixed-batch run and (e) on both
   paths (``launch/profile_serve.py``: idle share, device time by class;
   the profiler must see the replays' kernels).
4b. ARCA and HCMP, on the same weights: (a) the analytic ``--width 0``
   choice (the paper's Jetson model) and its table; (b) measured ARCA,
   ``arca.profile_engine`` on the paged int8 engine at B=4, prompt 512:
   every width of ``arca.WIDTHS`` inline over the dense kernel, and widths
   1-16 under {inline, overlap} x {dense, sparse}, each ``time_step``
   counted (the dense arm launches B2, the sparse arm B3 and B4, once per
   layer a step) and its graphs released; the times, ``choose_strategy``'s
   table over them (E[AL], step ms, est. tok/s, partition, kernel) and the
   argmax; (c) ``--hcmp overlap`` on the fixed batch, dense and paged
   int8, graphed: the serve's gate holds the tokens to an inline twin's,
   the pre-draft hits and discards, the replayed step beside inline's, and
   from ``profile_serve`` the device time a step with two activities at
   once (the draft's branch beside the commit); (d) replay (e)'s traffic
   with ``--hcmp overlap`` (the serve's ``_hcmp_gate``: every request's
   tokens equal the inline twin's, pools drained) and with ``--spec-width
   auto --hcmp auto --tree-kernel auto`` (the widths chosen, the
   switches, the captures, tok/s, latency; every request DONE); (e) an
   error inside the overlap capture reaches the caller.
4c. Training (``training/``, ``launch/train.py``,
   ``launch/e2e_train_serve.py``), with phase 4's and 4b's engines freed:
   (a) three ``train_step``s and ``medusa_step``s from the same seeded
   float32 params at ``qwen2-0.5b-smoke`` on the card and on the CPU: loss
   trajectories within 1e-4 relative, the first step's grads within 2e-5 x
   each leaf's max |g|; (c) ``medusa_step`` at full width on phase 4's
   frozen ``vicuna-7b`` (5 heads x top-10, batch 4 x seq 256, 10 steps),
   the heads saved through ``training/checkpoint.py`` to a temporary
   directory and restored into fresh random heads bit for bit, then a
   short serve (B=4, W=8, 16 tokens) with ``--heads-ckpt`` and one with
   the heads in memory: equal tokens, B1 once a layer a forward; then,
   with phase 4's weights freed, (b) ``train_step`` at full width on
   ``qwen2-0.5b`` (bf16, batch 8 x seq 512, 20 steps) through the train
   launcher; (d) the end-to-end driver at its defaults: lossless, and
   acceptance above 1.0 (printed beside the reference's recorded 2.71).
   Every training loss finite and the mean of the last 5 under the mean
   of the first 5; no training step launches a kernel (counts from 0
   just before each part); ms a step (synchronized, past 2 warm-up
   steps), tokens/s and peak memory reported.
4d. The MoE, VLM, hybrid, xLSTM and enc-dec families at full width and
   depth, after phase 4c has
   freed its weights, one model on the card at a time (random bf16
   weights from seed 0 drawn on the card through the port's
   ``init_params``; B=4, W=8: 4 Medusa heads x top-10, 4 paths of depth
   4; 32 tokens a row, chunk 8): (a) ``qwen3-moe-30b-a3b`` (48 layers,
   128 experts top-8) served at prompt 512 on the dense cache (B1 once a
   layer a forward) and on the paged int8 pool with ``--tree-kernel
   sparse`` (B3 and B4); (b) ``llava-next-mistral-7b``'s
   ``DecodeEngine.generate`` with 2880 seeded random patch embeds before
   511 text tokens, dense and paged bf16 (each row's reservation covers
   the 3391-position prefix); (c) ``zamba2-7b`` (81 Mamba2 layers, 13
   shared-attention sites of head_dim 112) served at prompt 512 dense (B1
   once a site a forward) and paged (B2), then 8 Poisson arrivals at 4/s
   through the continuous scheduler on the paged pool, a bank of 4
   (whole-prompt admission: every request DONE with its budget, the pool
   drained); (d) ``xlstm-125m`` (12 layers, sLSTM at 3 and 9, mLSTM
   elsewhere; no KV, no kernel) served at prompt 512 dense and paged (the
   pool holds nothing), then (c)'s replay; (e) ``seamless-m4t-medium``'s
   ``generate`` with 4096 seeded random frame embeds beside the 511-token
   prompts, dense (B1 once a decoder layer a forward), paged bf16 and
   paged int8 (B2), the frames not counted as decoder positions; (d) and
   (e)'s graphed dense runs profiled (idle share, device time by
   class).  Every fixed-batch run is served graphed and again inside
   ``eager()``: full budgets, graphed tokens equal the eager ones, every
   forward through its kernel once per attention layer or site (the
   graphed run counted through the replays' tallies) and no other,
   finite teacher-forced logits.  Replayed-step ms, tok/s, prefill
   seconds and peak allocated memory are printed, with the bytes a step
   moves: the weights, the MoE experts (the one-hot dispatch reads all of
   them; uniform routing would pick fewer), the hybrid's and xLSTM's
   per-depth recurrent states and the enc-dec cross memory.
5. Drive the Fig. 10b study's path (the normalized tree kernel through its
   public entry point) with the counts set to 0 before it, and print the
   study's FLOP terms.  Time each kernel at the main path's shapes, the
   tree kernel at the Fig. 10b shape, and the dense verify and the page
   walk at the W=256 chain, with CUDA events (the cost of a call) and
   under torch.profiler (the device time of every kernel of one call: the
   split walk and its merge for B1 and B2, the walk and its carry fold for
   B3) and on the host's clock (what enqueueing one call costs the host),
   beside its plain version, one PyTorch library call where there is
   one (B3 and B4: the efficient attention kernel with its log-sum-exp;
   B2 over an int8 pool: sdpa over the dequantized view), and its
   memory/compute bound.  Time B1 and B2 at verify W=8 with the split that
   fills the card's resident block slots once (the wrappers' rule)
   against one that fills them twice, and B5 at the Fig. 10b shape with
   each of its row tiles (the picker's rule against the others).  At the
   main path's W=8, time B4's empty-launch floor on each route's grid,
   its warp route and ``tree_partial_kernel`` (device time, beside the
   bound), and break one B4 call's host time into its pieces, beside
   the whole call's and the library call's, in alternating windows.
   Time B1, B2 (bf16 and int8 pools), B3 and B4 at verify W=8 on phase
   3c's family shapes (B1 and B2 at the seamless layer) beside their
   plain versions, bounds and library calls (sdpa; over the gathered view
   for B2; the efficient-attention kernel with its log-sum-exp for B3 and
   B4): the ``families`` entries of the kernels line.
6. Print the ``{"kernels": [...]}`` line, then the device line last.

Without a GPU, or outside a checkout, it fails and prints no result.
"""
from __future__ import annotations

import contextlib
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
            chunk=8, seed=0, page_size=16)
KERNELS = {
    "verify_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/verify_attention.cu",
        "replaces": "src/repro/kernels/tree_attention.py:96"},
    "paged_tree_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/tree_attention.py:153"},
    "paged_cache_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/tree_attention.py:285"},
    "sparse_tree_attention_partial": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_partial.cu",
        "replaces": "src/repro/kernels/sparse_tree.py:57"},
    "sparse_tree_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_partial.cu",
        "replaces": "src/repro/kernels/sparse_tree.py:90"},
}
# serve runs of phase 4: label -> (mode, extra flags, the kernels each of its
# forwards launches once per layer)
SERVE_RUNS = {
    "ghidorah": ("ghidorah", [], ("verify_attention",)),
    "sequential": ("sequential", [], ("verify_attention",)),
    "paged ghidorah": ("ghidorah", ["--paged"], ("paged_tree_attention",)),
    "paged sequential": ("sequential", ["--paged"],
                         ("paged_tree_attention",)),
    "paged ghidorah int8": ("ghidorah", ["--paged", "--kv-dtype", "int8"],
                            ("paged_tree_attention",)),
    "paged ghidorah int8 sparse": (
        "ghidorah", ["--paged", "--kv-dtype", "int8", "--tree-kernel",
                     "sparse"],
        ("paged_cache_attention", "sparse_tree_attention_partial")),
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
# the window-0 CASES as page tables (paged caches take no window): page
# size, pool dtype
PAGED_FROM_CASES = [(0, 16, None), (1, 16, None), (1, 8, "bfloat16"),
                    (2, 16, None), (4, 16, None), (5, 8, None), (6, 8, None)]
# tests/test_kernels.py PAGED_INT8_CASES: B, W, Hq, Hkv, hd, ps, n_pages, maxp
PAGED_INT8_CASES = [
    (1, 1, 4, 4, 32, 8, 6, 2),
    (2, 8, 4, 2, 64, 16, 10, 3),
    (3, 4, 8, 1, 32, 4, 12, 4),
]

# tests/test_kernels.py:134-138, the sparse tree sweep (B=2): W, Hq, Hkv, hd,
# dtype
SPARSE_CASES = [(4, 4, 2, 32, "float32"), (16, 8, 8, 64, "float32"),
                (64, 4, 1, 128, "bfloat16")]
# benchmarks/sparse.py:55, the Fig. 10b shape (B=1; the tree of
# build_tree(default_accs(5, 10), 64))
FIG10B = dict(B=1, W=64, Hq=32, Hkv=8, hd=128, ctx=256)
# a --prefill-chunk 256 piece at vicuna-7b's shape: a W=256 chain verify
CHAIN_W = 256
# B4 beside the sparse sweep: each route in fp32 and bf16, the route rule's
# edges (the warp route takes W <= 64 and head_dim <= 128) and each of the
# warp route's key-slot widths (8, 16, 32, 2 x 32), G up to 7, and the
# tiles route at a W=256 chain (a prefill piece); B, W, Hq, Hkv, hd, dtype
PARTIAL_EDGE = [(2, 64, 4, 1, 128, "float32"),     # warp: W = 64
                (2, 65, 4, 1, 128, "float32"),     # tiles: W = 65
                (2, 8, 4, 4, 136, "float32"),      # tiles: head_dim 136
                (2, 8, 4, 4, 136, "bfloat16"),
                (2, 8, 4, 4, 128, "float32"),      # warp: head_dim 128
                (1, 64, 7, 1, 64, "bfloat16"),     # warp: G = 7, 56 blocks
                (3, 1, 7, 1, 128, "float32"),      # warp: W = 1
                (1, 16, 4, 1, 128, "bfloat16"),    # warp: 16 key slots
                (2, 32, 4, 2, 128, "float32"),     # warp: 32 key slots
                (2, 24, 8, 2, 128, "bfloat16"),
                (1, 33, 8, 2, 64, "float32"),      # warp: 2 x 32 key slots
                (1, CHAIN_W, 32, 32, 128, "bfloat16")]   # tiles: the chain


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


def paged_inputs(torch, np, *, B, W, Hq, Hkv, hd, ps, table, n_pages, fills,
                 pool_dtype, q_dtype, seed, tree=None):
    """Paged kernel operands on the card from a numpy seed.  Row b holds
    positions [0, fills[b]) in the logical slots of its table (shuffled
    pool pages, -1 = unreserved); the pool is random everywhere, the trash
    page and unreserved pages included.  An int8 pool is quantized per
    (page, kv head) as the reference's kernel tests do."""
    rng = np.random.default_rng(seed)
    P = n_pages + 1
    maxp = table.shape[1]
    key_pos = np.full((B, maxp * ps), -1, np.int32)
    for b, f in enumerate(fills):
        key_pos[b, :f] = np.arange(f)
    mask, depth = tree if tree is not None else rand_tree(np, W, seed=ps)
    q_pos = (np.asarray(fills)[:, None] + depth[None, :]).astype(np.int32)
    qdt = getattr(torch, q_dtype)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape, np.float32))

    pool = rng.standard_normal((2, P, ps, Hkv, hd), np.float32)
    if pool_dtype == "int8":
        scale = (np.abs(pool).max(axis=(2, 4)) / 127.0).astype(np.float32)
        codes = np.clip(np.round(pool / np.maximum(
            scale, 1e-30)[:, :, None, :, None]), -127, 127).astype(np.int8)
        pools = [torch.as_tensor(c).to(DEVICE) for c in codes]
        scales = [torch.as_tensor(c).to(DEVICE) for c in scale]
    else:
        pdt = getattr(torch, pool_dtype)
        pools = [torch.as_tensor(c).to(DEVICE, pdt) for c in pool]
        scales = [None, None]
    ints = {k: torch.as_tensor(v).to(DEVICE) for k, v in (
        ("block_table", table.astype(np.int32)), ("key_pos", key_pos),
        ("q_pos", q_pos), ("lo", np.full_like(q_pos, -1)))}
    return dict(q=randn(B, W, Hq, hd).to(DEVICE, qdt), pool_k=pools[0],
                pool_v=pools[1], scale_k=scales[0], scale_v=scales[1],
                k_new=randn(B, W, Hkv, hd).to(DEVICE, qdt),
                v_new=randn(B, W, Hkv, hd).to(DEVICE, qdt),
                tree_mask=torch.as_tensor(mask).to(DEVICE), **ints)


def paged_args(a, tree=True):
    """The wrappers' positional operands: the fused walk's (tree=True) or
    the cache-only walk's."""
    walk = (a["block_table"], a["key_pos"], a["q_pos"], a["lo"])
    head = (a["q"], a["pool_k"], a["pool_v"], a["scale_k"], a["scale_v"])
    if not tree:
        return head + walk
    return head + (a["k_new"], a["v_new"]) + walk + (a["tree_mask"],)


def paged_case_list(np):
    """(label, kwargs of ``paged_inputs``) of the paged kernel check."""
    out = []
    for i, ps, pool in PAGED_FROM_CASES:
        B, W, Hq, Hkv, hd, S, pos, _, dt = CASES[i]
        rng = np.random.default_rng(100 + i)
        maxp = -(-S // ps) + 1                 # a trailing -1 entry per row
        n_pages = B * maxp + 2
        table = np.full((B, maxp), -1, np.int32)
        table[:, :-1] = rng.permutation(n_pages)[:B * (maxp - 1)].reshape(
            B, maxp - 1)
        fills = [min(max(pos - 2 * b, 1), S) for b in range(B)]
        out.append((f"case {i} ps={ps}", dict(
            B=B, W=W, Hq=Hq, Hkv=Hkv, hd=hd, ps=ps, table=table,
            n_pages=n_pages, fills=fills, pool_dtype=pool or dt, q_dtype=dt,
            seed=i, tree=rand_tree(np, W, seed=S))))
    for i, (B, W, Hq, Hkv, hd, ps, n_pages, maxp) in enumerate(
            PAGED_INT8_CASES):
        rng = np.random.default_rng(B * W + n_pages)
        table = np.full((B, maxp), -1, np.int32)
        fills = []
        for b in range(B):
            n_res = int(rng.integers(1, maxp + 1))
            table[b, :n_res] = rng.choice(n_pages, n_res, replace=False)
            fills.append(int(rng.integers(1, n_res * ps + 1)))
        out.append((f"int8 case {i}", dict(
            B=B, W=W, Hq=Hq, Hkv=Hkv, hd=hd, ps=ps, table=table,
            n_pages=n_pages, fills=fills, pool_dtype="int8",
            q_dtype="float32", seed=50 + i)))
    return out + [(label, kw) for label, kw in paged_main_shapes(np, 0)]


def paged_main_shapes(np, seed):
    """The paged kernels at the main path's shapes: B=4, Hq=Hkv=32,
    hd=128, page size 16, 37 pages a row (the serve's reservation for
    prompt + tokens + tree depth) shuffled across the pool, rows nearly
    full at diverged positions; bf16 q; bf16 and int8 pools; verify W=8
    and decode W=1."""
    tree, depth, cfg = main_path_tree(np)
    B, ps = MAIN["batch"], MAIN["page_size"]
    maxp = -(-(MAIN["prompt_len"] + MAIN["tokens"] + depth) // ps)
    n_pages = B * maxp
    table = np.random.default_rng(seed).permutation(n_pages).reshape(
        B, maxp).astype(np.int32)
    fills = [MAIN["prompt_len"] + MAIN["tokens"] - 2 * b for b in range(B)]
    common = dict(B=B, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
                  hd=cfg.head_dim, ps=ps, table=table, n_pages=n_pages,
                  fills=fills, q_dtype="bfloat16", seed=seed)
    out = []
    for pool in ("bfloat16", "int8"):
        out.append((f"main {pool} pool verify W=8",
                    dict(common, W=MAIN["width"], pool_dtype=pool,
                         tree=tree)))
        out.append((f"main {pool} pool decode W=1",
                    dict(common, W=1, pool_dtype=pool,
                         tree=(np.ones((1, 1), bool),
                               np.zeros((1,), np.int32)))))
    return out


def paged_valid_slots(a):
    """(B, S_logical) slots some query of the row may attend to, on a
    reserved page (the slots the page walk must read)."""
    kp = a["key_pos"]
    ps = a["pool_k"].shape[1]
    reserved = (a["block_table"] >= 0).repeat_interleave(ps, dim=1)
    return (reserved & (kp >= 0)
            & (kp[:, None, :] <= a["q_pos"][:, :, None]).any(dim=1))


def paged_bytes(a, outs, cache=True, tree=True):
    """Bytes a paged kernel must move: each input read once (the pool only
    at the slots it must read, and an int8 pool's scales only for the pages
    holding them), each output written once."""
    small = [a["q"]] + list(outs)
    if tree:
        small += [a["k_new"], a["v_new"], a["tree_mask"]]
    n = 0
    if cache:
        small += [a["block_table"], a["key_pos"], a["q_pos"], a["lo"]]
        valid = paged_valid_slots(a)
        n = int(valid.sum())
        slot = a["pool_k"].shape[2] * a["pool_k"].shape[3] * \
            a["pool_k"].element_size()
        total = 2 * n * slot
        if a["scale_k"] is not None:
            ps = a["pool_k"].shape[1]
            pages = int(valid.reshape(valid.shape[0], -1, ps).any(-1).sum())
            total += 2 * pages * a["scale_k"].shape[1] * 4
    else:
        total = 0
    return total + sum(t.numel() * t.element_size() for t in small), n


def paged_ops(a, n_slots, cache=True, tree=True):
    B, W, Hq, hd = a["q"].shape
    keys = (n_slots if cache else 0) + (B * W if tree else 0)
    return 4 * Hq * W * hd * keys          # q.k and p.v multiply-adds


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
        # per kernel instance: its registers, then its spills (-Xptxas -v)
        for line in text.strip().splitlines():
            if "registers" in line or "spill" in line or "error" in line \
                    or "warning" in line:
                log(f"  {name}: {line.strip()}")
    return sass_counts(build)


# the tensor-core instances phase 2 expects: B1 bf16; B2 and B3 over a
# bf16 and an int8 pool; B5 bf16
TENSOR_CORE_INSTANCES = 6
# B4's warp route: fp32 and bf16 at 8, 16, 32 and 2 x 32 key slots a row
WARP_INSTANCES = 8


def sass_counts(build):
    """Tensor-core products (HMMA) and async copies (LDGSTS) in the SASS
    of each tensor-core (bf16) instance of B1, B2, B3 and B5 (every kernel
    symbol with ``flash_kernel`` in its name), and HMMA, LDGSTS and fp32
    multiply-adds (FFMA) in each instance of B4's warp route
    (``tree_warp_kernel``, CUDA cores only), from ``cuobjdump -sass`` of
    the built libraries; fails if a tensor-core instance lacks HMMA or
    LDGSTS, or a warp instance lacks LDGSTS or FFMA or has an HMMA."""
    tool = Path(build.nvcc()).parent / "cuobjdump"
    counts, warp = {}, {}
    for name in build.SOURCES:
        path = build.library_path(name)
        sass = subprocess.run([str(tool), "-sass", str(path)],
                              capture_output=True, text=True, timeout=300)
        if sass.returncode != 0:
            raise SmokeError(f"cuobjdump failed on {path.name}: "
                             f"{sass.stderr.strip()}")
        for fn in sass.stdout.split("Function : ")[1:]:
            symbol = fn.split(None, 1)[0]
            key = f"{name}:{symbol}"
            if "tree_warp_kernel" in symbol:
                warp[key] = {op: fn.count(op)
                             for op in ("HMMA", "LDGSTS", "FFMA")}
                log(f"SASS {key}: {warp[key]} (no tensor cores)")
                if warp[key]["HMMA"] or not (warp[key]["LDGSTS"]
                                             and warp[key]["FFMA"]):
                    raise SmokeError(f"{key}: expected async copies, fp32 "
                                     f"multiply-adds and no tensor-core "
                                     f"product: {warp[key]}")
                continue
            if "flash_kernel" not in symbol:
                continue
            counts[key] = {op: fn.count(op) for op in ("HMMA", "LDGSTS")}
            log(f"SASS {key}: {counts[key]}")
            if not all(counts[key].values()):
                raise SmokeError(f"{key} has no tensor-core product or no "
                                 f"async copy: {counts[key]}")
    if len(counts) != TENSOR_CORE_INSTANCES:
        raise SmokeError(f"expected {TENSOR_CORE_INSTANCES} tensor-core "
                         f"instances (B1 bf16; B2 and B3 over bf16 and int8 "
                         f"pools; B5 bf16), found {sorted(counts)}")
    if len(warp) != WARP_INSTANCES:
        raise SmokeError(f"expected {WARP_INSTANCES} instances of B4's warp "
                         f"route, found {sorted(warp)}")
    return dict(counts, **warp)


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


def _hold(torch, name, label, got, want, tol):
    """Max abs error of a kernel's outputs against its plain version's;
    raises unless every element is within ``tol`` (atol = rtol) and
    finite."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = max(err, float((g - w).abs().max()))
        if not bool(torch.isclose(g, w, atol=tol, rtol=tol).all()) or \
                not bool(torch.isfinite(g).all()):
            raise SmokeError(f"{name} disagrees with its plain version at "
                             f"{label}: max abs err {err:.3e} > {tol}")
    return err


def phase_paged_kernel_check(torch, np):
    """The paged page walk, the cache-only walk and the tree partial
    against their plain versions, at the tolerance of q's dtype (the
    partials are fp32 whatever q's dtype)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain
    from repro_torch.kernels import tree_partial as tp
    worst = dict.fromkeys(("paged_tree_attention", "paged_cache_attention",
                           "sparse_tree_attention_partial"), 0.0)
    for label, kw in paged_case_list(np):
        a = paged_inputs(torch, np, **kw)
        tol = TOL[str(a["q"].dtype)]
        tree_in = (a["q"], a["k_new"], a["v_new"], a["tree_mask"])
        runs = {
            "paged_tree_attention": (
                pa.paged_tree_attention(*paged_args(a)),
                plain.paged_tree_attention_plain(*paged_args(a))),
            "paged_cache_attention": (
                pa.paged_cache_attention(*paged_args(a, tree=False)),
                plain.paged_cache_attention_plain(*paged_args(a, tree=False))),
            "sparse_tree_attention_partial": (
                tp.sparse_tree_attention_partial(*tree_in),
                plain.sparse_tree_attention_partial_plain(*tree_in)),
        }
        torch.cuda.synchronize()
        errs = []
        for name, (got, want) in runs.items():
            e = _hold(torch, name, label, got, want, tol)
            worst[name] = max(worst[name], e)
            errs.append(f"{e:.2e}")
        log(f"paged kernels vs plain {label} q {kw['q_dtype']} pool "
            f"{kw['pool_dtype']} B={kw['B']} W={kw['W']} Hq={kw['Hq']} "
            f"Hkv={kw['Hkv']} hd={kw['hd']} ps={kw['ps']} "
            f"pages/row={kw['table'].shape[1]}: max abs err fused {errs[0]} "
            f"cache-only {errs[1]} tree partial {errs[2]}")
    return worst


def fig10b_tree(np):
    """The Fig. 10b study's tree: ``build_tree(default_accs(5, 10), 64)``
    as (mask, depth)."""
    from repro_torch.core.speculative import tree as T
    spec = T.build_tree(T.default_accs(5, 10), FIG10B["W"])
    return spec.mask, spec.depth.astype(np.int32)


def chain_tree(np, W):
    """A W-token chain (a prefill piece) as (mask, depth)."""
    return (np.tril(np.ones((W, W), bool)),
            np.arange(W, dtype=np.int32))


def sparse_inputs(torch, np, *, B, W, Hq, Hkv, hd, dtype, mask, seed):
    """(q, k_new, v_new, tree_mask) of the tree kernels on the card."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape, np.float32)).to(
            DEVICE, dt)

    return (randn(B, W, Hq, hd), randn(B, W, Hkv, hd), randn(B, W, Hkv, hd),
            torch.as_tensor(mask).to(DEVICE))


def sparse_case_list(np):
    """(label, kwargs of ``sparse_inputs``) of the tree kernels' check: the
    reference's sparse sweep, the Fig. 10b shape in fp32 and bf16, and the
    main path's W=8 tree."""
    out = [(f"sweep W={W}", dict(B=2, W=W, Hq=Hq, Hkv=Hkv, hd=hd, dtype=dt,
                                 mask=rand_tree(np, W, seed=W)[0]))
           for W, Hq, Hkv, hd, dt in SPARSE_CASES]
    fig = {k: v for k, v in FIG10B.items() if k != "ctx"}
    for dt in ("float32", "bfloat16"):
        out.append((f"fig10b {dt}", dict(fig, dtype=dt,
                                         mask=fig10b_tree(np)[0])))
    tree, _, cfg = main_path_tree(np)
    out.append(("main W=8", dict(B=MAIN["batch"], W=MAIN["width"],
                                 Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
                                 hd=cfg.head_dim, dtype="bfloat16",
                                 mask=tree[0])))
    return out


def chain_cases(np):
    """B1 and B2 at a W=256 chain, the second prefill piece of a
    512-token prompt under ``--prefill-chunk 256`` at the main model's
    shape: 256 cached positions, then the piece."""
    _, depth, cfg = main_path_tree(np)
    dims = dict(B=1, W=CHAIN_W, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
                hd=cfg.head_dim)
    ps = MAIN["page_size"]
    maxp = -(-(2 * CHAIN_W + MAIN["tokens"] + depth) // ps)
    table = np.random.default_rng(3).permutation(maxp)[None].astype(np.int32)
    dense = dict(dims, S=2 * CHAIN_W, pos=CHAIN_W, window=0,
                 dtype="bfloat16", tree=chain_tree(np, CHAIN_W))
    paged = dict(dims, ps=ps, table=table, n_pages=maxp, fills=[CHAIN_W],
                 pool_dtype="bfloat16", q_dtype="bfloat16", seed=4,
                 tree=chain_tree(np, CHAIN_W))
    return dense, paged


# split-edge cases of phase 3 (B1, B2 and B3 where the split walk's edges
# show; B3's walk has no tree part and splits alike): S slots (320: 5 key
# tiles, 20 pages of 16; 592: the main path's 37 pages, whose last key
# tile holds 16 slots), rows filled to S, 70 and
# 200 slots; row 0 under a 100-position window (lo cuts its first splits
# away), row 2 with lo = q_pos (its whole cache masked); in the paged
# layout row 1's pages 4-7 unreserved (-1: a whole split) and pages past
# each fill unreserved.  Hkv picks the split count (launch.pick_split
# fills the card's 264 resident block slots): at S = 320, B*Hkv = 6
# blocks give one split per tile, 72 three, 96 two, 144 one; at S = 592,
# 24 give one per tile (10).  G*W <= 32 rows at head_dim 16 fold four and
# two key groups in a block of 29 KB.  Label -> (Hkv, G, W, hd, q dtype,
# pool dtype, S).
SPLIT_EDGE = {
    "per-tile G=4 W=8 bf16 hd=128": (2, 4, 8, 128, "bfloat16", "bfloat16",
                                     320),
    "per-tile G=1 W=1 bf16 hd=128": (2, 1, 1, 128, "bfloat16", "bfloat16",
                                     320),
    "per-tile G=6 W=8 bf16 hd=80": (2, 6, 8, 80, "bfloat16", "bfloat16",
                                    320),
    "per-tile G=12 W=8 bf16 hd=40": (2, 12, 8, 40, "bfloat16", "bfloat16",
                                     320),
    "per-tile G=1 W=8 bf16 hd=16": (2, 1, 8, 16, "bfloat16", "bfloat16",
                                    320),
    "per-tile G=4 W=8 bf16 hd=16": (2, 4, 8, 16, "bfloat16", "bfloat16",
                                    320),
    "per-tile G=2 W=8 int8 hd=64": (2, 2, 8, 64, "bfloat16", "int8", 320),
    "per-tile G=2 W=8 fp32 hd=64": (2, 2, 8, 64, "float32", "float32", 320),
    "per-tile G=2 W=8 fp32 q int8 hd=32": (2, 2, 8, 32, "float32", "int8",
                                           320),
    "3 splits G=1 W=8 bf16 hd=128": (24, 1, 8, 128, "bfloat16", "bfloat16",
                                     320),
    "2 splits G=1 W=8 int8 hd=64": (32, 1, 8, 64, "bfloat16", "int8", 320),
    "1 split G=1 W=8 bf16 hd=64": (48, 1, 8, 64, "bfloat16", "bfloat16",
                                   320),
    "ragged S=592 per-tile G=1 W=8 int8 hd=128": (8, 1, 8, 128, "bfloat16",
                                                  "int8", 592),
    "ragged S=592 2 splits G=1 W=8 int8 hd=128": (32, 1, 8, 128,
                                                  "bfloat16", "int8", 592),
    # zamba2-7b's shared-attention head_dim, 7 MMA k-steps of 16
    "Hkv=2 G=1 W=8 bf16 hd=112": (2, 1, 8, 112, "bfloat16", "bfloat16",
                                  320),
    "Hkv=32 G=1 W=8 int8 hd=112": (32, 1, 8, 112, "bfloat16", "int8", 320),
}
EDGE_PS = 16


def edge_fills(S):
    """The split-edge rows' fills: the whole cache, 70 and 200 slots."""
    return (S, 70, 200)


def split_edge_inputs(torch, np, Hkv, G, W, hd, q_dtype, pool_dtype, S,
                      seed):
    """(dense args of ``verify_attention``, paged dict of ``paged_args``)
    of one SPLIT_EDGE case from a numpy seed; the dense cache holds the
    paged pool's logical view (float32 for an int8 pool's dequant), so
    both walks see the same keys."""
    rng = np.random.default_rng(seed)
    fills = np.asarray(edge_fills(S), np.int32)
    B, ps, Hq = len(fills), EDGE_PS, Hkv * G
    maxp = -(-S // ps)
    mask, depth = rand_tree(np, W, seed=W)
    key_pos = np.full((B, S), -1, np.int32)
    for b, f in enumerate(fills):
        key_pos[b, :f] = np.arange(f)
    q_pos = (fills[:, None] + depth[None, :]).astype(np.int32)
    lo = np.full_like(q_pos, -1)
    lo[0] = q_pos[0] - 100
    lo[2] = q_pos[2]
    n_pages = B * maxp
    table = rng.permutation(n_pages).reshape(B, maxp).astype(np.int32)
    table[1, 4:8] = -1
    for b, f in enumerate(fills):
        table[b, -(-f // ps):] = -1
    key_pos[1, 4 * ps:8 * ps] = -1            # no key on an unreserved page
    pool = rng.standard_normal((2, n_pages + 1, ps, Hkv, hd), np.float32)
    qdt = getattr(torch, q_dtype)

    def dev(a, dt=None):
        t = torch.as_tensor(a).to(DEVICE)
        return t if dt is None else t.to(dt)

    if pool_dtype == "int8":
        scale = (np.abs(pool).max(axis=(2, 4)) / 127.0).astype(np.float32)
        codes = np.clip(np.round(pool / np.maximum(
            scale, 1e-30)[:, :, None, :, None]), -127, 127).astype(np.int8)
        view = codes.astype(np.float32) * scale[:, :, None, :, None]
        pools = [dev(c) for c in codes]
        scales = [dev(c) for c in scale]
    else:
        view = pool
        pools = [dev(c, getattr(torch, pool_dtype)) for c in pool]
        scales = [None, None]
    # the logical view through the table (-1 -> the trash page, last)
    t = np.where(table < 0, n_pages, table)
    ck, cv = (view[i][t].reshape(B, S, Hkv, hd) for i in range(2))
    q = rng.standard_normal((B, W, Hq, hd), np.float32)
    kn, vn = rng.standard_normal((2, B, W, Hkv, hd), np.float32)
    ints = [dev(a) for a in (key_pos, q_pos, lo)]
    dense = (dev(q, qdt), dev(ck, qdt), dev(cv, qdt), dev(kn, qdt),
             dev(vn, qdt), *ints, dev(mask))
    paged = dict(q=dense[0], pool_k=pools[0], pool_v=pools[1],
                 scale_k=scales[0], scale_v=scales[1], k_new=dense[3],
                 v_new=dense[4], block_table=dev(table), key_pos=ints[0],
                 q_pos=ints[1], lo=ints[2], tree_mask=dense[8])
    return dense, paged


def phase_split_edge_check(torch, np):
    """B1 (dense, the pool's logical view in q's dtype), B2 (paged) and B3
    (the cache-only page walk, split without a tree part and carry-folded)
    against their plain versions over SPLIT_EDGE: one split per tile,
    three, two and one; splits wholly unreserved, past the fill, cut away
    by lo; a row whose cache is all masked; a last key tile of 16 slots
    over an int8 pool; 1 to 96 query rows per kv head (four key groups to
    two row tiles); head_dim 16, 40 (padded to 48), 64, 80, 128; bf16,
    int8 and fp32 pools.  int8 under fp32 q is held at 2e-5 against the
    int8 oracle (the plain version)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain
    from repro_torch.kernels.verify_attention import verify_attention
    worst = dict.fromkeys(("verify_attention", "paged_tree_attention",
                           "paged_cache_attention"), 0.0)
    for i, (label, case) in enumerate(SPLIT_EDGE.items()):
        dense, paged = split_edge_inputs(torch, np, *case, seed=800 + i)
        tol = TOL[str(dense[0].dtype)]
        cache_args = paged_args(paged, tree=False)
        runs = {"verify_attention": (verify_attention(*dense),
                                     plain.tree_attention_plain(*dense)),
                "paged_tree_attention": (
                    pa.paged_tree_attention(*paged_args(paged)),
                    plain.paged_tree_attention_plain(*paged_args(paged))),
                "paged_cache_attention": (
                    pa.paged_cache_attention(*cache_args),
                    plain.paged_cache_attention_plain(*cache_args))}
        torch.cuda.synchronize()
        errs = []
        for name, (got, want) in runs.items():
            e = _hold(torch, name, f"split edge {label}", got, want, tol)
            worst[name] = max(worst[name], e)
            errs.append(f"{name} {e:.2e}")
        log(f"split edge {label} (Hkv={case[0]}): max abs err "
            f"{', '.join(errs)} (tol {tol})")
    return worst


# the families whose verify never splits (the enc-dec drops
# ``--tree-kernel sparse``): phases 3c and 5 hold only B1 and B2 there
FUSED_ONLY = ("seamless-m4t-medium",)


def family_kernel_cases(np):
    """(label, arch, W, dense kwargs of ``attention_inputs``, paged kwargs
    of ``paged_inputs`` without the pool dtype) of phase 3c: the kernels
    at the attention shapes of phase 4d's families: ``zamba2-7b``'s
    shared-attention site (Hq = Hkv = 32, head_dim 112),
    ``qwen3-moe-30b-a3b``'s layer (32 query heads over 4 kv heads, G=8,
    head_dim 128) and ``seamless-m4t-medium``'s decoder self-attention
    (Hq = Hkv = 16, head_dim 64); B=4, the W=8 tree of 4 Medusa heads x
    top-10 and W=1, the cache nearly full at the end of a 512 + 32 token
    serve."""
    from repro_torch.configs import get_config
    from repro_torch.core.speculative import tree as T
    out = []
    for arch in ("zamba2-7b", "qwen3-moe-30b-a3b", "seamless-m4t-medium"):
        cfg = get_config(arch)
        spec = T.build_tree(T.default_accs(cfg.medusa_heads,
                                           cfg.medusa_top_k),
                            FAMILY["width"])
        depth = spec.max_depth
        B, ps = FAMILY["batch"], FAMILY["page_size"]
        S = FAMILY["prompt_len"] + FAMILY["tokens"] + depth
        maxp = -(-S // ps)
        table = np.random.default_rng(S).permutation(B * maxp).reshape(
            B, maxp).astype(np.int32)
        fills = [S - depth - 2 * b for b in range(B)]
        dims = dict(B=B, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
                    hd=cfg.head_dim)
        for W, tree in ((spec.width, (spec.mask,
                                      spec.depth.astype(np.int32))),
                        (1, (np.ones((1, 1), bool),
                             np.zeros((1,), np.int32)))):
            dense = dict(dims, W=W, S=S, pos=S - depth, window=0,
                         tree=tree)
            paged = dict(dims, W=W, ps=ps, table=table, n_pages=B * maxp,
                         fills=fills, tree=tree)
            out.append((f"{arch} W={W}", arch, W, dense, paged))
    return out


def phase_family_kernel_check(torch, np):
    """Phase 3c: B1, B2 (bf16 and int8 pools), B3 (int8) and B4 against
    their plain versions at ``family_kernel_cases``' shapes, bf16 queries
    (the models' dtype), and B1 and B4 in fp32 at head_dim 112 (the CUDA
    cores' route), at the reference's tolerances; B1 and B2 alone at the
    ``FUSED_ONLY`` families' shapes.  Returns the worst error per
    kernel."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain
    from repro_torch.kernels import tree_partial as tp
    from repro_torch.kernels.verify_attention import verify_attention
    worst = dict.fromkeys(("verify_attention", "paged_tree_attention",
                           "paged_cache_attention",
                           "sparse_tree_attention_partial"), 0.0)
    for i, (label, arch, W, dense, paged) in enumerate(
            family_kernel_cases(np)):
        dtypes = ("bfloat16", "float32") if dense["hd"] == 112 \
            else ("bfloat16",)
        for dt in dtypes:
            args = attention_inputs(torch, np, seed=600 + i, dtype=dt,
                                    **dense)
            tol = TOL[str(args[0].dtype)]
            tree_in = (args[0], args[3], args[4], args[8])
            split = arch not in FUSED_ONLY
            errs = {"verify_attention": _hold(
                        torch, "verify_attention", f"{label} {dt}",
                        verify_attention(*args),
                        plain.tree_attention_plain(*args), tol)}
            if split:
                errs["sparse_tree_attention_partial"] = _hold(
                    torch, "sparse_tree_attention_partial",
                    f"{label} {dt}",
                    tp.sparse_tree_attention_partial(*tree_in),
                    plain.sparse_tree_attention_partial_plain(*tree_in),
                    tol)
            if dt == "bfloat16":
                for pool in ("bfloat16", "int8"):
                    a = paged_inputs(torch, np, seed=650 + i,
                                     pool_dtype=pool, q_dtype=dt, **paged)
                    e = _hold(torch, "paged_tree_attention",
                              f"{label} {pool} pool",
                              pa.paged_tree_attention(*paged_args(a)),
                              plain.paged_tree_attention_plain(
                                  *paged_args(a)), tol)
                    errs[f"paged_tree_attention {pool}"] = e
                    if pool == "int8" and split:
                        errs["paged_cache_attention"] = _hold(
                            torch, "paged_cache_attention",
                            f"{label} int8 pool",
                            pa.paged_cache_attention(
                                *paged_args(a, tree=False)),
                            plain.paged_cache_attention_plain(
                                *paged_args(a, tree=False)), tol)
            torch.cuda.synchronize()
            for name, e in errs.items():
                key = name.split()[0]
                worst[key] = max(worst[key], e)
            log(f"family shapes vs plain {label} ({arch}: Hq="
                f"{dense['Hq']} Hkv={dense['Hkv']} hd={dense['hd']}) q {dt}:"
                f" max abs err " + ", ".join(f"{k} {v:.2e}"
                                             for k, v in errs.items())
                + f" (tol {tol})")
    return worst


# the second kernel of a split walk, which a one-split plan leaves out
_ONE_SPLIT = ("merge_kernel", "carry_fold_kernel")


def _sdpa_ms(torch, lib_sets, ref):
    """``library_ms`` of a normalized verify: one
    ``scaled_dot_product_attention`` over ``lib_sets`` (``sdpa_inputs``),
    checked against the plain version's output ``ref`` first.  Returns
    (ms, note)."""
    import torch.nn.functional as F

    def call(a):
        return F.scaled_dot_product_attention(a[0], a[1], a[2],
                                              attn_mask=a[3])
    err = float((call(lib_sets[0]).transpose(1, 2).float() - ref.float())
                .abs().max())
    return timed(torch, call, lib_sets), (
        f" (sdpa; max abs diff to plain {err:.2e})")


def phase_family_timing(torch, np, card):
    """B1, B2 (bf16 and int8 pools), B3 (int8) and B4 at verify W=8 on
    ``family_kernel_cases``' shapes (bf16 queries; B1 and B2 alone at the
    ``FUSED_ONLY`` families'), each cycling 4 input sets, beside its
    plain version, its bound and one library call: sdpa over the dense
    cache and the tree (B1), over the view gathered through the table
    (B2; an int8 pool's view dequantized to bf16; the gather not timed),
    the efficient-attention kernel with its log-sum-exp (B3, B4:
    ``lse_library``)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain
    from repro_torch.kernels import tree_partial as tp
    from repro_torch.kernels.verify_attention import verify_attention
    from repro_torch.runtime.cache import gather_pages_dequant
    rows = {}

    for label, arch, W, dense, paged in family_kernel_cases(np):
        if W == 1:
            continue
        split = arch not in FUSED_ONLY
        sets = [attention_inputs(torch, np, seed=700 + r, dtype="bfloat16",
                                 **dense) for r in range(4)]
        ref = plain.tree_attention_plain(*sets[0])
        nbytes, _ = needed_bytes(torch, sets[0], ref)
        library_ms, note = _sdpa_ms(
            torch, [sdpa_inputs(torch, a) for a in sets], ref)
        rows[f"B1 {label}"] = time_row(
            torch, card, f"B1 {label}", SYMBOLS["verify_attention"],
            lambda a: verify_attention(*a),
            lambda a: plain.tree_attention_plain(*a), sets, nbytes,
            needed_ops(sets[0]), sets[0][0].dtype, note=note,
            optional=_ONE_SPLIT, library_ms=library_ms)
        if split:
            tree_sets = [(a[0], a[3], a[4], a[8]) for a in sets]
            part = plain.sparse_tree_attention_partial_plain(*tree_sets[0])
            tb = sum(t.numel() * t.element_size()
                     for t in list(tree_sets[0]) + list(part))
            B, Wq, Hq, hd = sets[0][0].shape
            library_ms, note = lse_library(torch, [lse_inputs(
                torch, dict(q=a[0], k_new=a[1], v_new=a[2], tree_mask=a[3]),
                cache=False) for a in tree_sets], part)
            rows[f"B4 {label}"] = time_row(
                torch, card, f"B4 {label}",
                SYMBOLS["sparse_tree_attention_partial"],
                lambda a: tp.sparse_tree_attention_partial(*a),
                lambda a: plain.sparse_tree_attention_partial_plain(*a),
                tree_sets, tb, 4 * B * Hq * Wq * Wq * hd, sets[0][0].dtype,
                note=note, library_ms=library_ms)
            del tree_sets
        del sets
        for pool in ("bfloat16", "int8"):
            psets = [paged_inputs(torch, np, seed=750 + r, pool_dtype=pool,
                                  q_dtype="bfloat16", **paged)
                     for r in range(4)]
            a0 = psets[0]
            outs = (plain.paged_tree_attention_plain(*paged_args(a0)),)
            nbytes, n = paged_bytes(a0, outs)

            def view(a, which):
                return gather_pages_dequant(
                    a[f"pool_{which}"], a[f"scale_{which}"],
                    a["block_table"]).to(torch.bfloat16)
            library_ms, note = _sdpa_ms(torch, [sdpa_inputs(torch, (
                a["q"], view(a, "k"), view(a, "v"), a["k_new"], a["v_new"],
                a["key_pos"], a["q_pos"], a["lo"], a["tree_mask"]))
                for a in psets], outs[0])
            rows[f"B2 {pool} pool {label}"] = time_row(
                torch, card, f"B2 {pool} pool {label}",
                SYMBOLS["paged_tree_attention"],
                lambda a: pa.paged_tree_attention(*paged_args(a)),
                lambda a: plain.paged_tree_attention_plain(*paged_args(a)),
                psets, nbytes, paged_ops(a0, n), a0["q"].dtype,
                note=note + " over the gathered view",
                optional=_ONE_SPLIT, library_ms=library_ms)
            if pool == "int8" and split:
                outs = plain.paged_cache_attention_plain(
                    *paged_args(a0, tree=False))
                nbytes, n = paged_bytes(a0, outs, tree=False)
                library_ms, note = lse_library(
                    torch, [lse_inputs(torch, a, cache=True) for a in psets],
                    outs)
                rows[f"B3 int8 pool {label}"] = time_row(
                    torch, card, f"B3 int8 pool {label}",
                    SYMBOLS["paged_cache_attention"],
                    lambda a: pa.paged_cache_attention(
                        *paged_args(a, tree=False)),
                    lambda a: plain.paged_cache_attention_plain(
                        *paged_args(a, tree=False)),
                    psets, nbytes, paged_ops(a0, n, tree=False),
                    a0["q"].dtype, note=note, optional=_ONE_SPLIT,
                    library_ms=library_ms)
            del psets
    return rows


def phase_sparse_kernel_check(torch, np):
    """The normalized tree kernel (B5) and the tree partial (B4) against
    their plain versions over the reference's sparse sweep, the Fig. 10b
    shape and the main path's W=8, and B4 over ``PARTIAL_EDGE`` (both
    routes, fp32 and bf16); the dense verify (B1), the fused page
    walk (B2) and the cache-only walk (B3, four row tiles in each of its
    two splits) at a W=256 chain, where G*W rows outgrow one block."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain
    from repro_torch.kernels import tree_partial as tp
    from repro_torch.kernels.verify_attention import verify_attention
    worst = dict.fromkeys(("sparse_tree_attention",
                           "sparse_tree_attention_partial",
                           "verify_attention", "paged_tree_attention",
                           "paged_cache_attention"), 0.0)
    for i, (label, kw) in enumerate(sparse_case_list(np)):
        args = sparse_inputs(torch, np, seed=300 + i, **kw)
        tol = TOL[str(args[0].dtype)]
        runs = {"sparse_tree_attention": (
                    tp.sparse_tree_attention(*args),
                    plain.sparse_tree_attention_plain(*args)),
                "sparse_tree_attention_partial": (
                    tp.sparse_tree_attention_partial(*args),
                    plain.sparse_tree_attention_partial_plain(*args))}
        torch.cuda.synchronize()
        errs = []
        for name, (got, want) in runs.items():
            e = _hold(torch, name, label, got, want, tol)
            worst[name] = max(worst[name], e)
            errs.append(f"{e:.2e}")
        log(f"tree kernels vs plain {label} {kw['dtype']} B={kw['B']} "
            f"W={kw['W']} Hq={kw['Hq']} Hkv={kw['Hkv']} hd={kw['hd']} "
            f"({int(kw['mask'].sum())} of {kw['W'] ** 2} mask entries): max "
            f"abs err normalized {errs[0]} partial {errs[1]}")
    for i, (B, W, Hq, Hkv, hd, dt) in enumerate(PARTIAL_EDGE):
        mask = chain_tree(np, W)[0] if W == CHAIN_W else \
            rand_tree(np, W, seed=W)[0]
        args = sparse_inputs(torch, np, B=B, W=W, Hq=Hq, Hkv=Hkv, hd=hd,
                             dtype=dt, mask=mask, seed=400 + i)
        e = _hold(torch, "sparse_tree_attention_partial", f"edge {i}",
                  tp.sparse_tree_attention_partial(*args),
                  plain.sparse_tree_attention_partial_plain(*args),
                  TOL[str(args[0].dtype)])
        worst["sparse_tree_attention_partial"] = max(
            worst["sparse_tree_attention_partial"], e)
        route = tp.partial_route(W, hd)
        log(f"tree partial vs plain edge {i} ({'warp' if route else 'tiles'}"
            f" route) {dt} B={B} W={W} Hq={Hq} Hkv={Hkv} hd={hd}: max abs "
            f"err {e:.2e}")
    dense, paged = chain_cases(np)
    args = attention_inputs(torch, np, seed=7, **dense)
    worst["verify_attention"] = _hold(
        torch, "verify_attention", "W=256 chain", verify_attention(*args),
        plain.tree_attention_plain(*args), TOL["torch.bfloat16"])
    a = paged_inputs(torch, np, **paged)
    worst["paged_tree_attention"] = _hold(
        torch, "paged_tree_attention", "W=256 chain",
        pa.paged_tree_attention(*paged_args(a)),
        plain.paged_tree_attention_plain(*paged_args(a)),
        TOL["torch.bfloat16"])
    worst["paged_cache_attention"] = _hold(
        torch, "paged_cache_attention", "W=256 chain",
        pa.paged_cache_attention(*paged_args(a, tree=False)),
        plain.paged_cache_attention_plain(*paged_args(a, tree=False)),
        TOL["torch.bfloat16"])
    torch.cuda.synchronize()
    log(f"W=256 chain (B=1, Hq=Hkv={dense['Hq']}, hd={dense['hd']}, bf16, "
        f"256 cached positions): max abs err verify_attention "
        f"{worst['verify_attention']:.2e}, paged_tree_attention "
        f"{worst['paged_tree_attention']:.2e}, paged_cache_attention "
        f"{worst['paged_cache_attention']:.2e}")
    return worst


def kernel_wrappers():
    """Every kernel wrapper of the port, by name: each counts its own
    launches in ``.launches``."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import tree_partial as tp
    from repro_torch.kernels.verify_attention import verify_attention
    return {"verify_attention": verify_attention,
            "paged_tree_attention": pa.paged_tree_attention,
            "paged_cache_attention": pa.paged_cache_attention,
            "sparse_tree_attention_partial":
                tp.sparse_tree_attention_partial,
            "sparse_tree_attention": tp.sparse_tree_attention}


def argv(mode, **over):
    """The serve entry point's flags of the main path in ``mode`` (``over``
    replaces MAIN's values)."""
    m = dict(MAIN, **over)
    return ["--arch", m["arch"], "--mode", mode,
            "--width", str(m["width"]), "--batch", str(m["batch"]),
            "--prompt-len", str(m["prompt_len"]),
            "--tokens", str(m["tokens"]), "--chunk", str(m["chunk"]),
            "--seed", str(m["seed"]), "--device", DEVICE,
            "--page-size", str(m["page_size"]), "--pool-pages", "0"]


def phase_serve(torch, np):
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import eager

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

    wrappers = kernel_wrappers()
    results = {}
    launches = dict.fromkeys(wrappers, 0)
    for label, (mode, flags, kernels) in SERVE_RUNS.items():
        args = serve.parse_args(argv(mode) + flags)
        runs = {}
        for path in ("graphed", "eager"):
            for fn in wrappers.values():      # counts from here: main path
                fn.launches = 0
            with (eager() if path == "eager" else contextlib.nullcontext()):
                res = serve.run(args, loaded)
            torch.cuda.synchronize()
            counts = {name: fn.launches for name, fn in wrappers.items()}
            stats = res["stats"]
            steps = stats["device_steps"]
            want = cfg.num_layers * steps
            step_ms = 1e3 * sum(stats["step_times"]) / max(steps, 1)
            graphs = graph_summary(res["engines"])
            log(f"{label} ({' '.join(flags) or 'dense cache'}), {path}: "
                f"{stats['emitted_total']} tokens, "
                f"{stats['emitted_total'] / res['seconds']:.1f} tok/s, "
                f"{steps} steps, mean step {step_ms:.2f} ms, acceptance "
                f"length {stats['acceptance_length']:.3f}, kernel launches "
                f"{counts} (want {want} = {cfg.num_layers} layers x {steps} "
                f"steps for {', '.join(kernels)}, 0 for the others)")
            if stats["emitted_total"] != MAIN["batch"] * MAIN["tokens"]:
                raise SmokeError(f"{label} ({path}) emitted "
                                 f"{stats['emitted_total']} tokens, expected "
                                 f"{MAIN['batch'] * MAIN['tokens']}")
            for name, got in counts.items():
                if got != (want if name in kernels else 0) or \
                        (name in kernels and got == 0):
                    raise SmokeError(f"{label} ({path}): {got} {name} "
                                     f"launches, expected "
                                     f"{want if name in kernels else 0}")
                if path == "graphed":
                    launches[name] += got
            check_graphs(label, path, graphs, steps)
            runs[path] = dict(res, step_ms=step_ms, counts=counts,
                              graphs=graphs,
                              tok_s=stats["emitted_total"] / res["seconds"],
                              replay_step_ms=1e3 * stats["replay_s"]
                              / max(stats["replay_steps"], 1))
        g, e = runs["graphed"], runs["eager"]
        log(f"{label}: graphed {g['tok_s']:.1f} tok/s, step "
            f"{g['step_ms']:.2f} ms (replayed chunks "
            f"{g['replay_step_ms']:.2f} ms a step over "
            f"{g['stats']['replay_steps']} steps), {_graphs_text(g)}; "
            f"eager {e['tok_s']:.1f} tok/s, step {e['step_ms']:.2f} ms")
        for row in range(e["out"].shape[0]):
            bad = divergence(torch, np, loaded, e["prompts"][row],
                             e["out"][row], g["out"][row])
            if bad is not None:
                raise SmokeError(f"{label}: graphed tokens differ from the "
                                 f"eager ones: row {row}, first at index "
                                 f"{bad[0]} (eager logit margin {bad[1]:.4f})")
        results[label] = dict(g, eager=e)
    log("every fixed-batch run's graphed tokens equal its eager tokens")
    check_outputs(torch, np, loaded, results)
    return launches, results, loaded


def graph_summary(engines):
    """The chunk graphs' counters, summed over a run's engines."""
    out = dict(captures=0, replays=0, warmup_steps=0, capture_s=0.0,
               pool_bytes=0)
    for eng in engines:
        for k in out:
            out[k] += eng.graph_stats[k]
    return out


def _graphs_text(run):
    g = run["graphs"]
    return (f"{g['captures']} graphs captured in {g['capture_s']:.3f}s, "
            f"{g['replays']} steps replayed, {g['warmup_steps']} warm-up "
            f"steps, pool {g['pool_bytes'] / 2 ** 20:.1f} MiB")


def check_graphs(label, path, graphs, steps):
    """The graphed run must replay captured steps (every step after each
    key's warm-up chunk); the eager run must capture none."""
    if path == "eager":
        if graphs["captures"] or graphs["replays"]:
            raise SmokeError(f"{label} (eager): {graphs} graphs/replays")
    elif not graphs["captures"] or not graphs["replays"] or \
            graphs["replays"] + graphs["warmup_steps"] != steps:
        raise SmokeError(f"{label}: {graphs} for {steps} decode steps: "
                         f"not every step past the warm-up replayed a graph")


def divergence(torch, np, loaded, prompt, ref, other):
    """None if the streams agree; else (index of the first token where
    ``other`` leaves ``ref``, the logit margin there of ``ref``'s token
    over ``other``'s, teacher-forced on prompt + ``ref``)."""
    diff = np.nonzero(np.asarray(ref) != np.asarray(other))[0]
    if not diff.size:
        return None
    i = int(diff[0])
    seq = np.concatenate([prompt, ref[:i]])[None]
    with torch.no_grad():
        logits, _, _ = loaded.model.prefill(
            loaded.params, {"tokens": torch.as_tensor(seq,
                                                      device=loaded.device)},
            return_cache=False)
    last = logits[0, -1].float()
    return i, float(last[int(ref[i])] - last[int(other[i])])


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_replay(torch, np, loaded, launches):
    """The continuous-batching plane at full width: (e) the continuous
    scheduler with chunked prefill, (f) the static baseline, (g) two
    replicas behind the router under the seeded chaos plan.  Each is driven
    through the serve entry point with every count set to 0 just before it
    and read just after."""
    from repro_torch.launch import serve
    cfg = loaded.cfg
    out = {}
    for label, flags in REPLAY_RUNS.items():
        args = serve.parse_args(argv("ghidorah") + REPLAY_FLAGS + flags)
        reset_counts()
        t0 = time.perf_counter()
        res = serve.run(args, loaded)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        stats, results = res["stats"], res["results"]
        log(f"{label}: {' '.join(flags)}: {_replay_summary(stats)}; wall "
            f"{wall:.2f}s; kernel launches {counts}")
        for name, got in counts.items():
            launches[name] += got
        pools = [(e.sched_pool_conserved(), e.sched_drained())
                 for e in res["engines"]]
        if not all(c and d for c, d in pools):
            raise SmokeError(f"{label}: a page pool leaked (conserved, "
                             f"drained per replica: {pools})")
        others = {k: v for k, v in counts.items()
                  if k != "paged_tree_attention" and v}
        if others:
            raise SmokeError(f"{label}: launched other attention kernels "
                             f"{others}")
        if label.startswith("(g)"):
            if not stats["terminal"] or not res["drained"]:
                raise SmokeError(f"{label}: terminal={stats['terminal']} "
                                 f"drained={res['drained']}")
            if counts["paged_tree_attention"] < 1:
                raise SmokeError(f"{label}: paged_tree_attention never "
                                 f"launched")
        else:
            bad = [(r.req_id, r.state, r.n_emitted) for r in results
                   if r.state != "DONE" or r.n_emitted != MAIN["tokens"]]
            if bad:
                raise SmokeError(f"{label}: requests not DONE with their "
                                 f"full budget: {bad}")
            pieces = stats.get("extend_pieces", 0)
            want = cfg.num_layers * (stats["device_steps"] + pieces)
            log(f"{label}: {stats['device_steps']} decode steps + {pieces} "
                f"prefill pieces: paged_tree_attention launches "
                f"{counts['paged_tree_attention']} (want {want} = "
                f"{cfg.num_layers} layers x "
                f"{stats['device_steps'] + pieces})")
            if counts["paged_tree_attention"] != want:
                raise SmokeError(f"{label}: {counts['paged_tree_attention']} "
                                 f"paged_tree_attention launches, expected "
                                 f"{want}")
            C = stats.get("prefill_chunk", 0)
            want_pieces = sum(-(-(len(q.tokens) - C) // C)
                              for q in res["requests"]
                              if C and len(q.tokens) > C)
            if pieces != want_pieces or (label.startswith("(e)")
                                         and not pieces):
                raise SmokeError(f"{label}: {pieces} prefill pieces, "
                                 f"expected {want_pieces} (> 0 for (e))")
            forced_finite(torch, np, loaded, res)
        graphs = graph_summary(res["engines"])
        if not graphs["captures"] or not graphs["replays"]:
            raise SmokeError(f"{label}: no captured step replayed "
                             f"({graphs})")
        log(f"{label}: {stats['tok_s']:.1f} tok/s, "
            f"{_graphs_text(dict(graphs=graphs))}")
        out[label] = dict(res, counts=counts, wall=wall, graphs=graphs)
        if label in EAGER_REPLAYS:
            out[label]["eager"] = eager_replay(torch, np, loaded, args,
                                               label, res)
    solo_agreement(np, loaded, out)
    return out


# the replays run a second time op by op (``eager()``), their tokens held
# equal to the graphed run's
EAGER_REPLAYS = ("(e) continuous",)


def eager_replay(torch, np, loaded, args, label, res):
    """Replay ``args`` again inside ``eager()``: the same gates on its
    counts, and every request's tokens equal the graphed run's."""
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import eager
    cfg = loaded.cfg
    reset_counts()
    t0 = time.perf_counter()
    with eager():
        ref = serve.run(args, loaded)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    stats = ref["stats"]
    want = cfg.num_layers * (stats["device_steps"]
                             + stats.get("extend_pieces", 0))
    if counts["paged_tree_attention"] != want or \
            sum(counts.values()) != want:
        raise SmokeError(f"{label} (eager): launches {counts}, expected "
                         f"{want} paged_tree_attention")
    check_graphs(label, "eager", graph_summary(ref["engines"]), 0)
    prompts = {q.req_id: q.tokens for q in ref["requests"]}
    for g, e in zip(res["results"], ref["results"]):
        if g.req_id != e.req_id or g.state != e.state:
            raise SmokeError(f"{label}: graphed request {g.req_id} "
                             f"{g.state}, eager {e.req_id} {e.state}")
        bad = divergence(torch, np, loaded, prompts[e.req_id], e.tokens,
                         g.tokens)
        if bad is not None or len(g.tokens) != len(e.tokens):
            raise SmokeError(f"{label}: request {g.req_id}'s graphed tokens "
                             f"differ from the eager ones (first at, eager "
                             f"logit margin: {bad})")
    log(f"{label} (eager): {_replay_summary(stats)}; wall {wall:.2f}s; "
        f"kernel launches {counts}; every request's graphed tokens equal "
        f"its eager tokens")
    return dict(ref, counts=counts, wall=wall)


def phase_time_step(torch, loaded, card):
    """``DecodeEngine.time_step`` (ARCA's time source: best of 5 chunks of
    8 steps on a dummy prompt of the main path's length, per step) for
    dense ghidorah (W=8) and sequential at B=4, through the deployed
    chunk (the replay) and inside ``eager()``."""
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import eager
    out = {}
    for mode in ("ghidorah", "sequential"):
        eng = serve.build_engine(serve.parse_args(argv(mode)), loaded)
        kw = dict(batch=MAIN["batch"], prompt_len=MAIN["prompt_len"],
                  reps=5)
        graphed = eng.time_step(**kw)
        with eager():
            op_by_op = eng.time_step(**kw)
        torch.cuda.synchronize()
        out[mode] = dict(graphed_ms=1e3 * graphed, eager_ms=1e3 * op_by_op,
                         graphs=eng.graph_stats)
        log(f"time_step {mode} (W={eng.strategy.width}, B={MAIN['batch']}, "
            f"prompt {MAIN['prompt_len']}; {card}): replayed step "
            f"{1e3 * graphed:.3f} ms, eager step {1e3 * op_by_op:.3f} ms")
        if not (0 < graphed < float("inf")) or \
                not eng.graph_stats["replays"]:
            raise SmokeError(f"time_step {mode}: {graphed} s, "
                             f"{eng.graph_stats}")
        del eng
    return out


# the runs profiled in phase 4 (both paths): the fixed-batch runs and (e)
PROFILED = list(SERVE_RUNS) + ["(e) continuous"]


def phase_profile(torch, loaded, card):
    """``launch/profile_serve.py`` over each profiled run, graphed and
    eager: the idle share, device time by class and activities per step
    of each path.  The profiler must see the replayed graphs' kernels (the
    same ~2,500 a step run either way; a graph seen as one activity would
    show ~1): the graphed path's device activities per decode step must
    reach half the eager path's.  Not a tighter bound: an eager run's
    trace can drop records (9% in one run on the H100)."""
    from repro_torch.launch import profile_serve as ps
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import eager
    out = {}
    for label in PROFILED:
        if label in SERVE_RUNS:
            mode, flags, _ = SERVE_RUNS[label]
            args = serve.parse_args(argv(mode) + flags)
        else:
            args = serve.parse_args(argv("ghidorah") + REPLAY_FLAGS
                                    + REPLAY_RUNS[label])
        rows = {}
        for path, ctx in (("graphed", contextlib.nullcontext),
                          ("eager", eager)):
            with ctx():
                r = ps.profile_serve(args, loaded)
            rows[path] = r
            classes = ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                r["by_class"].items(), key=lambda kv: -kv[1]))
            log(f"profile {label}, {path} ({card}): wall "
                f"{r['wall_ms']:.1f} ms, device busy {r['busy_ms']:.1f} ms, "
                f"idle share {r['idle_share']:.3f}, "
                f"{r['activities'] / max(r['steps'], 1):.0f} activities a "
                f"step over {r['steps']} steps + {r['pieces']} pieces; "
                f"graphs {r['graphs']}; device ms by class: {classes}")
        a, b = (rows[p]["activities"] / max(rows[p]["steps"], 1)
                for p in ("graphed", "eager"))
        if a < 0.5 * b:
            raise SmokeError(f"profile {label}: {a:.0f} device activities "
                             f"a step graphed against {b:.0f} eager: the "
                             f"profiler does not see the replays' kernels")
        out[label] = rows
    return out


# the replay runs of phase 4: the main path's flags plus these
REPLAY_FLAGS = ["--paged", "--arrivals", "poisson", "--rate", "4",
                "--requests", "12"]
REPLAY_RUNS = {
    "(e) continuous": ["--sched", "continuous", "--policy", "fifo",
                       "--prefill-chunk", "256"],
    "(f) static": ["--sched", "static"],
    "(g) router": ["--sched", "continuous", "--replicas", "2",
                   "--inject-faults", "3"],
}


def _replay_summary(stats):
    waits = (f", queue wait mean {stats['queue_wait_mean_s']:.3f}s p95 "
             f"{stats['queue_wait_p95_s']:.3f}s"
             if "queue_wait_mean_s" in stats else
             f", states {stats['states']}, {stats['retries']} retried, "
             f"routed {stats['routed']}")
    return (f"{stats['tok_s']:.1f} tok/s over {stats['makespan_s']:.2f}s, "
            f"latency mean {stats['latency_mean_s']:.3f}s p95 "
            f"{stats['latency_p95_s']:.3f}s{waits}")


def forced_finite(torch, np, loaded, res):
    """Teacher-forced logits over each request's prompt + stream, four
    requests at a time, must be finite."""
    reqs = {r.req_id: r for r in res["requests"]}
    results = res["results"]
    for i in range(0, len(results), 4):
        group = results[i:i + 4]
        seq = np.stack([np.concatenate([reqs[r.req_id].tokens,
                                        r.tokens[:-1]]) for r in group])
        with torch.no_grad():
            logits, _, _ = loaded.model.prefill(
                loaded.params,
                {"tokens": torch.as_tensor(seq, device=loaded.device)},
                return_cache=False)
        if not bool(torch.isfinite(logits).all()):
            raise SmokeError("non-finite teacher-forced logits on a replay "
                             "stream")
        del logits


def solo_agreement(np, loaded, runs):
    """Report (not gate) the share of each request's tokens that equals
    its solo ``generate`` on an engine of the same configuration: bf16
    batch composition can flip near-ties of random weights."""
    from repro_torch.launch import serve
    eng = serve.build_engine(
        serve.parse_args(argv("ghidorah") + REPLAY_FLAGS), loaded)
    solo = {}
    for label, res in runs.items():
        shares = []
        for r in res["results"]:
            req = next(q for q in res["requests"] if q.req_id == r.req_id)
            if r.req_id not in solo:
                o, _ = eng.generate({"tokens": req.tokens[None]},
                                    req.n_tokens)
                solo[r.req_id] = np.atleast_2d(o)[0]
            n = min(len(r.tokens), len(solo[r.req_id]))
            shares.append(float((r.tokens[:n] == solo[r.req_id][:n]).mean())
                          if n else 1.0)
        res["solo_share"] = shares
        log(f"{label}: share of each request's tokens equal to its solo "
            f"generate: {[round(x, 4) for x in shares]} (mean "
            f"{float(np.mean(shares)):.4f})")


def _leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


# (reference run, run compared with it) of phase 4's report
AGREEMENT = [("sequential", "ghidorah"), ("ghidorah", "paged ghidorah"),
             ("sequential", "paged sequential"),
             ("paged ghidorah", "paged ghidorah int8"),
             ("paged ghidorah int8", "paged ghidorah int8 sparse")]


def check_outputs(torch, np, loaded, results):
    """Every stream in range; teacher-forced logits over prompt + each
    reference stream all finite; report how far each pair of runs agrees
    and the logit margin where they first differ (reported, not gated: bf16
    on the card sums in another order than the plain path)."""
    prompts = results["sequential"]["prompts"]
    P = prompts.shape[1]
    shape = results["sequential"]["out"].shape
    for label, res in results.items():
        out = res["out"]
        if out.shape != shape or (out < 0).any() or \
                (out >= loaded.cfg.vocab_size).any():
            raise SmokeError(f"bad token array from {label}: {out.shape}")
    forced = {}

    def teacher(label):
        """Logits predicting each token of ``label``'s stream from prompt +
        the stream before it (B, tokens, V)."""
        if label not in forced:
            seq = results[label]["out"]
            full = torch.as_tensor(np.concatenate([prompts, seq[:, :-1]],
                                                  axis=1),
                                   device=loaded.device)
            with torch.no_grad():
                logits, _, _ = loaded.model.prefill(
                    loaded.params, {"tokens": full}, return_cache=False)
            if not bool(torch.isfinite(logits).all()):
                raise SmokeError(f"non-finite logits on the {label} stream")
            forced[label] = logits[:, P - 1:].float()
            del logits
        return forced[label]

    seq = results["sequential"]["out"]
    tf = teacher("sequential").argmax(-1).cpu().numpy()
    log(f"logits finite; teacher-forced greedy agrees with the sequential "
        f"stream on {float((tf == seq).mean()):.4f} of tokens")
    for ref, other in AGREEMENT:
        a, b = results[ref]["out"], results[other]["out"]
        lg = teacher(ref)
        margins = []
        for row in range(a.shape[0]):
            diff = np.nonzero(a[row] != b[row])[0]
            if diff.size:
                i = int(diff[0])
                margins.append((row, i, float(lg[row, i, int(a[row, i])]
                                              - lg[row, i, int(b[row, i])])))
        agree = float((a == b).mean())
        results[other].setdefault("agree", {})[ref] = agree
        log(f"{other} vs {ref}: {agree:.4f} of tokens agree; first "
            f"disagreement (row, index, logit margin {ref} - {other}): "
            f"{margins if margins else 'none'}")


# ---------------------------------------------------------------------------
# phase 4b: ARCA and HCMP
# ---------------------------------------------------------------------------
# the widths timed under both partitions and both paged verify kernels (the
# candidates of --spec-width auto); every width of arca.WIDTHS is timed
# inline over the dense kernel
GRID_WIDTHS = (1, 2, 4, 8, 16)
# phase (c)'s fixed-batch overlap runs: label -> (extra flags, the phase-4
# run of the same flags, the kernel each forward launches once per layer)
OVERLAP_RUNS = {
    "dense": ([], "ghidorah", "verify_attention"),
    "paged int8": (["--paged", "--kv-dtype", "int8"], "paged ghidorah int8",
                   "paged_tree_attention"),
}


def _as_smoke_error(fn, *args, **kw):
    """Run ``fn``; a serve gate's exit becomes this script's failure."""
    try:
        return fn(*args, **kw)
    except SystemExit as e:
        raise SmokeError(f"serve exited: {e}") from None


def _want_counts(want):
    return {name: want.get(name, 0) for name in kernel_wrappers()}


def arca_analytic(loaded):
    """(a) ``--width 0``: ARCA's analytic choice on the paper's Jetson
    Xavier NX model (its times are the Jetson's, not this card's)."""
    from repro_torch.core import arca
    from repro_torch.core.speculative import tree as T
    from repro_torch.launch import serve
    cfg = loaded.cfg
    accs = T.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    strats = arca.choose_strategy(cfg, accs, ctx=MAIN["prompt_len"])
    best = arca.best(strats)
    log("ARCA (a) analytic, Jetson model, ctx "
        f"{MAIN['prompt_len']}: " + "; ".join(
            f"W={w} E[AL] {s.acceptance:.3f} step {1e3 * s.step_time:.2f} "
            f"ms {s.throughput:.2f} tok/s" for w, s in strats.items())
        + f"; --width 0 picks width={best.width}")
    spec = serve.fixed_spec(serve.parse_args(
        argv("ghidorah")[:4] + ["--width", "0"] + argv("ghidorah")[6:]),
        cfg)
    if spec.width != best.width:
        raise SmokeError(f"--width 0 built width {spec.width}, ARCA chose "
                         f"{best.width}")
    return dict(width=best.width, table={
        w: dict(al=s.acceptance, step_ms=1e3 * s.step_time)
        for w, s in strats.items()})


def arca_measured(torch, np, loaded, card):
    """(b) ``profile_engine`` on the paged int8 engine at the main path's
    batch and prompt: every width of ``arca.WIDTHS`` inline over the dense
    kernel, then GRID_WIDTHS under both partitions and both kernels (the
    grid re-times inline/dense there: two readings of the same arm).
    Each ``time_step`` is counted: the dense arm must launch B2, the
    sparse arm B3 and B4, once per layer a step, and nothing else."""
    from repro_torch.core import arca
    from repro_torch.core.speculative import tree as T
    from repro_torch.launch import serve
    cfg = loaded.cfg
    L, B, P = cfg.num_layers, MAIN["batch"], MAIN["prompt_len"]
    accs = T.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    depth = max(T.candidate_spec(accs, w).max_depth for w in arca.WIDTHS)
    args = serve.parse_args(argv("ghidorah") + [
        "--paged", "--kv-dtype", "int8", "--tree-kernel", "sparse",
        "--hcmp", "overlap"])
    eng = serve.build_engine(args, loaded,
                             max_len=P + MAIN["tokens"] + depth)
    reps, K = 3, eng.chunk
    arms = {}
    real = eng.time_step

    def counted(strategy, **kw):
        reset_counts()
        t = real(strategy, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        arm = (strategy.width, kw["hcmp"], kw["tree_kernel"])
        kernels = ("paged_tree_attention",) if arm[2] == "dense" else (
            "paged_cache_attention", "sparse_tree_attention_partial")
        want = _want_counts({k: L * K * (2 + reps) for k in kernels})
        if counts != want:
            raise SmokeError(f"ARCA arm {arm}: launches {counts}, expected "
                             f"{want}")
        if not (0 < t < float("inf")):
            raise SmokeError(f"ARCA arm {arm}: time {t}")
        arms.setdefault(arm, []).append(1e3 * t)
        return t

    eng.time_step = counted
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tf_all = arca.profile_engine(eng, arca.WIDTHS, accs=accs, batch=B,
                                 prompt_len=P, reps=reps,
                                 hcmp_modes=("inline",),
                                 tree_kernels=("dense",))
    tf_grid = arca.profile_engine(eng, GRID_WIDTHS, accs=accs, batch=B,
                                  prompt_len=P, reps=reps,
                                  hcmp_modes=("inline", "overlap"),
                                  tree_kernels=("dense", "sparse"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    peak = torch.cuda.max_memory_allocated()
    if eng.graph_stats["graphs"]:
        raise SmokeError(f"profiling kept {eng.graph_stats['graphs']} "
                         f"graphs: time_step must release them")
    want = {(w, "inline", "dense") for w in arca.WIDTHS} | {
        (w, m, k) for w in GRID_WIDTHS for m in ("inline", "overlap")
        for k in ("dense", "sparse")}
    if set(arms) != want:
        raise SmokeError(f"ARCA arms timed {sorted(arms)}, expected "
                         f"{sorted(want)}")
    for w in GRID_WIDTHS:
        spec = T.candidate_spec(accs, w)
        key = (spec.width, spec.max_depth, spec.n_paths, B)
        missing = [k for k in [key + (m,) for m in ("inline", "overlap")]
                   + [key + (m, k) for m in ("inline", "overlap")
                      for k in ("dense", "sparse")] if k not in tf_grid.times]
        if missing:
            raise SmokeError(f"profile_engine lacks the keys {missing}")

    def pick(spec):
        return tf_grid if spec.width in GRID_WIDTHS else tf_all

    def time_fn(c, w, ctx, spec):
        return pick(spec)(c, w, ctx, spec)

    time_fn.partition_for = lambda spec: pick(spec).partition_for(spec)
    time_fn.kernel_for = lambda spec: pick(spec).kernel_for(spec)
    strats = arca.choose_strategy(cfg, accs, ctx=P, time_fn=time_fn)
    best = arca.best(strats)
    log(f"ARCA (b) measured ({card}; vicuna-7b, paged int8, B={B}, prompt "
        f"{P}, best of {reps} chunks of {K} replayed steps; "
        f"{len(sum(arms.values(), []))} time_step calls in {seconds:.1f}s; "
        f"memory allocated {before[0] / 2 ** 30:.2f} GiB before profiling, "
        f"{after[0] / 2 ** 30:.2f} after, {peak / 2 ** 30:.2f} at peak; "
        f"reserved {before[1] / 2 ** 30:.2f} before, "
        f"{after[1] / 2 ** 30:.2f} after): "
        "step ms by (W, partition, kernel): " + "; ".join(
            f"{a}: " + "/".join(f"{ms:.3f}" for ms in v)
            for a, v in sorted(arms.items())))
    log("ARCA (b) choose_strategy(default_accs(5, 10)) over the measured "
        "times: " + "; ".join(
            f"W={w} E[AL] {s.acceptance:.3f} step {1e3 * s.step_time:.3f} ms "
            f"est. {B * s.throughput:.1f} tok/s (B={B}) partition {s.hcmp} "
            f"kernel {s.tree_kernel}" for w, s in strats.items())
        + f"; argmax width={best.width} ({best.hcmp}, {best.tree_kernel})")
    del eng
    torch.cuda.empty_cache()
    return dict(arms={f"{w} {m} {k}": v for (w, m, k), v in arms.items()},
                choice=dict(width=best.width, hcmp=best.hcmp,
                            tree_kernel=best.tree_kernel),
                table={w: dict(al=s.acceptance, step_ms=1e3 * s.step_time,
                               hcmp=s.hcmp, tree_kernel=s.tree_kernel)
                       for w, s in strats.items()},
                seconds=seconds, allocated_bytes=(before[0], after[0]),
                peak_bytes=peak, reserved_bytes=(before[1], after[1]))


def overlap_fixed_batch(torch, np, loaded, card, profiles, launches):
    """(c) ``--hcmp overlap`` on the fixed batch, dense and paged int8,
    graphed: the serve's gate holds its tokens to the inline twin's; the
    counts cover both runs; then ``profile_serve`` reads how much device
    time a step runs two activities at once, beside phase 4's inline
    profile of the same flags."""
    from repro_torch.launch import profile_serve as ps
    from repro_torch.launch import serve
    L = loaded.cfg.num_layers
    out = {}
    for label, (flags, inline_label, kernel) in OVERLAP_RUNS.items():
        args = serve.parse_args(argv("ghidorah") + flags + ["--hcmp",
                                                            "overlap"])
        reset_counts()
        res = _as_smoke_error(serve.run, args, loaded)
        torch.cuda.synchronize()
        counts = read_counts()
        st, ist = res["stats"], res["inline"]["stats"]
        want = _want_counts({kernel: L * (st["device_steps"]
                                          + ist["device_steps"])})
        if counts != want:
            raise SmokeError(f"overlap {label}: launches {counts}, expected "
                             f"{want}")
        for name, got in counts.items():
            launches[name] += got
        eng = res["engines"][0]
        check_graphs(f"overlap {label}", "graphed",
                     graph_summary([eng]), st["device_steps"])
        hs = eng.hcmp_stats
        if hs["executors"] != (2 if DEVICE == "cuda" else 1) or not all(
                k[0] == "overlap" for k in eng._graphs._graphs):
            raise SmokeError(f"overlap {label}: {hs}, graph keys "
                             f"{list(eng._graphs._graphs)}")
        o_ms = 1e3 * st["replay_s"] / max(st["replay_steps"], 1)
        i_ms = 1e3 * ist["replay_s"] / max(ist["replay_steps"], 1)
        prof = _as_smoke_error(ps.profile_serve, args, loaded)
        inline_prof = profiles[inline_label]["graphed"]
        log(f"HCMP (c) overlap {label} ({card}): tokens equal the inline "
            f"twin's; predraft hits {hs['predraft_hits']} / discards "
            f"{hs['predraft_discards']} over {hs['chunks']} chunks on "
            f"{hs['verify_executor']} + {hs['draft_executor']}; replayed "
            f"step {o_ms:.3f} ms overlap against {i_ms:.3f} ms inline (same "
            f"process, {st['replay_steps']} / {ist['replay_steps']} steps); "
            f"{st['emitted_total'] / res['seconds']:.1f} tok/s against "
            f"{ist['emitted_total'] / res['inline']['seconds']:.1f} (the "
            f"inline twin's first run captures too); "
            f"{_graphs_text(dict(graphs=graph_summary([eng])))}; profile: "
            f"{prof['overlap_ms'] / max(prof['steps'], 1):.4f} ms a step "
            f"with two device activities at once over {prof['streams']} "
            f"stream(s) (phase 4's inline profile "
            f"{inline_prof['overlap_ms'] / max(inline_prof['steps'], 1):.4f}"
            f" ms over {inline_prof['streams']}), busy "
            f"{prof['busy_ms']:.1f} ms over {prof['steps']} steps "
            f"(inline {inline_prof['busy_ms']:.1f} over "
            f"{inline_prof['steps']}), idle share {prof['idle_share']:.3f} "
            f"(inline {inline_prof['idle_share']:.3f})")
        out[label] = dict(
            overlap_step_ms=o_ms, inline_step_ms=i_ms,
            tok_s=st["emitted_total"] / res["seconds"],
            inline_tok_s=ist["emitted_total"] / res["inline"]["seconds"],
            predraft_hits=hs["predraft_hits"],
            predraft_discards=hs["predraft_discards"],
            overlap_ms_per_step=prof["overlap_ms"] / max(prof["steps"], 1),
            inline_overlap_ms_per_step=inline_prof["overlap_ms"]
            / max(inline_prof["steps"], 1),
            streams=prof["streams"], idle_share=prof["idle_share"])
        del res, eng
    return out


def overlap_replay(torch, np, loaded, card, launches):
    """(d) replay (e)'s traffic with ``--hcmp overlap`` (the serve's
    ``_hcmp_gate`` holds every request to the inline twin's tokens), then
    with ``--spec-width auto --hcmp auto --tree-kernel auto`` (measured
    ARCA at B=4, the adaptive scheduler re-deciding the width)."""
    from repro_torch.launch import serve
    L = loaded.cfg.num_layers
    base = argv("ghidorah") + REPLAY_FLAGS + REPLAY_RUNS["(e) continuous"]
    out = {}
    for label, flags in (("overlap", ["--hcmp", "overlap"]),
                         ("auto", ["--spec-width", "auto", "--hcmp", "auto",
                                   "--tree-kernel", "auto"])):
        args = serve.parse_args(base + flags)
        t0 = time.perf_counter()
        eng, adaptive = _as_smoke_error(serve.prepare, args, loaded)
        prep_s = time.perf_counter() - t0
        g0 = graph_summary([eng])
        reset_counts()
        res = _as_smoke_error(serve.run, args, loaded, engine=eng,
                              adaptive=adaptive)
        torch.cuda.synchronize()
        counts = read_counts()
        stats = res["stats"]
        runs = [stats] + ([res["inline"]["stats"]] if "inline" in res
                          else [])
        steps = sum(s["device_steps"] for s in runs)
        pieces = sum(s.get("extend_pieces", 0) for s in runs)
        if eng.tree_kernel == "dense":
            want = {"paged_tree_attention": L * (steps + pieces)}
        else:
            want = {"paged_tree_attention": L * pieces,
                    "paged_cache_attention": L * steps,
                    "sparse_tree_attention_partial": L * steps}
        if counts != _want_counts(want):
            raise SmokeError(f"replay {label}: launches {counts}, expected "
                             f"{_want_counts(want)}")
        for name, got in counts.items():
            launches[name] += got
        bad = [(r.req_id, r.state, r.n_emitted) for r in res["results"]
               if r.state != "DONE" or r.n_emitted != MAIN["tokens"]]
        if bad or not (eng.sched_pool_conserved() and eng.sched_drained()):
            raise SmokeError(f"replay {label}: not DONE with the full "
                             f"budget {bad}, or a pool leaked")
        hs = eng.hcmp_stats or {}
        g = {k: v - g0[k] for k, v in graph_summary([eng]).items()}
        sw = stats.get("strategy_switches", [])
        log(f"HCMP (d) replay (e) {label} ({card}; prepare "
            f"{prep_s:.1f}s): {_replay_summary(stats)}; partition "
            f"{eng.hcmp}, tree kernel {eng.tree_kernel}, width at drain "
            f"{eng.strategy.width}, {len(sw)} switch(es) "
            f"{[(x['from'], x['to']) for x in sw]}; predraft hits "
            f"{hs.get('predraft_hits', 0)} / discards "
            f"{hs.get('predraft_discards', 0)}; the replay's "
            f"{_graphs_text(dict(graphs=g))}"
            + ("; every request's tokens equal the inline twin's"
               if "inline" in res else ""))
        out[label] = dict(tok_s=stats["tok_s"],
                          latency_mean_s=stats["latency_mean_s"],
                          latency_p95_s=stats["latency_p95_s"],
                          hcmp=eng.hcmp, tree_kernel=eng.tree_kernel,
                          switches=[(x["from"], x["to"]) for x in sw],
                          width_final=eng.strategy.width, graphs=g,
                          predraft=(hs.get("predraft_hits", 0),
                                    hs.get("predraft_discards", 0)))
        del res, eng
    return out


def failed_capture_raises(torch, loaded):
    """(e) An error raised while the overlapped step is captured reaches
    the caller: the chunk never runs on the inline step instead."""
    from repro_torch.core.hcmp import executors
    from repro_torch.launch import serve
    args = serve.parse_args(argv("ghidorah") + ["--hcmp", "overlap"])
    eng = serve.build_engine(args, loaded)
    real = executors.verify_front

    def faulty(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("injected capture fault")
        return real(*a, **kw)

    executors.verify_front = faulty
    try:
        eng.generate({"tokens": serve.prompts(loaded.cfg, args)}, 16)
    except RuntimeError as e:
        if "injected capture fault" not in str(e):
            raise
    else:
        raise SmokeError("a failed overlap capture did not raise")
    finally:
        executors.verify_front = real
    if eng.graph_stats["captures"]:
        raise SmokeError(f"the failed capture counted: {eng.graph_stats}")
    log("HCMP (e) an error inside the overlap capture raised to the caller "
        "(no inline fallback)")


def phase_arca_hcmp(torch, np, loaded, card, profiles, launches):
    t0 = time.perf_counter()
    out = dict(analytic=arca_analytic(loaded),
               measured=arca_measured(torch, np, loaded, card))
    out["fixed"] = overlap_fixed_batch(torch, np, loaded, card, profiles,
                                       launches)
    out["replay"] = overlap_replay(torch, np, loaded, card, launches)
    failed_capture_raises(torch, loaded)
    torch.cuda.empty_cache()
    log(f"ARCA and HCMP phase took {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 4c: training
# ---------------------------------------------------------------------------
# (a) the card against the CPU, float32, from the same seeded params
PARITY = dict(arch="qwen2-0.5b-smoke", batch=4, seq=64, steps=3)
PARITY_RTOL = 1e-4          # loss trajectories, relative
GRAD_TOL = 2e-5             # first step's grads, x the leaf's max |g|
# (b) train_step at full width through the train launcher
TRAIN_FULL = dict(arch="qwen2-0.5b", batch=8, seq=512, steps=20, lr=1e-3,
                  seed=0)
# (c) medusa_step on the frozen main-path model (phase 4's weights), then
# the heads' checkpoint and two short serves
HEADS_FULL = dict(batch=4, seq=256, steps=10, data_seed=500, lr=1e-4)
HEADS_SERVE = dict(batch=4, tokens=16, width=8)
# (d) the end-to-end driver at its defaults; the reference's recorded
# acceptance length of trained heads (benchmarks/results/engine_bench.json
# "trained": 120 base / 80 head steps, W=4; a JAX run on a CPU)
E2E_ARGV = []
REF_TRAINED_AL = 2.71
TIMED_FROM = 2              # warm-up steps left out of a step's time


def drop_engines(torch, *results):
    """Free phase 4's and 4b's engines (and their chunk graphs): every
    ``engines`` / ``engine`` entry of the runs' results goes, so only the
    loaded weights stay."""
    import gc

    def strip(x):
        if isinstance(x, dict):
            for k in ("engines", "engine"):
                x.pop(k, None)
            for v in x.values():
                strip(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                strip(v)
    for r in results:
        strip(r)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"engines freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB "
        f"reserved")


def _no_launches(label):
    counts = read_counts()
    if any(counts.values()):
        raise SmokeError(f"{label} launched attention kernels: {counts}")


def _losses_fall(label, losses, np):
    if not all(np.isfinite(losses)):
        raise SmokeError(f"{label}: a loss is not finite: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise SmokeError(f"{label}: the loss did not fall (mean of the "
                         f"first 5 {first:.4f}, of the last 5 {last:.4f}: "
                         f"{losses})")
    return first, last


def _to(tree, device):
    from repro_torch.training.optimizer import tree_map
    return tree_map(lambda t: t.to(device), tree)


def training_parity(torch, np, steps=PARITY["steps"]):
    """(a) ``steps`` ``train_step``s and ``medusa_step``s from the same
    seeded float32 params on the card and on the CPU: the loss
    trajectories within PARITY_RTOL, the first step's grads within
    GRAD_TOL x each leaf's max |g|, and no kernel launched on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.speculative.medusa import init_medusa
    from repro_torch.data.pipeline import MarkovDataset
    from repro_torch.models.api import get_model
    from repro_torch.training import train
    from repro_torch.training.optimizer import adamw_init
    cfg = get_config(PARITY["arch"])
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    heads = init_medusa(cfg, torch.Generator().manual_seed(1))
    batches = list(MarkovDataset(cfg.vocab_size, seed=1).batches(
        PARITY["batch"], PARITY["seq"], steps))
    runs = {}
    for dev in ("cpu", DEVICE):
        p, h = _to(params, dev), _to(heads, dev)
        reset_counts()
        grads = dict(lm=train.lm_value_and_grad(cfg, model, p,
                                                batches[0])[1],
                     heads=train.medusa_value_and_grad(cfg, model, p, h,
                                                       batches[0])[1])
        lm, med = [], []
        po, ho = adamw_init(p), adamw_init(h)
        for b in batches:
            p, po, m = train.train_step(cfg, model, p, po, b)
            lm.append(float(m["loss"]))
            h, ho, m = train.medusa_step(cfg, model, p, h, ho, b)
            med.append(float(m["loss"]))
        _no_launches(f"training parity ({dev})")
        runs[dev] = dict(grads=grads, lm=lm, heads=med)
    cpu, card = runs["cpu"], runs[DEVICE]
    loss_err = max(abs(a - b) / abs(a) for key in ("lm", "heads")
                   for a, b in zip(cpu[key], card[key]))
    grad_err = 0.0
    for key in ("lm", "heads"):
        for i, (a, b) in enumerate(zip(_leaves(cpu["grads"][key]),
                                       _leaves(card["grads"][key]))):
            a, b = a.float(), b.float().cpu()
            err = float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
            grad_err = max(grad_err, err)
            if err > GRAD_TOL:
                raise SmokeError(f"training parity: {key} grad leaf {i} "
                                 f"{err:.3e} x max|g| off the CPU's")
    if loss_err > PARITY_RTOL:
        raise SmokeError(f"training parity: losses {card} against the "
                         f"CPU's {cpu} ({loss_err:.3e} relative)")
    log(f"training (a) parity, {cfg.name} float32, {steps} steps: LM "
        f"losses {card['lm']} (CPU {cpu['lm']}), head losses "
        f"{card['heads']} (CPU {cpu['heads']}); worst loss {loss_err:.3e} "
        f"relative, worst first-step grad {grad_err:.3e} x max|g|; no "
        f"kernel launched")
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
                lm=card["lm"], heads=card["heads"])


def train_full(torch, np):
    """(b) ``train_step`` at full width through the train launcher: loss
    finite and falling, ms a step (synchronized, past TIMED_FROM warm-up
    steps), tokens/s, peak memory, no kernel launched."""
    from repro_torch.launch import train as launcher
    c = TRAIN_FULL
    args = launcher.parse_args(
        ["--arch", c["arch"], "--steps", str(c["steps"]), "--batch",
         str(c["batch"]), "--seq", str(c["seq"]), "--lr", str(c["lr"]),
         "--seed", str(c["seed"]), "--device", DEVICE])
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    res = launcher.run(args)
    wall = time.perf_counter() - t0
    _no_launches("train_step")
    first, last = _losses_fall("train_step", res["losses"], np)
    n_params = sum(t.numel() for t in _leaves(res["params"]))
    tokens = c["batch"] * c["seq"]
    step_ms = 1e3 * res["step_s"]
    peak = torch.cuda.max_memory_allocated()
    flop = 6 * n_params * tokens
    out = dict(arch=c["arch"], dtype=res["cfg"].dtype, n_params=n_params,
               batch=c["batch"], seq=c["seq"], steps=c["steps"], lr=c["lr"],
               losses=res["losses"], first5=first, last5=last,
               step_ms=step_ms, tok_s=tokens / res["step_s"],
               tflop_s=flop / res["step_s"] / 1e12,
               peak_gib=peak / 2 ** 30, before_gib=before / 2 ** 30,
               seconds=wall)
    log(f"training (b) train_step, {c['arch']} ({n_params / 1e6:.1f}M "
        f"params, {res['cfg'].dtype}), batch {c['batch']} x seq {c['seq']}, "
        f"{c['steps']} steps at lr {c['lr']}: loss {res['losses'][0]:.4f} "
        f"-> {res['losses'][-1]:.4f} (mean of first 5 {first:.4f}, last 5 "
        f"{last:.4f}); {step_ms:.2f} ms a step, {out['tok_s']:.0f} tokens/s, "
        f"{out['tflop_s']:.1f} TFLOP/s at 6ND; peak allocated "
        f"{out['peak_gib']:.2f} GiB ({out['before_gib']:.2f} before); no "
        f"kernel launched; {wall:.1f}s")
    from repro_torch.data.pipeline import MarkovDataset
    from repro_torch.models.api import get_model
    from repro_torch.training.train import train_step
    cfg = res["cfg"]
    batch = next(MarkovDataset(cfg.vocab_size, seed=1).batches(
        c["batch"], c["seq"], 1, seed=c["steps"]))
    out["profile"] = profile_step(torch, "(b)", lambda: train_step(
        cfg, get_model(cfg), res["params"], res["opt"], batch, lr=c["lr"]))
    del res
    torch.cuda.empty_cache()
    return out


def profile_step(torch, label, fn):
    """One training step ``fn()`` under torch.profiler: device busy time,
    idle share and device time by kernel class and by kernel (logged)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_serve import device_summary
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    r = _as_smoke_error(device_summary, prof, wall_us)
    busy = max(r["busy_ms"], 1e-9)
    top = sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:8]
    log(f"training {label} profiled step: wall {r['wall_ms']:.2f} ms, "
        f"device busy {r['busy_ms']:.2f} ms, idle share "
        f"{r['idle_share']:.3f}, {r['activities']} device activities; by "
        f"class: " + ", ".join(
            f"{k} {v:.2f} ms ({v / busy:.3f})" for k, v in sorted(
                r["by_class"].items(), key=lambda kv: -kv[1]))
        + "; top kernels: " + "; ".join(
            f"{ms:.2f} ms x{r['count'][n]} {n[:70]}" for n, ms in top))
    return dict(wall_ms=r["wall_ms"], busy_ms=r["busy_ms"],
                idle_share=r["idle_share"], activities=r["activities"],
                by_class=r["by_class"])


def _serve_heads(torch, serve, args, loaded, layers, label, launches):
    """One short fixed-batch serve (``loaded`` None: the serve loads its
    own weights): every forward through B1 once a layer, counted from 0
    just before it."""
    reset_counts()
    res = _as_smoke_error(serve.run, args, loaded)
    torch.cuda.synchronize()
    counts = read_counts()
    want = _want_counts(
        {"verify_attention": layers * res["stats"]["device_steps"]})
    if counts != want:
        raise SmokeError(f"{label}: launches {counts}, expected {want}")
    launches["verify_attention"] += counts["verify_attention"]
    res.pop("engines")
    return res


def heads_full(torch, np, loaded, launches):
    """(c) ``medusa_step`` at full width on the frozen main-path model,
    then the heads' checkpoint (saved, restored into fresh random heads,
    bit-equal) and two short serves, ``--heads-ckpt`` against the heads in
    memory: equal tokens, B1 once a layer a forward."""
    import os
    import tempfile
    from repro_torch.core.speculative.medusa import init_medusa
    from repro_torch.data.pipeline import MarkovDataset
    from repro_torch.launch import serve
    from repro_torch.training import checkpoint, train
    from repro_torch.training.optimizer import adamw_init
    c = HEADS_FULL
    cfg, model = loaded.cfg, loaded.model
    heads = loaded.heads
    opt = adamw_init(heads)
    batches = list(MarkovDataset(cfg.vocab_size, seed=1).batches(
        c["batch"], c["seq"], c["steps"], seed=c["data_seed"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    losses = []
    for i, b in enumerate(batches):
        if i == TIMED_FROM:
            torch.cuda.synchronize()
            tw = time.perf_counter()
        heads, opt, m = train.medusa_step(cfg, model, loaded.params, heads,
                                          opt, b, lr=c["lr"])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - tw) / (c["steps"] - TIMED_FROM)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _no_launches("medusa_step")
    losses = [float(x) for x in losses]
    first, last = _losses_fall("medusa_step", losses, np)
    tokens = c["batch"] * c["seq"]
    out = dict(batch=c["batch"], seq=c["seq"], steps=c["steps"], lr=c["lr"],
               losses=losses, first5=first, last5=last,
               step_ms=1e3 * step_s, tok_s=tokens / step_s,
               peak_gib=peak / 2 ** 30, before_gib=before / 2 ** 30,
               seconds=wall)
    n_heads = sum(t.numel() for t in _leaves(heads))
    log(f"training (c) medusa_step, {cfg.name} frozen, {cfg.medusa_heads} "
        f"heads ({n_heads / 1e9:.2f}B params, {cfg.dtype}), batch "
        f"{c['batch']} x seq {c['seq']}, {c['steps']} steps at lr "
        f"{c['lr']}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of first 5 {first:.4f}, "
        f"last 5 {last:.4f}); {out['step_ms']:.2f} ms a step, "
        f"{out['tok_s']:.0f} tokens/s; peak allocated {out['peak_gib']:.2f} "
        f"GiB ({out['before_gib']:.2f} before); no kernel launched; "
        f"{wall:.1f}s")
    out["profile"] = profile_step(torch, "(c)", lambda: train.medusa_step(
        cfg, model, loaded.params, heads, opt, batches[-1], lr=c["lr"]))
    del opt
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "heads.npz")
        checkpoint.save(path, heads)
        size = os.path.getsize(path)
        save_s = time.perf_counter() - t0
        fresh = init_medusa(cfg, torch.Generator(
            device=loaded.device).manual_seed(12345))
        t1 = time.perf_counter()
        restored = checkpoint.restore(path, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        for i, (a, b) in enumerate(zip(_leaves(restored), _leaves(heads))):
            if a.dtype != b.dtype or not torch.equal(
                    a.view(torch.int16), b.view(torch.int16)):
                raise SmokeError(f"heads checkpoint: leaf {i} is not "
                                 f"bit-equal after the round trip")
        del fresh, restored
        flags = argv("ghidorah", batch=HEADS_SERVE["batch"],
                     tokens=HEADS_SERVE["tokens"],
                     width=HEADS_SERVE["width"])
        t1 = time.perf_counter()
        from_file = _serve_heads(
            torch, serve, serve.parse_args(flags + ["--heads-ckpt", path]),
            None, cfg.num_layers, "serve --heads-ckpt", launches)
        file_s = time.perf_counter() - t1
    if os.path.exists(path):
        raise SmokeError(f"{path} outlived its temporary directory")
    torch.cuda.empty_cache()
    mem = serve.Loaded(cfg=cfg, model=model, params=loaded.params,
                       heads=heads, device=loaded.device)
    in_mem = _serve_heads(torch, serve, serve.parse_args(flags), mem,
                          cfg.num_layers, "serve, heads in memory", launches)
    if not np.array_equal(from_file["out"], in_mem["out"]):
        raise SmokeError("serve --heads-ckpt emitted other tokens than the "
                         "same heads held in memory")
    out.update(ckpt_bytes=size, save_s=save_s, restore_s=restore_s,
               serve_file_s=file_s,
               serve_al=in_mem["stats"]["acceptance_length"],
               serve_tok_s=in_mem["stats"]["emitted_total"]
               / in_mem["seconds"])
    log(f"training (c) heads checkpoint: {size / 2 ** 30:.2f} GiB saved in "
        f"{save_s:.1f}s, restored into fresh random heads in "
        f"{restore_s:.1f}s, every leaf bit-equal; serve --heads-ckpt "
        f"(B={HEADS_SERVE['batch']}, W={HEADS_SERVE['width']}, "
        f"{HEADS_SERVE['tokens']} tokens; the load included, "
        f"{file_s:.1f}s) emitted the in-memory heads' tokens, acceptance "
        f"length {out['serve_al']:.3f}; file deleted")
    return out


def e2e_driver(torch, np, launches):
    """(d) The end-to-end driver at its defaults: lossless, acceptance
    above 1.0 (the heads learned), B1 the only kernel launched (by its
    serving half)."""
    from repro_torch.launch import e2e_train_serve as e2e
    reset_counts()
    t0 = time.perf_counter()
    try:
        res = e2e.run(e2e.parse_args(E2E_ARGV + ["--device", DEVICE]))
    except AssertionError as e:
        raise SmokeError(f"e2e driver: {e}") from None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if not counts["verify_attention"] or \
            any(v for k, v in counts.items() if k != "verify_attention"):
        raise SmokeError(f"e2e driver: launches {counts} (its serving half "
                         f"runs B1 only)")
    launches["verify_attention"] += counts["verify_attention"]
    al = res["acceptance_length"]
    if not al > 1.0:
        raise SmokeError(f"e2e driver: acceptance length {al:.3f}: the "
                         f"heads learned nothing")
    table = {w: (round(v["al"], 3), round(v["tok_s"], 1))
             for w, v in res["widths"].items()}
    log(f"training (d) e2e driver: lossless; acceptance length {al:.3f} "
        f"(the reference's record {REF_TRAINED_AL}: 120/80 steps, W=4, a "
        f"JAX run on a CPU; acceptance is not a speed); top-1 accuracy per "
        f"head {np.round(res['accs'][:, 0], 3).tolist()}; ARCA chose "
        f"width {res['width']} (W: measured AL, tok/s {table}); wall "
        f"speedup {res['speedup']:.2f}x ({res['seq_s']:.3f}s sequential, "
        f"{res['spec_s']:.3f}s ghidorah); {counts['verify_attention']} B1 "
        f"launches; {wall:.1f}s")
    return dict(acceptance_length=al, width=res["width"],
                speedup=res["speedup"], accs_top1=res["accs"][:, 0].tolist(),
                widths=res["widths"], seconds=wall)


def phase_training(torch, np, loaded, launches):
    """Phase 4c's parts on phase 4's weights: (a) and (c)."""
    t0 = time.perf_counter()
    out = dict(parity=training_parity(torch, np))
    log(f"training (a) took {time.perf_counter() - t0:.1f}s")
    out["heads"] = heads_full(torch, np, loaded, launches)
    log(f"training (a), (c) took {time.perf_counter() - t0:.1f}s")
    return out


def phase_training_full(torch, np, launches):
    """Phase 4c's parts on a card without phase 4's weights: (b), (d)."""
    t0 = time.perf_counter()
    out = dict(train=train_full(torch, np))
    out["e2e"] = e2e_driver(torch, np, launches)
    log(f"training (b), (d) took {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 4d: the MoE, VLM and hybrid families at full width
# ---------------------------------------------------------------------------
# one model at a time, random bf16 weights from seed 0 drawn on the card
# through the port's init_params; B=4, W=8 (4 Medusa heads x top-10: 4
# paths, depth 4), prompts of 511 tokens, 32 new tokens a row, chunk 8
FAMILY = dict(width=8, batch=4, prompt_len=512, tokens=32, chunk=8, seed=0,
              page_size=16)
# (b)'s text tokens a row, after its 2880 patch embeds: 3391 positions
VLM_TEXT = 511
FAMILY_ARCHS = {"(a) moe": "qwen3-moe-30b-a3b",
                "(b) vlm": "llava-next-mistral-7b",
                "(c) hybrid": "zamba2-7b",
                "(d) xlstm": "xlstm-125m",
                "(e) encdec": "seamless-m4t-medium"}
# fixed-batch runs of each family: label -> (serve flags, the kernels each
# forward launches once per attention layer or site)
FAMILY_RUNS = {
    "(a) moe": {"dense": ([], ("verify_attention",)),
                "paged int8 sparse": (
                    ["--paged", "--kv-dtype", "int8", "--tree-kernel",
                     "sparse"],
                    ("paged_cache_attention",
                     "sparse_tree_attention_partial"))},
    "(b) vlm": {"dense": ([], ("verify_attention",)),
                "paged bf16": (["--paged", "--kv-dtype", "bf16"],
                               ("paged_tree_attention",))},
    "(c) hybrid": {"dense": ([], ("verify_attention",)),
                   "paged": (["--paged"], ("paged_tree_attention",))},
    # no attention: no kernel, and the paged pool holds nothing
    "(d) xlstm": {"dense": ([], ()), "paged": (["--paged"], ())},
    "(e) encdec": {"dense": ([], ("verify_attention",)),
                   "paged bf16": (["--paged", "--kv-dtype", "bf16"],
                                  ("paged_tree_attention",)),
                   "paged int8": (["--paged", "--kv-dtype", "int8"],
                                  ("paged_tree_attention",))},
}
# the embeddings a family's ``generate`` batch carries beside its tokens:
# label -> (batch key, the config's count of them, text tokens a row (None:
# the serve's prompt), generator seed offset)
FAMILY_EMBEDS = {"(b) vlm": ("patch_embeds", "num_frontend_tokens",
                             VLM_TEXT, 2),
                 "(e) encdec": ("frame_embeds", "encoder_seq_len", None, 3)}
# the replays of (c) and (d): 8 Poisson arrivals at 4/s, the continuous
# scheduler on the paged pool, a bank of 4 (whole-prompt admission:
# sched_chunked_ok is False for a recurrent family)
FAMILY_REPLAY = ["--paged", "--arrivals", "poisson", "--rate", "4",
                 "--requests", "8", "--sched", "continuous"]


def family_argv(arch, extra=()):
    f = FAMILY
    return ["--arch", arch, "--mode", "ghidorah", "--width",
            str(f["width"]), "--batch", str(f["batch"]), "--prompt-len",
            str(f["prompt_len"]), "--tokens", str(f["tokens"]), "--chunk",
            str(f["chunk"]), "--seed", str(f["seed"]), "--device", DEVICE,
            "--page-size", str(f["page_size"]), "--pool-pages", "0",
            *extra]


def attention_layers(cfg):
    """Attention layers (or shared-attention sites) a forward runs through
    a verify kernel: none in xLSTM, the decoder's in enc-dec."""
    if cfg.arch_type == "hybrid":
        from repro_torch.models.hybrid import n_sites
        return n_sites(cfg)
    if cfg.arch_type == "ssm":
        return 0
    return cfg.num_layers


def gate_counts(label, counts, kernels, want):
    """Each kernel of the run launched ``want`` times, every other 0."""
    for name, got in counts.items():
        if got != (want if name in kernels else 0) or \
                (name in kernels and not got):
            raise SmokeError(f"{label}: {got} {name} launches, expected "
                             f"{want if name in kernels else 0} "
                             f"(counts {counts})")


def family_bytes(cfg, loaded, B, W, n_paths, depth):
    """What a verify step must move besides the cache: the weights it
    reads (all of them, the one-hot dispatch reading every expert), the
    MoE experts' share of them and, with uniform routing, the experts
    that B*W verify tokens (and B decode tokens) pick in expectation; the
    hybrid's per-depth recurrent states (L x D x B*P x nh x hd x N x 4 B
    written a step) and xLSTM's (each mLSTM layer's C, n and m, each
    sLSTM layer's c, n, h and m, float32, D x B*P of them); the enc-dec
    cross memory read a step (K and V of every decoder layer over the
    encoder's frames)."""
    weights = sum(t.numel() * t.element_size() for t in _leaves(loaded.params))
    out = dict(weight_bytes=weights)
    if cfg.num_experts:
        E, K = cfg.num_experts, cfg.experts_per_token
        moe = loaded.params["layers"]["moe"]
        experts = sum(moe[k].numel() * moe[k].element_size()
                      for k in ("w_gate", "w_up", "w_down"))
        per = experts / E
        picked = {n: E * (1 - (1 - K / E) ** n) for n in (B * W, B)}
        out.update(expert_bytes=experts,
                   verify_expected_experts=picked[B * W],
                   verify_expected_bytes=per * picked[B * W],
                   decode_expected_experts=picked[B],
                   decode_expected_bytes=per * picked[B],
                   expert_read_ms=1e3 * experts / HBM_BYTES_PER_S)
    if cfg.arch_type == "hybrid":
        from repro_torch.models import mamba2
        di, nh, hd, N = mamba2.dims(cfg)
        out["depth_state_bytes"] = (cfg.num_layers * depth * B * n_paths
                                    * nh * hd * N * 4)
    if cfg.arch_type == "ssm":
        from repro_torch.configs.base import MLSTM
        from repro_torch.models.xlstm import mlstm_dims
        _, nh, hd = mlstm_dims(cfg)
        row = sum(nh * hd * hd + nh * hd + nh if kind == MLSTM
                  else 4 * cfg.d_model for kind in cfg.blocks())
        out["depth_state_bytes"] = depth * B * n_paths * row * 4
    if cfg.is_encoder_decoder:
        ck = loaded.params["embed"].element_size()
        out["cross_memory_bytes"] = (2 * cfg.num_layers * B
                                     * cfg.encoder_seq_len
                                     * cfg.num_kv_heads * cfg.head_dim * ck)
    return out


def family_finite(torch, np, loaded, prompts, out, extra=None):
    """Teacher-forced logits over prompt + each row's stream (one row at a
    time, with the row's entries of ``extra``: the VLM's patch embeds, the
    enc-dec frames) are finite."""
    for row in range(out.shape[0]):
        seq = np.concatenate([prompts[row], out[row][:-1]])[None]
        batch = {"tokens": torch.as_tensor(seq, device=loaded.device)}
        for k, v in (extra or {}).items():
            batch[k] = v[row:row + 1]
        with torch.no_grad():
            logits, _, _ = loaded.model.prefill(loaded.params, batch,
                                                return_cache=False)
        if not bool(torch.isfinite(logits).all()):
            raise SmokeError(f"{loaded.cfg.name}: non-finite teacher-forced "
                             f"logits on row {row}")
        del logits


def family_run(torch, np, label, loaded, run, kernels, go):
    """One fixed-batch run of a family, graphed then inside ``eager()``:
    ``go()`` returns ``(out, stats, seconds, engine)``.  Gates: full
    budgets, each forward through its kernel once per attention layer or
    site (the graphed run counted through the replays' tallies), the
    graphed run replaying its captured steps, graphed tokens equal to the
    eager ones.  Returns the graphed run's figures."""
    from repro_torch.runtime.engine import eager
    cfg = loaded.cfg
    layers = attention_layers(cfg)
    runs = {}
    for path in ("graphed", "eager"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with (eager() if path == "eager" else contextlib.nullcontext()):
            out, stats, seconds, eng = go()
        torch.cuda.synchronize()
        counts = read_counts()
        steps = stats["device_steps"]
        total = stats["emitted_total"]
        if total != FAMILY["batch"] * FAMILY["tokens"]:
            raise SmokeError(f"{label} {run} ({path}): {total} tokens, "
                             f"expected {FAMILY['batch'] * FAMILY['tokens']}")
        gate_counts(f"{label} {run} ({path})", counts, kernels,
                    layers * steps)
        graphs = graph_summary([eng])
        check_graphs(f"{label} {run}", path, graphs, steps)
        runs[path] = dict(
            out=np.asarray(out), steps=steps, seconds=seconds,
            tok_s=total / seconds, counts=counts, graphs=graphs,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            step_ms=1e3 * sum(stats["step_times"]) / max(steps, 1),
            replay_step_ms=1e3 * stats["replay_s"]
            / max(stats["replay_steps"], 1),
            replay_steps=stats["replay_steps"],
            acceptance=stats["acceptance_length"],
            prefill_s=seconds - sum(stats["step_times"]))
        del eng
    g, e = runs["graphed"], runs["eager"]
    if not np.array_equal(g["out"], e["out"]):
        rows = [r for r in range(g["out"].shape[0])
                if not np.array_equal(g["out"][r], e["out"][r])]
        raise SmokeError(f"{label} {run}: graphed tokens differ from the "
                         f"eager ones on rows {rows}")
    log(f"{label} {cfg.name} {run}: graphed {g['tok_s']:.1f} tok/s, "
        f"replayed step {g['replay_step_ms']:.3f} ms over "
        f"{g['replay_steps']} steps (mean step {g['step_ms']:.2f} ms), "
        f"prefill + prologue {g['prefill_s']:.2f}s, peak allocated "
        f"{g['peak_gib']:.2f} GiB, acceptance {g['acceptance']:.3f}, "
        f"launches {g['counts']} ({layers} x {g['steps']} steps), "
        f"{_graphs_text(g)}; eager {e['tok_s']:.1f} tok/s, step "
        f"{e['step_ms']:.2f} ms, peak {e['peak_gib']:.2f} GiB; graphed "
        f"tokens equal eager tokens")
    return dict(g, eager={k: e[k] for k in ("tok_s", "step_ms", "peak_gib",
                                            "seconds", "prefill_s")})


def family_load(torch, label):
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    arch = FAMILY_ARCHS[label]
    loaded = serve.load(serve.parse_args(family_argv(arch)), with_heads=True)
    torch.cuda.synchronize()
    cfg = loaded.cfg
    n = sum(t.numel() for t in _leaves(loaded.params))
    h = sum(t.numel() for t in _leaves(loaded.heads))
    log(f"{label} {cfg.name} ({cfg.source}): {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} query heads over "
        f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, "
        f"{n / 1e9:.2f}B params + {h / 1e9:.2f}B Medusa-head params "
        f"({cfg.medusa_heads} heads x top-{cfg.medusa_top_k}) in "
        f"{cfg.dtype}, random from seed {FAMILY['seed']} on the card "
        f"({time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated)")
    return loaded


def family_serve(torch, np, label, loaded, launches):
    """(a) and (c)'s fixed-batch runs through the serve entry point."""
    from repro_torch.launch import serve
    out = {}
    for run, (flags, kernels) in FAMILY_RUNS[label].items():
        args = serve.parse_args(family_argv(FAMILY_ARCHS[label], flags))

        def go():
            res = serve.run(args, loaded)
            return (res["out"], res["stats"], res["seconds"],
                    res["engines"][0])

        out[run] = r = family_run(torch, np, label, loaded, run, kernels, go)
        prompts = serve.prompts(loaded.cfg, args)
        family_finite(torch, np, loaded, prompts, r["out"])
        for name, n in r["counts"].items():
            launches[name] += n
        drop_engines(torch)
    return out


def embeds_serve(torch, np, label, loaded, launches):
    """(b) and (e): ``DecodeEngine.generate`` with the tokens and the
    family's embeddings (``FAMILY_EMBEDS``), seeded random bf16: (b)'s
    2880 patch embeds before ``VLM_TEXT`` text tokens a row (the serve's
    prompts, cut), on the dense cache and the paged bf16 pool; (e)'s 4096
    frame embeds beside the serve's 511-token prompts, dense, paged bf16
    and paged int8.  A paged row reserves pages for its decoder positions
    (the VLM's whole prefix; the prompt alone beside frames, which are
    not decoder positions) + budget + one accepted chain.  Returns the
    runs and the batch."""
    from repro_torch.launch import serve
    from repro_torch.runtime.cache import pages_for
    from repro_torch.runtime.engine import _prompt_len
    cfg = loaded.cfg
    key, count, text, seed = FAMILY_EMBEDS[label]
    args0 = serve.parse_args(family_argv(FAMILY_ARCHS[label]))
    prompts = serve.prompts(cfg, args0)[:, :text]
    gen = torch.Generator(device=loaded.device).manual_seed(FAMILY["seed"]
                                                             + seed)
    embeds = torch.randn((FAMILY["batch"], getattr(cfg, count),
                          cfg.d_model), generator=gen,
                         device=loaded.device).to(torch.bfloat16)
    batch = {"tokens": torch.as_tensor(prompts, device=loaded.device),
             key: embeds}
    plen = _prompt_len(batch)
    if key == "frame_embeds" and plen != prompts.shape[1]:
        raise SmokeError(f"{label}: the frames counted as decoder "
                         f"positions ({plen} for {prompts.shape[1]} tokens)")
    spec = serve.fixed_spec(args0, cfg)
    out = {}
    for run, (flags, kernels) in FAMILY_RUNS[label].items():
        args = serve.parse_args(family_argv(FAMILY_ARCHS[label], flags))
        reserved = []

        def go():
            eng = serve.build_engine(
                args, loaded, spec,
                max_len=plen + FAMILY["tokens"] + spec.max_depth)
            if eng.paged:
                orig = eng._reserve_tables

                def spy(B, prompt_len, budget):
                    tables, n_total = orig(B, prompt_len, budget)
                    reserved.append(((tables >= 0).sum(dim=1).tolist(),
                                     prompt_len))
                    return tables, n_total
                eng._reserve_tables = spy
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, stats = eng.generate(batch, FAMILY["tokens"])
            return o, stats, time.perf_counter() - t0, eng

        out[run] = r = family_run(torch, np, label, loaded, run, kernels, go)
        if reserved:
            want = pages_for(plen + FAMILY["tokens"] + spec.max_depth,
                             FAMILY["page_size"])
            for pages, p in reserved:
                if p != plen or pages != [want] * FAMILY["batch"]:
                    raise SmokeError(f"{label} {run}: reserved {pages} "
                                     f"pages for a prompt of {p}, expected "
                                     f"{want} a row for {plen} positions + "
                                     f"{FAMILY['tokens']} tokens + "
                                     f"{spec.max_depth}")
            r["pages_per_row"] = want
            log(f"{label} {run}: each row reserved {want} pages of "
                f"{FAMILY['page_size']} for {plen} decoder positions "
                f"+ {FAMILY['tokens']} tokens + {spec.max_depth}")
        family_finite(torch, np, loaded, prompts, r["out"],
                      extra={key: embeds})
        for name, n in r["counts"].items():
            launches[name] += n
        drop_engines(torch)
    return out, batch


def recurrent_replay(torch, np, label, loaded, launches):
    """(c)'s and (d)'s replay through the serve entry point: every request
    DONE with its full budget, every forward through B2 once a site (none
    in xLSTM), pools drained."""
    from repro_torch.launch import serve
    args = serve.parse_args(family_argv(FAMILY_ARCHS[label], FAMILY_REPLAY))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.run(args, loaded)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    stats = res["stats"]
    bad = [(r.req_id, r.state, r.n_emitted) for r in res["results"]
           if r.state != "DONE" or r.n_emitted != FAMILY["tokens"]]
    if bad:
        raise SmokeError(f"{label} replay: requests not DONE with their "
                         f"full budget: {bad}")
    if stats.get("extend_pieces", 0):
        raise SmokeError(f"{label} replay: chunked prefill ran on a "
                         f"recurrent family")
    eng = res["engines"][0]
    if not (eng.sched_pool_conserved() and eng.sched_drained()):
        raise SmokeError(f"{label} replay: the page pool leaked")
    layers = attention_layers(loaded.cfg)
    gate_counts(f"{label} replay", counts,
                ("paged_tree_attention",) if layers else (),
                layers * stats["device_steps"])
    graphs = graph_summary(res["engines"])
    if not graphs["captures"] or not graphs["replays"]:
        raise SmokeError(f"{label} replay: no captured step replayed "
                         f"({graphs})")
    forced_finite(torch, np, loaded, res)
    for name, n in counts.items():
        launches[name] += n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{label} replay ({' '.join(FAMILY_REPLAY)}, bank of "
        f"{FAMILY['batch']}): {_replay_summary(stats)}; wall {wall:.2f}s; "
        f"{stats['device_steps']} decode steps, launches {counts}; peak "
        f"{peak:.2f} GiB; {_graphs_text(dict(graphs=graphs))}; every "
        f"request DONE, pool drained")
    out = dict(tok_s=stats["tok_s"], latency_mean_s=stats["latency_mean_s"],
               latency_p95_s=stats["latency_p95_s"],
               steps=stats["device_steps"], wall=wall, peak_gib=peak,
               counts=counts)
    del res, eng
    drop_engines(torch)
    return out


def profile_generate(torch, eng, batch):
    """One ``generate`` of ``FAMILY["tokens"]`` on ``eng`` under
    torch.profiler (device activity only), after a warm-up one: the
    device summary and the steps."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_serve import device_summary
    eng.generate(batch, FAMILY["tokens"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = eng.generate(batch, FAMILY["tokens"])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return dict(_as_smoke_error(device_summary, prof, wall_us),
                steps=stats["device_steps"])


def family_profile(torch, label, loaded, batch):
    """The graphed dense run of (d) and (e) profiled (device activity
    only), after a warm-up run on the same engine: (d) through
    ``launch/profile_serve.py``, (e) as one ``generate`` with its frames
    (the serve has no frame flag).  Busy and idle, activities a step,
    device time by class."""
    from repro_torch.launch import profile_serve as ps
    from repro_torch.launch import serve
    args = serve.parse_args(family_argv(FAMILY_ARCHS[label]))
    if batch is None:
        r = _as_smoke_error(ps.profile_serve, args, loaded)
    else:
        eng = serve.build_engine(
            args, loaded, max_len=int(batch["tokens"].shape[1])
            + FAMILY["tokens"] + serve.fixed_spec(args, loaded.cfg).max_depth)
        r = profile_generate(torch, eng, batch)
        del eng
    busy = max(r["busy_ms"], 1e-9)
    log(f"{label} {loaded.cfg.name} profiled (graphed, dense): wall "
        f"{r['wall_ms']:.1f} ms, busy {r['busy_ms']:.1f} ms, idle share "
        f"{r['idle_share']:.3f}, {r['activities'] / max(r['steps'], 1):.0f}"
        f" activities a step over {r['steps']} steps; by class: "
        + ", ".join(f"{k} {v:.1f} ms ({v / busy:.3f})" for k, v in sorted(
            r["by_class"].items(), key=lambda kv: -kv[1])))
    drop_engines(torch)
    return {k: r[k] for k in ("wall_ms", "busy_ms", "idle_share",
                              "activities", "steps", "by_class")}


def phase_families(torch, np, launches, card):
    """Phase 4d: (a) ``qwen3-moe-30b-a3b`` served dense and paged int8
    with the sparse tree kernel, (b) ``llava-next-mistral-7b``'s
    ``generate`` with its patch prefix, dense and paged bf16, (c)
    ``zamba2-7b`` served dense and paged and replayed through the
    continuous scheduler, (d) ``xlstm-125m`` served dense and paged and
    replayed, (e) ``seamless-m4t-medium``'s ``generate`` with its frames,
    dense, paged bf16 and paged int8; (d) and (e) profiled; one model on
    the card at a time."""
    out = {}
    for label in FAMILY_ARCHS:
        t0 = time.perf_counter()
        loaded = family_load(torch, label)
        cfg = loaded.cfg
        batch = None
        if label in FAMILY_EMBEDS:
            runs, batch = embeds_serve(torch, np, label, loaded, launches)
        else:
            runs = family_serve(torch, np, label, loaded, launches)
        from repro_torch.core.speculative import tree as T
        spec = T.build_tree(T.default_accs(cfg.medusa_heads,
                                           cfg.medusa_top_k),
                            FAMILY["width"])
        sizes = family_bytes(cfg, loaded, FAMILY["batch"],
                             spec.width, spec.n_paths, spec.max_depth)
        if label in ("(c) hybrid", "(d) xlstm"):
            runs["replay"] = recurrent_replay(torch, np, label, loaded,
                                              launches)
        if label in ("(d) xlstm", "(e) encdec"):
            runs["profile"] = family_profile(torch, label, loaded, batch)
        del batch
        for r in runs.values():
            r.pop("out", None)
        text = ", ".join(f"{k} {v / 1e9:.2f} GB" if k.endswith("bytes")
                         else f"{k} {v:.2f}" for k, v in sizes.items())
        log(f"{label} {cfg.name} a step (W={spec.width}: {spec.n_paths} "
            f"paths, depth {spec.max_depth}; {card}): {text}")
        out[label] = dict(arch=cfg.name, runs=runs, sizes=sizes,
                          seconds=time.perf_counter() - t0)
        del loaded
        drop_engines(torch)
        log(f"{label} took {out[label]['seconds']:.1f}s")
    return out


def sdpa_inputs(torch, args):
    """``scaled_dot_product_attention`` operands computing the fused verify
    of a dense cache: cache and tree keys side by side, one boolean mask."""
    q, ck, cv, kn, vn, key_pos, q_pos, lo, mask = args
    B, W = q.shape[:2]
    ok = ((key_pos[:, None, :] >= 0)
          & (key_pos[:, None, :] <= q_pos[:, :, None])
          & (key_pos[:, None, :] > lo[:, :, None]))           # (B, W, S)
    m = torch.cat([ok, mask[None].expand(B, W, W)], dim=2)[:, None]
    G = q.shape[2] // ck.shape[2]              # query head h*G+g reads h
    k = torch.cat([ck, kn], dim=1).transpose(1, 2)
    v = torch.cat([cv, vn], dim=1).transpose(1, 2)
    return (q.transpose(1, 2).contiguous(),
            k.repeat_interleave(G, dim=1).contiguous(),
            v.repeat_interleave(G, dim=1).contiguous(), m)


def timed(torch, fn, sets, iters=50, warm=5):
    """Mean ms per call over ``iters`` calls cycling ``sets`` (CUDA
    events), after ``warm`` calls."""
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


def host_ms(torch, fn, sets, iters=50, warm=5):
    """Mean host time of one call (ms): the host's clock around ``iters``
    calls with no synchronize among them, after ``warm`` calls (the cost
    of enqueueing a call; the card's queue holds them all).  One window,
    the definition of every ``host_ms`` in the kernel table; the host's
    clock spreads between windows on a shared host, so two versions are
    compared in one run, in alternating windows (``alternating_ms``)."""
    return per_call_ms(torch, lambda i: fn(sets[i % len(sets)]), iters, warm)


def per_call_ms(torch, fn, n=50, warm=5):
    """Mean host time (ms) of ``fn(i)`` over ``n`` calls with no
    synchronize among them, after ``warm`` calls and a synchronize."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / n


# device-side symbols of the kernels one call launches (their time in a
# torch.profiler trace; matched as substrings, so no name holds another):
# at the timed shapes (bf16 queries) the split walks of B1 and B2 launch
# their tensor-core walk and the Eq.-1 merge, B3 at the main path's W=8
# (two splits) its tensor-core walk and the carry fold; B4 at W=8 its warp
# route; B5 one kernel of its route, by q's dtype
SYMBOLS = {"verify_attention": ("verify_flash_kernel", "merge_kernel"),
           "paged_tree_attention": ("paged_flash_kernel", "merge_kernel"),
           "paged_cache_attention": ("cache_flash_kernel",
                                     "carry_fold_kernel"),
           "sparse_tree_attention_partial": ("tree_warp_kernel",),
           "sparse_tree_attention": {
               "torch.float32": ("tree_norm_f32_kernel",),
               "torch.bfloat16": ("tree_norm_flash_kernel",)}}


PAD_KERNELS = 256


def device_ms(torch, fn, sets, symbols, iters=20, optional=()):
    """Mean device time of one call, from a torch.profiler trace of
    ``iters`` calls: for each kernel symbol in ``symbols`` (every kernel
    one call launches: a split walk and its merge), the mean time of its
    launches, summed over the symbols.  The time of the kernels alone,
    without the host's share of the call (CUDA events around a loop of
    calls measure the slower of the two).  The profiler may drop a launch
    at the edge of its window, so each mean is over the launches it
    recorded, which must be most of them for every symbol but those in
    ``optional`` (a merge or fold that a one-split plan does not launch),
    which count where the trace has them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(sets[i % len(sets)])
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # late in a long run a window's trace has lost its first ~26
            # device activities (13 of 20 two-kernel calls, every one of
            # 20 one-kernel calls), with or without 10 ms of idle device
            # time before them, and after 64 tiny kernels still its first
            # ~84 now and then: PAD_KERNELS tiny kernels, which no symbol
            # matches, take that loss first
            for _ in range(PAD_KERNELS):
                pad.add_(1)
            for i in range(iters):
                fn(sets[i % len(sets)])
            torch.cuda.synchronize()
        spans = {sym: [e.time_range.end - e.time_range.start
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA and sym in e.name]
                 for sym in symbols}
        if all(len(v) >= iters // 2 for k, v in spans.items()
               if k not in optional):
            return sum(sum(v) / len(v) for v in spans.values() if v) / 1e3
        # the trace lost most of the window's launches (seen on this card:
        # 1 of 20 recorded); a new window measures again, nothing is kept
        log(f"the profiler saw {({k: len(v) for k, v in spans.items()})} "
            f"of {iters} launches in window {attempt + 1} of 3")
    seen = {k: len(v) for k, v in spans.items()}
    raise SmokeError(f"the profiler saw {seen} launches, expected {iters} "
                     f"of each, in 3 windows")


def bound(nbytes, ops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of ``dtype``."""
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / PEAK_OPS_PER_S[str(dtype)]
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def phase_timing(torch, np, card):
    from repro_torch.kernels.plain import tree_attention_plain
    from repro_torch.kernels.verify_attention import verify_attention
    import torch.nn.functional as F

    rows = {}
    for label, kw in main_shapes(np):
        # 4 input sets (> the 50 MB L2 together) cycled, so every launch
        # reads its cache from device memory as the serving step does
        sets = [attention_inputs(torch, np, seed=100 + r, **kw)
                for r in range(4)]
        lib_sets = [sdpa_inputs(torch, a) for a in sets]
        ref = tree_attention_plain(*sets[0])
        lib = F.scaled_dot_product_attention(*lib_sets[0][:3],
                                             attn_mask=lib_sets[0][3])
        lib_err = float((lib.transpose(1, 2).float() - ref.float()).abs()
                        .max())
        kernel_ms = timed(torch, lambda a: verify_attention(*a), sets)
        call_host = host_ms(torch, lambda a: verify_attention(*a), sets)
        dev_ms = device_ms(torch, lambda a: verify_attention(*a), sets,
                           SYMBOLS["verify_attention"])
        plain_ms = timed(torch, lambda a: tree_attention_plain(*a), sets)
        library_ms = timed(torch, lambda a: F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3]), lib_sets)
        nbytes, slots = needed_bytes(torch, sets[0], ref)
        ops = needed_ops(sets[0])
        bound_ms, bound_by = bound(nbytes, ops, sets[0][0].dtype)
        rows[label] = dict(kernel_ms=kernel_ms, device_ms=dev_ms,
                           host_ms=call_host, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=nbytes, ops=ops)
        log(f"timing {label} ({card}): kernel_ms {kernel_ms:.4f} (device "
            f"{dev_ms:.4f}, host {call_host:.4f}) plain_ms {plain_ms:.4f} "
            f"library_ms "
            f"{library_ms:.4f} (sdpa, max abs "
            f"diff to plain {lib_err:.2e}) bound_ms {bound_ms:.4f} "
            f"({bound_by}: {nbytes / 1e6:.2f} MB over "
            f"{slots} valid cache slots, {ops / 1e9:.3f} GFLOP); "
            f"{kernel_ms / bound_ms:.1f}x the bound")
        del sets, lib_sets
    return rows


def phase_paged_timing(torch, np, card):
    """The paged kernels at the main path's shapes: the fused walk with a
    bf16 and an int8 pool at verify W=8 and decode W=1, the cache-only walk
    (int8) and the tree partial at W=8.  Each cycles 4 input sets with
    their own shuffled tables (> the 50 MB L2 together).  The library call
    of the fused walk is ``scaled_dot_product_attention`` over the view
    already gathered through the table (an int8 pool's view dequantized to
    bf16; the gather and the dequant left out of its time); the cache-only
    walk's and the tree partial's is the efficient-attention kernel with
    its log-sum-exp (``lse_library``)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain
    from repro_torch.kernels import tree_partial as tp
    from repro_torch.runtime.cache import gather_pages_dequant
    import torch.nn.functional as F

    shapes = {}
    for r in range(4):
        for label, kw in paged_main_shapes(np, seed=r):
            shapes.setdefault(label, []).append(kw)
    rows = {}

    def record(key, name, kernel_fn, plain_fn, sets, outs, cache, tree,
               library_ms=None, note=""):
        kernel_ms = timed(torch, kernel_fn, sets)
        call_host = host_ms(torch, kernel_fn, sets)
        dev_ms = device_ms(torch, kernel_fn, sets, SYMBOLS[name])
        plain_ms = timed(torch, plain_fn, sets)
        nbytes, slots = paged_bytes(sets[0], outs, cache=cache, tree=tree)
        ops = paged_ops(sets[0], slots, cache=cache, tree=tree)
        bound_ms, bound_by = bound(nbytes, ops, sets[0]["q"].dtype)
        rows[key] = dict(kernel_ms=kernel_ms, device_ms=dev_ms,
                         host_ms=call_host, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, ops=ops)
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        log(f"timing {key} ({card}): kernel_ms {kernel_ms:.4f} (device "
            f"{dev_ms:.4f}, host {call_host:.4f}) plain_ms {plain_ms:.4f} "
            f"library_ms {lib}{note} "
            f"bound_ms "
            f"{bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.2f} MB over "
            f"{slots} valid cache slots, {ops / 1e9:.3f} GFLOP); "
            f"{kernel_ms / bound_ms:.1f}x the bound")

    for pool in ("bfloat16", "int8"):
        for W, kind in ((MAIN["width"], "verify"), (1, "decode")):
            label = f"main {pool} pool {kind} W={W}"
            sets = [paged_inputs(torch, np, **dict(kw, seed=200 + r))
                    for r, kw in enumerate(shapes[label])]
            ref = plain.paged_tree_attention_plain(*paged_args(sets[0]))

            def view(a, which):
                return gather_pages_dequant(
                    a[f"pool_{which}"], a[f"scale_{which}"],
                    a["block_table"]).to(torch.bfloat16)
            lib_sets = [sdpa_inputs(torch, (
                a["q"], view(a, "k"), view(a, "v"), a["k_new"], a["v_new"],
                a["key_pos"], a["q_pos"], a["lo"], a["tree_mask"]))
                for a in sets]
            lib = F.scaled_dot_product_attention(
                *lib_sets[0][:3], attn_mask=lib_sets[0][3])
            lib_err = float((lib.transpose(1, 2).float()
                             - ref.float()).abs().max())
            library_ms = timed(
                torch, lambda a: F.scaled_dot_product_attention(
                    a[0], a[1], a[2], attn_mask=a[3]), lib_sets)
            what = "the gathered view" if pool == "bfloat16" else \
                "the gathered view dequantized to bf16"
            note = (f" (sdpa over {what}, not timed; max abs diff to plain "
                    f"{lib_err:.2e})")
            del lib_sets
            record(f"B2 {pool} pool W={W}", "paged_tree_attention",
                   lambda a: pa.paged_tree_attention(*paged_args(a)),
                   lambda a: plain.paged_tree_attention_plain(
                       *paged_args(a)),
                   sets, [ref], cache=True, tree=True,
                   library_ms=library_ms, note=note)
            if W > 1 and pool == "int8":
                parts = plain.paged_cache_attention_plain(
                    *paged_args(sets[0], tree=False))
                lib_sets = [lse_inputs(torch, a, cache=True) for a in sets]
                library_ms, note = lse_library(torch, lib_sets, parts)
                record("B3 int8 pool W=8", "paged_cache_attention",
                       lambda a: pa.paged_cache_attention(
                           *paged_args(a, tree=False)),
                       lambda a: plain.paged_cache_attention_plain(
                           *paged_args(a, tree=False)),
                       sets, parts, cache=True, tree=False,
                       library_ms=library_ms, note=note)
                del lib_sets
            if W > 1 and pool == "bfloat16":
                def tree_in(a):
                    return a["q"], a["k_new"], a["v_new"], a["tree_mask"]
                parts = plain.sparse_tree_attention_partial_plain(
                    *tree_in(sets[0]))
                lib_sets = [lse_inputs(torch, a, cache=False) for a in sets]
                library_ms, note = lse_library(torch, lib_sets, parts)
                record("B4 W=8", "sparse_tree_attention_partial",
                       lambda a: tp.sparse_tree_attention_partial(
                           *tree_in(a)),
                       lambda a: plain.sparse_tree_attention_partial_plain(
                           *tree_in(a)),
                       sets, parts, cache=False, tree=True,
                       library_ms=library_ms, note=note)
                del lib_sets
            del sets
    return rows


def alternating_ms(torch, fns, n=100, windows=7):
    """``per_call_ms`` of each of ``fns``, their windows taken in turns
    (fn 0, fn 1, ..., fn 0, ...), so a drift of the host's clock falls on
    all of them alike: the medians, in the order of ``fns``."""
    times = [[] for _ in fns]
    for _ in range(windows):
        for k, fn in enumerate(fns):
            times[k].append(per_call_ms(torch, fn, n))
    return [sorted(t)[len(t) // 2] for t in times]


def phase_partial(torch, np, card):
    """B4 at the main path's W=8 (B=4, Hq=Hkv=32, hd=128, bf16) over 4
    input sets: the device time of the empty-launch floor on each route's
    grid (``tree_partial_floor``), of the warp route (the wrapper) and of
    ``tree_partial_kernel`` (route 0 of ``tree_partial_launch``, which runs
    it at any shape; held against the plain version first), each with the
    bound; then where one wrapper call's host time goes, piece by piece:
    the plan lookup and per-call checks, the output allocation, the stream
    and device reads, the C call and the count, beside the whole call and
    the efficient-attention call (``lse_library``), all in alternating
    windows so a drift of the host's clock falls on each alike."""
    import ctypes
    from repro_torch.kernels import launch, plain
    from repro_torch.kernels import tree_partial as tp
    kw = dict(sparse_case_list(np))["main W=8"]
    sets = [sparse_inputs(torch, np, seed=500 + r, **kw) for r in range(4)]
    lib = tp._bind()
    q = sets[0][0]
    B, W, Hq, hd = q.shape
    Hkv = sets[0][1].shape[2]
    plan = tp.PARTIAL_PLANS.get(*sets[0])
    if plan.route != tp.PARTIAL_WARP:
        raise SmokeError(f"the main shape takes B4 route {plan.route}, not "
                         f"the warp route")
    tile, rows = launch.pick_tiles(lib.tree_partial_smem_bytes,
                                   Hq // Hkv * W, W, hd)
    c = plan.c_plan
    tiles_plan = tp._TreePlan(tp.PARTIAL_TILES, c.q_dtype, B, W, Hq, Hkv,
                              hd, tile, rows, c.scale)
    index = q.device.index

    def stream():
        return torch._C._cuda_getCurrentRawStream(index)

    def checked(err):
        if err:
            raise SmokeError(f"B4 entry failed: CUDA error {err} "
                             f"({lib.tree_partial_error_string(err)})")

    def floor(p):
        return lambda a: checked(lib.tree_partial_floor(
            ctypes.addressof(p), stream()))

    def tiles(a):
        outs, out = plan.outputs()
        checked(lib.tree_partial_launch(ctypes.addressof(tiles_plan),
                                        *launch.pointers(a, 3), out,
                                        stream()))
        return outs

    err = _hold(torch, "tree_partial_kernel", "main W=8", tiles(sets[0]),
                plain.sparse_tree_attention_partial_plain(*sets[0]),
                TOL[str(q.dtype)])
    outs = plain.sparse_tree_attention_partial_plain(*sets[0])
    nbytes = sum(t.numel() * t.element_size() for t in sets[0] + outs)
    nnz = int(sets[0][3].sum())
    ops = 4 * B * Hq * hd * nnz
    bound_ms, bound_by = bound(nbytes, ops, q.dtype)
    dev = {"floor warp": device_ms(torch, floor(c), sets,
                                   ("tree_floor_kernel",)),
           "floor tiles": device_ms(torch, floor(tiles_plan), sets,
                                    ("tree_floor_kernel",)),
           "warp": device_ms(torch,
                             lambda a: tp.sparse_tree_attention_partial(*a),
                             sets, SYMBOLS["sparse_tree_attention_partial"]),
           "tiles": device_ms(torch, tiles, sets, ("tree_partial_kernel",))}
    tiles_call = timed(torch, tiles, sets)
    log(f"B4 main W=8 ({card}), device ms: warp route {dev['warp']:.4f} "
        f"(floor {dev['floor warp']:.4f}), tree_partial_kernel "
        f"{dev['tiles']:.4f} (floor {dev['floor tiles']:.4f}; its call "
        f"through route 0 of the same entry {tiles_call:.4f}, max abs err "
        f"{err:.2e}); bound_ms {bound_ms:.4f} ({bound_by}: "
        f"{nbytes / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP over {nnz} mask "
        f"entries); warp route {dev['warp'] / bound_ms:.1f}x the bound, "
        f"{dev['warp'] / dev['floor warp']:.2f}x its floor")

    # ---- one call's host time, piece by piece, in alternating windows
    ptrs = launch.pointers(sets[0], 3)
    _, out = plan.outputs()
    counter = launch.Counted(lambda: None)
    lib_sets = [lse_inputs(torch, dict(zip(("q", "k_new", "v_new",
                                            "tree_mask"), a)), cache=False)
                for a in sets]

    def library(i):
        a = lib_sets[i % 4]
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            a[0], a[1], a[2], a[3], True)

    pieces = {
        "plan and checks": lambda i: (tp.PARTIAL_PLANS.get(*sets[i % 4]),
                                      launch.pointers(sets[i % 4], 3)),
        "outputs": lambda i: plan.outputs(),
        "stream and device": lambda i: (
            torch._C._cuda_getCurrentRawStream(index),
            torch._C._cuda_getDevice()),
        "ctypes": lambda i: lib.tree_partial_launch(plan.ref, *ptrs, out,
                                                    stream()),
        "count": lambda i: launch.count(counter),
        "call": lambda i: tp.sparse_tree_attention_partial(*sets[i % 4]),
        "library call": library,
    }
    host = dict(zip(pieces, alternating_ms(torch, list(pieces.values()))))
    host["other"] = host["call"] - sum(
        host[k] for k in ("plan and checks", "outputs", "stream and device",
                          "ctypes", "count"))
    log(f"B4 host ms per call, main W=8 ({card}; host clock, median of 7 "
        f"windows of 100 calls, the pieces' windows in turns): "
        + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    del sets
    return dict(device=dev, tiles_kernel_ms=tiles_call, tiles_err=err,
                bound_ms=bound_ms, bound_by=bound_by, host=host)


def lse_inputs(torch, a, cache):
    """Operands of ``aten._scaled_dot_product_efficient_attention`` for a
    partial: heads first, bf16, kv heads repeated to the query heads, an
    additive bf16 mask (0 where the key is seen, -inf elsewhere).  The
    cache-only walk (B3) reads the pool's logical view dequantized to bf16
    (the gather is not timed); the tree partial (B4) the tree KVs, its W
    keys padded with masked zero keys to a multiple of 8 (the kernel's
    bias alignment)."""
    from repro_torch.runtime.cache import gather_pages_dequant
    q = a["q"]
    B, W, Hq, hd = q.shape
    if cache:
        k = gather_pages_dequant(a["pool_k"], a["scale_k"], a["block_table"])
        v = gather_pages_dequant(a["pool_v"], a["scale_v"], a["block_table"])
        kp = a["key_pos"][:, None, :]
        seen = ((kp >= 0) & (kp <= a["q_pos"][..., None])
                & (kp > a["lo"][..., None]))                      # (B, W, S)
    else:
        k, v = a["k_new"], a["v_new"]
        seen = a["tree_mask"][None].expand(B, W, W)
    pad = -k.shape[1] % 8
    if pad:
        z = k.new_zeros((B, pad) + tuple(k.shape[2:]))
        k, v = torch.cat([k, z], 1), torch.cat([v, z], 1)
        seen = torch.cat([seen, seen.new_zeros((B, W, pad))], 2)
    G = Hq // k.shape[2]

    def heads(t):
        return t.transpose(1, 2).repeat_interleave(G, dim=1).to(
            torch.bfloat16).contiguous()

    bias = torch.zeros(seen.shape, dtype=torch.bfloat16, device=q.device)
    bias.masked_fill_(~seen, float("-inf"))
    return (q.transpose(1, 2).contiguous(), heads(k), heads(v),
            bias[:, None].expand(B, Hq, W, k.shape[1]).contiguous())


def lse_library(torch, lib_sets, parts):
    """``library_ms`` of a partial kernel: one call of
    ``aten._scaled_dot_product_efficient_attention(...,
    compute_log_sumexp=True)``, which returns o normalized and the
    log-sum-exp, the same partial in another form (o * l and m + log l);
    checked against the plain version's partial before it is timed.
    ``(None, why)`` if the call refuses these operands."""
    def call(a):
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            a[0], a[1], a[2], a[3], True)
    try:
        out, lse = call(lib_sets[0])[:2]
    except RuntimeError as e:
        return None, f" (no library time: the efficient kernel refused: " \
                     f"{str(e).splitlines()[0][:120]})"
    o, m, l = parts
    want = o / l.clamp(min=1e-30).transpose(1, 2)[..., None]
    err = float((out.transpose(1, 2).float() - want).abs().max())
    lse_err = float((lse[..., :m.shape[-1]].float()
                     - (m + torch.log(l))).abs().max())
    return timed(torch, call, lib_sets), (
        f" (aten._scaled_dot_product_efficient_attention with the "
        f"log-sum-exp, host {host_ms(torch, call, lib_sets):.4f}; max abs "
        f"diff to plain: o {err:.2e}, lse {lse_err:.2e})")


def phase_sparse_study(torch, np, launches):
    """The Fig. 10b study's path (``benchmarks/sparse.py``): the
    block-masked tree kernel through its public entry point
    ``kernels.dispatch.sparse_tree_attention`` at the study's shape, in
    fp32 (the study's dtype) and bf16, with every count set to 0 just
    before and read just after.  Prints the study's FLOP terms."""
    from repro_torch.kernels import dispatch
    mask, _ = fig10b_tree(np)
    nnz = int(mask.sum())
    W, H, hd, ctx = (FIG10B[k] for k in ("W", "Hq", "hd", "ctx"))
    dense = 2 * 2 * W * (ctx + W) * H * hd
    block = 2 * 2 * W * W * H * hd
    coo = 2 * 2 * nnz * H * hd
    log(f"Fig. 10b terms (W={W}, nnz={nnz}/{W * W}, ctx {ctx}, H={H}, "
        f"hd={hd}): dense-with-mask over ctx + tree {dense / 1e6:.1f} "
        f"MFLOP, block-masked tree {block / 1e6:.1f} MFLOP, true-sparse "
        f"(nnz) {coo / 1e6:.1f} MFLOP; dense / block = {dense / block:.2f}x")
    fig = {k: v for k, v in FIG10B.items() if k != "ctx"}
    reset_counts()
    for dt in ("float32", "bfloat16"):
        args = sparse_inputs(torch, np, dtype=dt, mask=mask, seed=400, **fig)
        out = dispatch.sparse_tree_attention(*args)
        torch.cuda.synchronize()
        if tuple(out.shape) != tuple(args[0].shape) or \
                out.dtype != args[0].dtype or \
                not bool(torch.isfinite(out).all()):
            raise SmokeError(f"the Fig. 10b study's output at {dt} is "
                             f"malformed: {tuple(out.shape)} {out.dtype}")
    counts = read_counts()
    log(f"Fig. 10b study through dispatch.sparse_tree_attention: kernel "
        f"launches {counts}")
    if counts["sparse_tree_attention"] != 2 or \
            sum(counts.values()) != 2:
        raise SmokeError(f"the study launched {counts}, expected 2 of "
                         f"sparse_tree_attention and nothing else")
    for name, got in counts.items():
        launches[name] += got
    return dict(dense_flop=dense, block_flop=block, nnz_flop=coo, nnz=nnz)


def time_row(torch, card, key, symbol, kernel_fn, plain_fn, sets, nbytes,
             ops, dtype, library=None, note="", optional=(),
             library_ms=None):
    """Time one kernel at one shape: CUDA events around calls (ms), the
    profiler's device time, the plain version and, where given, the
    library call ``(fn, its input sets)`` (or its time ``library_ms``,
    measured by the caller); with the bound of ``nbytes`` and ``ops``."""
    kernel_ms = timed(torch, kernel_fn, sets)
    call_host = host_ms(torch, kernel_fn, sets)
    dev_ms = device_ms(torch, kernel_fn, sets, symbol, optional=optional)
    plain_ms = timed(torch, plain_fn, sets)
    if library is not None:
        library_ms = timed(torch, *library)
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    lib = "none" if library_ms is None else f"{library_ms:.4f}"
    log(f"timing {key} ({card}): kernel_ms {kernel_ms:.4f} (device "
        f"{dev_ms:.4f}, host {call_host:.4f}) plain_ms {plain_ms:.4f} "
        f"library_ms {lib}{note} bound_ms {bound_ms:.4f} ({bound_by}: "
        f"{nbytes / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP); "
        f"{kernel_ms / bound_ms:.1f}x the bound")
    return dict(kernel_ms=kernel_ms, device_ms=dev_ms, host_ms=call_host,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, ops=ops)


def sdpa_tree(torch, args):
    """``scaled_dot_product_attention`` operands computing the normalized
    tree attention: heads first, kv heads repeated to the query heads, the
    boolean W x W mask."""
    q, k, v, mask = args
    G = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2).contiguous(),
            k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous(),
            v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous(), mask)


def phase_tree_timing(torch, np, card):
    """B5 at the Fig. 10b shape (fp32, the study's dtype, and bf16) and at
    the main path's W=8, beside its plain version and
    ``scaled_dot_product_attention`` with the boolean mask; then B1 and B2
    at the W=256 chain of a prefill piece (two row tiles)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain
    from repro_torch.kernels import tree_partial as tp
    from repro_torch.kernels.verify_attention import verify_attention
    from repro_torch.runtime.cache import gather_pages
    import torch.nn.functional as F
    rows = {}
    shapes = {label: kw for label, kw in sparse_case_list(np)
              if label.startswith(("fig10b", "main"))}
    for label, kw in shapes.items():
        sets = [sparse_inputs(torch, np, seed=500 + r, **kw)
                for r in range(4)]
        lib_sets = [sdpa_tree(torch, a) for a in sets]
        ref = plain.sparse_tree_attention_plain(*sets[0])
        lib_err = float((F.scaled_dot_product_attention(
            *lib_sets[0][:3], attn_mask=lib_sets[0][3]).transpose(1, 2)
            .float() - ref.float()).abs().max())
        q = sets[0][0]
        nbytes = sum(t.numel() * t.element_size() for t in sets[0]) + \
            ref.numel() * ref.element_size()
        nnz = int(sets[0][3].sum())
        ops = 4 * q.shape[0] * q.shape[2] * q.shape[3] * nnz
        rows[f"B5 {label}"] = time_row(
            torch, card, f"B5 {label}",
            SYMBOLS["sparse_tree_attention"][str(q.dtype)],
            lambda a: tp.sparse_tree_attention(*a),
            lambda a: plain.sparse_tree_attention_plain(*a), sets, nbytes,
            ops, q.dtype,
            library=(lambda a: F.scaled_dot_product_attention(
                a[0], a[1], a[2], attn_mask=a[3]), lib_sets),
            note=f" (sdpa with the bool mask, max abs diff to plain "
                 f"{lib_err:.2e}; ops over the {nnz} mask entries)")
        del sets, lib_sets
    dense, paged = chain_cases(np)
    sets = [attention_inputs(torch, np, seed=600 + r, **dense)
            for r in range(4)]
    ref = plain.tree_attention_plain(*sets[0])
    nbytes, _ = needed_bytes(torch, sets[0], ref)
    rows["B1 chain W=256"] = time_row(
        torch, card, "B1 chain W=256", SYMBOLS["verify_attention"],
        lambda a: verify_attention(*a),
        lambda a: plain.tree_attention_plain(*a), sets, nbytes,
        needed_ops(sets[0]), ref.dtype,
        library=(lambda a: F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3]),
            [sdpa_inputs(torch, a) for a in sets]))
    sets = [paged_inputs(torch, np, **dict(paged, seed=700 + r))
            for r in range(4)]
    ref = plain.paged_tree_attention_plain(*paged_args(sets[0]))
    nbytes, slots = paged_bytes(sets[0], [ref])
    rows["B2 chain W=256"] = time_row(
        torch, card, "B2 chain W=256", SYMBOLS["paged_tree_attention"],
        lambda a: pa.paged_tree_attention(*paged_args(a)),
        lambda a: plain.paged_tree_attention_plain(*paged_args(a)), sets,
        nbytes, paged_ops(sets[0], slots), ref.dtype,
        library=(lambda a: F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3]),
            [sdpa_inputs(torch, (
                a["q"], gather_pages(a["pool_k"], a["block_table"]),
                gather_pages(a["pool_v"], a["block_table"]), a["k_new"],
                a["v_new"], a["key_pos"], a["q_pos"], a["lo"],
                a["tree_mask"])) for a in sets]),
        note=" (sdpa over the gathered view, gather not timed)")
    return rows


def phase_waves(torch, np, card):
    """The split picker's rule, timed: B1 and B2 (bf16 pool) at verify
    W=8, device time per call with the wrappers' split (as many splits as
    fill the card's resident block slots once) and with twice as many
    splits (the plan for twice the SMs: a second round of blocks), over the
    same 4 input sets each.  Returns {kernel: {fill: (n_split, ms)}}."""
    from repro_torch.kernels import launch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import verify_attention as va
    real = launch.split_plan

    def twice(smem, flash_smem, per_sm, sms, *rest, **kw):
        return real(smem, flash_smem, per_sm, 2 * sms, *rest, **kw)

    kw = dict(main_shapes(np))["verify W=8"]
    dense = [attention_inputs(torch, np, seed=100 + r, **kw)
             for r in range(4)]
    paged = [paged_inputs(torch, np, **dict(k, seed=200 + r))
             for r in range(4)
             for label, k in paged_main_shapes(np, seed=r)
             if label == "main bfloat16 pool verify W=8"]
    sms = launch.sm_count(torch.device(DEVICE))
    libs = {"verify_attention": (va._bind(), "verify_attention",
                                 dense[0][0]),
            "paged_tree_attention": (pa._bind(), "paged_attention",
                                     paged[0]["q"])}
    calls = {"verify_attention": (lambda a: va.verify_attention(*a), dense),
             "paged_tree_attention": (
                 lambda a: pa.paged_tree_attention(*paged_args(a)), paged)}
    out = {}
    for name, (lib, prefix, q) in libs.items():
        per_sm = getattr(lib, f"{prefix}_flash_blocks_per_sm")
        B, W, Hq, hd = q.shape
        S = kw["S"] if name == "verify_attention" else \
            paged[0]["key_pos"].shape[1]
        ps = 1 if name == "verify_attention" else \
            paged[0]["pool_k"].shape[1]
        out[name] = {}
        for fill, plan in (("one fill", real), ("two fills", twice)):
            va.split_plan = pa.split_plan = plan
            try:
                n_split = plan(getattr(lib, f"{prefix}_smem_bytes"),
                               getattr(lib, f"{prefix}_flash_smem_bytes"),
                               per_sm, sms, True, B, W, Hq, kw["Hkv"], hd,
                               S, page=ps)[2]
                ms = device_ms(torch, calls[name][0], calls[name][1],
                               SYMBOLS[name])
            finally:
                va.split_plan = pa.split_plan = real
            out[name][fill] = (n_split, ms)
        log(f"waves {name} verify W=8 ({card}; {per_sm(hd)} blocks per SM "
            f"x {sms} SMs by the occupancy query): "
            + "; ".join(f"{fill}: {n} splits, "
                        f"{n * B * kw['Hkv']} blocks, device {ms:.4f} ms"
                        for fill, (n, ms) in out[name].items()))
    del dense, paged
    return out


def phase_tree_rows(torch, np, card):
    """B5's row-tile picker, timed: the device time of one call at the
    Fig. 10b shape (fp32 and bf16) with each row tile its route offers,
    the picker's choice marked, over the same 4 input sets each.  Returns
    {dtype: {"rows": the picker's choice, "ms": {rows: (blocks, ms)}}}."""
    from repro_torch.kernels import tree_partial as tp
    real = tp.norm_rows
    out = {}
    fig = {k: v for k, v in FIG10B.items() if k != "ctx"}
    G = fig["Hq"] // fig["Hkv"]
    for dt in ("float32", "bfloat16"):
        sets = [sparse_inputs(torch, np, dtype=dt, mask=fig10b_tree(np)[0],
                              seed=500 + r, **fig) for r in range(4)]
        route = tp.norm_route(sets[0][0].dtype, fig["W"], fig["hd"])
        chosen = real(route, fig["B"], fig["Hkv"], G * fig["W"])
        times = {}
        for rows in tp.NORM_ROWS[route]:
            tp.norm_rows = lambda *a, rows=rows: rows
            try:
                ms = device_ms(torch, lambda a: tp.sparse_tree_attention(*a),
                               sets, SYMBOLS["sparse_tree_attention"][
                                   str(sets[0][0].dtype)])
            finally:
                tp.norm_rows = real
            blocks = fig["B"] * fig["Hkv"] * -(-G * fig["W"] // rows)
            times[rows] = (blocks, ms)
        out[dt] = {"rows": chosen, "ms": times}
        log(f"rows B5 fig10b {dt} ({card}): the picker takes {chosen} rows; "
            + "; ".join(f"{r} rows: {n} blocks, device {ms:.4f} ms"
                        for r, (n, ms) in times.items()))
        del sets
    return out


def kernel_entry(name, launches, max_err, row, card, **extra):
    """One entry of the ``{"kernels": [...]}`` line: ``ms`` is the kernel's
    device time (profiler), ``kernel_ms`` the time of a call (CUDA events
    around a loop of calls, the host's share included), ``host_ms`` the
    host's own time per call (``host_ms``)."""
    return dict(KERNELS[name], name=name, launches=launches[name],
                max_abs_err=max_err, max_err=max_err, ms=row["device_ms"],
                device_ms=row["device_ms"], kernel_ms=row["kernel_ms"],
                host_ms=row["host_ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"], card=card, **extra)


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

    t_start = time.perf_counter()
    card = phase_device(torch)
    sass = phase_build()
    max_err = phase_kernel_check(torch, np)
    paged_err = phase_paged_kernel_check(torch, np)
    tree_err = phase_sparse_kernel_check(torch, np)
    edge_err = phase_split_edge_check(torch, np)
    family_err = phase_family_kernel_check(torch, np)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f}s")
    launches, served, loaded = phase_serve(torch, np)
    replays = phase_replay(torch, np, loaded, launches)
    log(f"serve runs done at {time.perf_counter() - t_start:.1f}s")
    phase_time_step(torch, loaded, card)
    profiles = phase_profile(torch, loaded, card)
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f}s")
    arca_hcmp = phase_arca_hcmp(torch, np, loaded, card, profiles, launches)
    log(f"phase 4b done at {time.perf_counter() - t_start:.1f}s")
    drop_engines(torch, served, replays, profiles, arca_hcmp)
    training = phase_training(torch, np, loaded, launches)
    del loaded
    drop_engines(torch)
    training.update(phase_training_full(torch, np, launches))
    log(f"phase 4c done at {time.perf_counter() - t_start:.1f}s")
    drop_engines(torch)
    families = phase_families(torch, np, launches, card)
    log(f"phase 4d done at {time.perf_counter() - t_start:.1f}s")
    study = phase_sparse_study(torch, np, launches)
    timing = phase_timing(torch, np, card)
    paged = phase_paged_timing(torch, np, card)
    tree = phase_tree_timing(torch, np, card)
    waves = phase_waves(torch, np, card)
    tree_rows = phase_tree_rows(torch, np, card)
    partial = phase_partial(torch, np, card)
    family_rows = phase_family_timing(torch, np, card)
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f}s")

    def shapes(prefix):
        """The family shapes' rows of one kernel (phase 5)."""
        return {k: {f: v[f] for f in ("device_ms", "kernel_ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by")}
                for k, v in family_rows.items() if k.startswith(prefix)}
    t, d = timing["verify W=8"], timing["decode W=1"]
    b2, b2d = paged["B2 bfloat16 pool W=8"], paged["B2 bfloat16 pool W=1"]
    i8, i8d = paged["B2 int8 pool W=8"], paged["B2 int8 pool W=1"]
    entries = [
        kernel_entry("verify_attention", launches,
                     max(max_err, tree_err["verify_attention"],
                         edge_err["verify_attention"],
                         family_err["verify_attention"]), t, card,
                     families=shapes("B1"),
                     sass={k: v for k, v in sass.items()
                           if k.startswith("verify")},
                     chain_ms=tree["B1 chain W=256"]["kernel_ms"],
                     chain_device_ms=tree["B1 chain W=256"]["device_ms"],
                     chain_bound_ms=tree["B1 chain W=256"]["bound_ms"],
                     chain_plain_ms=tree["B1 chain W=256"]["plain_ms"],
                     chain_library_ms=tree["B1 chain W=256"]["library_ms"],
                     decode_ms=d["kernel_ms"],
                     decode_device_ms=d["device_ms"],
                     decode_plain_ms=d["plain_ms"],
                     decode_library_ms=d["library_ms"],
                     decode_bound_ms=d["bound_ms"],
                     waves=waves["verify_attention"]),
        kernel_entry("paged_tree_attention", launches,
                     max(paged_err["paged_tree_attention"],
                         tree_err["paged_tree_attention"],
                         edge_err["paged_tree_attention"],
                         family_err["paged_tree_attention"]), b2, card,
                     families=shapes("B2"),
                     sass={k: v for k, v in sass.items()
                           if "paged_flash" in k},
                     chain_ms=tree["B2 chain W=256"]["kernel_ms"],
                     chain_device_ms=tree["B2 chain W=256"]["device_ms"],
                     chain_bound_ms=tree["B2 chain W=256"]["bound_ms"],
                     chain_plain_ms=tree["B2 chain W=256"]["plain_ms"],
                     chain_library_ms=tree["B2 chain W=256"]["library_ms"],
                     decode_ms=b2d["kernel_ms"],
                     decode_device_ms=b2d["device_ms"],
                     decode_plain_ms=b2d["plain_ms"],
                     decode_library_ms=b2d["library_ms"],
                     decode_bound_ms=b2d["bound_ms"],
                     int8_ms=i8["kernel_ms"], int8_device_ms=i8["device_ms"],
                     int8_plain_ms=i8["plain_ms"],
                     int8_library_ms=i8["library_ms"],
                     int8_bound_ms=i8["bound_ms"],
                     int8_decode_ms=i8d["kernel_ms"],
                     int8_decode_device_ms=i8d["device_ms"],
                     int8_decode_plain_ms=i8d["plain_ms"],
                     int8_decode_library_ms=i8d["library_ms"],
                     int8_decode_bound_ms=i8d["bound_ms"],
                     waves=waves["paged_tree_attention"]),
        kernel_entry("paged_cache_attention", launches,
                     max(paged_err["paged_cache_attention"],
                         tree_err["paged_cache_attention"],
                         edge_err["paged_cache_attention"],
                         family_err["paged_cache_attention"]),
                     paged["B3 int8 pool W=8"], card,
                     families=shapes("B3"),
                     sass={k: v for k, v in sass.items()
                           if "cache_flash" in k}),
        kernel_entry("sparse_tree_attention_partial", launches,
                     max(paged_err["sparse_tree_attention_partial"],
                         tree_err["sparse_tree_attention_partial"],
                         partial["tiles_err"],
                         family_err["sparse_tree_attention_partial"]),
                     paged["B4 W=8"], card,
                     families=shapes("B4"),
                     floor_ms=partial["device"]["floor warp"],
                     routes={
                         "warp": dict(
                             kernel="tree_warp_kernel",
                             takes="W <= 64 and head_dim <= 128",
                             device_ms=partial["device"]["warp"],
                             floor_ms=partial["device"]["floor warp"]),
                         "tiles": dict(
                             kernel="tree_partial_kernel",
                             takes="W > 64 or head_dim > 128",
                             device_ms=partial["device"]["tiles"],
                             floor_ms=partial["device"]["floor tiles"],
                             kernel_ms=partial["tiles_kernel_ms"])},
                     host=partial["host"],
                     sass={k: v for k, v in sass.items()
                           if "tree_warp" in k}),
        kernel_entry("sparse_tree_attention", launches,
                     tree_err["sparse_tree_attention"],
                     tree["B5 fig10b float32"], card,
                     bf16_ms=tree["B5 fig10b bfloat16"]["kernel_ms"],
                     bf16_device_ms=tree["B5 fig10b bfloat16"]["device_ms"],
                     bf16_plain_ms=tree["B5 fig10b bfloat16"]["plain_ms"],
                     bf16_library_ms=tree["B5 fig10b bfloat16"]["library_ms"],
                     bf16_bound_ms=tree["B5 fig10b bfloat16"]["bound_ms"],
                     w8_ms=tree["B5 main W=8"]["kernel_ms"],
                     w8_device_ms=tree["B5 main W=8"]["device_ms"],
                     w8_plain_ms=tree["B5 main W=8"]["plain_ms"],
                     w8_library_ms=tree["B5 main W=8"]["library_ms"],
                     w8_bound_ms=tree["B5 main W=8"]["bound_ms"],
                     rows=tree_rows,
                     sass={k: v for k, v in sass.items()
                           if "tree_norm" in k},
                     fig10b=study),
    ]
    log(f"training: {json.dumps(training)}")
    log(f"families: {json.dumps(families, default=str)}")
    steps = {label: r["stats"]["device_steps"] for label, r in served.items()}
    steps.update({label: (r["stats"].get("device_steps"),
                          r["stats"].get("extend_pieces"))
                  for label, r in replays.items()})
    log(f"serve steps per run: {steps}; launches over the main path's "
        f"runs: {launches}; total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeError as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
