"""The port's CUDA kernels on the card (marked ``gpu``; each test skips
without a GPU).  Imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_card.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import plain  # noqa: E402
from repro_torch.kernels import tree_partial as tp  # noqa: E402
from repro_torch.kernels.verify_attention import verify_attention  # noqa: E402


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")


@pytest.mark.gpu
def test_verify_attention_matches_plain_on_card():
    """The reference's kernel sweep and the main path's shapes, at fp32
    2e-5 / bf16 2e-2, each call one kernel launch."""
    _need_gpu()
    n = verify_attention.launches
    worst = chip_smoke.phase_kernel_check(torch, np)
    assert verify_attention.launches == n + len(chip_smoke.CASES) + 2
    assert worst < 2e-2


@pytest.mark.gpu
def test_cuda_call_launches_or_raises():
    """No fallback: a CUDA operand the kernel does not take raises; it
    never runs the plain version."""
    _need_gpu()
    args = chip_smoke.attention_inputs(torch, np, 1, 4, 4, 2, 32, 24, 20, 0,
                                       "float32", seed=0)
    bad = [args[0].double()] + list(args[1:])
    n = verify_attention.launches
    with pytest.raises(TypeError):
        verify_attention(*bad)
    assert verify_attention.launches == n


@pytest.mark.gpu
def test_paged_kernels_match_plain_on_card():
    """The fused page walk, the cache-only walk and the tree partial over
    the paged sweep (window-0 CASES as page tables, PAGED_INT8_CASES) and
    the main path's shapes, each call one launch of each kernel."""
    _need_gpu()
    before = (pa.paged_tree_attention.launches,
              pa.paged_cache_attention.launches,
              tp.sparse_tree_attention_partial.launches)
    worst = chip_smoke.phase_paged_kernel_check(torch, np)
    n = len(chip_smoke.paged_case_list(np))
    assert (pa.paged_tree_attention.launches,
            pa.paged_cache_attention.launches,
            tp.sparse_tree_attention_partial.launches) == tuple(
                b + n for b in before)
    assert max(worst.values()) < 2e-2


@pytest.mark.gpu
def test_paged_cuda_calls_launch_or_raise():
    """No fallback on the card: an int8 pool without scales, or an operand
    of the wrong dtype, raises before any launch."""
    _need_gpu()
    label, kw = chip_smoke.paged_case_list(np)[-1]
    a = chip_smoke.paged_inputs(torch, np, **kw)
    n = (pa.paged_tree_attention.launches, pa.paged_cache_attention.launches,
         tp.sparse_tree_attention_partial.launches)
    with pytest.raises(ValueError):
        pa.paged_tree_attention(*chip_smoke.paged_args(dict(a, scale_k=None,
                                                            scale_v=None)))
    with pytest.raises(TypeError):
        pa.paged_cache_attention(*chip_smoke.paged_args(
            dict(a, q=a["q"].double()), tree=False))
    with pytest.raises(TypeError):
        tp.sparse_tree_attention_partial(a["q"], a["k_new"].float(),
                                         a["v_new"], a["tree_mask"])
    assert (pa.paged_tree_attention.launches,
            pa.paged_cache_attention.launches,
            tp.sparse_tree_attention_partial.launches) == n


@pytest.mark.gpu
def test_tree_kernels_match_plain_on_card():
    """The normalized tree kernel (B5) and the tree partial (B4) over the
    reference's sparse sweep, the Fig. 10b shape and the main path's W=8,
    B4 over its route edges (chip_smoke.PARTIAL_EDGE); the dense verify
    (B1) and the page walk (B2) at a W=256 chain (four row tiles).  Each
    call is one launch of its kernel."""
    _need_gpu()
    wrappers = (tp.sparse_tree_attention, tp.sparse_tree_attention_partial,
                verify_attention, pa.paged_tree_attention)
    before = [w.launches for w in wrappers]
    worst = chip_smoke.phase_sparse_kernel_check(torch, np)
    n = len(chip_smoke.sparse_case_list(np))
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        n, n + len(chip_smoke.PARTIAL_EDGE), 1, 1]
    assert max(worst.values()) < 2e-2


@pytest.mark.gpu
def test_split_edges_match_plain_on_card():
    """B1, B2 and B3's split walk at its edges (chip_smoke.SPLIT_EDGE):
    one, two, three and one split per key tile; splits wholly unreserved,
    past the fill or cut away by a window; a row whose cache is all
    masked; a ragged last key tile over an int8 pool; head_dim 16 to 128;
    bf16, int8 and fp32.  One launch per call."""
    _need_gpu()
    wrappers = (verify_attention, pa.paged_tree_attention,
                pa.paged_cache_attention)
    before = [w.launches for w in wrappers]
    worst = chip_smoke.phase_split_edge_check(torch, np)
    n = len(chip_smoke.SPLIT_EDGE)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [n, n, n]
    assert max(worst.values()) < 2e-2


@pytest.mark.gpu
def test_cache_walk_folds_its_splits_on_card():
    """B3 over the split-edge cases: one unnormalized partial whatever its
    split (one per key tile down to one), within the tolerance of q's
    dtype of the plain version; the all-masked row 2 (lo = q_pos) comes
    back as exactly l = 0, m = NEG_INF / 2, o = 0."""
    _need_gpu()
    from repro_torch.kernels import plain
    for i, case in enumerate(chip_smoke.SPLIT_EDGE.values()):
        _, a = chip_smoke.split_edge_inputs(torch, np, *case, seed=900 + i)
        args = chip_smoke.paged_args(a, tree=False)
        n = pa.paged_cache_attention.launches
        o, m, l = pa.paged_cache_attention(*args)
        assert pa.paged_cache_attention.launches == n + 1
        tol = chip_smoke.TOL[str(a["q"].dtype)]
        chip_smoke._hold(torch, "paged_cache_attention", str(case), (o, m, l),
                         plain.paged_cache_attention_plain(*args), tol)
        assert bool((l[2] == 0).all()) and bool((o[2] == 0).all())
        assert bool((m[2] == -5e29).all())


@pytest.mark.gpu
def test_norm_tree_routes_match_plain_on_card():
    """B5 over the reference's sparse sweep, Fig. 10b and the main path's
    W=8 at every row tile of its route (fp32 2e-5, bf16 2e-2), one launch
    per call."""
    _need_gpu()
    from repro_torch.kernels import plain
    real = tp.norm_rows
    try:
        for i, (label, kw) in enumerate(chip_smoke.sparse_case_list(np)):
            args = chip_smoke.sparse_inputs(torch, np, seed=950 + i, **kw)
            route = tp.norm_route(args[0].dtype, kw["W"], kw["hd"])
            for rows in tp.NORM_ROWS[route]:
                tp.norm_rows = lambda *_, rows=rows: rows
                n = tp.sparse_tree_attention.launches
                got = tp.sparse_tree_attention(*args)
                assert tp.sparse_tree_attention.launches == n + 1
                chip_smoke._hold(torch, "sparse_tree_attention",
                                 f"{label} {rows} rows", got,
                                 plain.sparse_tree_attention_plain(*args),
                                 chip_smoke.TOL[str(args[0].dtype)])
    finally:
        tp.norm_rows = real


@pytest.mark.gpu
def test_tensor_core_instances_use_mma_and_cp_async():
    """The bf16 instances of B1, of B2 and B3 over a bf16 and an int8 pool
    and of B5 hold HMMA and LDGSTS instructions; the eight instances of
    B4's warp route hold LDGSTS and FFMA and no HMMA."""
    _need_gpu()
    from repro_torch.kernels import build
    build.build()
    sass = chip_smoke.sass_counts(build)
    counts = {k: v for k, v in sass.items() if "flash_kernel" in k}
    assert len(counts) == chip_smoke.TENSOR_CORE_INSTANCES == 6
    assert sum("cache_flash_kernel" in k for k in counts) == 2
    assert sum("tree_norm_flash_kernel" in k for k in counts) == 1
    assert all(v["HMMA"] > 0 and v["LDGSTS"] > 0 for v in counts.values())
    warp = {k: v for k, v in sass.items() if "tree_warp_kernel" in k}
    assert len(warp) == chip_smoke.WARP_INSTANCES == 8
    assert len(sass) == len(counts) + len(warp)
    assert all(v["HMMA"] == 0 and v["LDGSTS"] > 0 and v["FFMA"] > 0
               for v in warp.values())


@pytest.mark.gpu
@pytest.mark.parametrize("W", [8, 1, 16, 32, 64])
def test_tree_partial_warp_route_on_card(W):
    """B4's warp route equals its plain version at the main path's shape
    (B=4, Hq=Hkv=32, hd=128, bf16) with W = 8 (the serve's tree) and at
    W = 1, 16, 32 and 64 (each key-slot width of the route); each call is one launch; a misaligned or
    non-contiguous operand raises on CUDA and launches nothing."""
    _need_gpu()
    tree = chip_smoke.main_path_tree(np)[0][0] if W == 8 else \
        chip_smoke.rand_tree(np, W, seed=W)[0]
    args = chip_smoke.sparse_inputs(torch, np, B=4, W=W, Hq=32, Hkv=32,
                                    hd=128, dtype="bfloat16", mask=tree,
                                    seed=W)
    assert tp.PARTIAL_PLANS.get(*args).route == tp.PARTIAL_WARP
    n = tp.sparse_tree_attention_partial.launches
    got = tp.sparse_tree_attention_partial(*args)
    assert tp.sparse_tree_attention_partial.launches == n + 1
    got = tp.sparse_tree_attention_partial(*args)
    assert tp.sparse_tree_attention_partial.launches == n + 2
    want = plain.sparse_tree_attention_partial_plain(*args)
    torch.cuda.synchronize()
    assert chip_smoke._hold(torch, "sparse_tree_attention_partial",
                            f"W={W}", got, want, 2e-2) < 2e-2
    q = args[0]
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)[1:]
    misaligned = flat.view(q.shape)
    misaligned.copy_(q)
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    for bad in (misaligned, strided):
        with pytest.raises(ValueError):
            tp.sparse_tree_attention_partial(bad, *args[1:])
    assert tp.sparse_tree_attention_partial.launches == n + 2


@pytest.mark.gpu
def test_paged_walk_two_threads_two_widths_on_card():
    """B2 on its fp32 CUDA-core route, whose block's shared memory grows
    with W, from two threads at once: one at W=8, one at W=256 (a chain),
    200 calls each.  The shared-memory attribute is raised once per kernel
    instance to one fixed value, so neither thread's launch can find the
    other's smaller setting: every launch succeeds and every result equals
    the plain version (fp32 2e-5)."""
    import threading
    _need_gpu()
    cases = []
    for W, tree in ((8, chip_smoke.rand_tree(np, 8, seed=8)),
                    (256, chip_smoke.chain_tree(np, 256))):
        ps, maxp, B = 16, 24, 2
        table = np.random.default_rng(W).permutation(B * maxp).reshape(
            B, maxp).astype(np.int32)
        a = chip_smoke.paged_inputs(
            torch, np, B=B, W=W, Hq=4, Hkv=2, hd=64, ps=ps, table=table,
            n_pages=B * maxp, fills=[40, 33], pool_dtype="float32",
            q_dtype="float32", seed=W, tree=tree)
        args = chip_smoke.paged_args(a)
        cases.append((args, plain.paged_tree_attention_plain(*args)))
    n = pa.paged_tree_attention.launches
    errors, worst = [], []

    def run(args, want):
        try:
            outs = [pa.paged_tree_attention(*args) for _ in range(200)]
            torch.cuda.synchronize()
            worst.append(max(float((o - want).abs().max()) for o in outs))
        except Exception as e:          # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=c) for c in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(worst) == 2 and max(worst) < 2e-5, worst
    assert pa.paged_tree_attention.launches == n + 400


# serve modes of the graph path's card test: label -> (mode, flags, the
# kernels each forward launches once per layer)
GRAPH_MODES = {
    "dense ghidorah": ("ghidorah", [], ("verify_attention",)),
    "dense sequential": ("sequential", [], ("verify_attention",)),
    "paged bf16": ("ghidorah", ["--paged", "--kv-dtype", "bf16"],
                   ("paged_tree_attention",)),
    "paged int8": ("ghidorah", ["--paged", "--kv-dtype", "int8"],
                   ("paged_tree_attention",)),
    "int8 sparse": ("ghidorah", ["--paged", "--kv-dtype", "int8",
                                 "--tree-kernel", "sparse"],
                    ("paged_cache_attention",
                     "sparse_tree_attention_partial")),
}
_LOADED = {}


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(GRAPH_MODES))
def test_graphed_chunk_equals_eager_on_card(label):
    """On qwen2-0.5b-smoke (fp32, random weights), the captured step's
    replays give exactly the eager chunks' tokens, over two ``generate``
    calls (the second captures anew on its own prefill's K/V), and each
    forward is counted once per layer through the replays' tallies."""
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import eager
    _need_gpu()
    mode, flags, kernels = GRAPH_MODES[label]
    args = serve.parse_args(
        ["--arch", "qwen2-0.5b-smoke", "--mode", mode, "--width", "8",
         "--batch", "3", "--prompt-len", "24", "--tokens", "20",
         "--chunk", "4", "--page-size", "8"] + flags)
    if not _LOADED:
        _LOADED["m"] = serve.load(args, with_heads=True)
    loaded = _LOADED["m"]
    batch = {"tokens": serve.prompts(loaded.cfg, args)}
    wrappers = chip_smoke.kernel_wrappers()
    graphed = serve.build_engine(args, loaded)
    for w in wrappers.values():
        w.launches = 0
    outs, steps = [], 0
    for _ in range(2):
        out, stats = graphed.generate(batch, args.tokens)
        outs.append(out)
        steps += stats["device_steps"]
    torch.cuda.synchronize()
    counts = {name: w.launches for name, w in wrappers.items()}
    want = loaded.cfg.num_layers * steps
    assert counts == {name: want if name in kernels else 0
                      for name in wrappers}, (counts, want)
    gs = graphed.graph_stats
    assert gs["captures"] == 2 and gs["replays"] > 0 and gs["graphs"] == 1
    assert stats["replay_steps"] > 0
    with eager():
        ref, _ = serve.build_engine(args, loaded).generate(batch,
                                                           args.tokens)
    for out in outs:
        np.testing.assert_array_equal(out, ref)


# the overlap partition's card tests: the four drafted modes above and the
# paged pool in the model's dtype
OVERLAP_MODES = {label: GRAPH_MODES[label] for label in
                 ("dense ghidorah", "paged bf16", "paged int8",
                  "int8 sparse")}
OVERLAP_MODES["paged fp32"] = ("ghidorah", ["--paged"],
                               ("paged_tree_attention",))


def _overlap_args(flags, hcmp="overlap"):
    from repro_torch.launch import serve
    return serve.parse_args(
        ["--arch", "qwen2-0.5b-smoke", "--mode", "ghidorah", "--width", "8",
         "--batch", "3", "--prompt-len", "24", "--tokens", "20",
         "--chunk", "4", "--page-size", "8", "--hcmp", hcmp] + flags)


def _loaded(args):
    from repro_torch.launch import serve
    if not _LOADED:
        _LOADED["m"] = serve.load(args, with_heads=True)
    return _LOADED["m"]


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(OVERLAP_MODES))
def test_overlap_graph_equals_inline_on_card(label):
    """The overlapped step captured with its draft on a second stream:
    over two ``generate`` calls its replays give exactly the inline
    engine's tokens (graphed and eager), each forward is counted once per
    layer through the replays' tallies, and the pre-draft carries over the
    quiet chunk boundaries."""
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import eager
    _need_gpu()
    _, flags, kernels = OVERLAP_MODES[label]
    args = _overlap_args(flags)
    loaded = _loaded(args)
    batch = {"tokens": serve.prompts(loaded.cfg, args)}
    wrappers = chip_smoke.kernel_wrappers()
    over = serve.build_engine(args, loaded)
    assert over.hcmp == "overlap"
    for w in wrappers.values():
        w.launches = 0
    outs, steps = [], 0
    for _ in range(2):
        out, stats = over.generate(batch, args.tokens)
        outs.append(out)
        steps += stats["device_steps"]
    torch.cuda.synchronize()
    counts = {name: w.launches for name, w in wrappers.items()}
    want = loaded.cfg.num_layers * steps
    assert counts == {name: want if name in kernels else 0
                      for name in wrappers}, (counts, want)
    gs = over.graph_stats
    assert gs["captures"] == 2 and gs["replays"] > 0 and gs["graphs"] == 1
    assert all(k[0] == "overlap" for k in over._graphs._graphs)
    hs = over.hcmp_stats
    assert hs["executors"] == 2 and hs["predraft_hits"] > 0
    inline = serve.build_engine(_overlap_args(flags, "inline"), loaded)
    ref, _ = inline.generate(batch, args.tokens)
    with eager():
        ref_eager, _ = serve.build_engine(
            _overlap_args(flags, "inline"), loaded).generate(batch,
                                                             args.tokens)
    np.testing.assert_array_equal(ref, ref_eager)
    for out in outs:
        np.testing.assert_array_equal(out, ref)


@pytest.mark.gpu
def test_overlap_capture_two_replica_threads_on_card():
    """Two overlap engines (replicas over one set of weights) capture and
    replay at once from two threads, each with its own draft stream: no
    capture is voided by the other thread's work, and each thread's tokens
    equal the inline engine's."""
    import threading
    from repro_torch.launch import serve
    _need_gpu()
    args = _overlap_args(["--paged", "--kv-dtype", "int8"])
    loaded = _loaded(args)
    batch = {"tokens": serve.prompts(loaded.cfg, args)}
    ref, _ = serve.build_engine(
        _overlap_args(["--paged", "--kv-dtype", "int8"], "inline"),
        loaded).generate(batch, args.tokens)
    engines = [serve.build_engine(args, loaded) for _ in range(2)]
    outs, errors = [[], []], []

    def run(i):
        try:
            for _ in range(3):
                outs[i].append(engines[i].generate(batch, args.tokens)[0])
            # this thread's stream only: a device-wide sync would also
            # wait on the other thread's stream while it captures, which
            # CUDA refuses (cudaErrorStreamCaptureUnsupported)
            torch.cuda.current_stream().synchronize()
        except Exception as e:          # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i, eng in enumerate(engines):
        assert len(outs[i]) == 3 and eng.graph_stats["captures"] == 3
        for out in outs[i]:
            np.testing.assert_array_equal(out, ref)
    assert engines[0].hcmp_executors[1] != engines[1].hcmp_executors[1]


@pytest.mark.gpu
def test_failed_overlap_capture_raises_on_card(monkeypatch):
    """An error inside the overlapped step while it is captured reaches
    the caller: the chunk is not run on the inline step instead."""
    from repro_torch.core.hcmp import executors
    from repro_torch.launch import serve
    _need_gpu()
    args = _overlap_args([])
    loaded = _loaded(args)
    batch = {"tokens": serve.prompts(loaded.cfg, args)}
    real = executors.verify_front

    def faulty(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("injected capture fault")
        return real(*a, **kw)

    monkeypatch.setattr(executors, "verify_front", faulty)
    eng = serve.build_engine(args, loaded)
    with pytest.raises(RuntimeError, match="injected capture fault"):
        eng.generate(batch, args.tokens)
    assert eng.graph_stats["captures"] == 0
    assert eng.graph_stats["warmup_steps"] > 0


@pytest.mark.gpu
def test_training_steps_match_cpu_on_card():
    """One ``train_step`` and one ``medusa_step`` at ``qwen2-0.5b-smoke``
    float32 from the same seeded params on the card and on the CPU: losses
    within 1e-4 relative, the first step's grads within 2e-5 x each leaf's
    max |g|, and no kernel launched (``chip_smoke.training_parity`` raises
    otherwise)."""
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    res = chip_smoke.training_parity(torch, np, steps=1)
    assert res["loss_rel_err"] <= chip_smoke.PARITY_RTOL
    assert res["grad_rel_err"] <= chip_smoke.GRAD_TOL
    assert all(w.launches == 0
               for w in chip_smoke.kernel_wrappers().values())


@pytest.mark.gpu
def test_family_shapes_match_plain_on_card():
    """B1, B2 (bf16 and int8 pools), B3 (int8) and B4 at the attention
    shapes of the MoE, VLM and hybrid families (chip_smoke.
    family_kernel_cases): zamba2-7b's site at head_dim 112 with
    Hq = Hkv = 32 (B1 and B4 in fp32 too) and qwen3-moe-30b-a3b's G=8
    layer at head_dim 128; B1 and B2 alone at seamless-m4t-medium's
    decoder layer (Hq = Hkv = 16, head_dim 64: its verify never splits);
    W=8 and W=1; one launch per call, every one within fp32 2e-5 / bf16
    2e-2 of its plain version."""
    _need_gpu()
    wrappers = (verify_attention, pa.paged_tree_attention,
                pa.paged_cache_attention, tp.sparse_tree_attention_partial)
    before = [w.launches for w in wrappers]
    worst = chip_smoke.phase_family_kernel_check(torch, np)
    cases = chip_smoke.family_kernel_cases(np)
    n, n112 = len(cases), sum(c[3]["hd"] == 112 for c in cases)
    split = sum(c[1] not in chip_smoke.FUSED_ONLY for c in cases)
    assert n112 == 2 and n == 6 and split == 4
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        n + n112, 2 * n, split, split + n112]
    assert max(worst.values()) < 2e-2


# the families of the card's graph test: smoke configs, fp32
FAMILY_GRAPH_ARCHS = ["qwen3-moe-30b-a3b-smoke", "llava-next-mistral-7b-smoke",
                      "zamba2-7b-smoke", "xlstm-125m-smoke",
                      "seamless-m4t-medium-smoke"]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", FAMILY_GRAPH_ARCHS)
def test_family_graphed_chunk_equals_eager_on_card(arch, paged):
    """The MoE, VLM (its patch prefix in the batch), hybrid, xLSTM and
    enc-dec (its frames in the batch) families on the card: the captured
    step's replays give the eager chunks' tokens, each forward counted
    once per attention layer or site through the replays' tallies (none
    in xLSTM; the recurrent states ride the graph's static buffers, the
    cross memory is adopted like K/V)."""
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import eager
    _need_gpu()
    flags = ["--paged", "--kv-dtype", "bf16"] if paged else []
    args = serve.parse_args(
        ["--arch", arch, "--mode", "ghidorah", "--width", "8", "--batch",
         "3", "--prompt-len", "24", "--tokens", "20", "--chunk", "4",
         "--page-size", "8"] + flags)
    loaded = serve.load(args, with_heads=True)
    cfg = loaded.cfg
    batch = {"tokens": torch.as_tensor(serve.prompts(cfg, args),
                                       device=loaded.device)}
    extra = {"vision": ("patch_embeds", cfg.num_frontend_tokens),
             "audio": ("frame_embeds", cfg.encoder_seq_len)}.get(cfg.frontend)
    if extra is not None:
        batch[extra[0]] = torch.randn(
            (3, extra[1], cfg.d_model),
            generator=torch.Generator(device="cuda").manual_seed(2),
            device="cuda")
    spec = serve.fixed_spec(args, cfg)
    max_len = 24 + cfg.num_frontend_tokens + 20 + spec.max_depth
    wrappers = chip_smoke.kernel_wrappers()
    graphed = serve.build_engine(args, loaded, spec, max_len=max_len)
    for w in wrappers.values():
        w.launches = 0
    out, stats = graphed.generate(batch, args.tokens)
    torch.cuda.synchronize()
    counts = {name: w.launches for name, w in wrappers.items()}
    kernel = "paged_tree_attention" if paged else "verify_attention"
    want = chip_smoke.attention_layers(cfg) * stats["device_steps"]
    assert counts == {name: want if name == kernel else 0
                      for name in wrappers}, (counts, want)
    assert stats["replay_steps"] > 0
    with eager():
        ref, _ = serve.build_engine(args, loaded, spec,
                                    max_len=max_len).generate(batch,
                                                              args.tokens)
    np.testing.assert_array_equal(out, ref)
