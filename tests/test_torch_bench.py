"""The port's measured harness (``repro_torch.benchmarks``: Fig. 10b and its
int8 arm, the engine and scheduler benches, the roofline note) and its
quickstart (``repro_torch.launch.quickstart``) against the reference's
scripts in the repository's ``benchmarks/`` and ``examples/``, on the CPU
at a tiny size: the same numpy inputs through both, fp32 outputs within
2e-5, the records' keys a superset of the reference's recorded ones, and
every in-run gate of the benches held.  Nothing here writes into
``results/torch/`` or ``benchmarks/results/``."""
import contextlib
import io
import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import roofline as r_roof  # noqa: E402
from benchmarks import sched_bench as r_sched  # noqa: E402
from benchmarks import sparse as r_sparse  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core.speculative import tree as RT  # noqa: E402
from repro.core.speculative import medusa as r_medusa  # noqa: E402
from repro.kernels import ops as r_kops  # noqa: E402
from repro.kernels.ref import sparse_tree_ref  # noqa: E402
from repro.kernels import sparse_tree as r_sparse_tree  # noqa: E402
from repro.models import common as r_cm  # noqa: E402
from repro.models.api import get_model as r_get_model  # noqa: E402
from repro.runtime import cache as r_cache  # noqa: E402
from repro_torch.benchmarks import engine_bench, roofline  # noqa: E402
from repro_torch.benchmarks import sched_bench  # noqa: E402
from repro_torch.benchmarks import sparse  # noqa: E402
from repro_torch.bridge import heads_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.speculative import tree as TT  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.runtime.continuous import TERMINAL_STATES  # noqa: E402

TOL = 2e-5
REF_RESULTS = ROOT / "benchmarks" / "results"


def _t(a):
    return torch.as_tensor(np.array(a))


def _study(W, H=4, Hkv=2, hd=32, seed=0):
    """The reference study's inputs (``benchmarks/sparse.py::run``) at a
    small shape, as numpy."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (1, W, H, hd), jnp.float32)
    kn = jax.random.normal(ks[1], (1, W, Hkv, hd), jnp.float32)
    vn = jax.random.normal(ks[2], (1, W, Hkv, hd), jnp.float32)
    spec = RT.build_tree(RT.default_accs(5, 10), W)
    tspec = TT.build_tree(TT.default_accs(5, 10), W)
    assert np.array_equal(spec.mask, tspec.mask)
    return np.asarray(q), np.asarray(kn), np.asarray(vn), spec.mask


def test_fig10b_arms_equal_reference():
    q, kn, vn, mask = _study(16)
    jm = jnp.asarray(mask)
    ref = {"naive": r_sparse._naive_coo(q, kn, vn, jm),
           "dense": sparse_tree_ref(q, kn, vn, jnp.ones_like(jm) & jm),
           "block": r_sparse_tree.sparse_tree_attention(q, kn, vn, jm)}
    port = sparse.fig10b_outputs(_t(q), _t(kn), _t(vn), _t(mask))
    for arm in ("naive", "dense", "block"):
        np.testing.assert_allclose(port[arm].numpy(), np.asarray(ref[arm]),
                                   rtol=0, atol=TOL, err_msg=arm)


def _ref_int8(q, kn, vn, mask, k_ctx, v_ctx, ps):
    """The reference's int8 arm (``benchmarks/sparse.py::run_int8``): its
    three outputs, without the timing."""
    B, ctx = q.shape[0], k_ctx.shape[2]
    Hkv, hd = k_ctx.shape[3:]
    n_pages = (ctx + ps - 1) // ps
    dense = r_cache.init_kv_cache(1, B, ctx, Hkv, hd)
    dense = type(dense)(k=jnp.asarray(k_ctx), v=jnp.asarray(v_ctx),
                        key_pos=jnp.broadcast_to(jnp.arange(ctx), (B, ctx)),
                        pos=jnp.full((B,), ctx, jnp.int32), window=0)
    tables = jnp.broadcast_to(jnp.arange(n_pages, dtype=jnp.int32),
                              (B, n_pages))
    paged32 = r_cache.paginate_cache(r_cache.Cache(kv=dense), tables,
                                     page_size=ps, n_pages=n_pages).kv
    paged8 = r_cache.paginate_cache(r_cache.Cache(kv=dense), tables,
                                    page_size=ps, n_pages=n_pages,
                                    kv_dtype=jnp.int8).kv
    depth = jnp.zeros((q.shape[1],), jnp.int32)
    jm = jnp.asarray(mask)

    def fused(kv):
        return r_kops.paged_tree_attention(
            q, kv.pool_k[0], kv.pool_v[0], kn, vn, kv.block_table,
            kv.key_pos, kv.pos, depth, jm,
            scale_k=None if kv.scale_k is None else kv.scale_k[0],
            scale_v=None if kv.scale_v is None else kv.scale_v[0])

    cache_part = r_kops.paged_cache_attention(
        q, paged8.pool_k[0], paged8.pool_v[0], paged8.block_table,
        paged8.key_pos, paged8.pos, depth, scale_k=paged8.scale_k[0],
        scale_v=paged8.scale_v[0])
    tree_part = r_kops.sparse_tree_attention_partial(q, kn, vn, jm)
    return {"fused_fp32": fused(paged32), "fused_int8": fused(paged8),
            "split_int8": r_cm.merge_partials([cache_part, tree_part])}


def test_int8_arm_outputs_equal_reference():
    W, ctx, ps, Hkv, hd = 16, 40, 16, 2, 32
    q, kn, vn, mask = _study(W, Hkv=Hkv, hd=hd)
    k_ctx = np.asarray(jax.random.normal(jax.random.PRNGKey(9),
                                         (1, 1, ctx, Hkv, hd), jnp.float32))
    v_ctx = np.asarray(jax.random.normal(jax.random.PRNGKey(10),
                                         (1, 1, ctx, Hkv, hd), jnp.float32))
    ref = _ref_int8(q, kn, vn, mask, k_ctx, v_ctx, ps)
    port = sparse.int8_outputs(_t(q), _t(kn), _t(vn), _t(mask), _t(k_ctx),
                               _t(v_ctx), ps)
    for arm in ("fused_fp32", "fused_int8", "split_int8"):
        np.testing.assert_allclose(port[arm].numpy(), np.asarray(ref[arm]),
                                   rtol=0, atol=TOL, err_msg=arm)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = dict((n, v) for n, v, _ in sparse.run_int8(
            width=W, mask=_t(mask), q=_t(q), kn=_t(kn), vn=_t(vn), ctx=ctx,
            Hkv=Hkv, hd=hd, reps=1, k_ctx=_t(k_ctx), v_ctx=_t(v_ctx),
            page_size=ps))
    o32 = np.asarray(ref["fused_fp32"])
    for name, arm in (("int8_fused_err_vs_fp32", "fused_int8"),
                      ("int8_split_err_vs_fp32", "split_int8")):
        want = float(np.max(np.abs(np.asarray(ref[arm]) - o32)))
        assert rows[name] == pytest.approx(want, abs=TOL)
        assert rows[name] < sparse.INT8_BOUND
    ratio = (r_cache.page_bytes(1, ps, Hkv, hd, jnp.float32)
             / r_cache.page_bytes(1, ps, Hkv, hd, jnp.int8))
    assert rows["int8_cache_bytes_reduction"] == ratio


def test_int8_arm_gate_raises_past_its_bound(monkeypatch):
    """The in-run gate is live: an int8 walk off the fp32 one fails."""
    W, ctx, Hkv, hd = 8, 32, 2, 32
    q, kn, vn, mask = _study(W, Hkv=Hkv, hd=hd)
    real = sparse.int8_outputs

    def off(*a, **k):
        out = real(*a, **k)
        out["split_int8"] = out["split_int8"] + 1.0
        return out
    monkeypatch.setattr(sparse, "int8_outputs", off)
    with pytest.raises(AssertionError, match="int8 walk off"):
        with contextlib.redirect_stdout(io.StringIO()):
            sparse.run_int8(width=W, mask=_t(mask), q=_t(q), kn=_t(kn),
                            vn=_t(vn), ctx=ctx, Hkv=Hkv, hd=hd, reps=1)


def _covers(port, ref, path="record"):
    """Every key of the reference's record (recursively; a list's entries
    in order) is in the port's."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        # "note" is written only when the overlap does not win
        missing = sorted(set(ref) - set(port) - {"note"})
        assert not missing, f"{path} lacks {missing}"
        for k, v in ref.items():
            # states, routes and per-width times are keyed by data
            if isinstance(v, (dict, list)) and k not in (
                    "states", "routed", "step_time_measured_s"):
                _covers(port[k], v, f"{path}.{k}")
    elif isinstance(ref, list) and ref and isinstance(ref[0], dict):
        assert isinstance(port, list) and port, path
        for i, item in enumerate(ref):
            _covers(port[min(i, len(port) - 1)], item, f"{path}[{i}]")


_ENGINE = {}


def _engine_record():
    if not _ENGINE:
        loaded = engine_bench.load(engine_bench.engine_smoke_cfg(), "cpu")
        _ENGINE["rec"] = engine_bench.worker(
            loaded, n_tokens=8, reps=1, train_steps=30, head_steps=30)
    return _ENGINE["rec"]


def test_engine_bench_record_keeps_reference_keys():
    rec = _engine_record()
    with open(REF_RESULTS / "engine_bench.json") as f:
        _covers(rec, json.load(f))
    assert rec["card"] == {"device": "cpu", "name": "cpu"}
    assert [(g["engine"], g["B"], g["K"]) for g in rec["grid"]] == [
        (e, B, K) for B in engine_bench.BATCHES for K in engine_bench.CHUNKS
        for e in ("sequential", "speculative")]


def test_engine_bench_streams_equal_and_arms_gated():
    rec = _engine_record()
    assert rec["dtype"] == "float32"
    assert rec["streams_equal"] and rec["parity"]["equal"]
    assert all(g["agree_with_sequential"] == 1.0 for g in rec["grid"]
               if g["engine"] == "speculative")
    tr = rec["trained"]
    assert tr["acceptance"] > tr["acceptance_random_heads"]
    assert [g["B"] for g in rec["hcmp"]["grid"]] == [1, 4]
    assert rec["hcmp"]["streams"] == 1


def test_engine_bench_fp32_parity_of_a_bf16_model():
    """A bf16 model's grid is held to its float32 copy's streams."""
    loaded = engine_bench.load(engine_bench.engine_smoke_cfg(), "cpu",
                               dtype="bfloat16")
    spec = TT.build_tree(TT.default_accs(4, 4), 4)
    prompt = engine_bench.prompts_for(loaded.cfg, 2, 8)
    out = engine_bench.parity(engine_bench._as_fp32(loaded), spec, prompt,
                              6, 8 + 6 + spec.max_depth, 4)
    assert out["equal"] and out["dtype"] == "float32"


def _ref_sched_record():
    with open(REF_RESULTS / "sched_bench.json") as f:
        return json.load(f)


def _sched(sizes, arms):
    loaded = engine_bench.load(sched_bench.sched_smoke_cfg(), "cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        return sched_bench.worker(loaded, sizes, arms)


def test_sched_grid_and_paged_arms():
    sz = sched_bench.Sizes(requests=12, budgets=(8, 96), reps=1)
    rec = _sched(sz, ("grid", "paged"))
    ref = _ref_sched_record()
    _covers(rec, {k: ref[k] for k in ref
                  if k not in ("policies", "adaptive", "faults", "hcmp")})
    assert rec["paged"]["donation_in_place"] is True
    assert rec["paged"]["paged_max_resident"] > \
        rec["paged"]["dense_max_resident"]
    # the reference's pages-at-fixed-bytes figures at the same sizes
    cfg = r_sched._sched_smoke_cfg()
    spec = RT.build_tree(RT.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                         4)
    ps = sched_bench.PAGE_SIZE
    max_len = sched_bench.PROMPT_LEN + max(sz.budgets) + spec.max_depth
    pool_pages = (sched_bench.BATCH * max_len) // ps
    budget = pool_pages * r_cache.page_bytes(
        cfg.num_layers, ps, cfg.num_kv_heads, cfg.head_dim,
        jnp.dtype(cfg.dtype))
    int8_pages = r_cache.pages_at_fixed_bytes(
        budget, cfg.num_layers, ps, cfg.num_kv_heads, cfg.head_dim, jnp.int8)
    pg = rec["paged"]
    assert (pg["pool_pages"], pg["int8_pool_bytes_budget"],
            pg["int8_pool_pages"]) == (pool_pages, int(budget), int8_pages)
    assert pg["int8_reservable_token_gain"] == int8_pages / pool_pages


def test_sched_faults_arm_reaches_typed_terminal_states():
    """The faults arm's run (``faults_run``: the typed-terminal and
    drained-pool gates); its goodput gate compares two wall-clock
    makespans, whose spread on a shared CPU (1.5x between runs here) is
    wider than the gate's margin, so it is held on the card (chip phase
    4e) and its raise is checked below."""
    loaded = engine_bench.load(sched_bench.sched_smoke_cfg(), "cpu")
    spec = TT.build_tree(TT.default_accs(4, 4), sched_bench.WIDTH)
    sz = sched_bench.Sizes(budgets=(16, 192), reps=1)
    with engine_bench.pinned("cpu"), torch.no_grad():
        out = sched_bench.faults_run(
            loaded, spec, sched_bench.PROMPT_LEN + 192 + spec.max_depth, sz,
            "cpu")
    _covers(out, _ref_sched_record()["faults"], "faults")
    assert out["faulted"]["retries"] > 0          # the crash was retried
    for arm in ("fault_free", "faulted"):
        st = out[arm]
        assert st["terminal"] and st["pages_drained"]
        assert set(st["states"]) <= TERMINAL_STATES
        assert sum(st["states"].values()) == out["requests"]


def test_sched_faults_goodput_gate_raises(monkeypatch):
    stats = {"goodput_ratio_faulted_vs_fault_free": 0.79,
             "faulted": {"goodput_tok_s": 79.0},
             "fault_free": {"goodput_tok_s": 100.0}}
    monkeypatch.setattr(sched_bench, "faults_run", lambda *a: stats)
    with pytest.raises(AssertionError, match="below 0.8x fault-free"):
        sched_bench.faults_compare(None, None, 0, sched_bench.Sizes(), "cpu")
    stats["goodput_ratio_faulted_vs_fault_free"] = 0.8
    assert sched_bench.faults_compare(None, None, 0, sched_bench.Sizes(),
                                      "cpu") is stats


def test_sched_policy_adaptive_and_hcmp_arms():
    sz = sched_bench.Sizes(requests=12, policy_requests=32, budgets=(8, 64),
                           reps=1)
    rec = _sched(sz, ("policies", "adaptive", "hcmp"))
    ref = _ref_sched_record()
    for arm in ("policies", "adaptive", "hcmp"):
        _covers(rec[arm], ref[arm], arm)
    assert rec["policies"]["requests"] == 32
    assert rec["policies"]["p95_gain_best_vs_fifo"] > 1.0
    assert rec["adaptive"]["gain_adaptive_vs_worst_fixed"] >= 1.0
    assert rec["hcmp"]["streams"] == 1


def test_sched_unknown_arm_raises():
    with pytest.raises(ValueError, match="unknown arm"):
        sched_bench._arm({}, "nope", None, None, 0, sched_bench.Sizes(),
                         "cpu")


def test_int8_kv_note_equals_reference():
    for arch in ("qwen2-0.5b", "vicuna-7b"):
        assert roofline.int8_kv_note(arch) == r_roof.int8_kv_note(arch)


def test_roofline_reads_only_the_ports_records(tmp_path):
    """The port's table never reads the reference's TPU dry-run records
    and prices a record on the H100's figures."""
    assert roofline.DRYRUN_DIR != r_roof.RESULTS
    rows = roofline.table()
    assert len(rows) == len(list(
        roofline.DRYRUN_DIR.glob("*__single__hcmp.json")))
    # the reference's one record (a smoke config's train_4k) is not read
    assert all(not r["arch"].endswith("-smoke") for r in rows)
    rec = {"arch": "qwen2-0.5b", "shape": "decode_32k", "status": "ok",
           "mesh": "single", "mode": "hcmp", "n_devices": 1,
           "model_params_active": 5e8, "flops": 989e12,
           "bytes_accessed": 3.35e12 / 2,
           "collectives": {"total": 450e9 / 4},
           "memory": {"peak_bytes": 2e9}}
    (tmp_path / "r.json").write_text(json.dumps(rec))
    [row] = roofline.table(results_dir=str(tmp_path))
    assert (row["compute_s"], row["memory_s"], row["collective_s"]) == \
        pytest.approx((1.0, 0.5, 0.25))
    assert row["bound"] == "compute" and row["step_s"] == 1.0
    assert row["model_flops"] == pytest.approx(2.0 * 5e8 * 128)
    assert "| qwen2-0.5b | decode_32k |" in roofline.render_markdown([row])


def test_quickstart_steps_equal_reference(monkeypatch, capsys):
    arch = "qwen2-0.5b-smoke"
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--arch", arch])
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                   run_name="__main__")
    printed = capsys.readouterr().out.splitlines()
    ref_decode = [int(x.rsplit(" ", 1)[1]) for x in printed
                  if x.startswith("decode step")]
    spec_line = next(x for x in printed if x.startswith("speculative step"))
    ref_accepted = json.loads(spec_line.rsplit(": ", 1)[1])

    cfg = r_get_config(arch)
    jm = r_get_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, 16), 0,
                              cfg.vocab_size)
    jh = r_medusa.init_medusa(cfg, jax.random.PRNGKey(2))
    ref_logits, _, _ = jm.prefill(jp, {"tokens": toks}, max_len=128)

    tcfg = get_config(arch)
    port = quickstart.steps(
        get_model(tcfg),
        params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"),
        heads_from_jax(tcfg, jax.tree.map(np.asarray, jh), device="cpu"),
        torch.as_tensor(np.array(toks)))
    np.testing.assert_allclose(port["prefill_logits"].numpy(),
                               np.asarray(ref_logits), rtol=0, atol=TOL)
    assert port["decode_tokens"] == ref_decode
    assert port["accepted"] == ref_accepted
    assert port["n_accept"] == len(ref_accepted)


def test_quickstart_entry_point_on_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "speculative step: verified 8 tree nodes" in text
    assert len(out["decode_tokens"]) == quickstart.DECODE_STEPS
    assert out["launches"] == dict.fromkeys(dispatch.wrappers(), 0)
    assert bool(torch.isfinite(out["prefill_logits"]).all())
