"""The port's training path against the JAX reference on the same numpy
inputs and bridged weights (``qwen2-0.5b-smoke``, float32, CPU): AdamW,
``lm_loss`` and its grads (with and without remat), ``medusa_loss`` and
the heads' grads, three ``train_step`` / ``medusa_step`` trajectories,
``head_accuracies``; then the port's own loss-falls and heads-learn runs,
the train launcher, ``serve --ckpt/--heads-ckpt`` and the end-to-end
driver, all with ``--device cpu``.

Tolerances: AdamW fp32 1e-6 (bf16 equal or one bf16 ulp apart); losses
1e-5 relative; grads 2e-5 x the leaf's max |g| (the largest seen is
1.8e-6 x); three-step loss trajectories 1e-4 relative.  Parameters are not compared elementwise
after an Adam step: a near-zero grad whose sign differs flips that
element's first update by 2 lr.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.speculative import medusa as jmedusa
from repro.models.api import get_model as j_get_model
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch.bridge import heads_from_jax, params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.speculative import medusa as tmedusa
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.models.api import get_model as t_get_model
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen2-0.5b-smoke"
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
TRAJ_RTOL = 1e-4
_SETUP = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    if not _SETUP:
        cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
        jm, tm = j_get_model(cfg), t_get_model(tcfg)
        jp = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(0)))
        jh = jax.tree.map(np.array,
                          jmedusa.init_medusa(cfg, jax.random.PRNGKey(1)))
        data = MarkovDataset(cfg.vocab_size, seed=1)
        batches = list(data.batches(4, 32, 3))
        _SETUP.update(cfg=cfg, tcfg=tcfg, jm=jm, tm=tm, jp=jp, jh=jh,
                      batches=batches)
    s = _SETUP
    return (s["cfg"], s["tcfg"], s["jm"], s["tm"], s["jp"], s["jh"],
            s["batches"])


def _tp(tcfg, jp):
    return params_from_jax(tcfg, jp, device="cpu")


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_grads_close(tgrads, jgrads):
    for path, jg in _paths(jgrads):
        jg = np.asarray(jg, np.float32)
        tg = _get(tgrads, path).float().numpy()
        scale = float(np.max(np.abs(jg)))
        err = float(np.max(np.abs(tg - jg)))
        assert err <= GRAD_TOL * scale, (path, err, scale)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def _bf16_ulp_apart(a, b):
    """Elementwise distance in bf16 units of the last place."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    # map the sign-magnitude payload to a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFF), ib)
    return (ia - ib).abs()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_three_steps(dtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": {"c": (13,), "d": (3, 4, 2)}}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in s.items()}

    p0 = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: (rng.standard_normal(s) * 1e-2).astype(
        np.float32)) for _ in range(3)]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    tp = topt.tree_map(lambda a: torch.from_numpy(a).to(tdt), p0)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for g in grads:
        jp, js = jopt.adamw_update(jax.tree.map(
            lambda a: jnp.asarray(a, jdt), g), js, jp, lr=1e-2)
        before = topt.tree_map(torch.clone, tp)
        tp, ts = topt.adamw_update(topt.tree_map(
            lambda a: torch.from_numpy(a).to(tdt), g), ts, tp, lr=1e-2)
        for path, b in _paths(before):         # the caller's tree untouched
            assert _get(tp, path) is not b
    assert ts.step == int(js.step) == 3
    for path, jv in _paths(jp):
        tv = _get(tp, path)
        assert tv.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6,
                                       rtol=1e-6)
        else:
            jt = torch.from_numpy(np.array(jv).view(np.int16)).view(
                torch.bfloat16)
            assert int(_bf16_ulp_apart(tv, jt).max()) <= 1, path
    for tree_t, tree_j in ((ts.mu, js.mu), (ts.nu, js.nu)):
        for path, jv in _paths(tree_j):
            tv = _get(tree_t, path)
            assert tv.dtype == torch.float32
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# losses and grads
# --------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_reference(remat):
    cfg, tcfg, jm, tm, jp, jh, batches = _setup()
    cfg = dataclasses.replace(cfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    batch = dict(batches[0])
    batch["labels"] = batch["labels"].copy()
    batch["labels"][0, :5] = -100                      # ignored positions

    def jloss(p):
        return jtrain.lm_loss(cfg, jm, p, _jb(batch))

    fn = jax.checkpoint(jloss) if remat else jloss
    (jl, jce), jg = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    (tl, tce), tg = ttrain.lm_value_and_grad(tcfg, tm, _tp(tcfg, jp), batch)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert float(tce) == pytest.approx(float(jce), rel=LOSS_RTOL)
    _assert_grads_close(tg, jg)
    # the plain loss and the grad path's loss are one function
    tl2, _ = ttrain.lm_loss(tcfg, tm, _tp(tcfg, jp),
                            {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(tl2) == pytest.approx(float(tl), rel=1e-6)


def test_medusa_loss_and_head_grads_match_reference():
    cfg, tcfg, jm, tm, jp, jh, batches = _setup()
    batch = batches[1]
    jparams = jax.tree.map(jnp.asarray, jp)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda h: jtrain.medusa_loss(cfg, jm, jparams, h, _jb(batch))))(
        jax.tree.map(jnp.asarray, jh))
    tp, th = _tp(tcfg, jp), heads_from_jax(tcfg, jh, device="cpu")
    tl, tg = ttrain.medusa_value_and_grad(tcfg, tm, tp, th, batch)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _assert_grads_close(tg, jg)
    assert float(ttrain.medusa_loss(tcfg, tm, tp, th, batch)) == \
        pytest.approx(float(tl), rel=1e-6)
    assert all(not p.requires_grad for _, p in _paths(tp))


def test_train_step_trajectory_matches_reference():
    cfg, tcfg, jm, tm, jp, jh, batches = _setup()
    step = jax.jit(lambda p, o, b: jtrain.train_step(cfg, jm, p, o, b,
                                                     lr=3e-3))
    p, o = jax.tree.map(jnp.asarray, jp), None
    o = jopt.adamw_init(p)
    tparams = _tp(tcfg, jp)
    topt_state = topt.adamw_init(tparams)
    jl, tl = [], []
    for b in batches:
        p, o, jmet = step(p, o, _jb(b))
        tparams, topt_state, tmet = ttrain.train_step(
            tcfg, tm, tparams, topt_state, b, lr=3e-3)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)
    assert topt_state.step == 3


def test_medusa_step_trajectory_matches_reference():
    cfg, tcfg, jm, tm, jp, jh, batches = _setup()
    jparams = jax.tree.map(jnp.asarray, jp)
    step = jax.jit(lambda h, o, b: jtrain.medusa_step(cfg, jm, jparams, h,
                                                      o, b))
    h = jax.tree.map(jnp.asarray, jh)
    o = jopt.adamw_init(h)
    tp, th = _tp(tcfg, jp), heads_from_jax(tcfg, jh, device="cpu")
    ts = topt.adamw_init(th)
    jl, tl = [], []
    for b in batches:
        h, o, jmet = step(h, o, _jb(b))
        th, ts, tmet = ttrain.medusa_step(tcfg, tm, tp, th, ts, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)


def test_head_accuracies_equal_reference():
    cfg, tcfg, jm, tm, jp, jh, batches = _setup()
    data = MarkovDataset(cfg.vocab_size, seed=1)
    cal = [data.sample(2, 16, seed=100 + s)[:, :-1] for s in range(2)]
    want = jmedusa.head_accuracies(cfg, jm, jax.tree.map(jnp.asarray, jp),
                                   jax.tree.map(jnp.asarray, jh), cal)
    got = tmedusa.head_accuracies(tcfg, tm, _tp(tcfg, jp),
                                  heads_from_jax(tcfg, jh, device="cpu"), cal)
    assert got.shape == (tcfg.medusa_heads, tcfg.medusa_top_k)
    np.testing.assert_array_equal(got, want)


def test_head_accuracies_break_ties_toward_the_lower_index():
    """Tied logits rank in index order, as ``lax.top_k`` ranks them: heads
    whose logits are all equal put token k at rank k."""
    tcfg = t_get_config(ARCH)
    tm = t_get_model(tcfg)
    params = tm.init_params(torch.Generator().manual_seed(0))
    heads = tmedusa.init_medusa(tcfg, torch.Generator().manual_seed(1))
    heads["out"].zero_()
    H, K = tcfg.medusa_heads, tcfg.medusa_top_k
    toks = np.zeros((1, 8), np.int32)
    toks[0, 1::2] = 1                  # tokens 0 and 1 alternate
    accs = tmedusa.head_accuracies(tcfg, tm, params, heads, [toks])
    for h in range(H):
        tgt = toks[0, h + 2:]
        want = [float(np.mean(tgt == k)) for k in range(K)]
        np.testing.assert_array_equal(accs[h], want)


# --------------------------------------------------------------------------
# the port's own runs (tests/test_training.py's, on the port)
# --------------------------------------------------------------------------
def test_port_loss_decreases():
    tcfg = t_get_config("qwen2-0.5b").reduced()
    tm = t_get_model(tcfg)
    params = tm.init_params(torch.Generator().manual_seed(0))
    opt = topt.adamw_init(params)
    data = MarkovDataset(tcfg.vocab_size, seed=1)
    losses = []
    for batch in data.batches(8, 64, 30):
        params, opt, m = ttrain.train_step(tcfg, tm, params, opt, batch,
                                           lr=3e-3)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, \
        losses[:3] + losses[-3:]


def test_port_medusa_heads_learn():
    tcfg = t_get_config("qwen2-0.5b").reduced()
    tm = t_get_model(tcfg)
    params = tm.init_params(torch.Generator().manual_seed(0))
    heads = tmedusa.init_medusa(tcfg, torch.Generator().manual_seed(1))
    hopt = topt.adamw_init(heads)
    data = MarkovDataset(tcfg.vocab_size, seed=1)
    losses = []
    for batch in data.batches(8, 64, 60):
        heads, hopt, m = ttrain.medusa_step(tcfg, tm, params, heads, hopt,
                                            batch, lr=3e-3)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9


def test_prefill_reports_a_zero_aux_loss_and_keeps_no_cache():
    tcfg = t_get_config(ARCH)
    tm = t_get_model(tcfg)
    params = tm.init_params(torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 6), dtype=torch.int32)
    logits, extras, cache = tm.prefill(params, {"tokens": toks},
                                       return_cache=False)
    assert cache is None
    aux = extras["aux_loss"]
    assert aux.shape == () and aux.dtype == torch.float32
    assert float(aux) == 0.0
    assert extras["hidden"].shape == (2, 6, tcfg.d_model)


# --------------------------------------------------------------------------
# entry points on the CPU
# --------------------------------------------------------------------------
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def test_train_launcher_on_cpu_saves_a_restorable_checkpoint(tmp_path):
    from repro_torch.training import checkpoint
    path = str(tmp_path / "ck.npz")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16", "--save", path],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("[train] step    0 loss=")
    assert lines[1].startswith("[train] step    2 loss=")
    assert lines[-1] == f"[train] saved {path}"
    tcfg = t_get_config("qwen2-0.5b-smoke")
    like = t_get_model(tcfg).init_params(torch.Generator().manual_seed(0))
    restored = checkpoint.restore(path, like)
    changed = [not torch.equal(_get(restored, k), v) for k, v in _paths(like)]
    assert any(changed)                    # three steps moved the params


def test_train_launcher_without_gpu_fails_instead_of_running_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps", "1"],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "[train]" not in res.stdout


@pytest.mark.parametrize("mode", ["ghidorah", "sequential"])
def test_serve_restores_ckpt_and_heads_ckpt_on_cpu(mode, tmp_path):
    """``serve --ckpt/--heads-ckpt`` restores into the random weights
    before the engine is built: its tokens equal a serve of the saved
    weights held in memory (and differ from the random weights' serve)."""
    from repro_torch.launch import serve
    from repro_torch.training import checkpoint
    argv = ["--arch", "vicuna-7b-smoke", "--mode", mode, "--width", "8",
            "--tokens", "12", "--batch", "2", "--chunk", "4",
            "--prompt-len", "8", "--device", "cpu"]
    base = serve.load(serve.parse_args(argv), with_heads=True)
    params = base.model.init_params(torch.Generator().manual_seed(5))
    heads = tmedusa.init_medusa(base.cfg, torch.Generator().manual_seed(9))
    # strong heads and a skewed output so acceptance and tokens depend on
    # what is restored
    params["embed"][:, 0] = 1.0
    params["lm_head"][0, 7] += 4.0
    heads["out"][:, 0, 7] += 4.0
    checkpoint.save(str(tmp_path / "p.npz"), params)
    checkpoint.save(str(tmp_path / "h.npz"), heads)
    args = serve.parse_args(argv + ["--ckpt", str(tmp_path / "p.npz"),
                                    "--heads-ckpt", str(tmp_path / "h.npz")])
    got = serve.run(args)
    mem = serve.Loaded(cfg=base.cfg, model=base.model, params=params,
                       heads=heads if mode == "ghidorah" else None,
                       device=base.device)
    want = serve.run(serve.parse_args(argv), mem)
    rand = serve.run(serve.parse_args(argv))
    assert np.array_equal(got["out"], want["out"])
    assert not np.array_equal(got["out"], rand["out"])
    if mode == "ghidorah":
        assert got["stats"]["acceptance_length"] == \
            want["stats"]["acceptance_length"]


def test_e2e_driver_on_cpu_is_lossless():
    from repro_torch.launch import e2e_train_serve as e2e
    res = e2e.run(e2e.parse_args(["--device", "cpu", "--steps", "20",
                                  "--head-steps", "20", "--tokens", "16"]))
    assert res["match"]
    assert res["width"] in e2e.WIDTHS
    assert res["accs"].shape == (4, 4)
    assert res["acceptance_length"] >= 1.0
