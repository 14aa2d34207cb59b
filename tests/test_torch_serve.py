"""The port's serve entry point and ``chip_smoke.py`` on a machine without a
GPU: ``--device cpu`` serves and prints the reference's summary line, for
the fixed batch and for the arrival replay (continuous, static, and the
router with injected faults); the default device (cuda) and the chip smoke
test fail loudly instead of running on the CPU."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
SERVE = [sys.executable, "-m", "repro_torch.launch.serve"]
SMOKE = ["--arch", "qwen2-0.5b-smoke", "--tokens", "12", "--batch", "2",
         "--chunk", "4", "--prompt-len", "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cmd, cwd=ROOT):
    return subprocess.run(cmd, capture_output=True, text=True, env=ENV,
                          cwd=cwd, timeout=300)


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")


@pytest.mark.parametrize("mode,line", [
    ("ghidorah", r"\[serve\] ghidorah: 24 tokens \(2 seq x chunk 4\) in "
                 r"[\d.]+s \([\d.]+ tok/s\), acceptance length [\d.]+ over "
                 r"\d+ seq-steps"),
    ("sequential", r"\[serve\] sequential: 24 tokens \(2 seq x chunk 4\) in "
                   r"[\d.]+s \([\d.]+ tok/s\)"),
])
def test_serve_on_cpu_prints_the_reference_summary(mode, line):
    res = _run(SERVE + SMOKE + ["--mode", mode, "--width", "8",
                                "--device", "cpu"])
    assert res.returncode == 0, res.stderr
    assert re.fullmatch(line, res.stdout.strip()), res.stdout


def test_serve_without_gpu_fails_instead_of_running_on_cpu():
    _no_gpu()
    res = _run(SERVE + SMOKE + ["--mode", "sequential"])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "[serve]" not in res.stdout


@pytest.mark.parametrize("flags", [["--ckpt", "x"], ["--heads-ckpt", "x"]])
def test_later_slice_flags_exit_not_yet_ported(flags, tmp_path):
    """The checkpoint flags exited "not yet ported" until training was
    ported: they now parse, and ``load`` restores from them before any
    engine is built, so a missing file fails there."""
    from repro_torch.launch import serve
    argv = SMOKE + ["--device", "cpu", "--width", "8"] + flags
    argv[-1] = str(tmp_path / "missing.npz")
    args = serve.parse_args(argv)
    assert (args.ckpt or args.heads_ckpt) == argv[-1]
    with pytest.raises(FileNotFoundError):
        serve.load(args)


# the ARCA and HCMP flags, each with a line of the run's report
ARCA_HCMP_RUNS = {
    "tree kernel auto": (["--paged", "--tree-kernel", "auto"],
                         r"\[serve\] measured tree kernel: (dense|sparse) "),
    "hcmp auto": (["--hcmp", "auto"],
                  r"\[serve\] measured partition: (inline|overlap) "),
    "hcmp overlap": (["--hcmp", "overlap"],
                     r"\[serve\] hcmp overlap gate: parity OK; predraft "
                     r"hits \d+ / discards 0 over \d+ chunks on 1 "
                     r"executor\(s\)"),
    "spec width auto": (["--arrivals", "poisson", "--rate", "50",
                         "--requests", "4", "--spec-width", "auto"],
                        r"\[serve\] measured ARCA: start width=\d+ "),
    "spec width 4": (["--spec-width", "4"], r"\[serve\] ghidorah: 24 "),
    "width 0": (["--width", "0"], r"\[serve\] ARCA chose width=\d+ "),
}


@pytest.mark.parametrize("label", list(ARCA_HCMP_RUNS))
def test_arca_and_hcmp_flags_run_on_cpu(label, capsys):
    """Each flag of ARCA and HCMP parses and serves at smoke size on the
    CPU: every row or request emits its full budget, and the run prints
    the reference's line for its choice."""
    from repro_torch.launch import serve
    flags, line = ARCA_HCMP_RUNS[label]
    argv = SMOKE + ["--device", "cpu"] + flags
    if "--width" not in flags:
        argv += ["--width", "8"]
    res = serve.run(serve.parse_args(argv))
    assert re.search(line, capsys.readouterr().out)
    if "results" in res:
        assert all(r.state == "DONE" and r.n_emitted == 12
                   for r in res["results"])
    else:
        assert (res["stats"]["n_emitted"] == 12).all()
    if label == "spec width 4":
        assert res["engines"][0].strategy.width == 4
    if label == "hcmp overlap":
        np.testing.assert_array_equal(res["out"], res["inline"]["out"])
        assert res["inline"]["engine"].hcmp == "inline"


@pytest.mark.parametrize("flags,why", [
    (["--spec-width", "auto"], "--spec-width auto needs --arrivals poisson "
                               "--sched continuous"),
    (["--arrivals", "poisson", "--sched", "static", "--spec-width", "auto"],
     "--spec-width auto needs --arrivals poisson --sched continuous"),
    (["--mode", "sequential", "--hcmp", "overlap"], "ghidorah option"),
    (["--mode", "sequential", "--spec-width", "4"], "ghidorah option"),
    (["--spec-width", "0"], "--spec-width must be 'auto' or a width >= 1"),
])
def test_arca_and_hcmp_flag_errors_match_the_reference(flags, why, capsys):
    from repro_torch.launch import serve
    argv = SMOKE + ["--device", "cpu", "--width", "8"] + flags
    with pytest.raises(SystemExit) as e:
        serve.parse_args(argv)
    assert e.value.code != 0
    assert why in capsys.readouterr().err


def test_width_0_picks_the_reference_arca_width(capsys):
    """``--width 0``: the analytic ARCA choice on the Jetson model, the
    same width (and tree) as the reference's ``arca.best(choose_strategy)``
    at the serve's prompt length."""
    from repro.configs import get_config
    from repro.core import arca
    from repro.core.speculative import tree as T
    from repro_torch.launch import serve
    args = serve.parse_args(SMOKE + ["--device", "cpu", "--width", "0"])
    cfg = get_config(args.arch)
    want = arca.best(arca.choose_strategy(
        cfg, T.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
        ctx=args.prompt_len))
    eng, adaptive = serve.prepare(args, serve.load(args))
    assert adaptive is None
    assert eng.strategy.width == want.width
    np.testing.assert_array_equal(eng.strategy.tree.parent.numpy(),
                                  want.tree.parent)
    assert f"[serve] ARCA chose width={want.width} " in \
        capsys.readouterr().out


@pytest.mark.parametrize("flags,why", [
    (["--kv-dtype", "int8"], "add --paged"),
    (["--tree-kernel", "sparse"], "add --paged"),
    (["--paged", "--tree-kernel", "sparse", "--mode", "sequential"],
     "ghidorah option"),
    (["--paged", "--page-size", "0"], "--page-size must be >= 1"),
    (["--paged", "--pool-pages", "-1"], "--pool-pages must be >= 0"),
])
def test_paged_flag_errors_match_the_reference(flags, why, capsys):
    from repro_torch.launch import serve
    argv = SMOKE + ["--device", "cpu", "--width", "8"] + flags
    with pytest.raises(SystemExit) as e:
        serve.parse_args(argv)
    assert e.value.code != 0
    assert why in capsys.readouterr().err


_DENSE = {}


@pytest.mark.parametrize("mode,flags", [
    ("ghidorah", ["--paged"]),
    ("ghidorah", ["--paged", "--kv-dtype", "int8"]),
    ("ghidorah", ["--paged", "--kv-dtype", "int8", "--tree-kernel",
                  "sparse"]),
    ("ghidorah", ["--paged", "--kv-dtype", "bf16", "--page-size", "4"]),
    ("sequential", ["--paged", "--kv-dtype", "int8", "--pool-pages", "6"]),
])
def test_paged_serve_on_cpu_emits_the_full_budget(mode, flags):
    """The paged serve on the CPU (plain PyTorch attention) emits every
    row's budget; a float pool in the model's dtype emits the dense
    serve's tokens."""
    from repro_torch.launch import serve
    argv = SMOKE + ["--device", "cpu", "--width", "8", "--mode", mode]
    if mode not in _DENSE:
        _DENSE[mode] = serve.run(serve.parse_args(argv))
    res = serve.run(serve.parse_args(argv + flags))
    assert res["stats"]["emitted_total"] == 2 * 12
    assert (res["stats"]["n_emitted"] == 12).all()
    if flags == ["--paged"]:
        assert (res["out"] == _DENSE[mode]["out"]).all()


def test_chip_smoke_fails_without_gpu_and_outside_a_checkout(tmp_path):
    _no_gpu()
    res = _run([sys.executable, str(ROOT / "chip_smoke.py")])
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "needs an NVIDIA GPU" in res.stderr
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "checkout" in res.stderr


REPLAY = ["--arch", "vicuna-7b-smoke", "--device", "cpu", "--mode",
          "ghidorah", "--width", "8", "--paged", "--page-size", "4",
          "--batch", "4", "--prompt-len", "24", "--tokens", "12", "--chunk",
          "8", "--arrivals", "poisson", "--rate", "50", "--requests", "12"]


@pytest.mark.parametrize("flags,label", [
    (["--sched", "continuous", "--prefill-chunk", "8"], "continuous/fifo+pc8"),
    (["--sched", "continuous", "--policy", "sjf", "--kv-dtype", "int8"],
     "continuous/sjf"),
    (["--sched", "static"], "static"),
])
def test_replay_on_cpu_serves_every_request_and_drains(flags, label,
                                                        capsys):
    """The in-process replay: every request DONE with its full budget,
    the reference's summary line, and the engine's pool conserved and
    drained (the static baseline reserves per ``generate``, so its
    scheduler pool stays untouched)."""
    from repro_torch.launch import serve
    res = serve.run(serve.parse_args(REPLAY + flags))
    out = capsys.readouterr().out
    assert re.search(rf"\[serve\] {re.escape(label)} x12 reqs \(poisson rate "
                     rf"50.0/s, B=4\): 144 tokens in [\d.]+s", out), out
    assert all(r.state == "DONE" and r.n_emitted == 12
               for r in res["results"])
    eng = res["engines"][0]
    assert eng.sched_pool_conserved() and eng.sched_drained()
    if "--prefill-chunk" in flags:
        assert res["stats"]["extend_pieces"] == 12 * 2     # 23 = 8 + 8 + 7
    assert res["stats"]["device_steps"] > 0


def test_router_replay_with_faults_exits_zero_and_drains():
    """``--replicas 2 --inject-faults``: r0 crashes at its 6th boundary,
    its requests retry on r1; the run exits 0 only when every request is
    terminal and every replica's pool drained."""
    res = _run(SERVE + REPLAY + ["--replicas", "2", "--inject-faults", "3"])
    assert res.returncode == 0, res.stderr
    assert re.search(r"\[serve\] router x12 reqs over 2 replica\(s\) "
                     r"\(faults on\): 144 tokens .*states \{'DONE': 12\}.*"
                     r"pages drained: True", res.stdout), res.stdout


@pytest.mark.parametrize("flags,why", [
    (["--replicas", "2"], "need --arrivals poisson --sched continuous"),
    (["--arrivals", "poisson", "--sched", "static", "--inject-faults", "1"],
     "need --arrivals poisson --sched continuous"),
    (["--arrivals", "poisson", "--rate", "0"], "--rate must be > 0"),
    (["--prefill-chunk", "-1"], "--prefill-chunk must be >= 0"),
    (["--cancel-rate", "2"], "--cancel-rate must be in [0, 1]"),
])
def test_replay_flag_errors_match_the_reference(flags, why, capsys):
    from repro_torch.launch import serve
    argv = SMOKE + ["--device", "cpu", "--width", "8"] + flags
    with pytest.raises(SystemExit) as e:
        serve.parse_args(argv)
    assert e.value.code != 0
    assert why in capsys.readouterr().err
