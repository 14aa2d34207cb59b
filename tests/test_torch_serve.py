"""The port's serve entry point and ``chip_smoke.py`` on a machine without a
GPU: ``--device cpu`` serves and prints the reference's summary line; the
default device (cuda) and the chip smoke test fail loudly instead of
running on the CPU."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
SERVE = [sys.executable, "-m", "repro_torch.launch.serve"]
SMOKE = ["--arch", "qwen2-0.5b-smoke", "--tokens", "12", "--batch", "2",
         "--chunk", "4", "--prompt-len", "8"]


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


@pytest.mark.parametrize("flags", [
    ["--paged", "--tree-kernel", "auto"], ["--hcmp", "auto"],
    ["--hcmp", "overlap"], ["--arrivals", "poisson"], ["--spec-width", "4"],
    ["--ckpt", "x"], ["--heads-ckpt", "x"], ["--width", "0"],
    ["--spec-width", "auto"],
])
def test_later_slice_flags_exit_not_yet_ported(flags, capsys):
    from repro_torch.launch import serve
    argv = SMOKE + ["--device", "cpu", "--width", "8"] + flags
    with pytest.raises(SystemExit) as e:
        serve.parse_args(argv)
    assert e.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


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
