"""Nothing the harness runs loads JAX or the JAX package (top-level module
names compared whole: ``repro_torch`` is not ``repro``), and ``run.py``
prints no result where it cannot measure."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import spec

ROOT = Path(spec.ROOT)
PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import testing
res = testing.run("qwen3-moe-30b-a3b.decode", seconds=1.0)
loaded = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "loaded": loaded}}))
"""


def clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "PYTHONPATH"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_a_whole_run_loads_neither_jax_nor_the_jax_package():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=clean_env(), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    loaded = set(res["loaded"])
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_forbidden_names_are_whole_names():
    import importlib.util
    spec_ = importlib.util.spec_from_file_location(
        "portbench_run_entry", ROOT / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    assert run.forbidden_modules(["repro_torch.runtime", "portbench",
                                  "reproducible", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                  "jaxlib.xla"]) == ["flax", "jax", "jaxlib",
                                                      "repro"]


def test_no_result_without_a_card(tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "mistral-7b.decode", "--seed", str(2 ** 31 + 5), "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         env=clean_env(), timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    # a checkout holding only the benchmark: no port, no result
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         env=clean_env(), timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
