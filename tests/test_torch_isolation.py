"""The port (``src/repro_torch``) stands alone: it imports with jax blocked,
no module of it imports jax, triton or the reference package, and its file
names leave the reference's reprolint kernel checks intact."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.core import Project, collect_files

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['triton'] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None\n"
        "             and k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(_modules()) >= 25


SLICE_MODULES = ["repro_torch.runtime.cache",
                 "repro_torch.kernels.paged_attention",
                 "repro_torch.kernels.tree_partial",
                 "repro_torch.kernels.launch",
                 "repro_torch.kernels.dispatch",
                 "repro_torch.runtime.engine"]


# the continuous-batching slice: row surgery and slot protocol (cache,
# engine, above), scheduler, faults, server, router, serve entry point
SERVING_MODULES = ["repro_torch.runtime.continuous",
                   "repro_torch.runtime.faults",
                   "repro_torch.runtime.server",
                   "repro_torch.runtime.router",
                   "repro_torch.launch.serve"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_paged_slice_module_imports_alone_with_jax_blocked(module):
    """Each module of the paged slice imports on its own in a fresh
    process where jax, the reference and triton cannot be imported, and
    builds nothing at import (no ``kernels/_build`` library is loaded)."""
    _imports_alone(module)


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_plane_module_imports_alone_with_jax_blocked(module):
    """The same for each module of the continuous-batching plane: it
    imports neither jax nor ``repro.runtime.scheduler`` (the port keeps its
    own copies of the host-only reference modules), starts no thread and
    builds nothing."""
    _imports_alone(module)


# ARCA and HCMP: the strategy search, the executor split, the walkthrough
ARCA_HCMP_MODULES = ["repro_torch.core.arca",
                     "repro_torch.core.hcmp.executors",
                     "repro_torch.launch.arca_profile"]


@pytest.mark.parametrize("module", ARCA_HCMP_MODULES)
def test_arca_hcmp_module_imports_alone_with_jax_blocked(module):
    """The same for ARCA and the HCMP executor split: neither imports
    ``repro.core.arca`` or the reference's executors, and importing one
    creates no stream and starts no thread."""
    _imports_alone(module)


# training: the optimizer, the steps, checkpoints and their entry points
TRAINING_MODULES = ["repro_torch.training.optimizer",
                    "repro_torch.training.train",
                    "repro_torch.training.checkpoint",
                    "repro_torch.launch.train",
                    "repro_torch.launch.e2e_train_serve"]


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_module_imports_alone_with_jax_blocked(module):
    """The same for the training slice: neither ``repro.training`` nor
    ml_dtypes is needed to read or write the reference's checkpoints."""
    _imports_alone(module)
    code = (f"import sys, importlib\nimportlib.import_module({module!r})\n"
            "assert 'ml_dtypes' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(SRC)),
                         timeout=120)
    assert res.returncode == 0, res.stderr


# the MoE, VLM and hybrid families: the MoE mix, Mamba2, recurrent verify,
# the Zamba2 stack, the model API and the transformer stack
FAMILY_MODULES = ["repro_torch.models.mlp",
                  "repro_torch.models.mamba2",
                  "repro_torch.models.recurrent_verify",
                  "repro_torch.models.hybrid",
                  "repro_torch.models.api",
                  "repro_torch.models.transformer"]


@pytest.mark.parametrize("module", FAMILY_MODULES)
def test_family_module_imports_alone_with_jax_blocked(module):
    """The same for the modules of the MoE, VLM and hybrid families:
    neither ``repro.models`` nor ``repro.runtime.cache`` is needed."""
    _imports_alone(module)


def _imports_alone(module):
    assert module in _modules()
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['triton'] = None\n"
        f"importlib.import_module({module!r})\n"
        "from repro_torch.kernels import build\n"
        "assert not build._loaded, build._loaded\n"
        "import threading\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None\n"
        "             and k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_port_module_imports_jax_triton_or_reference():
    banned = {"jax", "jaxlib", "triton", "repro"}
    hits = []
    for p in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            hits += [f"{p.relative_to(SRC)}:{node.lineno} {n}" for n in names
                     if n.split(".")[0] in banned]
    assert hits == [], hits


def test_reference_oracle_lookups_stay_unique():
    """reprolint R8 cross-checks the Pallas wrappers against
    ``kernels/ref.py`` through ``Project.find``, which returns None when
    two files match: the port must not add a second ``kernels/ref.py`` or
    ``kernels/ops.py``, nor a file R8 would take for a Pallas kernel."""
    project = Project(collect_files([SRC]))
    assert project.find("kernels/ref.py").rel == "repro/kernels/ref.py"
    assert project.find("kernels/ops.py").rel == "repro/kernels/ops.py"
    names = {p.name for p in PORT.rglob("*.py")}
    assert not names & {"tree_attention.py", "sparse_tree.py"}


def test_reference_scheduler_stays_the_one_model_checked():
    """reprolint R9 explores the scheduler protocol only when exactly one
    file ending in ``scheduler.py`` holds a ``ContinuousScheduler``: the
    port's scheduler lives in ``runtime/continuous.py``."""
    hits = [p.relative_to(SRC).as_posix() for p in SRC.rglob("*.py")
            if p.name.endswith("scheduler.py")
            and "class ContinuousScheduler" in p.read_text()]
    assert hits == ["repro/runtime/scheduler.py"]
    assert (PORT / "runtime" / "continuous.py").exists()
