"""Run one cell of ``BENCHMARK.json`` once, on the card this process sees:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the run's checks on standard error and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number and its limit).

Exits non-zero, printing no result, without a CUDA card, when the port
(``src/repro_torch``) is not beside this folder, or when JAX or the JAX
package was loaded.  Kernel builds stay inside the checkout: the port's
``src/repro_torch/kernels/_build/`` and ``portbench/.cache/triton``.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's (whole names: ``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / ".cache"
                                         / "triton")
    # the package by its name, never this folder's files as top-level ones
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]
    import torch
    import repro_torch  # noqa: F401  (the system under test must be here)
    from portbench import cell, spec
    bench = spec.load_benchmark(ROOT)
    w = spec.workload(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"portbench: {args.workload} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = cell.run(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_PROC)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}: the benchmark runs without JAX "
              f"and the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
