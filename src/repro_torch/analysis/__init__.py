"""torchlint: AST-based checks of the PyTorch/CUDA port's invariants (the
port's counterpart of ``repro/analysis``, with rules T1-T9 for R1-R9).

The reference's rules are written for JAX: jit purity, donation, pytree
registration, retraces, Pallas BlockSpecs.  The port keeps the same
invariants in its own idiom, and this package machine-checks them:

* **T1 capture purity**: nothing reachable from a captured CUDA-graph step
  syncs with the host or has a host side effect (a capture records device
  work only: Python runs once, at capture).
* **T2 in-place state**: a captured step keeps its carry in static
  buffers; a state field is never rebound inside it, every carry it
  produces is used, and no buffer is read after its graphs were released.
* **T3 host-sync budget**: one ``torch.cat(...).cpu()`` per chunk in the
  runtime's hot functions; no ``time.time()`` in measured intervals.
* **T4 lock and thread discipline** of the serving plane (as R4).
* **T5 walker completeness**: the graphs' state walker names every field
  of every dataclass it maps; a dataclass built in a captured step is one
  it handles.
* **T6 slot-protocol conformance** against ``runtime/continuous.py``.
* **T7 capture hygiene**: no graph, graph cache, launch-plan cache or
  ``torch.compile`` built in a loop or a hot method; a graph key holds
  hashable host data only.
* **T8 launch bounds** of the CUDA grids (``launchbounds.py``) and the
  wrappers' signatures against their plain versions.
* **T9 boundary protocol** of the scheduler (``modelcheck.py``).

Run it with::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch

The rules are stdlib-only (``ast``): they import nothing of the code under
analysis, and nothing of ``repro``.
"""
from repro_torch.analysis.core import Finding, lint_paths, load_baseline  # noqa: F401
