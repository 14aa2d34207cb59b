"""The host time of one B4 call (``sparse_tree_attention_partial``, the tree
half of ``--tree-kernel sparse``) in several checkouts of the port, on one
card in one run, so two versions are compared like for like.

    python3 tools/b4_host_ab.py PARENT . PARENT . . PARENT . PARENT

Each argument is the root of a checkout (``src/repro_torch`` under it); each
is measured in a process of its own, in the order given (alternating
parent and change spreads a drift of the host over both), and builds its own
kernels from its sources.  At the main path's W=8 (B=4, Hq=Hkv=32, hd=128,
bf16, the serve's tree, the 4 input sets of ``chip_smoke.phase_partial``)
a process holds the call against the plain version, then times the call
and the efficient-attention call with its log-sum-exp (the kernel table's
library call) three ways:

* ``host_one_window``: the host's clock around one window of 50 calls
  after 5 (``chip_smoke.host_ms``, the kernel table's ``host_ms``);
* ``host_alternating``: the median of 21 windows of 100 calls, the two
  calls' windows taken in turns (``chip_smoke.alternating_ms``), and
  their ratio (``host_ratio``: the library call runs the same code in
  every checkout, so the ratio takes out how fast the host ran);
* ``call_ms``: CUDA events around 50 calls (``chip_smoke.timed``).

Each process prints one JSON line; the last line is the list of them.  It
needs a CUDA card and exits non-zero without one.
"""
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
WINDOWS = 21


def child(root):
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import plain
    from repro_torch.kernels import tree_partial as tp
    if not Path(tp.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {tp.__file__}, not from {root}")
    sys.path.append(str(HERE))
    import chip_smoke as cs
    card = cs.phase_device(torch)
    kw = dict(cs.sparse_case_list(np))["main W=8"]
    sets = [cs.sparse_inputs(torch, np, seed=500 + r, **kw) for r in range(4)]
    err = cs._hold(torch, "sparse_tree_attention_partial", "main W=8",
                   tp.sparse_tree_attention_partial(*sets[0]),
                   plain.sparse_tree_attention_partial_plain(*sets[0]),
                   cs.TOL[str(sets[0][0].dtype)])
    lib_sets = [cs.lse_inputs(torch, dict(zip(("q", "k_new", "v_new",
                                               "tree_mask"), a)), cache=False)
                for a in sets]

    def call(a):
        return tp.sparse_tree_attention_partial(*a)

    def library(a):
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            a[0], a[1], a[2], a[3], True)

    out = dict(root=str(root), card=card, max_abs_err=err)
    for name, fn, s in (("call", call, sets), ("library", library, lib_sets)):
        out[name] = dict(host_one_window=cs.host_ms(torch, fn, s),
                         call_ms=cs.timed(torch, fn, s))
    alt = cs.alternating_ms(torch, [lambda i: call(sets[i % 4]),
                                    lambda i: library(lib_sets[i % 4])],
                            windows=WINDOWS)
    out["call"]["host_alternating"], out["library"]["host_alternating"] = alt
    out["host_ratio"] = alt[0] / alt[1]
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--child"]:
        return child(Path(argv[1]).resolve())
    if not argv:
        raise SystemExit(__doc__)
    rows = []
    for root in argv:
        run = subprocess.run([sys.executable, __file__, "--child", root],
                             capture_output=True, text=True, timeout=900)
        sys.stdout.write(run.stdout)
        sys.stderr.write(run.stderr)
        if run.returncode != 0:
            raise SystemExit(f"{root}: exit {run.returncode}")
        rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
    print(json.dumps(rows))


if __name__ == "__main__":
    main(sys.argv[1:])
