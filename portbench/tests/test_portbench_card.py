"""On the card: the fp8 control, put in the program's place at a cell's
own size, comes out not correct on three seeds while the program comes out
correct.  Run there with ``python3 -m pytest -m gpu portbench/tests``;
``calibrate.py`` reads the same numbers over a dozen seeds."""
import time

import pytest

from portbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    from portbench import cell as harness
    bench = spec.load_benchmark()
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        res = harness.run(bench, cell, seed, 15.0, False, "cuda",
                          time.perf_counter(), control=True)
        lim = {k: v["limit"] for k, v in res["checks"].items()}
        assert res["correct"], res["checks"]
        assert any(v > lim[k] for k, v in res["controls"].items()), \
            (res["controls"], lim)
