"""The launch-bounds model of the port's CUDA grids (``repro_torch/
analysis/launchbounds.py``, rule T8).

* Its configurations cover the reference's ``kernelbounds.CONFIGS``
  shapes and, handed in by ``chip_smoke.launch_shapes``, the smoke's
  main-path and split-edge shapes, and every modelled launch of B1-B5 is
  exercised.
* Over that matrix every block is in bounds, every output tiled once and
  every page read in its row (``verify`` is empty).
* Seeded faults are caught: an off-by-one in a grid model, a launch
  constant changed in the ``.cu`` and not in the model, a grid expression
  changed in the ``.cu``, a page walk into another row's table entries.
"""
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import kernelbounds as kb
from repro_torch.analysis import launchbounds as lb

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
try:
    import chip_smoke
finally:
    sys.path.remove(str(ROOT))
# the configuration matrix with the smoke's shapes
SHAPES = lb.shapes(chip_smoke.launch_shapes(np))
# a few shapes that reach every launch, for the seeded faults
SMALL = [s for s in SHAPES
         if s[0].desc.startswith(("reference", "chip main verify",
                                  "chip main paged verify"))]


def test_configurations_cover_the_references_and_the_chip_shapes():
    ref = {k: [c.env for c in v] for k, v in kb.CONFIGS.items()}
    dense = [(e["B"], e["W"], e["Hq"], e["Hkv"], e["hd"], e["S"])
             for e in ref["tree_attention"]]
    assert lb.REFERENCE_DENSE == dense
    for name in ("paged_tree_attention", "paged_cache_attention"):
        paged = [(e["B"], e["W"], e["Hq"], e["Hkv"], e["hd"], e["ps"],
                  e["P"], c.table) for e, c in zip(ref[name],
                                                   kb.CONFIGS[name])]
        assert lb.REFERENCE_PAGED == paged
    for name in ("sparse_tree_attention", "sparse_tree_attention_partial"):
        assert lb.REFERENCE_SPARSE == [(e["B"], e["W"], e["Hq"], e["Hkv"],
                                        e["hd"]) for e in ref[name]]
    descs = [s.desc for s, _ in SHAPES]
    for label, _ in chip_smoke.main_shapes(np):
        assert f"chip main {label}" in descs
        assert f"chip main paged {label}" in descs
    for label in chip_smoke.SPLIT_EDGE:
        assert f"chip split edge {label}" in descs
        assert f"chip split edge paged {label}" in descs
    assert set(lb.launch_names(SHAPES)) == set(lb.C_LAUNCHES)


def test_every_block_in_bounds_over_the_matrix():
    assert lb.verify(SHAPES) == []


def test_a_seeded_off_by_one_in_a_grid_model_is_caught(monkeypatch):
    real = lb._row_blocks

    def short(s, rows, x, y):                 # the last row of each tile
        b, h, r0, nr = real(s, rows, x, y)    # is dropped
        return b, h, r0, nr - 1
    monkeypatch.setattr(lb, "_row_blocks", short)
    errs = lb.verify(SMALL, cards=[(132, 2)])
    assert any("never written" in e for e in errs), errs[:3]

    monkeypatch.setattr(lb, "_row_blocks", real)
    grid = lb._tree_kernel

    def one_tile_short(s, name, kernel, threads, rows, norm):
        out = grid(s, name, kernel, threads, rows, norm)
        out.grid = (out.grid[0], out.grid[1] - 1, 1)
        return out
    monkeypatch.setattr(lb, "_tree_kernel", one_tile_short)
    errs = lb.verify(SMALL, cards=[(132, 2)])
    assert any("the C source launches grid" in e for e in errs), errs[:3]


def test_a_page_walk_into_another_row_is_caught(monkeypatch):
    real = lb._slot_reads

    def next_row(s, b, h, jb, je):
        return real(s, (b + 1) % s.B if s.paged else b, h, jb, je)
    monkeypatch.setattr(lb, "_slot_reads", next_row)
    paged = [x for x in SMALL if x[0].paged and x[0].B > 1]
    errs = lb.verify(paged, cards=[(132, 2)])
    assert any("outside row" in e for e in errs), errs[:3]


def _copy_kernels(tmp_path):
    src = ROOT / "src" / "repro_torch" / "kernels"
    dst = tmp_path / "kernels"
    shutil.copytree(src / "csrc", dst / "csrc")
    shutil.copy(src / "plan.py", dst / "plan.py")
    return dst


def test_a_launch_constant_changed_in_the_source_is_caught(tmp_path):
    k = _copy_kernels(tmp_path)
    assert lb.verify(SMALL, csrc=k / "csrc", kernels=k,
                     cards=[(132, 2)]) == []
    cu = k / "csrc" / "tree_partial.cu"
    text = cu.read_text()
    assert "constexpr int kWarpRows = 8;" in text
    cu.write_text(text.replace("constexpr int kWarpRows = 8;",
                               "constexpr int kWarpRows = 16;"))
    errs = lb.verify(SMALL, csrc=k / "csrc", kernels=k, cards=[(132, 2)])
    assert any("`kWarpRows` is 16 in C, 8 in the launch-bounds model" in e
               for e in errs), errs[:3]
    assert any("WARP_ROWS" in e for e in errs)
    assert any("`B4 warp`" in e and "the C source launches grid" in e
               for e in errs)


def test_a_grid_expression_changed_in_the_source_is_caught(tmp_path):
    k = _copy_kernels(tmp_path)
    cu = k / "csrc" / "verify_attention.cu"
    text = cu.read_text()
    old = "(GW + flash::kRows - 1) / flash::kRows"
    assert old in text
    cu.write_text(text.replace(old, "GW / flash::kRows"))
    errs = lb.verify(SMALL, csrc=k / "csrc", kernels=k, cards=[(132, 2)])
    assert any("`B1 flash`" in e and "the C source launches grid" in e
               for e in errs), errs[:3]
    assert lb.check_constants(k / "csrc", k) == []


def test_t8_anchors_model_findings_at_the_wrapper(tmp_path, monkeypatch):
    from repro_torch.analysis import rules_launchbounds as rl
    from repro_torch.analysis.core import lint_paths
    monkeypatch.setattr(rl, "_verified", lambda kernels: [
        "`B3 flash` [x]: block (0, 0, 1) reads table[9:10] outside"])
    found = lint_paths([ROOT / "src" / "repro_torch"], rules=["T8"])
    assert [(f.path, f.rule) for f in found] == [
        ("kernels/paged_attention.py", "T8")]
    src = (ROOT / "src/repro_torch/kernels/paged_attention.py").read_text()
    assert src.splitlines()[found[0].line - 1].startswith(
        "def paged_cache_attention(")


@pytest.mark.parametrize("name", sorted(lb.C_LAUNCHES))
def test_each_modelled_launch_is_found_in_its_source(name):
    src, kernel = lb.C_LAUNCHES[name]
    hits = [c for c in lb.read_launches() if c.file == src
            and c.kernel == kernel]
    assert hits, (src, kernel)
