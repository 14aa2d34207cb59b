"""The port's analytic harness tables (``repro_torch.benchmarks``: Table I,
Fig. 9, Fig. 10a, the ablations) against the reference's scripts in the
repository's ``benchmarks/`` (loaded with the repository root on
``sys.path``, as ``benchmarks/run.py`` does): every figure within 1e-9
relative.  Numpy on both sides: no device is involved."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import ablations as r_abl  # noqa: E402
from benchmarks import acceptance as r_acc  # noqa: E402
from benchmarks import partitioning as r_part  # noqa: E402
from benchmarks import throughput as r_thr  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core import arca as r_arca  # noqa: E402
from repro.core.speculative import tree as RT  # noqa: E402
from repro_torch.benchmarks import ablations, acceptance  # noqa: E402
from repro_torch.benchmarks import partitioning, throughput  # noqa: E402
from repro_torch.benchmarks.benchlib import PAPER_MBPP_AL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import arca  # noqa: E402
from repro_torch.core.speculative import tree as TT  # noqa: E402

RTOL = 1e-9
_FITS = {}


def _fits():
    """(reference fit, port fit), computed once."""
    if not _FITS:
        _FITS["ref"] = r_acc.fit_accs()
        _FITS["port"] = acceptance.fit_accs()
    return _FITS["ref"], _FITS["port"]


def test_paper_constants_copied():
    from repro.benchlib import PAPER_MBPP_AL as ref_al
    assert PAPER_MBPP_AL == ref_al
    assert acceptance.PAPER == r_acc.PAPER
    assert acceptance.WIDTHS == r_acc.WIDTHS
    assert throughput.WIDTHS == r_thr.WIDTHS
    assert partitioning.CTXS == r_part.CTXS
    assert partitioning.WIDTH == r_part.WIDTH


def test_estimator_curve_equals_reference():
    accs = RT.default_accs(5, 10)
    np.testing.assert_allclose(
        acceptance.estimator_curve(TT.default_accs(5, 10)),
        r_acc.estimator_curve(accs), rtol=RTOL, atol=0)


def test_fit_accs_equals_reference():
    (r_accs, r_params, r_err), (accs, params, err) = _fits()
    np.testing.assert_allclose(accs, r_accs, rtol=RTOL, atol=0)
    np.testing.assert_allclose(params, r_params, rtol=RTOL, atol=0)
    assert err == pytest.approx(r_err, rel=RTOL)
    np.testing.assert_allclose(acceptance.estimator_curve(accs),
                               r_acc.estimator_curve(r_accs), rtol=RTOL,
                               atol=0)


def _table_equal(port, ref):
    assert list(port) == list(ref)
    for w in ref:
        assert set(port[w]) == set(ref[w])
        for k in ref[w]:
            assert port[w][k] == pytest.approx(ref[w][k], rel=RTOL), (w, k)


def _socs():
    """The Jetson model and one variant of it, on both sides."""
    out = [(arca.JETSON_NX, r_arca.JETSON_NX)]
    kw = dict(contention=1.15, em_ratio_err=0.06)
    port = dataclasses.replace(
        arca.JETSON_NX, units=(dataclasses.replace(arca.JETSON_NX.gpu,
                                                   gemm_eff=0.8, bw_frac=0.4),
                               arca.JETSON_NX.cpu), **kw)
    ref = dataclasses.replace(
        r_arca.JETSON_NX, units=(dataclasses.replace(r_arca.JETSON_NX.gpu,
                                                     gemm_eff=0.8,
                                                     bw_frac=0.4),
                                 r_arca.JETSON_NX.cpu), **kw)
    return out + [(port, ref)]


@pytest.mark.parametrize("al_row", [None, PAPER_MBPP_AL])
def test_systems_table_equals_reference(al_row):
    (r_accs, _, _), (accs, _, _) = _fits()
    for soc, r_soc in _socs():
        _table_equal(
            throughput.systems_table(soc, get_config("vicuna-7b"), accs,
                                     al_row=al_row),
            r_thr.systems_table(r_soc, r_get_config("vicuna-7b"), r_accs,
                                al_row=al_row))


def test_calibrate_equals_reference():
    (r_accs, _, _), (accs, _, _) = _fits()
    soc, err = throughput.calibrate(get_config("vicuna-7b"), accs)
    r_soc, r_err = r_thr.calibrate(r_get_config("vicuna-7b"), r_accs)
    assert err == pytest.approx(r_err, rel=RTOL)
    for port_u, ref_u in zip(soc.units, r_soc.units):
        assert dataclasses.asdict(port_u) == dataclasses.asdict(ref_u)
    assert (soc.dram_bw, soc.sync_latency, soc.contention,
            soc.em_ratio_err) == (r_soc.dram_bw, r_soc.sync_latency,
                                  r_soc.contention, r_soc.em_ratio_err)


def test_attn_times_every_ctx_equals_reference():
    spec = TT.build_tree(TT.default_accs(5, 10), partitioning.WIDTH)
    r_spec = RT.build_tree(RT.default_accs(5, 10), r_part.WIDTH)
    assert np.array_equal(spec.mask, r_spec.mask)
    cfg, r_cfg = get_config("vicuna-7b"), r_get_config("vicuna-7b")
    for ctx in partitioning.CTXS:
        np.testing.assert_allclose(
            partitioning.attn_times(arca.JETSON_NX, cfg, ctx, spec),
            r_part.attn_times(r_arca.JETSON_NX, r_cfg, ctx, r_spec),
            rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", ["tree_refinement_ablation",
                                  "contention_ratio_ablation",
                                  "width_vs_scale_ablation"])
def test_ablation_rows_equal_reference(name, capsys):
    port = getattr(ablations, name)()
    ref = getattr(r_abl, name)()
    printed = capsys.readouterr().out
    assert [r[0] for r in port] == [r[0] for r in ref]
    np.testing.assert_allclose([r[1] for r in port], [r[1] for r in ref],
                               rtol=RTOL, atol=0)
    # the printed tables agree line for line but for the Jetson labels
    lines = [x for x in printed.splitlines() if x and x[0].isdigit()]
    half = len(lines) // 2
    assert lines[:half] == lines[half:]
