"""The Mamba2 prefill's two depthwise convs and its per-rank SSD chunk
(``repro_torch/models/mamba2.py``).

* On one device: the x and the B/C channels convolved apart equal one
  depthwise conv over their concatenation (the layout the reference's
  fused conv and the recurrent state's tail ``(B, K-1, di + 2N)`` keep),
  and the chunked prefill still equals its time scan.
* On the fake (16, 16) mesh at full width and one layer
  (``zamba2-7b`` ``train_4k``, the dry run's case): the x channels reach
  the SSD split over ``model`` (by heads) and the batch over ``data``, B/C
  whole on ``model``; the ``in_x`` and ``conv_wx`` gradients come back
  split over ``model`` like their parameters, never whole on every rank.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch import cases
from repro_torch.launch import mesh as tmesh
from repro_torch.models import mamba2 as mb
from repro_torch.models.api import get_model
from repro_torch.training.train import lm_value_and_grad


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    tmesh.release_fake_group()


def _smoke(seed=0):
    cfg = get_config("zamba2-7b-smoke")
    cfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    p = mb.mamba_init(cfg, gen)
    for k in ("conv_bx", "conv_bbc"):
        p[k] = torch.randn(p[k].shape, generator=gen)
    return cfg, p, gen


def test_two_convs_equal_one_conv_over_the_concatenation():
    cfg, p, gen = _smoke()
    di, _, _, N = mb.dims(cfg)
    B, S, K = 2, 9, cfg.ssm_conv
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    state = mb.init_state(cfg, B, dtype=torch.float32, device="cpu")
    state["conv"] = torch.randn(state["conv"].shape, generator=gen)
    z, x_c, bc_c, dt_raw, tail = mb._conv_prefill(cfg, p, x, state)
    # the fused conv: one depthwise conv over cat(x, bc)
    xbc = torch.cat([x @ p["in_x"], x @ p["in_bc"]], dim=-1)
    hist = torch.cat([state["conv"], xbc], dim=1)
    w = torch.cat([p["conv_wx"], p["conv_wbc"]], dim=-1)
    b = torch.cat([p["conv_bx"], p["conv_bbc"]], dim=-1)
    wins = torch.stack([hist[:, i:i + S] for i in range(K)], dim=2)
    want = F.silu(torch.einsum("bskc,kc->bsc", wins, w) + b)
    torch.testing.assert_close(x_c, want[..., :di], rtol=0, atol=0)
    torch.testing.assert_close(bc_c, want[..., di:], rtol=0, atol=0)
    torch.testing.assert_close(tail, hist[:, -(K - 1):], rtol=0, atol=0)
    assert tail.shape == (B, K - 1, di + 2 * N)
    torch.testing.assert_close(z, x @ p["in_z"])
    torch.testing.assert_close(dt_raw, x @ p["in_dt"])


def test_chunked_prefill_still_equals_the_scan():
    cfg, p, gen = _smoke(1)
    x = torch.randn((2, 11, cfg.d_model), generator=gen)
    out, st = mb.mamba_prefill(cfg, p, x, chunk=4)
    ref, rst = mb._mamba_prefill_scan(
        cfg, p, x, mb.init_state(cfg, 2, dtype=torch.float32,
                                 device="cpu"))
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(st["ssm"], rst["ssm"], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(st["conv"], rst["conv"], rtol=0, atol=0)


def test_x_channels_stay_split_to_the_ssd_and_in_x_grad_stays_sharded(
        monkeypatch):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    seen = []
    real = mb._ssd_chunk_split

    def spy(p, x_c, bc_c, dt_raw, S0):
        seen.append((tuple(x_c.placements), tuple(bc_c.placements)))
        return real(p, x_c, bc_c, dt_raw, S0)

    monkeypatch.setattr(mb, "_ssd_chunk_split", spy)
    cfg = cases.shallow_clone(get_config("zamba2-7b"), 1, with_site=True)
    mesh = tmesh.make_production_mesh(device_type="cpu")
    with FakeTensorMode():
        case = cases.build_case("zamba2-7b", "train_4k", mesh,
                                cfg_override=cfg, device="cpu")
        params, _, batch = case["args"]
        with implicit_replication():
            _, grads = lm_value_and_grad(cfg, get_model(cfg), params, batch)
    assert seen and all(x == (Shard(0), Shard(2)) and
                        bc == (Shard(0), Replicate()) for x, bc in seen)
    got = {}
    tree.named_map(lambda names, g: got.setdefault(names[-1],
                                                   tuple(g.placements)),
                   grads["layers"]["mamba"])
    # batch partial sums over data; the columns split over model
    for name in ("in_x", "conv_wx"):
        assert got[name] == (Partial("sum"), Shard(2)), (name, got[name])
    assert got["in_bc"][1] in (Replicate(), Partial("sum"))
