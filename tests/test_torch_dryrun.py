"""The port's dry run and its counters (``repro_torch/launch/{dryrun,
comm_stats,cases}.py``), the kernels' custom ops under fake tensors, and
the model's steps across real ranks (``launch/sharded_check.py``).

* Counters on a fake (2, 4) mesh, two linears: ``megatron`` closes the
  pair with one all-reduce, ``hcmp`` re-gathers with all-gathers only;
  each collective's per-device bytes equal the analytic count.
* ``qwen2-0.5b`` x ``decode_32k`` on the (16, 16) mesh with fake CPU
  tensors: an ``ok`` record of the reference's schema whose per-device
  FLOPs equal the analytic count of its matmuls and attention (each
  rank: its 8 rows, its 1/16 of every weight's columns and of the
  cache's sequence, the tree part whole), no kernel launched, and
  ``roofline.table()`` returns its row.
* 4 gloo ranks on a (2, 2) mesh (spawned, ``FileStore`` under
  ``tmp_path``, 120 s timeout): prefill, W=8 verify and two decodes (the
  second reads the first's commit) of ``qwen2-0.5b-smoke`` and
  ``qwen3-moe-30b-a3b-smoke`` in fp32, both modes, within 2e-5 of the
  unsharded port; the unsharded port within 2e-5 of the JAX model on the
  bridged weights.  The same on the ranks for ``xlstm-125m-smoke`` and
  ``zamba2-7b-smoke``, whose commits pick each row's recurrent state.
* The recurrent decodes at full width on the (16, 16) mesh move nothing
  over ``data``; the sequence-split attention's parts on one device
  equal the whole cache's; the counters fail loudly without DTensor's
  private names; ``sharded_check`` defaults to the card.
Every fake process group a test starts is ended by the fixture.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as j_get_config
from repro.core.speculative import tree as JT
from repro.models.api import get_model as j_get_model
from repro_torch.benchmarks import roofline
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.hcmp import sharding as shd
from repro_torch.kernels import dispatch, registered
from repro_torch.launch import comm_stats, dryrun, sharded_check
from repro_torch.launch import mesh as tmesh
from repro_torch.models.api import get_model

TOL = 2e-5


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    tmesh.release_fake_group()


def _two_linears(mode, d=64, f=128, B=8):
    """x (B, d) @ w1 (d, f) @ w2 (f, d) on a fake (2, 4) mesh, the batch
    over ``data``, the weights by ``mode``'s rule (HCMP: both column
    split; Megatron: column, then row), each product re-gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import distribute_tensor as dist_t
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = tmesh.make_smoke_mesh(4, device_type="cpu", world=8)
    with FakeTensorMode() as fake:
        x = dist_t(torch.empty(B, d), mesh, [Shard(0), Replicate()],
                   src_data_rank=None)
        w1 = dist_t(torch.empty(d, f), mesh, [Replicate(), Shard(1)],
                    src_data_rank=None)
        w2 = dist_t(torch.empty(f, d), mesh,
                    [Replicate(), Shard(1 if mode == "hcmp" else 0)],
                    src_data_rank=None)
        c = comm_stats.StepCounters(mesh, fake)
        with implicit_replication(), c:
            h = shd.regather(x @ w1, w2)
            y = shd.regather(h @ w2)
        assert y.placements == (Shard(0), Replicate())
    return c


def test_megatron_closes_two_linears_with_one_all_reduce():
    c = _two_linears("megatron")
    # the partial sum of each rank's 4 rows x 64 fp32 outputs
    assert c.collective_bytes() == {"all-reduce": 4 * 64 * 4,
                                    "total": 4 * 64 * 4}
    assert c.collective_bytes_by_mesh_dim() == {
        "model": {"all-reduce": 1024, "total": 1024}}
    assert c.flops == 2 * 4 * 64 * 32 + 2 * 4 * 32 * 64


def test_hcmp_regathers_with_all_gathers_only():
    c = _two_linears("hcmp")
    # each product's 4 local rows gathered whole: 128, then 64 fp32 wide
    assert c.collective_bytes() == {"all-gather": 4 * (128 + 64) * 4,
                                    "total": 4 * (128 + 64) * 4}
    assert set(c.collective_bytes_by_mesh_dim()) == {"model"}
    assert c.flops == 2 * 4 * 64 * 32 + 2 * 4 * 128 * 16
    assert c.op_histogram()["all-gather"] == 2


def test_custom_ops_give_shapes_and_flops_under_fake_tensors():
    """Each kernel's custom op: under fake tensors its fake implementation
    (no launch), with the bound's FLOP count; on real CPU tensors its
    wrapper (the plain version)."""
    from torch.utils.flop_counter import FlopCounterMode
    B, W, Hq, Hkv, hd, S = 2, 4, 4, 2, 8, 16
    rng = np.random.default_rng(0)

    def args():
        t = lambda *s: torch.as_tensor(rng.standard_normal(s, np.float32))
        key_pos = torch.arange(S, dtype=torch.int32).expand(B, S).clone()
        q_pos = torch.full((B, W), S, dtype=torch.int32)
        return (t(B, W, Hq, hd), t(B, S, Hkv, hd), t(B, S, Hkv, hd),
                t(B, W, Hkv, hd), t(B, W, Hkv, hd), key_pos, q_pos,
                torch.full((B, W), -1, dtype=torch.int32),
                torch.tril(torch.ones(W, W, dtype=torch.bool)))

    real = args()
    want = dispatch.verify_attention(*real)
    np.testing.assert_array_equal(
        registered.verify_attention(*real).numpy(), want.numpy())
    with FakeTensorMode() as fake:
        fa = tuple(fake.from_tensor(t) for t in real)
        with FlopCounterMode(display=False) as fc:
            out = dispatch.tree_attention(fa[0], fa[1], fa[2], fa[3], fa[4],
                                          fa[5], torch.full((B,), S,
                                                            dtype=torch.int32),
                                          torch.zeros(W, dtype=torch.int32),
                                          fa[8])
            o, m, l = registered.tree_partial(fa[0], fa[3], fa[4], fa[8])
    assert out.shape == want.shape and out.dtype == want.dtype
    assert (o.shape, m.shape, l.shape) == ((B, W, Hq, hd), (B, Hq, W),
                                           (B, Hq, W))
    assert fc.get_total_flops() == 4 * B * Hq * W * (S + W) * hd \
        + 4 * B * Hq * W * W * hd


def _analytic_decode_flops(cfg, B=128, S=32_768, n_data=16, n_model=16):
    """Per-device FLOPs of one ``decode_32k`` step under HCMP: every
    linear column-split 16 ways over the rank's B / 16 rows, the cache's
    sequence split 16 ways, the W = 1 tree part whole."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.num_layers
    Hq, Hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    rows = B // n_data
    widths = d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d + 3 * d * f
    matmuls = 2 * rows * (L * widths + d * cfg.padded_vocab) // n_model
    attention = L * 4 * rows * Hq * (S // n_model + 1) * hd
    return matmuls + attention


def test_qwen2_decode_dry_run_counts_the_analytic_flops(tmp_path):
    for wrapper in dispatch.wrappers().values():
        wrapper.launches = 0
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                      "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    [f] = tmp_path.glob("*.json")
    assert f.name == "qwen2-0.5b__decode_32k__single__hcmp.json"
    rec = json.loads(f.read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) >= {"status", "torch_version", "memory", "flops",
                        "bytes_accessed", "collectives", "op_histogram",
                        "n_devices", "model_params", "model_params_active"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert "corrected" not in rec
    cfg = get_config("qwen2-0.5b")
    assert rec["flops"] == _analytic_decode_flops(cfg)
    assert rec["n_devices"] == 256
    assert rec["model_params"] == cfg.param_count()
    # the cache is read once: its local slice bounds the bytes from below
    cache = 2 * cfg.num_layers * 8 * 2048 * cfg.num_kv_heads \
        * cfg.head_dim * 2
    assert cache < rec["bytes_accessed"] < 2 * cache
    assert rec["memory"]["argument_bytes"] > cache
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce", "total"}
    assert rec["collectives_by_mesh_dim"]["model"]["total"] == \
        rec["collectives"]["total"]
    assert all(w.launches == 0 for w in dispatch.wrappers().values())
    [row] = roofline.table(results_dir=str(tmp_path))
    assert row["arch"] == "qwen2-0.5b" and row["bound"] == "memory"
    assert row["memory_s"] == pytest.approx(rec["bytes_accessed"] / 3.35e12)


def test_unsupported_case_is_skipped(tmp_path, monkeypatch):
    """Full attention (no window) cannot decode at long_500k: every
    config here has a window, so one is taken away."""
    import dataclasses
    full = dataclasses.replace(get_config("qwen3-32b"), sliding_window=0)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: full)
    rec = dryrun.run_case("qwen3-32b", "long_500k", device="cpu",
                          out_dir=tmp_path, verbose=False)
    assert rec["status"] == "skipped"
    assert "sliding window" in rec["reason"]


# --------------------------------------------------------------------------
# real ranks
# --------------------------------------------------------------------------
ARCHS = ("qwen2-0.5b-smoke", "qwen3-moe-30b-a3b-smoke")


def _jax_steps(arch, jp, x):
    jm = j_get_model(j_get_config(arch))
    spec_tree = JT.Tree.from_spec(x["spec"])
    lp, _, cache = jm.prefill(jp, {"tokens": jnp.asarray(x["prompt"])},
                              max_len=x["max_len"])
    lv, _ = jm.verify(jp, cache, jnp.asarray(x["tree_tokens"]), spec_tree)
    ld, cache = jm.decode(jp, cache, jnp.asarray(x["token"]))
    ld2, _ = jm.decode(jp, cache, jnp.asarray(x["token"]))
    return {"prefill": lp, "verify": lv, "decode": ld, "decode2": ld2}


# the recurrent families' commits pick each row's state (``per_row``)
RECURRENT = ("xlstm-125m-smoke", "zamba2-7b-smoke")


def test_sharded_steps_on_four_gloo_ranks_match(tmp_path):
    from repro_torch.core.speculative import tree as T
    params = {}
    for arch in ARCHS:
        jp = j_get_model(j_get_config(arch)).init_params(
            jax.random.PRNGKey(0))
        params[arch] = (jp, params_from_jax(
            get_config(arch), jax.tree.map(np.asarray, jp), device="cpu"))
        torch.save(params[arch][1], tmp_path / f"{arch}.pt")
    for arch in RECURRENT:
        params[arch] = (None, sharded_check.load_params(get_config(arch),
                                                        None, "cpu"))
        torch.save(params[arch][1], tmp_path / f"{arch}.pt")
    a = sharded_check.parse_args(["--arch", ",".join(ARCHS + RECURRENT),
                                  "--params", str(tmp_path),
                                  "--tmp", str(tmp_path),
                                  "--backend", "gloo", "--device", "cpu"])
    got = sharded_check.run_ranks(a)
    for arch in ARCHS + RECURRENT:
        cfg = get_config(arch)
        x = sharded_check.inputs(cfg)
        want = sharded_check.steps(get_model(cfg), params[arch][1], x)
        for mode in ("hcmp", "megatron"):
            diffs = sharded_check.max_diffs(got[f"{arch}/{mode}"], want)
            assert max(diffs.values()) <= TOL, (arch, mode, diffs)
        if arch in RECURRENT:
            continue
        # the unsharded port against the JAX model on the same weights
        spec = T.build_tree(T.default_accs(cfg.medusa_heads,
                                           cfg.medusa_top_k), 8)
        jx = {k: v.numpy() for k, v in x.items()
              if k in ("prompt", "tree_tokens", "token")}
        jx.update(spec=spec, max_len=x["max_len"])
        ref = _jax_steps(arch, params[arch][0], jx)
        for k in want:
            np.testing.assert_allclose(want[k].numpy(), np.asarray(ref[k]),
                                       atol=TOL, rtol=TOL)


def test_sharded_check_defaults_to_the_card():
    """The launcher runs on the card unless asked for the CPU; without a
    card it raises before spawning a rank."""
    a = sharded_check.parse_args([])
    assert (a.backend, a.device) == ("nccl", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded_check.main([])


@pytest.mark.parametrize("lengths", [(20, 13, 7), (16, 8, 16), (9, 31)])
@pytest.mark.parametrize("G", [1, 3])
def test_sequence_split_on_one_device_equals_tree_attention(lengths, G):
    """The sequence-split route's parts (each slice's B3 partial over pages
    of 16/8/4/2/1 slots, the tree's B4 partial, the Eq.-1 merge) on CPU
    tensors equal the whole cache's tree attention, including a slice
    past every row's position (all masked)."""
    from repro_torch.kernels.plain import tree_attention_plain
    rng = np.random.default_rng(sum(lengths) * G)
    B, W, Hkv, hd, S = 3, 4, 2, 16, sum(lengths)
    Hq = G * Hkv

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape, np.float32))

    q = randn(B, W, Hq, hd)
    ck, cv = randn(B, S, Hkv, hd), randn(B, S, Hkv, hd)
    kn, vn = randn(B, W, Hkv, hd), randn(B, W, Hkv, hd)
    pos = np.array([S - lengths[-1] - 2 * b for b in range(B)], np.int32)
    key_pos = np.where(np.arange(S)[None] < pos[:, None], np.arange(S)[None],
                       -1).astype(np.int32)
    depth = np.array([0, 1, 1, 2], np.int32)
    mask = np.tril(np.ones((W, W), bool))
    mask[2, 1] = mask[3, 1] = False
    q_pos = (pos[:, None] + depth[None]).astype(np.int32)
    lo = np.full_like(q_pos, -1)
    args = (q, ck, cv, kn, vn, *(torch.as_tensor(a) for a in
                                 (key_pos, q_pos, lo)), torch.as_tensor(mask))
    got = dispatch.sequence_split_attention(*args, lengths)
    want = tree_attention_plain(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="do not cover"):
        dispatch.sequence_split_attention(*args, lengths[:-1])


def test_counters_fail_loudly_without_the_private_names(monkeypatch):
    """A torch without one of the DTensor internals the counters patch
    fails on entering them, naming it; the row hook is put back."""
    from torch.distributed.tensor.placement_types import _StridedShard
    from repro_torch.models import attention
    mesh = tmesh.make_smoke_mesh(4, device_type="cpu", world=8)
    monkeypatch.delattr(_StridedShard, "local_shard_size_and_offset")
    with pytest.raises(RuntimeError, match="local_shard_size_and_offset"):
        with comm_stats.StepCounters(mesh):
            pass
    assert attention.ROWS_HOOK is None


@pytest.mark.parametrize("arch,shape", [("xlstm-125m", "decode_32k"),
                                        ("zamba2-7b", "decode_32k")])
def test_recurrent_commit_keeps_the_batch_split(arch, shape, tmp_path):
    """A recurrent family's decode (verify, then the commit's per-row pick
    of each state) moves nothing over ``data``: the state stays split by
    the batch (``sharding.per_row``)."""
    rec = dryrun.run_case(arch, shape, out_dir=tmp_path, force=True,
                          verbose=False, device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert "data" not in rec["collectives_by_mesh_dim"]
