"""The port's HCMP and Megatron placement tables
(``repro_torch/core/hcmp/sharding.py``) and dry-run case rules
(``repro_torch/launch/cases.py``) against the reference's.

Leaf by leaf, for every config of ``list_archs()`` at full size and
``reduced()``, in both modes, with ``fsdp`` off and on: the port's spec
tuples equal ``repro.core.hcmp.sharding``'s ``PartitionSpec`` tables on
``jax.eval_shape`` structs (the port's side on fake tensors: no 30B
weights are drawn), for params, caches (batch 128 and the batch of one
that stays replicated; the ``% 16`` head rules) and batches; each rank's
shard shape on a (2, 4) mesh equals ``NamedSharding(...).shard_shape``
(computed in one subprocess with 8 host devices, as
``tests/test_sharding_lowering.py`` does).  ``supports``,
``decode_window`` and ``shallow_clone`` agree for every arch x shape.
Every fake process group a test starts is ended by the fixture.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.core.hcmp import sharding as jshd
from repro.launch import cases as jcases
from repro.models.api import get_model as j_get_model
from repro_torch import tree
from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.hcmp import sharding as tshd
from repro_torch.launch import cases as tcases
from repro_torch.launch import mesh as tmesh
from repro_torch.models.api import get_model as t_get_model

ARCHS = list_archs()
MODES = ("hcmp", "megatron")


@pytest.fixture(autouse=True)
def _no_group_left():
    """A test's fake process group ends with it."""
    yield
    tmesh.release_fake_group()


def _cfgs(arch, fsdp):
    """(reference, port) configs: full size, then reduced, with ``fsdp``."""
    j, t = j_get_config(arch), t_get_config(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        yield (dataclasses.replace(jc, fsdp=fsdp),
               dataclasses.replace(tc, fsdp=fsdp))


def _norm(entry):
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else entry
    return entry


def _j_names(path):
    out = []
    for p in path:
        if isinstance(p, jax.tree_util.DictKey):
            out.append(p.key)
        elif isinstance(p, jax.tree_util.GetAttrKey):
            out.append(p.name)
    return tuple(out)


def _j_table(specs, structs):
    """{key-path names: [(spec, shape), ...]} of a reference spec tree."""
    out = {}
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    flat_t = jax.tree_util.tree_leaves(structs)
    for (path, spec), leaf in zip(flat_s, flat_t):
        out.setdefault(_j_names(path), []).append(
            (tuple(_norm(e) for e in spec), tuple(leaf.shape)))
    return out


def _t_table(spec_fn, structs):
    out = {}
    tree.named_map(lambda names, t: out.setdefault(names, []).append(
        (tuple(_norm(e) for e in spec_fn(names, t)), tuple(t.shape))),
        structs)
    return out


def _at(t, path):
    for k in path:
        t = t[k]
    return t


def _port_params(cfg):
    with FakeTensorMode():
        return t_get_model(cfg).init_params(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_equal_reference(arch, fsdp):
    for jc, tc in _cfgs(arch, fsdp):
        jp = jax.eval_shape(
            lambda: j_get_model(jc).init_params(jax.random.PRNGKey(0)))
        tp = _port_params(tc)
        for mode in MODES:
            want = _j_table(jshd.param_specs(jc, jp, mode), jp)
            got = _t_table(lambda n, t: tshd._leaf_spec(n, t.shape, mode,
                                                        tc.fsdp), tp)
            assert got == want, (jc.name, mode)
            # the public tree: the same spec at every leaf's path
            specs = tshd.param_specs(tc, tp, mode)
            for path, t in tree.paths(tp):
                names = tuple(k for k in path if isinstance(k, str))
                assert _at(specs, path) == tshd._leaf_spec(
                    names, t.shape, mode, tc.fsdp)


def _shapes(cfg):
    return [s for s in ("decode_32k", "long_500k")
            if tcases.supports(cfg, INPUT_SHAPES[s])[0]]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data")])
def test_cache_and_batch_specs_equal_reference(arch, batch_axes):
    for jc, tc in _cfgs(arch, False):
        for shape in _shapes(tc):
            jcache = jcases._cache_struct(jc, J_SHAPES[shape])
            with FakeTensorMode():
                tcache = tcases._cache(tc, INPUT_SHAPES[shape], "cpu")
            want = _j_table(jshd.cache_specs(jc, jcache,
                                             batch_axes=batch_axes), jcache)
            got = _t_table(lambda n, t: tshd._cache_spec(n, t.shape,
                                                         batch_axes,
                                                         "model"), tcache)
            assert got == want, (jc.name, shape)
        for shape in INPUT_SHAPES:
            jb = jcases._batch_struct(jc, J_SHAPES[shape])
            with FakeTensorMode():
                tb = tcases._batch(tc, INPUT_SHAPES[shape], "cpu")
            want = _j_table(jshd.batch_specs(jb, batch_axes), jb)
            got = _t_table(lambda n, t: tshd._batch_spec(t.shape,
                                                         batch_axes), tb)
            assert got == want, (jc.name, shape)


def test_the_rules_cover_the_cache_cases():
    """The tables above meet each cache rule: a batch of one replicated,
    kv heads split where 16 divides them (seamless: 16), Mamba heads
    likewise (zamba2: 112), and not elsewhere."""
    seen = set()
    for arch in ("seamless-m4t-medium", "zamba2-7b", "qwen3-32b"):
        cfg = t_get_config(arch)
        for shape in _shapes(cfg):
            with FakeTensorMode():
                c = tcases._cache(cfg, INPUT_SHAPES[shape], "cpu")
            tree.named_map(lambda n, t: seen.add(
                (n[-1], tshd._cache_spec(n, t.shape, ("data",), "model"))),
                c)
    assert ("cross_k", (None, ("data",), None, "model", None)) in seen
    assert ("ssm", (None, ("data",), "model", None, None)) in seen
    assert ("k", (None, None, "model", None, None)) in seen     # B = 1
    assert ("k", (None, ("data",), "model", None, None)) in seen


SHARD_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_config, list_archs
from repro.core.hcmp import sharding as shd
from repro.models.api import get_model
from repro.models import hybrid, xlstm_model
from repro.runtime.cache import Cache, init_kv_cache

mesh = jax.make_mesh((2, 4), ("data", "model"))
B, S = 8, 64
out = {}
for arch in list_archs():
    for fsdp in (False, True):
        cfg = dataclasses.replace(get_config(arch).reduced(), fsdp=fsdp)
        model = get_model(cfg)
        ps = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
        def build_cache():
            if cfg.arch_type == "hybrid":
                return hybrid.init_cache(cfg, B, S)
            if cfg.arch_type == "ssm":
                return xlstm_model.init_cache(cfg, B)
            ck = init_kv_cache(cfg.num_layers, B, S, cfg.num_kv_heads,
                               cfg.head_dim, dtype=jnp.dtype(cfg.dtype))
            if cfg.is_encoder_decoder:
                cz = jnp.zeros((cfg.num_layers, B, 16, cfg.num_kv_heads,
                                cfg.head_dim), jnp.dtype(cfg.dtype))
                return Cache(kv=ck, cross_k=cz, cross_v=cz)
            return Cache(kv=ck)
        cs = jax.eval_shape(build_cache)
        for mode in ("hcmp", "megatron"):
            specs = shd.param_specs(cfg, ps, mode)
            shapes = [list(NamedSharding(mesh, s).shard_shape(l.shape))
                      for s, l in zip(
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec)),
                          jax.tree_util.tree_leaves(ps))]
            out[f"{arch}/{fsdp}/{mode}/params"] = sorted(shapes)
        cspecs = shd.cache_specs(cfg, cs, batch_axes=("data",))
        out[f"{arch}/{fsdp}/cache"] = sorted(
            list(NamedSharding(mesh, s).shard_shape(l.shape))
            for s, l in zip(jax.tree_util.tree_leaves(
                cspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)),
                jax.tree_util.tree_leaves(cs)))
print(json.dumps(out))
"""


def _reference_shard_shapes():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, "-c", SHARD_SCRIPT],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _port_cache(cfg, B=8, S=64):
    from repro_torch.models import hybrid, xlstm_model
    from repro_torch.runtime.cache import Cache, init_kv_cache
    dt = getattr(torch, cfg.dtype)
    if cfg.arch_type == "hybrid":
        return hybrid.init_cache(cfg, B, S, device="cpu")
    if cfg.arch_type == "ssm":
        return xlstm_model.init_cache(cfg, B, device="cpu")
    kv = init_kv_cache(cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim,
                       dtype=dt, device="cpu")
    if cfg.is_encoder_decoder:
        shape = (cfg.num_layers, B, 16, cfg.num_kv_heads, cfg.head_dim)
        return Cache(kv=kv, cross_k=torch.zeros(shape, dtype=dt),
                     cross_v=torch.zeros(shape, dtype=dt))
    return Cache(kv=kv)


def test_local_shards_on_a_2x4_mesh_equal_reference():
    """Rank 0's slice of every param and cache leaf, laid out by the
    port's placements on a fake (2, 4) mesh, has the reference's
    ``shard_shape``."""
    want = _reference_shard_shapes()
    mesh = tmesh.make_smoke_mesh(4, device_type="cpu", world=8)
    for arch in ARCHS:
        for fsdp in (False, True):
            cfg = dataclasses.replace(t_get_config(arch).reduced(),
                                      fsdp=fsdp)
            with FakeTensorMode():
                params = t_get_model(cfg).init_params(
                    torch.Generator().manual_seed(0))
                for mode in MODES:
                    local = tshd.distribute_params(cfg, params, mode,
                                                   mesh=mesh)
                    got = sorted(list(t.to_local().shape)
                                 for t in _leaves(local))
                    assert got == want[f"{arch}/{fsdp}/{mode}/params"], \
                        (arch, fsdp, mode)
                cache = tshd.distribute_cache(cfg, _port_cache(cfg),
                                              mesh=mesh)
                got = sorted(list(t.to_local().shape)
                             for t in _leaves(cache))
                assert got == want[f"{arch}/{fsdp}/cache"], (arch, fsdp)


def _leaves(t):
    out = []
    tree.named_map(lambda n, x: out.append(x), t)
    return out


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh.shape == (2, 16, 16)
    assert tshd.data_axes(mesh) == ("pod", "data")
    assert tshd.placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert tshd.placements(mesh, (None, None)) == (Replicate(),) * 3


def _want_placements(mesh, table, structs):
    """The reference's spec of each port leaf (``_j_table``, in flatten
    order per path) as placements on ``mesh``, in the port's tree."""
    left = {n: list(v) for n, v in table.items()}

    def pick(names, t):
        spec, shape = left[names].pop(0)
        assert shape == tuple(t.shape), names
        return tshd.placements(mesh, spec)
    return tree.named_map(pick, structs)


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_reference(arch):
    """``param_placements``, ``cache_placements`` and ``batch_placements``
    on the (2, 16, 16) mesh equal the reference's ``PartitionSpec`` of
    every leaf read as placements: full size and reduced, both modes,
    fsdp off and on."""
    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    dp = tshd.data_axes(mesh)
    for fsdp in (False, True):
        for jc, tc in _cfgs(arch, fsdp):
            jp = jax.eval_shape(
                lambda: j_get_model(jc).init_params(jax.random.PRNGKey(0)))
            tp = _port_params(tc)
            for mode in MODES:
                want = _want_placements(
                    mesh, _j_table(jshd.param_specs(jc, jp, mode), jp), tp)
                assert tshd.param_placements(tc, tp, mode,
                                             mesh=mesh) == want, \
                    (jc.name, mode)
            if fsdp:
                continue
            for shape in _shapes(tc):
                jcache = jcases._cache_struct(jc, J_SHAPES[shape])
                with FakeTensorMode():
                    tcache = tcases._cache(tc, INPUT_SHAPES[shape], "cpu")
                want = _want_placements(mesh, _j_table(jshd.cache_specs(
                    jc, jcache, batch_axes=dp), jcache), tcache)
                assert tshd.cache_placements(tc, tcache, mesh=mesh) == \
                    want, (jc.name, shape)
            for shape in INPUT_SHAPES:
                jb = jcases._batch_struct(jc, J_SHAPES[shape])
                with FakeTensorMode():
                    tb = tcases._batch(tc, INPUT_SHAPES[shape], "cpu")
                want = _want_placements(
                    mesh, _j_table(jshd.batch_specs(jb, dp), jb), tb)
                assert tshd.batch_placements(tb, mesh=mesh) == want, \
                    (jc.name, shape)


def test_a_mesh_needs_the_group_it_finds():
    with pytest.raises(RuntimeError, match="no process group is up"):
        tmesh.make_smoke_mesh(2, device_type="cpu")
    mesh = tmesh.make_smoke_mesh(2, device_type="cpu", world=4)
    assert mesh.shape == (2, 2)
    with pytest.raises(RuntimeError, match="4 ranks is up"):
        tmesh.make_production_mesh(device_type="cpu")


# --------------------------------------------------------------------------
# case rules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_case_rules_equal_reference(arch):
    jc, tc = j_get_config(arch), t_get_config(arch)
    for shape in INPUT_SHAPES:
        js, ts = J_SHAPES[shape], INPUT_SHAPES[shape]
        assert tcases.supports(tc, ts) == jcases.supports(jc, js)
        assert tcases.decode_window(tc, ts) == jcases.decode_window(jc, js)
    for L in (1, 2):
        for site in (False, True):
            assert dataclasses.asdict(tcases.shallow_clone(
                tc, L, with_site=site)) == dataclasses.asdict(
                jcases.shallow_clone(jc, L, with_site=site))


def test_regather_leaves_plain_tensors_alone():
    x = torch.randn(3, 4)
    assert tshd.regather(x) is x
    assert tshd.gather_fsdp({"w": x})["w"] is x
    assert tshd.mesh_of(x) is None
