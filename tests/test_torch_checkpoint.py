"""The port's checkpoints against the reference's, both ways, on
``qwen2-0.5b-smoke`` params and heads: the port writes the reference's
layout (a ``treedef`` entry, ``leaf_{i}`` in JAX's flatten order) with
every leaf's ``.npy`` bytes equal to the reference's file, float32 and
bfloat16 (its raw ``<V2`` payload); the reference restores the port's
float32 files; the port restores the reference's float32 and bfloat16
files (the reference's own ``restore`` cannot read a bfloat16 leaf back,
so that direction is checked against the saved arrays), and its own
bfloat16 round trip is bit-exact."""
import dataclasses
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.speculative import medusa as jmedusa
from repro.models.api import get_model as j_get_model
from repro.training import checkpoint as jck
from repro_torch.bridge import heads_from_jax, params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.speculative.medusa import init_medusa
from repro_torch.models.api import get_model as t_get_model
from repro_torch.training import checkpoint as tck
from repro_torch.training.optimizer import tree_map

ARCH = "qwen2-0.5b-smoke"


def _trees(dtype):
    """The reference's params and heads in ``dtype`` (numpy / ml_dtypes
    arrays) and the port's bridged copies."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    jdt = jnp.dtype(dtype)
    jp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)),
                      j_get_model(cfg).init_params(jax.random.PRNGKey(0)))
    jh = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)),
                      jmedusa.init_medusa(cfg, jax.random.PRNGKey(1)))
    tdt = getattr(torch, dtype)
    return (jp, jh, params_from_jax(tcfg, jp, device="cpu", dtype=tdt),
            heads_from_jax(tcfg, jh, device="cpu", dtype=tdt))


def _bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 and \
        a.dtype.kind != "i" else a


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _leaves_in_order(tree):
    return [t for _, t in tck._paths(tree)]


@pytest.mark.parametrize("which", ["params", "heads"])
def test_leaf_order_is_jax_flatten_order(which):
    jp, jh, tp, th = _trees("float32")
    jt, tt = (jp, tp) if which == "params" else (jh, th)
    jleaves, treedef = jax.tree_util.tree_flatten(jt)
    tleaves = _leaves_in_order(tt)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tck.treedef_str(tt) == str(treedef)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["params", "heads"])
def test_port_file_equals_reference_file(which, dtype, tmp_path):
    """Every member of the port's ``.npz`` (header and data of each leaf,
    and the treedef entry) equals the reference's for the same tree."""
    jp, jh, tp, th = _trees(dtype)
    jt, tt = (jp, tp) if which == "params" else (jh, th)
    jck.save(str(tmp_path / "ref.npz"), jax.tree.map(jnp.asarray, jt))
    tck.save(str(tmp_path / "port"), tt)               # suffix added
    ref, port = _members(tmp_path / "ref.npz"), _members(tmp_path /
                                                         "port.npz")
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name] == ref[name], name


def test_reference_restores_port_float32_file(tmp_path):
    jp, jh, tp, th = _trees("float32")
    for jt, tt, name in ((jp, tp, "p.npz"), (jh, th, "h.npz")):
        tck.save(str(tmp_path / name), tt)
        like = jax.tree.map(jnp.zeros_like, jt)
        got = jck.restore(str(tmp_path / name), like)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(jt)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_reference_file(dtype, tmp_path):
    """The reference's files, float32 leaves and bfloat16 ``|V2``
    payloads, restore into the port's trees bit for bit; a template of
    another dtype gets the leaves cast to its dtype."""
    jp, jh, tp, th = _trees(dtype)
    tdt = getattr(torch, dtype)
    for jt, tt, name in ((jp, tp, "p.npz"), (jh, th, "h.npz")):
        jck.save(str(tmp_path / name), jax.tree.map(jnp.asarray, jt))
        like = {k: v for k, v in reversed(list(tt.items()))}   # key order
        zeros = tree_map(torch.zeros_like, like)
        got = tck.restore(str(tmp_path / name), zeros)
        assert list(got) == list(like)           # the template's key order
        for (path, a), b in zip(tck._paths(got),
                                jax.tree_util.tree_leaves(jt)):
            assert a.dtype == tdt, path
            np.testing.assert_array_equal(_bits(a), _jbits(b))
        f32 = tck.restore(str(tmp_path / name),
                          tree_map(lambda t: t.float(), like))
        for (_, a), b in zip(tck._paths(f32), jax.tree_util.tree_leaves(jt)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(jnp.asarray(b, jnp.float32)))


def test_reference_cannot_restore_its_own_bfloat16_file(tmp_path):
    """The fault the port departs from: the reference's ``restore`` casts
    the loaded ``|V2`` array with ``astype(bfloat16)``, which raises."""
    a = {"a": jnp.ones((2, 3), jnp.bfloat16), "b": jnp.ones((4,))}
    jck.save(str(tmp_path / "r.npz"), a)
    with pytest.raises(ValueError):
        jck.restore(str(tmp_path / "r.npz"), a)
    got = tck.restore(str(tmp_path / "r.npz"),
                      {"a": torch.zeros((2, 3), dtype=torch.bfloat16),
                       "b": torch.zeros(4)})
    assert torch.equal(got["a"], torch.ones((2, 3), dtype=torch.bfloat16))
    assert torch.equal(got["b"], torch.ones(4))


def test_port_bfloat16_round_trip_is_bit_exact(tmp_path):
    tcfg = t_get_config("vicuna-7b-smoke")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    heads = init_medusa(tcfg, torch.Generator().manual_seed(3))
    params = t_get_model(tcfg).init_params(torch.Generator().manual_seed(4))
    for tree, name in ((heads, "h.npz"), (params, "p.npz")):
        tck.save(str(tmp_path / name), tree)
        fresh = tree_map(lambda t: torch.randn_like(t.float()).to(t.dtype),
                         tree)
        got = tck.restore(str(tmp_path / name), fresh)
        for (path, a), (_, b) in zip(tck._paths(got), tck._paths(tree)):
            assert a.dtype == torch.bfloat16
            assert a is not b
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_restore_checks_shapes(tmp_path):
    tck.save(str(tmp_path / "x.npz"), {"w": torch.zeros(3, 4)})
    with pytest.raises(AssertionError):
        tck.restore(str(tmp_path / "x.npz"), {"w": torch.zeros(4, 3)})
