"""The port's verify-attention kernel path against the reference.

On the CPU the wrapper runs its plain version, ``tree_attention_plain``;
it and ``dispatch.tree_attention`` are held against the JAX oracle
``tree_attention_ref`` and the Pallas ``tree_attention`` in interpret mode
over the reference's kernel sweep (CASES, copied from
``tests/test_kernels.py``), on the same numpy inputs.  Tolerances are the
reference's own: fp32 2e-5, bf16 2e-2 (atol = rtol).  The CUDA kernel itself
is compared with the plain version on the card by ``test_torch_card.py``
and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import tree_attention_ref
from repro.kernels.tree_attention import tree_attention as pallas_tree_attention
from repro_torch.kernels import dispatch
from repro_torch.kernels.plain import tree_attention_plain
from repro_torch.kernels.verify_attention import _check, verify_attention

CASES = [
    # B, W, Hq, Hkv, hd, S, pos, window, block_s, dtype
    (1, 1, 4, 4, 64, 32, 17, 0, 16, "float32"),       # plain decode
    (2, 8, 4, 2, 64, 40, 33, 0, 16, "float32"),       # GQA tree
    (1, 16, 8, 1, 128, 128, 100, 0, 64, "float32"),   # MQA, wide tree
    (2, 4, 4, 4, 32, 24, 24, 16, 8, "float32"),       # sliding window
    (1, 8, 4, 2, 64, 64, 64, 0, 64, "bfloat16"),      # bf16, full ring
    (1, 32, 2, 2, 16, 8, 6, 0, 8, "float32"),         # tiny cache, big tree
    (4, 8, 4, 2, 32, 24, 20, 0, 8, "float32"),        # B=4 diverged pos
    (3, 4, 4, 4, 32, 16, 14, 8, 8, "float32"),        # diverged + window
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _rand_tree_mask(W, seed=0):
    rng = np.random.default_rng(seed)
    parent = np.full(W, -1)
    for i in range(1, W):
        parent[i] = rng.integers(0, i)
    mask = np.zeros((W, W), bool)
    depth = np.zeros(W, np.int32)
    for i in range(W):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = parent[j]
        d, j = 0, i
        while parent[j] >= 0:
            d, j = d + 1, parent[j]
        depth[i] = d
    return mask, depth


def _ring_key_pos(pos, S):
    base = np.arange(S)
    if pos >= S:
        return pos - S + ((base - (pos % S)) % S)
    return np.where(base < pos, base, -1)


def _inputs(B, W, Hq, Hkv, hd, S, pos, window):
    """numpy inputs from a seed: per-sequence diverged positions."""
    rng = np.random.default_rng(B * W + S)
    f = [rng.standard_normal(s).astype(np.float32) for s in
         [(B, W, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
          (B, W, Hkv, hd), (B, W, Hkv, hd)]]
    pos_b = np.array([max(pos - 2 * b, 1) for b in range(B)], np.int32)
    key_pos = np.stack([_ring_key_pos(p, S) for p in pos_b]).astype(np.int32)
    mask, depth = _rand_tree_mask(W, seed=S)
    q_pos = (pos_b[:, None] + depth[None, :]).astype(np.int32)
    lo = q_pos - window if window else np.full_like(q_pos, -1)
    return f, key_pos, q_pos, lo, mask, pos_b, depth


@pytest.mark.parametrize("B,W,Hq,Hkv,hd,S,pos,window,block_s,dtype", CASES)
def test_plain_and_dispatch_match_jax_oracle_and_pallas(
        B, W, Hq, Hkv, hd, S, pos, window, block_s, dtype):
    f, key_pos, q_pos, lo, mask, pos_b, depth = _inputs(
        B, W, Hq, Hkv, hd, S, pos, window)
    jf = [jnp.asarray(a, getattr(jnp, dtype)) for a in f]
    ji = [jnp.asarray(a) for a in (key_pos, q_pos, lo)]
    ref = np.asarray(tree_attention_ref(*jf, *ji, jnp.asarray(mask)),
                     np.float32)
    pallas = np.asarray(pallas_tree_attention(
        *jf, *ji, jnp.asarray(mask), block_s=block_s, interpret=True),
        np.float32)

    tf = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in f]
    ti = [torch.from_numpy(a) for a in (key_pos, q_pos, lo)]
    tmask = torch.from_numpy(mask)
    plain = tree_attention_plain(*tf, *ti, tmask)
    launches = verify_attention.launches
    disp = dispatch.tree_attention(*tf, ti[0], torch.from_numpy(pos_b),
                                   torch.from_numpy(depth), tmask,
                                   window=window)
    assert verify_attention.launches == launches   # CPU: no kernel launch
    assert plain.dtype == tf[0].dtype and plain.shape == tf[0].shape
    tol = TOL[dtype]
    for got in (plain, disp):
        got = got.float().numpy()
        np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
        np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


def test_decode_attention_is_the_w1_tree():
    f, key_pos, _, _, _, pos_b, _ = _inputs(2, 1, 4, 2, 32, 24, 20, 0)
    tf = [torch.from_numpy(a) for a in f]
    kp, pb = torch.from_numpy(key_pos), torch.from_numpy(pos_b)
    got = dispatch.decode_attention(*tf, kp, pb)
    want = dispatch.tree_attention(*tf, kp, pb,
                                   torch.zeros((1,), dtype=torch.int32),
                                   torch.ones((1, 1), dtype=torch.bool))
    assert torch.equal(got, want)


def _valid_args():
    f, key_pos, q_pos, lo, mask, _, _ = _inputs(2, 4, 4, 2, 32, 24, 20, 0)
    return ([torch.from_numpy(a) for a in f]
            + [torch.from_numpy(a) for a in (key_pos, q_pos, lo)]
            + [torch.from_numpy(mask)])


@pytest.mark.parametrize("break_arg,why", [
    (lambda a: a.__setitem__(1, a[1][:, :, :1]), "shape"),
    (lambda a: a.__setitem__(5, a[5].long()), "int32"),
    (lambda a: a.__setitem__(8, a[8].int()), "bool"),
    (lambda a: a.__setitem__(2, a[2].double()), "float64"),
    (lambda a: a.__setitem__(0, a[0].transpose(0, 1).contiguous()
                             .transpose(0, 1)), "contiguous"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(break_arg, why):
    args = _valid_args()
    assert _check(*args) == (2, 4, 4, 2, 32, 24)
    break_arg(args)
    with pytest.raises((ValueError, TypeError)):
        _check(*args)


def test_wrapper_runs_on_cuda_or_cpu_only():
    args = [a.to("meta") for a in _valid_args()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        verify_attention(*args)
