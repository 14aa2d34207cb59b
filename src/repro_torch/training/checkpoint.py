"""Flat ``.npz`` checkpoints of the port's param trees, in the reference's
file layout (counterpart of ``repro/training/checkpoint.py``).

Layout: a ``treedef`` entry (the bytes of the reference's
``str(treedef)``) and one ``leaf_{i}`` entry per leaf, numbered in JAX's
flatten order: dict keys sorted, tuples in order, recursively
(``repro_torch/tree.py``).  The port's trees carry the
reference's keys (``bridge.py``) but keep insertion order, so both
``save`` and ``restore`` sort explicitly.  A bfloat16 leaf is written as
the reference writes it: its raw 16-bit payload under the ``<V2`` descr
that ``np.savez`` gives an ml_dtypes bfloat16 array, so a leaf's ``.npy``
bytes equal the reference's for the same tree.

``restore`` reads the port's files and the reference's, float32 leaves
and bfloat16 payloads alike, and casts each leaf to ``like``'s dtype and
device.  Here the port departs from the reference: its ``restore`` casts
the loaded ``|V2`` array with ``.astype(bfloat16)``, which raises
(``ValueError: No cast function available``), so it cannot read back a
bfloat16 leaf that its own ``save`` wrote.  This module reinterprets the
payload instead.
"""
from __future__ import annotations

import os
import zipfile

import numpy as np
import torch

from repro_torch.tree import paths as _paths
from repro_torch.tree import rebuild, treedef_str

BF16_DESCR = "<V2"        # np.savez's header descr of an ml_dtypes bfloat16


def _npy(zf, name, arr, descr=None):
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        if descr is None:
            np.lib.format.write_array(f, arr, allow_pickle=False)
        else:
            np.lib.format.write_array_header_1_0(
                f, {"descr": descr, "fortran_order": False,
                    "shape": arr.shape})
            f.write(arr.tobytes())


def _host(t):
    """A leaf as (numpy array, header descr override or None)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16_DESCR
    return t.numpy(), None


def save(path: str, tree) -> None:
    """Write ``tree`` as ``np.savez`` would write the reference's tree (the
    ``.npz`` suffix is added when ``path`` lacks it, as np.savez does)."""
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        _npy(zf, "treedef", np.frombuffer(treedef_str(tree).encode(),
                                          np.uint8))
        for i, (_, leaf) in enumerate(_paths(tree)):
            arr, descr = _host(leaf)
            _npy(zf, f"leaf_{i}", arr, descr)


def _tensor(a):
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        # a bfloat16 leaf: reinterpret its 16-bit payload
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def restore(path: str, like):
    """Restore into the structure of ``like`` (shape, dtype and device
    template): new tensors, ``like`` untouched."""
    new = {}
    with np.load(path) as data:
        for i, (key, old) in enumerate(_paths(like)):
            t = _tensor(data[f"leaf_{i}"])
            assert tuple(old.shape) == tuple(t.shape), (old.shape, t.shape)
            new[key] = t.to(device=old.device, dtype=old.dtype)
    return rebuild(like, new)
