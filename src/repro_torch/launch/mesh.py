"""The dry run's device meshes (counterpart of ``repro/launch/mesh.py``):
a ``torch.distributed.DeviceMesh`` with the reference's shapes and axis
names, so the sweep keeps the reference's grid and global batches.

Built by functions, never at import.  A mesh function that finds no process
group up starts the ``fake`` one of the mesh's size (rank 0 of it, no
communication: a collective returns at once and moves nothing), which
the dry run traces under fake tensors; ``release_fake_group`` ends it.  A
group that is up (gloo or NCCL across real ranks) is used as it is and
must hold exactly the mesh's ranks.

Hardware constants: the H100's (``core/arca.py``).  A 16-wide ``model``
axis spans two 8-GPU NVLink domains of an HGX H100 host pair, so its
collectives cross the network between the two halves: the NVLink rate
used for the collective term is a floor on their time there.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.arca import H100_HBM, H100_NVLINK, H100_PEAK_BF16
from repro_torch.core.hcmp.sharding import data_axes  # noqa: F401

PEAK_FLOPS_BF16 = H100_PEAK_BF16     # FLOP/s, dense bf16 tensor cores
HBM_BW = H100_HBM                    # bytes/s
NVLINK_BW = H100_NVLINK              # bytes/s per direction


def _fake_group(world: int) -> None:
    """Start the fake process group of ``world`` ranks (this process is
    rank 0) unless a group is up, which must then hold ``world`` ranks."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is up; "
                f"the mesh needs {world}")
        return
    # registers the "fake" backend with c10d
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


def release_fake_group() -> None:
    """End the default process group if it is the fake one."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def _mesh(device_type, shape, names):
    world = 1
    for n in shape:
        world *= n
    _fake_group(world)
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``."""
    if multi_pod:
        return _mesh(device_type, (2, 16, 16), ("pod", "data", "model"))
    return _mesh(device_type, (16, 16), ("data", "model"))


def make_smoke_mesh(n_model: int = 1, *, device_type="cuda", world=None):
    """``(world // n_model, n_model)`` ``("data", "model")`` over the group
    that is up (its world size), or over a fake group of ``world`` ranks
    when none is."""
    if world is None:
        if not dist.is_initialized():
            raise RuntimeError("no process group is up: pass world=")
        world = dist.get_world_size()
    if world % n_model:
        raise ValueError(f"{world} ranks do not split into model axes of "
                         f"{n_model}")
    return _mesh(device_type, (world // n_model, n_model), ("data", "model"))
