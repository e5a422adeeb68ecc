"""Mesh construction over ``torch.distributed`` (deliberately functions:
importing this module starts no process group and touches no device).

The port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised world;
its axis names are the JAX package's.
"""

from __future__ import annotations

#: the production meshes' shapes and axis names, the JAX package's
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks) over
    the initialised world, which must have that many ranks (the dry run
    initialises a fake process group of that size).

    Axes: ``model`` is the fast tensor axis, ``data`` the FSDP/batch axis,
    ``pod`` the slow pure-DP axis — only gradient all-reduce crosses it.
    On H100 nodes of 8 GPUs joined by NVLink, a ``model`` extent of 16
    crosses a node; ``dryrun --aspect`` plans other shapes (32x8 keeps TP
    inside a node).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[multi_pod]
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh {shape} needs an "
                           f"initialised world of {n} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def init_one_rank(device) -> None:
    """A process group of this one process on an in-memory store (no
    network): NCCL for a CUDA ``device``, gloo for the CPU."""
    import torch.distributed as dist
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        import torch
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def init_from_env(device) -> None:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), if it
    set one and none is initialised; NCCL for a CUDA ``device``, gloo for
    the CPU."""
    import os

    import torch.distributed as dist
    if dist.is_initialized() or "RANK" not in os.environ:
        return
    if device.type == "cuda":
        import torch
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def make_host_mesh(model: int = 1, data: int | None = None, device=None):
    """A (data, model) mesh over the initialised world, on ``device``'s
    type (default the card).  With no process group initialised, it first
    starts a one-rank group (:func:`init_one_rank`).  ``data`` defaults to
    the world size over ``model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve
    device = resolve(device)
    if not dist.is_initialized():
        init_one_rank(device)
    n = dist.get_world_size()
    data = data or (n // model)
    return init_device_mesh(device.type, (data, model),
                            mesh_dim_names=("data", "model"))
