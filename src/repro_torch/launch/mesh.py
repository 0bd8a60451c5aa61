"""Production and local meshes as ``DeviceMesh`` objects.

``make_production_mesh`` lays out 256 H100s (``("data", "model") = (32,
8)``) or, with ``multi_pod``, 512 (``("pod", "data", "model") = (2, 32,
8)``): the reference's chip counts, tensor parallel inside one 8-GPU
NVLink node (NVLink 4 joins the eight cards of a node all to all at 450
GB/s each way; between nodes traffic crosses the slower network, so a
16-way model axis, the reference's TPU layout, would put every
tensor-parallel collective across two nodes). The mesh lives on a fake
process group (``init_process_group("fake", ...)``, world 256 or 512, this
process rank 0): collectives return tensors of the right shapes and move
nothing, which is what the dry run needs to count them
(``launch.dryrun``). The fake group is the process's default group, as
large as the first mesh built; a later mesh of no more ranks lies on its
first ranks (the single mesh after the multi-pod one), and counts what it
counts in a group of its own size.

``make_local_mesh`` is the training mesh of whatever ranks exist: under an
initialised process group (``torchrun``; ``gloo`` on the CPU, ``nccl`` on
cards) every rank on one ``("data",)`` axis, as the reference's local
mesh is every visible device; without one, this process's own card (or
the CPU when asked for it) as a one-device mesh. A ``DeviceMesh`` is one
device per rank. The conversion's data mesh is another thing: one process
drives every visible card through ``kernels.ops.use_mesh``, a plain tuple
of devices.
"""
from __future__ import annotations

import torch

__all__ = ["make_production_mesh", "make_fake_mesh", "make_local_mesh",
           "PRODUCTION_SHAPES"]

#: mesh kind → (shape, axis names)
PRODUCTION_SHAPES = {
    "single": ((32, 8), ("data", "model")),
    "multi": ((2, 32, 8), ("pod", "data", "model")),
}


def _fake_world(world: int) -> None:
    """This process as rank 0 of a fake process group of at least
    ``world`` ranks (made of ``world`` where there is none yet)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < world or dist.get_backend() != "fake":
            raise RuntimeError(
                f"this process already has a {dist.get_backend()!r} group of "
                f"{dist.get_world_size()} ranks; a mesh of {world} needs a "
                f"fake group of at least {world} (build the largest mesh "
                "first, or each mesh in its own process)")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False):
    """(32, 8) = 256 H100s; (2, 32, 8) = 512 when ``multi_pod``; on a fake
    process group (module doc)."""
    return make_fake_mesh(*PRODUCTION_SHAPES["multi" if multi_pod
                                             else "single"])


def make_fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on the first ranks of
    a fake process group (the dry run's meshes; tests use small ones;
    module doc)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    _fake_world(n)
    return DeviceMesh("cpu", torch.arange(n).view(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_local_mesh(device=None, shape=None, axes=("data",)):
    """Every rank of this process's group on a ``("data",)`` axis (the
    dry run's fake group aside), each on its own ``device``: ``"cuda"``
    (each rank's card) for an ``nccl`` group, ``"cpu"`` for any other,
    unless ``device`` says; ``shape`` and ``axes`` lay the ranks out
    otherwise (a (2, 2) ``("data", "model")`` mesh of 4 ranks). Without a
    group, this process's device as a one-device mesh: the current CUDA
    card by default, ``device="cpu"`` for the CPU. Raises when a CUDA
    device is asked for and none is visible."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    grouped = dist.is_available() and dist.is_initialized() and \
        dist.get_backend() != "fake"
    if device is None:
        device = "cuda" if not grouped or "nccl" in str(
            dist.get_backend()) else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_local_mesh: no CUDA device is visible "
                           "(pass device='cpu' for the CPU)")
    if grouped:
        shape = (dist.get_world_size(),) if shape is None else tuple(shape)
        return init_device_mesh(dev.type, shape,
                                mesh_dim_names=tuple(axes))
    if shape is not None and tuple(shape) != (1,) * len(shape):
        raise ValueError(f"make_local_mesh: a {tuple(shape)} mesh needs a "
                         f"process group of its ranks")
    return DeviceMesh(dev.type, torch.arange(1), mesh_dim_names=("data",),
                      _init_backend=False, _rank=0)
