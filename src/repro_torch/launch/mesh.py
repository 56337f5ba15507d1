"""Device meshes over ``torch.distributed``, and the ranks that hold them.

The counterpart of ``src/repro/launch/mesh.py``: ``model`` is the
intra-pod level (MemPool's group interconnect), ``data`` FSDP / data
parallelism within a pod, ``pod`` the cluster level (gradient reduction
only). A mesh is one rank a device: a ``DeviceMesh``
(``torch.distributed.device_mesh.init_device_mesh``) over the default
process group, wrapped as :class:`repro_torch.distributed.sharding.Mesh`.

The process group meets through a ``file://`` store, never TCP: gloo on
the CPU, NCCL on the card (rank r on ``cuda:r``). :func:`spawn` starts
the ranks of one host with ``torch.multiprocessing``; :func:`ranks` joins
the process to a group of its own when none is set up and the mesh has one
rank, so a ``1x1`` mesh takes the same path as a larger one.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.sharding import Mesh


def parse_mesh(spec: str, axes: str = "data,model"):
    """Parse the CLIs' ``--mesh`` / ``--mesh-axes`` flags.

    ``spec`` is either one int (model-parallel shorthand: ``"2"`` means
    ``1x2``) or ``"DxM[xP...]"`` sizes matching ``axes`` (comma-separated
    axis names, default ``"data,model"``). Returns ``(sizes, names)``.
    """
    names = tuple(a.strip() for a in axes.split(",") if a.strip())
    if not names:
        raise ValueError(f"--mesh-axes names no axes: {axes!r}")
    if "x" in spec:
        sizes = tuple(int(x) for x in spec.split("x"))
    else:
        sizes = (1,) * (len(names) - 1) + (int(spec),)
    if len(sizes) != len(names):
        raise ValueError(
            f"--mesh {spec!r} has {len(sizes)} sizes but --mesh-axes "
            f"names {len(names)} axes ({', '.join(names)})")
    if any(s < 1 for s in sizes):
        raise ValueError(f"--mesh sizes must be >= 1, got {spec!r}")
    return sizes, names


def mesh_ranks(sizes: Sequence[int]) -> int:
    n = 1
    for s in sizes:
        n *= s
    return n


def backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank`` on the card, else ``device``."""
    return torch.device("cuda", rank) if device.type == "cuda" else device


def check_devices(n: int, device: torch.device, what: str) -> None:
    """Raise unless the card has ``n`` GPUs for ``n`` ranks."""
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"{what} needs {n} GPUs (one a rank), have "
            f"{torch.cuda.device_count()}")


def make_mesh(sizes: Sequence[int], names: Sequence[str],
              device: torch.device, what: str = "the mesh") -> Mesh:
    """A mesh of ``sizes`` named ``names`` over the default process group,
    which must hold exactly that many ranks."""
    n = mesh_ranks(sizes)
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group of {n} ranks; "
                           f"start the ranks first (launch.mesh.ranks or "
                           f"launch.mesh.spawn)")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"{what} needs {n} ranks, have {world}")
    check_devices(n, device, what)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, tuple(sizes),
                          mesh_dim_names=tuple(names))
    return Mesh(dm, rank_device(device, dist.get_rank()))


def make_host_mesh(data: int = 1, model: int = 1,
                   device: torch.device = torch.device("cpu")) -> Mesh:
    """A small ``(data, model)`` mesh (tests and examples)."""
    return make_mesh((data, model), ("data", "model"), device)


def make_cli_mesh(spec: str, axes: str = "data,model",
                  device: torch.device = torch.device("cpu")) -> Mesh:
    """The mesh of the CLIs' ``--mesh`` / ``--mesh-axes``."""
    sizes, names = parse_mesh(spec, axes)
    return make_mesh(sizes, names, device, what=f"--mesh {spec}")


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device = torch.device("cuda")
                         ) -> Mesh:
    """The production mesh: ``(16, 16)`` data x model, or ``(2, 16, 16)``
    pod x data x model."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device, what=f"the production mesh {shape}")


# ------------------------------------------------------------------ ranks

def init_ranks(rank: int, world: int, store: str,
               device: torch.device) -> torch.device:
    """Join rank ``rank`` of ``world`` through the file store at ``store``;
    returns the rank's device."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend(device), init_method=f"file://{store}",
                            rank=rank, world_size=world)
    return dev


@contextlib.contextmanager
def ranks(world: int, device: torch.device):
    """The process group to run a ``world``-rank mesh in: the one already
    set up (its size must be ``world``), else, for ``world`` = 1, a group
    of this process alone, torn down on exit. More ranks than one are
    started by :func:`spawn`."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a mesh of {world} ranks in a process group "
                               f"of {dist.get_world_size()}")
        yield
        return
    if world != 1:
        raise RuntimeError(f"a mesh of {world} ranks needs its ranks "
                           f"started (launch.mesh.spawn)")
    check_devices(1, device, "a one-rank mesh")
    tmp = tempfile.mkdtemp(prefix="repro_torch_store_")
    hook = sys.excepthook       # the group wraps it to prefix the rank
    try:
        init_ranks(0, 1, os.path.join(tmp, "store"), device)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        sys.excepthook = hook
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, world: int, store: str, device_str: str,
               fn: Callable, args: tuple) -> None:
    device = torch.device(device_str)
    if device.type == "cpu":
        # the ranks share the host's cores: more than one thread a rank
        # oversubscribes them (8x slower serving at world 2 on 8 cores)
        torch.set_num_threads(1)
    init_ranks(rank, world, store, device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device: torch.device,
          args: tuple = ()) -> None:
    """Run ``fn(*args)`` on ``world`` new ranks of this host, each in a
    process group of ``world`` through a file store (rank r on ``cuda:r``
    on the card). Returns when every rank has returned; a rank that raises
    or exits non-zero fails the whole run
    (``torch.multiprocessing.ProcessRaisedException`` /
    ``ProcessExitedException``)."""
    check_devices(world, device, f"{world} ranks")
    tmp = tempfile.mkdtemp(prefix="repro_torch_store_")
    try:
        mp.spawn(_rank_main, args=(world, os.path.join(tmp, "store"),
                                   str(device), fn, args),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
