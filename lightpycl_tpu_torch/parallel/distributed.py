"""Multi-process bootstrap and the mesh helpers the sharded paths share.

Port counterpart of lightpycl_tpu/parallel/distributed.py. JAX runs one
program over every device of a mesh; torch.distributed runs one process a
rank, each on its own device, and the ranks meet only in collectives. So a
sharded trace here is SPMD by launch: every rank calls the same entry
point with the same arguments (the same source and seed, so the same
rays), keeps its own shard, and the collectives combine the shards.

  * `init_distributed` starts the process group: `env://` under torchrun
    (`torchrun --nproc-per-node N script.py`, one card a rank), or the
    given coordinator. The backend is explicit: NCCL when the rank's device
    is a card, gloo on the CPU; gloo also runs collectives on CUDA tensors,
    which is how several ranks can share one card (NCCL refuses that, and
    its refusal is not swapped for gloo here).
  * `ensure_process_group` starts a one-rank group when none exists, so a
    sharded mode works in a plain single process, as the reference's does
    on one chip.
  * `axis` gives a DeviceMesh axis as (size, this rank's index, group);
    `all_reduce_packed` reduces a list of float32 tensors over an axis in
    one collective; `check_device` refuses a tracer whose device is not its
    rank's.

Only all_reduce (SUM / MIN / MAX) and barrier are used, on tensors on the
rank's device, so one code path runs on NCCL and on gloo.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from lightpycl_tpu_torch.utils.profiling import span

log = logging.getLogger("lightpycl_tpu_torch.distributed")


def rank_device() -> torch.device:
    """This rank's device: cuda:<LOCAL_RANK> under torchrun (set as the
    current device when no card was chosen yet), else the current card,
    else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if "LOCAL_RANK" in os.environ and not torch.cuda.is_initialized():
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", torch.cuda.current_device())


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Start the default process group (a no-op when one exists) and return
    the world size.

    `coordinator_address` is 'host:port' (TCP, rank 0 listens there) or an
    init-method URL ('file:///path/store'); without it the group is read
    from the environment (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, as torchrun sets them). `backend` defaults to 'nccl' when this
    rank's device is a card and 'gloo' on the CPU."""
    if dist.is_initialized():
        log.info("distributed: already initialized (%d ranks)",
                 dist.get_world_size())
        return dist.get_world_size()
    backend = backend or _backend_for(rank_device())
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init_method, **kw)
    log.info("distributed: rank %d of %d on %s (%s)", dist.get_rank(),
             dist.get_world_size(), rank_device(), backend)
    return dist.get_world_size()


def ensure_process_group(device: torch.device) -> None:
    """A one-rank group on `device`'s backend when no group exists yet (its
    store lives in this process: no address, no file)."""
    if not dist.is_initialized():
        dist.init_process_group(_backend_for(device), store=dist.HashStore(),
                                rank=0, world_size=1)


def world_size(device=None) -> int:
    """The process group's rank count, after starting a one-rank group on
    `device` (default: this rank's device) when none exists."""
    ensure_process_group(rank_device() if device is None
                         else torch.device(device))
    return dist.get_world_size()


def axis(mesh, name: str):
    """(size, this rank's index, process group) of the mesh axis `name`.
    A mesh without that axis raises AttributeError, as the reference's
    `mesh.shape[name]` does on an object that is no mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if not names or name not in names:
        raise AttributeError(
            f"mesh needs a torch DeviceMesh axis {name!r} "
            f"(make_ray_mesh / make_tri_mesh / make_mesh2d), got "
            f"{type(mesh).__name__} with axes {names}")
    return (int(mesh.shape[names.index(name)]), int(mesh.get_local_rank(name)),
            mesh.get_group(name))


def check_device(mesh, device: torch.device) -> None:
    """Raise unless `device` is the device this rank's mesh runs on."""
    device = torch.device(device)
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh runs on {mesh.device_type}, the tracer "
                         f"on {device}")
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        if index != torch.cuda.current_device():
            raise ValueError(
                f"the tracer runs on {device}, but this rank's card is "
                f"cuda:{torch.cuda.current_device()} (torch.cuda.set_device "
                "or LOCAL_RANK picks it)")


def all_reduce_packed(tensors, group, op=dist.ReduceOp.SUM):
    """All-reduce float32 tensors with `op` (default SUM) over `group` in
    ONE collective (flattened into one buffer and split back). Returns new
    tensors of the same shapes."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    with span("parallel.all_reduce"):
        dist.all_reduce(flat, op=op, group=group)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return out


def barrier(mesh) -> None:
    """Every rank of `mesh` has reached this point: one all-reduce over each
    axis in turn (a rank passes the second only after every rank of its
    line passed the first, so after both every rank of the mesh has
    arrived). Device tensors, so it runs on NCCL and gloo alike."""
    dev = torch.device(mesh.device_type, torch.cuda.current_device()
                       if mesh.device_type == "cuda" else None)
    x = torch.zeros(1, device=dev)
    for name in mesh.mesh_dim_names:
        dist.all_reduce(x, group=mesh.get_group(name))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def is_origin(mesh) -> bool:
    """True on the rank at index 0 of every axis of `mesh`."""
    return all(mesh.get_local_rank(n) == 0 for n in mesh.mesh_dim_names)
