"""POI batches spread over GPUs, one process per GPU (``torch.distributed``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` and shards
every ``[N, ...]`` POI array along axis 0; images and volumes are
replicated.  The port follows PyTorch's idiom: every rank is a process
with one device, the mesh is a 1-D ``DeviceMesh`` over the ranks, and a
sharded table is the rows this rank holds.  The same steps, in order:

* ``pad_to_multiple`` the table so that it divides the mesh;
* ``shard_table``: this rank's rows;
* run the modules on them (each rank has the images);
* ``gather_table``: every rank gets the whole table back (the JAX
  package's global array holds it implicitly);
* ``unpad``.

Start one process per GPU with ``torchrun --nproc-per-node=N``;
``make_mesh`` reads its environment.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.precision import DeviceLike, resolve_device

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _init_group(n_devices: Optional[int], dev: torch.device) -> None:
    # on a card, NCCL carries CUDA tensors and gloo the host's
    backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
    kw = dict(device_id=dev) if dev.type == "cuda" else {}
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://", **kw)
    elif n_devices in (None, 1):
        # a group of one in this process: no rendezvous, no network
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        raise RuntimeError(
            f"make_mesh({n_devices}): no process group is initialised and "
            "no torchrun environment is set; start one process per device "
            "with torchrun --nproc-per-node=N, or initialise "
            "torch.distributed first")


def make_mesh(n_devices: Optional[int] = None, axis: str = "poi",
              device: DeviceLike = None) -> DeviceMesh:
    """A 1-D ``DeviceMesh`` named ``axis`` over every rank of the process
    group, for ``device``'s type (``cuda`` by default, or ``cpu``).
    Without a group it initialises one from torchrun's environment (each
    rank on the GPU ``LOCAL_RANK``), or, at ``n_devices`` 1, a group of one
    on a local store: NCCL for CUDA tensors and gloo for host ones when
    ``device`` is a card, gloo alone on the CPU.  ``n_devices`` must equal
    the group's size when given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        _init_group(n_devices, dev)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{world} ranks")
    return DeviceMesh(dev.type, list(range(world)), mesh_dim_names=(axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    return resolve_device("cuda" if mesh.device_type == "cuda" else "cpu")


def pad_to_multiple(table, multiple: int):
    """Pad the POI batch (edge-replicating) so it divides the mesh; returns
    (padded_table, original_n)."""
    n = table.n
    pad = -n % multiple
    if pad == 0:
        return table, n
    return table.map(lambda a: torch.cat(
        [a, a[-1:].expand((pad,) + a.shape[1:])])), n


def unpad(table, n: int):
    return table.map(lambda a: a[:n])


def shard_table(table, mesh: DeviceMesh, axis: str = "poi"):
    """This rank's rows of a table padded to a multiple of the mesh."""
    k = mesh.size(mesh.mesh_dim_names.index(axis))
    if table.n % k:
        raise ValueError(f"table of {table.n} POIs does not divide a mesh "
                         f"of {k}; pad_to_multiple first")
    rows = table.n // k
    lo = mesh.get_local_rank(axis) * rows
    return table.map(lambda a: a[lo:lo + rows])


def gather_table(table, mesh: DeviceMesh, axis: str = "poi"):
    """Every rank's rows, in rank order, on every rank: the whole table
    (one all-gather of the fields packed side by side)."""
    group = mesh.get_group(axis)
    cols = [getattr(table, f) for f in table.FIELDS]
    flat = torch.cat([c.reshape(table.n, -1) for c in cols], 1).contiguous()
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    whole, out, lo = torch.cat(parts), [], 0
    for c in cols:
        w = int(np.prod(c.shape[1:]))
        out.append(whole[:, lo:lo + w].reshape((-1,) + tuple(c.shape[1:])))
        lo += w
    return type(table)(*out)


def replicate(x: torch.Tensor, mesh: DeviceMesh,
              axis: Optional[str] = None) -> torch.Tensor:
    """Rank 0's tensor on every rank of the mesh."""
    group = mesh.get_group(axis)
    out = x.clone().contiguous()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out
