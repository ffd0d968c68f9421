"""Process-group start-up, and the world the distributed paths run on.

Counterpart of `fsw_gnn_tpu/parallel/runtime.py`.  The JAX package runs one
program over a mesh of devices; the port runs one process per device, each
holding its own shard, joined by a `torch.distributed` process group: NCCL
between cards (rank r takes `cuda:LOCAL_RANK`), gloo where the caller asks
for the CPU.

`ensure_distributed()` starts the group from torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT), from
FSW_DIST_INIT_METHOD (the file store `parallel.launch` sets), or from an
explicit `init_method`; without any of them it does nothing, as in the JAX
package.  `Mesh` stands in for the JAX mesh: the default group's size,
this process's rank and the device it computes on.  Every metadata array
is built on every host from the same inputs (the "host-replicated
metadata" pattern of the JAX package's `make_global_array`), and each
rank keeps its own slice.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

INIT_METHOD_ENV = 'FSW_DIST_INIT_METHOD'


def local_device(device=None) -> torch.device:
    """`device` as `resolve_device` gives it, with a CUDA device that names
    no index taken as this process's card, cuda:LOCAL_RANK."""
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    return dev


def ensure_distributed(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       device=None) -> bool:
    """Start the default process group once, if one is asked for (an
    `init_method`, FSW_DIST_INIT_METHOD, or torchrun's RANK and
    WORLD_SIZE), on NCCL for a CUDA `device` (None: the card) and gloo for
    the CPU.  Returns whether the world holds more than one process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    init_method = init_method or os.environ.get(INIT_METHOD_ENV)
    torchrun = 'RANK' in os.environ and 'WORLD_SIZE' in os.environ
    if init_method is None and not torchrun:
        return False
    world_size = int(os.environ['WORLD_SIZE'] if world_size is None
                     else world_size)
    rank = int(os.environ['RANK'] if rank is None else rank)
    dev = local_device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                            init_method=init_method or 'env://',
                            world_size=world_size, rank=rank)
    return world_size > 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of `size` processes (the default process group): this
    process's `rank` and the device its shard lives on."""
    size: int
    rank: int
    device: torch.device


def _launch_hint(n: int) -> str:
    return (f'launch one process per device: torchrun --nproc-per-node {n} '
            f'-m fsw_gnn_tpu_torch.cli train --num-devices {n} ..., or '
            f'python -m fsw_gnn_tpu_torch.parallel.launch --nproc {n} -- '
            f'train --num-devices {n} ...')


def make_graph_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the started process group (see `ensure_distributed`),
    its ranks the shards.  `num_devices` must equal the world size; a
    missing group or another world size raises a RuntimeError that says
    how to launch.  There is no single-device fallback."""
    if not dist.is_initialized():
        n = num_devices or 1
        raise RuntimeError(
            f'num_devices={n} needs a torch.distributed process group of '
            f'{n} processes and none is started (world size 0); '
            + _launch_hint(n))
    size = dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise RuntimeError(
            f'num_devices={num_devices} but the process group holds '
            f'{size} processes (world size {size}); '
            + _launch_hint(num_devices))
    dev = local_device(device)
    backend = dist.get_backend()
    if (dev.type == 'cuda') != (backend == 'nccl'):
        raise RuntimeError(f'a {backend} process group cannot exchange '
                           f'tensors on {dev}: NCCL serves the card, gloo '
                           f'the CPU')
    return Mesh(size=size, rank=dist.get_rank(), device=dev)


make_data_mesh = make_graph_mesh
global_mesh = make_graph_mesh


def broadcast_module(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers into every rank's `module`, so
    the replicas start alike whatever each drew."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (a small picklable value)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
