"""Process-group setup for the sharded codecs: the port's mesh.

The JAX package builds a 1-D `jax.sharding.Mesh` over its devices and runs
one controller over it (fastlanes_tpu/parallel/mesh.py). The PyTorch idiom
is one process per device, joined by collectives over a process group. A
mesh here is a 1-D `DeviceMesh` over the ranks of the default group, its one
dimension named `axis`: NCCL for CUDA, gloo for the CPU.

Device rule: `device=None` means CUDA and raises RuntimeError without one;
the CPU is used only when asked for by name (`device="cpu"`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import _engine as eng

BLOCK_AXIS = "blocks"


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _select_card(device: torch.device) -> None:
    """One card per rank: the one named, else rank mod the cards here."""
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = dist.get_rank() % torch.cuda.device_count() if dist.is_initialized() else 0
        torch.cuda.set_device(index)


def local_device_count(device=None) -> int:
    """Devices this process could drive: the CUDA devices on this host, or
    1 for the CPU."""
    device = eng.resolve_device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


def make_mesh(n_devices: Optional[int] = None, axis: str = BLOCK_AXIS,
              device=None) -> DeviceMesh:
    """1-D mesh over the block axis: the first `n_devices` ranks of the
    default group (all of them by default). Blocks never interact, so the
    codecs are data-parallel over every rank.

    In a single process this needs no setup: without a default group it
    starts a one-rank group on an in-process store."""
    device = eng.resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and n_devices > world:
        raise ValueError(f"asked for {n_devices} devices, have {world}")
    _select_card(device)
    ranks = list(range(world if n_devices is None else n_devices))
    return DeviceMesh(device.type, ranks, mesh_dim_names=(axis,))


def setup_distributed(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None, device=None) -> int:
    """Multi-process bring-up, one process per device: initialize the
    default group (NCCL for CUDA, gloo for the CPU) at `coordinator_address`
    (`host:port`, or an init-method URL such as `tcp://host:port` or
    `file:///path`). No-op for a single process.

    Returns the world size: the global device count of the mesh."""
    device = eng.resolve_device(device)
    if num_processes is not None and num_processes > 1:
        address = coordinator_address or ""
        if "://" not in address:
            address = "tcp://" + address
        dist.init_process_group(_backend(device), init_method=address,
                                world_size=num_processes, rank=process_id)
        _select_card(device)
    return dist.get_world_size() if dist.is_initialized() else 1
