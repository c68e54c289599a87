"""The device mesh of a worker: its local cards and the process group.

Port of ``tpu_render_cluster/parallel/mesh.py``. The reference's mesh is a
1-D ``jax.sharding.Mesh`` over the global device set, brought up across
hosts by ``jax.distributed.initialize``. Here the mesh is a list of the
process's own devices, and the processes of a multi-host worker form a
``torch.distributed`` group: NCCL between the cards, gloo only where the
caller asked for the CPU. As in the reference, one process runs per host
and drives every card of that host.

In a group of P processes, each with ``local`` devices, the mesh has
``n = P * local`` shards; shard ``s`` belongs to process ``s // local``,
its local device ``s % local``. Every process must have the same local
count. On the CPU the mesh is ``n_devices`` entries of ``cpu`` (default
1), the stand-in for the 8 forced host devices under which the reference's
tests run.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from tpu_render_cluster_torch import resolve_device

# The reference's launcher variables (``jax.distributed``'s names): a
# launcher that starts reference workers starts port workers unchanged.
COORDINATOR_ENV = "JAX_COORDINATOR_ADDRESS"
PROCESSES_ENV = "JAX_NUM_PROCESSES"
PROCESS_ID_ENV = "JAX_PROCESS_ID"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device | None = None,
) -> bool:
    """Join (or skip) the worker's multi-host process group.

    Explicit arguments win; otherwise the reference's environment
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``).
    With no configuration at all this is a no-op returning False: the
    single-host path stays untouched. A partial triple raises
    ``ValueError``. Otherwise ``torch.distributed.init_process_group`` comes
    up at ``tcp://<coordinator_address>`` (process 0 listens there) with
    that world size and rank, over NCCL when ``device`` resolves to CUDA
    and over gloo when the CPU was asked for; there is no fallback from one
    to the other. Returns True when the group is up."""
    coordinator_address = coordinator_address or os.environ.get(COORDINATOR_ENV)
    env_processes = os.environ.get(PROCESSES_ENV)
    env_process_id = os.environ.get(PROCESS_ID_ENV)
    if num_processes is None and env_processes is not None:
        num_processes = int(env_processes)
    if process_id is None and env_process_id is not None:
        process_id = int(env_process_id)
    if coordinator_address is None and num_processes is None and process_id is None:
        return False  # single-host: nothing to join
    if coordinator_address is None or num_processes is None or process_id is None:
        # A partial triple is a launcher bug (say, the line exporting the
        # coordinator dropped from a SLURM script): coming up single-host
        # would "work" with the cross-host mesh never forming.
        raise ValueError(
            "Multi-host configuration is incomplete: coordinator_address="
            f"{coordinator_address!r}, num_processes={num_processes!r}, "
            f"process_id={process_id!r} — set all three (flags or "
            f"{COORDINATOR_ENV}/{PROCESSES_ENV}/{PROCESS_ID_ENV}) or none."
        )
    backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    return True


def local_device_count(device: str | torch.device | None = None) -> int:
    """The process's local devices: its CUDA cards, or 1 on the CPU."""
    if resolve_device(device).type == "cpu":
        return 1
    return torch.cuda.device_count()


def device_mesh(
    n_devices: int | None = None, *, device: str | torch.device | None = None
) -> list[torch.device]:
    """This process's devices of a 1-D mesh of ``n_devices`` shards
    (default: every local device of every process of the group).

    On CUDA the local cards ``cuda:0, cuda:1, ...`` in order, whatever
    card ``device`` names (only its type counts; the backend and the
    worker refuse a named card under sharding); asking for more than exist raises,
    as the reference does. On the CPU ``n_devices``
    entries of ``cpu`` (default 1). In a group of P processes ``n_devices``
    counts the whole mesh and must be a multiple of P: each process takes
    ``n_devices // P`` of its own."""
    return mesh_layout(n_devices, device=device).devices


class MeshLayout(NamedTuple):
    """A mesh as one process sees it: ``n`` shards in all, this process's
    devices, and the index of the first shard they hold."""

    n: int
    devices: list[torch.device]
    first_shard: int


def mesh_layout(
    n_devices: int | None = None, *, device: str | torch.device | None = None
) -> MeshLayout:
    """The mesh of ``device_mesh`` with its place in the process group.
    Without ``n_devices`` the local counts of the group's processes are
    compared (a collective: every process must call it), and a mismatch
    raises."""
    resolved = resolve_device(device)
    processes = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        local = local_device_count(resolved)
        if processes > 1:
            counts = [None] * processes
            dist.all_gather_object(counts, local)
            if len(set(counts)) != 1:
                raise ValueError(
                    f"The processes of the group hold {counts} devices: every process "
                    "must have the same local count."
                )
    else:
        if n_devices < 1 or n_devices % processes:
            raise ValueError(
                f"Requested {n_devices} devices over {processes} processes: the mesh "
                "must hold the same number of devices in every process."
            )
        local = n_devices // processes
        if resolved.type == "cuda" and local > torch.cuda.device_count():
            raise ValueError(
                f"Requested {local} devices in this process, have "
                f"{torch.cuda.device_count()}."
            )
    if resolved.type == "cpu":
        devices = [resolved] * local
    else:
        devices = [torch.device("cuda", index) for index in range(local)]
    rank = dist.get_rank() if dist.is_initialized() else 0
    return MeshLayout(n=processes * local, devices=devices, first_shard=rank * local)
