"""Device meshes and the ``torch.distributed`` init hook.

FUNCTIONS, not module-level constants: importing this module touches no
device and starts no process group.

A :class:`DeviceMesh` stands in for the reference's ``jax.sharding.Mesh``
on the serving path: the devices of this process, one per local shard,
named axes with sizes (``shape[axis]``, ``axis_names``), and optionally a
``torch.distributed`` process group that joins the same mesh in other
processes.  ``dist.shard_refine`` runs one block of S per shard.
"""

from __future__ import annotations

import math
import os

import torch


class DeviceMesh:
    """Shards over devices: ``devices`` holds this process's shards, one
    device each (a device may repeat: two logical shards on one card are
    a mesh too); ``group`` is the process group whose every process holds
    as many shards (None: this process alone).  Shards are numbered
    process-major, so process r holds shards r·n .. r·n+n-1 of the
    ``size`` in all.  ``shape`` maps each axis name to its size; their
    product is ``size`` (default: every shard on the first axis)."""

    def __init__(self, devices, shape=None, axes=("data", "model"),
                 group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axes)
        self.group = group
        if group is None:
            self.n_processes, self.rank = 1, 0
        else:
            import torch.distributed as dist

            self.n_processes = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        n = len(self.devices) * self.n_processes
        if shape is None:
            shape = (n,) + (1,) * (len(self.axis_names) - 1)
        shape = tuple(int(x) for x in shape)
        if len(shape) != len(self.axis_names) or math.prod(shape) != n:
            raise ValueError(f"mesh shape {shape} over axes "
                             f"{self.axis_names} does not hold {n} shards")
        self.shape = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        """Shards in all processes."""
        return len(self.devices) * self.n_processes

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    def __repr__(self):
        return (f"DeviceMesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices]}, "
                f"process {self.rank}/{self.n_processes})")


def _default_group():
    """The default process group when ``torch.distributed`` runs, else
    None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _local_devices(n_devices, device, group):
    """This process's shard devices.  ``device`` may be a list (taken as
    it is), "cuda" (distinct cards: all of them, or with a process group
    the card of this rank), or one device ("cpu", "cuda:0"), repeated
    ``n_devices`` times (default once)."""
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if n_devices is not None and int(n_devices) != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} "
                             "devices were given")
        return devs
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.dist.cluster import resolve_device

        resolve_device(dev)  # no card: raise, never fall back
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        cards = [torch.device("cuda", i) for i in range(count)]
        if group is not None and n_devices is None:
            import torch.distributed as dist

            return [cards[dist.get_rank(group) % count]]
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(
                f"n_devices={n} out of range (host has {count} devices)")
        return cards[:n]
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices={n} out of range")
    return [dev] * n


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh: 16×16 = 256 shards on ("data",
    "model"), or with ``multi_pod`` 2×16×16 on ("pod", "data", "model"),
    as logical shards of one device (the first card by default; no card
    raises).  It starts no process group: the dry-run resolves per-device
    shapes on it and runs nothing across it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return DeviceMesh(_local_devices(math.prod(shape), dev, None), shape,
                      axes)


def make_mesh(shape, axes, device="cuda"):
    """A mesh of ``prod(shape)`` shards over these axes (split evenly
    over the processes of the default group, when one runs)."""
    import torch.distributed as dist

    group = _default_group()
    world = 1 if group is None else dist.get_world_size(group)
    total = math.prod(int(x) for x in shape)
    if total % world:
        raise ValueError(f"{total} shards do not split over {world} "
                         "processes")
    devs = _local_devices(total // world, device, group)
    return DeviceMesh(devs, tuple(shape), tuple(axes), group)


def make_host_mesh(n_devices: int | None = None, axes=("data", "model"),
                   device="cuda"):
    """A (n, 1) mesh over ``n_devices`` shards of this host.

    On the card (the default) it spans the local cards, or with a
    process group running this rank's card; ``device="cpu"`` with
    ``n_devices=N`` gives N logical shards on the CPU (the tests' stand-in
    for ``XLA_FLAGS=--xla_force_host_platform_device_count=N``), and a
    device list may repeat a device.  Asking for the card on a host
    without one raises.
    """
    group = _default_group()
    devs = _local_devices(n_devices, device, group)
    return DeviceMesh(devs, None, tuple(axes), group)


def _process_group_args(coordinator_address=None, num_processes=None,
                        process_id=None):
    """``init_process_group`` arguments from the explicit arguments, then
    ``REPRO_COORDINATOR``, ``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``
    and ``REPRO_DISTRIBUTED_AUTO``; None when nothing is configured.  A
    coordinator ``host:port`` becomes ``tcp://host:port``; one with a
    scheme (``file://...``, ``tcp://...``) is used as it is.  Auto mode
    without a coordinator reads ``torch.distributed``'s own environment
    (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)."""
    coord = coordinator_address or os.environ.get("REPRO_COORDINATOR")
    auto = os.environ.get("REPRO_DISTRIBUTED_AUTO", "")
    if coord is None and not auto:
        return None
    if coord is None:
        return {"init_method": "env://"}
    kw = {"init_method": coord if "://" in coord else f"tcp://{coord}"}
    nproc = (num_processes if num_processes is not None
             else os.environ.get("REPRO_NUM_PROCESSES"))
    pid = (process_id if process_id is not None
           else os.environ.get("REPRO_PROCESS_ID"))
    if nproc is not None:
        kw["world_size"] = int(nproc)
    if pid is not None:
        kw["rank"] = int(pid)
    return kw


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> bool:
    """Initialize ``torch.distributed`` for multi-process serving: NCCL
    when ``device`` is the card (each process then takes card rank mod
    the card count), gloo on the CPU.

    Explicit arguments win; otherwise the coordinator comes from
    ``REPRO_COORDINATOR`` with process counts from
    ``REPRO_NUM_PROCESSES``/``REPRO_PROCESS_ID``, or, with
    ``REPRO_DISTRIBUTED_AUTO`` set, from a launcher's environment.

    Returns True when initialization ran, False when no coordinator was
    configured (single-process mode: the caller proceeds with local
    devices only — the same code path, a 1-process mesh).
    """
    import torch.distributed as dist

    kw = _process_group_args(coordinator_address, num_processes, process_id)
    if kw is None:
        return False
    cuda = torch.device(device).type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", **kw)
    if cuda:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return True
