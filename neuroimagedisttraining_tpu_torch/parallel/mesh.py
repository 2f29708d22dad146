"""The device mesh: of one process, or spanning the ranks of a process
group.

The reference has a single controller: one process drives every device
of a ``jax.sharding.Mesh``, and a stacked client axis ``[C, ...]`` is
sharded over it; under ``jax.distributed`` the mesh spans every host's
devices. In the port a :class:`Mesh` is an ordered grid of entries, each a
``torch.device`` with its own CUDA stream on a card, and collectives are
peer copies and sums in a fixed order (``parallel/cohort.py``,
``hierarchical.py``, ``gossip.py``). ``--virtual_devices N`` makes N
entries on the run's device (N streams of ``cuda:0``, or N CPU entries, as
the reference provisions N virtual CPU devices); with no flag the entries
are every visible device, one on a one-card machine.

Across processes (``--multihost_coordinator``, a ``torch.distributed``
group joined by ``distributed/cross_silo.py`` ``init_multihost``) the
global entries are every rank's local entries concatenated in rank order,
as ``jax.devices()`` orders processes (:func:`global_entries`). Each entry
knows its owning rank (:meth:`Mesh.rank_of`); :attr:`Mesh.local_entries`
are this process's. An entry another rank owns stands, in this process,
for this process's first local device: the work a mesh places there (the
round's tail, which every rank runs on the exchanged states) runs here.
A mesh in which some rank owns no entry is refused.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

CLIENT_AXIS = "clients"
SILO_AXIS = "silos"  # outer axis of a two-level (silo, client) mesh


class Mesh:
    """An ordered grid of devices with named axes; ``devices`` is an object
    array of ``torch.device`` (``devices.size`` entries, row-major), and
    each local CUDA entry has its own stream (``streams``, in entry
    order). ``ranks``: each entry's owning rank (row-major; None: every
    entry this process's), ``process_id``: this process's rank."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 ranks=None, process_id: int = 0, streams=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_id = int(process_id)
        self.ranks = (np.full(devices.size, self.process_id, np.int64)
                      if ranks is None else np.asarray(ranks, np.int64))
        self.streams = (streams if streams is not None else
                        [torch.cuda.Stream(d)
                         if d.type == "cuda" and self.is_local(i) else None
                         for i, d in enumerate(devices.flat)])
        self._flat = None

    @property
    def entries(self) -> list[torch.device]:
        return list(self.devices.flat)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def num_processes(self) -> int:
        """The ranks that own the mesh's entries."""
        return int(self.ranks.max()) + 1

    @property
    def local_entries(self) -> list[int]:
        """The indices (row-major) of this process's entries."""
        return [i for i in range(self.devices.size) if self.is_local(i)]

    def rank_of(self, entry: int) -> int:
        """The rank that owns entry ``entry`` (row-major index)."""
        return int(self.ranks[entry])

    def is_local(self, entry: int) -> bool:
        return self.rank_of(entry) == self.process_id

    def stream(self, i: int):
        """A context running entry ``i``'s work on its stream (a no-op on
        the CPU and for another rank's entry)."""
        s = self.streams[i]
        return (torch.cuda.stream(s) if s is not None
                else contextlib.nullcontext())

    def first(self, n: int) -> "Mesh":
        """The 1-D mesh of the first ``n`` entries (a shrunk mesh), each
        with its owner."""
        return make_mesh(num_devices=n, devices=self.entries,
                         ranks=list(self.ranks), process_id=self.process_id)

    def flat(self) -> "Mesh":
        """The same entries, with their owners and streams, as a 1-D
        client mesh (row-major: silo-major on a two-level mesh); the mesh
        itself where it is 1-D."""
        if len(self.axis_names) == 1:
            return self
        if self._flat is None:
            grid = np.empty(self.devices.size, dtype=object)
            grid[:] = self.entries
            self._flat = Mesh(grid, (CLIENT_AXIS,), ranks=self.ranks,
                              process_id=self.process_id,
                              streams=self.streams)
        return self._flat

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.axis_names})"


def visible_devices(device: torch.device | str) -> list[torch.device]:
    """Every visible device of ``device``'s type: the CUDA cards, or the
    one CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def virtual_devices(n: int, device: torch.device | str) -> list[torch.device]:
    """``n`` mesh entries on ``device`` (the reference's ``n`` virtual CPU
    devices; on a card, ``n`` streams of it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return [device] * int(n)


def global_entries(local: list[torch.device]
                   ) -> tuple[list[torch.device], list[int], int]:
    """``(devices, ranks, process_id)`` of the process group's global
    entries: every rank's ``local`` entries concatenated in rank order
    (each rank's count learnt by one ``all_reduce``), another rank's entry
    standing for this process's first local device. Without a group of
    more than one process, ``local`` alone."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return list(local), [0] * len(local), 0
    me, world = dist.get_rank(), dist.get_world_size()
    counts = torch.zeros(world, dtype=torch.int64)
    counts[me] = len(local)
    dist.all_reduce(counts)
    devices, ranks = [], []
    for r, n in enumerate(counts.tolist()):
        devices += list(local) if r == me else [local[0]] * n
        ranks += [r] * n
    return devices, ranks, me


def make_mesh(num_devices: int | None = None, devices=None,
              axis_name: str = CLIENT_AXIS,
              shape: tuple[int, ...] = (), ranks=None,
              process_id: int = 0) -> Mesh:
    """A 1-D mesh over ``devices`` (or their first ``num_devices``); a
    2-entry ``shape`` (``--mesh_shape S C``) makes the two-level
    ``(silos, clients)`` mesh. ``ranks``: each device's owning rank, for
    a mesh over the global entries of several processes (None: all this
    process's). The reference's checks and messages, and a mesh in which
    a rank owns no entry is refused."""
    if devices is None:
        devices = visible_devices("cuda" if torch.cuda.is_available()
                                  else "cpu")
    devices = list(devices)
    ranks = [process_id] * len(devices) if ranks is None else list(ranks)
    if shape and (len(shape) > 2 or any(s < 1 for s in shape)):
        raise ValueError(
            f"--mesh_shape must be 1 or 2 positive integers, got {shape}")
    if len(shape) == 2:
        need = shape[0] * shape[1]
        if len(devices) < need:
            raise ValueError(
                f"--mesh_shape {shape} needs {need} devices, "
                f"have {len(devices)}")
        take, names = need, (SILO_AXIS, CLIENT_AXIS)
    else:
        if shape:
            num_devices = shape[0]
        if num_devices is not None and len(devices) < num_devices:
            raise ValueError(
                f"mesh needs {num_devices} devices, have {len(devices)}")
        take = len(devices) if num_devices is None else num_devices
        names = (axis_name,)
    if ranks != sorted(ranks):
        raise ValueError(f"mesh entries must come in rank order (every "
                         f"rank's entries after the rank before), got "
                         f"ranks {ranks}")
    idle = sorted(set(ranks) - set(ranks[:take]))
    if idle:
        raise ValueError(
            f"a mesh of {take} of the {len(devices)} entries leaves rank(s) "
            f"{idle} without an entry; every process of the group needs "
            "one (more --virtual_devices on each rank, or a larger "
            "--client_mesh / --mesh_shape)")
    grid = np.empty(take, dtype=object)
    grid[:] = devices[:take]
    return Mesh(grid.reshape(shape) if len(shape) == 2 else grid, names,
                ranks=ranks[:take], process_id=process_id)


def pad_to_multiple(n: int, d: int) -> int:
    return ((n + d - 1) // d) * d


def shard_federation(tree: dict, mesh: Mesh) -> dict:
    """Each stacked tensor of ``tree`` (leading client axis, a multiple of
    the mesh size) as the list of its consecutive client blocks, each on
    its entry's device."""
    D = mesh.devices.size
    out = {}
    for k, x in tree.items():
        if x.shape[0] % D:
            raise ValueError(
                f"shard_federation: {k}'s client axis ({x.shape[0]}) does "
                f"not tile the {D}-entry mesh — pad the federation first")
        B = x.shape[0] // D
        out[k] = [x[i * B:(i + 1) * B].to(dev)
                  for i, dev in enumerate(mesh.entries)]
    return out
