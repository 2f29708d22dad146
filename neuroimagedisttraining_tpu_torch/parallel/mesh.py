"""The device mesh of one process.

The reference has a single controller: one process drives every device
of a ``jax.sharding.Mesh``, and a stacked client axis ``[C, ...]`` is
sharded over it. The port follows it without a multi-process transport: a
:class:`Mesh` is an ordered grid of ``torch.device`` entries in one
process, each entry with its own CUDA stream on a card, and collectives
are peer copies and sums in a fixed order (``parallel/cohort.py``,
``hierarchical.py``, ``gossip.py``). ``--virtual_devices N`` makes a mesh
of N entries on the run's device (N streams on ``cuda:0``, or N CPU
entries, as the reference provisions N virtual CPU devices); with no flag
the mesh is every visible device, one on a one-card machine.
"""

from __future__ import annotations

import numpy as np
import torch

CLIENT_AXIS = "clients"
SILO_AXIS = "silos"  # outer axis of a two-level (silo, client) mesh


class Mesh:
    """An ordered grid of devices with named axes; ``devices`` is an object
    array of ``torch.device`` (``devices.size`` entries, row-major), and
    each CUDA entry has its own stream (``streams``, in entry order)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in devices.flat]

    @property
    def entries(self) -> list[torch.device]:
        return list(self.devices.flat)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.devices.shape)

    def stream(self, i: int):
        """A context running entry ``i``'s work on its stream (a no-op on
        the CPU)."""
        import contextlib

        s = self.streams[i]
        return (torch.cuda.stream(s) if s is not None
                else contextlib.nullcontext())

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


def make_mesh(num_devices: int | None = None, devices=None,
              axis_name: str = CLIENT_AXIS,
              shape: tuple[int, ...] = ()) -> Mesh:
    """A 1-D mesh over ``devices`` (or their first ``num_devices``); a
    2-entry ``shape`` (``--mesh_shape S C``) makes the two-level
    ``(silos, clients)`` mesh. The reference's checks and messages."""
    if devices is None:
        devices = visible_devices("cuda" if torch.cuda.is_available()
                                  else "cpu")
    devices = list(devices)
    if shape and (len(shape) > 2 or any(s < 1 for s in shape)):
        raise ValueError(
            f"--mesh_shape must be 1 or 2 positive integers, got {shape}")
    if len(shape) == 2:
        need = shape[0] * shape[1]
        if len(devices) < need:
            raise ValueError(
                f"--mesh_shape {shape} needs {need} devices, "
                f"have {len(devices)}")
        grid = np.empty(need, dtype=object)
        grid[:] = devices[:need]
        return Mesh(grid.reshape(shape), (SILO_AXIS, CLIENT_AXIS))
    if shape:
        num_devices = shape[0]
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"mesh needs {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, (axis_name,))


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
