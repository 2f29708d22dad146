"""Spatial (depth) sharding of a 3D convolution over the mesh (the
reference package's ``parallel/spatial.py``).

A stride-1 'SAME' Conv3D whose depth axis is cut into one block a mesh
entry: each entry takes ``kd // 2`` halo rows from each neighbour (zeros
at the volume's edges) and convolves its block on its own device. The
reference uses it only in its own test (an 8-device CPU mesh against the
unsharded conv at 1e-5); the port keeps its layout (NDHWC input, DHWIO
kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neuroimagedisttraining_tpu_torch.parallel.mesh import Mesh, make_mesh

SPACE_AXIS = "space"


def make_space_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    return make_mesh(num_devices=num_devices, devices=devices,
                     axis_name=SPACE_AXIS)


def spatial_sharded_conv3d(x: torch.Tensor, kernel: torch.Tensor,
                           mesh: Mesh,
                           bias: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 'SAME' Conv3D of ``x`` ``[B, D, H, W, Cin]`` (D divisible
    by the mesh size) with ``kernel`` ``[kd, kh, kw, Cin, Cout]`` (odd
    sizes), the depth blocks on the mesh's entries with halos from their
    neighbours. Returns ``[B, D, H, W, Cout]`` on ``x``'s device."""
    kd, kh, kw = kernel.shape[:3]
    if kd % 2 != 1 or kh % 2 != 1 or kw % 2 != 1:
        raise ValueError("all kernel dims must be odd for SAME semantics")
    halo = kd // 2
    n = mesh.devices.size
    if x.shape[1] % n:
        raise ValueError(f"depth {x.shape[1]} not divisible by mesh size "
                         f"{n}")
    blk = x.shape[1] // n
    if blk < halo:
        raise ValueError("each shard must hold at least `halo` rows")
    w = kernel.permute(4, 3, 0, 1, 2).contiguous()       # DHWIO -> OIDHW
    xs = x.permute(0, 4, 1, 2, 3)                        # -> NCDHW
    outs = []
    for i, dev in enumerate(mesh.entries):
        xb = xs[:, :, i * blk:(i + 1) * blk]
        if halo:
            zeros = xb.new_zeros(xb.shape[:2] + (halo,) + xb.shape[3:])
            left = (xs[:, :, i * blk - halo:i * blk] if i > 0 else zeros)
            right = (xs[:, :, (i + 1) * blk:(i + 1) * blk + halo]
                     if i < n - 1 else zeros)
            xb = torch.cat([left, xb, right], 2)
        s = mesh.streams[i]
        if s is not None:  # the halo was cut on the caller's stream
            s.wait_stream(torch.cuda.current_stream(s.device))
        with mesh.stream(i):
            out = F.conv3d(xb.to(dev), w.to(dev),
                           None if bias is None else bias.to(dev),
                           padding=(0, kh // 2, kw // 2))
        outs.append(out.to(x.device))
    for s in mesh.streams:
        if s is not None:
            torch.cuda.current_stream(s.device).wait_stream(s)
    return torch.cat(outs, 2).permute(0, 2, 3, 4, 1).contiguous()
