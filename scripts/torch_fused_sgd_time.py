"""Device time of one fused SGD step (``ops/fused_update.py``
``fused_sgd_step``) on one CUDA card, for a port tree given by its root,
so that two trees can be timed in turns within one call.

    python3 scripts/torch_fused_sgd_time.py [--root DIR] [--iters N]

Times the step over the flagship AlexNet3D's 24 leaves (2,570,241
parameters, one table) and, where the tree steps more than 32 leaves,
over resnet18's 62 (11,173,962 parameters, two tables): the clip taken,
weight decay, momentum and a mask, the per-round lr on the device. Each
call is timed with CUDA events while a spin kernel holds the stream until
the host has queued it, after a write of 256 MB that leaves the L2 cache
cold (the mean of ``--iters`` calls after a warm-up). Prints the card's
name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SPIN_CYCLES = int(4e-3 * 2.0e9)  # 4 ms at a clock above the H100's boost


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the tree whose neuroimagedisttraining_tpu_torch "
                         "is timed")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import RESNET18_SIZES

    if not torch.cuda.is_available():
        print("torch_fused_sgd_time: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from neuroimagedisttraining_tpu_torch.models import create_model
    from neuroimagedisttraining_tpu_torch.ops import fused_update as FU

    if Path(FU.__file__).resolve().parents[2] != Path(args.root).resolve():
        print(f"imported {FU.__file__}, not from {args.root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    trees = {"alexnet3d_24": [p.numel() for p in create_model(
        "3dcnn", (121, 145, 121)).parameters()]}
    try:
        FU.plan_chunks(RESNET18_SIZES)
        trees["resnet18_62"] = RESNET18_SIZES
    except ValueError:  # a tree that refuses more than 32 leaves
        pass
    lr = torch.tensor(0.01, dtype=torch.float32, device=dev)
    out = {"root": args.root, "iters": args.iters}
    for name, sizes in trees.items():
        p = [torch.randn(n, generator=gen, device=dev) * 0.05 for n in sizes]
        g = [torch.randn(n, generator=gen, device=dev) * 0.01 for n in sizes]
        t = [torch.zeros(n, device=dev) for n in sizes]
        m = [(torch.rand(n, generator=gen, device=dev) < 0.5).float()
             for n in sizes]
        kw = dict(clip=float(FU.global_norm(g)) / 3, wd=5e-4, momentum=0.9)
        step = lambda: FU.fused_sgd_step(p, g, t, m, lr=lr, **kw)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        dev_ms, host_ms = [], []
        for _ in range(args.iters):
            scratch.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            t0 = time.perf_counter()
            step()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            e.record()
            e.synchronize()
            dev_ms.append(s.elapsed_time(e))
        out[name] = {"leaves": len(sizes), "params": sum(sizes),
                     "ms": sum(dev_ms) / len(dev_ms),
                     "ms_min": min(dev_ms), "host_ms":
                         sum(host_ms) / len(host_ms)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    out["card"] = card
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
