"""Where the card's memory sits while flagship runs hold their step graphs.

On the flagship slice (AlexNet3D_Dropout at 121x145x121, batch 16, fp32,
48 synthetic subjects over 4 sites, ``--fused_update``, the fast stem),
runs one after another and keeps each engine alive, as the smoke's mesh
cells do: D-PSGD with ring gossip (``--cs ring --frac 0.5``), the same
on a 4-entry mesh, the same again; then FedAvg on a 4-entry mesh with
``preempt:2@2`` and a checkpoint every round. After each run it prints
one JSON line: the bytes reserved and allocated in the regular pool and
in the graph pools (``torch.cuda.memory_snapshot()``), by pool and
stream, and the peak reserved.

``--layout shared`` is the trainer's own (one stream and one capture pool
for all of a trainer's step graphs); ``--layout per_graph`` gives each
step graph a stream and a private pool of its own, ``--layout
shared_stream`` the trainer's stream and a private pool each, to
compare.

    python3 scripts/torch_graph_memory.py --layout shared
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def by_pool() -> dict:
    """Reserved and allocated GB by (pool, stream) of every segment."""
    import torch

    out = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id") or (0, 0))
        key = ("regular" if pool == (0, 0) else f"graph{list(pool)}") + \
            f" stream {seg['stream']:#x}"
        cell = out.setdefault(key, [0.0, 0.0])
        cell[0] += seg["total_size"] / 1e9
        cell[1] += seg["allocated_size"] / 1e9
    return {k: {"reserved_gb": round(r, 3), "allocated_gb": round(a, 3)}
            for k, (r, a) in sorted(out.items())}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layout",
                    choices=("shared", "per_graph", "shared_stream"),
                    default="shared")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_graph_memory: needs a CUDA card", file=sys.stderr)
        return 1
    os.environ.setdefault("NIDT_FAST_STEM", "1")
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, build_experiment, config_from_args,
    )
    from neuroimagedisttraining_tpu_torch.core import graphs

    if args.layout != "shared":
        init = graphs.StepGraph.__init__
        own_stream = args.layout == "per_graph"

        def own(self, body, device, generator, capture=True, notify=None,
                stream=None, pool=None):
            init(self, body, device, generator, capture, notify,
                 torch.cuda.Stream(device) if own_stream else stream, None)
        graphs.StepGraph.__init__ = own

    def flagship(algorithm: str, *extra: str):
        return config_from_args(add_args(argparse.ArgumentParser())
                                .parse_args([
            "--algorithm", algorithm, "--dataset", "synthetic",
            "--model", "3DCNN", "--synthetic_shape", "121", "145", "121",
            "--synthetic_num_subjects", "48", "--client_num_in_total", "4",
            "--batch_size", "16", "--itersnip_iteration", "1", "--epochs",
            "1", "--comm_round", "2", "--fused_update", *extra]))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    tmp = Path(tempfile.mkdtemp(prefix="nidt_mem_"))
    ring = ("--cs", "ring", "--frac", "0.5")
    runs = [("dpsgd_ring", flagship("dpsgd", *ring)),
            ("dpsgd_ring_mesh4", flagship("dpsgd", *ring,
                                          "--virtual_devices", "4")),
            ("dpsgd_ring_again", flagship("dpsgd", *ring)),
            ("fedavg_preempt_mesh4", flagship(
                "fedavg", "--comm_round", "4", "--checkpoint_every", "1",
                "--client_mesh", "4", "--virtual_devices", "4",
                "--fault_spec", "preempt:2@2", "--checkpoint_dir",
                str(tmp / "ckpt")))]
    alive = []
    try:
        for tag, cfg in runs:
            torch.cuda.reset_peak_memory_stats()
            engine, _ = build_experiment(cfg, "cuda")
            engine.train()
            torch.cuda.synchronize()
            alive.append(engine)
            print(json.dumps({"graph_memory": {
                "card": card, "layout": args.layout, "run": tag,
                "engines_alive": len(alive),
                "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                "by_pool": by_pool()}}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
