"""Where the time goes in the port's flagship run, on one CUDA card.

    python3 scripts/torch_port_profile.py
        [--algorithm salientgrads|fedavg|subavg|dispfl|dpsgd|fedfomo|
                     turboaggregate] [--precision fp32|bf16_mixed]
        [--model 3DCNN|3dcnn_gn|3dcnn_deeper|...] [--out DIR]
    python3 scripts/torch_port_profile.py --vision [--out DIR]
    python3 scripts/torch_port_profile.py --darts [--out DIR]

Builds the flagship run as ``chip_smoke.py`` does (48 synthetic subjects
over 4 sites at 121x145x121, ``3DCNN`` or ``--model``, batch 16, in
``--precision`` (fp32 by default), ``--fused_update``,
``NIDT_FAST_STEM=1``; every engine but SalientGrads and FedAvg with
``chip_smoke.py``'s flags). SalientGrads (the default): runs phase 1 and
one round to warm up, then traces phase 1 and one phase-2 round. FedAvg
and TurboAggregate: run one round to warm up, then trace one round (with
TurboAggregate's share stage) and the final fine-tune of every client.
Sub-FedAvg, DisPFL, D-PSGD and FedFomo: run round 0 to warm up, then trace
round 1 (DisPFL's with its gradient probes and mask evolution, D-PSGD's
with its consensus, FedFomo's with its validation evaluations and
aggregation). Windows are traced with
``torch.profiler``. For each window it
prints the wall time, the device time summed over kernels (and its share
of the wall time: the device's busy share, one stream), the time by kernel
family, and the top kernels; with ``--out``, a Chrome trace of each
window is written there. The last line is one JSON object with the same numbers.

``--vision`` profiles the 2D path instead: ``chip_smoke.py``'s CIFAR sweep
(ResNet-18, SalientGrads, 100 clients at Dirichlet 0.3, frac 0.1, batch
16, 2 epochs, on the synthetic cohort at CIFAR-10's size): after phase 1
and one round to warm up, it traces phase 1 and one round (10 clients, 64
local steps each).

``--darts`` profiles the DARTS path: the same sweep on ``darts`` at full
width (``chip_smoke.py``'s ``DARTS_SWEEP``); after one warm-up of each it
traces 4 local steps of the largest client (batch 16) and the evaluation
of the global model on one client's test rows (the sweep evaluates 100
clients four times).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FAMILIES = (
    ("port:stem_dw_bf16", ("stem_dw_bf16",)),
    ("port:stem_dw", ("stem_dw",)),
    ("port:fused_sgd", ("fused_sgd",)),
    ("port:count_ge", ("count_ge",)),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "sm90_",
                      "winograd", "fprop", "dgrad", "wgrad")),
    ("pool", ("pool",)),
    ("reduce", ("reduce",)),
    ("gemm", ("gemm", "gemv", "cutlass")),
    ("sort", ("sort", "radix")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def summarize(prof, wall_s: float, top: int = 12) -> dict:
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    fams: dict[str, float] = {}
    for name, ms, _ in rows:
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    return {
        "wall_ms": wall_s * 1e3,
        "device_ms": device_ms,
        "device_busy_share": device_ms / (wall_s * 1e3),
        "by_family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms": ms, "calls": c}
                        for n, ms, c in rows[:top]],
    }


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--algorithm", default="salientgrads",
                    choices=["salientgrads", "fedavg", "subavg", "dispfl",
                             "dpsgd", "fedfomo", "turboaggregate"])
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16_mixed"])
    ap.add_argument("--model", default="3DCNN")
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome traces (none if unset)")
    ap.add_argument("--vision", action="store_true",
                    help="the CIFAR sweep on ResNet-18 (chip_smoke.py's "
                         "vision main path) instead of the flagship run")
    ap.add_argument("--darts", action="store_true",
                    help="4 local steps and one client's evaluation of the "
                         "CIFAR sweep on darts (chip_smoke.py's DARTS main "
                         "path)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_port_profile: needs a CUDA card", file=sys.stderr)
        return 1
    os.environ["NIDT_FAST_STEM"] = "1"
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, build_experiment, config_from_args,
    )
    from neuroimagedisttraining_tpu_torch.ops import _cuda

    from chip_smoke import (
        CIFAR_SWEEP, DARTS_SWEEP, ENGINE_ARGS, cifar_sweep_engine,
    )
    from neuroimagedisttraining_tpu_torch.ops.masks import ones_mask

    _cuda.build(["stem_dw", "stem_dw_bf16", "fused_sgd", "count_ge"])
    if args.vision or args.darts:
        args.algorithm = "salientgrads"
        args.model = "darts" if args.darts else "resnet18"
        engine, info = cifar_sweep_engine(
            torch.device("cuda"), DARTS_SWEEP if args.darts else CIFAR_SWEEP)
    else:
        cfg = config_from_args(add_args(argparse.ArgumentParser())
                               .parse_args([
            "--algorithm", args.algorithm, "--dataset", "synthetic",
            "--model", args.model, "--precision", args.precision,
            "--synthetic_shape", "121", "145", "121",
            "--synthetic_num_subjects", "48", "--client_num_in_total", "4",
            "--batch_size", "16", "--itersnip_iteration", "1", "--epochs",
            "1", "--comm_round", "2", "--fused_update",
            *ENGINE_ARGS.get(args.algorithm, ())]))
        engine, info = build_experiment(cfg, "cuda")
    params, bstats = engine.init_global_state()
    C = engine.num_clients
    if args.darts:
        c = int(max(range(C), key=lambda i: engine.n_train[i]))
        tr, B = engine.trainer, engine.cfg.optim.batch_size
        X, y = engine.data.X_train[c], engine.data.y_train[c]
        Xt, yt, nt = (engine.data.X_test[c], engine.data.y_test[c],
                      int(engine.data.n_test[c]))
        valid = torch.arange(Xt.shape[0], device=engine.device) < nt
        lr = engine.round_lr(0)
        windows = {
            "local_steps": lambda: tr.local_train(
                params, bstats, X, y, 4 * B, lr, 1, B, engine.max_samples),
            "client_eval": lambda: tr.evaluate(params, bstats, Xt, yt,
                                               valid),
        }
        for fn in windows.values():  # warm-up
            fn()
    elif args.algorithm == "subavg":
        masks = [ones_mask(params) for _ in range(C)]
        state = engine.run_round(0, params, bstats, masks,
                                 engine.client_sampling(0))
        windows = {"round": lambda: engine.run_round(
            1, *state[:3], engine.client_sampling(1))}
    elif args.algorithm == "dispfl":
        masks, _ = engine.init_masks_all(params)
        per_p = [{k: v * m[k] for k, v in params.items()} for m in masks]
        per_b = [dict(bstats) for _ in range(C)]

        def graph(r):
            return engine.adjacency(r, engine.active_draw(r))

        state = engine.run_round(0, per_p, per_b, masks, masks, graph(0))
        windows = {"round": lambda: engine.run_round(1, *state[:4],
                                                     graph(1))}
    elif args.algorithm == "dpsgd":
        per_p, per_b = engine.broadcast_states(params, bstats, C)
        state = engine.run_round(0, per_p, per_b, engine.mixing_matrix(0))
        windows = {"round": lambda: engine.run_round(
            1, *state[:2], engine.mixing_matrix(1))}
    elif args.algorithm == "fedfomo":
        per_p, per_b = engine.broadcast_states(params, bstats, C)
        weights = torch.full((C, C), 1.0 / C, device=engine.device)
        p_choose = torch.ones((C, C), device=engine.device)
        state = engine.run_round(0, per_p, per_b, weights, p_choose)
        windows = {"round": lambda: engine.run_round(1, *state[:4])}
    elif args.algorithm in ("fedavg", "turboaggregate"):
        state = engine.run_round(0, params, bstats, engine.client_sampling(0))
        windows = {
            "round": lambda: engine.run_round(1, *state[:2],
                                              engine.client_sampling(1)),
            "finetune": lambda: engine.finetune(*state[:2]),
        }
    else:
        masks, _ = engine.generate_global_mask(params, bstats)  # warm-up
        state = engine.run_round(0, params, bstats, [params] * C,
                                 [bstats] * C, masks,
                                 engine.client_sampling(0))
        torch.cuda.synchronize()
        windows = {
            "phase1": lambda: engine.generate_global_mask(params, bstats),
            "round": lambda: engine.run_round(1, *state[:4], masks,
                                              engine.client_sampling(1)),
        }
    torch.cuda.synchronize()
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    result = {"card": card, "algorithm": args.algorithm,
              "model": args.model, "precision": args.precision,
              "vision": args.vision, "darts": args.darts,
              "partition": info["train_counts"]}
    for name, fn in windows.items():
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if out is not None:
            prof.export_chrome_trace(str(out / f"{name}.trace.json"))
        s = summarize(prof, wall)
        result[name] = s
        print(f"== {name}: wall {s['wall_ms']:.3f} ms, device "
              f"{s['device_ms']:.3f} ms (busy {s['device_busy_share']:.3f})")
        for fam, ms in s["by_family_ms"].items():
            print(f"   {fam:16s} {ms:10.3f} ms")
        for k in s["top_kernels"]:
            print(f"   {k['ms']:10.3f} ms x{k['calls']:4d}  {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
