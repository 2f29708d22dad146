"""Run-to-run spread of the port's small-input engine runs on one CUDA card.

    python3 scripts/torch_small_spread.py [--repeats N]
        [--engines fedprox,ditto,subavg,dispfl]

Runs each engine at 69^3 (24 synthetic subjects over 4 sites, batch 4,
1 epoch, 2 rounds; the small input of ``chip_smoke.py``, Sub-FedAvg and
DisPFL with its flags) N times through the plain paths and N times through
the kernels (``--fused_update``, ``NIDT_FAST_STEM=1``), first with cuDNN
free to pick any algorithm and then with
``torch.backends.cudnn.deterministic``. For every pair of runs it prints
the largest weight difference over the global and personal states as a
fraction of the largest weight change from the initial weights, with the
leaf that holds it (Sub-FedAvg and DisPFL: the share of mask entries that
differ, and the weight difference where no client's support differs,
``chip_smoke.sparse_gap``): plain against plain, kernels against kernels,
kernels against plain. During the kernel runs every ``stem_dw``
and ``fused_sgd`` call is also computed by its plain version on the same
inputs (``chip_smoke.PerCallCheck``; not counted as a launch), and the
largest per-call error over its tolerance is printed. The last line is one
JSON object with every number.
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


def states(result: dict, algorithm: str, num_clients: int) -> dict:
    """Every params dict of a run: the global one and each client's."""
    out = {"global": result["params"]}
    per = result["personal_params" if algorithm == "ditto" else "personal"]
    if algorithm != "ditto":
        per = per["params"]
    for c in range(num_clients):
        out[f"personal {c}"] = per[c]
    return {s: {k: v.detach().clone() for k, v in p.items()}
            for s, p in out.items()}


def weight_gap(a: dict, b: dict) -> tuple[float, str]:
    """Largest |a - b| over every state and leaf, and where."""
    best, where = -1.0, ""
    for s, leaves in b.items():
        for k, v in leaves.items():
            e = float((a[s][k] - v).abs().max())
            if e > best:
                best, where = e, f"{s}/{k}"
    return best, where


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--engines", default="fedprox,ditto,subavg,dispfl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_small_spread: needs a CUDA card", file=sys.stderr)
        return 1
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, build_experiment, config_from_args,
    )
    from neuroimagedisttraining_tpu_torch.device import resolve_device
    from neuroimagedisttraining_tpu_torch.ops import _cuda
    from chip_smoke import SPARSE_ARGS, PerCallCheck, sparse_gap

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    _cuda.build(["stem_dw", "fused_sgd"])

    def run(algorithm: str, kernels: bool):
        os.environ["NIDT_FAST_STEM"] = "1" if kernels else "0"
        argv = ["--algorithm", algorithm, "--dataset", "synthetic",
                "--synthetic_shape", "69", "69", "69",
                "--synthetic_num_subjects", "24",
                "--client_num_in_total", "4", "--batch_size", "4",
                "--epochs", "1", "--comm_round", "2",
                *SPARSE_ARGS.get(algorithm, ())]
        if kernels:
            argv.append("--fused_update")
        eng = build_experiment(config_from_args(
            add_args(argparse.ArgumentParser()).parse_args(argv)), "cuda")[0]
        # the mode under test (building an engine sets the port's default)
        torch.backends.cudnn.deterministic = mode == "deterministic"
        init_p, _ = eng.init_global_state()
        init_p = {k: v.detach().clone() for k, v in init_p.items()}
        res = eng.train()
        kept = (res if algorithm in SPARSE_ARGS
                else states(res, algorithm, eng.num_clients))
        return (kept, init_p, [h["train_loss"] for h in res["history"]],
                res["final_personal"]["loss"])

    per_call = PerCallCheck()
    report = {"card": card, "repeats": args.repeats, "engines": {}}
    for algorithm in args.engines.split(","):
        for mode in ("default", "deterministic"):
            t0 = time.perf_counter()
            plain, kern = [], []
            per_call.reset()
            for _ in range(args.repeats):
                plain.append(run(algorithm, False))
                with per_call:
                    kern.append(run(algorithm, True))
            init_p = plain[0][1]
            sparse = algorithm in SPARSE_ARGS
            moved = (sparse_gap(algorithm, plain[0][0], plain[0][0], init_p)
                     ["largest_weight_change"] if sparse else
                     max(float((v - init_p[k]).abs().max())
                         for leaves in plain[0][0].values()
                         for k, v in leaves.items()))

            def gaps(xs, ys):
                out = []
                for x, y in zip(xs, ys):
                    if sparse:
                        g = sparse_gap(algorithm, x[0], y[0], init_p)
                        out.append({k: g[k] for k in (
                            "mask_diff_share", "param_err_over_change",
                            "support_flipped")})
                        continue
                    e, where = weight_gap(x[0], y[0])
                    out.append({"ratio": e / moved, "at": where})
                return out
            entry = {
                "largest_weight_change": moved,
                "plain_vs_plain": gaps(plain[1:], plain[:1] * len(plain)),
                "kernels_vs_kernels": gaps(kern[1:], kern[:1] * len(kern)),
                "kernels_vs_plain": gaps(kern, plain),
                "train_loss_plain": [p[2] for p in plain],
                "train_loss_kernels": [k[2] for k in kern],
                "eval_loss_plain": [p[3] for p in plain],
                "eval_loss_kernels": [k[3] for k in kern],
                "per_call": {"calls": per_call.calls,
                             "worst_err_over_tol": per_call.worst,
                             "fused_sgd_not_bit_equal": per_call.inexact,
                             "fused_sgd_clip_taken": per_call.clip_taken},
                "seconds": time.perf_counter() - t0}
            report["engines"][f"{algorithm}/{mode}"] = entry
            print(json.dumps({f"{algorithm}/{mode}": {
                k: v for k, v in entry.items()
                if k.endswith("_vs_plain") or k.endswith("vs_kernels")
                or k in ("per_call", "seconds")}}))
    torch.backends.cudnn.deterministic = True
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
