"""Count the ported kernels in ``torch.profiler`` traces of one graphed
ResNet-18 client, again and again, beside the launches the wrappers count.

    python3 scripts/torch_trace_count.py [--repeats 10]

On the card: the FedAvg ResNet-18 engine of ``chip_smoke.py``'s dispatch
phase (``RESNET_WINDOW``: 100 clients of the synthetic cohort at CIFAR-10's
size, batch 16), its step graphs captured by one 2-round window, then one
sampled client's local training traced ``--repeats`` times in each of two
ways, in turns:

- ``bare``: ``chip_smoke.kernel_trace`` as the smoke's check runs it (the
  call and a device sync inside the profiler's window);
- ``padded``: the same with the card idle for ``--pad_ms`` on both sides
  of the call inside the window (a sync and a host sleep before and
  after), so that no kernel runs near either end of the window.

Each trace prints ``fused_sgd``'s launches in the trace and as counted, the
missing launches' place (how many of the traced kernel events fall in the
first and last 5% of the traced span), and the whole run's misses by way.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def traced_launches(fn, pad_s: float) -> tuple[dict, dict]:
    """``fn`` once under ``torch.profiler``; ``(traced, span)``: the
    ported kernels' launches in the trace by counter name, and where the
    ``fused_sgd`` events lie in the span of all traced kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as S

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if pad_s:
            torch.cuda.synchronize()
            time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
    traced, starts, fused = {}, [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        starts.append(e.time_range.start)
        for part, counter in S.TRACE_COUNTERS:
            if part in e.name:
                traced[counter] = traced.get(counter, 0) + 1
                if counter == "fused_sgd":
                    fused.append(e.time_range.start)
                break
    span = {}
    if starts:
        lo, hi = min(starts), max(starts)
        edge = 0.05 * max(hi - lo, 1)
        span = {"kernel_events": len(starts), "span_us": hi - lo,
                "fused_first_5pct": sum(t < lo + edge for t in fused),
                "fused_last_5pct": sum(t > hi - edge for t in fused)}
    return traced, span


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--pad_ms", type=float, default=50.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as S
    from neuroimagedisttraining_tpu_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    os.environ["NIDT_FAST_STEM"] = "1"
    _cuda.build(["fused_sgd", "stem_dw", "count_ge"])
    engine, _ = S.cifar_sweep_engine("cuda", S.RESNET_WINDOW)
    p0, b0 = engine.init_global_state()
    engine.program.run_window((p0, b0), 0, 2)  # warm-up, capture, replays
    torch.cuda.synchronize()
    c0 = int(engine.client_sampling(0)[0])
    rows0 = dict(engine.client_rows([c0]))[c0]
    lr0 = engine.round_lr(0)

    def client():
        engine.client_train(0, c0, rows0, p0, b0, lr0,
                            engine.cfg.optim.epochs)

    client()  # replays only from here on
    torch.cuda.synchronize()
    misses = {"bare": 0, "padded": 0}
    traces = {"bare": 0, "padded": 0}
    for rep in range(args.repeats):
        for way, pad in (("bare", 0.0), ("padded", args.pad_ms / 1e3)):
            before = _cuda.counts()
            traced, span = traced_launches(client, pad)
            after = _cuda.counts()
            counted = after["fused_sgd"] - before["fused_sgd"]
            got = traced.get("fused_sgd", 0)
            misses[way] += counted - got
            traces[way] += counted != got
            print(json.dumps({"rep": rep, "way": way, "card": card,
                              "fused_sgd_traced": got,
                              "fused_sgd_counted": counted,
                              "traced": traced, **span}), flush=True)
    print(json.dumps({"card": card, "repeats": args.repeats,
                      "pad_ms": args.pad_ms, "missing_launches": misses,
                      "traces_short": traces}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
