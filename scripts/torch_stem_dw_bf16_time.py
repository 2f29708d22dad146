"""Device time of the bf16 stem weight gradient (``ops/stemconv.py``
``stem_dw`` on bf16 x and g, ``csrc/stem_dw_bf16.cu``) at the flagship
shape on one CUDA card, for port trees given by their roots, so that two
designs can be timed in turns within one call.

    python3 scripts/torch_stem_dw_bf16_time.py [--trees A,B,B,A] [--iters N]
        [--variants TREE]

Each tree runs in a process of its own (the trees hold packages of one
name): x the slice's integral voxels in bf16, g Gaussian bf16 in the
convolution backward's NCDHW memory (B 16, 121x145x121, seed 0). Each call
is timed with CUDA events while a spin kernel holds the stream until the
host has queued it, after a write of 256 MB that leaves the L2 cache cold
(the mean of ``--iters`` calls after a warm-up); ``host_ms`` is the wall
time to queue the call. ``--variants TREE`` also times the tree's kernel
with parts of its work taken out, to attribute its time. The mma.sync
design: ``copies`` (no products: the row loop runs no row),
``products`` (no refills after the first two items: the products run on
stale stages), ``one_block`` (one block an SM instead of two). The wgmma
design: ``feed`` (the producer's copies alone: no rewrite, no products),
``no_rewrite``, ``no_products``, ``compute`` (no copies: the rewrite and
the products on stale stages), ``products`` (the products alone). The
variants' dW is wrong by design and is not checked. Prints the card's name
and power limit, then one JSON object a run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

SPIN_CYCLES = int(4e-3 * 2.0e9)  # 4 ms at a clock above the H100's boost
B, D, H, W = 16, 121, 145, 121
#: text edits of each design's source that take out part of its work, by
#: a line only that design has
_WAIT_B = "mbar_wait(bfull_s + 8 * bt, (i / TILES) & 1);\n"
_NO_CHAINS = (_WAIT_B, _WAIT_B + """      if (it < items) {  // no products
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(bempty_s + 8 * bt);
          mbar_arrive(empty_s + 8 * st);
        }
        continue;
      }
""")
_NO_REWRITE = ("for (int pr = rt; pr < CO * 8; pr += REWRITERS) {",
               "for (int pr = rt; pr < 0; pr += REWRITERS) {")
_NO_COPIES = ("mbar_arrive_expect(full, bytes);",
              "mbar_arrive_expect(full, 0u);\n        continue;")
PATCHES = {
    "mma.sync.aligned.m16n8k16": {
        "copies": [("for (int r = 0; r < m.nrows; ++r) {",
                    "for (int r = 0; r < 0; ++r) {")],
        "products": [("if (nxt < items)", "if (nxt < 0)")],
        "one_block": [],
    },
    "wgmma.mma_async": {
        "feed": [_NO_CHAINS, _NO_REWRITE],
        "no_rewrite": [_NO_REWRITE],
        "no_products": [_NO_CHAINS],
        "compute": [_NO_COPIES],
        "products": [_NO_COPIES, _NO_REWRITE],
    },
}


def design_patches(src: str) -> dict:
    for marker, patches in PATCHES.items():
        if marker in src:
            return patches
    raise SystemExit("the source holds neither design")


def one(root: Path, variant: str | None, iters: int) -> dict:
    import torch

    sys.path.insert(0, str(root))
    from neuroimagedisttraining_tpu_torch.ops import _cuda
    from neuroimagedisttraining_tpu_torch.ops import stemconv as SC

    if Path(SC.__file__).resolve().parents[2] != root:
        raise SystemExit(f"imported {SC.__file__}, not from {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    od, oh, ow = (D - 5) // 2 + 1, (H - 5) // 2 + 1, (W - 5) // 2 + 1
    x = torch.randint(0, 256, (B, D, H, W, 1), generator=gen,
                      device=dev).to(bf)
    g = torch.randn((B, 64, od, oh, ow), generator=gen, device=dev,
                    dtype=bf).permute(0, 2, 3, 4, 1)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    if variant is None:
        def call():
            SC.stem_dw(x, g)
    else:
        src = (_cuda.CSRC / "stem_dw_bf16.cu").read_text()
        for old, new in design_patches(src)[variant]:
            if src.count(old) != 1:
                raise SystemExit(f"{variant}: {old!r} is not one line of "
                                 f"the source of {root}")
            src = src.replace(old, new)
        name = f"stem_dw_bf16_{variant}"
        (_cuda.CSRC / f"{name}.cu").write_text(src)
        lib = _cuda.load(name, SC._SIG_BF16)
        n = ctypes.c_int(0)
        _cuda.check_launch(lib, lib.stem_dw_bf16_num_parts(ctypes.byref(n)),
                           "num_parts")
        nparts = n.value
        if variant == "one_block":
            nparts = torch.cuda.get_device_properties(dev).multi_processor_count
        part = torch.empty(nparts * 125 * 64, dtype=torch.float32, device=dev)
        dw = torch.empty(125 * 64, dtype=torch.float32, device=dev)
        stream = _cuda.stream_ptr(dev)
        # the wgmma design's launch also takes the plan's rows an item
        extra = ([SC.bf16_plan(B, D, H, W).nr]
                 if hasattr(SC, "bf16_plan") else [])

        def call():
            _cuda.check_launch(lib, lib.stem_dw_bf16_launch(
                x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                nparts, B, D, H, W, od, oh, ow, *extra, stream), name)
    call()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(iters):
        scratch.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        t = time.perf_counter()
        call()
        host_ms.append((time.perf_counter() - t) * 1e3)
        late = s.query()
        e.record()
        e.synchronize()
        if late:
            raise SystemExit("the spin ended before the call was queued")
        dev_ms.append(s.elapsed_time(e))
    return {"tree": str(root), "variant": variant,
            "ms": sum(dev_ms) / iters, "ms_min": min(dev_ms),
            "ms_max": max(dev_ms), "host_ms": sum(host_ms) / iters,
            "iters": iters, "device": torch.cuda.get_device_name(0)}


def main(argv: list[str]) -> int:
    here = Path(__file__).resolve().parents[1]
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", default=str(here),
                    help="comma-separated roots of port trees, timed in turn")
    ap.add_argument("--variants", default=None,
                    help="root of a tree whose kernel is taken apart")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(Path(args.one).resolve(), args.variant,
                             args.iters)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_stem_dw_bf16_time: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    runs = [(t, None) for t in args.trees.split(",") if t]
    if args.variants:
        src = (Path(args.variants) / "neuroimagedisttraining_tpu_torch" /
               "csrc" / "stem_dw_bf16.cu").read_text()
        runs += [(args.variants, v) for v in design_patches(src)]
    for tree, variant in runs:
        cmd = [sys.executable, __file__, "--one", tree,
               "--iters", str(args.iters)]
        if variant:
            cmd += ["--variant", variant]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
