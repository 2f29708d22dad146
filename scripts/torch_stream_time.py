"""Times the port's streamed feed (``data/stream.py``) at scale on one card.

    python3 scripts/torch_stream_time.py [--subjects N] [--sites S]
        [--chunk C] [--step_ms T] [--dir DIR] [--out FILE]

Writes a cohort of ``--subjects`` volumes of 121x145x121 uint8 over
``--sites`` sites (the synthetic generator's site draw) to a ``.npy`` file
and opens it as a memmap, the lazy source a streamed run reads. Then it
streams one FedAvg round's training rows (every client, as at full
participation) in chunks of ``--chunk`` clients through the feed, with a
stand-in consumer that reads each chunk and holds the card for ``--step_ms``
a local step of the client (one epoch of batch 16), as the round's compute
would. It prints, as JSON lines: the host's free RAM and disk, the
pinned-slab allocation time, the gather and H2D rates, a chunk's feed time
against a local step, the main thread's wait on the feed against the feed's
own time, with the card's name and power limit; and, computed without
running, the device bytes of the resident stacks and of the feed's two
slabs at the reference's 11,573 subjects over 21 sites. Three passes:
the feed alone on a cold mapping (the process's first touch of the
memmap's pages, as a run's first round), then with the consumer's hold
and alone again, both warm.

Needs a CUDA card; the cohort file is deleted at the end.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPE = (121, 145, 121)
ROW = int(np.prod(SHAPE))
REFERENCE_SUBJECTS = 11573
BATCH = 16


def sites_of(subjects: int, sites: int, seed: int) -> np.ndarray:
    """The synthetic generator's site labels (drawn before any voxel, so a
    one-voxel volume gives the same draw)."""
    from neuroimagedisttraining_tpu_torch.data.synthetic import (
        generate_synthetic_abcd,
    )
    return generate_synthetic_abcd(num_subjects=subjects, shape=(1, 1, 1),
                                   num_sites=sites, seed=seed)["site"]


def feed_bytes(site: np.ndarray, chunk: int) -> dict:
    """Device bytes of the resident stacks (train and test, each padded to
    its largest client) and of the streamed feed's two slabs (``chunk``
    clients padded to the largest client of either split), voxels and
    int32 labels and counts."""
    from neuroimagedisttraining_tpu_torch.data.federate import (
        federation_maps,
    )
    tr, te, _, _ = federation_maps(site, 42)
    C = len(tr)
    ntr = max(len(v) for v in tr.values())
    nte = max(len(v) for v in te.values())
    resident = C * (ntr + nte) * (ROW + 4) + 2 * C * 8
    slab = chunk * max(ntr, nte) * (ROW + 4 * 2)
    return {"subjects": int(len(site)), "clients": C,
            "nmax_train": ntr, "nmax_test": nte,
            "cohort_bytes": int(len(site)) * ROW,
            "resident_stack_bytes": resident,
            "feed_two_slab_bytes": 2 * slab, "chunk_clients": chunk}


def free_host() -> dict:
    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    return {"mem_available_bytes": avail}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--subjects", type=int, default=2000)
    ap.add_argument("--sites", type=int, default=21)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--step_ms", type=float, default=35.0,
                    help="the stand-in consumer's hold a local step")
    ap.add_argument("--seed", type=int, default=1024)
    ap.add_argument("--dir", type=str, default=None,
                    help="where the cohort file goes (default: TMPDIR)")
    ap.add_argument("--out", type=str, default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_stream_time: needs a CUDA card", file=sys.stderr)
        return 1
    from neuroimagedisttraining_tpu_torch.data.federate import (
        federation_maps,
    )
    from neuroimagedisttraining_tpu_torch.data.stream import (
        StreamingFederation,
    )
    from neuroimagedisttraining_tpu_torch.device import resolve_device

    lines = []

    def emit(rec: dict) -> None:
        print(json.dumps(rec), flush=True)
        lines.append(rec)

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ref_site = sites_of(REFERENCE_SUBJECTS, 21, args.seed)
    emit({"reference_scale_computed": feed_bytes(ref_site, args.chunk),
          "reference_scale_computed_chunk1": feed_bytes(ref_site, 1)})

    root = Path(tempfile.mkdtemp(prefix="nidt_stream_time_",
                                 dir=args.dir))
    try:
        disk = shutil.disk_usage(root)
        emit({"card": card, "host": {**free_host(),
                                     "disk_free_bytes": disk.free,
                                     "cpus": os.cpu_count()},
              "subjects": args.subjects, "sites": args.sites})
        site = sites_of(args.subjects, args.sites, args.seed)
        need = args.subjects * ROW
        if need > 0.9 * disk.free:
            print(f"torch_stream_time: the cohort needs {need} bytes, the "
                  f"disk has {disk.free} free", file=sys.stderr)
            return 1
        path = root / "cohort.npy"
        t0 = time.perf_counter()
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8,
                                       shape=(args.subjects,) + SHAPE)
        base = np.random.default_rng(args.seed).integers(
            0, 256, SHAPE, dtype=np.uint8)
        for i in range(args.subjects):
            np.bitwise_xor(base, np.uint8(i & 255), out=mm[i])
        mm.flush()
        del mm
        write_s = time.perf_counter() - t0
        X = np.load(path, mmap_mode="r")
        y = (np.arange(args.subjects) % 2).astype(np.int8)
        tr, te, _, _ = federation_maps(site, 42)
        emit({"cohort_write_seconds": write_s, "cohort_bytes": need,
              "host_after_write": free_host()})

        # the pinned host slab a chunk needs, allocated and freed once
        rows = args.chunk * max(max(len(v) for v in tr.values()),
                                max(len(v) for v in te.values()))
        t0 = time.perf_counter()
        slab = torch.empty(rows * ROW, dtype=torch.uint8, pin_memory=True)
        pin_s = time.perf_counter() - t0
        del slab
        emit({"pinned_slab_bytes": rows * ROW,
              "pinned_slab_alloc_seconds": pin_s})

        clients = np.arange(len(tr))
        steps = [math.ceil(len(tr[c]) / BATCH) for c in clients]
        spin_per_ms = spin_rate(torch)
        for mapping, hold in (("cold", False), ("warm", True),
                              ("warm", False)):
            stream = StreamingFederation(X, y, tr, te, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunks, acc = 0, torch.zeros((), dtype=torch.int64, device=dev)
            for ch in stream.eval_chunks(args.chunk, "train", ids=clients):
                acc += ch.X[:, 0, 0, 0, :8].sum()  # the consumer reads it
                if hold:
                    ms = args.step_ms * sum(steps[c] for c in ch.ids)
                    torch.cuda._sleep(int(ms * spin_per_ms))
                chunks += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stream.sync()
            ts = dict(stream.transfer_stats)
            feed_ms = ts["host_gather_ms"] + ts["device_put_ms"]
            emit({"card": card, "mapping": mapping, "consumer_hold": hold,
                  "chunk_clients": args.chunk, "chunks": chunks,
                  "round_wall_seconds": wall,
                  "held_ms": (args.step_ms * sum(steps) if hold else 0.0),
                  "transfer_stats": ts,
                  "gather_gb_per_s": ts["bytes"] / ts["host_gather_ms"] / 1e6,
                  "h2d_gb_per_s": ts["bytes"] / ts["device_put_ms"] / 1e6,
                  "chunk_feed_ms": feed_ms / chunks,
                  "local_step_ms": args.step_ms,
                  "main_thread_wait_ms": stream.wait_ms,
                  "wait_with_card_idle_ms": stream.idle_wait_ms,
                  "feed_ms": feed_ms,
                  "feed_hidden_share": 1.0 - stream.idle_wait_ms / feed_ms,
                  "feed_device_bytes": sum(
                      s.dev_X.nbytes + s.dev_i.nbytes
                      for s in stream._slots if s.rows),
                  "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)})
            stream.close()
            del stream
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return 0


def spin_rate(torch) -> float:
    """``torch.cuda._sleep`` cycles per millisecond on this card."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    b.synchronize()
    return 100_000_000 / a.elapsed_time(b)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
