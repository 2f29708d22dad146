"""Operator CLI of the serving plane (the reference package's
``serve/__main__.py``, flag for flag, with ``--device``).

``python -m neuroimagedisttraining_tpu_torch.serve --bundle DIR --port N
--serve_workers K --batch_buckets 1,2,4,8 --max_queue_ms 2 --precision
bf16`` serves a built bundle on the card (``--device cuda``, the default;
``--device cpu`` serves on the host); ``--from_checkpoint DIR`` builds the
bundle first (``--build_only`` stops there: the checkpoint -> bundle step a
distribution script calls).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def _parse_buckets(text: str) -> tuple[int, ...]:
    try:
        buckets = tuple(int(b) for b in text.split(",") if b.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"batch_buckets must be comma-separated ints, got {text!r}")
    if not buckets or min(buckets) < 1:
        raise argparse.ArgumentTypeError(
            f"batch_buckets must be positive, got {text!r}")
    return buckets


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m neuroimagedisttraining_tpu_torch.serve",
        description="serve a deployment bundle over SO_REUSEPORT HTTP "
                    "workers with micro-batched inference, one CUDA graph "
                    "per model and bucket")
    p.add_argument("--bundle", required=True,
                   help="bundle directory (manifest.json + "
                        "weights.msgpack); created when "
                        "--from_checkpoint is given")
    p.add_argument("--port", type=int, default=0,
                   help="shared SO_REUSEPORT port (0 = ephemeral, "
                        "printed at startup)")
    p.add_argument("--serve_workers", type=int, default=2,
                   help="HTTP worker processes on the shared port")
    p.add_argument("--batch_buckets", type=_parse_buckets,
                   default=(1, 2, 4, 8),
                   help="declared batch sizes; ONE captured program "
                        "per (model, bucket), e.g. 1,2,4,8")
    p.add_argument("--max_queue_ms", type=float, default=2.0,
                   help="max wait of the oldest queued request for "
                        "batch-mates before dispatch")
    p.add_argument("--precision", default="",
                   choices=("", "bf16", "fp32"),
                   help="serving precision override ('' = as stored; "
                        "fp32 is the full-precision escape hatch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu: the device every worker "
                        "serves on")
    p.add_argument("--metrics_port", type=int, default=0,
                   help="root port for the MERGED /metrics + /healthz "
                        "(0 = off)")
    p.add_argument("--run_seconds", type=float, default=0.0,
                   help="serve for N seconds then exit cleanly "
                        "(0 = until SIGINT/SIGTERM)")
    p.add_argument("--trace_out", default="",
                   help="merged chrome-trace path (workers write "
                        ".wN-suffixed secondaries)")
    p.add_argument("--flight_out", default="",
                   help="merged flight-recorder dump path")
    # ---- bundle building ----
    p.add_argument("--from_checkpoint", default="",
                   help="build --bundle from this training checkpoint "
                        "dir before serving")
    p.add_argument("--model", default="",
                   help="model name for --from_checkpoint (e.g. "
                        "3dcnn_tiny, alexnet3d)")
    p.add_argument("--num_classes", type=int, default=1)
    p.add_argument("--input_shape", default="",
                   help="comma-separated per-request input shape for "
                        "--from_checkpoint, e.g. 12,14,12")
    p.add_argument("--source_round", type=int, default=-1,
                   help="checkpoint round to bundle (-1 = latest)")
    p.add_argument("--bundle_precision", default="bf16",
                   choices=("bf16", "fp32"),
                   help="stored weight precision for --from_checkpoint")
    p.add_argument("--build_only", action="store_true",
                   help="build the bundle and exit without serving")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.build_only and not args.from_checkpoint:
        parser.error("--build_only requires --from_checkpoint")
    if args.from_checkpoint:
        if not args.model or not args.input_shape:
            parser.error("--from_checkpoint requires --model and "
                         "--input_shape")
        from neuroimagedisttraining_tpu_torch.serve.bundle import build_bundle
        manifest = build_bundle(
            args.from_checkpoint, args.bundle, model=args.model,
            num_classes=args.num_classes,
            input_shape=tuple(int(d) for d in
                              args.input_shape.split(",") if d),
            precision=args.bundle_precision,
            round_idx=None if args.source_round < 0
            else args.source_round)
        print(json.dumps({"bundle": args.bundle,
                          "flavor": manifest["flavor"],
                          "source_round": manifest["source_round"],
                          "sites": len(manifest["sites"]),
                          "precision": manifest["precision"],
                          "sparse_nnz": manifest["sparse_nnz"]},
                         indent=1, sort_keys=True))
        if args.build_only:
            return 0

    from neuroimagedisttraining_tpu_torch.obs.http import start_metrics_server
    from neuroimagedisttraining_tpu_torch.serve.server import (
        ShardedServeServer,
    )

    server = ShardedServeServer(
        args.bundle, port=args.port, serve_workers=args.serve_workers,
        batch_buckets=args.batch_buckets,
        max_queue_ms=args.max_queue_ms, precision=args.precision,
        trace_out=args.trace_out, flight_out=args.flight_out,
        device=args.device)
    msrv = start_metrics_server(args.metrics_port,
                                registry=server.metrics_view(),
                                health_probe=server.health)
    print(json.dumps({"port": server.port,
                      "workers": server.serve_workers,
                      "metrics_port": msrv.port if msrv else 0,
                      "model": server.manifest["model"],
                      "model_version": server.manifest["source_round"]},
                     sort_keys=True), flush=True)
    done = threading.Event()

    def _sig(signum, frame):
        done.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    done.wait(args.run_seconds if args.run_seconds > 0 else None)
    audit = server.stop()
    if msrv is not None:
        msrv.close()
    print(json.dumps({"audit": audit}, indent=1, sort_keys=True))
    return 0 if audit["reconciled"] else 1


if __name__ == "__main__":
    sys.exit(main())
