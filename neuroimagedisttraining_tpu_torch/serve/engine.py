"""Micro-batched inference with one CUDA graph per model and bucket (the
reference package's ``serve/engine.py``).

Requests queue a routed model; one batcher thread collects up to the
largest declared bucket (or until the oldest request has waited
``max_queue_ms``), pads to the smallest bucket that fits, dispatches once,
de-pads and resolves the waiters.

The forward is the trainer's eval forward (``models.create_model`` with
``train=False`` through ``functional_call``, ``primary_logits``), on the
bundle's weights turned into the port's state by
``weights.params_from_flax``. On a CUDA device each (model, bucket) is one
program: a static input buffer on the card and one ``torch.cuda.CUDAGraph``
captured from the forward, on the engine's stream, at the first dispatch of
that pair; every dispatch copies the padded batch into the buffer, replays
the graph and reads its logits back. Capture runs on the batcher thread in
the ``"global"`` error mode: the request threads of the process do no CUDA
work, so any CUDA call from another thread during a capture raises instead
of leaking into the graph. The graphs of one engine share one memory pool,
which is safe because the one batcher replays them one at a time and reads
each replay's logits before the next. A capture or replay that fails
raises: the waiters get the error, and nothing falls back to eager steps
or to the CPU. On the CPU the program is the eager forward on the same
padded batch.

The compute plane's counters see captures and replays as the reference's
see compiles and dispatches: ``obs.compute.note_compile`` at each capture
(``nidt_compiles_total{engine="serve"}``) and ``note_dispatch`` at each
dispatch (phase ``compile`` for a capture's first one). Stage latencies go
to ``nidt_serve_latency_ms{stage=queue|batch|dispatch|reply}`` (reply from
the HTTP worker) with a batch-occupancy and a queue-depth gauge; all
metrics are host-side, around the dispatch.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch
from torch.func import functional_call

from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.device import resolve_device
from neuroimagedisttraining_tpu_torch.models import (
    create_model, primary_logits,
)
from neuroimagedisttraining_tpu_torch.obs import compute as obs_compute
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as N
from neuroimagedisttraining_tpu_torch.obs import rules as obs_rules
from neuroimagedisttraining_tpu_torch.serve.bundle import (
    ServeBundle, _tree_map, bf16_round,
)
from neuroimagedisttraining_tpu_torch.weights import params_from_flax

#: engine label on the shared compute-plane series
#: (``nidt_compiles_total{engine="serve"}`` etc.)
ENGINE_LABEL = "serve"

#: per-request stage latency edges (ms); wider than the upload stage
#: buckets because a capture rides the first dispatch of its program
SERVE_LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                            50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
                            5000.0, 10000.0)

#: the rule engine's boundary cadence: a registry snapshot a dispatch
#: would dominate small-model serving, so rules run every N dispatches
_RULE_BOUNDARY_EVERY = 32


def serve_latency_histogram(registry: obs_metrics.MetricsRegistry | None
                            = None):
    reg = registry if registry is not None else obs_metrics.REGISTRY
    return reg.histogram(
        N.SERVE_LATENCY_MS,
        "per-request serving latency by stage: queue (enqueue→batch "
        "collect), batch (pad/stack), dispatch (compiled forward incl. "
        "device sync), reply (result→bytes on the wire; observed by "
        "serve/worker.py)",
        labelnames=("stage",), buckets=SERVE_LATENCY_BUCKETS_MS)


class _Pending:
    """One queued request: numpy input and the waiter's event."""

    __slots__ = ("x", "event", "result", "error", "t_enq")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.t_enq = time.perf_counter()


class _Program:
    """One (model, bucket): its static input buffer and, on a CUDA
    device, the graph captured over it and the logits it writes."""

    __slots__ = ("x", "graph", "out")

    def __init__(self, x: torch.Tensor):
        self.x = x
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: torch.Tensor | None = None


class ServeEngine:
    """Micro-batching inference over a loaded :class:`ServeBundle`.

    ``batch_buckets`` declares the only batch shapes that get a program;
    ``max_queue_ms`` bounds how long the oldest request waits for
    batch-mates. ``precision`` "" serves the bundle's stored precision;
    "bf16" / "fp32" re-cast at load (fp32 is the full-precision escape
    hatch). ``device`` is ``"cuda"`` unless the caller asks for the CPU;
    a CUDA device that does not exist raises."""

    def __init__(self, bundle: ServeBundle,
                 batch_buckets: tuple[int, ...] = (1, 2, 4, 8),
                 max_queue_ms: float = 2.0, precision: str = "",
                 registry: obs_metrics.MetricsRegistry | None = None,
                 device: str | torch.device = "cuda"):
        buckets = sorted({int(b) for b in batch_buckets})
        if not buckets or buckets[0] < 1:
            raise ValueError(
                f"batch_buckets must be positive ints, got "
                f"{batch_buckets!r}")
        if precision not in ("", "bf16", "fp32"):
            raise ValueError(
                f"precision must be ''|bf16|fp32, got {precision!r}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # the batcher thread selects the device by its index
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.bundle = bundle
        self.buckets = tuple(buckets)
        self._max_bucket = buckets[-1]
        self._max_queue_s = max(0.0, float(max_queue_ms)) / 1e3
        self.precision = precision or bundle.precision
        dtype = torch.bfloat16 if self.precision == "bf16" else torch.float32
        self.input_shape = bundle.input_shape
        self._model = create_model(bundle.model_name, self.input_shape,
                                   num_classes=bundle.num_classes,
                                   dtype=dtype).to(self.device).eval()
        self._input_rank = getattr(self._model, "input_rank", 5)
        names = {k for k, _ in self._model.named_parameters()}
        buffers = {k for k, _ in self._model.named_buffers()}

        def leaf(x):
            # float32 values; a re-cast rounds to the serving precision
            # first, as the reference casts its leaves
            bf16 = isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
            a = (x.float().numpy() if bf16 else np.asarray(x))
            if self.precision == "bf16" and not bf16 \
                    and np.issubdtype(a.dtype, np.floating):
                a = bf16_round(a).float().numpy()
            return a

        def load(entry):
            params, bstats = params_from_flax(
                _tree_map(leaf, entry["params"]),
                _tree_map(leaf, entry["batch_stats"]))
            if set(params) != names or not set(bstats) <= buffers:
                raise ValueError(
                    f"bundle weights do not fit model {bundle.model_name!r}:"
                    f" leaves {sorted(set(params) ^ names)} differ")
            return ({k: v.to(self.device) for k, v in params.items()},
                    {k: v.to(self.device) for k, v in bstats.items()})

        self._weights = {key: load(entry)
                         for key, entry in bundle.models.items()}

        reg = registry if registry is not None else obs_metrics.REGISTRY
        self._lat = serve_latency_histogram(reg)
        self._occupancy = reg.gauge(
            N.SERVE_BATCH_OCCUPANCY,
            "real requests / bucket slots of the latest dispatch "
            "(serve/engine.py); chronically low means the declared "
            "buckets are too coarse for the offered load")
        self._depth = reg.gauge(
            N.SERVE_QUEUE_DEPTH,
            "requests queued behind the batcher after the latest "
            "collect (serve/engine.py)")

        # one program per (model_key, bucket); only the batcher thread
        # touches these
        self._programs: dict[tuple[str, int], _Program] = {}
        self._sigs: dict[tuple[str, int], tuple] = {}
        self._recompiles = 0
        cuda = self.device.type == "cuda"
        #: the stream the captures run on and the pool the graphs share
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None

        self._cv = threading.Condition()
        self._queues: dict[str, deque[_Pending]] = {
            key: deque() for key in self._weights}
        self._open = True
        self._dispatches = 0
        self._batches: dict[int, int] = {}
        self._real_total = 0
        self._slot_total = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    # ---------- the forward ----------

    def _forward(self, params, bstats, x: torch.Tensor) -> torch.Tensor:
        """The batched eval forward: the trainer's raw float32 cast and
        channel axis (``LocalTrainer._prep``), then the model's primary
        logits in float32."""
        out = functional_call(self._model, (params, bstats),
                              (LocalTrainer._prep(x, self._input_rank),),
                              {"train": False})
        return primary_logits(out).float()

    @torch.no_grad()
    def _build(self, model_key: str, bucket: int) -> _Program:
        """The program of (model, bucket): its input buffer and, on a
        CUDA device, the graph captured over it (after one eager forward
        on the engine's stream, which warms cuDNN there)."""
        prog = _Program(torch.zeros((bucket, *self.input_shape),
                                    dtype=torch.float32, device=self.device))
        if self._stream is None:
            return prog
        params, bstats = self._weights[model_key]
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            self._forward(params, bstats, prog.x)
        torch.cuda.current_stream(self.device).wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self._pool, stream=s,
                              capture_error_mode="global"):
            prog.out = self._forward(params, bstats, prog.x)
        prog.graph = g
        return prog

    @torch.no_grad()
    def _execute(self, model_key: str, prog: _Program,
                 xb: np.ndarray) -> np.ndarray:
        """One dispatch: the padded batch into the buffer, the graph (or,
        on the CPU, the forward) over it, the logits back to the host."""
        prog.x.copy_(torch.from_numpy(xb))
        if prog.graph is None:
            params, bstats = self._weights[model_key]
            return self._forward(params, bstats, prog.x).numpy()
        prog.graph.replay()
        return prog.out.cpu().numpy()

    # ---------- request side ----------

    def submit(self, site: str | None, x) -> tuple[_Pending, str]:
        """Validate and enqueue one request; returns (pending, model_key).
        The shape check is the bucket fence: a non-conforming array would
        otherwise need a program of its own."""
        x = np.asarray(x, dtype=np.float32)
        if tuple(x.shape) != self.input_shape:
            raise ValueError(
                f"input shape {tuple(x.shape)} != bundle input_shape "
                f"{self.input_shape}")
        model_key = self.bundle.route(site)
        pending = _Pending(x)
        with self._cv:
            if not self._open:
                raise RuntimeError("serve engine is closed")
            self._queues[model_key].append(pending)
            self._cv.notify()
        return pending, model_key

    def predict(self, site: str | None, x, timeout: float = 30.0
                ) -> tuple[np.ndarray, str]:
        """Blocking single prediction: (logits row, routed model key)."""
        pending, model_key = self.submit(site, x)
        if not pending.event.wait(timeout):
            raise TimeoutError(
                f"no dispatch within {timeout}s (queue depth "
                f"{self.queue_depth()})")
        if pending.error is not None:
            raise pending.error
        return pending.result, model_key

    def queue_depth(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    # ---------- batcher thread ----------

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while self._open and not any(self._queues.values()):
                    self._cv.wait(0.05)
                if not self._open:
                    leftovers = [p for q in self._queues.values()
                                 for p in q]
                    for q in self._queues.values():
                        q.clear()
                    break
                # the oldest head request picks the model; one batcher
                # serializes the dispatches, so fairness is head-age order
                model_key = min(
                    (q[0].t_enq, k)
                    for k, q in self._queues.items() if q)[1]
                queue = self._queues[model_key]
                deadline = queue[0].t_enq + self._max_queue_s
                while (self._open and len(queue) < self._max_bucket):
                    remain = deadline - time.perf_counter()
                    if remain <= 0:
                        break
                    self._cv.wait(remain)
                n = min(len(queue), self._max_bucket)
                batch = [queue.popleft() for _ in range(n)]
                depth = sum(len(q) for q in self._queues.values())
            self._depth.set(depth)
            if batch:
                try:
                    self._dispatch(model_key, batch)
                except BaseException as e:  # resolve waiters, keep serving
                    for p in batch:
                        p.error = e
                        p.event.set()
        for p in leftovers:
            p.error = RuntimeError("serve engine closed")
            p.event.set()

    def _dispatch(self, model_key: str, batch: list[_Pending]) -> None:
        t_collect = time.perf_counter()
        queue_obs = self._lat.labels(stage="queue")
        for p in batch:
            queue_obs.observe((t_collect - p.t_enq) * 1e3)
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        xb = np.zeros((bucket, *self.input_shape), dtype=np.float32)
        for i, p in enumerate(batch):
            xb[i] = p.x
        t_pad = time.perf_counter()
        batch_obs = self._lat.labels(stage="batch")
        for _ in batch:
            batch_obs.observe((t_pad - t_collect) * 1e3)

        key = (model_key, bucket)
        program = f"{model_key}/b{bucket}"
        sig = (xb.shape, str(xb.dtype))
        fresh = key not in self._programs
        recompile = (not fresh) and self._sigs[key] != sig
        t0 = time.perf_counter()
        if fresh or recompile:
            # the tripwire: a second capture of the SAME (model, bucket)
            # key means the declared-bucket fence leaked a shape
            self._programs[key] = self._build(model_key, bucket)
            self._sigs[key] = sig
            if recompile:
                self._recompiles += 1
            obs_compute.note_compile(ENGINE_LABEL, program,
                                     recompile=recompile)
        phase = "compile" if (fresh or recompile) else "execute"
        y_np = self._execute(model_key, self._programs[key], xb)
        dur = time.perf_counter() - t0
        obs_compute.note_dispatch(ENGINE_LABEL, program, dur, rounds=1,
                                  phase=phase)
        self._occupancy.set(n / bucket)
        self._dispatches += 1
        self._batches[bucket] = self._batches.get(bucket, 0) + 1
        self._real_total += n
        self._slot_total += bucket

        t_done = time.perf_counter()
        dispatch_obs = self._lat.labels(stage="dispatch")
        for i, p in enumerate(batch):
            p.result = y_np[i]
            dispatch_obs.observe((t_done - t_pad) * 1e3)
            p.event.set()
        if self._dispatches % _RULE_BOUNDARY_EVERY == 0:
            obs_rules.observe_boundary(self._dispatches)

    # ---------- lifecycle / introspection ----------

    def stats(self) -> dict:
        """Bookkeeping the worker ships home in its bye message:
        ``compiled`` lists the captured ``model/bN`` programs and
        ``recompiles`` the second captures of one key."""
        return {
            "dispatches": self._dispatches,
            "batches": {str(b): c for b, c in sorted(self._batches.items())},
            "occupancy_mean": (self._real_total / self._slot_total
                               if self._slot_total else 0.0),
            "requests_dispatched": self._real_total,
            "compiled": sorted(f"{mk}/b{b}" for mk, b in self._programs),
            "compiles": len(self._programs),
            "recompiles": self._recompiles,
        }

    def close(self) -> None:
        with self._cv:
            self._open = False
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
