"""A client's local step as a CUDA graph, replayed from static buffers.

``LocalTrainer.local_train`` runs each step of a client through a
:class:`StepGraph`, in every round and every dispatch window: the step's inputs (the client's
parameters, BatchNorm statistics, optimizer state, mask, proximal
reference, the round's lr, the batch rows and the filler weights of the
wrapped last batch) live in static buffers that the step reads and
updates in place. A client's state is copied in when its ``local_train``
starts and out when it ends; each step's batch is gathered into the
static rows before the step.

On a CUDA device the first step of a configuration runs eagerly on the
graph's stream (it warms up cuDNN, cuBLAS and autograd there, and creates
the ``fused_sgd`` workspace of that stream before anything is captured),
the second is captured into a ``torch.cuda.CUDAGraph`` and replayed, and
every later step is a replay. The trainer's generator is registered with
the graph, so each replay draws the dropout keep-masks the eager step
would have drawn. The graphs of one trainer share one memory pool
(``LocalTrainer``), and every trainer's graphs run on the process's graph
stream of the device (:func:`graph_stream`), one after another: a capture
reuses the pool's blocks that earlier captures freed, and an eager first
step the blocks that earlier eager steps, of this run or an earlier one,
freed. The cache is
handed back to the device (a ``cudaFree``, which synchronizes it) only
where a capture would not find the memory its eager step took. The kernel wrappers run on the capture stream and bake their tables
(``fused_sgd``'s leaf descriptors, ``stem_dw``'s operands) into the
graph by value, which holds because every buffer they name is a static
buffer or the graph pool's. A wrapper counts its launches when it
is called, which during capture launches nothing, so a capture's counts
are taken back and added again at each replay.

On the CPU there is nothing to capture: the "capture" and the "replays"
run the same step function on the same static buffers, so a run on the
CPU goes through the buffer handling of the card's path. On the card,
``capture=False`` (``LocalTrainer.capture_steps``) does the same: the
eager steps that the replays are held against. A capture or replay that
fails raises; nothing gives way to eager steps.

``StepGraph.captures`` and ``replays`` feed ``RoundProgram.built`` and
``dispatches`` (the reference's compile and dispatch counts); ``notify``,
where set, hears each capture and replay with its host seconds (the
compute profiler's ``nidt_compiles_total`` and ``nidt_dispatch_ms``,
``obs/compute.py``).
"""

from __future__ import annotations

import time

import torch

from neuroimagedisttraining_tpu_torch.ops import _cuda


#: the graph stream of each device (:func:`graph_stream`), by index
_STREAMS: dict[int, torch.cuda.Stream] = {}


def graph_stream(device: torch.device) -> torch.cuda.Stream:
    """The process's stream for the step graphs of ``device``, made at
    first use. Made anew for every trainer, a stream would keep the
    buffers that live as long as it does (cuBLAS's workspaces) inside a
    block that the run's activations freed, and that block (1 GB at the
    flagship) after the run's release; one stream keeps them once. At its
    making, products in float32 and bfloat16 make those workspaces while
    its pool is empty, so each takes a segment of its own."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _STREAMS.get(idx)
    if s is None:
        dev = torch.device("cuda", idx)
        s = _STREAMS[idx] = torch.cuda.Stream(dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            for dt in (torch.float32, torch.bfloat16):
                a = torch.ones((16, 16), dtype=dt, device=dev,
                               requires_grad=True)
                torch.nn.functional.linear(a, a, a[0]).sum().backward()
        torch.cuda.current_stream(dev).wait_stream(s)
    return s


class StepGraph:
    """One configuration's step: ``body()`` over the static buffers,
    eager at the first call, captured at the second, replayed after."""

    def __init__(self, body, device: torch.device,
                 generator: torch.Generator | None, capture: bool = True,
                 notify=None, stream=None, pool=None):
        self.body = body
        #: ``notify(phase, seconds)`` at each capture ("compile") and
        #: replay ("execute")
        self.notify = notify
        self.device = device
        self.generator = generator
        #: capture on a CUDA device; otherwise every call runs ``body()``
        self.capture = capture and device.type == "cuda"
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self.outputs = None
        self.graph = None
        #: the launches a replay makes, by kernel (counted at capture)
        self.launches: dict[str, int] = {}
        #: the stream the caller runs the step on and the memory pool the
        #: capture allocates from (the trainer's; None on the CPU)
        self.stream = stream
        self.pool = pool
        #: the bytes the eager first step allocated beyond what was held
        #: before it: at most what its capture takes fresh from the device
        self.need = 0
        #: captures that found the device too full and emptied the cache
        self.cache_releases = 0

    def __call__(self):
        self.calls += 1
        if self.calls == 1:
            base = (torch.cuda.memory_allocated(self.device)
                    if self.capture else 0)
            self.outputs = self.body()
            if self.capture:  # host counters: no sync
                self.need = torch.cuda.max_memory_allocated(self.device) \
                    - base
        elif self.calls == 2:
            t0 = time.perf_counter()
            self._capture()
            if self.notify is not None:
                self.notify("compile", time.perf_counter() - t0)
            self._replay()
        else:
            self._replay()
        return self.outputs

    def _capture(self) -> None:
        self.captures += 1
        if not self.capture:
            return
        # a capture that runs short of device memory fails rather than
        # hand cached blocks back (the flagship's did with 53 GB cached):
        # where the device's free memory is under what the eager step
        # allocated, the cache goes back first, a device-wide sync that a
        # card with room never takes
        if torch.cuda.mem_get_info(self.device)[0] < self.need:
            torch.cuda.empty_cache()
            self.cache_releases += 1
        g = torch.cuda.CUDAGraph()
        if self.generator is not None:
            g.register_generator_state(self.generator)
        before = _cuda.counts()
        # the caller runs the step on ``self.stream``; capture_begin does
        # not synchronize the device (torch.cuda.graph's context would)
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            self.outputs = self.body()
        finally:
            g.capture_end()
        after = _cuda.counts()
        self.launches = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        for k, n in self.launches.items():  # captured, not launched
            _cuda.counter(k).add(-n)
        self.graph = g

    def _replay(self) -> None:
        self.replays += 1
        t0 = time.perf_counter()
        if self.graph is None:
            self.outputs = self.body()
        else:
            self.graph.replay()
            for k, n in self.launches.items():
                _cuda.counter(k).add(n)
        if self.notify is not None:
            self.notify("execute", time.perf_counter() - t0)
