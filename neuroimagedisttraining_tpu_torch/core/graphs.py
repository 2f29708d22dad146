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
would have drawn. The kernel wrappers run on the capture stream and bake
their tables (``fused_sgd``'s leaf descriptors, ``stem_dw``'s operands)
into the graph by value, which holds because every buffer they name is a
static buffer or the graph pool's. A wrapper counts its launches when it
is called, which during capture launches nothing, so a capture's counts
are taken back and added again at each replay.

On the CPU there is nothing to capture: the "capture" and the "replays"
run the same step function on the same static buffers, so a run on the
CPU goes through the buffer handling of the card's path. On the card,
``capture=False`` (``LocalTrainer.capture_steps``) does the same: the
eager steps that the replays are held against. A capture or replay that
fails raises; nothing gives way to eager steps.

``StepGraph.captures`` and ``replays`` feed ``RoundProgram.built`` and
``dispatches`` (the reference's compile and dispatch counts).
"""

from __future__ import annotations

import torch

from neuroimagedisttraining_tpu_torch.ops import _cuda


class StepGraph:
    """One configuration's step: ``body()`` over the static buffers,
    eager at the first call, captured at the second, replayed after."""

    def __init__(self, body, device: torch.device,
                 generator: torch.Generator | None, capture: bool = True):
        self.body = body
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
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def __call__(self):
        self.calls += 1
        if self.calls == 1:
            self.outputs = self.body()
        elif self.calls == 2:
            self._capture()
            self._replay()
        else:
            self._replay()
        return self.outputs

    def _capture(self) -> None:
        self.captures += 1
        if not self.capture:
            return
        g = torch.cuda.CUDAGraph()
        if self.generator is not None:
            g.register_generator_state(self.generator)
        before = _cuda.counts()
        # the caller runs the step on ``self.stream``; capture_begin does
        # not synchronize the device (torch.cuda.graph's context would)
        g.capture_begin(capture_error_mode="thread_local")
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
        if self.graph is None:
            self.outputs = self.body()
            return
        self.graph.replay()
        for k, n in self.launches.items():
            _cuda.counter(k).add(n)
