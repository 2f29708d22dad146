"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # full run: kernels, then the engines
    python3 chip_smoke.py --quick    # build + check the kernels only
    python3 chip_smoke.py --zoo-precision  # kernels, then step 7 alone
    python3 chip_smoke.py --vision   # kernels, then step 8 (2D) alone
    python3 chip_smoke.py --darts    # kernels, then step 9 (DARTS) alone
    python3 chip_smoke.py --defense  # kernels, then step 10 (defended) alone
    python3 chip_smoke.py --secure   # kernels, then step 11 (secure) alone
    python3 chip_smoke.py --dispatch # kernels, then step 12 (dispatch) alone

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   four CUDA kernel sources of ``neuroimagedisttraining_tpu_torch/csrc``
   with one ``nvcc`` per source, all started together, and beside them the
   host's row gather (``csrc/gather.cpp``, ``g++``).
2. Holds each kernel against its plain PyTorch version on the card at the
   flagship shapes, with the tolerance stated beside it, and times kernel,
   plain version and (where one exists) the one PyTorch call computing the
   same function; ``bound_ms`` is the least time the card could take.
   Times are device times (``ms``), taken while a spin kernel holds the
   stream until the host has queued the whole call, beside the host's time
   to queue it (``host_ms``). ``stem_dw`` is held on the slice's integral
   x and on a Gaussian x (a TF32 low part in every element), and two calls
   must be bit-equal; its bound is at the split-TF32 tensor-core rate,
   two products where x holds TF32 values only and three otherwise
   (``bound_fp32_cores_ms`` beside it). Its bf16 kernel (``stem_dw_bf16``,
   the ``bf16_mixed`` path: ``wgmma`` fed by a warp-specialised TMA ring)
   is held on bf16 integral and Gaussian x: its f32 sum within 1e-4 of the
   plain f32 sum's largest entry, at least 99.9% of the entries bit-equal
   after both are rounded to bf16, two calls bit-equal, rows of two boxes
   (OW = 69) and the ragged edge shapes ``EDGE_SHAPES`` within the same
   1e-4 and repeatable; bound by its bf16 bytes, beside cuDNN's bf16
   ``conv3d_weight``, with its device operations a call. ``kth_largest`` (row
   ``kth_select``) must equal the host's plain loop bit for bit on four
   kinds of scores, run with no host sync, in at most 6 device operations
   (``torch.profiler``), and is timed against ``torch.topk``. The fused
   SGD step over the flagship's 24 leaves: its pass under given scalars
   and the whole step with the clip skipped or off are bit-equal to the
   plain chain; with the clip taken (gnorm ~ 3 x clip) its norm is within
   rtol 2e-6 of the plain one and the step within a stated tolerance; two
   calls are bit-equal; a step is at most 2 device operations with no
   host sync. ``ms`` is the whole step, ``apply_ms`` the pass alone,
   ``library_ms`` the nearest torch chain (``clip_grad_norm_``,
   ``torch._fused_sgd_``, a masking ``_foreach_mul_``) with its error.
   Beyond one launch's table of 32 leaves: resnet18's 62 leaves (two
   tables) and 140 ragged leaves (five), each bit-equal to the plain pass
   under the kernel's scalars and its norm within rtol 2e-6, with two
   launches a table; the 62-leaf step is timed against its bound.
3. Runs the flagship SalientGrads slice through ``build_experiment`` and
   ``engine.train()``: a synthetic cohort of 48 subjects over 4 sites at
   121x145x121, ``3DCNN``, batch 16, IterSNIP 1, 1 epoch, 2 rounds,
   ``--fused_update`` and ``NIDT_FAST_STEM=1``. The launch counters (one
   per device kernel launched) are set to 0 just before and read just
   after: every kernel of that path (``stem_dw``, ``fused_sgd``,
   ``kth_select``) must have launched, ``fused_sgd`` exactly twice a
   local step.
4. Runs the dense engines on the same flagship slice, each through
   ``build_experiment`` and ``engine.train()`` with the counters set to 0
   just before and read just after: FedAvg (``--frac 0.75``, so 3 of the
   4 clients a round, then the final fine-tune of all 4), FedProx, Ditto
   (both tracks) and Local-only. Each must show ``fused_sgd`` = 2 and
   ``stem_dw`` = 3 launches a local step, counted on the host from the
   clients' rows, no top-k launch, and finite losses and metrics. One more
   FedAvg round runs under torch's sync debug mode; the port's lines that
   synchronized with the host are printed.
5. Runs the sparse personalized engines on the same flagship slice, each
   with the counters set to 0 just before and read just after:
   Sub-FedAvg (``--epochs 2 --dist_thresh 0 --acc_thresh 0``, so its two
   candidate masks differ; it fails unless a prune is accepted) and DisPFL
   (``--frac 0.5``: two random neighbours a client). Each must show
   ``fused_sgd`` = 2 launches a local step and ``stem_dw`` = 3 a local
   step or DisPFL gradient probe, no top-k launch and finite losses and
   metrics; DisPFL's fire and regrow must keep every client's per-layer
   nonzero count and its masks' density within 0.01 of ``dense_ratio``.
   Each prints its rounds, launches, steps and peak memory, the host time
   ``fused_sgd`` spends on its leaf table a step (a new table for every
   new mask; SalientGrads' beside it), the port's lines that synchronized
   with the host in one more round (sync debug mode), and DisPFL the cost
   of a gradient probe and of a mask evolution against a local step.
6. Runs D-PSGD (``--frac 0.5``), FedFomo (``--frac 0.5 --val_fraction
   0.2``) and TurboAggregate (``--frac 0.75``, the share stage on the
   device) on the same flagship slice, each with the counters set to 0
   just before and read just after: ``fused_sgd`` 2 and ``stem_dw`` 3 a
   local step (FedFomo's validation evaluations are forward only), no
   top-k launch, finite losses and metrics; FedFomo's one round under sync
   debug mode must show its one read of ``p_choose`` (any other line is
   printed), and TurboAggregate's share stage is timed against FedAvg's
   plain weighted mean. Then one FedAvg run with ``--client_optimizer
   adam`` (unfused: ``fused_sgd`` 0, ``stem_dw`` 3 a step), and
   ``--client_optimizer adam --fused_update`` must be refused.
   Then the streamed feed (``--streaming``, 2 clients a chunk): the
   flagship cohort, drawn once, written to a ``.npy`` file and read back as
   a memmap (the card's machine has no ``h5py``, so the HDF5 reader is held
   by the CPU tests). SalientGrads, FedAvg, DisPFL and FedFomo run streamed
   with the counters set to 0 just before and read just after: their
   launches must equal their resident runs'; each prints its seconds beside
   the resident run's, the feed's transfer stats, H2D and gather rates,
   the host's wait on it (and the part with the card idle) and both peaks
   of device memory. FedFomo's streamed chunks of every split must equal
   the resident stacks byte for byte, and one streamed FedAvg round under
   sync debug mode must sync nowhere the resident round does not.
7. The model zoo, mixed precision, memory and cuDNN's determinism
   (``zoo_precision_phase``): a flagship FedAvg run under cuDNN's default
   and deterministic algorithms in turns, fp32 and bf16 (the cost; the
   deterministic runs must repeat bit for bit); SalientGrads and FedAvg
   under ``--precision bf16_mixed`` (the bf16 ``stem_dw`` 2 launches a
   step or SNIP pass, never the f32 one, float32 state, seconds beside the
   fp32 runs'); ``--loss_scale 1024`` bit-equal to 1 with every bf16 dW
   call held against a float64 sum; one FedAvg round of each other 3D
   model (``stem_dw`` on the AlexNet family only); the training step's
   peak memory a sample, fp32 and bf16, without and with stem remat (the
   ``--remat auto`` cutoff); remat bit-equal to none; ``NIDT_FAST_POOL``
   against the default pool.
8. The 2D vision path (``vision_phase``): the reference package's CIFAR
   sweep (``CIFAR_SWEEP``: ResNet-18, SalientGrads, 100 clients at
   Dirichlet 0.3, frac 0.1, batch 16, 2 epochs, dense ratio 0.5) for 1
   round on the synthetic vision cohort at CIFAR-10's size, through
   ``federate_vision``, ``create_model``, ``LocalTrainer`` and
   ``create_engine`` (``fused_sgd`` 2 launches a table a step, its 62
   leaves two tables; ``kth_select`` launched; no ``stem_dw``; mask
   density within 0.01); one FedAvg round of every other 2D model on the
   CLI's synthetic vision cohort (``fused_sgd`` 2 a table a step); and
   SalientGrads and FedAvg on ``cnn_cifar10`` and ``resnet18`` through the
   kernels and the plain paths, held as the small 3D input is below. With
   the kernel checks, ``kth_largest`` runs at resnet18's and vgg11's score
   counts (``VISION_SCORES``): bit-equal to the host's plain loop on the
   four kinds of scores, no host sync, at most 6 device operations, timed
   against ``torch.topk``.
9. The DARTS family (``darts_phase``): an engine built without
   ``build_experiment`` must have switched TF32 and cuDNN's default
   algorithms off (the fp32 contract lives in ``LocalTrainer``); the CIFAR
   sweep on ``darts`` at full width (``DARTS_SWEEP``: DARTS_V2, C=36, 20
   cells, 919 leaves, 1 epoch, 1 round of 5 clients; its evaluations
   take client 0 alone, ``--ci 1``) on the synthetic cohort at CIFAR-10's size (``kth_select`` launched for the one mask over
   3,308,940 scores, ``fused_sgd`` 2 launches a table a step over its 29
   tables, no ``stem_dw``, density within 0.01), with one client's local
   step split into wall and device time and ``fused_sgd``'s host and
   device part; one FedAvg round of ``fednas_v1`` and ``darts_search``
   (39 and 44 tables); SalientGrads on a narrow DARTS (C=8, 5 cells)
   through the kernels and the plain paths, held as step 8's small inputs;
   and the drivers, ``DartsSearch`` (first order and unrolled) and
   ``DartsTrainer`` (auxiliary head, drop-path), on the card. With the
   kernel checks, ``kth_largest`` runs at the DARTS network's 3,308,940
   scores and the fused SGD step over its 919 and the search net's 1,401
   leaves (bit-equal to the plain pass, timed against the library chain).
10. The defended round (``defense_phase``) at the flagship width over 6
   site clients: a sign_flip attack against each of the 8 defenses on
   FedAvg and a nonfinite one (one upload rejected), with the launches of
   an undefended run and the round tail's ms; FedAvg with ``--wire_codec
   delta+sparse+quant`` for 2 rounds, plain and under a nonfinite attack:
   ``kth_select`` once a client a round over the upload's 2,571,649
   residual scores at k = 25%, each call equal to its plain version
   (threshold and keep count; the NaN row's NaN), the codec's ms a client
   and its bytes against the dense wire's; SalientGrads with the codec
   (no select beyond its mask's); the select alone on a captured residual
   vector against ``torch.topk``; D-PSGD under ``--dp_clip 1 --dp_sigma 1``
   and FedAvg under ``--defense weak_dp``, each ledger's epsilon equal to
   the host accountant's; FedAvg under ``crash:2@0``, only survivors
   training.
11. Secure quantized aggregation (``secure_phase``) in the defended
   cells' configuration with ``--secure_quant --secure_quant_field_bits
   32``: FedAvg (2 rounds), FedProx, Ditto and SalientGrads through the
   GF(p) fold with the launches of an undefended run (SalientGrads'
   ``kth_select`` 5, its density within 0.01, its aggregate 0 off the
   mask) and no host sync inside the fold; one captured FedAvg round's
   fold bit for bit the host protocol's (``encode_secure_quant`` frames
   folded by a ``SlotAccumulator``) and within one lattice step of the
   plain mean, its device ms beside the undefended tail's, the host's
   encode and fold ms a client, a frame's bytes a parameter at field_bits
   8, 16 and 32; ``byz:2@0:nonfinite`` (one row counted), the clip family
   (the weak-DP ledger against the host accountant); TurboAggregate
   unchanged by the flag, bit for bit; the startup refusals.
12. Round programs and dispatch (``dispatch_phase``): SalientGrads and
   FedAvg on the flagship slice for 5 rounds (evaluation at rounds 0 and
   4) with ``--rounds_per_dispatch 4`` and 1: rounds 1-4 one window whose
   local steps replay CUDA graphs with ``stem_dw`` and ``fused_sgd``
   inside; models, masks and losses bit-equal to the single rounds', one
   host read a window, no host sync inside a window (sync debug mode),
   the launches with replays equal to the single rounds', the graphs'
   captures and replays, round times and the busy share of a window and
   of four single rounds; FedAvg on ResNet-18 over the synthetic cohort at
   CIFAR-10's size (10 clients a round), a 2-round window against 2
   single rounds, bit-equal, round time and busy share of both; the mesh:
   ``--client_mesh 2`` on 2 entries of the card bit-equal to the
   unsharded run, ``--client_mesh 1`` logging its one-device fallback,
   ``--mesh_shape 2 2`` aggregating silo first within 1e-6 of the flat
   mean, D-PSGD over a ring on 4 entries through ring shifts within 1e-6
   of its einsum.
13. Runs SalientGrads, FedProx, Ditto, Sub-FedAvg, DisPFL, D-PSGD, FedFomo
   and TurboAggregate on a small input (69^3, 4 sites, 2 rounds) through
   the kernels and through the plain paths (SalientGrads under one phase-1
   mask), and holds the two runs' losses, weights (global and personal;
   the sparse engines' on the entries both masks keep, beside the share of
   mask entries that differ) and evaluation losses against each other. cuDNN runs its deterministic
   algorithms here, so each path repeats bit for bit and the two differ
   by the kernels alone; a second run of each engine but SalientGrads
   through the kernels must equal the first. Every ``stem_dw`` and
   ``fused_sgd`` call of the kernel runs is also held against its plain
   version on the call's own inputs (``PerCallCheck``). SalientGrads and
   DisPFL also run streamed (2 clients a chunk) and must equal their
   resident runs bit for bit.
14. Prints the run's seconds, one JSON line per kernel, the
   ``{"kernels": [...]}`` line (each kernel's launches on its main path,
   SalientGrads, in bf16 for the bf16 ``stem_dw``, and on every engine's
   run), and last ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it fails before
printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12      # CUDA cores
TF32_OPS_PER_S = 495e12     # tensor cores, dense
BF16_OPS_PER_S = 989e12     # tensor cores, dense
# spin-kernel cycles per second of the host's queueing time to cover; above
# the H100's 1.98 GHz boost clock, so a spin lasts at least that long
SPIN_CYCLES_PER_S = 2.0e9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def device_ops(fn) -> list[str]:
    """Names of the device operations ``fn`` runs (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def local_steps(engine) -> int:
    """Local steps of ``engine.train()``, counted on the host from the
    clients' row counts: the sampled clients' epochs each round (Ditto's
    personal epochs too), FedAvg's / FedProx's / TurboAggregate's fine-tune
    of every client, and every client's epochs each round in Local-only,
    DisPFL, D-PSGD (and its fine-tune every 100 rounds) and FedFomo."""
    cfg = engine.cfg
    B, E = cfg.optim.batch_size, cfg.optim.epochs
    per = [math.ceil(int(n) / B) for n in engine.n_train]
    if cfg.algorithm in ("local", "dispfl", "dpsgd", "fedfomo"):
        steps = sum(per) * E * cfg.fed.comm_round
        if cfg.algorithm == "dpsgd":  # the fine-tune after round 99, 199..
            steps += sum(per) * E * (cfg.fed.comm_round // 100)
        return steps
    if cfg.algorithm == "ditto":
        E += cfg.fed.local_epochs
    steps = sum(sum(per[c] for c in engine.client_sampling(r)) * E
                for r in range(cfg.fed.comm_round))
    if cfg.algorithm in ("fedavg", "fedprox", "turboaggregate"):
        steps += sum(per) * cfg.optim.epochs
    return steps


def probes(engine) -> int:
    """DisPFL's gradient probes in ``engine.train()``: one a client a round
    (every client, rows or not), none under ``--static``."""
    cfg = engine.cfg
    if cfg.algorithm != "dispfl" or cfg.sparsity.static:
        return 0
    return engine.num_clients * cfg.fed.comm_round


class TableTimer:
    """Inside ``with``, the host time ``fused_sgd`` spends finding or
    building its leaf table (``ops/fused_update.py`` ``_table``), a step at
    a time, and how many tables it built."""

    def __init__(self):
        from neuroimagedisttraining_tpu_torch.ops import fused_update as FU
        self.FU, self.orig = FU, FU._table
        self.calls, self.builds, self.seconds = 0, 0, 0.0

    def _table(self, *a, **kw):
        before = self.FU._last_table
        t = time.perf_counter()
        tab = self.orig(*a, **kw)
        self.seconds += time.perf_counter() - t
        self.calls += 1
        self.builds += tab is not before
        return tab

    def __enter__(self):
        self.FU._table = self._table
        return self

    def __exit__(self, *exc):
        self.FU._table = self.orig

    def summary(self) -> dict:
        return {"steps": self.calls, "tables_built": self.builds,
                "host_ms_per_step": 1e3 * self.seconds / max(self.calls, 1)}


def free_card() -> None:
    """Collect the engines a part let go of (a trainer's CUDA graphs hold
    their memory pools until the trainer is collected), then return the
    cached blocks to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def hidden_syncs(fn) -> list[str]:
    """Run ``fn`` with torch's sync debug mode at "warn"; the port's source
    lines (file:line) where a synchronizing CUDA operation ran."""
    import traceback
    import warnings

    import torch

    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return  # not torch's sync warning (set_sync_debug_mode's own)
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack
                  if "neuroimagedisttraining_tpu_torch" in f.filename]
        f = frames[-1] if frames else None
        # no frame of the port: the innermost frames outside warnings
        outer = " < ".join(f"{Path(x.filename).name}:{x.lineno}:{x.name}"
                           for x in stack[::-1][:6])
        sites.append(f"{Path(f.filename).name}:{f.lineno}" if f
                     else f"{filename}:{lineno} ({outer})")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


class PerCallCheck:
    """Inside ``with``, every ``stem_dw`` and ``fused_sgd`` call that an
    engine makes is also computed by its plain version on the same inputs
    (no launch, so no count): ``stem_dw`` within 1e-4 of the plain dW's
    largest entry, as at the flagship shape. In bf16 (``stem_dw_bf16``) a
    training step's g sums to about 0 over the positions (the BatchNorm
    backward), so dW is a small difference of large sums and an f32 sum
    in any order is off by much more than 1e-4 of its largest entry: the
    kernel's f32 sum (one more launch, of a run whose launches are not
    counted) is held against the float64 sum of the same bf16 values
    within ``BF16_SUM_RTOL`` of each entry's sum of magnitudes
    ``sum |x| |g|``, the plain f32 sum beside it, and the returned dW must
    be that f32 sum rounded to bf16. ``fused_sgd`` bit-equal to the plain
    pass under the kernel's own scalars, and within 1e-5 of the largest
    entry of the plain step's params and momentum (the kernel's fp64
    global norm against the plain fp32 one where the clip is taken).
    ``worst`` holds each kernel's largest error over its tolerance,
    ``inexact`` the steps that were not bit-equal."""

    def __init__(self):
        from neuroimagedisttraining_tpu_torch.core import graphs as G
        from neuroimagedisttraining_tpu_torch.core import optim
        from neuroimagedisttraining_tpu_torch.ops import fused_update as FU
        from neuroimagedisttraining_tpu_torch.ops import stemconv as SC
        self.SC, self.optim, self.FU, self.G = SC, optim, FU, G
        self.orig_dw, self.orig_step = SC.stem_dw, optim.fused_sgd_step
        self.orig_graph_init = G.StepGraph.__init__
        self.reset()

    def reset(self) -> None:
        self.calls = {"stem_dw": 0, "stem_dw_bf16": 0, "fused_sgd": 0}
        self.worst = {"stem_dw": 0.0, "stem_dw_bf16": 0.0, "fused_sgd": 0.0}
        # bf16 calls: the least share of rounded entries equal to the
        # plain f32 sum rounded; the plain sum's own worst error over the
        # tolerance; whether every dW was the kernel's f32 sum rounded
        self.bf16_share, self.worst_plain_bf16 = 1.0, 0.0
        self.rounded_ok = True
        self.inexact = self.clip_taken = 0

    def _err(self, name: str, got, ref, tol_of) -> None:
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        tol = tol_of * max(float(b.abs().max()) for b in ref)
        self.worst[name] = max(self.worst[name], err / max(tol, 1e-30))
        self.calls[name] += 1

    def dw(self, x, g, out_dtype=None):
        import torch

        out = self.orig_dw(x, g, out_dtype)
        if out.dtype != torch.bfloat16:
            self._err("stem_dw", [out], [self.SC.stem_dw_plain(
                x, g, out_dtype)], 1e-4)
            return out
        k32 = self.orig_dw(x, g, torch.float32)
        p32 = self.SC.stem_dw_plain(x, g, torch.float32)
        x64, g64 = x.double(), g.double()
        exact = self.SC.stem_dw_plain(x64, g64)
        scale = self.SC.stem_dw_plain(x64.abs(), g64.abs())
        tol = (BF16_SUM_RTOL * scale).clamp_min(
            torch.finfo(torch.float64).tiny)
        err_k = float(((k32.double() - exact).abs() / tol).max())
        err_p = float(((p32.double() - exact).abs() / tol).max())
        self.worst["stem_dw_bf16"] = max(self.worst["stem_dw_bf16"], err_k)
        self.worst_plain_bf16 = max(self.worst_plain_bf16, err_p)
        self.bf16_share = min(self.bf16_share, float(
            (out.view(torch.int16) == p32.to(torch.bfloat16).view(
                torch.int16)).float().mean()))
        self.rounded_ok &= torch.equal(out, k32.to(torch.bfloat16))
        self.calls["stem_dw_bf16"] += 1
        return out

    def step(self, params, grads, trace, mask, **kw):
        def copy():
            return ([p.clone() for p in params],
                    None if trace is None else [t.clone() for t in trace])
        (pa, ta), (ps, ts) = copy(), copy()
        scal = self.orig_step(params, grads, trace, mask, **kw)
        own = {k: v for k, v in kw.items() if k != "lr"}
        if scal is None:  # no clip: the plain step has the same scalars
            own_scal = self.FU.sgd_scalars(grads, clip=0.0, lr=kw["lr"])
        else:
            own_scal = scal.clone()
            self.clip_taken += int(float(own_scal[0]) < 0.5)
        self.FU.sgd_apply_plain(pa, grads, ta, mask, own_scal, **own)
        self.FU.sgd_step_plain(ps, grads, ts, mask, **kw)
        got = params + (trace or [])
        self.inexact += not all(
            torch_equal_bits(a, b) for a, b in zip(got, pa + (ta or [])))
        self._err("fused_sgd", got, ps + (ts or []), 1e-5)
        return scal

    def __enter__(self):
        self.SC.stem_dw, self.optim.fused_sgd_step = self.dw, self.step
        # a graph replay calls no wrapper, and a check reads the host: the
        # local steps made inside run eagerly (``StepGraph`` capture off)
        init = self.orig_graph_init

        def eager_init(graph, *args, **kw):
            init(graph, *args, **kw)
            graph.capture = False

        self.G.StepGraph.__init__ = eager_init
        return self

    def __exit__(self, *exc):
        self.SC.stem_dw = self.orig_dw
        self.optim.fused_sgd_step = self.orig_step
        self.G.StepGraph.__init__ = self.orig_graph_init

    def check(self, what: str, stem: bool = True) -> dict:
        """Fails unless both kernels ran (``fused_sgd`` alone where
        ``stem`` is False: the 2D models have no stem kernel) and every
        call was within its tolerance; returns what was seen."""
        seen = {"calls": dict(self.calls), "worst_err_over_tol":
                dict(self.worst), "fused_sgd_not_bit_equal": self.inexact,
                "fused_sgd_clip_taken": self.clip_taken,
                "stem_dw_bf16_plain_worst_err_over_tol":
                    self.worst_plain_bf16,
                "stem_dw_bf16_least_share_equal_to_plain_rounded":
                    self.bf16_share,
                "stem_dw_bf16_is_its_f32_sum_rounded": self.rounded_ok}
        c = self.calls
        if not c["fused_sgd"] or (stem and not (c["stem_dw"]
                                                or c["stem_dw_bf16"])):
            fail(f"{what}: a kernel was not called: {self.calls}")
        if (not all(v <= 1.0 for v in self.worst.values()) or self.inexact
                or not self.rounded_ok):
            fail(f"{what}: a kernel call disagrees with its plain version "
                 f"on the run's own inputs: {seen}")
        return seen


#: the sparse engines' flags on the card: Sub-FedAvg with 2 epochs and no
#: accept thresholds on distance or accuracy (with 1 epoch its candidate
#: masks are equal and it never prunes), DisPFL with random neighbours
SPARSE_ARGS = {"subavg": ("--epochs", "2", "--dist_thresh", "0",
                          "--acc_thresh", "0"),
               "dispfl": ("--frac", "0.5")}
#: the share of mask entries kernels and plain paths may differ in on the
#: small input: what two implementations that differ in rounding alone
#: differ in after two rounds, measured between the reference package and
#: the port on the CPU (tests/test_torch_subavg.py: 2.0e-4, limit 1e-3;
#: tests/test_torch_dispfl.py: 4.0e-3, limit 1e-2). A weight within the
#: runs' difference of a cut (a prune threshold, a fire or regrow rank)
#: lands on either side of it. On an H100 under cuDNN's default
#: algorithms two plain runs differed in up to 9.3e-4 of Sub-FedAvg's
#: entries and two kernel runs in up to 6.5e-3 of DisPFL's; under
#: cudnn.deterministic kernels against plain differed in 2.9e-7 and
#: 7.8e-7 (scripts/torch_small_spread.py)
SPARSE_MASK_SHARE = {"subavg": 1e-3, "dispfl": 1e-2}
#: every engine's flags on the card beyond the slice's: the sparse ones'
#: and D-PSGD with 2 random neighbours, FedFomo with 2 models requested and
#: a validation split of 0.2, TurboAggregate with 3 of 4 clients a round
ENGINE_ARGS = {**SPARSE_ARGS, "dpsgd": ("--frac", "0.5"),
               "fedfomo": ("--frac", "0.5", "--val_fraction", "0.2"),
               "turboaggregate": ("--frac", "0.75")}
#: resnet18's 62 parameter leaves (the reference's models/resnet2d.py at 10
#: classes, 11,173,962 parameters): two of fused_sgd's 32-leaf tables
RESNET18_SIZES = [
    64, 64, 1728, 64, 64, 64, 64, 36864, 36864, 64, 64, 64, 64, 36864, 36864,
    128, 128, 128, 128, 73728, 147456, 128, 128, 8192, 128, 128, 128, 128,
    147456, 147456, 256, 256, 256, 256, 294912, 589824, 256, 256, 32768, 256,
    256, 256, 256, 589824, 589824, 512, 512, 512, 512, 1179648, 2359296, 512,
    512, 131072, 512, 512, 512, 512, 2359296, 2359296, 10, 5120]


def sync_site(cls, needle: str) -> str:
    """``file:line`` of the first source line of ``cls`` holding
    ``needle`` (a host read an engine makes on purpose)."""
    import inspect

    lines, start = inspect.getsourcelines(cls)
    path = Path(inspect.getsourcefile(cls)).name
    for i, line in enumerate(lines):
        if needle in line:
            return f"{path}:{start + i}"
    fail(f"{needle!r} not found in {cls.__name__}")


def sparse_gap(algorithm: str, a: dict, b: dict, init_p: dict) -> dict:
    """Run ``a`` against run ``b`` of a sparse engine: the share of mask
    entries that differ, and the largest weight difference over the
    largest weight change of ``b`` from ``init_p``, on the entries where
    no client's support (the masks its weights were trained under: the
    personal masks in Sub-FedAvg, a nonzero weight in DisPFL) differs."""
    import torch

    if algorithm == "subavg":
        ma, mb = a["mask_pers"], b["mask_pers"]
        states = [(a["params"], b["params"])]
        support = list(zip(ma, mb))
    else:
        ma, mb = a["masks"], b["masks"]
        states = list(zip(a["personal_params"], b["personal_params"]))
        support = [({k: (v != 0) for k, v in pa.items()},
                    {k: (v != 0) for k, v in pb.items()})
                   for pa, pb in states]
    differ = sum(int((x[k] != y[k]).sum()) for x, y in zip(ma, mb)
                 for k in x)
    total = sum(v.numel() for m in mb for v in m.values())
    keep = {k: torch.stack([sa[k] == sb[k] for sa, sb in support]).all(0)
            for k in states[0][1]}
    moved = max(float((v - init_p[k]).abs().max())
                for _, pb in states for k, v in pb.items())
    err = max(float(((pa[k] - v).abs() * keep[k]).max())
              for pa, pb in states for k, v in pb.items())
    return {"mask_diff_share": differ / total, "differ": differ,
            "param_err_over_change": err / max(moved, 1e-30),
            "largest_weight_change": moved,
            "support_flipped": sum(int((~v).sum()) for v in keep.values())}


def evolution_cost(engine, result) -> dict:
    """DisPFL's mask evolution against a local step, on client 0's final
    state: host-clock ms (synchronized) of a gradient probe alone, of a
    whole evolution (probe, fire, regrow over every layer), and of one
    local step (a 1-epoch ``client_train``), each the mean of 3 calls
    after a warm-up."""
    import torch

    p, b = result["personal_params"][0], result["personal_batch_stats"][0]
    m = result["masks"][0]
    _, rows = next(engine.client_rows([0]))
    n = rows.n
    idx = engine.probe_rows(0, 0, n)
    X, y = rows.X[idx], rows.y[idx]
    lr = engine.round_lr(0)

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 3 * 1e3

    return {"probe_ms": ms(lambda: engine.trainer.eval_grad(p, b, X, y)),
            "evolve_ms": ms(lambda: engine.evolve(1, 0, rows, p, b, m)),
            "local_step_ms": ms(lambda: engine.client_train(
                1, 0, rows, p, b, lr, 1, mask=m)), "client_rows": n}


#: clients a streamed chunk holds on the card: with 4 clients a walk
#: crosses a chunk boundary, and a round's sampled 3 take two chunks
STREAM_CHUNK = 2
#: the engines run streamed at full width, each beside its resident run
STREAMED = {"salientgrads": (), "fedavg": ("--frac", "0.75"),
            "dispfl": ("--frac", "0.5"),
            "fedfomo": ("--frac", "0.5", "--val_fraction", "0.2")}


def stream_phase(card, dev, flagship, build_experiment, synthetic,
                 resident: dict, by_path: dict) -> None:
    """The streamed feed at full width. The flagship cohort, drawn once,
    is written to a ``.npy`` file and read back as a memmap: a lazy,
    row-sliceable source of 102 MB, as an HDF5 file's dataset is (the
    card's machine has no ``h5py``, so the HDF5 reader is held by the CPU
    tests). SalientGrads, FedAvg, DisPFL and FedFomo run streamed at
    ``STREAM_CHUNK`` clients a chunk with the counters set to 0 just
    before and read just after: their kernel launches must equal their
    resident runs'. Each prints its round (phase-1, fine-tune) seconds
    beside the resident run's, ``transfer_stats``, the H2D and gather
    rates, the main thread's wait on the feed against the feed's own time,
    and both peaks of device memory. FedFomo's chunks of every split must
    equal the resident stacks on the card byte for byte, read after the
    consumer's ``wait_event``; one streamed FedAvg round under sync debug
    mode must sync nowhere the resident round does not."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from neuroimagedisttraining_tpu_torch.ops import _cuda

    cached = synthetic.generate_synthetic_abcd
    tmp = Path(tempfile.mkdtemp(prefix="nidt_stream_"))
    memmaps = {}

    def memmap_cohort(**kw):
        key = tuple(sorted(kw.items()))
        if key not in memmaps:
            c = cached(**kw)
            path = tmp / f"cohort{len(memmaps)}.npy"
            mm = np.lib.format.open_memmap(path, mode="w+",
                                           dtype=c["X"].dtype,
                                           shape=c["X"].shape)
            mm[:] = c["X"]
            mm.flush()
            del mm
            memmaps[key] = {**c, "X": np.load(path, mmap_mode="r")}
        return memmaps[key]

    synthetic.generate_synthetic_abcd = memmap_cohort
    try:
        for algorithm, extra in STREAMED.items():
            ecfg = flagship(algorithm, *extra, "--stream_chunk_clients",
                            str(STREAM_CHUNK))
            engine, info = build_experiment(ecfg, "cuda", streaming=True)
            stream = engine.stream
            if not isinstance(stream.X, np.memmap):
                fail(f"{algorithm}: the streamed source is not the memmap")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _cuda.reset_counts()
            t0 = time.perf_counter()
            result = engine.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            got = _cuda.counts()
            by_path[f"{algorithm}_streamed"] = got
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            stream.sync()
            ts = dict(stream.transfer_stats)
            feed_ms = ts["host_gather_ms"] + ts["device_put_ms"]
            res = resident[algorithm]
            losses = [h["train_loss"] for h in result["history"]]
            final = result.get("final_personal") or result["final_global"]
            out = {"streamed": algorithm, "card": card,
                   "chunk_clients": STREAM_CHUNK,
                   "source": "memmap .npy",
                   "round_seconds": result.get("round_seconds") or [
                       h["round_seconds"] for h in result["history"]],
                   "round_seconds_resident": res["round_seconds"],
                   "train_seconds": train_s,
                   "train_seconds_resident": res["train_seconds"],
                   "phase1_seconds": result.get("phase1_seconds"),
                   "phase1_seconds_resident": res.get("phase1_seconds"),
                   "finetune_seconds": result.get("finetune_seconds"),
                   "finetune_seconds_resident":
                       res.get("finetune_seconds"),
                   "launches": got, "launches_resident": res["launches"],
                   "transfer_stats": ts,
                   "h2d_gb_per_s": ts["bytes"] / ts["device_put_ms"] / 1e6,
                   "gather_gb_per_s":
                       ts["bytes"] / ts["host_gather_ms"] / 1e6,
                   "feed_ms": feed_ms, "main_thread_wait_ms": stream.wait_ms,
                   "wait_with_card_idle_ms": stream.idle_wait_ms,
                   "feed_hidden_share": 1.0 - stream.idle_wait_ms / feed_ms,
                   "feed_device_bytes": sum(
                       slot.dev_X.nbytes + slot.dev_i.nbytes
                       for slot in stream._slots if slot.rows),
                   "peak_memory_gb": peak_gb,
                   "peak_memory_gb_resident": res["peak_memory_gb"],
                   "train_loss": losses, "final": final}
            if got != res["launches"]:
                fail(f"{algorithm} streamed launched {got}, resident "
                     f"{res['launches']}")
            if not all(math.isfinite(v) for v in losses + [
                    final[m] for m in ("acc", "loss", "auc")]):
                fail(f"{algorithm} streamed: non-finite losses or metrics")
            if algorithm == "fedavg":
                syncs = hidden_syncs(lambda: engine.run_round(
                    2, result["params"], result["batch_stats"],
                    engine.client_sampling(2)))
                added = sorted(set(syncs) - set(res["sync_warnings"]))
                out.update(sync_warnings=syncs, syncs_added=added)
                if added:
                    fail(f"the streamed FedAvg round synced at {added}")
            if algorithm == "fedfomo":
                ref, _ = build_experiment(flagship(algorithm, *extra), "cuda")
                checked = 0
                for split in ("train", "test", "val"):
                    X, y, n = ref._resident(split)
                    for ch in stream.eval_chunks(STREAM_CHUNK, split):
                        for j, c in enumerate(ch.ids):
                            if not (torch.equal(ch.X[j], X[c])
                                    and torch.equal(ch.y[j], y[c])
                                    and int(ch.n[j]) == int(n[c])):
                                fail(f"streamed {split} rows of client {c} "
                                     "differ from the resident stack")
                            checked += 1
                        for j in range(len(ch.ids), STREAM_CHUNK):
                            if ch.X[j].any() or int(ch.n[j]):
                                fail(f"a pad client of a {split} chunk is "
                                     "not zero")
                out["byte_equal_client_splits"] = checked
                del ref
            print(json.dumps(out))
            stream.close()
            del engine, result, stream
            free_card()
    finally:
        synthetic.generate_synthetic_abcd = cached
        shutil.rmtree(tmp, ignore_errors=True)


#: bf16 dW against its plain version: the kernel's f32 sum within 1e-4 of
#: the plain f32 sum's largest entry (f32 sums of 3.95 M exact bf16
#: products in other orders), and after both are rounded to bf16 at least
#: this share of the entries bit-equal (a sum within its difference of a
#: rounding boundary rounds to the neighbouring bf16 value)
BF16_EQUAL_SHARE = 0.999
#: a bf16 dW entry's f32 sum against its float64 sum, over the entry's sum
#: of magnitudes sum |x| |g| (about 8 f32 units of it: the summation error
#: an f32 sum of 3.95 M exact products may carry in any order)
BF16_SUM_RTOL = 2.0 ** -20
#: x shapes [B, D, H, W] at which the bf16 kernel's work items are ragged:
#: B = 1 at the flagship volume; 54 items, fewer than the persistent grid;
#: OW 32 (half of each row's box padded), where the last run ends at g's
#: end and is read through the map of 16-byte rows; OW 63, one column short
#: of a box; both x of odd size (the producer copies its last elements)
EDGE_SHAPES = ((1, 121, 145, 121), (2, 21, 25, 23), (1, 7, 23, 67),
               (1, 7, 13, 129))


def bf16_stem_dw_row(dev, gen, quick: bool, time_ms) -> dict:
    """The bf16 stem weight gradient (``csrc/stem_dw_bf16.cu``) at the
    flagship shape: x the slice's integral voxels in bf16 (and a Gaussian
    x), g bf16 in the conv backward's NCDHW memory. The kernel's f32 sum is
    held against the plain f32 sum of the same bf16 values within 1e-4 of
    its largest entry, the rounded dW bit-equal in ``BF16_EQUAL_SHARE`` of
    the entries; two calls bit-equal; rows of two boxes (OW = 69) and the
    edge shapes too; the device operations of one call listed. Bound: x
    and g read once in bf16, dW written once, against the data sheet's
    dense bf16 tensor-core rate."""
    import torch

    from neuroimagedisttraining_tpu_torch.ops import stemconv as SC

    bf = torch.bfloat16
    B, D, H, W = 16, 121, 145, 121
    od, oh, ow = (D - 5) // 2 + 1, (H - 5) // 2 + 1, (W - 5) // 2 + 1
    g_ncdhw = torch.randn((B, 64, od, oh, ow), generator=gen, device=dev,
                          dtype=bf)
    g = g_ncdhw.permute(0, 2, 3, 4, 1)
    out = {}
    for kind in ("gaussian", "integral"):
        if kind == "gaussian":
            x = torch.randn((B, D, H, W, 1), generator=gen, device=dev,
                            dtype=bf)
        else:
            x = torch.randint(0, 256, (B, D, H, W, 1), generator=gen,
                              device=dev).to(bf)
        k32 = SC.stem_dw(x, g, torch.float32)
        kb, kb2 = SC.stem_dw(x, g), SC.stem_dw(x, g)
        p32 = SC.stem_dw_plain(x, g, torch.float32)
        pb = SC.stem_dw_plain(x, g)
        torch.cuda.synchronize()
        e = float((k32 - p32).abs().max())
        t = 1e-4 * float(p32.abs().max())
        share = float((kb.view(torch.int16) == pb.view(torch.int16)
                       ).float().mean())
        if kb.dtype != bf or not torch.equal(kb, k32.to(bf)):
            fail(f"stem_dw bf16 ({kind} x): the dW is not the f32 sum "
                 "rounded to bf16")
        if not e <= t:
            fail(f"stem_dw bf16 ({kind} x) disagrees with its plain "
                 f"version: {e} > {t}")
        if not share >= BF16_EQUAL_SHARE:
            fail(f"stem_dw bf16 ({kind} x): {share} of the rounded entries "
                 f"equal the plain version's, under {BF16_EQUAL_SHARE}")
        if not torch.equal(kb.view(torch.int16), kb2.view(torch.int16)):
            fail(f"stem_dw bf16 ({kind} x): two calls on the same inputs "
                 "differ")
        out[kind] = (e, t, share)
        if kind == "gaussian":
            del x
    xw = torch.randn((2, 21, 25, 141, 1), generator=gen, device=dev,
                     dtype=bf)
    gw = torch.randn((2, 64, 9, 11, 69), generator=gen, device=dev,
                     dtype=bf).permute(0, 2, 3, 4, 1)
    pw = SC.stem_dw_plain(xw, gw, torch.float32)
    ew = float((SC.stem_dw(xw, gw, torch.float32) - pw).abs().max())
    if not ew <= 1e-4 * float(pw.abs().max()):
        fail(f"stem_dw bf16 at OW = 69 disagrees with its plain version: "
             f"{ew}")
    del xw, gw, pw
    # where a work decomposition breaks (EDGE_SHAPES): each within 1e-4 of
    # the plain sum's largest entry and two calls bit-equal
    edges = {}
    for shape in EDGE_SHAPES:
        xe = torch.randn(shape + (1,), generator=gen, device=dev, dtype=bf)
        oe = [(n - 5) // 2 + 1 for n in shape[1:]]
        ge = torch.randn((shape[0], 64, *oe), generator=gen, device=dev,
                         dtype=bf).permute(0, 2, 3, 4, 1)
        pe = SC.stem_dw_plain(xe, ge, torch.float32)
        ke, ke2 = SC.stem_dw(xe, ge, torch.float32), SC.stem_dw(xe, ge,
                                                                 torch.float32)
        ee, te = float((ke - pe).abs().max()), 1e-4 * float(pe.abs().max())
        if not ee <= te:
            fail(f"stem_dw bf16 at x {shape} disagrees with its plain "
                 f"version: {ee} > {te}")
        if not torch.equal(ke.view(torch.int32), ke2.view(torch.int32)):
            fail(f"stem_dw bf16 at x {shape}: two calls differ")
        edges["x".join(map(str, shape))] = ee / te
        del xe, ge, pe, ke, ke2
    ops = device_ops(lambda: SC.stem_dw(x, g))
    R = B * od * oh * ow
    flops = 2.0 * R * 125 * 64
    nbytes = 2.0 * (x.numel() + g.numel() + 125 * 64)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_OPS_PER_S)
    k_ms = k_host = p_ms = l_ms = None
    extra = {}
    if not quick:
        x_ncdhw = x.reshape(B, 1, D, H, W)
        k_ms, k_host = time_ms(lambda: SC.stem_dw(x, g), 10)
        p_ms, _ = time_ms(lambda: SC.stem_dw_plain(x, g), 3)
        l_ms, _ = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x_ncdhw, (64, 1, 5, 5, 5), g_ncdhw, stride=2), 10)
        lib = torch.nn.grad.conv3d_weight(x_ncdhw, (64, 1, 5, 5, 5),
                                          g_ncdhw, stride=2)
        extra["library_vs_plain_max_abs_err"] = float(
            (lib.permute(2, 3, 4, 1, 0).float() - p32).abs().max())
        del x_ncdhw, lib
    e, t, share = out["integral"]
    return {"name": "stem_dw_bf16", "route": "cuda",
            "source": "neuroimagedisttraining_tpu_torch/csrc/stem_dw_bf16.cu",
            "replaces": "neuroimagedisttraining_tpu/ops/stemconv.py:112",
            "max_abs_err": e, "tolerance": t, "bf16_equal_share": share,
            "ms": k_ms, "host_ms": k_host, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            "library": "torch.nn.grad.conv3d_weight (bf16)",
            "bound_bf16_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "gaussian_max_abs_err": out["gaussian"][0],
            "gaussian_tolerance": out["gaussian"][1],
            "gaussian_bf16_equal_share": out["gaussian"][2],
            "wide_rows_max_abs_err": ew, "edge_err_over_tol": edges,
            "device_ops": len(ops) or None, "device_op_names": ops, **extra}


def drive(build_experiment, cfg, dev, deterministic=None) -> dict:
    """Build ``cfg``'s engine and run ``engine.train()`` with the launch
    counters set to 0 just before and read just after; ``deterministic``
    (where given) sets cuDNN's mode after the build. Returns the engine, its
    result, launches, local steps, seconds and peak device memory."""
    import torch

    from neuroimagedisttraining_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    engine, info = build_experiment(cfg, "cuda")
    setup_s = time.perf_counter() - t0
    if deterministic is not None:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = False
    steps = local_steps(engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_counts()
    t0 = time.perf_counter()
    result = engine.train()
    torch.cuda.synchronize()
    return {"engine": engine, "result": result, "launches": _cuda.counts(),
            "steps": steps, "setup_seconds": setup_s,
            "train_seconds": time.perf_counter() - t0,
            "partition": info["train_counts"],
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def float_dtypes(tree) -> set:
    """The dtypes of every floating tensor in a result (dicts, lists)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return {tree.dtype} if tree.is_floating_point() else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(float_dtypes(v) for v in tree)) if tree \
            else set()
    return set()


def model_states(res: dict) -> list:
    """A run's models: global and personal parameters and stats."""
    out = []
    for k in ("params", "batch_stats", "personal_params",
              "personal_batch_stats"):
        v = res.get(k)
        if v is not None:
            out += v if isinstance(v, list) else [v]
    per = res.get("personal")
    if isinstance(per, dict):
        out += per["params"] + per["batch_stats"]
    return out


def states_bit_equal(a: dict, b: dict) -> bool:
    sa, sb = model_states(a), model_states(b)
    return len(sa) == len(sb) and all(
        x.keys() == y.keys() and all(torch_equal_bits(x[k], y[k]) for k in x)
        for x, y in zip(sa, sb))


def mean(xs) -> float:
    return sum(xs) / len(xs)


#: the 3D models beside the flagship, each one FedAvg round at full width:
#: whether its stem is the 5^3 stride-2 ConvBNReLU3D that reaches stem_dw
ZOO = {"3dcnn_deeper": True, "3dcnn_regression": True, "3dcnn_gn": True,
       "resnet3d": False, "3dcnn_tiny": False}


def zoo_precision_phase(card, dev, flagship, build_experiment,
                        resident: dict, by_path: dict) -> None:
    """The model zoo, mixed precision and the memory side at full width
    (121x145x121, the flagship slice's cohort), each run with the launch
    counters set to 0 just before and read just after:

    - cuDNN's determinism: a FedAvg run (``--frac 0.75``, 4 rounds) under
      the default algorithms and under ``cudnn.deterministic`` (benchmark
      off), in turns (default, deterministic, deterministic, default), in
      fp32 and in bf16_mixed; the cost is the mean round's seconds (rounds
      1-3) deterministic over default. The two deterministic runs must be
      bit-equal; whether the default ones are is printed.
    - bf16_mixed: SalientGrads and FedAvg with ``--fused_update`` and the
      fast stem must launch the bf16 ``stem_dw`` (2 a step or SNIP pass),
      never the f32 one, ``fused_sgd`` 2 a step (and SalientGrads
      ``kth_select``), and leave every model leaf and stat float32; their
      seconds print beside the fp32 runs'. Two bf16 FedAvg runs at
      ``--loss_scale`` 1 and 1024 under deterministic cuDNN must be
      bit-equal, every bf16 ``stem_dw`` call of both, and of one more
      bf16 SalientGrads run, held against its plain version
      (``PerCallCheck``).
    - The zoo: one FedAvg round of each model of ``ZOO``: ``fused_sgd`` 2 a
      step; ``stem_dw`` 3 a step for the ConvBNReLU3D stems, none for
      ResNet3D and Tiny3DCNN; finite losses.
    - Memory: the flagship's training step at batch 8 and 16, fp32 and
      bf16, without and with stem remat: peak device memory above what was
      allocated before the step, its growth a sample, the step's time; the
      largest batch whose step without remat stays within 90% of the card
      (``--remat auto``'s cutoff, printed beside ``REMAT_AUTO_SAMPLES``).
      FedAvg under ``--remat none`` and ``stem`` must be bit-equal under
      deterministic cuDNN. ``NIDT_FAST_POOL=1`` against the default pool
      (one FedAvg round): the round's loss bit-equal (the forward is the
      same), the global weights within 5e-2 of the largest weight change
      (where a window's maxima tie the gradient goes to other inputs)."""
    import torch

    from neuroimagedisttraining_tpu_torch.core.optim import (
        REMAT_AUTO_SAMPLES,
    )

    det0 = torch.backends.cudnn.deterministic
    fedavg = ("fedavg", "--frac", "0.75")

    # ---- cuDNN determinism: its cost on a flagship FedAvg round ----
    det_out = {"card": card}
    for prec in ("fp32", "bf16_mixed"):
        secs = {False: [], True: []}
        runs = {False: [], True: []}
        for det in (False, True, True, False):
            r = drive(build_experiment, flagship(
                *fedavg, "--comm_round", "4", "--precision", prec), dev,
                deterministic=det)
            secs[det].append(mean(r["result"]["round_seconds"][1:]))
            runs[det].append(r["result"])
            del r
        det_out[prec] = {
            "round_seconds_default": secs[False],
            "round_seconds_deterministic": secs[True],
            "deterministic_cost": mean(secs[True]) / mean(secs[False]) - 1,
            "deterministic_repeats": states_bit_equal(*runs[True]),
            "default_repeats": states_bit_equal(*runs[False])}
        if not det_out[prec]["deterministic_repeats"]:
            fail(f"{prec}: two flagship FedAvg runs under deterministic "
                 "cuDNN differ")
        del runs
        free_card()
    print(json.dumps({"determinism": det_out}))
    torch.backends.cudnn.deterministic = det0

    # ---- bf16_mixed on the flagship path ----
    bf16 = ("--precision", "bf16_mixed")
    for algorithm, extra in (("salientgrads", ()), ("fedavg", fedavg[1:])):
        r = drive(build_experiment, flagship(algorithm, *extra, *bf16), dev)
        got, res, steps = r["launches"], r["result"], r["steps"]
        passes = steps + (len(r["engine"].n_train)
                          if algorithm == "salientgrads" else 0)
        by_path[f"{algorithm}_bf16"] = got
        f32 = resident.get(algorithm, {})
        losses = [h["train_loss"] for h in res["history"]]
        dtypes = sorted(str(d) for d in float_dtypes(res))
        out = {"engine": algorithm, "precision": "bf16_mixed", "card": card,
               "launches": got, "local_steps": steps,
               "round_seconds": res.get("round_seconds") or [
                   h["round_seconds"] for h in res["history"]],
               "round_seconds_fp32": f32.get("round_seconds"),
               "phase1_seconds": res.get("phase1_seconds"),
               "phase1_seconds_fp32": f32.get("phase1_seconds"),
               "finetune_seconds": res.get("finetune_seconds"),
               "finetune_seconds_fp32": f32.get("finetune_seconds"),
               "train_seconds": r["train_seconds"],
               "train_seconds_fp32": f32.get("train_seconds"),
               "peak_memory_gb": r["peak_memory_gb"],
               "peak_memory_gb_fp32": f32.get("peak_memory_gb"),
               "train_loss": losses, "result_float_dtypes": dtypes,
               "final": res.get("final_personal") or res["final_global"]}
        print(json.dumps(out))
        if got["stem_dw_bf16"] != 2 * passes or got["stem_dw"]:
            fail(f"{algorithm} bf16: {got} in {passes} steps and SNIP "
                 "passes, not stem_dw_bf16 2 each and no f32 stem_dw")
        if got["fused_sgd"] != 2 * steps:
            fail(f"{algorithm} bf16: fused_sgd {got['fused_sgd']} in "
                 f"{steps} local steps, not 2 a step")
        if (got["kth_select"] > 0) != (algorithm == "salientgrads"):
            fail(f"{algorithm} bf16: kth_select launches {got}")
        if dtypes != ["torch.float32"]:
            fail(f"{algorithm} bf16: the run's state holds {dtypes}, not "
                 "float32 alone")
        if not all(math.isfinite(v) for v in losses):
            fail(f"{algorithm} bf16: non-finite losses {losses}")
        del r, res
        free_card()
    scaled = {}
    per_call = PerCallCheck()
    with per_call:
        for scale in ("1", "1024"):
            scaled[scale] = drive(build_experiment, flagship(
                *fedavg, "--comm_round", "1", *bf16, "--loss_scale", scale),
                dev, deterministic=True)["result"]
    calls = per_call.check("bf16 loss-scale runs")
    same = (states_bit_equal(scaled["1"], scaled["1024"])
            and scaled["1"]["history"][0]["train_loss"]
            == scaled["1024"]["history"][0]["train_loss"])
    print(json.dumps({"loss_scale_1024_bit_equal_to_1": same,
                      "per_call": calls, "card": card}))
    if not same:
        fail("bf16 FedAvg at --loss_scale 1024 differs from scale 1")
    if not calls["calls"]["stem_dw_bf16"]:
        fail("the loss-scale runs made no bf16 stem_dw call")
    del scaled
    # SalientGrads in bf16 once more (its phase 1 and rounds), every bf16
    # stem_dw call held too
    per_call.reset()
    with per_call:
        drive(build_experiment, flagship("salientgrads", *bf16), dev)
    calls = per_call.check("bf16 SalientGrads run")
    print(json.dumps({"salientgrads_bf16_per_call": calls, "card": card}))
    if not calls["calls"]["stem_dw_bf16"]:
        fail("the bf16 SalientGrads run made no bf16 stem_dw call")
    torch.backends.cudnn.deterministic = det0
    free_card()

    # ---- the zoo: one FedAvg round each at full width ----
    for name, stem in ZOO.items():
        r = drive(build_experiment, flagship(
            *fedavg, "--model", name, "--comm_round", "1"), dev)
        got, res, steps = r["launches"], r["result"], r["steps"]
        by_path[f"fedavg_{name}"] = got
        losses = [h["train_loss"] for h in res["history"]]
        n_params = sum(v.numel() for v in res["params"].values())
        print(json.dumps({
            "zoo": name, "card": card, "launches": got,
            "local_steps": steps, "params": n_params,
            "leaves": len(res["params"]),
            "stats": len(res["batch_stats"]),
            "round_seconds": res["round_seconds"],
            "finetune_seconds": res["finetune_seconds"],
            "peak_memory_gb": r["peak_memory_gb"], "train_loss": losses,
            "final_personal": res["final_personal"]}))
        if got["fused_sgd"] != 2 * steps:
            fail(f"{name}: fused_sgd {got['fused_sgd']} in {steps} steps")
        if got["stem_dw"] != (3 * steps if stem else 0):
            fail(f"{name}: stem_dw launched {got['stem_dw']} times in "
                 f"{steps} steps (its stem {'does' if stem else 'does not'}"
                 " reach the kernel)")
        if not all(math.isfinite(v) for v in losses):
            fail(f"{name}: non-finite losses {losses}")
        del r, res
        free_card()

    # ---- memory: a sample's peak and the remat policies ----
    total = torch.cuda.get_device_properties(dev).total_memory
    gen = torch.Generator(device=dev).manual_seed(3)
    mem = {"card": card, "total_memory_gb": total / 1e9}
    X = y = None
    for prec in ("fp32", "bf16_mixed"):
        for remat in ("none", "stem"):
            engine, _ = build_experiment(flagship(
                "fedavg", "--precision", prec, "--remat", remat), "cuda")
            if X is None:  # 16 volumes of the slice's shape
                X = torch.randint(0, 256, (16, *engine.sample_shape),
                                  generator=gen, device=dev,
                                  dtype=torch.uint8)
                y = (torch.arange(16, device=dev) % 2).to(torch.int32)
            params, bstats = engine.init_global_state()
            tr = engine.trainer
            peak = {}
            for b in (8, 16):
                tr.loss_and_grad(params, bstats, X[:b], y[:b])  # warm-up
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                out = tr.loss_and_grad(params, bstats, X[:b], y[:b])
                torch.cuda.synchronize()
                peak[b] = torch.cuda.max_memory_allocated(dev) - before
                del out
            t0 = time.perf_counter()
            for _ in range(3):
                out = tr.loss_and_grad(params, bstats, X, y)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / 3 * 1e3
            del out
            slope = (peak[16] - peak[8]) / 8
            fixed = peak[16] - 16 * slope
            row = {"peak_gb_b16": peak[16] / 1e9, "peak_gb_b8": peak[8] / 1e9,
                   "gb_per_sample": slope / 1e9, "fixed_gb": fixed / 1e9,
                   "allocated_before_gb": before / 1e9,
                   "step_ms_b16": step_ms}
            if remat == "none":
                row["batch_cutoff_90pct"] = int(
                    (0.9 * total - before - fixed) // slope)
                row["committed_cutoff"] = REMAT_AUTO_SAMPLES[prec]
            mem[f"{prec}_{remat}"] = row
            del engine, params, bstats, tr
            free_card()
    del X, y
    runs = {}
    for remat in ("none", "stem"):
        r = drive(build_experiment, flagship(
            *fedavg, "--comm_round", "1", "--remat", remat), dev,
            deterministic=True)
        runs[remat] = r["result"]
        mem[f"fedavg_remat_{remat}"] = {
            "peak_memory_gb": r["peak_memory_gb"],
            "round_seconds": r["result"]["round_seconds"],
            "finetune_seconds": r["result"]["finetune_seconds"],
            "launches": r["launches"]}
        del r
    mem["remat_bit_equal"] = states_bit_equal(runs["none"], runs["stem"])
    if not mem["remat_bit_equal"]:
        fail("flagship FedAvg under --remat stem differs from --remat none "
             "under deterministic cuDNN")
    del runs
    free_card()
    pools = {}
    try:
        for env in ("0", "1"):
            os.environ["NIDT_FAST_POOL"] = env
            r = drive(build_experiment, flagship(*fedavg, "--comm_round",
                                                 "1"), dev,
                      deterministic=True)
            pools[env] = r
    finally:
        os.environ.pop("NIDT_FAST_POOL", None)
    init_p, _ = pools["0"]["engine"].init_global_state()
    a, b = pools["1"]["result"], pools["0"]["result"]
    moved = max(float((v - init_p[k]).abs().max())
                for k, v in b["params"].items())
    p_err = max(float((a["params"][k] - v).abs().max())
                for k, v in b["params"].items())
    la, lb = a["history"][0]["train_loss"], b["history"][0]["train_loss"]
    mem["fast_pool"] = {"train_loss": la, "train_loss_default": lb,
                        "param_max_abs_err": p_err,
                        "largest_weight_change": moved,
                        "round_seconds": a["round_seconds"],
                        "round_seconds_default": b["round_seconds"],
                        "peak_memory_gb": pools["1"]["peak_memory_gb"],
                        "peak_memory_gb_default":
                            pools["0"]["peak_memory_gb"]}
    print(json.dumps({"memory": mem}))
    if la != lb:
        fail(f"NIDT_FAST_POOL=1: the round's loss {la} differs from the "
             f"default pool's {lb} (the forward is the same)")
    if not p_err <= 5e-2 * moved:
        fail(f"NIDT_FAST_POOL=1: weights {p_err} from the default pool's, "
             f"over 5e-2 of the largest change {moved}")
    del pools, a, b
    torch.backends.cudnn.deterministic = det0
    free_card()


#: the reference package's CIFAR sweep (scripts/run_cifar_salientgrads.sh),
#: cut to 1 round to keep the whole smoke well inside its limit on a slow
#: host; its data is the synthetic vision cohort at CIFAR-10's size
#: (CIFAR_SIZE), since neither machine holds the CIFAR files
CIFAR_SWEEP = ("--algorithm", "salientgrads", "--dataset", "cifar10",
               "--model", "resnet18", "--partition_method", "dir",
               "--partition_alpha", "0.3", "--client_num_in_total", "100",
               "--frac", "0.1", "--comm_round", "1", "--batch_size", "16",
               "--epochs", "2", "--lr", "0.01", "--dense_ratio", "0.5",
               "--itersnip_iteration", "1", "--fused_update")
CIFAR_SIZE = (50000, 10000)
#: maskable scores (conv and dense kernels) at 10 classes: the global
#: top-k select's sizes on the 2D path
VISION_SCORES = {"resnet18": 11_164_352, "vgg11": 9_222_848}


def parse_cfg(argv):
    import argparse

    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, config_from_args,
    )
    return config_from_args(add_args(argparse.ArgumentParser())
                            .parse_args(list(argv)))


def cifar_sweep_engine(dev, argv=CIFAR_SWEEP):
    """The CIFAR sweep's engine on ``dev`` through the entry points a user
    calls: ``federate_vision`` (100 clients, Dirichlet 0.3, the synthetic
    cohort at ``CIFAR_SIZE``), ``create_model``, ``LocalTrainer``,
    ``create_engine``. Returns ``(engine, partition info)``."""
    import torch

    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.data.vision import federate_vision
    from neuroimagedisttraining_tpu_torch.engines import create_engine
    from neuroimagedisttraining_tpu_torch.models import create_model

    dev = torch.device(dev)  # LocalTrainer applies the fp32 contract
    cfg = parse_cfg(argv)
    d = cfg.data
    fed, info = federate_vision(
        d.dataset, d.data_dir, d.partition_method, d.partition_alpha,
        cfg.fed.client_num_in_total, dev, seed=cfg.seed, synthetic=True,
        num_classes=cfg.num_classes, synthetic_num=CIFAR_SIZE)
    model = create_model(cfg.model, tuple(fed.X_train.shape[2:]),
                         cfg.num_classes)
    trainer = LocalTrainer(model, cfg.optim, dev,
                           torch.Generator(device=dev).manual_seed(cfg.seed),
                           num_classes=cfg.num_classes)
    return create_engine(cfg.algorithm, cfg, fed, trainer), info


def tables_of(engine) -> int:
    """fused_sgd's 32-leaf tables for the engine's model."""
    from neuroimagedisttraining_tpu_torch.ops.fused_update import MAX_LEAVES

    leaves = len(list(engine.trainer.model.parameters()))
    return -(-leaves // MAX_LEAVES)


def kth_select_at(n: int, gen, dev, time_ms, quick: bool) -> dict:
    """``kth_largest`` (row ``kth_select``) over ``n`` scores at dense ratio
    0.5: on the card bit-equal to the host's plain loop on the four kinds
    of scores, with no host sync, in at most 6 device operations; its time
    beside ``torch.topk``'s and its byte bound."""
    import torch

    from neuroimagedisttraining_tpu_torch.ops import topk as TK

    k = n // 2
    u = torch.rand(n, generator=gen, device=dev) ** 3
    kinds = {
        "uniform3": (u / u.sum(), k),
        "normal": (torch.randn(n, generator=gen, device=dev), k),
        "ties": (torch.randint(0, 50, (n,), generator=gen,
                               device=dev).to(torch.float32), k),
        "tail": (torch.exp(4.0 * torch.randn(n, generator=gen, device=dev)),
                 int(0.95 * n)),
    }
    for kind, (v, kk) in kinds.items():
        got = TK.kth_largest(v, kk).cpu()
        want = TK.kth_largest(v.cpu(), kk)
        if got.view(torch.int32) != want.view(torch.int32):
            fail(f"kth_largest at {n} scores ({kind}) on the card "
                 f"{got.item()} != plain {want.item()}")
    xs = kinds["uniform3"][0]
    del kinds, v
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    TK.kth_largest(xs, k)
    torch.cuda.set_sync_debug_mode("default")
    ops = device_ops(lambda: TK.kth_largest(xs, k))
    if len(ops) > 6:
        fail(f"kth_largest at {n} scores ran {len(ops)} device operations")
    search = math.ceil(math.log2(512 + 1))
    b_ms, b_by = bound_ms(4.0 * (n + 1), n * (2 + 4 * search))
    out = {"n": n, "k": k, "kinds_bit_equal": ["normal", "tail", "ties",
                                               "uniform3"],
           "device_ops": len(ops) or None, "bound_ms": b_ms,
           "bound_by": b_by, "equals_topk": bool(
               TK.kth_largest(xs, k) == torch.topk(xs, k).values[-1])}
    if not quick:
        out["ms"], out["host_ms"] = time_ms(lambda: TK.kth_largest(xs, k),
                                            20)
        out["plain_ms"], _ = time_ms(lambda: TK.kth_largest_plain(xs, k), 5)
        out["library_ms"], _ = time_ms(
            lambda: torch.topk(xs, k).values[-1], 20)
    del xs, u
    free_card()
    return out


def vision_cfg(algorithm: str, model: str, kernels: bool = True,
               rounds: int = 1):
    """A run on the CLI's synthetic vision cohort (256 training and 96 test
    32x32x3 images, 10 classes) over 4 clients, batch 16, 1 epoch."""
    return parse_cfg([
        "--algorithm", algorithm, "--dataset", "synthetic_vision",
        "--model", model, "--client_num_in_total", "4", "--batch_size", "16",
        "--epochs", "1", "--comm_round", str(rounds),
        *(["--fused_update"] if kernels else [])])


def vision_phase(card, dev, build_experiment, by_path: dict) -> None:
    """The 2D vision path on the card, each run with the launch counters set
    to 0 just before and read just after:

    - the main path, the CIFAR sweep (``CIFAR_SWEEP``: ResNet-18 with
      GroupNorm, SalientGrads, 100 clients at Dirichlet 0.3, frac 0.1,
      batch 16, 2 epochs, dense ratio 0.5, ``--fused_update``) for 1 round
      on the synthetic cohort at CIFAR-10's size: ``fused_sgd`` 2 launches
      a table a local step (two tables: 4), ``kth_select`` launched for the
      one global mask, no ``stem_dw``, the mask's density within 0.01 of
      0.5, finite losses and metrics; its phase-1 and round seconds, peak
      memory and ``fused_sgd``'s host table time a step;
    - one FedAvg round of every other 2D model but the DARTS family
      (``darts_phase``) on the CLI's synthetic vision cohort: ``fused_sgd``
      2 a table a local step, no other kernel, finite losses, its round
      seconds;
    - SalientGrads and FedAvg on ``cnn_cifar10`` and ``resnet18`` on that
      cohort (2 rounds) through the kernels and the plain paths under
      deterministic cuDNN, held as the 3D engines' small input is: every
      ``fused_sgd`` call against its plain version (``PerCallCheck``), two
      kernel runs bit-equal, the first round's train loss rtol 1e-4, the
      weights within 1e-3 (SalientGrads, one mask) or 5e-2 (FedAvg) of the
      largest weight change, the evaluation loss rtol 1e-3 / 2e-2. Where
      the clip is taken the kernel's norm (float64) and the plain one
      (float32) round apart, and a max pool's tied window or a ReLU input
      at the rounding level carries that into the next round: FedAvg's
      second round starts from weights held at 5e-2 of the change, so its
      loss is held at the evaluation loss's rtol 2e-2 (on an H100 80GB
      HBM3 at 700 W, ``cnn_cifar10``'s differed by 1.7e-4). All four runs
      print before any check fails."""
    import torch

    from neuroimagedisttraining_tpu_torch.models import MODELS_2D
    from neuroimagedisttraining_tpu_torch.ops import _cuda

    # ---- the main path: the CIFAR sweep on ResNet-18 ----
    t0 = time.perf_counter()
    engine, info = cifar_sweep_engine(dev)
    setup_s = time.perf_counter() - t0
    cfg, tables = engine.cfg, tables_of(engine)
    steps = local_steps(engine)
    data_gb = sum(t.numel() * t.element_size() for t in (
        engine.data.X_train, engine.data.X_test)) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_counts()
    t0 = time.perf_counter()
    with TableTimer() as table:
        result = engine.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = _cuda.counts()
    by_path["salientgrads_resnet18"] = got
    losses = [h["train_loss"] for h in result["history"]]
    metrics = [result[w][m] for w in ("final_global", "final_personal")
               for m in ("acc", "loss", "auc")]
    print(json.dumps({
        "vision_main_path": "salientgrads resnet18 cifar10-size", "card": card,
        "clients": engine.num_clients, "images_a_client":
            sorted(set(info["train_counts"])), "data_gb": data_gb,
        "setup_seconds": setup_s, "train_seconds": train_s,
        "phase1_seconds": result["phase1_seconds"],
        "round_seconds": [h["round_seconds"] for h in result["history"]],
        "train_loss": losses, "mask_density": result["mask_density"],
        "final_global": result["final_global"],
        "final_personal": result["final_personal"], "launches": got,
        "local_steps": steps, "fused_sgd_tables": tables,
        "fused_sgd_table": table.summary(),
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    if got.get("fused_sgd", 0) != 2 * tables * steps:
        fail(f"resnet18: fused_sgd launched {got.get('fused_sgd')} kernels "
             f"in {steps} local steps, not {2 * tables} a step")
    if not got.get("kth_select", 0) > 0:
        fail("the CIFAR sweep never launched the kth_select kernel")
    if got.get("stem_dw", 0) or got.get("stem_dw_bf16", 0):
        fail(f"the 2D path launched a stem_dw kernel: {got}")
    if abs(result["mask_density"] - cfg.sparsity.dense_ratio) > 0.01:
        fail(f"resnet18 mask density {result['mask_density']}")
    if not all(math.isfinite(v) for v in losses + metrics):
        fail(f"resnet18: non-finite losses or metrics {losses} {metrics}")
    del engine, result
    free_card()

    # ---- every other 2D model but the DARTS family (darts_phase): one
    # FedAvg round ----
    for name in MODELS_2D:
        if name == "resnet18" or name in DARTS_SCORES:
            continue
        r = drive(build_experiment, vision_cfg("fedavg", name), dev)
        got, res, steps = r["launches"], r["result"], r["steps"]
        tables = tables_of(r["engine"])
        by_path[f"fedavg_{name}"] = got
        losses = [h["train_loss"] for h in res["history"]]
        print(json.dumps({
            "vision_zoo": name, "card": card, "launches": got,
            "local_steps": steps, "leaves": len(res["params"]),
            "fused_sgd_tables": tables,
            "round_seconds": res["round_seconds"],
            "finetune_seconds": res["finetune_seconds"],
            "peak_memory_gb": r["peak_memory_gb"], "train_loss": losses}))
        if got.get("fused_sgd", 0) != 2 * tables * steps:
            fail(f"{name}: fused_sgd {got.get('fused_sgd')} in {steps} "
                 f"steps of {tables} tables")
        if any(v for k, v in got.items() if k != "fused_sgd"):
            fail(f"{name}: a kernel other than fused_sgd launched: {got}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"{name}: non-finite losses {losses}")
        del r, res
        free_card()

    # ---- SalientGrads and FedAvg: kernels against plain paths ----
    det0 = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    per_call = PerCallCheck()
    faults = []
    for model in ("cnn_cifar10", "resnet18"):
        for algorithm in ("salientgrads", "fedavg"):
            def small(kernels):
                return build_experiment(vision_cfg(algorithm, model, kernels,
                                                   rounds=2), "cuda")[0]
            probe = small(True)
            init_p, init_b = probe.init_global_state()
            kw = {}
            if algorithm == "salientgrads":
                kw["masks"], _ = probe.generate_global_mask(init_p, init_b)
            plain = small(False).train(**kw)
            per_call.reset()
            with per_call:
                kern = small(True).train(**kw)
            calls = per_call.check(f"{algorithm} {model} small input",
                                   stem=False)
            again = small(True).train(**kw)
            if not states_bit_equal(kern, again):
                fail(f"{algorithm} {model}: two runs through the kernels "
                     "differ")
            moved = max(float((v - init_p[k]).abs().max())
                        for k, v in plain["params"].items())
            p_err = max(float((kern["params"][k] - v).abs().max())
                        for k, v in plain["params"].items())
            lp = [h["train_loss"] for h in plain["history"]]
            lk = [h["train_loss"] for h in kern["history"]]
            ep = plain["final_global"]["loss"]
            ek = kern["final_global"]["loss"]
            sg = algorithm == "salientgrads"
            print(json.dumps({"vision_small_input_check": {
                "engine": algorithm, "model": model, "card": card,
                "train_loss_plain": lp, "train_loss_kernels": lk,
                "eval_loss_plain": ep, "eval_loss_kernels": ek,
                "param_max_abs_err": p_err, "largest_weight_change": moved,
                "per_call": calls}}))
            rtol = [1e-4] + [1e-4 if sg else 2e-2] * (len(lp) - 1)
            if not all(abs(a - b) <= r * abs(b)
                       for a, b, r in zip(lk, lp, rtol)):
                faults.append(f"{algorithm} {model} small-input train "
                              f"losses {lk} vs plain {lp}")
            if not p_err <= (1e-3 if sg else 5e-2) * moved:
                faults.append(f"{algorithm} {model} small-input params "
                              f"differ by {p_err} (largest weight change "
                              f"{moved})")
            if not abs(ek - ep) <= (1e-3 if sg else 2e-2) * abs(ep):
                faults.append(f"{algorithm} {model} small-input eval loss "
                              f"{ek} vs plain {ep}")
    if faults:
        fail("; ".join(faults))
    torch.backends.cudnn.deterministic = det0
    free_card()


#: the DARTS path's main run: the CIFAR sweep (``CIFAR_SWEEP``) on the
#: DARTS_V2 network at full width (C=36, 20 cells, 919 leaves: 29 of
#: fused_sgd's 32-leaf tables), 1 epoch and 1 round of 5 clients (the
#: sweep's frac 0.1 halved: a step is ~0.25-0.5 s of host dispatch, and
#: the whole smoke must stay well inside its limit on a slow host)
DARTS_SWEEP = ("--algorithm", "salientgrads", "--dataset", "cifar10",
               "--model", "darts", "--partition_method", "dir",
               "--partition_alpha", "0.3", "--client_num_in_total", "100",
               "--frac", "0.05", "--comm_round", "1", "--batch_size", "16",
               "--epochs", "1", "--lr", "0.01", "--dense_ratio", "0.5",
               "--itersnip_iteration", "1", "--fused_update", "--ci", "1")
#: the DARTS models' maskable scores (conv and dense kernels) at 10
#: classes
DARTS_SCORES = {"darts": 3_308_940, "fednas_v1": 4_226_076,
                "darts_search": 1_930_512}


class CallTimer:
    """Inside ``with``, the host time of every call of ``module.name``
    (the call's own wall time, queueing only where it launches), and the
    calls."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls, self.seconds = 0, 0.0

    def _call(self, *a, **kw):
        t = time.perf_counter()
        out = self.orig(*a, **kw)
        self.seconds += time.perf_counter() - t
        self.calls += 1
        return out

    def __enter__(self):
        setattr(self.module, self.name, self._call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms_per_call(self) -> float:
        return 1e3 * self.seconds / max(self.calls, 1)


def device_kernel_ms(fn) -> tuple[float, float]:
    """``(all kernels, fused_sgd's kernels)``: the device milliseconds of
    the kernels ``fn`` runs (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = fused = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            total += t / 1e3
            fused += t / 1e3 if "fused_sgd" in e.key else 0.0
    return total, fused


def darts_step_split(engine, repeats: int = 2, steps: int = 4) -> dict:
    """``steps`` local steps of the engine's largest client, timed: the wall
    ms of a local step (host clock, the card synced after; the least of
    ``repeats`` runs after a warm-up), the kernels' device ms a step
    (``torch.profiler``, one more run), and ``fused_sgd``'s part: the host
    ms of its call a step (its table and its launches) and its kernels'
    device ms a step. These run with capture off (eager steps: a replay
    calls no wrapper); ``step_wall_ms_graphed`` is the same steps' wall ms
    as graph replays, the default."""
    import torch

    from neuroimagedisttraining_tpu_torch.core import optim

    import numpy as np

    tr, cfg = engine.trainer, engine.cfg
    capture = tr.capture_steps
    c = int(np.argmax(engine.n_train))
    B = cfg.optim.batch_size
    n = min(int(engine.n_train[c]), steps * B)
    X, y = engine.data.X_train[c], engine.data.y_train[c]
    p, b = engine.init_global_state()
    lr = engine.round_lr(0)
    steps = math.ceil(n / B)

    def run():
        return tr.local_train(p, b, X, y, n, lr, 1, B, engine.max_samples)

    def walls_ms() -> float:
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(repeats):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        return 1e3 * min(walls) / steps

    tr.capture_steps = False
    try:
        with CallTimer(optim, "fused_sgd_step") as fused:
            wall_ms = walls_ms()
        dev_ms, fused_dev_ms = device_kernel_ms(run)
    finally:
        tr.capture_steps = capture
    out = {"client_rows": n, "steps": steps, "step_wall_ms": wall_ms,
           "step_device_ms": dev_ms / steps,
           "fused_sgd_host_ms_per_step": fused.ms_per_call(),
           "fused_sgd_device_ms_per_step": fused_dev_ms / steps,
           "step_wall_ms_graphed": walls_ms()}
    out["fused_sgd_host_share_of_step"] = (
        out["fused_sgd_host_ms_per_step"] / wall_ms)
    return out


def narrow_darts_engine(dev, algorithm: str, kernels: bool, rounds: int = 2):
    """``algorithm`` on a narrow DARTS_V2 network (C=8, 5 cells) on the CLI's
    synthetic vision cohort (4 clients, batch 16, 1 epoch), through
    ``federate_vision``, ``LocalTrainer`` and ``create_engine``; the fused
    step where ``kernels``."""
    import torch

    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.data.vision import federate_vision
    from neuroimagedisttraining_tpu_torch.engines import create_engine
    from neuroimagedisttraining_tpu_torch.models.darts import (
        DARTS_V2, DartsNetwork,
    )

    cfg = vision_cfg(algorithm, "darts", kernels, rounds=rounds)
    d = cfg.data
    fed, _ = federate_vision("cifar10", d.data_dir, "dir", d.partition_alpha,
                             cfg.fed.client_num_in_total, dev, seed=cfg.seed,
                             synthetic=True, num_classes=cfg.num_classes)
    model = DartsNetwork(genotype=DARTS_V2, c=8, layers=5,
                         num_classes=cfg.num_classes)
    trainer = LocalTrainer(model, cfg.optim, dev,
                           torch.Generator(device=dev).manual_seed(cfg.seed),
                           num_classes=cfg.num_classes)
    return create_engine(algorithm, cfg, fed, trainer)


def darts_drivers(card, dev, by_path: dict) -> None:
    """``DartsSearch`` on ``darts_search`` (C=16, 8 cells, batch 16) for 3
    steps first order and 2 unrolled, and ``DartsTrainer`` on ``darts``
    with the auxiliary head for 3 steps at drop-path 0.2 over 4 total
    steps, on random 32x32x3 images: finite losses, alphas and weights
    that move, a derived genotype, BatchNorm stats that move, and
    ``fused_sgd`` 2 launches a table a step (the launch counters set to 0
    just before each run and read just after)."""
    import torch

    from neuroimagedisttraining_tpu_torch.models import darts as D
    from neuroimagedisttraining_tpu_torch.ops import _cuda
    from neuroimagedisttraining_tpu_torch.ops.fused_update import MAX_LEAVES

    gen = torch.Generator(device=dev).manual_seed(3)

    def batch():
        return (torch.randn((16, 3, 32, 32), generator=gen, device=dev),
                torch.randint(0, 10, (16,), generator=gen, device=dev))

    for unrolled, steps in ((False, 3), (True, 2)):
        net = D.DartsSearchNet(num_classes=10).to(dev)
        search = D.DartsSearch(net, 10, unrolled=unrolled, total_steps=10)
        state = search.init(torch.Generator().manual_seed(0))
        a0 = {k: state["params"][k].clone() for k in D.ARCH_KEYS}
        w0 = state["params"]["Dense_0.weight"].clone()
        batches = [(batch(), batch()) for _ in range(steps)]
        torch.cuda.synchronize()
        _cuda.reset_counts()
        t0 = time.perf_counter()
        losses = [float(search.step(state, tb, vb)[1]) for tb, vb in batches]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _cuda.counts()
        path = f"darts_search_driver{'_unrolled' if unrolled else ''}"
        by_path[path] = got
        tables = -(-(len(state["params"]) - 2) // MAX_LEAVES)
        moved = all(not torch.equal(state["params"][k], a0[k])
                    for k in D.ARCH_KEYS)
        geno = search.genotype(state)
        print(json.dumps({"darts_search_driver": {
            "unrolled": unrolled, "card": card, "steps": steps,
            "losses": losses, "seconds_per_step": secs / steps,
            "launches": got, "fused_sgd_tables": tables,
            "genotype_normal": geno.normal}}))
        if got.get("fused_sgd", 0) != 2 * tables * steps:
            fail(f"DartsSearch (unrolled {unrolled}): fused_sgd {got} in "
                 f"{steps} steps of {tables} tables")
        if not all(math.isfinite(v) for v in losses) or not moved or \
                torch.equal(state["params"]["Dense_0.weight"], w0):
            fail(f"DartsSearch (unrolled {unrolled}): losses {losses}, "
                 f"alphas moved {moved}")
        if len(geno.normal) != 8 or any(op == "none" for op, _ in
                                        geno.normal + geno.reduce):
            fail(f"DartsSearch derived a malformed genotype {geno}")
        del net, search, state
    net = D.DartsNetwork(num_classes=10, auxiliary=True).to(dev)
    trainer = D.DartsTrainer(net, 10, total_steps=4)
    state = trainer.init(torch.Generator().manual_seed(0))
    b0 = {k: v.clone() for k, v in state["bstats"].items()}
    batches = [batch() for _ in range(3)]
    torch.cuda.synchronize()
    _cuda.reset_counts()
    t0 = time.perf_counter()
    losses = [float(trainer.step(state, bt, gen)[1]) for bt in batches]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _cuda.counts()
    by_path["darts_trainer_driver"] = got
    tables = -(-len(state["params"]) // MAX_LEAVES)
    print(json.dumps({"darts_trainer_driver": {
        "card": card, "steps": 3, "losses": losses,
        "seconds_per_step": secs / 3, "launches": got,
        "fused_sgd_tables": tables,
        "drop_prob_last_step": trainer.drop_prob(2)}}))
    if got.get("fused_sgd", 0) != 2 * tables * 3:
        fail(f"DartsTrainer: fused_sgd {got} in 3 steps of {tables} tables")
    if not all(math.isfinite(v) for v in losses) or all(
            torch.equal(state["bstats"][k], b0[k]) for k in b0):
        fail(f"DartsTrainer: losses {losses} or BatchNorm stats that did "
             "not move")
    del net, trainer, state
    free_card()


def darts_phase(card, dev, build_experiment, by_path: dict) -> None:
    """The DARTS family on the card, each run with the launch counters set
    to 0 just before and read just after:

    - the fp32 contract: with TF32 and cuDNN's default algorithms switched
      on, the main path's engine built through ``federate_vision``,
      ``create_model``, ``LocalTrainer`` and ``create_engine`` (no
      ``build_experiment``, no ``resolve_device``) must have switched them
      off before its first step;
    - the main path, the CIFAR sweep on ``darts`` at full width
      (``DARTS_SWEEP``: DARTS_V2, C=36, 20 cells, SalientGrads, 100 clients
      at Dirichlet 0.3, frac 0.05, batch 16, 1 epoch, 1 round, dense ratio
      0.5) on the synthetic cohort at CIFAR-10's size: ``kth_select``
      launched for the one global mask over 3,308,940 scores, ``fused_sgd``
      2 launches a table a local step (29 tables: 58), no ``stem_dw``, the
      mask's density within 0.01 of 0.5, finite losses and metrics; its
      phase-1 and round seconds, peak memory, ``fused_sgd``'s host table ms
      a step, and one client's local step split (wall and device ms,
      ``fused_sgd``'s host and device ms);
    - one FedAvg round of ``fednas_v1`` and of ``darts_search`` on the CLI's
      synthetic vision cohort (4 clients, batch 16): ``fused_sgd`` 2 a
      table a local step (39 and 44 tables), finite, and the search net's
      local step split;
    - SalientGrads on a narrow DARTS_V2 (C=8, 5 cells) through the kernels
      and the plain paths under deterministic cuDNN, held as
      ``vision_phase`` holds ``cnn_cifar10`` and ``resnet18``: every
      ``fused_sgd`` call against its plain version (``PerCallCheck``), two
      kernel runs bit-equal, the train losses rtol 1e-4, the weights within
      1e-3 of the largest weight change, the evaluation loss rtol 1e-3;
    - the drivers (``darts_drivers``)."""
    import torch

    from neuroimagedisttraining_tpu_torch.ops import _cuda

    spent, mark = {}, [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        spent[part] = now - mark[0]
        mark[0] = now

    # ---- the fp32 contract without build_experiment ----
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    cudnn.deterministic, cudnn.benchmark = False, True
    t0 = time.perf_counter()
    engine, info = cifar_sweep_engine(dev, DARTS_SWEEP)
    setup_s = time.perf_counter() - t0
    contract = {"cudnn.allow_tf32": cudnn.allow_tf32,
                "matmul.allow_tf32": matmul.allow_tf32,
                "cudnn.deterministic": cudnn.deterministic,
                "cudnn.benchmark": cudnn.benchmark}
    print(json.dumps({"darts_fp32_contract_before_first_step": contract}))
    if contract != {"cudnn.allow_tf32": False, "matmul.allow_tf32": False,
                    "cudnn.deterministic": True, "cudnn.benchmark": False}:
        fail(f"an engine built without build_experiment runs outside the "
             f"fp32 contract: {contract}")

    # ---- the main path: the CIFAR sweep on darts at full width ----
    cfg, tables = engine.cfg, tables_of(engine)
    steps = local_steps(engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_counts()
    t0 = time.perf_counter()
    with TableTimer() as table:
        result = engine.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = _cuda.counts()
    by_path["salientgrads_darts"] = got
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    split = darts_step_split(engine)
    losses = [h["train_loss"] for h in result["history"]]
    metrics = [result[w][m] for w in ("final_global", "final_personal")
               for m in ("acc", "loss", "auc")]
    print(json.dumps({
        "darts_main_path": "salientgrads darts cifar10-size", "card": card,
        "clients": engine.num_clients, "leaves": len(result["params"]),
        "setup_seconds": setup_s, "train_seconds": train_s,
        "phase1_seconds": result["phase1_seconds"],
        "round_seconds": [h["round_seconds"] for h in result["history"]],
        "train_loss": losses, "mask_density": result["mask_density"],
        "final_global": result["final_global"],
        "final_personal": result["final_personal"], "launches": got,
        "local_steps": steps, "fused_sgd_tables": tables,
        "fused_sgd_table": table.summary(), "peak_memory_gb": peak,
        "step_split": split}))
    if tables != 29:
        fail(f"darts has {tables} fused_sgd tables, not 29")
    if got.get("fused_sgd", 0) != 2 * tables * steps:
        fail(f"darts: fused_sgd launched {got.get('fused_sgd')} kernels in "
             f"{steps} local steps, not {2 * tables} a step")
    if not got.get("kth_select", 0) > 0:
        fail("the DARTS sweep never launched the kth_select kernel")
    if got.get("stem_dw", 0) or got.get("stem_dw_bf16", 0):
        fail(f"the DARTS path launched a stem_dw kernel: {got}")
    if abs(result["mask_density"] - cfg.sparsity.dense_ratio) > 0.01:
        fail(f"darts mask density {result['mask_density']}")
    if not all(math.isfinite(v) for v in losses + metrics):
        fail(f"darts: non-finite losses or metrics {losses} {metrics}")
    del engine, result
    free_card()
    lap("main_path")

    # ---- fednas_v1 and darts_search: one FedAvg round each ----
    for name, want_tables in (("fednas_v1", 39), ("darts_search", 44)):
        r = drive(build_experiment, vision_cfg("fedavg", name), dev)
        got, res, steps = r["launches"], r["result"], r["steps"]
        tables = tables_of(r["engine"])
        by_path[f"fedavg_{name}"] = got
        extra = ({"step_split": darts_step_split(r["engine"], steps=2)}
                 if name == "darts_search" else {})
        losses = [h["train_loss"] for h in res["history"]]
        print(json.dumps({
            "darts_zoo": name, "card": card, "launches": got,
            "local_steps": steps, "leaves": len(res["params"]),
            "fused_sgd_tables": tables, "round_seconds": res["round_seconds"],
            "finetune_seconds": res["finetune_seconds"],
            "peak_memory_gb": r["peak_memory_gb"], "train_loss": losses,
            **extra}))
        if tables != want_tables:
            fail(f"{name} has {tables} fused_sgd tables, not {want_tables}")
        if got.get("fused_sgd", 0) != 2 * tables * steps:
            fail(f"{name}: fused_sgd {got.get('fused_sgd')} in {steps} "
                 f"steps of {tables} tables")
        if any(v for k, v in got.items() if k != "fused_sgd"):
            fail(f"{name}: a kernel other than fused_sgd launched: {got}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"{name}: non-finite losses {losses}")
        del r, res
        free_card()
        lap(f"fedavg_{name}")

    # ---- a narrow DARTS: kernels against plain paths ----
    det0 = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    per_call = PerCallCheck()
    probe = narrow_darts_engine(dev, "salientgrads", True)
    init_p, init_b = probe.init_global_state()
    masks, _ = probe.generate_global_mask(init_p, init_b)
    plain = narrow_darts_engine(dev, "salientgrads", False).train(masks=masks)
    per_call.reset()
    with per_call:
        kern = narrow_darts_engine(dev, "salientgrads", True).train(masks=masks)
    calls = per_call.check("salientgrads narrow darts small input",
                           stem=False)
    again = narrow_darts_engine(dev, "salientgrads", True).train(masks=masks)
    if not states_bit_equal(kern, again):
        fail("salientgrads narrow darts: two runs through the kernels "
             "differ")
    moved = max(float((v - init_p[k]).abs().max())
                for k, v in plain["params"].items())
    p_err = max(float((kern["params"][k] - v).abs().max())
                for k, v in plain["params"].items())
    lp = [h["train_loss"] for h in plain["history"]]
    lk = [h["train_loss"] for h in kern["history"]]
    ep, ek = plain["final_global"]["loss"], kern["final_global"]["loss"]
    print(json.dumps({"darts_small_input_check": {
        "engine": "salientgrads", "model": "darts C=8 5 cells",
        "card": card, "train_loss_plain": lp, "train_loss_kernels": lk,
        "eval_loss_plain": ep, "eval_loss_kernels": ek,
        "param_max_abs_err": p_err, "largest_weight_change": moved,
        "per_call": calls}}))
    faults = []
    if not all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lk, lp)):
        faults.append(f"narrow darts train losses {lk} vs plain {lp}")
    if not p_err <= 1e-3 * moved:
        faults.append(f"narrow darts params differ by {p_err} (largest "
                      f"weight change {moved})")
    if not abs(ek - ep) <= 1e-3 * abs(ep):
        faults.append(f"narrow darts eval loss {ek} vs plain {ep}")
    if faults:
        fail("; ".join(faults))
    torch.backends.cudnn.deterministic = det0
    del probe, plain, kern, again
    free_card()
    lap("small_input")

    # ---- the drivers ----
    darts_drivers(card, dev, by_path)
    lap("drivers")
    print(json.dumps({"darts_phase_seconds": spent}))


#: the defended round's runs on the flagship model (defense_phase): 48
#: subjects over 6 sites (the synthetic cohort draws max(4, clients / 4)
#: sites: 24 clients in total gives 6 site clients, all sampled)
DEFENSE_SITES = ("--client_num_in_total", "24")
#: the residual scores of one flagship upload: 2,570,241 parameters and
#: 1,408 BatchNorm statistics
CODEC_SCORES = 2_571_649


def defense_cfg(algorithm: str, *extra: str):
    """The defended cells' configuration: AlexNet3D at 121x145x121, batch
    16, ``--fused_update``, 48 subjects over 6 site clients, 1 round, then
    ``extra``."""
    import argparse

    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, config_from_args,
    )

    return config_from_args(add_args(argparse.ArgumentParser()).parse_args([
        "--algorithm", algorithm, "--dataset", "synthetic",
        "--model", "3DCNN", "--synthetic_shape", "121", "145", "121",
        "--synthetic_num_subjects", "48", *DEFENSE_SITES,
        "--batch_size", "16", "--itersnip_iteration", "1",
        "--epochs", "1", "--comm_round", "1", "--fused_update", *extra]))


def synced_ms(fn, out: list):
    """``fn`` timed on the host around two device syncs, ms into ``out``."""
    import torch

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
        return r
    return timed


def defended_run(card, build_experiment, by_path: dict, tag: str,
                 algorithm: str, *extra: str, hook=None) -> dict:
    """One defended cell (``defense_cfg``) through ``build_experiment`` and
    ``engine.train()``, the launch counters set to 0 just before and read
    just after (into ``by_path[tag]``), with the round tail, the codec
    stage, the host's frame encode and the secure fold each timed
    (``synced_ms``); ``hook(engine)`` runs before the training. Fails
    unless the losses, metrics and weights are finite and ``stem_dw``
    launched 3 times and ``fused_sgd`` 2 a local step (or SNIP pass).
    Returns the engine, its result and the printed row."""
    import torch

    from neuroimagedisttraining_tpu_torch.ops import _cuda

    engine, _ = build_experiment(defense_cfg(algorithm, *extra), "cuda")
    tail_ms, codec_ms, wire_ms, fold_ms = [], [], [], []
    engine.defended_aggregate = synced_ms(engine.defended_aggregate, tail_ms)
    engine.codec_stage = synced_ms(engine.codec_stage, codec_ms)
    engine.account_wire_bytes = synced_ms(engine.account_wire_bytes,
                                          wire_ms)
    engine.secure_quant_aggregate = synced_ms(engine.secure_quant_aggregate,
                                              fold_ms)
    if hook is not None:
        hook(engine)
    steps = local_steps(engine)
    # SalientGrads' phase 1: one IterSNIP pass a client with rows
    snips = (int((engine.n_train > 0).sum())
             if algorithm == "salientgrads" else 0)
    torch.cuda.synchronize()
    _cuda.reset_counts()
    t0 = time.perf_counter()
    res = engine.train()
    torch.cuda.synchronize()
    got = _cuda.counts()
    by_path[tag] = got
    losses = [h["train_loss"] for h in res["history"]]
    final = res.get("final_global") or res["final_personal"]
    out = {"run": tag, "card": card, "launches": got,
           "local_steps": steps, "train_seconds": time.perf_counter() - t0,
           "tail_ms": tail_ms, "codec_ms": codec_ms,
           # the host's frame encode and byte count, inside codec_ms
           "wire_bytes_ms": wire_ms, "fold_ms": fold_ms,
           "nonfinite_uploads": engine.stat_info["nonfinite_uploads"],
           "round_seconds": res.get("round_seconds") or [
               h.get("round_seconds") for h in res["history"]],
           "train_loss": losses}
    if not all(math.isfinite(v) for v in losses
               + [final[m] for m in ("acc", "loss", "auc")]):
        fail(f"{tag}: non-finite losses or metrics {losses} {final}")
    state = res.get("params") or res.get("global_params")
    if not all(bool(torch.isfinite(v).all()) for v in state.values()):
        fail(f"{tag}: non-finite weights")
    if got.get("stem_dw", 0) != 3 * (steps + snips) or \
            got.get("fused_sgd", 0) != 2 * steps:
        fail(f"{tag}: launches {got} in {steps} local steps and {snips} "
             "SNIP passes, not stem_dw 3 a step or pass and fused_sgd 2 "
             "a step")
    return {"engine": engine, "result": res, "row": out}


def defense_phase(card, dev, build_experiment, by_path: dict, rows: list,
                  time_ms) -> None:
    """The defended aggregation tail at the flagship width (AlexNet3D,
    121x145x121, batch 16, ``--fused_update``, ``NIDT_FAST_STEM=1``, 48
    subjects over 6 sites, 1 round unless stated), each run with the launch
    counters set to 0 just before and read just after:

    - ``--fault_spec byz:1@0:sign_flip`` against each of the 8
      ``--defense_type`` values on FedAvg: finite losses, no rejected
      upload, ``stem_dw`` 3 and ``fused_sgd`` 2 launches a local step as an
      undefended run, no top-k; the round tail's device ms (attack, guard,
      defense, aggregation: ``defended_aggregate`` synchronized around);
      then ``byz:2@0:nonfinite`` (one upload rejected, finite weights);
    - the wire codec, ``--wire_codec delta+sparse+quant`` on FedAvg for 2
      rounds (error feedback carried): one ``kth_select`` a client a round
      over the upload's 2,571,649 residual scores at k = 25%, each call
      held against its plain version on its own input (equal thresholds,
      equal keep counts; NaN for NaN) and its keep count beside the exact
      k-th largest's (``torch.topk``), the codec stage's device ms a
      client apart from the host's frame encode,
      ``sum_comm_bytes`` against ``sum_comm_bytes_dense``; then the same
      under ``byz:2@0:nonfinite`` (the NaN row's select); then
      SalientGrads with the codec (the mask handoff: no select beyond the
      phase-1 mask's); ``kth_select`` alone on a captured residual vector
      against ``torch.topk`` and its byte bound;
    - DP: D-PSGD with ``--dp_clip 1 --dp_sigma 1`` and FedAvg with
      ``--defense weak_dp``: ``epsilon_per_round`` equal to the host
      accountant's for the run's q and z;
    - crashes: FedAvg with ``--fault_spec crash:2@0``: only survivors
      train."""
    import functools

    import numpy as np
    import torch

    from neuroimagedisttraining_tpu_torch.codec import device as CD
    from neuroimagedisttraining_tpu_torch.codec.wire import WireSpec
    from neuroimagedisttraining_tpu_torch.core.robust import DEFENSES
    from neuroimagedisttraining_tpu_torch.ops import topk as TK
    from neuroimagedisttraining_tpu_torch.privacy import accountant as acct

    spent, mark = {}, [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        spent[part] = now - mark[0]
        mark[0] = now

    run = functools.partial(defended_run, card, build_experiment, by_path)

    # ---- attacks against defenses ----
    defenses = {}
    for defense in DEFENSES:
        r = run(f"fedavg_{defense}", "fedavg", "--fault_spec",
                "byz:1@0:sign_flip", "--defense", defense)
        row = r["row"]
        print(json.dumps({"defense_run": defense, **row}))
        if row["nonfinite_uploads"] != 0:
            fail(f"{defense}: {row['nonfinite_uploads']} uploads rejected")
        if row["launches"].get("kth_select", 0):
            fail(f"{defense}: a top-k select launched")
        defenses[defense] = row["tail_ms"]
        del r
        free_card()
    r = run("fedavg_nonfinite", "fedavg", "--fault_spec",
            "byz:2@0:nonfinite", "--defense", "trimmed_mean")
    print(json.dumps({"defense_run": "trimmed_mean nonfinite", **r["row"]}))
    if r["row"]["nonfinite_uploads"] != 1:
        fail(f"byz:2@0:nonfinite rejected {r['row']['nonfinite_uploads']} "
             "uploads, not 1")
    del r
    lap("defenses")

    # ---- the wire codec: kth_select on the residuals ----
    checks, captured = [], []

    def checked(x, k):
        thr = TK.kth_largest(x, k)
        plain = TK.kth_largest_plain(x.contiguous(), k)
        both_nan = bool(torch.isnan(thr)) and bool(torch.isnan(plain))
        same = both_nan or torch_equal_bits(thr.reshape(1), plain.reshape(1))
        keep, keep_plain = int((x >= thr).sum()), int((x >= plain).sum())
        checks.append({"n": x.numel(), "k": k, "equal": same,
                       "nan": both_nan, "keep": keep,
                       "keep_plain": keep_plain,
                       # the exact k-th largest keeps at least k (ties)
                       "keep_exact": 0 if both_nan else int(
                           (x >= torch.topk(x, k).values[-1]).sum())})
        if len(captured) < 1 and not both_nan:
            captured.append(x.detach().clone())
        return thr

    codec_rows = {}
    for tag, extra in (("fedavg_codec", ()),
                       ("fedavg_codec_nonfinite",
                        ("--fault_spec", "byz:2@0:nonfinite"))):
        del checks[:]
        real = CD.kth_largest
        CD.kth_largest = checked
        try:
            r = run(tag, "fedavg", "--wire_codec", "delta+sparse+quant",
                    "--comm_round", "2", *extra)
        finally:
            CD.kth_largest = real
        eng, row = r["engine"], r["row"]
        clients = sum(len(eng.client_sampling(q)) for q in range(2))
        selects = row["launches"].get("kth_select", 0) // 5
        row.update({
            "selects": selects, "select_checks": len(checks),
            "selects_nan": sum(c["nan"] for c in checks),
            # entries kept beyond the exact k-th largest's support, a call
            "keep_over_exact": [c["keep"] - c["keep_exact"] for c in checks],
            "codec_device_ms_a_client": [
                (a - b) / len(eng.client_sampling(q))
                for q, (a, b) in enumerate(zip(row["codec_ms"],
                                               row["wire_bytes_ms"]))],
            "sum_comm_bytes": eng.stat_info["sum_comm_bytes"],
            "sum_comm_bytes_dense": eng.stat_info["sum_comm_bytes_dense"]})
        print(json.dumps({"codec_run": tag, **row}))
        if selects != clients or len(checks) != clients:
            fail(f"{tag}: {selects} kth_select runs ({len(checks)} checked) "
                 f"for {clients} client uploads")
        bad = [c for c in checks if not c["equal"]
               or c["keep"] != c["keep_plain"] or c["n"] != CODEC_SCORES]
        if bad:
            fail(f"{tag}: kth_select against its plain version: {bad}")
        if "nonfinite" in tag and not any(c["nan"] for c in checks):
            fail(f"{tag}: no select saw the NaN row")
        if not 0 < row["sum_comm_bytes"] < row["sum_comm_bytes_dense"]:
            fail(f"{tag}: encoded bytes {row['sum_comm_bytes']} against "
                 f"dense {row['sum_comm_bytes_dense']}")
        codec_rows[tag] = row
        del r, eng
        free_card()
    r = run("salientgrads_codec", "salientgrads", "--wire_codec",
            "delta+sparse+quant")
    print(json.dumps({"codec_run": "salientgrads_codec", **r["row"]}))
    if r["row"]["launches"].get("kth_select", 0) != 5:
        fail(f"salientgrads with the codec launched "
             f"{r['row']['launches'].get('kth_select')} select kernels, not "
             "the phase-1 mask's 5")
    del r
    free_card()
    lap("codec")

    # the select alone on a residual vector the codec ranked
    xs = captured[0]
    k = CD.topk_count(WireSpec(sparse=True, topk_ratio=0.25), xs.numel())
    search = math.ceil(math.log2(512 + 1))
    b_ms, b_by = bound_ms(4.0 * (xs.numel() + 1),
                          xs.numel() * (2 + 4 * search))
    at = {"n": xs.numel(), "k": k, "bound_ms": b_ms, "bound_by": b_by,
          "equals_plain": torch_equal_bits(
              TK.kth_largest(xs, k).reshape(1),
              TK.kth_largest_plain(xs, k).reshape(1)),
          "equals_topk": bool(TK.kth_largest(xs, k)
                              == torch.topk(xs, k).values[-1]),
          "threshold": float(TK.kth_largest(xs, k)),
          "topk_value": float(torch.topk(xs, k).values[-1]),
          "keep": int((xs >= TK.kth_largest(xs, k)).sum()),
          "keep_exact": int((xs >= torch.topk(xs, k).values[-1]).sum())}
    at["ms"], at["host_ms"] = time_ms(lambda: TK.kth_largest(xs, k), 20)
    at["plain_ms"], _ = time_ms(lambda: TK.kth_largest_plain(xs, k), 5)
    at["library_ms"], _ = time_ms(lambda: torch.topk(xs, k).values[-1], 20)
    print(json.dumps({"kth_select_at": "codec residuals", "card": card,
                      **at}))
    if not at["equals_plain"]:
        fail("kth_select on the codec's residuals differs from its plain "
             "version")
    for row in rows:
        if row["name"] == "kth_select":
            row["codec_scores"] = {
                **at, "selects": {t: r["selects"]
                                  for t, r in codec_rows.items()},
                "codec_device_ms_a_client": codec_rows["fedavg_codec"][
                    "codec_device_ms_a_client"],
                "keep_over_exact": codec_rows["fedavg_codec"][
                    "keep_over_exact"]}
    del xs, captured
    free_card()
    lap("codec_select")

    # ---- DP: the ledgers against the host accountant ----
    r = run("dpsgd_dp", "dpsgd", "--dp_clip", "1", "--dp_sigma", "1",
            "--comm_round", "2")
    led = r["engine"].stat_info["dp"]
    rdp = np.zeros(len(acct.DEFAULT_ORDERS))
    want = []
    for _ in range(2):
        rdp = rdp + acct.rdp_gaussian(1.0, 1.0)
        want.append(round(acct.rdp_to_epsilon(rdp, delta=1e-5)[0], 4))
    print(json.dumps({"dp_run": "dpsgd", **r["row"], "ledger": led,
                      "host_epsilon_per_round": want}))
    if led["epsilon_per_round"] != want:
        fail(f"dpsgd epsilon {led['epsilon_per_round']} != host {want}")
    del r
    r = run("fedavg_weak_dp", "fedavg", "--defense", "weak_dp")
    eng = r["engine"]
    led = eng.stat_info["weak_dp"]
    sampled = eng.client_sampling(0)
    z = acct.weak_dp_noise_multiplier(0.05, 5.0, eng.n_train[sampled])
    q = len(sampled) / eng.real_clients
    want = [round(acct.rdp_to_epsilon(acct.rdp_gaussian(q, z),
                                      delta=1e-5)[0], 4)]
    print(json.dumps({"dp_run": "fedavg weak_dp", **r["row"], "ledger": led,
                      "q": q, "z": z, "host_epsilon_per_round": want}))
    if led["epsilon_per_round"] != want:
        fail(f"weak_dp epsilon {led['epsilon_per_round']} != host {want}")
    del r, eng
    lap("dp")

    # ---- crashes: only survivors train ----
    trained = []

    def record(engine):
        inner = engine.client_train

        def client_train(r, c, *a, **k):
            trained.append((r, c))
            return inner(r, c, *a, **k)
        engine.client_train = client_train

    r = run("fedavg_crash", "fedavg", "--fault_spec", "crash:2@0",
            "--comm_round", "2", hook=record)
    rounds = [c for q, c in trained if q < 2]
    print(json.dumps({"crash_run": "crash:2@0", **r["row"],
                      "trained": trained}))
    if 1 in rounds or len(rounds) != 2 * (r["engine"].num_clients - 1):
        fail(f"crash:2@0: the rounds trained clients {rounds}")
    del r
    free_card()
    lap("crash")
    print(json.dumps({"defense_phase_seconds": spent,
                      "defense_tail_ms": defenses}))


#: the secure cells' flags: an in-process cohort of 2 or more clients
#: needs the 32-bit field
SECURE = ("--secure_quant", "--secure_quant_field_bits", "32")


def secure_phase(card, build_experiment, by_path: dict) -> None:
    """Secure quantized aggregation (``--secure_quant``) at the flagship
    width, in the defended cells' configuration (``defense_cfg``: 6 site
    clients, 1 round unless stated), each run with the launch counters set
    to 0 just before and read just after:

    - FedAvg (2 rounds), FedProx, Ditto and SalientGrads through the GF(p)
      fold: finite losses, ``stem_dw`` 3 and ``fused_sgd`` 2 launches a
      local step, ``kth_select`` only in SalientGrads (5, its mask), whose
      density is within 0.01 of ``dense_ratio`` and whose aggregate is 0
      wherever the mask is 0; no host sync inside the fold (sync debug
      mode);
    - the fold of one captured FedAvg round against the host protocol:
      every client's ``encode_secure_quant`` frame (its own generator)
      folded by a ``SlotAccumulator`` at the round's integer weights,
      finalized and divided by the integer mass, equal to the card's fold
      in every bit; within one lattice step (``2^-frac_bits`` times the
      leaf's scale) of the plain weighted mean at the integer weights
      (the error against the sample-count mean printed beside it); the
      fold's and the undefended tail's device ms on those uploads, in
      turns; the host's encode and fold ms a client; a frame's bytes a
      parameter at field_bits 8, 16 and 32 against the dense float32
      upload's;
    - ``byz:2@0:nonfinite`` (one row counted, none dropped, a finite
      aggregate), ``--defense norm_diff_clipping`` and ``--defense
      weak_dp`` (its epsilon equal to the host accountant's);
    - TurboAggregate with the flag bit for bit its run without it (its
      own share stage keeps the round);
    - the startup refusals: the 16-bit field at 6 clients, the codec and
      an order-statistic defense."""
    import functools

    import numpy as np
    import torch

    from neuroimagedisttraining_tpu_torch.codec import wire
    from neuroimagedisttraining_tpu_torch.core import robust
    from neuroimagedisttraining_tpu_torch.engines.base import (
        FederatedEngine,
    )
    from neuroimagedisttraining_tpu_torch.ops.mpc_device import (
        sq_integer_weights,
    )
    from neuroimagedisttraining_tpu_torch.privacy import accountant as acct
    from neuroimagedisttraining_tpu_torch.privacy import secure_quant as SQ
    from neuroimagedisttraining_tpu_torch.weights import flax_named_leaves

    t_phase = time.perf_counter()
    run = functools.partial(defended_run, card, build_experiment, by_path)
    captured: dict = {}

    def capture(engine):
        """Keep a copy of the first round tail's inputs."""
        inner = engine.defended_aggregate

        def tail(*a):
            if not captured:
                captured["args"] = tuple(
                    [{k: v.clone() for k, v in st.items()} for st in x]
                    if isinstance(x, list) else
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in a)
            return inner(*a)
        engine.defended_aggregate = tail

    rows = {}
    for algorithm, rounds in (("fedavg", "2"), ("fedprox", "1"),
                              ("ditto", "1"), ("salientgrads", "1")):
        tag = f"{algorithm}_sq"
        r = run(tag, algorithm, *SECURE, "--comm_round", rounds,
                hook=capture if algorithm == "fedavg" else None)
        eng, res, row = r["engine"], r["result"], r["row"]
        folds = len(row["fold_ms"])
        row["sq"] = {"p": eng.sq_spec.p, "frac_bits": eng.sq_spec.frac_bits,
                     "weight_shift": eng.sq_weight_shift}
        if folds != int(rounds):
            fail(f"{tag}: {folds} folds in {rounds} rounds")
        selects = row["launches"].get("kth_select", 0)
        if algorithm == "salientgrads":
            row["mask_density"] = res["mask_density"]
            if selects != 5:
                fail(f"{tag}: {selects} kth_select launches, not its "
                     "mask's 5")
            if abs(res["mask_density"] - eng.cfg.sparsity.dense_ratio) \
                    > 0.01:
                fail(f"{tag}: mask density {res['mask_density']}")
            off = [k for k, m in res["masks"].items()
                   if bool((res["params"][k][m == 0] != 0).any())]
            if off:
                fail(f"{tag}: the aggregate is not 0 off the mask in {off}")
        elif selects:
            fail(f"{tag}: {selects} kth_select launches")
        if algorithm == "fedavg":
            args = captured["args"]
            row["fold_syncs"] = hidden_syncs(
                lambda: FederatedEngine.secure_quant_aggregate(
                    eng, *args[:5], *args[6:]))
            if row["fold_syncs"]:
                fail(f"the fold synced with the host at "
                     f"{row['fold_syncs']}")
            fedavg = eng
        print(json.dumps({"secure_run": tag, **row}))
        rows[tag] = row
        del r, eng, res
        free_card()

    # ---- one captured round: the card's fold against the host's ----
    eng = fedavg
    rnd, sampled, params_up, bstats_up, ref_p, ref_b, ns, losses = \
        captured["args"]
    spec, shift, scales = eng.sq_spec, eng.sq_weight_shift, eng.sq_scales
    fold_args = (rnd, sampled, params_up, bstats_up, ref_p, ns, losses)
    card_p, card_b, _, _ = FederatedEngine.secure_quant_aggregate(
        eng, *fold_args)
    got = {**card_p, **card_b}
    uploads = [{**p, **b} for p, b in zip(params_up, bstats_up)]
    host_up = [{k: v.cpu().numpy() for k, v in u.items()} for u in uploads]
    w = ns.cpu().numpy().astype(np.float32)
    wi = np.maximum(np.rint(w / np.float32(w.max()) * np.float32(1 << shift)),
                    np.float32(1.0)).astype(np.int64)
    denom = np.float32(wi.sum())
    acc = SQ.SlotAccumulator(spec, like=host_up[0])
    enc_ms, hfold_ms = [], []
    for c, u in enumerate(host_up):
        t = time.perf_counter()
        frame = SQ.encode_secure_quant(u, 1.0, spec,
                                       np.random.default_rng(1000 + c),
                                       scales=scales)
        enc_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        acc.fold(frame, weight_int=int(wi[c]))
        hfold_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    host = acc.finalize(like=host_up[0], rescale=1.0, scales=scales)
    final_ms = (time.perf_counter() - t) * 1e3
    host = {k: (np.asarray(v, np.float32) / denom).astype(v.dtype)
            for k, v in host.items()}
    differ = [k for k in host
              if got[k].cpu().numpy().tobytes() != host[k].tobytes()]
    wi_dev = sq_integer_weights(ns, shift)
    if wi_dev.cpu().numpy().astype(np.int64).tolist() != wi.tolist():
        fail(f"integer weights: card {wi_dev.tolist()}, host {wi.tolist()}")
    step = {k: scales[k] * 2.0 ** -spec.frac_bits for k in got}
    plain_wi = robust.weighted_mean(uploads, wi_dev)
    plain_ns = robust.weighted_mean(uploads, ns.to(torch.float32))
    over_wi = max(float((got[k] - plain_wi[k]).abs().max()) / step[k]
                  for k in got)
    over_ns = max(float((got[k] - plain_ns[k]).abs().max()) / step[k]
                  for k in got)

    # the fold and the undefended tail on the same uploads, in turns
    fold_t, tail_t = [], []
    timed_fold = synced_ms(functools.partial(
        FederatedEngine.secure_quant_aggregate, eng), fold_t)
    timed_tail = synced_ms(functools.partial(
        FederatedEngine.defended_aggregate, eng), tail_t)
    for _ in range(5):
        timed_fold(*fold_args)
        eng.sq_spec = None
        timed_tail(*captured["args"])
        eng.sq_spec = spec

    # a frame's bytes a parameter against the dense float32 upload's
    pkeys = set(params_up[0])
    named = flax_named_leaves(
        {k: v for k, v in uploads[0].items() if k in pkeys},
        {k: v for k, v in uploads[0].items() if k not in pkeys})
    n_params = sum(v.size for v in named.values())
    dense = wire.frame_nbytes(wire.nest(named))
    per_param = {}
    for bits in (8, 16, 32):
        fspec = SQ.QuantSpec.from_bits(bits, 3 if bits == 8 else 10)
        nbytes = SQ.frame_nbytes(SQ.encode_secure_quant(
            named, 1.0, fspec, np.random.default_rng(bits)))
        per_param[bits] = {"bytes": nbytes,
                           "bytes_a_parameter": nbytes / n_params,
                           "of_dense": nbytes / dense}
    fold_row = {
        "fold_vs_host": "bit-equal" if not differ else differ,
        "leaves": len(got), "clients": len(uploads),
        "integer_weights": wi.tolist(), "denom": float(denom),
        "sample_counts": w.tolist(),
        "fold_err_over_lattice_vs_plain_at_integer_weights": over_wi,
        "fold_err_over_lattice_vs_plain_at_sample_counts": over_ns,
        "fold_ms": fold_t, "undefended_tail_ms": tail_t,
        "fold_ms_a_round_in_the_run": rows["fedavg_sq"]["fold_ms"],
        "host_encode_ms_a_client": enc_ms,
        "host_fold_ms_a_client": hfold_ms, "host_finalize_ms": final_ms,
        "parameters": n_params, "dense_bytes": dense,
        "dense_bytes_a_parameter": dense / n_params,
        "frame_by_field_bits": per_param}
    print(json.dumps({"secure_fold": "fedavg round 0", "card": card,
                      **fold_row}))
    if differ:
        fail(f"the card's fold differs from the host protocol's in {differ}")
    if not over_wi <= 1.0:
        fail(f"the fold is {over_wi} lattice steps from the plain mean at "
             "its integer weights")
    del captured["args"], fold_args, uploads, params_up, bstats_up, got
    del plain_wi, plain_ns, host, host_up, acc
    free_card()

    # ---- faults and clips under the fold ----
    r = run("fedavg_sq_nonfinite", "fedavg", *SECURE, "--fault_spec",
            "byz:2@0:nonfinite")
    print(json.dumps({"secure_run": "fedavg_sq_nonfinite", **r["row"]}))
    if r["row"]["nonfinite_uploads"] != 1:
        fail(f"byz:2@0:nonfinite under --secure_quant counted "
             f"{r['row']['nonfinite_uploads']} rows, not 1")
    del r
    r = run("fedavg_sq_clip", "fedavg", *SECURE, "--defense",
            "norm_diff_clipping")
    print(json.dumps({"secure_run": "fedavg_sq_clip", **r["row"]}))
    del r
    r = run("fedavg_sq_weak_dp", "fedavg", *SECURE, "--defense", "weak_dp")
    eng = r["engine"]
    led = eng.stat_info["weak_dp"]
    sampled = eng.client_sampling(0)
    z = acct.weak_dp_noise_multiplier(0.05, 5.0, eng.n_train[sampled])
    q = len(sampled) / eng.real_clients
    want = [round(acct.rdp_to_epsilon(acct.rdp_gaussian(q, z),
                                      delta=1e-5)[0], 4)]
    print(json.dumps({"secure_run": "fedavg_sq_weak_dp", **r["row"],
                      "ledger": led, "q": q, "z": z,
                      "host_epsilon_per_round": want}))
    if led["epsilon_per_round"] != want:
        fail(f"weak_dp under --secure_quant: epsilon "
             f"{led['epsilon_per_round']} != host {want}")
    del r, eng
    free_card()

    # ---- TurboAggregate keeps its own share stage ----
    ta = [run(f"turboaggregate_6{tag}", "turboaggregate", *flags)
          for tag, flags in (("", ()), ("_sq", SECURE))]
    same = states_bit_equal(ta[0]["result"], ta[1]["result"])
    print(json.dumps({"secure_run": "turboaggregate with and without",
                      "bit_equal": same,
                      "train_loss": [t["row"]["train_loss"] for t in ta],
                      "fold_ms": [t["row"]["fold_ms"] for t in ta]}))
    if not same or ta[1]["row"]["fold_ms"]:
        fail("TurboAggregate under --secure_quant is not its run without")
    del ta
    free_card()

    # ---- the startup refusals ----
    refusals = {}
    for what, flags, needle in (
            ("16-bit field", ("--secure_quant",), "field_bits 32"),
            ("codec", (*SECURE, "--wire_codec", "delta+quant"),
             "does not compose with --wire_codec"),
            ("krum", (*SECURE, "--defense", "krum"),
             "does not compose with --secure_quant")):
        try:
            build_experiment(defense_cfg("fedavg", *flags), "cuda")
        except ValueError as e:
            refusals[what] = str(e)
            if needle not in str(e):
                fail(f"{what}: refused with {e}")
        else:
            fail(f"{what}: --secure_quant was not refused")
    print(json.dumps({"secure_refusals": refusals,
                      "secure_phase_seconds":
                          time.perf_counter() - t_phase}))


def run_states(res: dict) -> list:
    """Every model state a result holds (global, personal, masks), in a
    fixed order, for bit-equality."""
    out = []
    for k in ("params", "batch_stats", "masks", "per_params", "per_bstats",
              "personal_params", "personal_batch_stats", "global_params",
              "global_batch_stats"):
        v = res.get(k)
        if v is not None:
            out += v if isinstance(v, list) else [v]
    if "personal" in res:
        out += res["personal"]["params"] + res["personal"]["batch_stats"]
    return out


def states_equal(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


#: the launch counter each kernel of ``csrc/`` counts toward, by a part of
#: its name in a trace (the first that matches; ``ops/*.py`` counts the
#: same launches where it calls them)
TRACE_COUNTERS = (("stem_dw_bf16_", "stem_dw_bf16"), ("stem_dw_", "stem_dw"),
                  ("fused_sgd_", "fused_sgd"),
                  ("count_ge_minmax_kernel", "kth_select"),
                  ("count_ge_round_kernel", "kth_select"),
                  ("count_ge_kernel", "count_ge"))


def kernel_trace(fn) -> tuple[float, dict]:
    """``fn`` once under ``torch.profiler``: the device ms of its kernels
    and the launches of each ported kernel in the trace, by counter name
    (kernels inside CUDA graph replays included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, traced = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        total += max(t, 0) / 1e3
        for part, counter in TRACE_COUNTERS:
            if part in e.key:
                traced[counter] = traced.get(counter, 0) + e.count
                break
    return total, traced


def busy_share(fn) -> dict:
    """``fn``'s wall time (synchronized around it, no profiler), and the
    device time of its kernels in a second call under ``torch.profiler``;
    busy = device / wall. The second call's launches twice: as the trace
    has them (``traced``) and as the wrappers count them (``counted``; a
    graph replay adds its capture's launches)."""
    import torch

    from neuroimagedisttraining_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    before = _cuda.counts()
    total, traced = kernel_trace(fn)
    after = _cuda.counts()
    counted = {k: n - before.get(k, 0) for k, n in after.items()
               if n != before.get(k, 0)}
    return {"wall_ms": wall, "device_ms": total,
            "busy": total / max(wall, 1e-9), "traced": traced,
            "counted": counted}


def traced_as_counted(busy: dict, kernels: tuple) -> bool:
    """Each of ``kernels`` launched in ``busy``'s profiled call, as many
    times in the trace as the wrappers counted."""
    return all(busy["traced"].get(k, 0) == busy["counted"].get(k, 0) > 0
               for k in kernels)


#: how far D-PSGD's ring run on 4 mesh entries may part from its einsum
#: run, as a multiple of how far the float64 einsum's run parts from it
RING_WITNESS_FACTOR = 3.0

#: the flagship windows: 5 rounds, an evaluation at rounds 0 and 4 (the
#: last), so K = 4 runs round 0 alone and rounds 1-4 as one window
WINDOW_ROUNDS = ("--comm_round", "5", "--frequency_of_the_test", "4")
#: the host-bound window: FedAvg on ResNet-18 over the synthetic cohort at
#: CIFAR-10's size, 10 clients a round (100 at frac 0.1, Dirichlet 0.3)
RESNET_WINDOW = ("--algorithm", "fedavg", "--dataset", "cifar10",
                 "--model", "resnet18", "--client_num_in_total", "100",
                 "--frac", "0.1", "--partition_method", "dir",
                 "--partition_alpha", "0.3", "--batch_size", "16",
                 "--epochs", "1", "--comm_round", "2",
                 "--rounds_per_dispatch", "2", "--fused_update")


def dispatch_phase(card, dev, flagship, build_experiment,
                   by_path: dict) -> None:
    """Round programs and dispatch on the card (``engines/program.py``,
    ``parallel/``): flagship windows of SalientGrads and FedAvg bit-equal
    to single rounds, their local steps CUDA graph replays with
    ``stem_dw`` and ``fused_sgd`` inside, one host read a window and no
    host sync inside one; the ResNet-18 window's round time and busy
    share beside single rounds'; the mesh: a sharded FedAvg round, a
    one-entry client mesh, silo-first aggregation, D-PSGD's ring gossip."""
    import logging

    import torch

    from neuroimagedisttraining_tpu_torch.ops import _cuda


    def train(cfg, tag: str, capture: bool = True, setup=None):
        engine, _ = build_experiment(cfg, "cuda")
        engine.trainer.capture_steps = capture
        if setup is not None:
            setup(engine)
        reads = []
        read = engine.read_host
        engine.read_host = lambda v: (reads.append(len(v)), read(v))[1]
        _cuda.reset_counts()
        t0 = time.perf_counter()
        res = engine.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        by_path[tag] = _cuda.counts()
        return engine, res, reads, secs

    # ---- flagship windows: K = 4 (graph replays) against K = 1 (eager) ----
    for algorithm, extra in (("salientgrads", ()),
                             ("fedavg", ("--frac", "0.75"))):
        runs = {}
        for K, tag in ((1, "k1_eager"), (4, "k4")):
            cfg = flagship(algorithm, *extra, *WINDOW_ROUNDS,
                           "--rounds_per_dispatch", str(K))
            runs[K] = train(cfg, f"{algorithm}_{tag}", capture=K > 1)
        (e1, r1, reads1, s1), (e4, r4, reads4, s4) = runs[1], runs[4]
        l1 = [h["train_loss"] for h in r1["history"]]
        l4 = [h["train_loss"] for h in r4["history"]]
        equal = states_equal(run_states(r1), run_states(r4))
        launches1 = by_path[f"{algorithm}_k1_eager"]
        launches4 = by_path[f"{algorithm}_k4"]
        # the window again from the run's last state: no host sync in it,
        # and its busy share beside four single eager rounds'
        carry = ((r4["params"], r4["batch_stats"]) if algorithm == "fedavg"
                 else (r4["params"], r4["batch_stats"], r4["per_params"],
                       r4["per_bstats"]))
        syncs = hidden_syncs(lambda: e4.program.run_window(carry, 1, 4))

        def singles(eng=e1, carry=carry):
            c = carry
            for r in range(1, 5):
                c, _ = eng.window_round(c, r, eng.client_sampling(r))

        busy = {"k1_eager": busy_share(singles),
                "k4": busy_share(lambda: e4.program.run_window(carry, 1, 4))}
        out = {
            "engine": algorithm, "card": card, "bit_equal": equal,
            "train_loss_k1": l1, "train_loss_k4": l4,
            "round_seconds_k1": r1.get("round_seconds") or [
                h["round_seconds"] for h in r1["history"]],
            "round_seconds_k4": r4.get("round_seconds") or [
                h["round_seconds"] for h in r4["history"]],
            "train_seconds": {"k1_eager": s1, "k4": s4},
            "host_reads": {"k1": reads1, "k4": reads4},
            "graph_captures": e4.program.built,
            "graph_replays": e4.program.dispatches,
            "eager_captures": e1.program.built,
            "launches": {"k1_eager": launches1, "k4": launches4},
            "window_sync_warnings": syncs, "window_busy": busy}
        print(json.dumps({"dispatch_window": out}))
        if not equal or l1 != l4:
            fail(f"{algorithm}: the 4-round window is not bit-equal to four "
                 f"single eager rounds (losses {l1} vs {l4})")
        if len(reads4) != 2 or len(reads1) != 5:
            fail(f"{algorithm}: host reads {reads1} (K=1) and {reads4} "
                 "(K=4): not one a round, and one a window (round 0, "
                 "rounds 1-4)")
        if syncs:
            fail(f"{algorithm}: the window synchronized with the host at "
                 f"{syncs}")
        if not (e4.program.built >= 1 and e4.program.dispatches >= 1):
            fail(f"{algorithm}: no CUDA graph was captured or replayed")
        if launches4 != launches1 or not (launches4.get("stem_dw")
                                          and launches4.get("fused_sgd")):
            fail(f"{algorithm}: launches with replays {launches4} against "
                 f"single eager rounds' {launches1}")
        for name, b in busy.items():
            if not traced_as_counted(b, ("stem_dw", "fused_sgd")):
                fail(f"{algorithm} {name}: the trace has the launches "
                     f"{b['traced']}, the wrappers counted {b['counted']}")
        del e1, e4, r1, r4, runs, carry
        free_card()

    # ---- the host-bound window: ResNet-18 FedAvg, eager single rounds,
    # graphed single rounds (the default) and a graphed window of 2 ----
    engine, _ = cifar_sweep_engine(dev, RESNET_WINDOW)
    gen = engine.trainer.generator
    seed = engine.cfg.seed
    p0, b0 = engine.init_global_state()
    sampled = [engine.client_sampling(r) for r in range(2)]

    def singles():
        c = (p0, b0)
        for r in range(2):
            c, _ = engine.window_round(c, r, sampled[r])
        return c

    def window():
        return engine.program.run_window((p0, b0), 0, 2)[0]

    gen.manual_seed(seed)
    window()  # the step graph's warm-up, capture and first replays
    res, timing = {}, {}
    for name, capture, fn in (("k1_eager", False, singles),
                              ("k1", True, singles), ("k2", True, window)):
        engine.trainer.capture_steps = capture
        gen.manual_seed(seed)
        _cuda.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        timing[name] = (time.perf_counter() - t0) / 2
        by_path[f"fedavg_resnet18_{name}"] = _cuda.counts()
    equal = all(states_equal(list(res["k1_eager"]), list(res[k]))
                for k in ("k1", "k2"))
    # the busy share of one sampled client's local training (its steps
    # are most of a round), eager and as graph replays: a profiled round
    # of ~6,100 aten calls a step would take minutes under the profiler
    c0 = int(sampled[0][0])
    rows0 = dict(engine.client_rows([c0]))[c0]
    lr0 = engine.round_lr(0)
    busy = {}
    for name, capture in (("eager", False), ("graphed", True)):
        engine.trainer.capture_steps = capture
        busy[name] = busy_share(lambda: engine.client_train(
            0, c0, rows0, p0, b0, lr0, engine.cfg.optim.epochs))
    engine.trainer.capture_steps = True
    steps = sum(math.ceil(int(engine.n_train[c]) / engine.cfg.optim.batch_size)
                for s in sampled for c in s)
    out = {"engine": "fedavg", "model": "resnet18", "card": card,
           "clients_a_round": len(sampled[0]), "local_steps": steps,
           "bit_equal": equal, "round_seconds": timing,
           "busy_one_client": busy,
           "graph_captures": engine.program.built,
           "graph_replays": engine.program.dispatches,
           "launches": {k: by_path[f"fedavg_resnet18_{k}"]
                        for k in ("k1_eager", "k1", "k2")}}
    print(json.dumps({"dispatch_window": out}))
    if not equal:
        fail("resnet18: the graphed single rounds or the 2-round window are "
             "not bit-equal to two single eager rounds")
    for name, b in busy.items():
        if not traced_as_counted(b, ("fused_sgd",)):
            fail(f"resnet18 {name}: the trace has the launches "
                 f"{b['traced']}, the wrappers counted {b['counted']}")
    del engine, res, p0, b0
    free_card()

    # ---- the mesh ----
    def flag_run(tag, algorithm, *extra, setup=None):
        engine, res, _, secs = train(flagship(algorithm, *extra), tag,
                                     setup=setup)
        return engine, res, secs

    _, plain, _ = flag_run("fedavg_plain", "fedavg", "--frac", "0.75")
    caplog = []
    handler = logging.Handler()
    handler.emit = lambda rec: caplog.append(rec.getMessage())
    prog_log = logging.getLogger(
        "neuroimagedisttraining_tpu_torch.engines.program")
    level = prog_log.level
    prog_log.setLevel(logging.INFO)
    prog_log.addHandler(handler)
    try:
        sharded_eng, sharded, _ = flag_run(
            "fedavg_mesh2", "fedavg", "--frac", "0.75", "--client_mesh", "2",
            "--virtual_devices", "2")
        one_eng, _, _ = flag_run("fedavg_mesh1", "fedavg", "--frac", "0.75",
                                 "--client_mesh", "1")
    finally:
        prog_log.removeHandler(handler)
        prog_log.setLevel(level)
    mesh_equal = states_equal(run_states(plain), run_states(sharded))
    one_logged = any("only one device visible" in m for m in caplog)
    if not sharded_eng._cohort_on or not mesh_equal:
        fail("fedavg --client_mesh 2: the sharded run is not bit-equal to "
             "the unsharded one")
    if one_eng._cohort_on or not one_logged:
        fail("fedavg --client_mesh 1 did not log the one-device fallback")
    del sharded_eng, one_eng, sharded, plain
    # silo first on a 2 x 2 mesh against the flat mean: one round of 4
    flat_eng, flat, _ = flag_run("fedavg_flat", "fedavg", "--comm_round",
                                 "1")
    two_eng, two, _ = flag_run("fedavg_two_level", "fedavg", "--comm_round",
                               "1", "--mesh_shape", "2", "2",
                               "--virtual_devices", "4")
    rel = max(float((two["params"][k] - flat["params"][k]).abs().max())
              / max(float(flat["params"][k].abs().max()), 1e-30)
              for k in flat["params"])
    if not rel <= 1e-6:
        fail(f"--mesh_shape 2 2: the silo-first mean is {rel} relative from "
             "the flat mean")
    del flat_eng, two_eng, flat, two
    # D-PSGD with ring gossip over 4 mesh entries against its einsum: every
    # round's mix of the meshed run held against the einsum of the same
    # inputs, the first round's states (trained from the first mix) and the
    # two runs after 2 rounds; the einsum in float64 as the witness of how
    # far a rounding-level difference of the mix carries through training
    def einsum_mix(states, M, dtype=torch.float32):
        Mt = torch.as_tensor(M, dtype=dtype, device=dev)
        return [torch.einsum("cj,j...->c...", Mt,
                             torch.stack([st[k] for st in states]).to(dtype)
                             ).to(states[0][k].dtype)
                for k in states[0]]

    def rel_to(a: list, b: list) -> float:
        return max(float((y - x).abs().max())
                   / max(float(x.abs().max()), 1e-30) for x, y in zip(a, b))

    mix_rel, inputs = [], {}

    def record(tag, check=False, f64=False):
        def setup(eng):
            mix = eng.consensus

            def consensus(per_params, per_bstats, M):
                inputs.setdefault(tag, []).append(
                    [{k: v.clone() for k, v in st.items()}
                     for st in per_params])
                if f64:
                    return f64_consensus(per_params, per_bstats, M)
                out = mix(per_params, per_bstats, M)
                if check:
                    mix_rel.append(max(
                        rel_to(einsum_mix(states, M),
                               [torch.stack([st[k] for st in mixed])
                                for k in states[0]])
                        for states, mixed in ((per_params, out[0]),
                                              (per_bstats, out[1]))
                        if states[0]))
                return out

            eng.consensus = consensus
        return setup

    def f64_consensus(per_params, per_bstats, M):
        def mix(states):
            if not states[0]:
                return [{} for _ in states]
            leaves = einsum_mix(states, M, torch.float64)
            return [{k: x[c] for k, x in zip(states[0], leaves)}
                    for c in range(len(states))]
        return mix(per_params), mix(per_bstats)

    ring = ("--cs", "ring", "--frac", "0.5")
    dense_eng, dense, _ = flag_run("dpsgd_ring", "dpsgd", *ring,
                                   setup=record("dense"))
    mesh_eng, meshed, _ = flag_run("dpsgd_ring_mesh4", "dpsgd", *ring,
                                   "--virtual_devices", "4",
                                   setup=record("mesh", check=True))
    _, dense64, _ = flag_run("dpsgd_ring_f64", "dpsgd", *ring,
                             setup=record("f64", f64=True))
    M = mesh_eng.mixing_matrix(2)
    from neuroimagedisttraining_tpu_torch.parallel import gossip
    plan, _ = gossip.make_plan(M, mesh_eng.mesh, mesh_eng.num_clients)
    mixed = [type(eng).consensus(eng, meshed["personal_params"],
                                 meshed["personal_batch_stats"], M)
             for eng in (dense_eng, mesh_eng)]
    g_rel = max(float((b[k] - a[k]).abs().max())
                / max(float(a[k].abs().max()), 1e-30)
                for part in (0, 1) for a, b in zip(mixed[0][part],
                                                    mixed[1][part])
                for k in a)

    # the two runs' client states after round 0 (the inputs of round 1's
    # mix) and after 2 rounds, as shares of the einsum run's largest
    # weight change from the initial model by then
    init_p, _ = dense_eng.init_global_state()

    def over_change(ref: list, other: list) -> float:
        moved = max(float((v - init_p[k]).abs().max())
                    for st in ref for k, v in st.items())
        return max(float((b[k] - a[k]).abs().max())
                   for a, b in zip(ref, other) for k in a) / moved

    first = {t: over_change(inputs["dense"][1], inputs[t][1])
             for t in ("mesh", "f64")}
    end = {t: over_change(dense["personal_params"], r["personal_params"])
           for t, r in (("mesh", meshed), ("f64", dense64))}
    out = {"card": card, "sharded_bit_equal": mesh_equal,
           "one_device_logged": one_logged, "silo_first_rel": rel,
           "ring_plan": repr(plan), "ring_consensus_rel": g_rel,
           "ring_mix_rel_by_round": mix_rel,
           "ring_first_round_over_largest_change": first["mesh"],
           "f64_first_round_over_largest_change": first["f64"],
           "ring_runs_over_largest_change": end["mesh"],
           "f64_runs_over_largest_change": end["f64"]}
    print(json.dumps({"dispatch_mesh": out}))
    if not isinstance(plan, tuple) or not g_rel <= 1e-6:
        fail(f"dpsgd ring on 4 entries: plan {plan!r}, consensus {g_rel} "
             "relative from the einsum")
    if len(mix_rel) != 2 or not max(mix_rel) <= 1e-6:
        fail(f"dpsgd ring on 4 entries: the run's mixes {mix_rel} relative "
             "from the einsum of the same inputs")
    # the float64 einsum's run is the witness: its mix is more exact than
    # either float32 one, so how far its run parts from the einsum run's
    # is how far a rounding of the mix carries through training
    for when, d in (("after round 0", first), ("after 2 rounds", end)):
        if not d["mesh"] <= RING_WITNESS_FACTOR * d["f64"]:
            fail(f"dpsgd ring on 4 entries {when}: {d['mesh']} of the "
                 "largest weight change from the einsum run, more than "
                 f"{RING_WITNESS_FACTOR}x the float64 einsum's {d['f64']}")
    losses = [h["train_loss"] for h in meshed["history"]]
    if not all(math.isfinite(v) for v in losses):
        fail(f"dpsgd ring on the mesh: non-finite losses {losses}")
    del dense_eng, mesh_eng, dense, meshed, dense64
    free_card()


def torch_equal_bits(a, b) -> bool:
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def streamed_bit_equal(a: dict, b: dict) -> bool:
    """Two runs' results hold the same models (global and personal), masks
    and final metrics, bit for bit."""
    import torch

    def states(res):
        out = []
        for k in ("params", "batch_stats", "masks", "per_params",
                  "per_bstats", "personal_params", "personal_batch_stats"):
            v = res.get(k)
            if v is not None:
                out += v if isinstance(v, list) else [v]
        return out

    sa, sb = states(a), states(b)
    return (len(sa) == len(sb) and all(
        x.keys() == y.keys() and all(
            torch_equal_bits(x[k], y[k]) if x[k].dtype == torch.float32
            else torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(sa, sb))
        and a["final_personal"] == b["final_personal"])


#: the run whose launches a kernel's row reports: its main path
MAIN_PATH = {"stem_dw_bf16": "salientgrads_bf16"}


def finish(rows: list, by_path: dict, started: float,
           laps: dict | None = None) -> int:
    """The run's seconds since ``started`` (and each part's, ``laps``), the
    ``kernels`` line (each row's launches on its main path and on every
    path) and the contract's last line."""
    import torch

    print(json.dumps({"smoke_seconds": time.perf_counter() - started,
                      "part_seconds": laps or {}}))

    for r in rows:
        main_path = by_path.get(MAIN_PATH.get(r["name"], "salientgrads"))
        r["launches"] = None if main_path is None else main_path.get(
            r["name"], 0)
        r["launches_by_path"] = {k: v.get(r["name"], 0)
                                 for k, v in by_path.items()}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv: list[str]) -> int:
    started = time.perf_counter()
    quick = "--quick" in argv
    only_new = "--zoo-precision" in argv
    only_vision = "--vision" in argv
    only_darts = "--darts" in argv
    only_defense = "--defense" in argv
    only_secure = "--secure" in argv
    only_dispatch = "--dispatch" in argv
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    sys.path.insert(0, str(HERE))
    try:
        import neuroimagedisttraining_tpu_torch as pkg
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    if Path(pkg.__file__).resolve().parent.parent != HERE:
        fail(f"imported the port from {pkg.__file__}, not from {HERE}")
    from neuroimagedisttraining_tpu_torch.device import resolve_device
    from neuroimagedisttraining_tpu_torch.ops import _cuda
    from neuroimagedisttraining_tpu_torch.ops import fused_update as FU
    from neuroimagedisttraining_tpu_torch.ops import stemconv as SC
    from neuroimagedisttraining_tpu_torch.ops import topk as TK

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    # the host's row gather (g++) builds beside the kernels (nvcc)
    from concurrent.futures import ThreadPoolExecutor

    from neuroimagedisttraining_tpu_torch.utils import native
    with ThreadPoolExecutor(max_workers=1) as pool:
        gather = pool.submit(lambda: (native.load(),
                                      time.perf_counter() - t0)[1])
        built = _cuda.build(["stem_dw", "stem_dw_bf16", "fused_sgd",
                             "count_ge"])
        built["gather.cpp"] = gather.result()
    print(json.dumps({"build_seconds": round(time.perf_counter() - t0, 3),
                      "per_source": {k: round(v, 3)
                                     for k, v in built.items()}}))
    for name in ("stem_dw", "stem_dw_bf16", "fused_sgd", "count_ge"):
        log = (_cuda.BUILD / f"{name}.ptxas.txt")
        if log.exists():
            lines = [ln.strip() for ln in log.read_text().splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"ptxas {name}: " + " | ".join(lines))

    gen = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    def flush():
        scratch.zero_()  # 256 MB write: the next call finds L2 cold

    def time_ms(fn, iters: int) -> tuple[float, float]:
        """(device ms, host ms) per call of ``fn``, L2 flushed before each.
        A spin kernel holds the stream while the host queues the call, so
        the events around it time the device alone, not the host's gaps
        between launches; host ms is the wall time the call takes to queue
        its work. Where the spin ends before the call is queued, the call
        is timed again under a spin twice as long."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        queue_s = time.perf_counter() - t
        torch.cuda.synchronize()
        spin = int(max(4 * queue_s, 2e-3) * SPIN_CYCLES_PER_S)
        dev_ms, host_ms, retries = [], [], 0
        while len(dev_ms) < iters:
            flush()
            torch.cuda._sleep(spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            t = time.perf_counter()
            fn()
            host = time.perf_counter() - t
            late = s.query()  # the device reached the call before its end
            e.record()
            e.synchronize()
            if late and retries < 4:
                retries += 1
                spin *= 2
                continue
            if late:
                print(json.dumps({"timing_note": "spin outran the host; "
                                  "this call's time includes host gaps"}))
            dev_ms.append(s.elapsed_time(e))
            host_ms.append(host * 1e3)
        return sum(dev_ms) / iters, sum(host_ms) / iters

    rows = []
    laps, lap_at = {}, [started]

    def lap(part: str) -> None:
        """The seconds since the last lap, as ``part``'s."""
        now = time.perf_counter()
        laps[part] = now - lap_at[0]
        lap_at[0] = now

    lap("build")

    # ---- kernel 1: stem weight gradient at the flagship shape ----
    B, D, H, W = 16, 121, 145, 121
    od, oh, ow = (D - 5) // 2 + 1, (H - 5) // 2 + 1, (W - 5) // 2 + 1
    # g as the convolution's backward hands it over: NCDHW memory, seen
    # through the reference's channels-last shape
    g_ncdhw = torch.randn((B, 64, od, oh, ow), generator=gen, device=dev)
    g = g_ncdhw.permute(0, 2, 3, 4, 1)
    # the slice's x (the raw cast of 8-bit volumes: integers, whose TF32 low
    # part is 0) and a Gaussian x (a low part in every element); tolerance:
    # f32 sums of 3.95 M products in different orders, split-TF32 products
    errs = {}
    for kind in ("gaussian", "integral"):
        if kind == "gaussian":
            x = torch.randn((B, D, H, W, 1), generator=gen, device=dev)
        else:
            x = torch.randint(0, 256, (B, D, H, W, 1), generator=gen,
                              device=dev).to(torch.float32)
        dw_k = SC.stem_dw(x, g)
        dw_k2 = SC.stem_dw(x, g)
        dw_p = SC.stem_dw_plain(x, g)
        torch.cuda.synchronize()
        e = float((dw_k - dw_p).abs().max())
        t = 1e-4 * float(dw_p.abs().max())
        if not e <= t:
            fail(f"stem_dw ({kind} x) disagrees with its plain version: "
                 f"{e} > {t}")
        if not torch.equal(dw_k.view(torch.int32), dw_k2.view(torch.int32)):
            fail(f"stem_dw ({kind} x): two calls on the same inputs differ")
        errs[kind] = (e, t)
        if kind == "gaussian":
            del x
    err, tol = errs["integral"]
    # rows wider than one item (OW > 64) take the kernel's per-row copies
    xw = torch.randn((2, 21, 25, 141, 1), generator=gen, device=dev)
    gw = torch.randn((2, 64, 9, 11, 69), generator=gen, device=dev
                     ).permute(0, 2, 3, 4, 1)
    pw = SC.stem_dw_plain(xw, gw)
    ew = float((SC.stem_dw(xw, gw) - pw).abs().max())
    if not ew <= 1e-4 * float(pw.abs().max()):
        fail(f"stem_dw at OW = 69 disagrees with its plain version: {ew}")
    del xw, gw, pw
    R = B * od * oh * ow
    flops = 2.0 * R * 125 * 64
    nbytes = 4.0 * (x.numel() + g.numel() + 125 * 64)
    # split TF32 on the tensor cores: three products, or two where every x
    # is a TF32 value (low 13 mantissa bits 0, the kernel's own test), as
    # the timed x (the slice's integers) is
    x_lo = bool(((x.view(torch.int32) & 0x1FFF) != 0).any())
    products = 3 if x_lo else 2
    b_ms, b_by = bound_ms(nbytes, products * flops, TF32_OPS_PER_S)
    stem_extra = {"tf32_products": products,
                  "bound_fp32_cores_ms": bound_ms(nbytes, flops)[0],
                  "gaussian_max_abs_err": errs["gaussian"][0],
                  "gaussian_tolerance": errs["gaussian"][1],
                  "wide_rows_max_abs_err": ew}
    k_ms = k_host = p_ms = l_ms = None
    if not quick:
        x_ncdhw = x.reshape(B, 1, D, H, W)
        lib = torch.nn.grad.conv3d_weight(x_ncdhw, (64, 1, 5, 5, 5), g_ncdhw,
                                          stride=2)
        lib_err = float((lib.permute(2, 3, 4, 1, 0) - dw_p).abs().max())
        print(json.dumps({"stem_dw_library_vs_plain_max_abs_err": lib_err}))
        k_ms, k_host = time_ms(lambda: SC.stem_dw(x, g), 10)
        p_ms, _ = time_ms(lambda: SC.stem_dw_plain(x, g), 3)
        l_ms, _ = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x_ncdhw, (64, 1, 5, 5, 5), g_ncdhw, stride=2), 10)
        # the copy a kernel reading g channels-last would need per call
        t_ms, _ = time_ms(lambda: g.contiguous(), 10)
        stem_extra["g_transpose_ms"] = t_ms
        del x_ncdhw, lib
    rows.append({"name": "stem_dw", "route": "cuda",
                 "source": "neuroimagedisttraining_tpu_torch/csrc/stem_dw.cu",
                 "replaces": "neuroimagedisttraining_tpu/ops/stemconv.py:112",
                 "max_abs_err": err, "tolerance": tol, "ms": k_ms,
                 "host_ms": k_host, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": l_ms,
                 "library": "torch.nn.grad.conv3d_weight", **stem_extra})
    del x, g, g_ncdhw, dw_k, dw_k2, dw_p
    free_card()

    lap("kernel stem_dw")

    # ---- kernel 1b: the stem weight gradient in bf16 (bf16_mixed) ----
    rows.append(bf16_stem_dw_row(dev, gen, quick, time_ms))
    free_card()
    lap("kernel stem_dw_bf16")

    # ---- kernel 2: fused SGD tail over the flagship AlexNet3D leaves ----
    from neuroimagedisttraining_tpu_torch.models import create_model

    shapes = [tuple(p.shape) for p in
              create_model("3dcnn", (121, 145, 121)).parameters()]
    n_params = sum(math.prod(s) for s in shapes)

    def leaves(scale, gen):
        return [torch.randn(s, generator=gen, device=dev) * scale
                for s in shapes]

    def bit_equal(xs, ys) -> bool:
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(xs, ys))

    p0, g0, t0_ = leaves(0.05, gen), leaves(0.01, gen), leaves(0.01, gen)
    m0 = [(torch.rand(s, generator=gen, device=dev) < 0.5).to(torch.float32)
          for s in shapes]

    def state():
        return [p.clone() for p in p0], [t.clone() for t in t0_]

    lr = torch.tensor(0.01, dtype=torch.float32, device=dev)
    wd, mom = 5e-4, 0.9
    gnorm_p = FU.global_norm(g0)
    # the clip taken far from its boundary: gnorm ~ 3 x clip
    clip = float(gnorm_p) / 3
    kw = dict(clip=clip, wd=wd, momentum=mom)
    # the pass under given scalars == the plain pass bit for bit (each
    # operation rounded on its own in both), the clip stage taken and not
    for ok in (0.0, 1.0):
        scal = torch.stack([torch.full_like(gnorm_p, ok), gnorm_p, lr])
        (pk, tk), (pp, tp) = state(), state()
        FU.fused_sgd_apply(pk, g0, tk, m0, scal, **kw)
        FU.sgd_apply_plain(pp, g0, tp, m0, scal, **kw)
        if not bit_equal(pk + tk, pp + tp):
            fail(f"fused_sgd_apply (ok = {ok}) is not bit-equal to the plain "
                 "pass under the same scalars")
    # the whole step where the clip is skipped (1e6) or off (0): bit-equal
    # to the plain step, since ok and lr are then exact on both sides
    for c in (1e6, 0.0):
        (pk, tk), (pp, tp) = state(), state()
        FU.fused_sgd_step(pk, g0, tk, m0, clip=c, wd=wd, momentum=mom, lr=lr)
        FU.sgd_step_plain(pp, g0, tp, m0, clip=c, wd=wd, momentum=mom, lr=lr)
        if not bit_equal(pk + tk, pp + tp):
            fail(f"fused_sgd_step (clip {c}) is not bit-equal to the plain "
                 "step")
    # the clip taken: the kernel's fp64 norm within rtol 2e-6 of the plain
    # fp32 one; the step == the plain pass under the kernel's own scalars,
    # bit for bit, and within a tolerance of the plain step (clip / gnorm
    # differs by up to 2e-6 relative, and each output by one rounding)
    (pk, tk), (pp, tp), (pq, tq) = state(), state(), state()
    scal_k = FU.fused_sgd_step(pk, g0, tk, m0, lr=lr, **kw).clone()
    FU.sgd_apply_plain(pp, g0, tp, m0, scal_k, **kw)
    FU.sgd_step_plain(pq, g0, tq, m0, lr=lr, **kw)
    _, apply_blocks, norm_blocks = FU._library(torch.cuda.current_device())
    gnorm_b = FU.global_norm_blocked(g0, norm_blocks)
    torch.cuda.synchronize()
    gnorm_k = float(scal_k[1])
    gnorm_err = abs(gnorm_k - float(gnorm_p)) / float(gnorm_p)
    if not gnorm_err <= 2e-6:
        fail(f"fused_sgd's global norm {gnorm_k} is not within rtol 2e-6 of "
             f"the plain {float(gnorm_p)}")
    if float(scal_k[0]) != 0.0 or float(scal_k[2]) != float(lr):
        fail(f"fused_sgd's scalars {scal_k.tolist()}: the clip at gnorm / 3 "
             "was not taken, or lr was not copied")
    if not bit_equal(pk + tk, pp + tp):
        fail("fused_sgd_step is not bit-equal to the plain pass under its own "
             "scalars")
    f_err = max(float((a - b).abs().max()) for a, b in zip(pk + tk, pq + tq))
    f_tol = 1e-5 * max(float(b.abs().max()) for b in pq + tq)
    if not f_err <= f_tol:
        fail(f"fused_sgd_step (clip taken) is {f_err} from the plain step, "
             f"over {f_tol}")
    # two calls on the same inputs: bit-equal, scalars included
    pk2, tk2 = state()
    scal_k2 = FU.fused_sgd_step(pk2, g0, tk2, m0, lr=lr, **kw)
    if not bit_equal(pk + tk + [scal_k], pk2 + tk2 + [scal_k2]):
        fail("fused_sgd_step: two calls on the same inputs differ")
    # no host sync (a new table, then the kept one), and 2 device operations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    pk2, tk2 = state()
    for _ in range(2):
        FU.fused_sgd_step(pk2, g0, tk2, m0, lr=lr, **kw)
    torch.cuda.set_sync_debug_mode("default")
    step_ops = device_ops(lambda: FU.fused_sgd_step(pk2, g0, tk2, m0, lr=lr,
                                                    **kw))
    if len(step_ops) > 2:
        fail(f"fused_sgd_step ran {len(step_ops)} device operations, more "
             f"than 2: {step_ops}")
    # the nearest library chain (not the same function bit for bit:
    # clip_grad_norm_ scales by clip / (gnorm + 1e-6) and the fused SGD
    # contracts into FMAs), on copies: clip_grad_norm_ writes the grads
    fused_sgd_ = getattr(torch, "_fused_sgd_", None)
    lr_f = float(lr)
    gl = [g.clone() for g in g0]
    pl, tl = state()
    for pi, gi in zip(pl, gl):
        pi.grad = gi  # clip_grad_norm_ clips the .grad of what it is given

    def library_chain():
        torch.nn.utils.clip_grad_norm_(pl, clip, foreach=True)
        fused_sgd_(pl, gl, tl, weight_decay=wd, momentum=mom, lr=lr_f,
                   dampening=0.0, nesterov=False, maximize=False,
                   is_first_step=False)
        torch._foreach_mul_(pl, m0)

    lib_err = None
    if fused_sgd_ is not None:
        library_chain()
        lib_err = max(float((a - b).abs().max())
                      for a, b in zip(pl + tl, pq + tq))
    # bytes: p, g, momentum and mask read once, p and momentum written once
    # (the norm's read of g is the pass's; its second read finds g in L2);
    # operations: 2 for the norm and 9 for the update an element
    fb_ms, fb_by = bound_ms(4.0 * 6 * n_params, 11.0 * n_params)
    fk_ms = fk_host = fp_ms = fl_ms = None
    timed = {}
    if not quick:
        scal = FU.sgd_scalars(g0, clip=clip, lr=lr)
        fk_ms, fk_host = time_ms(
            lambda: FU.fused_sgd_step(pk, g0, tk, m0, lr=lr, **kw), 20)
        a_ms, a_host = time_ms(
            lambda: FU.fused_sgd_apply(pk, g0, tk, m0, scal, **kw), 20)
        fp_ms, _ = time_ms(
            lambda: FU.sgd_step_plain(pp, g0, tp, m0, lr=lr, **kw), 10)
        pa_ms, _ = time_ms(
            lambda: FU.sgd_apply_plain(pp, g0, tp, m0, scal, **kw), 10)
        if fused_sgd_ is not None:
            fl_ms, _ = time_ms(library_chain, 20)
        timed = {"apply_ms": a_ms, "apply_host_ms": a_host,
                 "plain_apply_ms": pa_ms}
    # beyond one launch's table of 32 leaves: resnet18's 62 leaves (two
    # tables) and 140 ragged leaves (five, empty leaves among them); the
    # clip taken at gnorm / 3
    wide = {}
    ragged = [int(n) for n in np.random.default_rng(6).integers(0, 9000, 140)]
    darts_sizes = {name: [p.numel() for p in create_model(
        name, (32, 32, 3), 10).parameters()] for name in ("darts",
                                                          "darts_search")}
    for tree, sizes in (("resnet18", RESNET18_SIZES), ("ragged140", ragged),
                        *darts_sizes.items()):
        pw = [torch.randn(n, generator=gen, device=dev) * 0.05 for n in sizes]
        gw = [torch.randn(n, generator=gen, device=dev) * 0.01 for n in sizes]
        tw = [torch.randn(n, generator=gen, device=dev) * 0.01 for n in sizes]
        mw = [(torch.rand(n, generator=gen, device=dev) < 0.5).to(
            torch.float32) for n in sizes]

        def wstate():
            return [p.clone() for p in pw], [t.clone() for t in tw]

        gn_w = FU.global_norm(gw)
        kw_w = dict(clip=float(gn_w) / 3, wd=wd, momentum=mom)
        ntables = len(FU.plan_chunks(sizes).tables)
        (pk_w, tk_w), (pp_w, tp_w) = wstate(), wstate()
        before = FU.LAUNCHES.count
        scal_w = FU.fused_sgd_step(pk_w, gw, tk_w, mw, lr=lr, **kw_w).clone()
        step_launches = FU.LAUNCHES.count - before
        FU.sgd_apply_plain(pp_w, gw, tp_w, mw, scal_w, **kw_w)
        gn_err = abs(float(scal_w[1]) - float(gn_w)) / float(gn_w)
        if step_launches != 2 * ntables:
            fail(f"fused_sgd_step over {len(sizes)} leaves launched "
                 f"{step_launches} kernels, not 2 for each of {ntables} "
                 "tables")
        if not gn_err <= 2e-6 or float(scal_w[0]) != 0.0:
            fail(f"fused_sgd over {len(sizes)} leaves: norm {scal_w.tolist()}"
                 f" against the plain {float(gn_w)} (rtol 2e-6, clip taken)")
        if not bit_equal(pk_w + tk_w, pp_w + tp_w):
            fail(f"fused_sgd_step over {len(sizes)} leaves is not bit-equal "
                 "to the plain pass under its own scalars")
        for ok in (0.0, 1.0):
            scal = torch.stack([torch.full_like(gn_w, ok), gn_w, lr])
            (pk_w, tk_w), (pp_w, tp_w) = wstate(), wstate()
            FU.fused_sgd_apply(pk_w, gw, tk_w, mw, scal, **kw_w)
            FU.sgd_apply_plain(pp_w, gw, tp_w, mw, scal, **kw_w)
            if not bit_equal(pk_w + tk_w, pp_w + tp_w):
                fail(f"fused_sgd_apply over {len(sizes)} leaves (ok = {ok}) "
                     "is not bit-equal to the plain pass")
        n_w = sum(sizes)
        wide[tree] = {"leaves": len(sizes), "params": n_w,
                      "tables": ntables, "launches_per_step": step_launches,
                      "gnorm_rel_err": gn_err,
                      "bound_ms": bound_ms(4.0 * 6 * n_w, 11.0 * n_w)[0]}
        if not quick and tree != "ragged140":
            (pk_w, tk_w) = wstate()
            w_ms, w_host = time_ms(lambda: FU.fused_sgd_step(
                pk_w, gw, tk_w, mw, lr=lr, **kw_w), 20)
            # the plain chain is no yardstick: one timed call
            wp_ms, _ = time_ms(lambda: FU.sgd_step_plain(
                pp_w, gw, tp_w, mw, lr=lr, **kw_w), 1)
            wide[tree].update(ms=w_ms, host_ms=w_host, plain_ms=wp_ms)
            if fused_sgd_ is not None and tree != "resnet18":
                gl_w = [g.clone() for g in gw]
                pl_w, tl_w = wstate()
                for pi, gi in zip(pl_w, gl_w):
                    pi.grad = gi

                def wide_chain():
                    torch.nn.utils.clip_grad_norm_(pl_w, kw_w["clip"],
                                                   foreach=True)
                    fused_sgd_(pl_w, gl_w, tl_w, weight_decay=wd,
                               momentum=mom, lr=lr_f, dampening=0.0,
                               nesterov=False, maximize=False,
                               is_first_step=False)
                    torch._foreach_mul_(pl_w, mw)
                wide[tree]["library_ms"], _ = time_ms(wide_chain, 10)
                del gl_w, pl_w, tl_w
        del pw, gw, tw, mw, pk_w, tk_w, pp_w, tp_w
    rows.append({"name": "fused_sgd", "route": "cuda",
                 "source": "neuroimagedisttraining_tpu_torch/csrc/fused_sgd.cu",
                 "replaces":
                     "neuroimagedisttraining_tpu/ops/fused_update.py:131",
                 "max_abs_err": f_err, "tolerance": f_tol, "ms": fk_ms,
                 "host_ms": fk_host, "plain_ms": fp_ms, "bound_ms": fb_ms,
                 "bound_by": fb_by, "library_ms": fl_ms,
                 "library": "clip_grad_norm_(foreach) + torch._fused_sgd_ + "
                            "_foreach_mul_(masks)",
                 "library_max_abs_err": lib_err, "leaves": len(shapes),
                 "params": n_params, "chunks": FU.plan_chunks(
                     [math.prod(s) for s in shapes]).nchunks,
                 "blocks": {"apply": apply_blocks, "norm": norm_blocks},
                 "gnorm_rel_err": gnorm_err,
                 "gnorm_blocked_rel_err":
                     abs(gnorm_k - float(gnorm_b)) / float(gnorm_b),
                 "device_ops_per_step": len(step_ops) or None,
                 "beyond_one_table": wide,
                 "bit_equal": ["apply (ok 0 and 1)", "step (clip 1e6)",
                               "step (clip 0)", "step (clip taken) vs the "
                               "plain pass under its scalars",
                               "two calls"], **timed})
    del p0, g0, t0_, m0, pk, tk, pp, tp, pq, tq, pk2, tk2, gl, pl, tl
    free_card()

    lap("kernel fused_sgd")

    # ---- kernel 3: count >= thresholds over the flagship score vector ----
    n_scores = sum(math.prod(s) for s in shapes if len(s) >= 2)
    xs = torch.rand(n_scores, generator=gen, device=dev) ** 3
    xs = xs / xs.sum()
    thr = TK.linspace(xs.min(), xs.max(), 512)
    c_k = TK.count_ge(xs, thr)
    c_p = TK.count_ge_plain(xs, thr)
    torch.cuda.synchronize()
    c_err = float((c_k - c_p).abs().max())
    if c_err != 0.0:  # integer counts: exact
        fail(f"count_ge disagrees with its plain version: {c_err}")
    # the kernel sorts its ladder: an unsorted one with ties, NaN and +-inf,
    # over scores holding NaN and +-inf, must count exactly the same
    x2 = xs.clone()
    x2[::997], x2[1::991], x2[2::983] = (float("nan"), float("inf"),
                                         float("-inf"))
    perm = torch.randperm(512, generator=gen, device=dev)
    thr2 = torch.cat([thr[perm[:400]], thr[:96], thr.new_tensor(
        [float("nan")] * 14 + [float("inf"), float("-inf")])])
    c2_err = float((TK.count_ge(x2, thr2)
                    - TK.count_ge_plain(x2, thr2)).abs().max())
    if c2_err != 0.0:
        fail(f"count_ge on an unsorted ladder with NaN disagrees: {c2_err}")
    del x2, thr2
    k = n_scores // 2
    # the select on the card == the plain loop on the host, bit for bit, on
    # four kinds of scores: the flagship's (uniform^3, normalised), normal,
    # many ties, and a lognormal tail whose k-th value sits near the
    # bottom (there 4 x 512 bins stop short of float resolution)
    kinds = {
        "uniform3": (xs, k),
        "normal": (torch.randn(n_scores, generator=gen, device=dev), k),
        "ties": (torch.randint(0, 50, (n_scores,), generator=gen,
                               device=dev).to(torch.float32), k),
        "tail": (torch.exp(4.0 * torch.randn(n_scores, generator=gen,
                                             device=dev)),
                 int(0.95 * n_scores)),
    }
    for kind, (v, kk) in kinds.items():
        got = TK.kth_largest(v, kk).cpu()
        want = TK.kth_largest(v.cpu(), kk)  # the plain loop on the host
        if got.view(torch.int32) != want.view(torch.int32):
            fail(f"kth_largest ({kind}) on the card {got.item()} != plain "
                 f"{want.item()}")
    kind_names = sorted(kinds)
    del kinds, v
    thr_gpu = TK.kth_largest(xs, k)
    # no host sync inside the select, and its launches on the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    TK.kth_largest(xs, k)
    torch.cuda.set_sync_debug_mode("default")
    kth_ops = device_ops(lambda: TK.kth_largest(xs, k))
    if len(kth_ops) > 6:
        fail(f"kth_largest ran {len(kth_ops)} device operations, more "
             f"than 6: {kth_ops}")
    exact = torch.topk(xs, k).values[-1]
    # x read once, thresholds read and counts written once; a binary search
    # over the sorted ladder: ceil(log2(nbins + 1)) compares per element
    search = math.ceil(math.log2(512 + 1))
    cb_ms, cb_by = bound_ms(4.0 * (n_scores + 2 * 512), n_scores * search)
    # the select: one read of x from HBM (its later passes find the 10 MB
    # in L2, for which the data sheet gives no rate), two compares an
    # element for min/max and a search an element in each of 4 rounds
    kb_ms, kb_by = bound_ms(4.0 * (n_scores + 1), n_scores * (2 + 4 * search))
    ck_ms = ck_host = cp_ms = None
    kl_ms = kl_host = kp_ms = kt_ms = None
    if not quick:
        ck_ms, ck_host = time_ms(lambda: TK.count_ge(xs, thr), 50)
        cp_ms, _ = time_ms(lambda: TK.count_ge_plain(xs, thr), 5)
        kl_ms, kl_host = time_ms(lambda: TK.kth_largest(xs, k), 20)
        kp_ms, _ = time_ms(lambda: TK.kth_largest_plain(xs, k), 5)
        kt_ms, _ = time_ms(lambda: torch.topk(xs, k).values[-1], 20)
    # the standalone count (the TPU kernel's function); the main path runs
    # it inside the select (next row), so its launch count there is 0
    rows.append({"name": "count_ge", "route": "cuda",
                 "source": "neuroimagedisttraining_tpu_torch/csrc/count_ge.cu",
                 "replaces": "neuroimagedisttraining_tpu/ops/topk.py:59",
                 "max_abs_err": c_err, "tolerance": 0.0, "ms": ck_ms,
                 "host_ms": ck_host, "plain_ms": cp_ms, "bound_ms": cb_ms,
                 "bound_by": cb_by, "library_ms": None, "library": None,
                 "n": n_scores, "nbins": 512, "kth_largest_ms": kl_ms,
                 # None where the profiler saw no device activity
                 "kth_largest_launches": len(kth_ops) or None,
                 "kth_largest_library_ms": kt_ms})
    # kth_largest on the card: the min/max pass and 4 counting rounds of
    # count_ge.cu; max_abs_err over the four kinds held bit-equal above
    rows.append({"name": "kth_select", "route": "cuda",
                 "source": "neuroimagedisttraining_tpu_torch/csrc/count_ge.cu",
                 "replaces": "neuroimagedisttraining_tpu/ops/topk.py:59",
                 "max_abs_err": 0.0, "tolerance": 0.0, "ms": kl_ms,
                 "host_ms": kl_host, "plain_ms": kp_ms, "bound_ms": kb_ms,
                 "bound_by": kb_by, "library_ms": kt_ms,
                 "library": "torch.topk(x, k).values[-1]", "n": n_scores,
                 "k": k, "nbins": 512, "rounds": 4,
                 "equals_topk": bool(exact == thr_gpu),
                 "kinds_bit_equal": kind_names,
                 "device_ops": len(kth_ops) or None})
    del xs, thr, c_k, c_p
    free_card()
    # the select at the 2D path's score counts (resnet18, vgg11)
    rows[-1]["vision_scores"] = {}
    for name, n in VISION_SCORES.items():
        at = kth_select_at(n, gen, dev, time_ms, quick)
        rows[-1]["vision_scores"][name] = at
        print(json.dumps({"kth_select_at": name, "card": card, **at}))
    # and at the DARTS network's (the DARTS path's one global mask)
    at = kth_select_at(DARTS_SCORES["darts"], gen, dev, time_ms, quick)
    rows[-1]["darts_scores"] = {"darts": at}
    print(json.dumps({"kth_select_at": "darts", "card": card, **at}))

    lap("kernel count_ge, kth_select")

    # ---- the slice: flagship SalientGrads through the user entry points ----
    launches = {r["name"]: None for r in rows}
    by_path: dict[str, dict] = {}  # kernel launches of each engine's run
    if not quick:
        os.environ["NIDT_FAST_STEM"] = "1"
        from neuroimagedisttraining_tpu_torch.__main__ import (
            add_args, build_experiment, config_from_args,
        )
        from neuroimagedisttraining_tpu_torch.data import synthetic
        import argparse
        import contextlib
        import functools
        import io

        # every flagship run draws the same synthetic cohort (seed, shape,
        # subjects and sites): drawn once, read by every build_experiment
        synthetic.generate_synthetic_abcd = functools.lru_cache(maxsize=2)(
            synthetic.generate_synthetic_abcd)

        def flagship(algorithm: str, *extra: str, fused: bool = True):
            return config_from_args(add_args(argparse.ArgumentParser())
                                    .parse_args([
                "--algorithm", algorithm, "--dataset", "synthetic",
                "--model", "3DCNN", "--synthetic_shape", "121", "145", "121",
                "--synthetic_num_subjects", "48", "--client_num_in_total",
                "4", "--batch_size", "16", "--itersnip_iteration", "1",
                "--epochs", "1", "--comm_round", "2",
                *(["--fused_update"] if fused else []), *extra]))

        if only_new:
            zoo_precision_phase(card, dev, flagship, build_experiment, {},
                                by_path)
            lap("phase")
            return finish(rows, by_path, started, laps)
        if only_vision:
            vision_phase(card, dev, build_experiment, by_path)
            lap("phase")
            return finish(rows, by_path, started, laps)
        if only_darts:
            darts_phase(card, dev, build_experiment, by_path)
            lap("phase")
            return finish(rows, by_path, started, laps)
        if only_defense:
            defense_phase(card, dev, build_experiment, by_path, rows,
                          time_ms)
            lap("phase")
            return finish(rows, by_path, started, laps)
        if only_secure:
            secure_phase(card, build_experiment, by_path)
            lap("phase")
            return finish(rows, by_path, started, laps)
        if only_dispatch:
            dispatch_phase(card, dev, flagship, build_experiment, by_path)
            lap("phase")
            return finish(rows, by_path, started, laps)

        cfg = flagship("salientgrads")
        t0 = time.perf_counter()
        engine, info = build_experiment(cfg, "cuda")
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        _cuda.reset_counts()
        t0 = time.perf_counter()
        with TableTimer() as sg_table:
            result = engine.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = _cuda.counts()
        n = [int(v) for v in engine.n_train]
        steps = sum(math.ceil(v / cfg.optim.batch_size) for v in n) \
            * cfg.optim.epochs * cfg.fed.comm_round
        losses = [h["train_loss"] for h in result["history"]]
        metrics = [result["final_global"][m] for m in ("acc", "loss", "auc")]
        print(json.dumps({
            "card": card, "partition": info["train_counts"],
            "setup_seconds": setup_s, "train_seconds": train_s,
            "phase1_seconds": result["phase1_seconds"],
            "round_seconds": [h["round_seconds"] for h in result["history"]],
            "train_loss": losses, "mask_density": result["mask_density"],
            "final_global": result["final_global"],
            "final_personal": result["final_personal"],
            "launches": launches, "local_steps": steps,
            "fused_sgd_table": sg_table.summary(),
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
        if not all(math.isfinite(v) for v in losses + metrics):
            fail(f"non-finite losses or metrics: {losses} {metrics}")
        if abs(result["mask_density"] - cfg.sparsity.dense_ratio) > 0.01:
            fail(f"mask density {result['mask_density']} is not within 0.01 "
                 f"of {cfg.sparsity.dense_ratio}")
        # the main path's kernels (the standalone count_ge is not one)
        for name in ("stem_dw", "fused_sgd", "kth_select"):
            if not launches.get(name, 0) > 0:
                fail(f"the slice never launched the {name} kernel")
        # the fused step: the norm and the pass, one launch each a step
        if launches["fused_sgd"] != 2 * steps:
            fail(f"fused_sgd launched {launches['fused_sgd']} kernels in "
                 f"{steps} local steps, not 2 a step")
        # device kernel launches: per local or SNIP step, per phase 1
        per_call = {"stem_dw": launches["stem_dw"] / (steps + len(n)),
                    "fused_sgd": launches["fused_sgd"] / steps,
                    "count_ge": launches["count_ge"],
                    "kth_select": launches["kth_select"]}
        for r in rows:
            print(json.dumps({"kernel": r["name"], "kernel_ms": r["ms"],
                              "host_ms": r["host_ms"],
                              "plain_ms": r["plain_ms"],
                              "library_ms": r["library_ms"],
                              "bound_ms": r["bound_ms"],
                              "launches_per_step_or_phase1":
                                  per_call.get(r["name"]),
                              "card": card}))

        by_path["salientgrads"] = launches
        # each resident run the streamed phase holds its streamed run against
        resident = {"salientgrads": {
            "round_seconds": [h["round_seconds"] for h in result["history"]],
            "phase1_seconds": result["phase1_seconds"],
            "train_seconds": train_s, "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}}

        # ---- the dense engines at full width, each its own main path ----
        for algorithm, extra in (("fedavg", ("--frac", "0.75")),
                                 ("fedprox", ()), ("ditto", ()),
                                 ("local", ())):
            ecfg = flagship(algorithm, *extra)
            t0 = time.perf_counter()
            engine, info = build_experiment(ecfg, "cuda")
            setup_s = time.perf_counter() - t0
            steps = local_steps(engine)
            torch.cuda.reset_peak_memory_stats(dev)
            _cuda.reset_counts()
            t0 = time.perf_counter()
            result = engine.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            got = _cuda.counts()
            by_path[algorithm] = got
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            losses = [h["train_loss"] for h in result["history"]]
            metrics = [result["final_personal"][m]
                       for m in ("acc", "loss", "auc")]
            syncs = (hidden_syncs(lambda: engine.run_round(
                2, result["params"], result["batch_stats"],
                engine.client_sampling(2))) if algorithm == "fedavg"
                else None)
            print(json.dumps({
                "engine": algorithm, "card": card,
                "partition": info["train_counts"],
                "sampled": [engine.client_sampling(r).tolist()
                            for r in range(ecfg.fed.comm_round)],
                "setup_seconds": setup_s, "train_seconds": train_s,
                "round_seconds": result["round_seconds"],
                "finetune_seconds": result.get("finetune_seconds"),
                "train_loss": losses,
                "final_personal": result["final_personal"],
                "final_global": result.get("final_global"),
                "launches": got, "local_steps": steps,
                "sync_warnings": syncs, "peak_memory_gb": peak_gb}))
            if algorithm == "fedavg":
                resident["fedavg"] = {
                    "round_seconds": result["round_seconds"],
                    "finetune_seconds": result["finetune_seconds"],
                    "train_seconds": train_s, "launches": got,
                    "peak_memory_gb": peak_gb, "sync_warnings": syncs}
            if not all(math.isfinite(v) for v in losses + metrics):
                fail(f"{algorithm}: non-finite losses or metrics: {losses} "
                     f"{metrics}")
            if got["fused_sgd"] != 2 * steps or got["stem_dw"] != 3 * steps:
                fail(f"{algorithm}: {got} in {steps} local steps, not "
                     "fused_sgd 2 and stem_dw 3 a step")
            if got["kth_select"] or got["count_ge"]:
                fail(f"{algorithm} launched the top-k kernels: {got}")
            del engine, result
            free_card()

        # ---- the sparse personalized engines at full width ----
        from neuroimagedisttraining_tpu_torch.ops import masks as M

        for algorithm, extra in (
                ("subavg", SPARSE_ARGS["subavg"]),
                ("dispfl", SPARSE_ARGS["dispfl"])):
            ecfg = flagship(algorithm, *extra)
            t0 = time.perf_counter()
            engine, info = build_experiment(ecfg, "cuda")
            setup_s = time.perf_counter() - t0
            steps, n_probes = local_steps(engine), probes(engine)
            torch.cuda.reset_peak_memory_stats(dev)
            _cuda.reset_counts()
            t0 = time.perf_counter()
            with TableTimer() as table:
                result = engine.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            got = _cuda.counts()
            by_path[algorithm] = got
            resident[algorithm] = {
                "round_seconds": result["round_seconds"],
                "train_seconds": train_s, "launches": got,
                "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
            losses = [h["train_loss"] for h in result["history"]]
            metrics = [result["final_personal"][m]
                       for m in ("acc", "loss", "auc")]
            out = {"engine": algorithm, "card": card,
                   "partition": info["train_counts"],
                   "setup_seconds": setup_s, "train_seconds": train_s,
                   "round_seconds": result["round_seconds"],
                   "train_loss": losses, "history": result["history"],
                   "final_personal": result["final_personal"],
                   "launches": got, "local_steps": steps,
                   "gradient_probes": n_probes,
                   "kernel_calls_per_step": {
                       "fused_sgd": got["fused_sgd"] / max(steps, 1),
                       "stem_dw": got["stem_dw"] / max(steps + n_probes, 1)},
                   "fused_sgd_table": table.summary(),
                   "fused_sgd_table_salientgrads": sg_table.summary(),
                   "peak_memory_gb":
                       torch.cuda.max_memory_allocated(dev) / 1e9}
            if not all(math.isfinite(v) for v in losses + metrics):
                fail(f"{algorithm}: non-finite losses or metrics: {losses} "
                     f"{metrics}")
            if (got["fused_sgd"] != 2 * steps
                    or got["stem_dw"] != 3 * (steps + n_probes)):
                fail(f"{algorithm}: {got} in {steps} local steps and "
                     f"{n_probes} gradient probes, not fused_sgd 2 a step "
                     "and stem_dw 3 a step or probe")
            if got["kth_select"] or got["count_ge"]:
                fail(f"{algorithm} launched the top-k kernels: {got}")
            # one more round under sync debug mode: the port's lines that
            # synchronized with the host
            if algorithm == "subavg":
                out["sync_warnings"] = hidden_syncs(lambda: engine.run_round(
                    2, result["params"], result["batch_stats"],
                    result["mask_pers"], engine.client_sampling(2)))
            else:
                out["sync_warnings"] = hidden_syncs(lambda: engine.run_round(
                    2, result["personal_params"],
                    result["personal_batch_stats"], result["masks"],
                    result["masks"], engine.adjacency(
                        2, engine.active_draw(2))))
            if algorithm == "subavg":
                out["client_densities"] = result["client_densities"]
                if not sum(h["prunes_accepted"] for h in result["history"]):
                    fail("subavg: no prune was accepted, so the prune path "
                         "did not run")
            else:
                init_p, _ = engine.init_global_state()
                start, _ = engine.init_masks_all(init_p)
                nnz_moved = [(c, k) for c, (a, b) in
                             enumerate(zip(start, result["masks"]))
                             for k in a if M.is_weight_kernel(k, a[k])
                             and int(a[k].sum()) != int(b[k].sum())]
                density = [float(M.mask_density(m))
                           for m in result["masks"]]
                out.update(mask_density=density,
                           mask_dis_matrix=result["mask_dis_matrix"],
                           evolution=evolution_cost(engine, result))
                if nnz_moved:
                    fail(f"dispfl: fire and regrow changed the nonzero "
                         f"count of (client, layer) {nnz_moved}")
                if any(abs(d - ecfg.sparsity.dense_ratio) > 0.01
                       for d in density):
                    fail(f"dispfl: mask densities {density} are not "
                         f"within 0.01 of {ecfg.sparsity.dense_ratio}")
            print(json.dumps(out))
            del engine, result
            free_card()

        # ---- D-PSGD, FedFomo and TurboAggregate at full width ----
        from neuroimagedisttraining_tpu_torch.__main__ import main as cli
        from neuroimagedisttraining_tpu_torch.core.optim import LocalOptimizer
        from neuroimagedisttraining_tpu_torch.engines.fedfomo import (
            FedFomoEngine,
        )

        fomo_read = sync_site(FedFomoEngine, "p_choose.cpu()")
        for algorithm in ("dpsgd", "fedfomo", "turboaggregate"):
            ecfg = flagship(algorithm, *ENGINE_ARGS[algorithm])
            t0 = time.perf_counter()
            engine, info = build_experiment(ecfg, "cuda")
            setup_s = time.perf_counter() - t0
            steps = local_steps(engine)
            torch.cuda.reset_peak_memory_stats(dev)
            _cuda.reset_counts()
            t0 = time.perf_counter()
            result = engine.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            got = _cuda.counts()
            by_path[algorithm] = got
            resident[algorithm] = {
                "round_seconds": result["round_seconds"],
                "train_seconds": train_s, "launches": got,
                "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
            losses = [h["train_loss"] for h in result["history"]]
            final = result.get("final_personal") or result["final_global"]
            metrics = [final[m] for m in ("acc", "loss", "auc")]
            out = {"engine": algorithm, "card": card,
                   "partition": info["train_counts"],
                   "setup_seconds": setup_s, "train_seconds": train_s,
                   "round_seconds": result["round_seconds"],
                   "finetune_seconds": result.get("finetune_seconds"),
                   "train_loss": losses, "history": result["history"],
                   "final": final, "launches": got, "local_steps": steps,
                   "peak_memory_gb":
                       torch.cuda.max_memory_allocated(dev) / 1e9}
            if not all(math.isfinite(v) for v in losses + metrics):
                fail(f"{algorithm}: non-finite losses or metrics: {losses} "
                     f"{metrics}")
            if got["fused_sgd"] != 2 * steps or got["stem_dw"] != 3 * steps:
                fail(f"{algorithm}: {got} in {steps} local steps, not "
                     "fused_sgd 2 and stem_dw 3 a step")
            if got["kth_select"] or got["count_ge"]:
                fail(f"{algorithm} launched the top-k kernels: {got}")
            # one more round under sync debug mode: the port's lines that
            # synchronized with the host (FedFomo reads p_choose once)
            if algorithm == "dpsgd":
                syncs = hidden_syncs(lambda: engine.run_round(
                    2, result["personal_params"],
                    result["personal_batch_stats"], engine.mixing_matrix(2)))
            elif algorithm == "fedfomo":
                syncs = hidden_syncs(lambda: engine.run_round(
                    2, result["personal_params"],
                    result["personal_batch_stats"], result["weights"],
                    result["p_choose"]))
                out["expected_sync"] = fomo_read
                out["unexpected_syncs"] = [x for x in syncs
                                           if x != fomo_read]
            else:
                syncs = hidden_syncs(lambda: engine.run_round(
                    2, result["params"], result["batch_stats"],
                    engine.client_sampling(2)))
                # the share stage against FedAvg's plain weighted mean, on
                # the aggregate model stacked for 3 clients
                S = len(engine.client_sampling(0))
                stacked = {k: torch.stack([v] * S) / S
                           for k, v in result["params"].items()}
                w = torch.ones(S, device=dev)
                out["mpc_ms"], out["mpc_host_ms"] = time_ms(
                    lambda: engine.secure_aggregate(stacked), 5)
                out["plain_aggregate_ms"], _ = time_ms(
                    lambda: engine.aggregate([result["params"]] * S, w), 5)
                out["mpc_clients"] = S
            out["sync_warnings"] = syncs
            print(json.dumps(out))
            del engine, result
            free_card()

        # Adam: unfused (no fused_sgd launch), and refused with the flag
        acfg = flagship("fedavg", "--frac", "0.75", "--client_optimizer",
                        "adam", "--comm_round", "1", fused=False)
        engine, _ = build_experiment(acfg, "cuda")
        steps = local_steps(engine)
        _cuda.reset_counts()
        result = engine.train()
        torch.cuda.synchronize()
        got = _cuda.counts()
        by_path["fedavg_adam"] = got
        losses = [h["train_loss"] for h in result["history"]]
        print(json.dumps({"engine": "fedavg", "client_optimizer": "adam",
                          "card": card, "launches": got,
                          "local_steps": steps, "train_loss": losses,
                          "round_seconds": result["round_seconds"],
                          "finetune_seconds": result["finetune_seconds"],
                          "final_personal": result["final_personal"]}))
        if got["fused_sgd"] or got["stem_dw"] != 3 * steps:
            fail(f"fedavg with adam: {got} in {steps} local steps, not "
                 "fused_sgd 0 and stem_dw 3 a step")
        if not all(math.isfinite(v) for v in losses):
            fail(f"fedavg with adam: non-finite losses {losses}")
        del engine, result
        free_card()
        refused = False
        try:
            LocalOptimizer(flagship("fedavg", "--client_optimizer",
                                    "adam").optim)
        except ValueError:
            refused = True
        if not refused:
            fail("--client_optimizer adam --fused_update was not refused")
        refused = False
        try:
            with contextlib.redirect_stderr(io.StringIO()):  # its usage
                cli(["--client_optimizer", "adam", "--fused_update"])
        except SystemExit as e:
            refused = e.code != 0
        if not refused:
            fail("the CLI did not refuse --client_optimizer adam "
                 "--fused_update")

        lap("engines")

        # ---- the streamed feed at full width (--streaming) ----
        stream_phase(card, dev, flagship, build_experiment, synthetic,
                     resident, by_path)
        lap("stream")

        # ---- the model zoo, bf16_mixed, memory, cuDNN's determinism ----
        zoo_precision_phase(card, dev, flagship, build_experiment, resident,
                            by_path)
        lap("zoo_precision")

        # ---- the 2D vision path: the CIFAR sweep and the 2D zoo ----
        vision_phase(card, dev, build_experiment, by_path)
        lap("vision")

        # ---- the DARTS family: the CIFAR sweep on darts, the drivers ----
        darts_phase(card, dev, build_experiment, by_path)
        lap("darts")

        # ---- the defended tail: attacks, defenses, codec, DP, crashes ----
        defense_phase(card, dev, build_experiment, by_path, rows, time_ms)
        lap("defense")

        # ---- secure quantized aggregation: the GF(p) fold ----
        secure_phase(card, build_experiment, by_path)
        lap("secure")

        # ---- round programs and dispatch: windows, CUDA graphs, mesh ----
        dispatch_phase(card, dev, flagship, build_experiment, by_path)
        lap("dispatch")

        # ---- the slice on a small input: kernels against plain paths ----
        def small(kernels: bool, algorithm: str = "salientgrads",
                  streaming: bool = False):
            os.environ["NIDT_FAST_STEM"] = "1" if kernels else "0"
            argv = ["--algorithm", algorithm, "--dataset", "synthetic",
                    "--synthetic_shape", "69", "69", "69",
                    "--synthetic_num_subjects", "24",
                    "--client_num_in_total", "4", "--batch_size", "4",
                    "--epochs", "1", "--comm_round", "2",
                    *ENGINE_ARGS.get(algorithm, ())]
            if kernels:
                argv.append("--fused_update")
            if streaming:
                argv += ["--stream_chunk_clients", str(STREAM_CHUNK)]
            return build_experiment(config_from_args(
                add_args(argparse.ArgumentParser()).parse_args(argv)),
                "cuda", streaming=streaming)[0]

        # cuDNN's default algorithms are not reproducible from run to run:
        # two plain FedProx or Ditto runs here differed by up to 1.6e-2 of
        # the largest weight change (scripts/torch_small_spread.py). With
        # its deterministic algorithms (the port's default since they cost
        # nothing measurable: device.py) each path repeats bit for bit, so
        # the runs below differ by the kernels alone.
        det0 = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        per_call = PerCallCheck()
        probe = small(True)
        init_p, init_b = probe.init_global_state()
        masks, _ = probe.generate_global_mask(init_p, init_b)
        # fresh engines under one mask draw the same permutations and
        # dropout: the runs differ in the stem dW's summation order and,
        # where the clip is taken, in the global norm's (fused_sgd is
        # bit-equal to the plain chain only where the clip is not taken)
        plain = small(False).train(masks=masks)
        with per_call:
            kern = small(True).train(masks=masks)
        calls = per_call.check("salientgrads small input")
        # the same run streamed a chunk of STREAM_CHUNK clients at a time
        streamed = small(True, streaming=True).train(masks=masks)
        if not streamed_bit_equal(streamed, kern):
            fail("small-input streamed SalientGrads differs from its "
                 "resident run")
        moved = max(float((v - init_p[k]).abs().max())
                    for k, v in plain["params"].items())
        p_err = max(float((kern["params"][k] - v).abs().max())
                    for k, v in plain["params"].items())
        lp = [h["train_loss"] for h in plain["history"]]
        lk = [h["train_loss"] for h in kern["history"]]
        ep, ek = plain["final_global"]["loss"], kern["final_global"]["loss"]
        print(json.dumps({"small_input_check": {
            "shape": [69, 69, 69], "train_loss_plain": lp,
            "train_loss_kernels": lk, "eval_loss_plain": ep,
            "eval_loss_kernels": ek, "param_max_abs_err": p_err,
            "largest_weight_change": moved, "per_call": calls}}))
        if not all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lk, lp)):
            fail(f"small-input train losses differ: {lk} vs plain {lp}")
        if not p_err <= 1e-3 * moved:
            fail(f"small-input params differ by {p_err} (largest weight "
                 f"change {moved})")
        if not abs(ek - ep) <= 1e-3 * abs(ep):
            fail(f"small-input eval loss {ek} vs plain {ep}")

        def dense_states(res: dict) -> dict:
            """A dense engine's result: its global model (where it has one)
            and every client's personal model, by name."""
            out = {}
            if "params" in res or "global_params" in res:
                out["global"] = res.get("params", res.get("global_params"))
            per = (res["personal_params"] if "personal_params" in res
                   else res["personal"]["params"])
            out.update({f"personal {c}": st for c, st in enumerate(per)})
            return out

        # FedProx (with its fine-tune), Ditto (both tracks), D-PSGD,
        # FedFomo and TurboAggregate (with its fine-tune) on the small
        # input: through the kernels and through the plain paths. Their runs
        # chain several steps a client, and where a ReLU input lies
        # within fp32 rounding of 0 the kernels' rounding flips the unit:
        # held at the tolerances of tests/torch_port_support.py TRAJECTORY
        # (weights 5e-2 of the largest change, eval loss rtol 2e-2), train
        # losses rtol 1e-4
        for algorithm in ("fedprox", "ditto", "dpsgd", "fedfomo",
                          "turboaggregate"):
            plain_eng = small(False, algorithm)
            init_p, _ = plain_eng.init_global_state()
            plain = plain_eng.train()
            per_call.reset()
            with per_call:
                kern = small(True, algorithm).train()
            calls = per_call.check(f"{algorithm} small input")
            # the kernels' run once more: bit for bit the same
            again = dense_states(small(True, algorithm).train())
            if not all(torch_equal_bits(v, again[name][k])
                       for name, st in dense_states(kern).items()
                       for k, v in st.items()):
                fail(f"{algorithm} small input: two runs through the kernels "
                     "differ")
            ks, ps = dense_states(kern), dense_states(plain)
            pairs = {name: (ks[name], ps[name]) for name in ps}
            moved = max(float((v - init_p[k]).abs().max())
                        for st in (pr[1] for pr in pairs.values())
                        for k, v in st.items())
            p_err = max(float((a[k] - v).abs().max())
                        for a, b in pairs.values() for k, v in b.items())
            lp = [h["train_loss"] for h in plain["history"]]
            lk = [h["train_loss"] for h in kern["history"]]
            which = ("final_personal" if "final_personal" in plain
                     else "final_global")
            ep, ek = plain[which]["loss"], kern[which]["loss"]
            print(json.dumps({"small_input_check": {
                "engine": algorithm, "shape": [69, 69, 69],
                "train_loss_plain": lp, "train_loss_kernels": lk,
                "eval": which, "eval_loss_plain": ep,
                "eval_loss_kernels": ek,
                "param_max_abs_err": p_err, "states": sorted(pairs),
                "largest_weight_change": moved, "per_call": calls}}))
            if not all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lk, lp)):
                fail(f"{algorithm} small-input train losses differ: {lk} vs "
                     f"plain {lp}")
            if not p_err <= 5e-2 * moved:
                fail(f"{algorithm} small-input params differ by {p_err} "
                     f"(largest weight change {moved})")
            if not abs(ek - ep) <= 2e-2 * abs(ep):
                fail(f"{algorithm} small-input {which} eval loss {ek} vs "
                     f"plain {ep}")

        # Sub-FedAvg and DisPFL on the small input: through the kernels and
        # through the plain paths, each path twice bit for bit. A weight
        # within the runs' difference of a prune threshold or a fire/regrow
        # cut lands on either side, so the masks are compared entry by
        # entry and the weights on the entries whose support agrees
        for algorithm in ("subavg", "dispfl"):
            plain_eng = small(False, algorithm)
            init_p, _ = plain_eng.init_global_state()
            plain = plain_eng.train()
            per_call.reset()
            with per_call:
                kern = small(True, algorithm).train()
            calls = per_call.check(f"{algorithm} small input")
            again = small(True, algorithm).train()
            if algorithm == "dispfl":
                streamed = small(True, algorithm, streaming=True).train()
                if not streamed_bit_equal(streamed, again):
                    fail("small-input streamed DisPFL differs from its "
                         "resident run")
            gap = sparse_gap(algorithm, kern, plain, init_p)
            key = "params" if algorithm == "subavg" else "personal_params"
            states = [kern[key]] if algorithm == "subavg" else kern[key]
            states2 = [again[key]] if algorithm == "subavg" else again[key]
            if (sparse_gap(algorithm, again, kern, init_p)["differ"]
                    or not all(torch_equal_bits(v, b[k])
                               for a, b in zip(states, states2)
                               for k, v in a.items())):
                fail(f"{algorithm} small input: two runs through the "
                     "kernels differ")
            lp = [h["train_loss"] for h in plain["history"]]
            lk = [h["train_loss"] for h in kern["history"]]
            ep = plain["final_personal"]["loss"]
            ek = kern["final_personal"]["loss"]
            print(json.dumps({"small_input_check": {
                "engine": algorithm, "shape": [69, 69, 69],
                "train_loss_plain": lp, "train_loss_kernels": lk,
                "personal_eval_loss_plain": ep,
                "personal_eval_loss_kernels": ek, **gap,
                "per_call": calls}}))
            if not gap["mask_diff_share"] <= SPARSE_MASK_SHARE[algorithm]:
                fail(f"{algorithm} small input: {gap['mask_diff_share']} of "
                     f"the mask entries differ, over "
                     f"{SPARSE_MASK_SHARE[algorithm]}")
            if not gap["param_err_over_change"] <= 5e-2:
                fail(f"{algorithm} small-input params differ by "
                     f"{gap['param_err_over_change']} of the largest weight "
                     "change where the masks agree, over 5e-2")
            if not abs(lk[0] - lp[0]) <= 1e-4 * abs(lp[0]):
                fail(f"{algorithm} small-input first-round train loss "
                     f"{lk[0]} vs plain {lp[0]}")
            if not abs(ek - ep) <= 2e-2 * abs(ep):
                fail(f"{algorithm} small-input personal eval loss {ek} vs "
                     f"plain {ep}")
        torch.backends.cudnn.deterministic = det0
        lap("small input")
    return finish(rows, by_path, started, laps)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
