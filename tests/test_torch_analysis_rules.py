"""The port's per-file rule families of ``analysis/`` (async, lock, shm,
determinism, privacy, health, engine contract, round program, trace
safety, obs, mesh and precision discipline) on source snippets written in
the port's idiom: the reference's ``tests/test_analysis.py`` cases carried
over (each family flagged and clean), the torch counterparts of the
privacy rule and of "inside a traced body" (inside a captured step: a
``StepGraph`` body, a ``torch.cuda.graph`` block and their resolvable
callees), the pragma mechanics on the new ids, the CLI's ``--list-rules``
and its exit codes, and each family's ids and messages against the
reference's on the same snippets."""

import textwrap

import pytest

from neuroimagedisttraining_tpu.analysis import lint_source as ref_lint
from neuroimagedisttraining_tpu_torch.analysis import all_rule_ids
from neuroimagedisttraining_tpu_torch.analysis import lint_source
from neuroimagedisttraining_tpu_torch.analysis.cli import main as cli_main

PORT = "neuroimagedisttraining_tpu_torch"
ASYNCFL = f"{PORT}/asyncfl/loadgen.py"
FAMILIES = {"async-blocking-call", "async-queue-get", "lock-send",
            "lock-shared-map", "shm-owner-teardown", "shm-attach-unlink",
            "determinism-global-random", "determinism-unseeded-rng",
            "dp-key-discipline", "health-metric-literal"}
#: the families whose torch counterparts check captured steps, the engine
#: contract and the round program
STEP_FAMILIES = {"engine-attrs", "engine-round", "engine-signature",
                 "round-program-fused-body", "round-program-reason",
                 "trace-host-sync", "trace-np-random", "obs-clock-in-trace",
                 "obs-metrics-in-trace", "obs-sync-in-trace",
                 "obs-trace-ctx-key", "obs-pipe-per-upload",
                 "mesh-pad-weights", "precision-upcast"}
#: of those, the ones whose findings and messages carry over unchanged
SAME_AS_REFERENCE = {"engine-round", "engine-signature",
                     "round-program-reason", "obs-trace-ctx-key",
                     "mesh-pad-weights"}
ENGINE = f"{PORT}/engines/mod.py"
INGEST = f"{PORT}/asyncfl/ingest.py"
MESSAGE = f"{PORT}/distributed/message.py"


def lint(src, path="pkg/mod.py", rules=None):
    return lint_source(textwrap.dedent(src), path=path, rules=rules)


def rules_of(findings):
    return [f.rule for f in findings]


def test_families_registered_with_reference_ids():
    ids = set(all_rule_ids())
    assert FAMILIES | STEP_FAMILIES <= ids
    # shard_map's spec rule is JAX-only: the port has no shard_map
    assert "mesh-shardmap-specs" not in ids


# ---------------- async discipline ----------------


def test_async_blocking_calls_flagged_in_asyncfl():
    fs = lint("""
        import time
        import select

        async def drive(sock):
            time.sleep(0.1)
            select.select([sock], [], [])
            sock.recv(4)
            sock.accept()
        """, path=ASYNCFL, rules=["async-blocking-call"])
    assert rules_of(fs) == ["async-blocking-call"] * 4
    assert "freezes every coroutine" in fs[0].message


def test_async_awaited_and_nested_sync_bodies_pass():
    assert lint("""
        import asyncio
        import time

        async def drive(loop, sock):
            await asyncio.sleep(0.1)
            data = await loop.sock_recv(sock, 4)

            def off_loop():
                time.sleep(1)
                return sock.recv(4)
            return await loop.run_in_executor(None, off_loop)
        """, path=ASYNCFL, rules=["async-blocking-call"]) == []


def test_async_rules_scoped_to_asyncfl_and_sync_defs_exempt():
    src = """
        import time

        def sync_helper():
            time.sleep(1)

        async def drive(sock):
            time.sleep(1)
        """
    assert lint(src, path=f"{PORT}/distributed/x.py",
                rules=["async-blocking-call"]) == []
    fs = lint(src, path=ASYNCFL, rules=["async-blocking-call"])
    assert len(fs) == 1 and fs[0].line == 8


def test_async_nested_coroutine_violation_reported_once():
    fs = lint("""
        import time

        async def outer():
            async def inner():
                time.sleep(1)
            return inner
        """, path=ASYNCFL, rules=["async-blocking-call"])
    assert rules_of(fs) == ["async-blocking-call"]
    assert "inner" in fs[0].message


def test_async_queue_get_flagged_dict_get_passes():
    fs = lint("""
        async def drain(q, d):
            item = q.get()
            known = d.get("key")
            timed = q.get(timeout=0.1)
            nonblock = q.get(block=False)
        """, path=ASYNCFL, rules=["async-queue-get"])
    assert rules_of(fs) == ["async-queue-get"]
    assert fs[0].line == 3


# ---------------- lock discipline ----------------


def test_lock_flags_unlocked_send_under_distributed_faults_asyncfl():
    src = """
        def relay(conn, payload):
            conn.sendall(payload)
        """
    for pkg in ("distributed", "faults", "asyncfl"):
        assert rules_of(lint(src, path=f"{PORT}/{pkg}/t.py")) == \
            ["lock-send"], pkg
    assert lint(src, path=f"{PORT}/engines/t.py") == []


def test_lock_covers_the_ingest_worker_pipe():
    fs = lint("""
        class Worker:
            def reply(self, conn, verdict):
                conn.send(("vb", verdict))
        """, path=f"{PORT}/asyncfl/ingest.py", rules=["lock-send"])
    assert rules_of(fs) == ["lock-send"]


def test_lock_flags_unlocked_shared_map_mutations():
    fs = lint("""
        class Broker:
            def register(self, topic, conn, payload):
                self._subs.setdefault(topic, []).append(conn)
                self._retained[topic] = payload
        """, path=f"{PORT}/distributed/broker2.py")
    assert rules_of(fs) == ["lock-shared-map", "lock-shared-map"]


def test_lock_satisfied_inside_with_lock():
    assert lint("""
        class Broker:
            def register(self, topic, conn, payload):
                with self._lock:
                    self._subs.setdefault(topic, []).append(conn)
                    self._retained[topic] = payload
                with self._wlocks[conn]:
                    conn.sendall(payload)
        """, path=f"{PORT}/distributed/broker2.py") == []


def test_lock_with_header_mutation_is_flagged():
    fs = lint("""
        import threading

        class Broker:
            def serve(self, conn, payload):
                with self._wlocks.setdefault(conn, threading.Lock()):
                    conn.sendall(payload)
        """, path=f"{PORT}/distributed/t.py")
    assert rules_of(fs) == ["lock-shared-map"]


def test_lock_nested_def_does_not_inherit_lock():
    fs = lint("""
        def serve(self, conn):
            with self._lock:
                def later():
                    conn.sendall(b"x")  # runs after the with exits
                return later
        """, path=f"{PORT}/distributed/t.py")
    assert rules_of(fs) == ["lock-send"]


# ---------------- shm discipline ----------------


def test_shm_owner_must_close_and_unlink():
    src = """
        from multiprocessing import shared_memory

        class LeakyWriter:
            def __init__(self, size):
                self.shm = shared_memory.SharedMemory(create=True,
                                                      size=size)

            def destroy(self):
                self.shm.close()
        """
    assert rules_of(lint(src)) == ["shm-owner-teardown"]
    assert rules_of(lint("""
        from multiprocessing import shared_memory

        class VeryLeakyWriter:
            def __init__(self, size):
                self.shm = shared_memory.SharedMemory(create=True,
                                                      size=size)
        """)) == ["shm-owner-teardown"] * 2


def test_shm_attacher_must_never_unlink():
    assert rules_of(lint("""
        from multiprocessing import shared_memory

        class GreedyReader:
            def __init__(self, name):
                self.shm = shared_memory.SharedMemory(name=name)

            def close(self):
                self.shm.close()
                self.shm.unlink()
        """)) == ["shm-attach-unlink"]


def test_shm_clean_lifecycles_and_aliases():
    assert lint("""
        import multiprocessing.shared_memory as sm

        class Writer:
            def __init__(self, size):
                self.shm = sm.SharedMemory(None, True, size)

            def destroy(self):
                self.shm.close()
                self.shm.unlink()

        class Reader:
            def __init__(self, name):
                self.shm = sm.SharedMemory(name=name)

            def close(self):
                self.shm.close()
        """) == []


# ---------------- determinism ----------------


def test_determinism_flags_global_stream_and_unseeded_rng():
    fs = lint("""
        import numpy as np

        def sample(n):
            np.random.seed(0)
            idx = np.random.choice(n, 2)
            g = np.random.default_rng()
            r = np.random.RandomState()
            return idx, g, r
        """)
    assert rules_of(fs) == ["determinism-global-random",
                            "determinism-global-random",
                            "determinism-unseeded-rng",
                            "determinism-unseeded-rng"]


def test_determinism_allows_seeded_generators_and_torch_streams():
    assert lint("""
        import numpy as np
        import torch

        def sample(seed, n):
            rs = np.random.RandomState(seed)
            rng = np.random.default_rng(seed + 1)
            gen = torch.Generator().manual_seed(seed)
            return rs.permutation(n), rng.integers(0, n), torch.randn(
                3, generator=gen)
        """) == []


def test_determinism_pragma_and_id_granularity():
    src = "import numpy as np\nnp.random.seed(1)\n"
    assert lint_source(src, rules=["determinism-unseeded-rng"]) == []
    assert rules_of(lint_source(src, rules=[
        "determinism-global-random"])) == ["determinism-global-random"]
    assert lint("""
        import numpy as np

        np.random.seed(0)  # nidt: allow[determinism-global-random] -- reference-parity shim (fedavg_api.py:92-100)
        """) == []
    fs = lint("""
        import numpy as np

        np.random.seed(0)  # nidt: allow[determinism-global-random]
        """)
    assert rules_of(fs) == ["pragma"]


# ---------------- privacy discipline (the torch counterparts) ----------


@pytest.mark.parametrize("root", [
    "torch.Generator(device=dev).manual_seed(7)",
    "torch.manual_seed(7)",
    "Generator()",
])
def test_privacy_flags_stream_roots_minted_in_privacy(root):
    src = f"""
        import torch
        from torch import Generator

        def noise(shape, dev):
            g = {root}
            return torch.randn(shape, generator=g)
        """
    fs = lint(src, path=f"{PORT}/privacy/noise.py")
    assert rules_of(fs) == ["dp-key-discipline"]
    assert "privacy/" in fs[0].message
    # outside privacy/ a generator made at the call site is the idiom
    assert lint(src, path=f"{PORT}/engines/noise.py") == []


def test_privacy_threaded_generator_passes():
    assert lint("""
        import torch

        def noise(shape, gen):
            return torch.randn(shape, generator=gen)
        """, path=f"{PORT}/privacy/noise.py") == []


@pytest.mark.parametrize("call", [
    "robust.add_weak_dp_noise(p, {k: torch.randn_like(v) for k, v in "
    "p.items()}, 0.05)",
    "add_weak_dp_noise(p, noise={k: torch.normal(0.0, 1.0, v.shape) for k, "
    "v in p.items()}, stddev=0.05)",
])
def test_privacy_flags_inline_weak_dp_noise(call):
    fs = lint(f"""
        import torch
        from neuroimagedisttraining_tpu_torch.core import robust
        from neuroimagedisttraining_tpu_torch.core.robust import (
            add_weak_dp_noise,
        )

        def defend(p):
            return {call}
        """, path=f"{PORT}/engines/t.py")
    assert rules_of(fs) == ["dp-key-discipline"]
    assert "noise_draws" in fs[0].message


def test_privacy_weak_dp_noise_from_noise_draws_passes():
    assert lint("""
        from neuroimagedisttraining_tpu_torch.core import robust

        def defend(p, seed, r, c, dev):
            noise = robust.noise_draws(seed, "weak_dp", r, c, p, dev)
            return robust.add_weak_dp_noise(p, noise, 0.05)
        """, path=f"{PORT}/engines/t.py") == []


# ---------------- health discipline ----------------


def test_health_metric_literal_fires_outside_obs():
    fs = lint_source(
        'from neuroimagedisttraining_tpu_torch.obs import metrics as m\n'
        'g = m.gauge("nidt_health_cosine_min", "h")\n',
        path=f"{PORT}/engines/whatever.py")
    assert rules_of(fs) == ["health-metric-literal"]


def test_health_metric_literal_clean_cases():
    assert not lint_source('x = "the nidt_mfu gauge"\n',
                           path=f"{PORT}/engines/whatever.py")
    assert not lint_source(
        'from neuroimagedisttraining_tpu_torch.obs import names as n\n'
        'name = n.MFU + "_bucket"\n', path=f"{PORT}/engines/whatever.py")
    assert not lint_source('g = ("nidt_mfu",)\n',
                           path=f"{PORT}/obs/compute.py")


# ------------- the same ids and messages as the reference's -------------


# ---------------- trace safety (captured steps) ----------------


def test_trace_flags_host_sync_in_step_graph_body():
    fs = lint("""
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def build(dev, gen, x):
            def body():
                return float(x) + x.item()
            return StepGraph(body, dev, gen)
        """, rules=["trace-host-sync"])
    assert rules_of(fs) == ["trace-host-sync", "trace-host-sync"]


def test_trace_resolves_body_keyword_lambda_and_self_method():
    fs = lint("""
        import torch
        from neuroimagedisttraining_tpu_torch.core import graphs

        class Trainer:
            def _step(self):
                torch.cuda.synchronize()
                return self.x.cpu()

            def build(self, dev):
                a = graphs.StepGraph(self._step, dev, None)
                b = graphs.StepGraph(device=dev, generator=None,
                                     body=lambda: self.x.tolist())
                return a, b
        """, rules=["trace-host-sync"])
    assert rules_of(fs) == ["trace-host-sync"] * 3


def test_trace_resolves_self_alias_and_transitive_callees():
    """A step that reaches its trainer through ``weakref.proxy(self)``
    (``core/trainer.py``'s idiom) traces the methods it calls, and a bare
    helper called from there too."""
    fs = lint("""
        import weakref
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def helper(t):
            return t.numpy()

        class Trainer:
            def _loss(self, x):
                return helper(x)

            def _graph(self, dev, x):
                tr = weakref.proxy(self)

                def body():
                    return tr._loss(x)
                return StepGraph(body, dev, None)
        """, rules=["trace-host-sync"])
    assert rules_of(fs) == ["trace-host-sync"]
    assert fs[0].line == 6


def test_trace_flags_torch_cuda_graph_block_and_np_random():
    fs = lint("""
        import numpy as np
        import torch

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * np.random.rand()
                z = y.item()
            return y, z
        """, rules=["trace-host-sync", "trace-np-random"])
    assert rules_of(fs) == ["trace-np-random", "trace-host-sync"]


def test_trace_ignores_host_code_and_literals():
    assert lint("""
        import torch
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def build(dev, x):
            def body():
                return x * float(2) + int("3")
            return StepGraph(body, dev, None)

        def host_driver(g):
            out = g()                # a replay is fine
            torch.cuda.synchronize()
            return float(out[0].item())
        """, rules=["trace-host-sync", "trace-np-random"]) == []


# ---------------- engine contract ----------------


def test_engine_missing_name_and_round_method():
    fs = lint("""
        from neuroimagedisttraining_tpu_torch.engines.base import (
            FederatedEngine,
        )

        class BadEngine(FederatedEngine):
            pass
        """, path=ENGINE)
    assert sorted(rules_of(fs)) == ["engine-attrs", "engine-round"]


def test_engine_signature_mismatch_against_base():
    fs = lint("""
        from neuroimagedisttraining_tpu_torch.engines.base import (
            FederatedEngine,
        )

        class SigEngine(FederatedEngine):
            name = "sig"

            def __init__(self, cfg, data, trainer, perms_for=None,
                         hook=None, stream=None, mesh=None):
                pass

            def train(self, extra):
                return {}

            def client_sampling(self, idx):  # base: (self, round_idx)
                return idx
        """, path=ENGINE)
    assert rules_of(fs) == ["engine-signature"] * 2


def test_engine_inherited_train_but_own_name_required():
    fs = lint("""
        from neuroimagedisttraining_tpu_torch.engines.base import (
            FederatedEngine,
        )

        class MidEngine(FederatedEngine):
            name = "mid"

            def train(self):
                return {}

        class LeafEngine(MidEngine):
            pass  # inherits train, but its name would collide
        """, path=ENGINE)
    assert rules_of(fs) == ["engine-attrs"]
    assert "name" in fs[0].message


def test_engine_compliant_subclass_and_other_classes_clean():
    assert lint("""
        from neuroimagedisttraining_tpu_torch.engines.base import (
            FederatedEngine,
        )

        class GoodEngine(FederatedEngine):
            name = "good"

            def __init__(self, cfg, data, trainer, perms_for=None,
                         stream=None, mesh=None, hook=None):
                pass

            def train(self):
                return {}

            def eval_global(self, params, bstats, split="test"):
                return {}

        class Helper:
            def client_sampling(self):
                return 0
        """, path=ENGINE) == []


# ---------------- round program ----------------


_ROUND_ENGINE = """
    from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph
    from neuroimagedisttraining_tpu_torch.engines.base import (
        FederatedEngine,
    )

    class E(FederatedEngine):
        name = "e"

        def train(self):
            pass

        def {meth}(self, ids, dev):
            X, y, n = self.stream.get_window(ids)
            self.stream.prefetch_window(ids)
            return StepGraph(lambda: X, dev, None)
    """


def test_round_program_flags_hand_rolled_window():
    fs = lint(_ROUND_ENGINE.format(meth="_fused_window"), path=ENGINE,
              rules=["round-program-fused-body"])
    assert rules_of(fs) == ["round-program-fused-body"] * 3
    assert "RoundProgram" in fs[0].message


def test_round_program_allows_builder_and_other_methods():
    # the builder itself is exempt by file
    assert lint(_ROUND_ENGINE.format(meth="stream_window"),
                path=f"{PORT}/engines/program.py",
                rules=["round-program-fused-body"]) == []
    # a method that is not a round, fused or window method may capture
    assert lint(_ROUND_ENGINE.format(meth="_scores"), path=ENGINE,
                rules=["round-program-fused-body"]) == []
    # and outside an engine class nothing is fenced
    assert lint("""
        def run_window(stream, ids):
            return stream.get_window(ids)
        """, path=ENGINE, rules=["round-program-fused-body"]) == []


def test_round_program_reason_must_be_table_key():
    base = """
        from neuroimagedisttraining_tpu_torch.engines.base import (
            FederatedEngine,
        )

        class E(FederatedEngine):
            name = "e"

            def train(self):
                pass

            def fused_fallback_key(self):
                return {key}
        """
    fs = lint(base.format(key="'my ad-hoc reason string'"), path=ENGINE,
              rules=["round-program-reason"])
    assert rules_of(fs) == ["round-program-reason"]
    for ok in ("'mpc-host-stage'", "None"):
        assert lint(base.format(key=ok), path=ENGINE,
                    rules=["round-program-reason"]) == []


def test_round_program_reason_keys_parse_from_the_port_source():
    from neuroimagedisttraining_tpu_torch.analysis.round_program import (
        _reason_keys,
    )
    from neuroimagedisttraining_tpu_torch.engines.program import REASONS

    assert _reason_keys() == set(REASONS)


# ---------------- obs discipline ----------------


def test_obs_clock_in_captured_step_flagged():
    fs = lint("""
        import time
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def build(dev, x):
            def body():
                t0 = time.perf_counter()
                return x + time.monotonic() - t0
            return StepGraph(body, dev, None)
        """, rules=["obs-clock-in-trace"])
    assert rules_of(fs) == ["obs-clock-in-trace"] * 2
    assert "never at a replay" in fs[0].message


def test_obs_clock_aliased_import_in_lambda_and_host_pass():
    fs = lint("""
        import time
        from time import perf_counter
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def build(dev, x):
            return StepGraph(lambda: x * perf_counter(), dev, None)

        def driver(g):
            t0 = time.perf_counter()
            y = g()
            return y, time.perf_counter() - t0
        """, rules=["obs-clock-in-trace"])
    assert rules_of(fs) == ["obs-clock-in-trace"]
    assert fs[0].line == 7


def test_obs_metrics_mutation_in_step_and_transitive_callee():
    fs = lint("""
        import torch
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph
        from neuroimagedisttraining_tpu_torch.obs import metrics as om

        COUNTER = om.counter("x_total")

        def note(h, v):
            h.observe(v)

        def build(dev, h, x):
            def body():
                COUNTER.inc()
                om.gauge("g").set(1)
                note(h, x)
                return x
            return StepGraph(body, dev, None)
        """, rules=["obs-metrics-in-trace"])
    assert rules_of(fs) == ["obs-metrics-in-trace"] * 3


def test_obs_indexed_set_and_host_mutation_pass():
    assert lint("""
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph
        from neuroimagedisttraining_tpu_torch.obs import metrics as om

        def build(dev, st, x):
            def body():
                return st.set(x)  # not a gauge
            return StepGraph(body, dev, None)

        def host_boundary(c):
            c.inc()
            om.gauge("g").set(2)
        """, rules=["obs-metrics-in-trace"]) == []


def test_obs_sync_in_step_flagged_and_at_boundary_passes():
    fs = lint("""
        import torch
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def wait(ev):
            ev.synchronize()

        def build(dev, ev, s, x):
            def body():
                torch.cuda.synchronize()
                s.synchronize()
                wait(ev)
                return x
            return StepGraph(body, dev, None)

        def driver(g):
            y = g()
            torch.cuda.synchronize()
            return y
        """, rules=["obs-sync-in-trace"])
    assert rules_of(fs) == ["obs-sync-in-trace"] * 3
    assert "zero-sync" in fs[0].message


def test_trace_ctx_literal_flagged_constant_and_definition_pass():
    fs = lint("""
        def stamp(msg, ctx):
            msg.add("trace_ctx", ctx)

        def read(msg):
            return msg.get("trace_ctx")
        """, rules=["obs-trace-ctx-key"])
    assert rules_of(fs) == ["obs-trace-ctx-key"] * 2
    assert "ARG_TRACE_CTX" in fs[0].message
    assert lint("""
        from neuroimagedisttraining_tpu_torch.distributed import message as M

        def stamp(msg, ctx):
            msg.add(M.ARG_TRACE_CTX, ctx)
            return msg.get("round_idx")
        """, rules=["obs-trace-ctx-key"]) == []
    assert lint("""
        ARG_TRACE_CTX = "trace_ctx"

        def demo(msg):
            return msg.get("trace_ctx")
        """, path=MESSAGE, rules=["obs-trace-ctx-key"]) == []


def test_pipe_sends_per_upload_flagged_batched_pass():
    fs = lint("""
        class W:
            def receive_message(self, msg):
                self.conn.send(("beat", self.wid, msg.sender_id))

            def per_upload(self, verdict):
                self.conn.send(("v", self.wid, verdict))
        """, path=INGEST, rules=["obs-pipe-per-upload"])
    assert rules_of(fs) == ["obs-pipe-per-upload"] * 2
    assert "batch" in fs[0].message
    assert lint("""
        class W:
            def _flush_locked(self):
                self.conn.send(("beats", self.wid, sorted(self.pend)))
                self.conn.send(("vb", self.wid, self.counts, self.taus))
                self.conn.send(("obs", self.wid, payload))
        """, path=INGEST, rules=["obs-pipe-per-upload"]) == []
    assert lint("""
        def elsewhere(conn):
            conn.send(("beat", 0, 1))
        """, rules=["obs-pipe-per-upload"]) == []


# ---------------- mesh discipline ----------------


def test_pad_weights_adhoc_mask_flagged():
    fs = lint("""
        import torch

        def weights(ns, n_real):
            return torch.where(torch.arange(ns.shape[0]) < n_real, ns, 0)
        """, path=f"{PORT}/engines/base.py", rules=["mesh-pad-weights"])
    assert rules_of(fs) == ["mesh-pad-weights"]
    assert "pad_row_weights" in fs[0].message


def test_pad_weights_helper_home_and_other_compares_pass():
    src = """
        import torch

        def pad_row_weights(ns, n_real):
            return torch.where(torch.arange(ns.shape[0]) < n_real, ns,
                               torch.zeros_like(ns))
        """
    assert lint(src, path=f"{PORT}/parallel/cohort.py",
                rules=["mesh-pad-weights"]) == []
    assert lint("""
        import torch

        def f(ns, k):
            return torch.arange(ns.shape[0]) < k, ns < 3
        """, path=ENGINE, rules=["mesh-pad-weights"]) == []


# ---------------- precision discipline ----------------


def test_precision_upcasts_in_captured_step_flagged():
    fs = lint("""
        import torch
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def build(dev, x):
            def body():
                a = x.float() + x.to(torch.float32)
                b = x.to(dev, torch.float32) + x.to(dtype=torch.float32)
                return a + b + torch.tensor(2.0, dtype=torch.float32)
            return StepGraph(body, dev, None)
        """, path=f"{PORT}/core/mod.py", rules=["precision-upcast"])
    assert rules_of(fs) == ["precision-upcast"] * 5


def test_precision_upcast_transitive_callee_flagged():
    fs = lint("""
        import torch
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def widen(x):
            return x.float()

        def build(dev, x):
            return StepGraph(lambda: widen(x) * 2, dev, None)
        """, path=f"{PORT}/models/mod.py", rules=["precision-upcast"])
    assert rules_of(fs) == ["precision-upcast"]
    assert fs[0].line == 6


def test_precision_upcast_out_of_scope_host_and_dtype_pass():
    src = """
        import torch
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def build(dev, w):
            return StepGraph(lambda: w.float(), dev, None)

        def host(x):
            return x.to(torch.float32)
        """
    # the engines' tails work on the float32 masters by contract
    assert lint(src, path=f"{PORT}/engines/mod.py",
                rules=["precision-upcast"]) == []
    assert lint("""
        import torch
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def build(dev, x, dtype):
            def body():
                return x.to(dtype) + torch.zeros(4, dtype=torch.float32)
            return StepGraph(body, dev, None)
        """, path=f"{PORT}/core/mod.py", rules=["precision-upcast"]) == []


def test_precision_upcast_pragma_suppresses_with_reason():
    assert lint("""
        from neuroimagedisttraining_tpu_torch.core.graphs import StepGraph

        def build(dev, x):
            def body():
                return x.float()  # nidt: allow[precision-upcast] -- the loss
            return StepGraph(body, dev, None)
        """, path=f"{PORT}/core/mod.py", rules=["precision-upcast"]) == []


SHARED = [
    ("pkg/asyncfl/a.py", "import time\nasync def f(s):\n    time.sleep(1)\n"
                         "    s.recv(3)\n    q = s.get()\n"),
    ("pkg/distributed/a.py", "def f(c, p):\n    c.sendall(p)\n"
                             "    self._subs.add(c)\n"),
    ("pkg/x.py", "from multiprocessing import shared_memory as s\n"
                 "class A:\n    def f(self):\n"
                 "        self.m = s.SharedMemory(create=True, size=4)\n"
                 "class B:\n    def f(self):\n"
                 "        self.m = s.SharedMemory(name='x')\n"
                 "        self.m.unlink()\n"),
    ("pkg/x.py", "import numpy as np\nnp.random.seed(0)\n"
                 "g = np.random.default_rng()\n"),
    ("pkg/engines/x.py", "n = 'nidt_rounds_total'\n"),
    ("pkg/engines/e.py", "from pkg.engines.base import FederatedEngine\n"
                         "class A(FederatedEngine):\n"
                         "    name = 'a'\n"
                         "    supports_streaming = True\n"
                         "    def client_sampling(self, idx):\n"
                         "        return 'ad hoc'\n"
                         "    def cohort_fallback_key(self):\n"
                         "        return 'ad hoc'\n"),
    ("pkg/x.py", "import numpy as np\n"
                 "def f(ns, n_real, m):\n"
                 "    m.add('trace_ctx', 1)\n"
                 "    return np.arange(ns.shape[0]) < n_real\n"),
]


@pytest.mark.parametrize("path,src", SHARED)
def test_findings_equal_reference(path, src):
    ours = [(f.line, f.rule, f.message) for f in lint_source(src, path)]
    theirs = [(f.line, f.rule, f.message) for f in ref_lint(src, path)
              if f.rule in FAMILIES | SAME_AS_REFERENCE]
    assert ours and ours == theirs


# ---------------- CLI ----------------


def test_cli_lists_families_and_exits_on_findings(tmp_path, capsys):
    assert cli_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in FAMILIES | STEP_FAMILIES:
        assert rid in listed
    bad = tmp_path / "asyncfl" / "t.py"
    bad.parent.mkdir()
    bad.write_text("import time\nasync def f():\n    time.sleep(1)\n")
    assert cli_main([str(tmp_path)]) == 1
    assert "async-blocking-call" in capsys.readouterr().out
    assert cli_main(["--rules", "lock-send", str(tmp_path)]) == 0
    capsys.readouterr()
