"""Serving plane (the reference package's ``serve/``): the checkpoint ->
bundle contract, micro-batched inference with one CUDA graph per model and
bucket, per-site model routing, and the ``SO_REUSEPORT`` HTTP front end.

``bundle`` owns the versioned deployment artifact, ``engine`` the captured
forward programs and the micro-batcher, ``worker`` the per-process HTTP
listener, and ``server`` the root that spawns, audits and fans in the
worker fleet. ``python -m neuroimagedisttraining_tpu_torch.serve`` is the
operator CLI.
"""

from neuroimagedisttraining_tpu_torch.serve.bundle import (  # noqa: F401
    BundleError,
    ServeBundle,
    build_bundle,
    load_bundle,
)
from neuroimagedisttraining_tpu_torch.serve.engine import (  # noqa: F401
    ServeEngine,
)


def __getattr__(name):
    # server pulls in the multiprocessing stack; bundle and engine stay
    # importable without it
    if name == "ShardedServeServer":
        from neuroimagedisttraining_tpu_torch.serve.server import (
            ShardedServeServer)
        return ShardedServeServer
    raise AttributeError(name)
