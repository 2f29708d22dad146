"""The asynchronous buffered control plane (the reference package's
``asyncfl/``).

The cross-silo server (``distributed/cross_silo.py``) is round-synchronous:
a deadline, a quorum and a barrier, its pace the slowest survivor's. This
package is its asynchronous counterpart:

- :mod:`asyncfl.loop`: ``SelectorCommManager``, one event-loop thread
  holding every connection (persistent or one frame a connection), with
  bounded write queues for backpressure; ``PersistentClientCommManager``,
  a silo's one kept-open connection to it.
- :mod:`asyncfl.server`: ``BufferedFedAvgServer``, FedBuff (Nguyen et al.,
  AISTATS 2022): uploads accepted continuously into a bounded buffer and
  aggregated every K arrivals with the staleness weight ``(1 + tau)^-alpha``
  on the server's device, syncs tagged with the model version, staleness
  bounded.
- :mod:`asyncfl.ingest`: the sharded ingest plane, N worker processes on
  one ``SO_REUSEPORT`` port folding uploads into exact int64 partials that
  the root merges.
- :mod:`asyncfl.region`: regional sub-aggregators between the workers and
  the root.
"""

from neuroimagedisttraining_tpu_torch.asyncfl.loop import (  # noqa: F401
    SelectorCommManager,
)
from neuroimagedisttraining_tpu_torch.asyncfl.server import (  # noqa: F401
    BufferedFedAvgServer,
    staleness_weight,
)

__all__ = ["SelectorCommManager", "BufferedFedAvgServer",
           "staleness_weight"]
