"""The cross-silo control plane (the reference package's ``distributed/``):
msgpack messages (``message.py``) over TCP sockets (``comm.py``) or a
pub/sub broker (``broker.py``), handler-registry managers
(``managers.py``), the synchronous FedAvg server and silos with their
fault tolerance, defenses, wire codec and secure aggregation
(``cross_silo.py``), and the runnable federation of one OS process a rank
(``python -m neuroimagedisttraining_tpu_torch.distributed.run``)."""

from neuroimagedisttraining_tpu_torch.distributed.message import Message  # noqa: F401
from neuroimagedisttraining_tpu_torch.distributed.comm import (  # noqa: F401
    BaseCommManager, Observer, SocketCommManager,
)
from neuroimagedisttraining_tpu_torch.distributed.managers import (  # noqa: F401
    ClientManager, DistributedManager, ServerManager,
)
from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (  # noqa: F401
    FedAvgClientProc, FedAvgServer,
)
