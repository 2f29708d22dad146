"""Handler-registry client and server managers, the control plane's event
loops (the reference package's ``distributed/managers.py``).

A manager owns a transport, takes ``register_message_receive_handler(
msg_type, fn)``, runs a receive loop that dispatches by message type, and
``finish()`` stops the loop.
"""

from __future__ import annotations

from typing import Callable

from neuroimagedisttraining_tpu_torch.distributed.comm import (
    BaseCommManager, Observer, SocketCommManager,
)
from neuroimagedisttraining_tpu_torch.distributed.message import Message


class DistributedManager(Observer):
    """The common base of ``ClientManager`` and ``ServerManager`` (only
    their registered handlers differ)."""

    def __init__(self, rank: int, world_size: int,
                 comm: BaseCommManager | None = None,
                 host_map: dict[int, str] | None = None,
                 base_port: int | None = None):
        kw = {} if base_port is None else {"base_port": base_port}
        self.rank = rank
        self.world_size = world_size
        self.com_manager = comm or SocketCommManager(rank, world_size,
                                                     host_map=host_map, **kw)
        self.com_manager.add_observer(self)
        self._handlers: dict[str, Callable[[Message], None]] = {}

    def register_message_receive_handler(
            self, msg_type: str, handler: Callable[[Message], None]) -> None:
        self._handlers[msg_type] = handler

    def receive_message(self, msg_type: str, msg: Message) -> None:
        handler = self._handlers.get(msg_type)
        if handler is None:
            raise KeyError(
                f"rank {self.rank}: no handler for message type "
                f"{msg_type!r} (have {sorted(self._handlers)})")
        handler(msg)

    def send_message(self, msg: Message) -> None:
        self.com_manager.send_message(msg)

    def run(self) -> None:
        """Register the handlers, then dispatch until ``finish()``."""
        self.register_message_receive_handlers()
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        self.com_manager.stop_receive_message()


class ClientManager(DistributedManager):
    pass


class ServerManager(DistributedManager):
    pass
