"""Flight recorder: a bounded ring of structured control-plane events
(the reference package's ``obs/flight.py``).

The ring keeps the last N decisions of a run (alerts and their clears,
reflex actions and their dry runs, rollbacks, mesh shrinks, graph
recaptures) as records in a ``collections.deque(maxlen=N)``, so the
question "what did the run decide just before it died?" has a
machine-readable answer. ``utils/profiling.failure_context`` dumps it to
``<log_dir>/<dataset>/<identity>.flight.json`` on any fatal failure
(``--flight_events`` sets N).

One dict and one deque append under a lock an event; recording is
always on. Each event carries ``t_mono`` (monotonic, orders events in
the process) and ``t_wall`` (epoch, joins processes). ``record()`` reads
clocks: host boundaries only.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any

__all__ = ["FlightRecorder", "FLIGHT", "record", "dump", "configure",
           "clear", "events"]

DEFAULT_CAPACITY = 256


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 path: str = ""):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=int(capacity))
        self._dropped = 0  # events the ring evicted (bounded-ring honesty)
        self._seq = 0  # monotone per-event id (cross-process shipping)
        self._path = path

    def configure(self, capacity: int | None = None,
                  path: str | None = None) -> None:
        """Re-arm: ``capacity`` resizes the ring (keeping the newest
        events), ``path`` sets the default dump destination."""
        with self._lock:
            if capacity is not None and \
                    int(capacity) != self._ring.maxlen:
                old = list(self._ring)
                self._ring = collections.deque(old[-int(capacity):],
                                               maxlen=int(capacity))
            if path is not None:
                self._path = path

    @property
    def path(self) -> str:
        return self._path

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    @property
    def evicted(self) -> int:
        """Events the bounded ring has dropped."""
        with self._lock:
            return self._dropped

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event. ``fields`` must be JSON-serializable
        scalars/lists (the callers only pass ids, counts, reasons)."""
        ev = {"kind": kind, "t_mono": round(time.monotonic(), 6),
              "t_wall": round(time.time(), 6), **fields}
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def events_from(self, after_seq: int) -> tuple[list[dict], int]:
        """Incremental read for periodic shipping (``obs/fanin.py``): ring
        events with ``seq > after_seq`` plus the new watermark. Events the
        bounded ring evicted between reads are gone (``evicted`` counts
        them in the dump)."""
        with self._lock:
            evs = [e for e in self._ring if e["seq"] > int(after_seq)]
            return evs, self._seq

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0
            self._seq = 0

    def dump(self, path: str | None = None, *,
             reason: str = "") -> str | None:
        """Write ``{"reason", "capacity", "evicted", "events": [...]}``
        to ``path`` (or the configured default). Returns the path
        written, or None when neither is set — dumping must never be
        the thing that crashes the failure path, so I/O errors are
        swallowed into the return value too."""
        with self._lock:
            out = path or self._path
            if not out:
                return None
            doc = {"reason": reason, "capacity": self._ring.maxlen,
                   "evicted": self._dropped,
                   "events": list(self._ring)}
        try:
            d = os.path.dirname(out)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(out, "w") as f:
                json.dump(doc, f, default=str)
        except OSError:
            return None
        return out


#: the process-global recorder every control-plane site records into
FLIGHT = FlightRecorder()

#: module-level conveniences (instrumentation-site spelling)
record = FLIGHT.record
dump = FLIGHT.dump
configure = FLIGHT.configure
clear = FLIGHT.clear
events = FLIGHT.events
