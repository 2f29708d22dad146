"""Free-port allocation for multi-rank socket runs (the reference
package's ``distributed/ports.py``).

The socket transport listens on ``base_port + rank`` (comm.py) — a fixed
``BASE_PORT`` collides the moment two suites (or two CI shards) run on
one host. ``free_port_block`` hands out a contiguous block that is (a)
proven bindable by actually binding every port, and (b) taken from
BELOW the kernel's ephemeral port range (``ip_local_port_range``), so
an unrelated outbound connection can never transiently grab a port
inside the block between allocation and use — the failure mode of
anchoring at a kernel-assigned ephemeral port, where every short-lived
``send_message`` connection in the process draws local ports from the
same pool.

Concurrent allocators (parallel CI shards) start their scans at
pid-derived offsets and are disambiguated by the bind probe; the probe
uses plain binds (no SO_REUSEADDR) so a block still in TIME_WAIT from a
previous test is skipped rather than handed out twice.
"""

from __future__ import annotations

import itertools
import os
import socket

_SCAN_LO = 20000  # below this live well-known/registered services
_CALL_SEQ = itertools.count()


def _ephemeral_low(default: int = 32768) -> int:
    """First port of the kernel's local (outbound) port range."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return default


def _block_bindable(base: int, n: int) -> bool:
    held: list[socket.socket] = []
    try:
        for i in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", base + i))
            held.append(s)
        return True
    except OSError:
        return False
    finally:
        for s in held:
            s.close()


def free_port_block(n: int, tries: int = 256) -> int:
    """Return a base port such that ``base .. base + n - 1`` were all
    bindable a moment ago and sit outside the kernel's outbound port
    pool."""
    if n <= 0:
        raise ValueError(f"need a positive block size, got {n}")
    hi = _ephemeral_low() - n - 1
    if hi > _SCAN_LO:
        span = hi - _SCAN_LO
        start = (os.getpid() * 7919 + next(_CALL_SEQ) * (n + 3)) % span
        for i in range(tries):
            base = _SCAN_LO + (start + i * (n + 3)) % span
            if _block_bindable(base, n):
                return base
    # degenerate configuration (tiny/absent ephemeral range): fall back
    # to kernel-assigned anchors — rare enough that the transient
    # outbound-port hazard is acceptable
    for _ in range(tries):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as probe:
            probe.bind(("127.0.0.1", 0))
            base = probe.getsockname()[1]
        if base + n < 65535 and _block_bindable(base, n):
            return base
    raise RuntimeError(f"could not find {n} contiguous free ports "
                       f"in {tries} tries")
