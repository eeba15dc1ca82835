"""
Shared idle-connection reaper for the asyncio serving planes (a copy of
``ics_wt_physicsengine_tpu/utils/netreap.py``, which holds no JAX code).

Both protocol servers (modbus/slave.py, opcua/server.py) enforce their
idle / slow-loris caps the same way since round 4: handlers stamp a
per-connection activity cell when they make REAL protocol progress (a
complete frame parsed, a response drained), and one sweep per
``idle_timeout/4`` aborts transports whose cell has gone stale — zero
timer churn on the hot path (the per-read ``asyncio.wait_for`` pattern
it replaced profiled at ~35% of the event loop's non-epoll CPU).

Progress-stamping is load-bearing for the slow-loris defense: the stamp
must happen on completed frames, NOT on every received chunk — a
drip-feeding peer that never completes a frame must look idle to the
sweep so it loses its cap slot within ``idle_timeout``.

Counterpart in the reference: none (pymodbus owns its transport);
the C++ data plane enforces the same posture with poll-loop idle
tracking and a bounded write buffer (native/modbus_server.cpp).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple


class IdleReaper:
    """Per-server registry of connection activity cells.

    Single-event-loop discipline: register/stamp/pop happen on handler
    tasks, sweep on the server's main task — all one thread, no locks.
    """

    def __init__(self, idle_timeout_seconds: float,
                 log: Callable[[str], None] = lambda m: None):
        self.idle_timeout = idle_timeout_seconds
        self.sweep_every = max(0.2, idle_timeout_seconds / 4)
        self._next_sweep: float | None = None
        self._log = log
        self._conns: Dict[int, Tuple[list, object]] = {}

    def register(self, writer, now: float) -> list:
        """Track a connection; returns its activity cell (a 1-element
        list the handler updates in place on protocol progress)."""
        cell = [now]
        self._conns[id(writer)] = (cell, writer)
        return cell

    def pop(self, writer) -> None:
        self._conns.pop(id(writer), None)

    def __len__(self) -> int:
        return len(self._conns)

    def maybe_sweep(self, now: float) -> int:
        """Abort transports idle past the cap; returns how many were
        reaped. Cheap no-op between sweep deadlines."""
        if self._next_sweep is None:
            self._next_sweep = now + self.sweep_every
        if now < self._next_sweep:
            return 0
        self._next_sweep = now + self.sweep_every
        cutoff = now - self.idle_timeout
        reaped = 0
        for cell, w in list(self._conns.values()):
            if cell[0] < cutoff:
                self._log("dropping idle/slow connection")
                try:
                    w.transport.abort()
                except Exception:  # noqa: BLE001 — already-dead transport
                    pass
                reaped += 1
        return reaped
