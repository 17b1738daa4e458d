"""Progress / cancellation protocol.

Reference (reference: src/progress.rs): ``ProgressMonitor`` with
``alive()`` polling (raising ``Interrupt`` to cancel), ``update(state)``
carrying a JSON payload, and ``keep_alive()`` guards.  The build polls the
monitor between device launches — cancellation is a host-side check between
jitted phases.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional


class Interrupt(Exception):
    """Raised by a monitor to cancel a build (reference: progress.rs:8-10)."""


class ProgressMonitor:
    """Base monitor: no-op (reference: impl for (), progress.rs:18-29)."""

    def alive(self) -> None:
        """Raise :class:`Interrupt` to cancel."""

    def update(self, state: Dict[str, Any]) -> None:
        """Receive a structured progress update."""

    @contextlib.contextmanager
    def keep_alive(self):
        """Scope guard around a long-running phase (progress.rs keepalive!)."""
        yield


class CallbackProgressMonitor(ProgressMonitor):
    """Adapter: wraps plain callables."""

    def __init__(self, on_update=None, is_cancelled=None):
        self._on_update = on_update
        self._is_cancelled = is_cancelled

    def alive(self) -> None:
        if self._is_cancelled is not None and self._is_cancelled():
            raise Interrupt()

    def update(self, state: Dict[str, Any]) -> None:
        if self._on_update is not None:
            self._on_update(state)
        self.alive()


def ensure_monitor(progress: Optional[ProgressMonitor]) -> ProgressMonitor:
    return progress if progress is not None else ProgressMonitor()
