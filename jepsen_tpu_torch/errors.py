"""Typed errors of the checker runtime.

    CheckError            base; a ValueError, so `except ValueError`
    │                     callers keep working
    ├── BackendUnavailable no usable device: no card where the caller
    │                     asked for one, or a device type the port has
    │                     no kernel for
    └── Unsupported       a history or model outside the port
                          (overlap past the deep plane, too many states,
                          an undecomposable or spec-less model, crashed
                          calls that no crash tier settles); the message
                          names the ROADMAP item that will cover it
"""

from __future__ import annotations

from typing import Any, Optional


class CheckError(ValueError):
    """Base of the error taxonomy.  `history_index` names the history
    of a batch that raised, when known; `backend` the device type."""

    def __init__(self, message: str, *,
                 history_index: Optional[int] = None,
                 backend: Optional[str] = None):
        super().__init__(message)
        self.history_index = history_index
        self.backend = backend

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"error": type(self).__name__,
                               "message": str(self)}
        for k in ("history_index", "backend"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


class BackendUnavailable(CheckError):
    """No usable device path for the requested device."""


class Unsupported(CheckError):
    """The history or model is outside what this package checks on the
    device.  Never answered by another engine behind the caller's back:
    the caller decides (for example `Linearizable(algorithm="cpu")`)."""
