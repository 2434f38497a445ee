"""Typed errors of the checker runtime.

    CheckError            base; a ValueError, so `except ValueError`
    │                     callers keep working
    ├── BackendUnavailable no usable device: no card where the caller
    │                     asked for one, or a device type the port has
    │                     no kernel for
    ├── Unsupported       a history or model outside an engine
    │                     (overlap past the deep plane, too many states,
    │                     an undecomposable or spec-less model, crashed
    │                     calls that no crash tier settles, a model the
    │                     serial kernel has no transition for); the
    │                     message names what covers it
    └── Unencodable       an op the device encoding cannot hold (an f
                          the model has no code for, a value past
                          int32): only the exact CPU oracle checks it
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
    """The history or model is outside what an engine checks on the
    device.  The engine that raises it answers nothing else; the callers
    that answer it do so as the reference's do (`Linearizable`,
    `check_many`'s fallback and `wgl_deep.check_pipeline`'s stragglers
    run the serial frontier engine), or the caller decides (for example
    `Linearizable(algorithm="cpu")`)."""


class Unencodable(CheckError):
    """An op of the history has no device encoding: the model has no
    f-code for it, or its value passes int32.  The serial engine's plan
    raises it where the reference's raises ValueError (it is one), and
    `check_many`'s default fallback answers it, and nothing else, with
    the CPU oracle."""
