"""Error taxonomy for the conv stack, copied from the reference.

One root, two branches, one question: *is retrying sane?*

  ``ConvError``
  ├── ``TransientError``      the condition can clear
  │   ├── ``KernelLaunchError``      a CUDA launch reported an error
  │   ├── ``DispatchTableError``     a routing table could not be read
  │   └── ``DeadlineExceededError``  a request or step blew its deadline
  └── ``FatalError``           wrong shapes, wrong schema, programmer error

The port's server has no retry or demotion ladder yet, so a
``KernelLaunchError`` propagates to the caller like any other error; the
taxonomy is kept so that the later serving slice classifies the same way.
This module imports nothing from the package.
"""
from __future__ import annotations

__all__ = ["ConvError", "TransientError", "FatalError", "KernelLaunchError",
           "DispatchTableError", "DeadlineExceededError", "classify",
           "is_transient"]


class ConvError(Exception):
    """Root of the conv-stack taxonomy."""


class TransientError(ConvError):
    """The condition can clear: retry with backoff, do not crash the loop."""


class FatalError(ConvError):
    """Programmer/config error: retrying repeats the bug — crash loudly."""


class KernelLaunchError(TransientError):
    """A CUDA kernel launch returned a non-zero ``cudaGetLastError()``."""


class DispatchTableError(TransientError):
    """A measured dispatch table could not be loaded or parsed."""


class DeadlineExceededError(TransientError):
    """A per-request deadline or a rolling step deadline was breached."""


def classify(exc: BaseException) -> type:
    """-> the taxonomy branch for an arbitrary exception (unknown -> fatal)."""
    if isinstance(exc, TransientError):
        return TransientError
    return FatalError


def is_transient(exc: BaseException) -> bool:
    """True iff retrying is the sane response to ``exc``."""
    return isinstance(exc, TransientError)
