"""Typed exceptions of the session API.

Counterpart of ``repro.api.errors``.  Only :class:`PlanError` is raised
by this package so far; the request and fallback errors belong to the
serving and fallback layers, which are not ported yet.
"""

from __future__ import annotations


class ServingError(Exception):
    """Base class for session/serving errors."""


class PlanError(ServingError, ValueError):
    """The input image cannot be planned (non-finite or empty)."""


class RequestError(ServingError, ValueError):
    """A request failed admission validation."""


class FallbackError(ServingError, RuntimeError):
    """Compile/execute failed and the fallback policy could not recover."""
