"""Typed exceptions of the session API and the serving engine.

Counterpart of ``repro.api.errors``.  :class:`PlanError`: ``Segmenter.plan``
refuses an unusable image (non-finite pixels, zero elements) before any
device work.  :class:`RequestError`: ``SegmentationEngine.submit`` refuses
a request (non-finite model statistics, more labels than the pool's K, a
bucket past the pool's, a bad rid or deadline); it never enters the queue.
Both subclass :class:`ValueError`.  :class:`FallbackError` belongs to the
fallback policy, which is not ported yet: nothing raises it so far.
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
