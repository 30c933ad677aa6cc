"""Typed exceptions of the session API and the serving engine.

Counterpart of ``repro.api.errors``.  :class:`PlanError`: ``Segmenter.plan``
refuses an unusable image (non-finite pixels, zero elements) before any
device work.  :class:`RequestError`: ``SegmentationEngine.submit`` refuses
a request (non-finite model statistics, more labels than the pool's K, a
bucket past the pool's, a bad rid or deadline); it never enters the queue.
Both subclass :class:`ValueError`.  :class:`FallbackError`: a compile, an
execute or an engine tick failed and the session's ``FallbackPolicy``
could not recover: after the same-route retries under the default policy
(which takes no other route), when the plain fallback route failed too
(``FallbackPolicy(backend="torch")``), or on a tick that may not be
replayed; the original error is its ``__cause__``.
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
