"""Collective context: sharded execution as a parametrisation of EM.

Counterpart of ``repro.core.pmrf.collectives``.  The EM driver touches
cross-element state in four places; everything else in an iteration is
elementwise over hood elements or works on small replicated arrays
(labels, mu, sigma).  When hood elements are block-partitioned over the
ranks of a process group (the hybrid distributed PMRF of the paper's
section 5), the four touch points become:

  1. per-(hood, label) counts       ReduceByKey      -> + all-reduce
  2. per-hood energy sums           ReduceByKey      -> + all-reduce
  3. label votes                    Scatter(Add)     -> + all-reduce
  4. convergence decision           AND              -> all-reduce MIN

:class:`ReduceCtx` carries those hooks.  The single-device context
(``group=None``, the constant :data:`LOCAL`) lowers each to the plain DPP
primitive; a sharded context holds the process group and wraps the local
primitive in the matching ``dpp_sharded`` collective.  Counts and votes
are integer-valued floats, so their cross-rank sums are exact and sharded
labels equal single-device labels; the label count K rides in the key
spaces (``dpp.compound_key``) and needs no hook of its own.

The modes ``static`` and ``faithful`` go through all four hooks as the
reference's driver does: :meth:`segment_sum` for the counts and (in
element order, ``ordered=True``) the hood sums, :meth:`vote_scatter` for
the votes, :meth:`all_converged` for the window; each is the rank's local
reduction and then one all-reduce.

The static-pallas sharded route's MAP iteration
(``kernels.ops.map_step_workspace``) needs no collective for touch point
1: each rank counts its hoods over their whole runs of the partition,
which it holds, and that is the all-reduced count exactly.  Touch points 2 and 3 are one :meth:`psum` of
the step's buffer, and 4 is :meth:`and_flags` on its flag word.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import dpp, dpp_sharded

Tensor = torch.Tensor


@dataclass(frozen=True)
class ReduceCtx:
    """The EM driver's cross-shard reduction hooks (module docstring).

    ``group`` is ``None`` for single-device execution, or the process group
    whose ranks each hold one block of the hood elements (the default
    group is ``torch.distributed.group.WORLD``).
    """

    group: Optional[dist.ProcessGroup] = None

    @property
    def sharded(self) -> bool:
        return self.group is not None

    def psum(self, x: Tensor) -> Tensor:
        """Sum a partial result of the same shape on every rank (identity on
        one device).  Reduces ``x`` in place and returns it: callers pass
        buffers they own, such as a kernel's fresh outputs."""
        if self.group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def segment_sum(
        self,
        segment_ids: Tensor,
        values: Tensor,
        num_segments: int,
        *,
        backend: Optional[str] = None,
        where: Optional[Tensor] = None,
        ordered: bool = False,
    ) -> Tensor:
        """Touch points 1 and 2: ReduceByKey(Add) over a global segment id
        space, all-reduced when sharded.  ``where`` masks contributions
        first (masked lanes add exact zeros); ``ordered=True`` sums each
        rank's elements in element order (``dpp.reduce_by_key``) before
        the all-reduce."""
        if where is not None:
            values = torch.where(where, values, torch.zeros((), dtype=values.dtype, device=values.device))
        if self.group is None:
            return dpp.reduce_by_key(segment_ids, values, num_segments, op="add", backend=backend,
                                     ordered=ordered)
        return dpp_sharded.global_reduce_by_key(
            segment_ids, values, num_segments, self.group, op="add", backend=backend,
            ordered=ordered,
        )

    def vote_scatter(
        self,
        values: Tensor,
        indices: Tensor,
        out_size: int,
        *,
        where: Optional[Tensor] = None,
    ) -> Tensor:
        """Touch point 3: Scatter(Add) into the global vote field (indices
        outside ``[0, out_size)`` dropped), all-reduced when sharded."""
        if where is not None:
            values = torch.where(where, values, torch.zeros((), dtype=values.dtype, device=values.device))
        return self.psum(dpp.scatter_(values, indices, out_size, mode="add"))

    def and_flags(self, word: Tensor) -> Tensor:
        """Touch point 4 on a MAP loop's flag word (``kernels.ref.FLAG_*``,
        an int32 tensor of one element), in place: its minimum over the
        ranks, so that every rank reads one word.  The minimum is the AND
        of the converged bits and keeps the diverged bit only because every
        rank holds the same word: the words test all-reduced sums, so ranks
        agree by construction, and the collective keeps the decision one
        decision.  Words that differed could lose a diverged bit (the
        minimum of 1 and 2 is 1).  Returns ``word``."""
        if self.group is not None:
            dist.all_reduce(word, op=dist.ReduceOp.MIN, group=self.group)
        return word

    def all_converged(self, flags: Tensor) -> Tensor:
        """Touch point 4: the global convergence AND, a 0-d bool tensor.
        Flags come from all-reduced energy sums, so ranks agree by
        construction; the collective keeps the decision one decision."""
        if self.group is None:
            return torch.all(flags)
        return dpp_sharded.global_all_converged(flags, self.group)


#: The single-device context, the default of ``run_em``.
LOCAL = ReduceCtx()


__all__ = ["ReduceCtx", "LOCAL"]
