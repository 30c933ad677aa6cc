"""The K = 3 case of ``tests/test_torch_session.py``'s
``test_segment_stack_batched_equals_serial_and_jax`` (see its docstring):
``segment_stack(batch="always")`` against ``"never"`` bit for bit and
against the JAX session's ``segment_stack`` on the same four three-phase
slices.  It is a file of its own so that two test workers share that
file's JAX sessions: each stack's JAX planning and solve compile for
about as long as the rest of that file together.
"""

import pytest

from repro_torch.testing.threads import one_intra_op_thread

from test_torch_session import check_segment_stack_batched_equals_serial_and_jax

one_intra_op_thread()


@pytest.mark.parametrize("n_labels", [3])
def test_segment_stack_batched_equals_serial_and_jax(n_labels):
    check_segment_stack_batched_equals_serial_and_jax(n_labels)
