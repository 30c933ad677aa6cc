"""The K = 9 stack's cases of ``tests/test_torch_batched.py`` (see its
docstring): every lane of the port's ``run_em_batched`` against the JAX
package's, and against the port's serial ``run_em`` bit for bit, at f32
and bf16.  They are a file of their own so that two test workers share
that file's JAX references: the K = 9 stack's three JAX problems and its
JAX solve compile for about as long as the rest of that file together.
"""

import pytest

from repro_torch.testing.threads import one_intra_op_thread

from test_torch_batched import check_every_lane_equals_its_serial_run, check_run_em_batched_matches_jax

one_intra_op_thread()


@pytest.mark.parametrize("n_labels", [9])
def test_run_em_batched_matches_jax(n_labels):
    check_run_em_batched_matches_jax(n_labels)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n_labels", [9])
def test_every_lane_equals_its_serial_run(n_labels, precision):
    check_every_lane_equals_its_serial_run(n_labels, precision)
