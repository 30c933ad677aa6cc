"""The port's NumPy oracle (``repro_torch.core.pmrf.reference``) against the
JAX package's (``repro.core.pmrf.reference``) on the same problem.

The problem is a 32x32 synthetic slice planned by the port on the CPU
(grid 4; K = 2 and a three-phase K = 3 slice), quantile init; the same
arrays go to both oracles, as the port's tensors to the port's and as JAX
arrays to the JAX package's.  ``serial_em`` and ``coarse_em`` run a few
iterations (their Python loops are slow by design), ``golden_em`` a whole
solve.  Labels, mu, sigma, iteration counts and total energy must be
equal; ``seconds`` is left out.  The port's oracle imports neither JAX nor
the JAX package.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods
from repro.core.pmrf import reference as jax_reference

from repro_torch.core import synthetic
from repro_torch.core.pmrf import convert, pipeline
from repro_torch.core.pmrf import reference
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

SHORT = dict(max_em_iters=3, max_map_iters=4)


def _problem(n_labels):
    if n_labels == 2:
        vol = synthetic.make_synthetic_volume(seed=2, n_slices=1, shape=(32, 32), device="cpu")
    else:
        vol = synthetic.make_kary_volume(seed=2, n_slices=1, shape=(32, 32), n_phases=n_labels,
                                         device="cpu")
    prob = pipeline.initialize(vol.images[0], overseg_grid=(4, 4), n_labels=n_labels,
                               device="cpu")
    init = pipeline.initial_params(prob, 0, "quantile")
    hoods, model = prob.hoods, prob.model
    jh = jax_hoods.Hoods(**{f: jnp.asarray(getattr(hoods, f).numpy()) for f in convert.HOODS_ARRAYS},
                         **{f: getattr(hoods, f) for f in convert.HOODS_SIZES})
    jm = jax_energy.EnergyModel(*(jnp.asarray(t.numpy()) for t in model))
    return (hoods, model, *init), (jh, jm, *(jnp.asarray(t.numpy()) for t in init))


def _assert_equal(got, want, what):
    for f in ("labels", "mu", "sigma"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{what} {f}")
    assert (got.em_iters, got.map_iters, got.total_energy) == (
        want.em_iters, want.map_iters, want.total_energy), what


@pytest.mark.parametrize("n_labels", [2, 3])
@pytest.mark.parametrize("oracle", ["serial_em", "coarse_em", "golden_em"])
def test_oracle_matches_jax_package(oracle, n_labels):
    port, jax_problem = _problem(n_labels)
    kw = {} if oracle == "golden_em" else SHORT
    got = getattr(reference, oracle)(*port, **kw)
    want = getattr(jax_reference, oracle)(*jax_problem, **kw)
    _assert_equal(got, want, f"{oracle} K={n_labels}")
    assert got.labels.shape == (port[0].n_regions + 1,) and got.seconds >= 0.0


def test_oracle_imports_no_jax():
    code = ("import sys; import repro_torch.core.pmrf.reference; "
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
