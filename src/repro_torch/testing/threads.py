"""One intra-op thread for a test process of the port.

The CPU tests run under pytest-xdist, several worker processes on one
machine's cores.  PyTorch gives each process one intra-op thread per core
(8 on an 8-core host, under xdist too), so six workers' OpenMP pools put
48 spinning threads on 8 cores, against each other and against XLA
compiling the JAX reference: a 30-step training test that takes 6 s on
one thread took 248 s in such a run.  Each of the port's test files calls
:func:`one_intra_op_thread` when it is imported, so every worker runs the
port's tensors on one thread.  The spawned gloo ranks
(:mod:`repro_torch.testing.ranks`) set the same.
"""

import torch


def one_intra_op_thread() -> None:
    """Run this process's PyTorch CPU operations on one intra-op thread."""
    if torch.get_num_threads() != 1:
        torch.set_num_threads(1)
