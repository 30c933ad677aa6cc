"""Training substrate of the port: optimizer, train step, data pipeline,
checkpointing and fault tolerance, in PyTorch (no external optimizer or
checkpoint library).  Counterpart of ``repro.training``; its gradient
compression waits for ``parallel/`` (ROADMAP.md Queue 1)."""

from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.training.train_step import (  # noqa: F401
    TrainStepConfig,
    make_train_step,
    make_sharded_train_state,
)
