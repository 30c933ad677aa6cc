"""Training substrate of the port: optimizer, train step, data pipeline,
checkpointing, fault tolerance and the cross-pod gradient codecs, in
PyTorch (no external optimizer or checkpoint library), on one device or
a DeviceMesh.  Counterpart of ``repro.training``."""

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
