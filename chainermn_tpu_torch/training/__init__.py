from chainermn_tpu_torch.training.trainer import (
    FsdpStatefulUpdater, FsdpUpdater, StandardUpdater, StatefulUpdater,
    Trainer)
from chainermn_tpu_torch.training import extensions

__all__ = ["FsdpStatefulUpdater", "FsdpUpdater", "StandardUpdater",
           "StatefulUpdater", "Trainer", "extensions"]
