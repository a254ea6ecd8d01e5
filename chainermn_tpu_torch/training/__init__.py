from chainermn_tpu_torch.training.trainer import (
    StandardUpdater, StatefulUpdater, Trainer)
from chainermn_tpu_torch.training import extensions

__all__ = ["StandardUpdater", "StatefulUpdater", "Trainer", "extensions"]
