from chainermn_tpu_torch.training.trainer import (
    StandardUpdater, StatefulUpdater, Trainer)

__all__ = ["StandardUpdater", "StatefulUpdater", "Trainer"]
