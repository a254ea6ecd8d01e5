from chainermn_tpu_torch.models.resnet import (
    BasicBlock, BottleneckBlock, ResNet, ResNet50)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "ResNet50"]
