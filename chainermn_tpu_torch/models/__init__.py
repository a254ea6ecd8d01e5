from chainermn_tpu_torch.models.mlp import MLP
from chainermn_tpu_torch.models.resnet import (
    BasicBlock, BottleneckBlock, ResNet, ResNet50)
from chainermn_tpu_torch.models.transformer import Block, TransformerLM

__all__ = ["BasicBlock", "Block", "BottleneckBlock", "MLP", "ResNet",
           "ResNet50", "TransformerLM"]
