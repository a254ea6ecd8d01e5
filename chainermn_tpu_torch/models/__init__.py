from chainermn_tpu_torch.models.alexnet import AlexNet
from chainermn_tpu_torch.models.googlenet import GoogLeNet, GoogLeNetBN
from chainermn_tpu_torch.models.mlp import MLP
from chainermn_tpu_torch.models.nin import NIN
from chainermn_tpu_torch.models.resnet import (
    BasicBlock, BottleneckBlock, ResNet, ResNet50)
from chainermn_tpu_torch.models.seq2seq import (
    Seq2SeqDecoder, Seq2SeqEncoder)
from chainermn_tpu_torch.models.transformer import Block, TransformerLM
from chainermn_tpu_torch.models.vgg import VGG, VGG16
from chainermn_tpu_torch.models.vit import EncoderBlock, ViT, ViT_B16, ViT_S16

__all__ = ["AlexNet", "BasicBlock", "Block", "BottleneckBlock",
           "EncoderBlock", "GoogLeNet", "GoogLeNetBN", "MLP", "NIN", "ResNet",
           "ResNet50", "Seq2SeqDecoder", "Seq2SeqEncoder", "TransformerLM",
           "VGG", "VGG16", "ViT", "ViT_B16", "ViT_S16"]
