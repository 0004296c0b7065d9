"""Models of the port: the GPT and BERT families and their transformer
blocks, the MNIST ConvNet and the ResNet family."""

from horovod_tpu_torch.models.gpt import GptDecoder, GptMedium, GptSmall
from horovod_tpu_torch.models.mnist import MnistConvNet
from horovod_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152)
from horovod_tpu_torch.models.transformer import (BertBase, BertEncoder,
                                                  BertLarge)

__all__ = ["BertEncoder", "BertBase", "BertLarge", "GptDecoder", "GptSmall",
           "GptMedium", "MnistConvNet", "ResNet", "ResNet18", "ResNet34",
           "ResNet50", "ResNet101", "ResNet152"]
