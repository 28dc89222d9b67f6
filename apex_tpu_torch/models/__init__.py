"""Models: the GPT decoder of the serving and LM paths, the BERT encoder,
the ResNet family of the ImageNet trainer, and the DCGAN pair."""

from .bert import (BertEncoder, BertLayer, BertSelfAttention, bert_base,
                   bert_tiny)
from .dcgan import Discriminator, Generator
from .gpt import GPT, GPTBlock, gpt2_small, gpt_tiny, init_cache
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18,
                     ResNet34, ResNet50, ResNet101, ResNet152)

__all__ = ["BasicBlock", "BertEncoder", "BertLayer", "BertSelfAttention",
           "BottleneckBlock", "Discriminator", "GPT", "GPTBlock",
           "Generator", "ResNet",
           "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "bert_base", "bert_tiny", "gpt2_small", "gpt_tiny", "init_cache"]
