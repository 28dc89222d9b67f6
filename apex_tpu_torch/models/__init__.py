"""Models: the GPT decoder of the serving and LM paths, the BERT encoder,
and the ResNet family of the ImageNet trainer."""

from .bert import (BertEncoder, BertLayer, BertSelfAttention, bert_base,
                   bert_tiny)
from .gpt import GPT, GPTBlock, gpt2_small, gpt_tiny, init_cache
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18,
                     ResNet34, ResNet50, ResNet101, ResNet152)

__all__ = ["BasicBlock", "BertEncoder", "BertLayer", "BertSelfAttention",
           "BottleneckBlock", "GPT", "GPTBlock", "ResNet",
           "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "bert_base", "bert_tiny", "gpt2_small", "gpt_tiny", "init_cache"]
