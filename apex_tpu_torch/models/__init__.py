"""Models: the GPT decoder of the serving and LM paths, and the ResNet
family of the ImageNet trainer."""

from .gpt import GPT, GPTBlock, gpt2_small, gpt_tiny, init_cache
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18,
                     ResNet34, ResNet50, ResNet101, ResNet152)

__all__ = ["BasicBlock", "BottleneckBlock", "GPT", "GPTBlock", "ResNet",
           "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "gpt2_small", "gpt_tiny", "init_cache"]
