"""Models of the port: the MLP and CIFAR CNN, the causal LM and the
ResNet family."""

from distkeras_tpu_torch.models.cnn import CIFARConvNet, cifar10_cnn
from distkeras_tpu_torch.models.gpt import CausalLM, gpt_small, gpt_tiny
from distkeras_tpu_torch.models.mlp import MLP, mnist_mlp
from distkeras_tpu_torch.models.resnet import (ResNet, resnet18, resnet34,
                                               resnet50, resnet50_nf,
                                               resnet101)

__all__ = ["CIFARConvNet", "CausalLM", "MLP", "ResNet", "cifar10_cnn",
           "gpt_small", "gpt_tiny", "mnist_mlp", "resnet18", "resnet34",
           "resnet50", "resnet50_nf", "resnet101"]
