"""Models of the port: the causal LM and the ResNet family."""

from distkeras_tpu_torch.models.gpt import CausalLM, gpt_small, gpt_tiny
from distkeras_tpu_torch.models.resnet import (ResNet, resnet18, resnet34,
                                               resnet50, resnet50_nf,
                                               resnet101)

__all__ = ["CausalLM", "gpt_small", "gpt_tiny", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet50_nf", "resnet101"]
