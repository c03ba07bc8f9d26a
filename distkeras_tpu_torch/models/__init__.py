"""Models of the port: the MLP and CIFAR CNN, the causal LM, the ResNet
family and the encoder families (BERT, ViT, the Switch-MoE classifier)."""

from distkeras_tpu_torch.models.bert import BertMLM, bert_base, bert_tiny
from distkeras_tpu_torch.models.cnn import CIFARConvNet, cifar10_cnn
from distkeras_tpu_torch.models.gpt import CausalLM, gpt_small, gpt_tiny
from distkeras_tpu_torch.models.mlp import MLP, mnist_mlp
from distkeras_tpu_torch.models.moe import MoEClassifier, SwitchMoE
from distkeras_tpu_torch.models.remat import REMAT_POLICIES, remat_call
from distkeras_tpu_torch.models.resnet import (ResNet, resnet18, resnet34,
                                               resnet50, resnet50_nf,
                                               resnet101)
from distkeras_tpu_torch.models.vit import ViT, vit_base, vit_large, vit_tiny

__all__ = ["BertMLM", "CIFARConvNet", "CausalLM", "MLP", "MoEClassifier",
           "REMAT_POLICIES", "ResNet", "SwitchMoE", "ViT", "bert_base",
           "bert_tiny", "cifar10_cnn", "gpt_small", "gpt_tiny", "mnist_mlp",
           "remat_call", "resnet18", "resnet34", "resnet50", "resnet50_nf",
           "resnet101", "vit_base", "vit_large", "vit_tiny"]
