from edl_tpu_torch.models.mlp import MLP, LinearRegression
from edl_tpu_torch.models.resnet import (
    ResNet,
    ResNet18_vd,
    ResNet50_vd,
    ResNeXt,
    ResNeXt50_32x4d,
    ResNeXt101_32x16d,
)
from edl_tpu_torch.models.transformer import TransformerLM

__all__ = [
    "MLP",
    "LinearRegression",
    "ResNet",
    "ResNet18_vd",
    "ResNet50_vd",
    "ResNeXt",
    "ResNeXt50_32x4d",
    "ResNeXt101_32x16d",
    "TransformerLM",
]
