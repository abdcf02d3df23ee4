from edl_tpu_torch.models.ctr import (
    CTR_EMBEDDING_RULES,
    DeepFM,
    binary_cross_entropy_loss,
)
from edl_tpu_torch.models.mlp import MLP, LinearRegression
from edl_tpu_torch.models.resnet import (
    ResNet,
    ResNet18_vd,
    ResNet50_vd,
    ResNeXt,
    ResNeXt50_32x4d,
    ResNeXt101_32x16d,
)
from edl_tpu_torch.models.decode import greedy_generate, init_cache
from edl_tpu_torch.models.moe import MOE_EP_RULES, SwitchMoE
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
    "DeepFM",
    "CTR_EMBEDDING_RULES",
    "binary_cross_entropy_loss",
    "SwitchMoE",
    "MOE_EP_RULES",
    "greedy_generate",
    "init_cache",
]
