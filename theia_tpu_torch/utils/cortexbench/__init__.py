"""CortexBench adapters of the port (port of theia_tpu/utils/cortexbench/):
the model loader, the input transforms and the policy heads."""

from theia_tpu_torch.utils.cortexbench.load_model import load_model
from theia_tpu_torch.utils.cortexbench.policy_heads import ConvBatchNormMLP, ConvPolicyHead
from theia_tpu_torch.utils.cortexbench.transforms import (
    r3m_transforms,
    rvfm_image_transforms,
    vit_transforms,
)

__all__ = [
    "load_model",
    "rvfm_image_transforms",
    "vit_transforms",
    "r3m_transforms",
    "ConvBatchNormMLP",
    "ConvPolicyHead",
]
