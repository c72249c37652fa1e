from theia_tpu_torch.utils.cortexbench.trifinger.policy import (
    ConvBatchNormMLPDeterministicPolicy,
    construct_policy,
)

__all__ = ["ConvBatchNormMLPDeterministicPolicy", "construct_policy"]
