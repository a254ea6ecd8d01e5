from chainermn_tpu_torch.ops.cast_scale import cast_scale, cast_scale_plain
from chainermn_tpu_torch.ops.fused_norm import (
    FusedBatchNormAct, ReferenceBatchNormAct, fused_norm,
    fused_norm_reference, fused_norm_traffic_bytes, resnet_bn_traffic_bytes)

__all__ = ["FusedBatchNormAct", "ReferenceBatchNormAct", "cast_scale",
           "cast_scale_plain", "fused_norm", "fused_norm_reference",
           "fused_norm_traffic_bytes", "resnet_bn_traffic_bytes"]
