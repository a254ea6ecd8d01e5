from chainermn_tpu_torch.ops.cast_scale import cast_scale, cast_scale_plain
from chainermn_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bytes, flash_attention_flops)
from chainermn_tpu_torch.ops.fused_norm import (
    FusedBatchNormAct, ReferenceBatchNormAct, fused_norm,
    fused_norm_reference, fused_norm_traffic_bytes, resnet_bn_traffic_bytes)

__all__ = ["FusedBatchNormAct", "ReferenceBatchNormAct", "cast_scale",
           "cast_scale_plain", "flash_attention", "flash_attention_bytes",
           "flash_attention_flops", "fused_norm", "fused_norm_reference",
           "fused_norm_traffic_bytes", "resnet_bn_traffic_bytes"]
