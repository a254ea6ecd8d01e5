"""Gradient compression (a beyond-reference extension of the JAX package).

Counterpart of ``chainermn_tpu/compression/``: pluggable wire codecs for
the three gradient exchange seams --
``Communicator.allreduce_grad(compressor=..., state=...)``,
``create_multi_node_optimizer(compression=...)`` and
``fsdp_init(bucket_compressors=...)`` -- generalizing the fork's
``allreduce_grad_dtype`` cast (now exactly ``NoCompression(wire_dtype)``)
into int8/fp8 quantization with error feedback.  ``base.py`` holds the
protocol, ``quantize.py`` the codecs, ``error_feedback.py`` the EF state
that checkpoints carry, ``observe.py`` the ``compression_*`` metrics and
the codecs' compute spans (observability on).
"""

from chainermn_tpu_torch.compression.base import (
    Compressor, NoCompression, available_compressors, register_compressor,
    resolve_compressor)
from chainermn_tpu_torch.compression.error_feedback import (
    EF_VERSION, CompressionState, compression_layout, init_state,
    iter_compression_states)
from chainermn_tpu_torch.compression.quantize import (
    Fp8Compressor, Int8Compressor, dequantize_int8, is_quantizing,
    quantize_per_channel_int8, quantize_per_tensor_int8,
    wire_bits_per_param)

__all__ = ["CompressionState", "Compressor", "EF_VERSION", "Fp8Compressor",
           "Int8Compressor", "NoCompression", "available_compressors",
           "compression_layout", "dequantize_int8", "init_state",
           "is_quantizing", "iter_compression_states",
           "quantize_per_channel_int8", "quantize_per_tensor_int8",
           "register_compressor", "resolve_compressor",
           "wire_bits_per_param"]
