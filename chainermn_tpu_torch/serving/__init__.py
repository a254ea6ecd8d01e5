"""Continuous-batching inference (counterpart of ``chainermn_tpu.serving``).

:mod:`~chainermn_tpu_torch.serving.kv_cache` -- paged KV cache,
deterministic page allocator, prefix trie;
:mod:`~chainermn_tpu_torch.serving.scheduler` -- lockstep admission
(continuous or static); :mod:`~chainermn_tpu_torch.serving.engine` -- the
fused prefill+decode step and the draft+verify step;
:mod:`~chainermn_tpu_torch.serving.weights` -- restore, cast, broadcast;
:mod:`~chainermn_tpu_torch.serving.router` -- session-affine replicas.
The JAX package's int8 weights, multicast plans and tensor-parallel
slicing raise in ``weights`` and are not exported here.
"""

from chainermn_tpu_torch.serving.engine import (Completion, InferenceEngine,
                                                ServingConfig, StepResult)
from chainermn_tpu_torch.serving.kv_cache import (KvCache, PageAllocator,
                                                  PrefixCache, gather_kv,
                                                  init_kv_cache,
                                                  paged_attention, write_kv)
from chainermn_tpu_torch.serving.router import ReplicaStatus, Router
from chainermn_tpu_torch.serving.scheduler import AdmissionScheduler, Request
from chainermn_tpu_torch.serving.weights import (broadcast_inference_params,
                                                 load_inference_params)

__all__ = [
    "AdmissionScheduler",
    "Completion",
    "InferenceEngine",
    "KvCache",
    "PageAllocator",
    "PrefixCache",
    "ReplicaStatus",
    "Request",
    "Router",
    "ServingConfig",
    "StepResult",
    "broadcast_inference_params",
    "gather_kv",
    "init_kv_cache",
    "load_inference_params",
    "paged_attention",
    "write_kv",
]
