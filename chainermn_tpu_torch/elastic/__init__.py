"""Elastic runtime: preemption-tolerant training on top of the checkpoint
and observability stack.

Counterpart of ``chainermn_tpu/elastic/__init__.py``.  Three cooperating
pieces:

* :class:`AsyncCheckpointer` -- the ``backend="async"`` flavor of
  :func:`~chainermn_tpu_torch.extensions.checkpoint.
  create_multi_node_checkpointer`: a device-to-host snapshot at the step
  boundary, the npz persist on a background thread, a write barrier
  before generation GC and the ``async_ckpt_stall_ms`` stall metric.
* :class:`Supervisor` (driven by ``python -m chainermn_tpu_torch.tools.
  elastic_run``) -- launches the world, consumes the watchdog's and crash
  handlers' flight dumps, writes a ``restart_manifest/v1`` per incident
  and relaunches from the newest consistent generation.
* :func:`resume_resized` / :func:`retune_plan_table` -- world-resize
  resume: reshard FSDP bucket shards into the new world, re-key
  error-feedback state, and re-tune the collective plan table for the new
  topology instead of refusing the mismatch.
"""

from chainermn_tpu_torch.elastic.async_ckpt import AsyncCheckpointer
from chainermn_tpu_torch.elastic.manifest import (MANIFEST_SCHEMA,
                                                  build_restart_manifest,
                                                  write_restart_manifest)
from chainermn_tpu_torch.elastic.resize import (resize_report,
                                                resume_resized,
                                                retune_plan_table)
from chainermn_tpu_torch.elastic.supervisor import (Supervisor,
                                                    SupervisorConfig)

__all__ = [
    "AsyncCheckpointer",
    "MANIFEST_SCHEMA",
    "Supervisor",
    "SupervisorConfig",
    "build_restart_manifest",
    "resize_report",
    "resume_resized",
    "retune_plan_table",
    "write_restart_manifest",
]
