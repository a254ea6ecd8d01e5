from chainermn_tpu_torch.parallel.sequence import (
    attention, ring_attention, ulysses_attention)
from chainermn_tpu_torch.parallel.topology import (
    Topology, init_topology, resolve_device)

__all__ = ["Topology", "attention", "init_topology", "resolve_device",
           "ring_attention", "ulysses_attention"]
