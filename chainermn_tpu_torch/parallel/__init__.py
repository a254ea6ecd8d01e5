from chainermn_tpu_torch.parallel.topology import (
    Topology, init_topology, resolve_device)

__all__ = ["Topology", "init_topology", "resolve_device"]
