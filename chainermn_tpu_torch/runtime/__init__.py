from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from chainermn_tpu_torch.runtime.control_plane import (
    ControlPlane, SingleProcessControlPlane, SocketControlPlane,
    get_control_plane, reserved_tag)

__all__ = ["ControlPlane", "SingleProcessControlPlane", "SocketControlPlane",
           "get_control_plane", "init_distributed", "reserved_tag"]
