from chainermn_tpu_torch.runtime.bootstrap import init_distributed

__all__ = ["init_distributed"]
