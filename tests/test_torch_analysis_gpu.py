"""cmn-lint on the card.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
nothing else, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_analysis_gpu.py

On an NCCL world of one card:

* a data-parallel step through the BatchNorm kernels (``FusedBatchNormAct``
  at every boundary of a small ResNet) and the float16 wire's cast,
  recorded under ``lint_step`` for three steps, leaves its parameters
  and buffers bit-equal to a twin's three bare steps (cuDNN
  deterministic), with no finding of the data-plane rules;
* a float32 all-reduce under a float16 plan is ``wire-dtype-mismatch``;
* a 64 MiB CUDA tensor the step closes over is ``captured-constant``.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chainermn_tpu_torch import init_distributed
    init_distributed()
    return torch.device("cuda", torch.cuda.current_device())


def _twin(dev, comm):
    import torch.nn.functional as F
    from chainermn_tpu_torch import (create_multi_node_optimizer,
                                     make_train_step)
    from chainermn_tpu_torch.models.resnet import BottleneckBlock, ResNet
    g = torch.Generator(device=dev).manual_seed(7)
    model = ResNet((1, 1), BottleneckBlock, num_classes=10, num_filters=16,
                   dtype=torch.bfloat16, device=dev, generator=g)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)
    step = make_train_step(
        comm, lambda b: F.cross_entropy(model(b[0]), b[1]), opt)
    return model, opt, step


def test_recorded_steps_are_bit_equal_to_bare_steps(cuda):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.analysis import lint_step
    comm = create_communicator("xla", allreduce_grad_dtype="float16")
    g = torch.Generator(device=cuda).manual_seed(8)
    batch = (torch.randn(8, 3, 64, 64, device=cuda, generator=g),
             torch.randint(0, 10, (8,), device=cuda, generator=g))
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        bare, _, bare_step = _twin(cuda, comm)
        rec, rec_opt, rec_step = _twin(cuda, comm)
        bare_losses = [bare_step(batch) for _ in range(3)]

        def fn(state, b):
            return rec_step(b)
        rep = lint_step(fn, (rec, rec_opt), batch, comm=comm, census=True,
                        plan=comm.plan(), donate_argnums=(0,), steps=3,
                        raise_on_error=False,
                        rules=["census-drift", "wire-dtype-mismatch",
                               "async-pair", "captured-constant",
                               "donation-alias"])
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    assert rep.ok and not rep.findings and not rep.skipped, \
        rep.render_text()
    assert any(op.kind == "all-reduce" and op.dtype == "f16"
               for op in rep.schedule)
    for a, b in zip(bare_losses, rep.outputs):
        assert torch.equal(a, b)
    for a, b in zip(list(bare.parameters()) + list(bare.buffers()),
                    list(rec.parameters()) + list(rec.buffers())):
        assert torch.equal(a, b)


def test_float32_all_reduce_under_a_float16_plan(cuda):
    import torch.distributed as dist
    from chainermn_tpu_torch.analysis import lint_step
    from chainermn_tpu_torch.planner.plans import flavor_plan
    rep = lint_step(lambda x: dist.all_reduce(x.clone()),
                    torch.ones(4096, device=cuda),
                    plan=flavor_plan("xla", wire_dtype="float16"),
                    rules=["wire-dtype-mismatch"], raise_on_error=False)
    assert [f.rule for f in rep.findings] == ["wire-dtype-mismatch"]
    assert rep.findings[0].details["observed_dtypes"] == ["f32"]


def test_a_closed_over_cuda_tensor_is_captured(cuda):
    from chainermn_tpu_torch.analysis import lint_step
    big = torch.ones(16 << 20, device=cuda)  # 64 MiB
    rep = lint_step(lambda x: x + big.sum(), torch.ones(8, device=cuda),
                    rules=["captured-constant"], raise_on_error=False)
    assert [f.rule for f in rep.findings] == ["captured-constant"]
    const = rep.findings[0].details["constants"][0]
    assert const["nbytes"] == 64 << 20 and const["device"].startswith("cuda")
