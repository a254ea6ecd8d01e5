"""Auto communicator: the tuned flavor.

Counterpart of ``chainermn_tpu/communicators/auto_communicator.py``.
``create_communicator("auto", plan_table=...)`` routes every
``allreduce_grad`` through the plan the autotuned table picks for this
(topology, gradient dtype, packed byte size): instead of the user picking a
flavor once, the table picks the measured-fastest decomposition per
message-size bucket (:mod:`chainermn_tpu_torch.planner.autotune`, tuned from
``benchmarks/bench_allreduce.py --sweep`` rows on the card).

The JAX class selects at trace time; here the selection runs on the host at
each call (a dictionary lookup on the gradients' byte count), and
:meth:`AutoCommunicator.swap_plan_table` takes effect at the next call.
With no table, or a miss, the flat plan runs: the one all-reduce legal on
every topology.  A table that fails to load raises.
"""

from __future__ import annotations

from typing import Union

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)
from chainermn_tpu_torch.planner.autotune import PlanTable
from chainermn_tpu_torch.planner.ir import Plan, dtype_name
from chainermn_tpu_torch.planner.plans import flavor_plan


class AutoCommunicator(MeshCommunicator):
    flavor = "auto"

    def __init__(self, *args,
                 plan_table: Union[None, str, dict, PlanTable] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if plan_table is None:
            self.plan_table = PlanTable()
        elif isinstance(plan_table, PlanTable):
            self.plan_table = plan_table
        elif isinstance(plan_table, dict):
            self.plan_table = PlanTable.from_dict(plan_table)
        else:
            self.plan_table = PlanTable.load(plan_table)

    def swap_plan_table(self, plan_table: Union[dict, PlanTable]) -> None:
        """Hot-swap the plan table (the online tuner's step-boundary
        apply); the next ``allreduce_grad`` selects from it."""
        self.plan_table = plan_table if isinstance(plan_table, PlanTable) \
            else PlanTable.from_dict(plan_table)

    def plan(self) -> Plan:
        """The fallback plan (table-independent); per-message selection
        happens in :meth:`plan_for`."""
        return flavor_plan("flat")

    def plan_for(self, nbytes: int, dtype) -> Plan:
        """Tuned plan for a packed payload of ``nbytes`` of ``dtype`` on
        this communicator's topology (fallback: the flat plan)."""
        found = self.plan_table.lookup(self.plan_topology(),
                                       dtype_name(dtype), int(nbytes))
        return found if found is not None else self.plan()

    def _select(self, grads) -> Plan:
        """The table's plan for ``grads``, keyed on the dtype that carries
        the most bytes; announces the exchange as the ``"allreduce"`` plan
        slot of the step workload (``planner.schedule``)."""
        from chainermn_tpu_torch.planner.schedule import register_plan_slot
        leaves = _packing.tree_flatten(grads)[0]
        by_dtype: dict = {}
        for l in leaves:
            name = dtype_name(l.dtype)
            by_dtype[name] = by_dtype.get(name, 0) + \
                (int(l.numel()) or 1) * l.element_size()
        nbytes = sum(by_dtype.values())
        dtype = max(by_dtype, key=lambda k: by_dtype[k]) if by_dtype \
            else "float32"
        register_plan_slot("allreduce", nbytes=nbytes, dtype=dtype,
                           op="all-reduce",
                           owners=("plan:", "fsdp", "collective"))
        return self.plan_for(nbytes, dtype)

    def _allreduce_grad_traced(self, grads):
        from chainermn_tpu_torch.planner.compiler import execute_plan
        return execute_plan(self._select(grads), self, grads)


__all__ = ["AutoCommunicator"]
