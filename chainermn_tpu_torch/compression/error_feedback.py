"""Error-feedback state: the residual memory that makes lossy wires safe.

Counterpart of ``chainermn_tpu/compression/error_feedback.py``.  Error
feedback (EF-SGD): each rank adds the compression error it committed last
step back into this step's gradient before compressing again, so the
quantization error accumulates into the update stream instead of being
lost.

:class:`CompressionState` carries one buffer's state, on this rank:

* ``ef`` -- this rank's residual, the padded buffer's length (every rank
  keeps its own error);
* ``scale`` -- the delayed quantization scales as base-2 EXPONENTS
  (``scale = 2**e``): powers of two are exact in every float wire dtype,
  which lets the FSDP seam ride the exponents on the parameter
  all-gather;
* ``step`` -- a float32 step counter ``[1]``, which seeds the stochastic
  rounding's generator;
* ``spec``, ``ef_version`` and ``hop`` -- the compressor's identity, the
  format version, and the plan stage of a per-hop state (``None`` for the
  whole-buffer exchange; a per-hop plan's state carries its hop key,
  ``planner.init_plan_compression_states``).

Where JAX's state is a pytree threaded through the step, the port's is
updated in place (:meth:`CompressionState.update`), so a checkpoint that
holds it saves the live state and a resume restores into it.
"""

from __future__ import annotations

from typing import List, Optional

import torch

EF_VERSION = 1


class CompressionState:
    """Per-buffer EF and delayed-scale state (see the module note)."""

    def __init__(self, ef, scale, step, spec: str = "",
                 ef_version: int = EF_VERSION, hop: Optional[int] = None):
        self.ef = ef
        self.scale = scale
        self.step = step
        self.spec = spec
        self.ef_version = ef_version
        self.hop = hop

    def _replace(self, **kw) -> "CompressionState":
        d = {"ef": self.ef, "scale": self.scale, "step": self.step,
             "spec": self.spec, "ef_version": self.ef_version,
             "hop": self.hop}
        d.update(kw)
        return CompressionState(**d)

    def update(self, new: "CompressionState") -> "CompressionState":
        """Take ``new``'s tensors into this state, in place; returns it."""
        with torch.no_grad():
            self.ef.copy_(new.ef)
            self.scale.copy_(new.scale)
            self.step.copy_(new.step)
        return self

    def tree(self) -> dict:
        """What a checkpoint stores: ``{"ef", "scale", "step"}``."""
        return {"ef": self.ef, "scale": self.scale, "step": self.step}

    def load_tree(self, tree: dict) -> None:
        """Copy a restored :meth:`tree` into this state, in place."""
        with torch.no_grad():
            for k in ("ef", "scale", "step"):
                getattr(self, k).copy_(tree[k])

    def __repr__(self):
        hop = f", hop={self.hop}" if self.hop is not None else ""
        return (f"CompressionState(ef={tuple(self.ef.shape)}, "
                f"scale={tuple(self.scale.shape)}, spec={self.spec}{hop})")


def init_state(compressor, length: int, n_scales: int,
               hop: Optional[int] = None,
               device=None) -> CompressionState:
    """Fresh state for one flat buffer: zero residual, unit scales
    (``e = 0``; the delayed-scale update converges geometrically from any
    start because EF re-feeds what the first steps clipped), step 0."""
    return CompressionState(
        ef=torch.zeros((int(length),), dtype=torch.float32, device=device),
        scale=torch.zeros((int(n_scales),), dtype=torch.float32,
                          device=device),
        step=torch.zeros((1,), dtype=torch.float32, device=device),
        spec=compressor.spec, ef_version=EF_VERSION, hop=hop)


def iter_compression_states(tree) -> List[CompressionState]:
    """Every CompressionState in a tree of dicts, lists and tuples, also
    inside an FSDP state (``.comp``) and a compressed optimizer
    (``.comp_state``): what the checkpoint guard compares."""
    out: List[CompressionState] = []

    def walk(node):
        if isinstance(node, CompressionState):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            for attr in ("comp", "comp_state"):
                sub = getattr(node, attr, None)
                if isinstance(sub, (CompressionState, list, tuple)):
                    walk(sub)

    walk(tree)
    return out


def compression_layout(tree) -> Optional[dict]:
    """The compression config of every EF state in ``tree`` (None when
    there is none): what the multi-node checkpointer keeps in its sidecar
    and compares on resume.  The spec list is sorted, so the comparison
    does not depend on the walk's order."""
    states = iter_compression_states(tree)
    if not states:
        return None
    out = {
        "specs": sorted({s.spec for s in states}),
        "n_states": len(states),
        "ef_version": max(s.ef_version for s in states),
    }
    hops = sorted(f"{s.hop}:{s.spec}" for s in states if s.hop is not None)
    if hops:
        out["hops"] = hops
    return out


__all__ = ["EF_VERSION", "CompressionState", "compression_layout",
           "init_state", "iter_compression_states"]
