"""Compression observability -- the ``compression_*`` metric family plus
compute-tagged flight spans.

Counterpart of ``chainermn_tpu/compression/observe.py``.  Same
zero-cost-when-disabled contract as ``parallel/fsdp._FsdpObs``: the seams
obtain a :class:`CompressionObs` ONCE when they are built; with the
metrics switch and the flight recorder both off it is ``None`` and the
exchange makes no observability call at all.  JAX delivers the edges from
device callbacks on rank 0; here the seam calls :meth:`CompressionObs.edge`
itself on rank 0, after the stream has reached the edge (the residual
norm is read back then).

Metrics (labels ``seam`` ∈ {allreduce, fsdp}, ``bucket``, ``compressor``):

* ``compression_bits_per_param`` (gauge) — achieved wire bits/param
  including the chunk-grid pad and (FSDP) the piggybacked scale slot;
* ``compression_wire_bytes_saved`` (counter) — bytes NOT moved per
  collective vs the uncompressed f32 wire;
* ``compression_residual_norm`` (gauge) — L2 norm of this rank's EF
  residual after compress (the convergence health signal: a decaying /
  flat-low residual is healthy, a growing one means the wire is too
  narrow for the gradient stream).

Flight spans: ``compress`` / ``decompress`` are recorded with
``kind="compute"`` — a slow quantizer must show up in
``identify_desync`` as a *compute straggler*, never as a wedged
collective (the desync analysis only treats collective/object spans as
cross-rank-symmetric progress markers).
"""

from __future__ import annotations

from typing import Optional


class CompressionObs:
    """Begin/end edges for one compress or decompress region, recorded on
    rank 0 (one event stream, like the FSDP overlap lane)."""

    def __init__(self, flight, registry):
        self.flight = flight
        self.registry = registry
        self._open: dict = {}
        if registry is not None:
            self._bits = registry.gauge(
                "compression_bits_per_param",
                "achieved wire bits per parameter (pad + scale overhead "
                "included)")
            self._saved = registry.counter(
                "compression_wire_bytes_saved",
                "wire bytes not moved vs an uncompressed f32 collective")
            self._residual = registry.gauge(
                "compression_residual_norm",
                "L2 norm of this rank's error-feedback residual")
            self._sat = registry.gauge(
                "compression_saturated_chunks",
                "summed per-chunk saturation-flag count of the last "
                "collective (nonzero = some rank clipped hard; the "
                "delayed scale escalates next step)")

    def edge(self, phase: str, edge: str, seam: str, bucket: int,
             compressor: str, bits_per_param: float, bytes_saved: int,
             residual_norm: Optional[float]) -> None:
        labels = {"seam": seam, "bucket": str(bucket),
                  "compressor": compressor}
        key = (phase, seam, bucket)
        if self.flight is not None:
            if edge == "begin":
                self._open[key] = self.flight.span_begin(
                    "compute", f"{phase}:{seam}", bucket=bucket,
                    compressor=compressor)
            else:
                tok = self._open.pop(key, None)
                if tok is not None:
                    self.flight.span_end(tok)
        if self.registry is not None and edge == "end" \
                and phase == "compress":
            self._bits.set(bits_per_param, **labels)
            self._saved.inc(bytes_saved, **labels)
            if residual_norm is not None:
                self._residual.set(residual_norm, **labels)

    def device_edge(self, rank: int, phase: str, edge: str, seam: str,
                    bucket: int, compressor: str, bits_per_param: float,
                    bytes_saved: int, residual=None, dep=None) -> None:
        """One edge, in place of JAX's device callback: on rank 0 only,
        wait for ``dep``'s stream (the edge's data on the card) and record the
        edge; ``residual`` (the EF residual tensor, at a compress end) is
        reduced to its L2 norm and read back."""
        if int(rank) != 0:
            return
        if dep is not None and dep.is_cuda:
            import torch
            torch.cuda.current_stream(dep.device).synchronize()
        rnorm = 0.0 if residual is None else \
            float(residual.float().square().sum().sqrt())
        self.edge(phase, edge, seam, bucket, compressor, bits_per_param,
                  bytes_saved, rnorm)

    def device_sat(self, rank: int, seam: str, bucket: int,
                   compressor: str, sat_count) -> None:
        """Rank 0 records the summed saturation-flag count of one
        collective (a tensor, read back; JAX's sat callback)."""
        if int(rank) == 0 and self.registry is not None:
            self._sat.set(float(sat_count), seam=seam, bucket=str(bucket),
                          compressor=compressor)


def get_compression_obs() -> Optional[CompressionObs]:
    """The build-time hook: ``None`` while observability is off."""
    from chainermn_tpu_torch.observability import flight_recorder as _flight
    from chainermn_tpu_torch.observability import registry as _registry

    fr = _flight.get_flight_recorder()
    reg = _registry.get_registry() if _registry.enabled() else None
    return CompressionObs(fr, reg) if (fr or reg) else None


__all__ = ["CompressionObs", "get_compression_obs"]
