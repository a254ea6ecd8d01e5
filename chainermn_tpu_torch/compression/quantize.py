"""int8 / fp8 quantizers: per-chunk power-of-two scales, stochastic
rounding, in-wire summation.

Counterpart of ``chainermn_tpu/compression/quantize.py``.  The collective
between ``compress`` and ``decompress`` SUMS wire values in wire
arithmetic, which sets three design points (the JAX module's):

* **Overflow-safe codes**: each rank clips its codes to ``max_code /
  world_size`` (int8: ``127 // W``; fp8 e4m3: ``448 / W``), so the summed
  wire value cannot overflow whatever the addends.  What the clip loses,
  error feedback re-feeds next step.
* **Rank-identical scales**: summing codes means something only when every
  rank quantized with the same scale, so the scales are *delayed*: step t
  uses the scales derived from step t-1's SUMMED (hence identical) wire,
  and every rank updates them alike with no extra collective.  Scales are
  powers of two (kept as exponents), exact in any float wire.
* **Saturation flags on the wire**: the summed amax underestimates a
  rank's amplitude when ranks cancel, which can wedge a scale below the
  clip point; each rank appends one 0/1 flag per chunk ("I clipped past
  ``sat_margin`` times the limit in this chunk") to its codes, the same
  collective sums them into a clip count, and a nonzero count raises the
  exponent by at least one.

How the port sums the wire (``Communicator.allreduce_grad`` and FSDP's
buckets; neither gloo nor NCCL reduces ``float8_e4m3fn``):

* int8: the backend's sum all-reduce (exact: the clip rules out
  overflow);
* fp8: the codes move as bytes (``all_to_all_single`` of a ``uint8``
  view); each rank adds its shard of every rank's codes in float16, in
  rank order, starting from +0 (:func:`sum_wire`), rounds once to
  e4m3fn (:func:`to_e4m3fn`, NaN past the format's range as
  ``ml_dtypes`` and XLA give it), and all-gathers the summed shards as
  bytes.  That is what JAX's ``psum`` of e4m3fn codes computes on the
  CPU, and it costs the bytes of a ring all-reduce.

Stochastic rounding (``floor(v/s + u)``, ``u ~ U[0, 1)``; fp8 dithers by
the value's own e4m3 ulp) keeps the quantizer unbiased.  JAX draws ``u``
from threefry keys folded with ``(seed, step, rank)``; the port draws it
from a ``torch.Generator`` on the tensor's device, seeded with
:func:`generator_seed` of the same triple (no global RNG state).  The two
streams differ, and a CUDA generator's stream differs from a CPU one's for
the same seed, so bit-for-bit checks use ``stochastic=False``.
"""

from __future__ import annotations

from typing import Optional

import torch

from chainermn_tpu_torch.compression import error_feedback as _ef
from chainermn_tpu_torch.compression.base import (
    Compressor, register_compressor, torch_dtype)

_E_MIN, _E_MAX = -60.0, 60.0   # exponent clamp (2**+-60 covers f32 grads)
_MASK64 = (1 << 64) - 1
# past this magnitude e4m3fn cannot round to a finite value (464 itself
# ties to 448, the even neighbour): ml_dtypes and XLA give NaN, torch's
# own cast saturates to 448
_E4M3_NAN_PAST = 464.0


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def generator_seed(seed: int, step: int, rank: Optional[int] = None) -> int:
    """The stochastic rounding's generator seed for ``(seed, step,
    rank)``: ``splitmix64(splitmix64(splitmix64(seed) ^ step) ^ (rank +
    1))`` (``rank`` None counts as -1), kept to 63 bits.  Replayable, and
    the rank decorrelates the ranks' dither."""
    r = -1 if rank is None else int(rank)
    x = _splitmix64(int(seed) & _MASK64)
    x = _splitmix64(x ^ (int(step) & _MASK64))
    x = _splitmix64(x ^ ((r + 1) & _MASK64))
    return x & ((1 << 63) - 1)


def to_e4m3fn(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float16/float32) rounded to ``float8_e4m3fn`` with the bits
    ``ml_dtypes`` and XLA give: to nearest even, NaN (sign kept) past
    magnitude 464, where torch's own cast saturates to 448."""
    bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
    bits = torch.where(x.abs() > _E4M3_NAN_PAST, bits | 0x7F, bits)
    return bits.view(torch.float8_e4m3fn)


def sum_wire(parts: torch.Tensor, wire: torch.dtype) -> torch.Tensor:
    """The in-wire sum of ``parts`` (``[W, n]`` codes, rank order) as
    JAX's ``psum`` computes it on the CPU: int8 exactly; float8_e4m3fn
    added in float16 in rank order from +0 and rounded once."""
    if wire == torch.int8:
        return parts.to(torch.int16).sum(0).to(torch.int8)
    if wire != torch.float8_e4m3fn:
        raise TypeError(f"no in-wire sum for {wire}")
    acc = torch.zeros(parts.shape[1:], dtype=torch.float16,
                      device=parts.device)
    for p in parts:   # in rank order
        acc = acc + p.to(torch.float16)
    return to_e4m3fn(acc)


class _ScaledQuantizer(Compressor):
    """Shared machinery of the int8/fp8 codecs (see the module note).

    Subclasses pin ``wire`` (the collective dtype's name), ``max_code``
    (the symmetric wire range) and :meth:`encode`.
    """

    stateful = True
    wire: str = "?"
    max_code: float = 0.0
    #: saturation-flag threshold, in multiples of the clip limit: mild tail
    #: clipping is left to EF, a wedged scale trips the flag within a step
    #: or two (its clipped excess compounds through the residual)
    sat_margin = 2.0

    def __init__(self, chunk_size: int = 1024, stochastic: bool = True,
                 seed: int = 0, headroom: float = 2.0):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.chunk_size = int(chunk_size)
        self.stochastic = bool(stochastic)
        self.seed = int(seed)
        self.headroom = float(headroom)

    def config(self):
        return {"chunk_size": self.chunk_size,
                "stochastic": self.stochastic,
                "seed": self.seed, "headroom": self.headroom}

    @property
    def wire_dtype(self) -> torch.dtype:
        return torch_dtype(self.wire)

    def wire_dtype_for(self, dtype):
        return self.wire_dtype

    # -- wire budget ---------------------------------------------------------
    def clip_limit(self, world_size: int) -> float:
        """Per-rank |code| bound so the in-wire sum cannot overflow."""
        c = self.max_code / world_size
        if c < 2.0:
            raise ValueError(
                f"{self.name} in-wire summation needs max_code/world >= 2 "
                f"(got {self.max_code}/{world_size}): too few code levels "
                f"per rank -- use fp8 or an uncompressed wire at this world "
                f"size")
        return c

    def effective_clip(self, world_size: int) -> float:
        """The |code| bound :meth:`encode` applies (int8 floors
        :meth:`clip_limit` to the integer grid)."""
        return self.clip_limit(world_size)

    def saturation_flags(self, v, scale_pos, world_size: int,
                         chunk_len: int):
        """Per-chunk 0/1 wire flags: did THIS rank clip past ``sat_margin``
        times the clip limit anywhere in the chunk?"""
        c = self.sat_margin * self.effective_clip(world_size)
        over = (v / scale_pos).abs() > c
        return over.reshape(-1, chunk_len).any(dim=1).to(self.wire_dtype)

    # -- stochastic rounding's uniforms --------------------------------------
    def uniform(self, shape, step: int, rank, device) -> torch.Tensor:
        """``U[0, 1)`` float32 draws for ``(seed, step, rank)`` on
        ``device`` (see :func:`generator_seed`)."""
        g = torch.Generator(device=device)
        g.manual_seed(generator_seed(self.seed, step, rank))
        return torch.rand(shape, generator=g, device=device,
                          dtype=torch.float32)

    # -- codec primitives (shared by both exchange seams) --------------------
    def encode(self, v, scale_pos, step: int, rank, world_size: int):
        raise NotImplementedError

    def decode(self, codes, scale_pos):
        return codes.to(torch.float32) * scale_pos

    def next_exponent(self, e_prev, summed_amax, world_size: int,
                      sat_count=None):
        """The delayed power-of-two scale update from the SUMMED amax of
        each chunk (identical on every rank): aim a rank's amplitude
        ``amax / world`` at ``clip / headroom`` code levels; an all-zero
        chunk shrinks by 2**-2 a step; a nonzero ``sat_count`` (the summed
        clip flags) raises the exponent by at least 1.  The log is taken
        in float64 and rounded to float32 before the ceiling, so the card
        and the CPU take the same exponent."""
        c = self.clip_limit(world_size)
        target = (summed_amax * self.headroom) / (world_size * c)
        t = torch.clamp(target, min=2.0 ** _E_MIN)
        e_new = torch.ceil(torch.log2(t.double()).float())
        cand = torch.where(summed_amax > 0, e_new, e_prev - 2.0)
        if sat_count is not None:
            cand = torch.where(sat_count > 0,
                               torch.maximum(cand, e_prev + 1.0), cand)
        return torch.clamp(cand, _E_MIN, _E_MAX)

    # -- allreduce-seam protocol --------------------------------------------
    def _padded(self, length: int) -> int:
        return length + (-length) % self.chunk_size

    def n_chunks(self, length: int) -> int:
        return self._padded(length) // self.chunk_size

    def init_state(self, length: int, world_size: int = 1, hop=None,
                   device=None):
        del world_size  # shape-independent; kept for the API's symmetry
        return _ef.init_state(self, self._padded(int(length)),
                              self.n_chunks(int(length)), hop=hop,
                              device=device)

    def scale_per_pos(self, scale_e):
        return torch.exp2(scale_e).repeat_interleave(self.chunk_size)

    def step_of(self, state) -> int:
        """The state's step as a host integer (read only when stochastic
        rounding needs it: a device read)."""
        return int(state.step[0].item()) if self.stochastic else 0

    def compress(self, buf, state, rank=None, world_size: int = 1):
        """EF-compress one flat float buffer into wire codes (padded to the
        chunk grid, one saturation flag per chunk after them).  The
        residual and step advance; the scales are only read (they move in
        :meth:`decompress`, from summed data)."""
        m = int(buf.shape[0])
        mp = self._padded(m)
        v = torch.zeros((mp,), dtype=torch.float32, device=buf.device)
        v[:m] = buf.to(torch.float32)
        v = v + state.ef
        sp = self.scale_per_pos(state.scale)
        codes = self.encode(v, sp, self.step_of(state), rank, world_size)
        new_ef = v - self.decode(codes, sp)
        flags = self.saturation_flags(v, sp, world_size, self.chunk_size)
        return (torch.cat([codes, flags]),
                state._replace(ef=new_ef, step=state.step + 1.0))

    def decompress(self, wire, state, world_size: int = 1):
        """Decode the SUMMED wire buffer to a float32 SUM (the caller
        divides by the world for the mean) and advance the delayed scales
        from each chunk's amax and summed clip count."""
        mp = int(state.ef.shape[0])
        sp = self.scale_per_pos(state.scale)
        out = self.decode(wire[:mp], sp)
        amax = out.abs().reshape(-1, self.chunk_size).amax(dim=1)
        new_e = self.next_exponent(state.scale, amax, world_size,
                                   wire[mp:].to(torch.float32))
        return out, state._replace(scale=new_e)


class Int8Compressor(_ScaledQuantizer):
    """int8 wire: ``codes = clip(round(v / 2**e), +-(127 // W))``, summed
    across ranks in int8 arithmetic (about 4x fewer wire bytes than
    float32)."""

    name = "int8"
    wire = "int8"
    max_code = 127.0

    def effective_clip(self, world_size: int) -> float:
        return float(int(self.clip_limit(world_size)))

    def encode(self, v, scale_pos, step: int, rank, world_size: int):
        c = self.effective_clip(world_size)
        q = v / scale_pos
        if self.stochastic:
            q = torch.floor(q + self.uniform(q.shape, step, rank, q.device))
        else:
            q = torch.round(q)
        return torch.clamp(q, -c, c).to(torch.int8)


class Fp8Compressor(_ScaledQuantizer):
    """float8_e4m3fn wire: scaled values cast to fp8 and summed in fp8
    arithmetic -- coarser than int8 near the chunk's amax (3 mantissa
    bits) but with about 2**15 of dynamic range inside a chunk.
    Stochastic rounding dithers by the value's own e4m3 ulp before the
    cast."""

    name = "fp8"
    wire = "float8_e4m3fn"
    max_code = 448.0

    def encode(self, v, scale_pos, step: int, rank, world_size: int):
        c = self.clip_limit(world_size)
        q = torch.clamp(v / scale_pos, -c, c)
        if self.stochastic:
            # e4m3 has 3 mantissa bits: ulp(x) = 2**(floor(log2|x|) - 3);
            # frexp's exponent e has |x| in [2**(e-1), 2**e)
            _, e = torch.frexp(q)
            ulp = torch.exp2((e - 1 - 3).to(torch.float32))
            u = self.uniform(q.shape, step, rank, q.device)
            q = q + (u - 0.5) * ulp
        return to_e4m3fn(torch.clamp(q, -c, c))


register_compressor(Int8Compressor.name, Int8Compressor)
register_compressor(Fp8Compressor.name, Fp8Compressor)

# The quantizing codecs, for seams that branch on "lossy or not".
QUANTIZERS = (Int8Compressor, Fp8Compressor)


def is_quantizing(comp) -> bool:
    return isinstance(comp, _ScaledQuantizer)


def wire_bits_per_param(comp, length: int, world_size: int = 1) -> float:
    """Achieved wire bits per parameter, counting the chunk grid's pad and
    the per-chunk saturation flags (32 for an uncompressed wire)."""
    if not is_quantizing(comp):
        return 32.0
    mp = comp._padded(int(length)) + comp.n_chunks(int(length))
    item_bits = comp.wire_dtype.itemsize * 8
    return item_bits * mp / max(int(length), 1)


# -- weight quantization (serving) -------------------------------------------
# Inference weights are quantized once, offline, with exact per-channel
# amax scales: no EF and no wire-sum budget.

def quantize_per_channel_int8(w, channel_axis: int = -1):
    """Symmetric per-channel int8: ``codes = round(w / s)`` with ``s = amax
    / 127`` per slice along ``channel_axis``.  Returns ``(codes int8, scale
    float32)``, ``scale`` shaped to broadcast against ``codes``; an
    all-zero channel gets scale 1."""
    w = torch.as_tensor(w).to(torch.float32)
    ax = channel_axis % w.ndim
    axes = tuple(a for a in range(w.ndim) if a != ax)
    amax = w.abs().amax(dim=axes, keepdim=True) if axes else w.abs()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return codes, scale


def quantize_per_tensor_int8(w):
    """One scale for the whole tensor (the baseline the per-channel
    property test beats)."""
    w = torch.as_tensor(w).to(torch.float32)
    amax = w.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes, scale):
    """Inverse of either weight quantizer (the scale broadcasts)."""
    return codes.to(torch.float32) * scale


__all__ = ["Fp8Compressor", "Int8Compressor", "QUANTIZERS",
           "dequantize_int8", "generator_seed", "is_quantizing",
           "quantize_per_channel_int8", "quantize_per_tensor_int8",
           "sum_wire", "to_e4m3fn", "wire_bits_per_param"]
