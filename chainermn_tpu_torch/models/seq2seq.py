"""Encoder/decoder sequence-to-sequence model, split for model parallelism.

Counterpart of ``chainermn_tpu/models/seq2seq.py`` (the reference's
seq2seq example: an LSTM encoder on one rank, the decoder on another): two
modules whose cross-stage interface is the LSTM carry ``(c, h)``, each
``[B, hidden]`` -- the tensors the reference shipped between ranks, in
flax's order.

The LSTM is ``nn.LSTM`` (cuDNN on the card; the JAX package runs its LSTM
outside any Pallas kernel) laid out as flax's ``OptimizedLSTMCell``:
gates in the order i, f, g, o, input kernels without a bias and hidden
kernels with one, so ``weight_ih_l0`` is the input kernels transposed and
stacked, ``weight_hh_l0`` the hidden ones, ``bias_hh_l0`` their biases,
and ``bias_ih_l0`` is zero and frozen (``requires_grad=False``), so the
one bias trains as flax's does.  Initialisation draws from an explicit
``torch.Generator`` with flax's initialisers (lecun-normal input kernels,
dense kernels and embeddings, orthogonal hidden kernels, zero biases);
parity tests load the flax weights instead (:mod:`chainermn_tpu_torch.
weights`).

The encoder's ``lengths`` make the carry the state at each sentence's last
real token (``pack_padded_sequence``, as flax's ``nn.RNN(seq_lengths=)``).
The decoder is teacher-forced over the whole padded target (``__call__``)
and decodes greedily (:meth:`Seq2SeqDecoder.decode`) with the same
parameters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

from chainermn_tpu_torch.models.resnet import Dense, _lecun_normal_
from chainermn_tpu_torch.models.transformer import Embed


def _orthogonal_(w: torch.Tensor, generator) -> None:
    """``nn.init.orthogonal_`` on one CPU thread: LAPACK's QR rounds by its
    thread count, and the weights of a seed must not depend on the
    machine (``torchrun`` gives each of several ranks one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        nn.init.orthogonal_(w, generator=generator)
    finally:
        torch.set_num_threads(threads)


def _lstm(input_size: int, hidden: int, device, generator) -> nn.LSTM:
    lstm = nn.LSTM(input_size, hidden, batch_first=True, device=device)
    with torch.no_grad():
        for g in range(4):
            rows = slice(g * hidden, (g + 1) * hidden)
            _lecun_normal_(lstm.weight_ih_l0[rows], input_size, generator)
            _orthogonal_(lstm.weight_hh_l0[rows], generator)
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    lstm.bias_ih_l0.requires_grad_(False)
    return lstm


class Seq2SeqEncoder(nn.Module):
    """Embed + LSTM; returns the final carry ``(c, h)`` (the cross-rank
    tensors).  ``lengths`` (per-example true source lengths, a CPU tensor
    or array) takes the carry at each sentence's last real token."""

    def __init__(self, vocab_size: int, embed_dim: int = 64,
                 hidden: int = 128, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed = Embed(vocab_size, embed_dim, device=device,
                           generator=generator)
        self.lstm = _lstm(embed_dim, hidden, device, generator)

    def forward(self, src, lengths=None):
        emb = self.embed(src)
        if lengths is not None:
            emb = pack_padded_sequence(
                emb, torch.as_tensor(lengths).cpu().long(), batch_first=True,
                enforce_sorted=False)
        _, (h, c) = self.lstm(emb)
        return c[0], h[0]


class Seq2SeqDecoder(nn.Module):
    """LSTM decoder seeded with the encoder's carry: ``forward(carry,
    tgt_in)`` gives the teacher-forced logits ``[B, T, vocab]``;
    :meth:`decode` is greedy generation with the same parameters."""

    def __init__(self, vocab_size: int, embed_dim: int = 64,
                 hidden: int = 128, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed = Embed(vocab_size, embed_dim, device=device,
                           generator=generator)
        self.lstm = _lstm(embed_dim, hidden, device, generator)
        self.out = Dense(hidden, vocab_size, device=device,
                         generator=generator)

    @staticmethod
    def _state(carry):
        c, h = carry
        return h[None].contiguous(), c[None].contiguous()

    def forward(self, enc_carry, tgt_in):
        hs, _ = self.lstm(self.embed(tgt_in), self._state(enc_carry))
        return self.out(hs)

    def decode(self, enc_carry, max_len: int, bos_id: int = 1):
        """Greedy decode: feed BOS, then each argmax token back in.
        Returns ``[B, max_len]`` int32 token ids (the caller truncates at
        EOS)."""
        state = self._state(enc_carry)
        tok = torch.full((state[0].shape[1], 1), bos_id, dtype=torch.long,
                         device=state[0].device)
        toks = []
        for _ in range(max_len):
            h, state = self.lstm(self.embed(tok), state)
            tok = self.out(h).argmax(-1)
            toks.append(tok)
        return torch.cat(toks, dim=1).to(torch.int32)


def make_copy_reverse_task(n: int, seq_len: int, vocab: int, seed: int = 0):
    """Synthetic translation stand-in: target = reversed source, BOS id 1,
    symbols 2.. (the JAX function's arrays from the same ``RandomState``)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, vocab, size=(n, seq_len)).astype(np.int32)
    tgt = src[:, ::-1].copy()
    bos = np.ones((n, 1), np.int32)
    tgt_in = np.concatenate([bos, tgt[:, :-1]], axis=1)
    return src, tgt_in, tgt


__all__ = ["Seq2SeqDecoder", "Seq2SeqEncoder", "make_copy_reverse_task"]
