"""NMT corpus utilities: vocabulary, bucketing, padding, BLEU.

The port's own copy of ``chainermn_tpu/datasets/nmt.py`` (pure numpy, as
there; the port imports nothing of the JAX package): load parallel
token-per-line text files, build frequency-sorted vocabularies with
special tokens, batch ragged sentences into padded LENGTH BUCKETS (every
batch of a bucket has one shape) with explicit lengths and masks, and
score held-out translations with corpus-level BLEU-4 and its brevity
penalty.  Its integer results equal the JAX module's on the same inputs
(``tests/test_torch_nmt.py``).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD_ID, BOS_ID, EOS_ID, UNK_ID = 0, 1, 2, 3
SPECIALS = ("<pad>", "<bos>", "<eos>", "<unk>")


class Vocab:
    """Frequency-sorted vocabulary with pinned special tokens.

    ``itos[0:4]`` are always ``<pad> <bos> <eos> <unk>``; remaining slots
    are corpus tokens, most frequent first (ties broken lexicographically
    so construction is deterministic across processes).
    """

    def __init__(self, counts: Dict[str, int],
                 max_size: Optional[int] = None):
        items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if max_size is not None:
            if max_size <= len(SPECIALS):
                raise ValueError(
                    f"max_size={max_size} leaves no room beyond the "
                    f"{len(SPECIALS)} special tokens")
            items = items[:max_size - len(SPECIALS)]
        self.itos: List[str] = list(SPECIALS) + [t for t, _ in items]
        self.stoi: Dict[str, int] = {t: i for i, t in enumerate(self.itos)}

    @classmethod
    def build(cls, sentences: Iterable[Sequence[str]],
              max_size: Optional[int] = None) -> "Vocab":
        counts: Counter = Counter()
        for toks in sentences:
            counts.update(toks)
        for sp in SPECIALS:
            counts.pop(sp, None)
        return cls(counts, max_size)

    def __len__(self) -> int:
        return len(self.itos)

    def encode(self, tokens: Sequence[str]) -> List[int]:
        return [self.stoi.get(t, UNK_ID) for t in tokens]

    def decode(self, ids: Iterable[int]) -> List[str]:
        """Ids -> tokens, stopping at EOS, skipping pad/bos."""
        out = []
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if i in (PAD_ID, BOS_ID):
                continue
            out.append(self.itos[i] if 0 <= i < len(self.itos)
                       else SPECIALS[UNK_ID])
        return out


def load_corpus(src_path: str, tgt_path: str,
                max_len: Optional[int] = None,
                ) -> List[Tuple[List[str], List[str]]]:
    """Parallel corpus: one sentence per line, whitespace-tokenized.
    Pairs where either side is empty (or longer than ``max_len``, when
    given) are skipped — the reference example filtered the same way."""
    with open(src_path, encoding="utf-8") as f:
        src_lines = f.read().splitlines()
    with open(tgt_path, encoding="utf-8") as f:
        tgt_lines = f.read().splitlines()
    if len(src_lines) != len(tgt_lines):
        raise ValueError(
            f"parallel corpus line-count mismatch: {src_path} has "
            f"{len(src_lines)} lines, {tgt_path} has {len(tgt_lines)}")
    pairs = []
    for s, t in zip(src_lines, tgt_lines):
        st, tt = s.split(), t.split()
        if not st or not tt:
            continue
        if max_len is not None and (len(st) > max_len or len(tt) > max_len):
            continue
        pairs.append((st, tt))
    if not pairs:
        raise ValueError(f"no usable sentence pairs in {src_path}")
    return pairs


def encode_pairs(pairs: Sequence[Tuple[Sequence[str], Sequence[str]]],
                 src_vocab: Vocab, tgt_vocab: Vocab,
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Token pairs -> (src_ids, tgt_ids+EOS) int32 arrays."""
    out = []
    for s, t in pairs:
        out.append((np.asarray(src_vocab.encode(s), np.int32),
                    np.asarray(tgt_vocab.encode(t) + [EOS_ID], np.int32)))
    return out


def _pad_to(ids: np.ndarray, length: int) -> np.ndarray:
    return np.pad(ids, (0, length - len(ids)),
                  constant_values=PAD_ID).astype(np.int32)


def bucket_batches(examples: Sequence[Tuple[np.ndarray, np.ndarray]],
                   batch_size: int, step: int = 4,
                   shuffle: bool = True, seed: int = 0,
                   drop_remainder: bool = True):
    """Yield padded batches grouped by (src, tgt) length bucket.

    Each example lands in the bucket of its lengths rounded up to a
    multiple of ``step``; every batch from a bucket has that one padded
    shape.  Yields dicts with:

    - ``src`` (B, Ls): pad-right source ids
    - ``src_len`` (B,): true source lengths (feed the encoder so the
      carry is taken at the last real token)
    - ``tgt_in`` (B, Lt): BOS + target[:-1] (teacher forcing input)
    - ``tgt_out`` (B, Lt): target + EOS, pad-right (loss labels)
    - ``mask`` (B, Lt) float32: 1 on real target positions (incl. EOS)

    ``drop_remainder=False`` wrap-pads the final short batch of each
    bucket to ``batch_size`` and marks the padding rows with ``mask=0``
    (eval path: metrics stay exact, shapes stay static).  Every yielded
    batch has exactly ``batch_size`` rows.
    """
    rng = np.random.RandomState(seed)
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, (s, t) in enumerate(examples):
        key = (max(step, math.ceil(len(s) / step) * step),
               max(step, math.ceil(len(t) / step) * step))
        buckets.setdefault(key, []).append(i)

    order = sorted(buckets)
    if shuffle:
        order = [order[j] for j in rng.permutation(len(order))]
    for key in order:
        idx = buckets[key]
        if shuffle:
            idx = [idx[j] for j in rng.permutation(len(idx))]
        ls, lt = key
        for b0 in range(0, len(idx), batch_size):
            chunk = idx[b0:b0 + batch_size]
            real = len(chunk)
            if real < batch_size:
                if drop_remainder:
                    continue
                chunk = (chunk * math.ceil(batch_size / real))[:batch_size]
            src = np.stack([_pad_to(examples[i][0], ls) for i in chunk])
            src_len = np.asarray(
                [len(examples[i][0]) for i in chunk], np.int32)
            tgt_full = np.stack([_pad_to(examples[i][1], lt)
                                 for i in chunk])
            tgt_in = np.concatenate(
                [np.full((len(chunk), 1), BOS_ID, np.int32),
                 tgt_full[:, :-1]], axis=1)
            mask = (tgt_full != PAD_ID).astype(np.float32)
            if real < batch_size:  # wrap-padded eval rows don't count
                mask[real:] = 0.0
            yield {"src": src, "src_len": src_len, "tgt_in": tgt_in,
                   "tgt_out": tgt_full, "mask": mask, "n_real": real}


def bleu(hypotheses: Sequence[Sequence[str]],
         references: Sequence[Sequence[str]], max_n: int = 4,
         smooth: bool = True) -> float:
    """Corpus-level BLEU-``max_n`` with brevity penalty (Papineni et al.).
    ``smooth`` adds +1 smoothing to higher-order precisions (method-1),
    keeping short-corpus scores finite — the usual example-scale choice."""
    if len(hypotheses) != len(references):
        raise ValueError("hypothesis/reference count mismatch")
    clipped = np.zeros(max_n)
    totals = np.zeros(max_n)
    hyp_len = ref_len = 0
    for hyp, ref in zip(hypotheses, references):
        hyp, ref = list(hyp), list(ref)
        hyp_len += len(hyp)
        ref_len += len(ref)
        for n in range(1, max_n + 1):
            h_ngrams = Counter(tuple(hyp[i:i + n])
                               for i in range(len(hyp) - n + 1))
            r_ngrams = Counter(tuple(ref[i:i + n])
                               for i in range(len(ref) - n + 1))
            totals[n - 1] += max(0, len(hyp) - n + 1)
            clipped[n - 1] += sum(min(c, r_ngrams[g])
                                  for g, c in h_ngrams.items())
    log_p = 0.0
    for n in range(max_n):
        num, den = clipped[n], totals[n]
        if smooth and n > 0:
            num, den = num + 1.0, den + 1.0
        if num == 0 or den == 0:
            return 0.0
        log_p += math.log(num / den) / max_n
    bp = (1.0 if hyp_len >= ref_len
          else math.exp(1.0 - ref_len / max(hyp_len, 1)))
    return bp * math.exp(log_p)
