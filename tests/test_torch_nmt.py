"""The port's NMT corpus utilities against the JAX package's.

``chainermn_tpu_torch/datasets/nmt.py`` is the port's own copy of
``chainermn_tpu/datasets/nmt.py`` (pure numpy on both sides): every
integer result -- vocabularies, encoded pairs, bucketed batches with their
shuffles -- must equal JAX's exactly, and BLEU (a float from the same
integer counts in the same order) too.  The twins of ``tests/test_nmt.py``
hold the port to the same contract.
"""

import math

import numpy as np
import pytest

from chainermn_tpu.datasets import nmt as jnmt
from chainermn_tpu_torch.datasets import nmt as tnmt
from chainermn_tpu_torch.datasets.nmt import (
    BOS_ID, EOS_ID, PAD_ID, UNK_ID, Vocab, bleu, bucket_batches,
    encode_pairs, load_corpus)
from chainermn_tpu_torch.examples.seq2seq import synthetic_pairs


def _corpus(n=300, max_len=11, vocab=40, seed=3):
    return synthetic_pairs(n, max_len, vocab, seed=seed)


def test_constants_match():
    assert (tnmt.PAD_ID, tnmt.BOS_ID, tnmt.EOS_ID, tnmt.UNK_ID) == \
        (jnmt.PAD_ID, jnmt.BOS_ID, jnmt.EOS_ID, jnmt.UNK_ID)
    assert tnmt.SPECIALS == jnmt.SPECIALS


@pytest.mark.parametrize("max_size", [None, 12, 30])
def test_vocab_and_encoding_match_jax(max_size):
    pairs = _corpus()
    tv = tnmt.Vocab.build((s for s, _ in pairs), max_size)
    jv = jnmt.Vocab.build((s for s, _ in pairs), max_size)
    assert tv.itos == jv.itos and tv.stoi == jv.stoi
    got = tnmt.encode_pairs(pairs, tv, tv)
    want = jnmt.encode_pairs(pairs, jv, jv)
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        assert a.dtype == c.dtype == np.int32
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    ids = got[5][1].tolist() + [PAD_ID, 7]
    assert tv.decode(ids) == jv.decode(ids)


@pytest.mark.parametrize("shuffle,seed,drop,step",
                         [(False, 0, True, 4), (True, 0, True, 4),
                          (True, 7, False, 2), (False, 0, False, 3)])
def test_bucket_batches_match_jax(shuffle, seed, drop, step):
    pairs = _corpus()
    v = tnmt.Vocab.build((s for s, _ in pairs))
    ex = tnmt.encode_pairs(pairs, v, v)
    got = list(tnmt.bucket_batches(ex, 16, step=step, shuffle=shuffle,
                                   seed=seed, drop_remainder=drop))
    want = list(jnmt.bucket_batches(ex, 16, step=step, shuffle=shuffle,
                                    seed=seed, drop_remainder=drop))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


def test_bleu_matches_jax():
    rng = np.random.RandomState(0)
    refs = [[f"t{rng.randint(6)}" for _ in range(rng.randint(1, 9))]
            for _ in range(40)]
    hyps = [r[:-1] + ["t0"] if i % 3 else r for i, r in enumerate(refs)]
    for smooth in (True, False):
        assert tnmt.bleu(hyps, refs, smooth=smooth) == \
            jnmt.bleu(hyps, refs, smooth=smooth)


def test_load_corpus_matches_jax(tmp_path):
    src, tgt = tmp_path / "s.txt", tmp_path / "t.txt"
    src.write_text("a b c\n\nx y\n" + "w " * 9 + "\nq\n")
    tgt.write_text("A B\nZ\nX Y\nL\n\n")
    for max_len in (None, 5):
        assert tnmt.load_corpus(str(src), str(tgt), max_len) == \
            jnmt.load_corpus(str(src), str(tgt), max_len)


# -- twins of tests/test_nmt.py ---------------------------------------------

class TestVocab:
    def test_specials_pinned_and_frequency_order(self):
        v = Vocab.build([["b", "a", "b"], ["b", "c", "a"]])
        assert v.itos[:4] == ["<pad>", "<bos>", "<eos>", "<unk>"]
        assert v.itos[4:] == ["b", "a", "c"]
        assert (PAD_ID, BOS_ID, EOS_ID, UNK_ID) == (0, 1, 2, 3)

    def test_deterministic_tie_break(self):
        assert Vocab.build([["x", "y"]]).itos == Vocab.build([["y", "x"]]).itos

    def test_unk_and_max_size(self):
        v = Vocab.build([["a", "a", "b", "c"]], max_size=6)
        assert len(v) == 6
        assert v.encode(["a", "zzz"]) == [v.stoi["a"], UNK_ID]
        with pytest.raises(ValueError, match="no room"):
            Vocab.build([["a"]], max_size=4)

    def test_decode_stops_at_eos(self):
        v = Vocab.build([["hello", "world"]])
        ids = v.encode(["hello", "world"]) + [EOS_ID] + v.encode(["hello"])
        assert v.decode([BOS_ID] + ids) == ["hello", "world"]
        assert v.decode([PAD_ID, PAD_ID]) == []


class TestLoadCorpus:
    def test_load_filter_and_mismatch(self, tmp_path):
        src, tgt = tmp_path / "s.txt", tmp_path / "t.txt"
        src.write_text("a b c\n\nx y\nlong " + "w " * 60 + "\n")
        tgt.write_text("A B\nZ\nX Y\nL\n")
        assert load_corpus(str(src), str(tgt), max_len=50) == [
            (["a", "b", "c"], ["A", "B"]), (["x", "y"], ["X", "Y"])]
        tgt.write_text("A B\n")
        with pytest.raises(ValueError, match="mismatch"):
            load_corpus(str(src), str(tgt))


class TestBucketBatches:
    def _examples(self, lengths, seed=0):
        rng = np.random.RandomState(seed)
        return [(rng.randint(4, 10, size=l).astype(np.int32),
                 np.concatenate([rng.randint(4, 10, size=l),
                                 [EOS_ID]]).astype(np.int32))
                for l in lengths]

    def test_shapes_masks_and_teacher_forcing(self):
        batches = list(bucket_batches(self._examples([3, 3, 5, 5]), 2,
                                      step=4, shuffle=False))
        assert len(batches) == 2
        by_shape = {b["src"].shape[1]: b for b in batches}
        assert set(by_shape) == {4, 8}
        b = by_shape[4]
        assert b["src"].shape == (2, 4)
        assert b["tgt_in"].shape == b["tgt_out"].shape == (2, 4)
        assert (b["src"][:, 3] == PAD_ID).all()
        assert (b["tgt_in"][:, 0] == BOS_ID).all()
        np.testing.assert_array_equal(b["tgt_in"][:, 1:], b["tgt_out"][:, :-1])
        np.testing.assert_array_equal(b["mask"], [[1, 1, 1, 1], [1, 1, 1, 1]])
        assert (b["src_len"] == 3).all()

    def test_drop_remainder_vs_wrap_pad(self):
        ex = self._examples([3, 3, 3])
        assert len(list(bucket_batches(ex, 2, shuffle=False))) == 1
        batches = list(bucket_batches(ex, 2, shuffle=False,
                                      drop_remainder=False))
        assert len(batches) == 2
        tail = batches[1]
        assert tail["n_real"] == 1
        assert tail["src"].shape[0] == 2
        assert tail["mask"][1].sum() == 0

    def test_epoch_shuffle_differs_but_covers(self):
        ex = self._examples([3] * 8)
        a = [b["src"].tobytes() for b in bucket_batches(ex, 4, seed=0)]
        c = [b["src"].tobytes() for b in bucket_batches(ex, 4, seed=1)]
        assert set(a) != set(c) or a != c


class TestBleu:
    def test_perfect_match(self):
        refs = [["the", "cat", "sat", "on", "the", "mat"]]
        assert bleu(refs, refs) == pytest.approx(1.0)

    def test_zero_on_disjoint(self):
        assert bleu([["a", "b", "c", "d"]], [["w", "x", "y", "z"]],
                    smooth=False) == 0.0

    def test_brevity_penalty(self):
        ref = [["a", "b", "c", "d", "e", "f"]]
        short = [["a", "b", "c"]]
        clipped = bleu(short, ref)
        assert clipped < bleu(ref, ref)
        assert clipped == pytest.approx(math.exp(1 - 6 / 3), rel=1e-6)

    def test_known_partial_overlap(self):
        hyp = [["the", "cat", "sat", "on", "mat"]]
        ref = [["the", "cat", "sat", "on", "the", "mat"]]
        assert 0.0 < bleu(hyp, ref) < 1.0
        with pytest.raises(ValueError, match="count mismatch"):
            bleu(hyp, ref + ref)


def test_encode_pairs_appends_eos():
    v = Vocab.build([["a", "b"]])
    src, tgt = encode_pairs([(["a"], ["b"])], v, v)[0]
    assert tgt[-1] == EOS_ID and src[-1] == v.stoi["a"]
