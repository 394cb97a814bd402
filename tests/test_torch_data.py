"""The port's data pipeline (a numpy copy) against the reference's: the
same ``DataConfig`` gives bit-equal batches, documents, eval batches and
iterator states; a resumed iterator continues as the reference's does;
host shards take disjoint residues of the document ids."""
import numpy as np
import pytest

from repro.data import pipeline as J
from repro_torch.data import pipeline as T

CONFIGS = [dict(batch_size=2, seq_len=32),
           dict(vocab_size=512, seq_len=64, batch_size=3, seed=5),
           dict(vocab_size=32000, seq_len=48, batch_size=1, n_markov_states=16),
           dict(batch_size=2, seq_len=40, host_index=1, host_count=3)]


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", CONFIGS)
def test_batches_bit_equal_to_reference(kw):
    jit, tit = J.PackedIterator(J.DataConfig(**kw)), T.PackedIterator(T.DataConfig(**kw))
    for _ in range(3):
        _same(next(tit), next(jit))
        assert tit.state().to_dict() == jit.state().to_dict()
    jc, tc = J.SyntheticCorpus(J.DataConfig(**kw)), T.SyntheticCorpus(T.DataConfig(**kw))
    np.testing.assert_array_equal(tc.unigram, jc.unigram)
    for doc_id in (0, 7, 10_000_001):
        np.testing.assert_array_equal(tc.doc(doc_id), jc.doc(doc_id))
    for a, b in zip(T.eval_batches(T.DataConfig(**kw), 2),
                    J.eval_batches(J.DataConfig(**kw), 2)):
        _same(a, b)


def test_resume_matches_reference():
    kw = dict(batch_size=2, seq_len=32)
    tit = T.PackedIterator(T.DataConfig(**kw))
    for _ in range(3):
        next(tit)
    state = tit.state()
    assert T.IteratorState.from_dict(state.to_dict()) == state
    jres = J.PackedIterator(J.DataConfig(**kw),
                            J.IteratorState.from_dict(state.to_dict()))
    tres = T.PackedIterator(T.DataConfig(**kw), state)
    for _ in range(2):
        _same(next(tres), next(jres))
    # a fresh iterator replays the same stream from the start
    again = T.PackedIterator(T.DataConfig(**kw))
    first = T.PackedIterator(T.DataConfig(**kw))
    for _ in range(3):
        _same(next(again), next(first))


def test_host_shards_take_disjoint_doc_ids():
    its = [T.PackedIterator(T.DataConfig(batch_size=1, seq_len=64,
                                         host_index=i, host_count=3))
           for i in range(3)]
    for i, it in enumerate(its):
        assert it.next_doc % 3 == i
        next(it)
        assert it.next_doc % 3 == i
    # a state from another residue class is realigned to this host's
    it = T.PackedIterator(T.DataConfig(host_index=2, host_count=3),
                          T.IteratorState(next_doc=10))
    assert it.next_doc == 11
