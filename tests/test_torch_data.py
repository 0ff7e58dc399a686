"""The port's data pipeline (``repro_torch.data``) is bitwise the
reference's (``repro.data``): the synthetic corpus's streams, the
batcher's host-sharded batches for several seeds and hosts, and the byte
tokenizer."""
import numpy as np
import pytest

from repro_torch.data import ByteTokenizer, SyntheticCorpus, TokenBatcher


@pytest.mark.parametrize("vocab,seed,seq", [(256, 0, 16), (151936, 3, 64),
                                            (1000, 7, 33)])
def test_corpus_stream_is_the_reference(vocab, seed, seq):
    from repro.data import SyntheticCorpus as JaxCorpus
    a = SyntheticCorpus(vocab, seed=seed).stream(seq)
    b = JaxCorpus(vocab, seed=seed).stream(seq)
    for _ in range(5):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (1, 2), (3, 4)])
def test_batcher_is_the_reference(host_id, num_hosts):
    from repro.data import SyntheticCorpus as JaxCorpus
    from repro.data import TokenBatcher as JaxBatcher
    a = TokenBatcher(SyntheticCorpus(512, seed=2), 8, 24, host_id=host_id,
                     num_hosts=num_hosts)
    b = JaxBatcher(JaxCorpus(512, seed=2), 8, 24, host_id=host_id,
                   num_hosts=num_hosts)
    try:
        for _ in range(3):
            (ta, la), (tb, lb) = next(a), next(b)
            assert ta.shape == (8 // num_hosts, 24)
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(la, lb)
            np.testing.assert_array_equal(ta[:, 1:], la[:, :-1])
    finally:
        a.close()
        b.close()


def test_tokenizer_is_the_reference():
    from repro.data import ByteTokenizer as JaxTokenizer
    a, b = ByteTokenizer(), JaxTokenizer()
    text = "Shift parallelism: naïve ∑ tokens"
    assert a.encode(text) == b.encode(text)
    assert a.encode(text, bos=False) == b.encode(text, bos=False)
    ids = a.encode(text) + [a.EOS, a.PAD]
    assert a.decode(ids) == b.decode(ids) == text
    assert (a.vocab_size, a.BOS, a.EOS, a.PAD) == (b.vocab_size, b.BOS,
                                                   b.EOS, b.PAD)
