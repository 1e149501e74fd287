"""The port's token pipeline (``repro_torch.data.tokens``) against the reference's.

``TokenStream.batch_at`` draws from NumPy's ``SeedSequence([seed, step,
host_index])`` in both packages, so the batches are bit-equal; host shards
are disjoint; ``Prefetcher`` keeps its order, on the host and as tensors
on a device.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import tokens as jtokens  # noqa: E402
from repro_torch.data.tokens import Prefetcher, TokenConfig, TokenStream  # noqa: E402


@pytest.mark.parametrize("seed,step,host_index,n_hosts", [
    (0, 0, 0, 1), (0, 17, 0, 1), (3, 5, 1, 2), (11, 1000, 3, 4), (2**31 - 1, 7, 0, 2),
])
def test_batch_at_is_bit_equal_to_reference(seed, step, host_index, n_hosts):
    kw = dict(vocab_size=503, seq_len=32, global_batch=8, seed=seed, n_hosts=n_hosts,
              host_index=host_index)
    got = TokenStream(TokenConfig(**kw)).batch_at(step)
    want = jtokens.TokenStream(jtokens.TokenConfig(**kw)).batch_at(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert got["tokens"].shape == (8 // n_hosts, 32)
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    assert got["tokens"].min() >= 0 and got["tokens"].max() < 503


def test_host_shards_are_disjoint_and_resume_replays():
    kw = dict(vocab_size=50, seq_len=8, global_batch=8, n_hosts=2)
    h0 = TokenStream(TokenConfig(**kw, host_index=0)).batch_at(0)
    h1 = TokenStream(TokenConfig(**kw, host_index=1)).batch_at(0)
    assert h0["tokens"].shape == (4, 8)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    stream = TokenStream(TokenConfig(vocab_size=100, seq_len=16, global_batch=4))
    first = [b["tokens"] for _, b in zip(range(10), stream)]
    for s in range(6, 10):
        np.testing.assert_array_equal(stream.batch_at(s)["tokens"], first[s])
    with pytest.raises(ValueError):
        TokenConfig(vocab_size=10, seq_len=4, global_batch=5, n_hosts=2).host_batch


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetcher_keeps_order(device):
    stream = TokenStream(TokenConfig(vocab_size=100, seq_len=8, global_batch=2))
    pf = Prefetcher(stream, start_step=5, depth=2, device=device)
    try:
        got = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, batch in got:
        want = stream.batch_at(s)
        for k in want:
            if device is None:
                np.testing.assert_array_equal(batch[k], want[k])
            else:
                assert torch.is_tensor(batch[k]) and batch[k].device.type == "cpu"
                np.testing.assert_array_equal(batch[k].numpy(), want[k])
