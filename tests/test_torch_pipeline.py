"""The port's token pipeline against the JAX package's: the same batches,
bit for bit, for any (seed, step, shard); skip-ahead, prefetch and
labels.  Both draw from ``np.random.default_rng``, so equality is exact."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig,
    PrefetchingLoader,
    TokenPipeline,
)


@pytest.mark.parametrize("seed,shards,shard_id,start", [
    (0, 1, 0, 0), (7, 1, 0, 5), (3, 2, 0, 0), (3, 2, 1, 11),
    (123, 4, 3, 2),
])
def test_batches_equal_jax_bit_for_bit(seed, shards, shard_id, start):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=8,
              num_shards=shards, shard_id=shard_id, seed=seed)
    port = TokenPipeline(DataConfig(**kw), start_step=start)
    ref = JTokenPipeline(JDataConfig(**kw), start_step=start)
    for _ in range(3):
        a, b = port.next_batch(), ref.next_batch()
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
    assert port.state() == ref.state()


def _pipe(**kw):
    return TokenPipeline(DataConfig(vocab_size=512, seq_len=16,
                                    global_batch=4, **kw))


def test_skip_to_reproduces_the_stream():
    p1 = _pipe()
    batches = [p1.next_batch() for _ in range(5)]
    p2 = _pipe()
    p2.skip_to(3)
    np.testing.assert_array_equal(p2.next_batch()["tokens"],
                                  batches[3]["tokens"])
    p3 = TokenPipeline.from_state(p1.cfg, {"step": 2, "seed": 0})
    np.testing.assert_array_equal(p3.next_batch()["labels"],
                                  batches[2]["labels"])


def test_prefetch_matches_sync():
    sync = _pipe()
    pre = PrefetchingLoader(_pipe(), depth=2)
    try:
        for _ in range(4):
            np.testing.assert_array_equal(pre.next_batch()["tokens"],
                                          sync.next_batch()["tokens"])
    finally:
        pre.close()
    assert not pre._thread.is_alive()


def test_labels_are_shifted_tokens():
    b = _pipe().next_batch()
    assert b["tokens"].shape == b["labels"].shape == (4, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 512


def test_shards_disjoint():
    a = _pipe(num_shards=2, shard_id=0).next_batch()
    b = _pipe(num_shards=2, shard_id=1).next_batch()
    assert a["tokens"].shape == (2, 16)
    assert not np.array_equal(a["tokens"], b["tokens"])
