"""The port's data pipeline (``repro_torch/data/pipeline.py``, a copy of the
reference's numpy code) against the reference: ``TokenPipeline`` batches and
``FeaturePipeline`` blocks equal bit for bit over several steps, seeds and
``host`` / ``n_hosts`` splits, and the two pipeline properties of
``tests/test_data_and_specs.py``."""
import numpy as np
import pytest

import repro.data as r_data
import repro_torch.data as data
from repro.data.pipeline import FeaturePipeline as RFeaturePipeline
from repro.data.pipeline import TokenPipeline as RTokenPipeline
from repro_torch.data import FeaturePipeline, TokenPipeline


@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 16, 8, 3),
                                                  (49_152, 128, 8, 0),
                                                  (512, 7, 12, 11)])
def test_token_batches_equal_the_reference(vocab, seq, batch, seed):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    port, ref = TokenPipeline(**kw), RTokenPipeline(**kw)
    for n_hosts in (1, 2, 4):
        for host in range(n_hosts):
            for step in (0, 1, 5, 1_000):
                got = port.batch(step, host=host, n_hosts=n_hosts)
                want = ref.batch(step, host=host, n_hosts=n_hosts)
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
    for got, want, _ in zip(port, ref, range(3)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_classes,seed", [(2, 0), (5, 4)])
def test_feature_blocks_equal_the_reference(n_classes, seed):
    kw = dict(n_total=10_000, dim=6, seed=seed, n_classes=n_classes)
    port, ref = FeaturePipeline(**kw), RFeaturePipeline(**kw)
    for start, count in ((0, 64), (64, 64), (5_000, 17)):
        (x, y), (rx, ry) = port.block(start, count), ref.block(start, count)
        assert x.dtype == rx.dtype == np.float32
        assert y.dtype == ry.dtype == np.int64
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)


def test_token_pipeline_deterministic():
    p = TokenPipeline(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    a = p.batch(5)
    b = p.batch(5)
    np.testing.assert_array_equal(a, b)
    c = p.batch(6)
    assert not np.array_equal(a, c)
    assert a.shape == (8, 17) and a.dtype == np.int32
    assert a.min() >= 0 and a.max() < 1000


def test_token_pipeline_sharding_partitions_global_batch():
    """Each host's rows are deterministic and disjoint in randomness (the
    host index enters the seed)."""
    p = TokenPipeline(vocab_size=100, seq_len=8, global_batch=8, seed=0)
    h0 = p.batch(3, host=0, n_hosts=2)
    h1 = p.batch(3, host=1, n_hosts=2)
    assert h0.shape == (4, 9) and h1.shape == (4, 9)
    assert not np.array_equal(h0, h1)
    # re-computation for replay gives identical shards
    np.testing.assert_array_equal(h0, p.batch(3, host=0, n_hosts=2))


def test_data_package_exports_the_reference_names():
    assert sorted(data.__all__) == sorted(r_data.__all__)
    for name in data.__all__:
        assert getattr(data, name) is not None
