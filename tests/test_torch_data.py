"""The port's synthetic data pipeline against the reference's, on the CPU.

``repro_torch.data.pipeline`` is numpy only; its batches must equal the
reference's bit for bit (tolerance 0: the same ``hash((seed, step,
host))`` seeds and the same numpy draws): token prompts, frontend models'
patch embeddings and enc-dec models' source frames, at several steps and
host shards, and through the prefetching iterator from any start step.
"""

import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline

KINDS = {"dense": {}, "frontend": dict(frontend_len=4, d_model=16),
         "encdec": dict(encdec=True, frontend_len=3, d_model=16)}


def _pair(kind, n_hosts=1, host=0, **kw):
    base = dict(vocab_size=512, seq_len=32, global_batch=8, seed=3,
                **KINDS[kind], **kw)
    return (SyntheticPipeline(DataConfig(**base), host_index=host,
                              n_hosts=n_hosts),
            JPipeline(JDataConfig(**base), host_index=host, n_hosts=n_hosts))


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_batch_at_equals_the_reference(kind, hosts):
    ours, theirs = _pair(kind, n_hosts=hosts[0], host=hosts[1])
    for step in (0, 1, 7, 1234):
        _equal(ours.batch_at(step), theirs.batch_at(step))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_iterator_resumes_at_start_step(kind):
    ours, theirs = _pair(kind, branching=2)
    it, jit_ = ours.iterator(start_step=5, depth=2), theirs.iterator(
        start_step=5, depth=2)
    try:
        for i in range(3):
            got = next(it)
            _equal(got, ours.batch_at(5 + i))
            _equal(got, next(jit_))
    finally:
        it.close()
        jit_.close()


def test_hosts_must_split_the_batch():
    with pytest.raises(ValueError, match="does not split"):
        SyntheticPipeline(DataConfig(vocab_size=16, seq_len=4,
                                     global_batch=6), n_hosts=4)
