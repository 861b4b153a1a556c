"""The port's synthetic data pipeline against the JAX package's (numpy
only on both sides): ``SyntheticLM.batch_at`` gives the reference's
batches exactly, for several steps, host splits and seeds, and the
prefetch loader hands them out in step order from its start step."""
import numpy as np
import pytest

from repro.data import pipeline as ref_pipeline

from repro_torch.data import pipeline


@pytest.mark.parametrize("seed,vocab,seq,batch,n_hosts", [
    (0, 256, 32, 4, 1), (1, 8192, 17, 8, 2), (7, 151936, 64, 8, 4),
    (3, 50, 5, 6, 3)])
def test_batch_at_equals_the_reference(seed, vocab, seq, batch, n_hosts):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ours = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
    theirs = ref_pipeline.SyntheticLM(ref_pipeline.DataConfig(**kw))
    for step in (0, 1, 5, 123):
        for host in range(n_hosts):
            a = ours.batch_at(step, host, n_hosts)
            b = theirs.batch_at(step, host, n_hosts)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a["tokens"][:, 1:],
                                          a["labels"][:, :-1])


def test_prefetch_loader_order():
    cfg = pipeline.DataConfig(vocab_size=256, seq_len=8, global_batch=2,
                              prefetch=3)
    src = pipeline.SyntheticLM(cfg)
    loader = pipeline.PrefetchLoader(src, start_step=3)
    try:
        for want in (3, 4, 5, 6):
            b = next(loader)
            assert b["_step"] == want
            np.testing.assert_array_equal(b["tokens"],
                                          src.batch_at(want)["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()
