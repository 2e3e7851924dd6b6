"""The port's data modules (``repro_torch.data``, numpy only) against
repro's, array for array: the synthetic classification sets of the three
paper datasets (1-D and 2-D, with and without normalization and extra
noise), mixup, the LM token stream and the step-indexed Markov batches,
and the pipeline's restart determinism."""
import numpy as np
import pytest

from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro_torch.data import pipeline, synthetic


@pytest.mark.parametrize("name,kw", [("uci-har", {}), ("smnist", dict(extra_noise=0.5)),
                                     ("gtsrb", dict(normalize=False, seed=3))])
def test_classification_datasets_equal_the_reference(name, kw):
    got = synthetic.make_classification_dataset(name, n_train=48, n_test=16, **kw)
    want = j_synthetic.make_classification_dataset(name, n_train=48, n_test=16, **kw)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_mixup_equals_the_reference():
    x = np.random.default_rng(0).normal(0, 1, (10, 5, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[np.arange(10) % 4]
    got = synthetic.mixup(x, y, np.random.default_rng(1))
    want = j_synthetic.mixup(x, y, np.random.default_rng(1))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("vocab,seed", [(503, 0), (49152, 4)])
def test_token_streams_equal_the_reference(vocab, seed):
    got = list(synthetic.lm_token_batches(vocab, 3, 12, seed=seed, n_batches=3))
    want = list(j_synthetic.lm_token_batches(vocab, 3, 12, seed=seed, n_batches=3))
    assert len(got) == len(want) == 3
    bf, jbf = pipeline.markov_batch_fn(vocab, 3, 12, seed=seed), \
        j_pipeline.markov_batch_fn(vocab, 3, 12, seed=seed)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(bf(step)[k], jbf(step)[k])
    np.testing.assert_array_equal(got[0]["labels"][:, :-1], got[0]["tokens"][:, 1:])


def test_pipeline_restores_mid_stream():
    bf = pipeline.markov_batch_fn(1000, 4, 16, seed=7)
    pipe = pipeline.DataPipeline(bf)
    seen = [next(pipe)["tokens"] for _ in range(5)]
    assert pipe.state() == {"step": 5}
    again = pipeline.DataPipeline(bf)
    again.restore({"step": 3})
    np.testing.assert_array_equal(next(again)["tokens"], seen[3])
    assert not np.array_equal(seen[3], seen[4])
