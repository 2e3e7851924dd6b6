"""Synthetic datasets, statistically matched to the paper's three benchmarks
(``repro/data/synthetic.py``, numpy only; the port keeps its own copy).

The real datasets are not in the repository: UCI-HAR / SMNIST / GTSRB are
replaced by class-conditional generators with the same shapes, channel counts
and class counts, built so that class structure lives at several scales
(per-class base frequency + channel mixing + noise).  A float model reaches
high accuracy quickly, and — the property the paper's claims C1–C4 are about —
quantization degrades it through *value-grid* error, not through dataset
quirks.  Absolute paper accuracies are not claimed; relative float/int16/int8
behaviour is.

Also provides the LM token stream used by the big-arch examples: a Zipf-ish
unigram mix with Markov structure so cross-entropy has learnable signal.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from repro_torch.configs.microai_resnet import DATASETS


def make_classification_dataset(
    name: str, *, n_train: int = 2048, n_test: int = 512, seed: int = 0,
    normalize: bool = True, extra_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train, y_train, x_test, y_test), channels-last float32.

    Class c draws a smooth class template (sinusoid bank with class-specific
    frequencies/phases for 1D; oriented gratings for 2D) plus per-sample jitter
    and noise — the same "classes differ in spectral content" structure that
    makes UCI-HAR/SMNIST/GTSRB solvable by small convnets.
    """
    ds = DATASETS[name]
    rng = np.random.default_rng(seed)
    n_total = n_train + n_test
    classes = ds.classes

    if ds.ndim == 1:
        samples, channels = ds.in_shape
        t = np.linspace(0.0, 1.0, samples, dtype=np.float32)
        # class templates: k sinusoids with class-dependent freq per channel
        freqs = rng.uniform(1.0, 14.0, size=(classes, channels, 3)).astype(np.float32)
        phases = rng.uniform(0, 2 * np.pi, size=(classes, channels, 3)).astype(np.float32)
        amps = rng.uniform(0.4, 1.2, size=(classes, channels, 3)).astype(np.float32)
        y = rng.integers(0, classes, size=n_total)
        x = np.zeros((n_total, samples, channels), np.float32)
        for i in range(n_total):
            c = y[i]
            jitter = 1.0 + 0.08 * rng.standard_normal((channels, 3)).astype(np.float32)
            # per-channel sum of 3 class-specific sinusoids
            wave = np.sin(2 * np.pi * (freqs[c] * jitter)[..., None] * t
                          + phases[c][..., None])            # (ch, 3, T)
            x[i] = (wave * (amps[c] * jitter)[..., None]).sum(1).T
        x += 0.35 * rng.standard_normal(x.shape).astype(np.float32)
    else:
        h, w, channels = ds.in_shape
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy, xx = yy / h - 0.5, xx / w - 0.5
        theta = rng.uniform(0, np.pi, size=classes).astype(np.float32)
        freq = rng.uniform(2.0, 8.0, size=classes).astype(np.float32)
        color = rng.uniform(-1.0, 1.0, size=(classes, channels)).astype(np.float32)
        y = rng.integers(0, classes, size=n_total)
        x = np.zeros((n_total, h, w, channels), np.float32)
        for i in range(n_total):
            c = y[i]
            th = theta[c] + 0.1 * rng.standard_normal()
            u = xx * np.cos(th) + yy * np.sin(th)
            grating = np.sin(2 * np.pi * freq[c] * u
                             + rng.uniform(0, 2 * np.pi)).astype(np.float32)
            x[i] = grating[..., None] * color[c][None, None, :]
        x += 0.3 * rng.standard_normal(x.shape).astype(np.float32)

    if extra_noise:
        # "hard mode": pushes the float model off the accuracy ceiling so the
        # int8-vs-int16 separation (paper C2/C4) is measurable
        x += extra_noise * rng.standard_normal(x.shape).astype(np.float32)
    if normalize:  # z-score of the training split (paper Sec. 6)
        mu = x[:n_train].mean(axis=0, keepdims=True)
        sd = x[:n_train].std(axis=0, keepdims=True) + 1e-6
        x = (x - mu) / sd
    y = y.astype(np.int32)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def mixup(x: np.ndarray, y_onehot: np.ndarray, rng: np.random.Generator,
          alpha: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """Mixup (paper Sec. 6 uses it during training)."""
    lam = rng.beta(alpha, alpha)
    perm = rng.permutation(x.shape[0])
    return lam * x + (1 - lam) * x[perm], lam * y_onehot + (1 - lam) * y_onehot[perm]


def lm_token_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
                     n_batches: int = 0) -> Iterator[dict]:
    """Markov-structured token stream: learnable, deterministic per (seed,
    step), so the pipeline state in a checkpoint is just the step counter.
    Batch ``step`` is :func:`repro_torch.data.pipeline.markov_batch_fn`'s."""
    from repro_torch.data.pipeline import markov_batch_fn

    batch_fn = markov_batch_fn(vocab, batch, seq, seed=seed)
    step = 0
    while n_batches == 0 or step < n_batches:
        yield batch_fn(step)
        step += 1
