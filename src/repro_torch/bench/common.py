"""Shared training utilities of the benchmarks (``benchmarks/common.py``):
the synthetic datasets, the paper's ResNetv1-6 training loop (float or QAT)
and test accuracy.

ResNetv1-6 has no ``loss`` of its own: the loop takes the one-hot negative
log-likelihood of its logits, with SGD (momentum 0.9, decay 5e-4), the
paper's multi-step schedule (x0.13 at 2/3 and 5/6 of the iterations) and
batches drawn with replacement from a seeded numpy generator, as the
reference does.  The training split lives on the device and each batch is
gathered there; the step reads nothing back.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.microai_resnet import build_resnet
from repro_torch.core.policy import QuantPolicy
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.nn.module import Context, eval_context, resolve_device, tree_device
from repro_torch.optim import multistep_lr, sgd
from repro_torch.train.trainer import value_and_grad

_DATA_CACHE: Dict[Tuple, Tuple] = {}


def dataset(name: str, n_train=1024, n_test=384, seed=0, extra_noise=0.0):
    """(x_train, y_train, x_test, y_test) numpy arrays, made once per setting."""
    key = (name, n_train, n_test, seed, extra_noise)
    if key not in _DATA_CACHE:
        _DATA_CACHE[key] = make_classification_dataset(
            name, n_train=n_train, n_test=n_test, seed=seed, extra_noise=extra_noise)
    return _DATA_CACHE[key]


def nll_loss(model, policy: QuantPolicy):
    """``(params, x, y) -> (loss, {})``: the mean one-hot NLL of the logits
    of a training-mode forward under ``policy``."""
    def loss_fn(params, x, y):
        logits = model.apply(params, x, Context(policy=policy, train=True))
        oh = torch.nn.functional.one_hot(y.to(torch.int64), logits.shape[-1]).to(logits.dtype)
        return -torch.mean(torch.sum(oh * torch.log_softmax(logits, dim=-1), dim=-1)), {}
    return loss_fn


def train_resnet(dataset_name: str, filters: int, *, iters: int = 400,
                 policy: Optional[QuantPolicy] = None, lr: float = 0.02,
                 seed: int = 0, init_params=None, batch: int = 64,
                 extra_noise: float = 0.0, device=None):
    """Train the paper's ResNetv1-6 (float, or QAT under ``policy``) on a
    synthetic dataset; returns (model, params, (x_test, y_test)) with the
    test split as numpy arrays.  ``init_params`` starts from given
    parameters (QAT fine-tuning after float training); otherwise they come
    from a generator seeded with ``seed`` on ``device`` (``cuda`` unless
    given)."""
    x_tr, y_tr, x_te, y_te = dataset(dataset_name, extra_noise=extra_noise)
    if init_params is not None and device is None:
        device = tree_device(init_params)
    dev = resolve_device(device)
    model = build_resnet(dataset_name, filters=filters, device=dev)
    params = init_params or model.init(torch.Generator(device=dev).manual_seed(seed))
    opt = sgd(momentum=0.9, weight_decay=5e-4)
    opt_state = opt.init(params)
    sched = multistep_lr(lr, milestones=(iters * 2 // 3, iters * 5 // 6), gamma=0.13)
    loss_fn = nll_loss(model, policy or QuantPolicy.float32())
    x_dev, y_dev = torch.from_numpy(x_tr).to(dev), torch.from_numpy(y_tr).to(dev)
    rng = np.random.default_rng(seed)        # the reference's draws, one batch at a time
    idx = torch.from_numpy(np.stack([rng.integers(0, x_tr.shape[0], batch)
                                     for _ in range(iters)])).to(dev)
    lrs = sched(torch.arange(iters, device=dev))
    for it in range(iters):
        (_, _), grads = value_and_grad(loss_fn, params, x_dev.index_select(0, idx[it]),
                                       y_dev.index_select(0, idx[it]))
        params, opt_state = opt.update(grads, opt_state, params, lrs[it])
    return model, params, (x_te, y_te)


def accuracy(model, params, test, policy: Optional[QuantPolicy] = None,
             qstate=None) -> float:
    """Argmax accuracy of a no-gradient forward over the test split."""
    x, y = test
    dev = tree_device(params)
    with torch.no_grad():
        logits = model.apply(params, torch.as_tensor(x).to(dev),
                             eval_context(policy or QuantPolicy.float32(), qstate=qstate))
    if hasattr(logits, "dequantize"):
        logits = logits.dequantize()
    hit = torch.argmax(logits, dim=-1) == torch.as_tensor(y).to(dev)
    return float(torch.mean(hit.to(torch.float32)))
