"""Activation-range observers for PTQ calibration (``repro/core/observers.py``).

An observer absorbs each batch's per-site max|x| statistics (recorded by a
CALIB-mode forward) and converts the accumulated ranges into frozen pow2
exponents.  :class:`MinMaxObserver` keeps the running max (order
invariant); :class:`EMAObserver` an exponential moving average of the
per-batch maxima.  :func:`calibrate_tokens` runs the flow over an LM's
token stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Union

import torch


@dataclasses.dataclass
class MinMaxObserver:
    """Running max|x| per quant site: the stream's envelope."""

    ranges: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def observe(self, stats: Dict[str, torch.Tensor]) -> None:
        for k, v in stats.items():
            v = torch.as_tensor(v).to(torch.float32)
            self.ranges[k] = torch.maximum(self.ranges[k], v) if k in self.ranges else v

    def qstate(self, policy) -> Dict[str, torch.Tensor]:
        from repro_torch.core.ptq import ranges_to_qstate

        return ranges_to_qstate(dict(self.ranges), policy)


@dataclasses.dataclass
class EMAObserver:
    """EMA of per-batch max|x|; the first batch seeds the average."""

    decay: float = 0.9
    ranges: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def observe(self, stats: Dict[str, torch.Tensor]) -> None:
        for k, v in stats.items():
            v = torch.as_tensor(v).to(torch.float32)
            if k in self.ranges:
                # a float32 scalar on the host, as the reference's jnp.float32
                d = torch.tensor(self.decay, dtype=torch.float32)
                self.ranges[k] = d * self.ranges[k] + (1.0 - d) * v
            else:
                self.ranges[k] = v

    def qstate(self, policy) -> Dict[str, torch.Tensor]:
        from repro_torch.core.ptq import ranges_to_qstate

        return ranges_to_qstate(dict(self.ranges), policy)


Observer = Union[MinMaxObserver, EMAObserver]

_OBSERVERS = {"minmax": MinMaxObserver, "ema": EMAObserver}


def make_observer(kind: Union[str, Observer] = "minmax", **kw) -> Observer:
    """``"minmax"`` / ``"ema"`` (plus kwargs) or a ready observer instance."""
    if not isinstance(kind, str):
        return kind
    try:
        return _OBSERVERS[kind](**kw)
    except KeyError:
        raise ValueError(
            f"unknown observer {kind!r}; expected one of {sorted(_OBSERVERS)}") from None


def calibrate_tokens(model, params, token_batches: Iterable, policy, *,
                     observer: Union[str, Observer] = "minmax",
                     existing: Optional[Dict[str, torch.Tensor]] = None,
                     ) -> Dict[str, torch.Tensor]:
    """Activation exponents for an LM from a token stream: each (B, T)
    batch of token ids runs through ``model.apply`` under a CALIB-mode
    context, its recorded max|x| statistics fold into the observer
    (stacked layers share a site, so a site's statistic is the max over its
    layers, as in the reference's scan), and the frozen qstate ``{site: n}``
    comes back.  Tokens move to the parameters' device."""
    from repro_torch.core.policy import QMode
    from repro_torch.nn.module import Context, tree_device

    obs = make_observer(observer)
    if existing:
        obs.observe(existing)
    calib_policy = policy.with_mode(QMode.CALIB)
    device = tree_device(params)
    with torch.no_grad():
        for toks in token_batches:
            ctx = Context(policy=calib_policy, train=False)
            model.apply(params, torch.as_tensor(toks, dtype=torch.int32).to(device), ctx)
            obs.observe(ctx.stats)
    return obs.qstate(policy)
