"""Post-training quantization: activation calibration (``repro/core/ptq.py``).

CALIB-mode forwards record max|x| per quant site; Eq. 1-2 turn the ranges
into frozen exponents (``qstate``), which EVAL fake-quant and
:mod:`repro_torch.core.integerize` consume.  Weight exponents come from the
tensors themselves, or from ``network_frac_bits`` in per-network mode.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from repro_torch.core import qformat
from repro_torch.core.policy import Granularity, QMode, QuantPolicy


def ranges_to_qstate(ranges: Dict[str, torch.Tensor],
                     policy: QuantPolicy) -> Dict[str, torch.Tensor]:
    """Recorded max|x| statistics -> frozen int32 exponents (Eq. 1-2)."""
    if policy.granularity is Granularity.PER_NETWORK and policy.network_frac_bits is not None:
        return {k: torch.full((), policy.network_frac_bits, dtype=torch.int32,
                              device=torch.as_tensor(v).device) for k, v in ranges.items()}
    return {k: qformat.frac_bits_for(v, policy.act_bits) for k, v in ranges.items()}


def calibrate(apply_fn: Callable, params, batches: Iterable, policy: QuantPolicy, *,
              existing: Optional[Dict[str, torch.Tensor]] = None,
              observer="minmax") -> Dict[str, torch.Tensor]:
    """Run CALIB-mode forwards ``apply_fn(params, batch, ctx)`` over
    ``batches`` and return the frozen activation exponents; ``observer``
    picks the range accumulation (``"minmax"``, ``"ema"`` or an instance)."""
    from repro_torch.core.observers import make_observer
    from repro_torch.nn.module import Context

    calib_policy = policy.with_mode(QMode.CALIB)
    obs = make_observer(observer)
    if existing:
        obs.observe(existing)
    with torch.no_grad():
        for batch in batches:
            ctx = Context(policy=calib_policy, train=False)
            apply_fn(params, batch, ctx)
            obs.observe(ctx.stats)
    return obs.qstate(policy)
