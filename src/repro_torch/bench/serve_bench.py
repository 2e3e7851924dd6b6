"""The weight-format side of ``benchmarks/serve_bench.py``, on the port.

``bench_weight_formats`` serves one workload through the chunked scheduler
with each serving weight format (fp32, int8, packed int4 with per-block
scales), repeats it and requires the repeat to give the same tokens, and
counts each format's weight bytes with :func:`weight_payload_bytes`.  The
entry points run on the card unless ``device`` says otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qformat import PackedQTensor, QTensor
from repro_torch.serve import Request, ServeEngine

# Weight formats on the serving frontier: engine ``weight_quant`` specs.
WEIGHT_FORMATS = {"fp32": False, "int8": True, "int4": "int4-block"}


def make_workload(n_requests: int, prompt_len: int, short_new: int, long_new: int,
                  spacing: int, vocab: int, seed: int = 0):
    """Request i arrives at tick i * spacing with a random prompt and
    ``short_new`` (even i) or ``long_new`` (odd i) tokens to generate."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=prompt_len, dtype=np.int32),
                    max_new=short_new if i % 2 == 0 else long_new, arrival=i * spacing)
            for i in range(n_requests)]


def weight_payload_bytes(params) -> dict:
    """Serving weight bytes by kind.

    ``kernel_bytes``: the GEMM weight payload (container bytes: 1 per int8
    element, exactly half that for packed int4 at even K); ``table_bytes``:
    the embedding tables; ``scale_bytes``: the exponent grids, 4 bytes per
    exponent, apart so the packed formats' payload is counted alone;
    ``float_bytes``: everything left in float (norms, biases).
    """
    out = {"kernel_bytes": 0, "table_bytes": 0, "scale_bytes": 0, "float_bytes": 0}

    def rec(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v, name)
        elif isinstance(node, PackedQTensor):
            out["kernel_bytes"] += node.nbytes_packed
            out["scale_bytes"] += node.n.numel() * 4
        elif isinstance(node, QTensor):
            key = "table_bytes" if name == "table" else "kernel_bytes"
            out[key] += node.q.numel() * node.q.element_size()
            out["scale_bytes"] += node.n.numel() * 4
        elif isinstance(node, torch.Tensor):
            key = ("kernel_bytes" if name == "kernel"
                   else "table_bytes" if name == "table" else "float_bytes")
            out[key] += node.numel() * node.element_size()

    rec(params, "")
    return out


def bench_weight_formats(model, params, vocab: int, *, smoke: bool = True, seed: int = 0,
                         weight_block: int = 32, device=None) -> dict:
    """Tok/s and weight bytes of each format in :data:`WEIGHT_FORMATS` on the
    same workload through the chunked scheduler; each run is repeated and
    must give the same tokens (sub-int8 serving stays deterministic)."""
    if smoke:
        wl = dict(n_requests=8, prompt_len=64, short_new=8, long_new=16, spacing=2, slots=4,
                  chunk=32)
    else:
        wl = dict(n_requests=16, prompt_len=256, short_new=8, long_new=32, spacing=2,
                  slots=4, chunk=64)
    workload = make_workload(wl["n_requests"], wl["prompt_len"], wl["short_new"],
                             wl["long_new"], wl["spacing"], vocab, seed=seed)
    max_len = wl["prompt_len"] + wl["long_new"]
    out = {"workload": {**wl, "max_len": max_len, "weight_block": weight_block}}
    for name, spec in WEIGHT_FORMATS.items():
        eng = ServeEngine(model=model, params=params, max_len=max_len,
                          batch_slots=wl["slots"], weight_quant=spec,
                          weight_block=weight_block, device=device)
        res, st = eng.scheduler(chunk_size=wl["chunk"]).run(workload, seed=seed,
                                                            time_ticks=True)
        res2, _ = eng.scheduler(chunk_size=wl["chunk"]).run(workload, seed=seed)
        for r in workload:
            if res2[r.rid].tokens != res[r.rid].tokens:
                raise RuntimeError(f"weight format {name}: non-deterministic stream on "
                                   f"rid {r.rid}")
        pb = weight_payload_bytes(eng.params)
        out[name] = {"tok_s": round(st.steady_tok_s, 2), "repeat_identical": True, **pb}
        print(f"wfmt/{name:5s} {st.steady_tok_s:8.1f} tok/s | kernel payload "
              f"{pb['kernel_bytes']} B | scales {pb['scale_bytes']} B", flush=True)
    return out
