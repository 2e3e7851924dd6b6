"""Port parity for packed sub-int8 serving: ``ServeEngine(weight_quant=
"int4[-block]"|"int2[-block]")`` against repro's through ``generate``, the
chunked ``Scheduler``, the paged engine and the ragged tick; the CLI's
``--wq``/``--wq-block``; and the weight-byte account of
``benchmarks/serve_bench.py`` (``weight_payload_bytes``) on the port.

Both engines integerize the same float weights (bit-identical, see
``test_torch_subint8.py``), and on the CPU both multiply through the plain
versions, so greedy tokens, tick timelines and stats are held equal.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.registry import get_config as j_get_config
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bench.serve_bench import bench_weight_formats, weight_payload_bytes
from repro_torch.convert import params_from_numpy
from repro_torch.core.qformat import PackedQTensor
from repro_torch.launch import serve as t_launch
from repro_torch.models.registry import get_config
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(2)
VOCAB = 503
PROMPT, NEW, SLOTS = 12, 10, 4
FORMATS = ["int4-block", "int2-block"]


def _reference_bench():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "serve_bench.py"
    spec = importlib.util.spec_from_file_location("reference_serve_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    jm = j_get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="off")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_config("smollm-135m-smoke").build()
    return jm, jp, tm, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def engines(smoke):
    """Memoized (JAX engine, port engine) pairs of one geometry."""
    jm, jp, tm, tp = smoke
    made = {}

    def get(weight_quant, max_len=48, batch_slots=SLOTS, **kw):
        key = (weight_quant, max_len, batch_slots, tuple(sorted(kw.items())))
        if key not in made:
            made[key] = (JServeEngine(model=jm, params=jp, max_len=max_len,
                                      batch_slots=batch_slots, weight_quant=weight_quant,
                                      quantized_kv=True, **kw),
                         ServeEngine(model=tm, params=tp, max_len=max_len,
                                     batch_slots=batch_slots, weight_quant=weight_quant,
                                     quantized_kv=True, device="cpu", **kw))
        return made[key]

    return get


def _reqs(n=5, *, seed=3, base_len=5, stride=3, max_new=6):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, VOCAB, size=base_len + stride * i, dtype=np.int32),
                    max_new, i) for i in range(n)]


def checked(engines, weight_quant, eng_kw, sched_kw, reqs):
    """The port's run, after holding its tokens, ticks and stats to repro's."""
    je, te = engines(weight_quant, **eng_kw)
    jreqs = [JRequest(r.rid, r.prompt, r.max_new, r.arrival) for r in reqs]
    want, wstats = je.scheduler(**sched_kw).run(jreqs, warmup=False)
    got, gstats = te.scheduler(**sched_kw).run(reqs, warmup=False)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, (weight_quant, rid)
        assert (got[rid].admitted_at, got[rid].finished_at, got[rid].status) == \
            (want[rid].admitted_at, want[rid].finished_at, want[rid].status), rid
    for key in ("decode_steps", "tokens_out", "prefill_chunks", "peak_pages_in_use",
                "prefix_hits", "p50_ttft_steps", "p99_ttft_steps"):
        assert gstats.summary()[key] == wstats.summary()[key], key
    return got, gstats


@pytest.mark.parametrize("weight_quant", FORMATS + ["int4"])
def test_generate_tokens_match_reference(engines, weight_quant):
    je, te = engines(weight_quant, max_len=PROMPT + NEW)
    prompts = np.random.default_rng(1).integers(0, VOCAB, (SLOTS, PROMPT)).astype(np.int32)
    want = np.asarray(je.generate(jnp.asarray(prompts), NEW, seed=0))
    got = te.generate(prompts, NEW, seed=0)
    np.testing.assert_array_equal(got.numpy(), want)
    kernels = [v for v in te.params["stack"]["body"][0]["ffn"].values()]
    assert all(isinstance(p["kernel"], PackedQTensor) for p in kernels)


@pytest.mark.parametrize("weight_quant", FORMATS)
def test_chunked_scheduler_matches_reference(engines, weight_quant):
    got, stats = checked(engines, weight_quant, {}, {"chunk_size": 4}, _reqs())
    assert stats.prefill_chunks > 5 and all(r.status == "ok" for r in got.values())


@pytest.mark.parametrize("weight_quant", FORMATS)
def test_paged_scheduler_matches_reference(engines, weight_quant):
    rng = np.random.default_rng(7)
    head = rng.integers(0, VOCAB, size=16, dtype=np.int32)
    reqs = [Request(i, np.concatenate([head, rng.integers(0, VOCAB, size=4, dtype=np.int32)]),
                    5, 0 if i == 0 else 8) for i in range(4)]
    _, stats = checked(engines, weight_quant, {"paged_kv": True, "page_size": 8},
                       {"chunk_size": 8}, reqs)
    assert stats.prefix_hits > 0


@pytest.mark.parametrize("weight_quant", FORMATS)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_ragged_scheduler_matches_reference(engines, weight_quant, paged):
    eng_kw = {"paged_kv": True, "page_size": 8} if paged else {}
    reqs = _reqs()
    base, _ = checked(engines, weight_quant, eng_kw, {"chunk_size": 4}, reqs)
    got, _ = checked(engines, weight_quant, eng_kw,
                     {"chunk_size": 4, "ragged": True, "prefill_lanes": 2}, reqs)
    for rid in base:
        assert got[rid].tokens == base[rid].tokens, rid


def test_launch_serve_subint8_on_cpu(monkeypatch, capsys):
    """``--wq int4-block --wq-block 16`` reaches the engine: every GEMM
    kernel is packed int4 with one scale per 16 K rows."""
    made = []

    class Recording(ServeEngine):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    monkeypatch.setattr(t_launch, "ServeEngine", Recording)
    argv = ["--arch", "smollm-135m-smoke", "--policy", "chunked", "--chunk-size", "4",
            "--slots", "2", "--prompt-len", "8", "--requests", "4", "--max-new", "6",
            "--wq", "int4-block", "--wq-block", "16", "--qkv", "--device", "cpu"]
    results = t_launch.main(argv)
    assert "[chunked] warmup(compile)" in capsys.readouterr().out
    assert sorted(results) == list(range(4))
    assert all(r.status == "ok" and len(r.tokens) == 6 for r in results.values())
    kernel = made[0].params["stack"]["body"][0]["mixer"]["wq"]["kernel"]
    assert isinstance(kernel, PackedQTensor)
    assert (kernel.width, kernel.block_size, kernel.n.shape[-2]) == (4, 16, 64 // 16)


@pytest.mark.parametrize("weight_quant", [False, True, "int4", "int4-block", "int2-block"])
def test_weight_payload_bytes_match_reference(engines, smoke, weight_quant):
    if weight_quant:
        je, te = engines(weight_quant)
        jparams, tparams = je.params, te.params
    else:
        _, jparams, _, tparams = smoke
    want = _reference_bench().weight_payload_bytes(jparams)
    assert weight_payload_bytes(tparams) == want
    if weight_quant in ("int4", "int4-block"):
        int8 = weight_payload_bytes(engines(True)[1].params)["kernel_bytes"]
        assert 2 * want["kernel_bytes"] == int8 and want["table_bytes"] > 0


def test_bench_weight_formats_on_cpu(smoke):
    """The frontier's serving side runs, repeats token for token, and keeps
    the reference's hard rule: int4 kernel bytes <= 0.5x int8's."""
    _, _, tm, tp = smoke
    out = bench_weight_formats(tm, tp, VOCAB, smoke=True, device="cpu")
    assert set(out) == {"workload", "fp32", "int8", "int4"}
    assert all(out[f]["repeat_identical"] and out[f]["tok_s"] > 0 for f in
               ("fp32", "int8", "int4"))
    assert out["int4"]["kernel_bytes"] <= 0.5 * out["int8"]["kernel_bytes"]
    assert out["int4"]["kernel_bytes"] * 8 == out["fp32"]["kernel_bytes"]
