"""Port parity: lockstep serving and the restart policy against repro's, the
launch CLI on the CPU, device selection and the import boundary."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.qformat import QTensor as JQ
from repro.models.registry import get_config as j_get_config
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import run_restart_batching as j_run_restart
from repro.serve.engine import sample_tokens as j_sample_tokens
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as t_launch
from repro_torch.models.registry import get_config
from repro_torch.nn.module import resolve_device
from repro_torch.serve import Request, ServeEngine, run_restart_batching, sample_tokens

torch.set_num_threads(2)
SRC = Path(__file__).resolve().parents[1] / "src"

# the four deployment variants of examples/serve_quantized_lm.py
VARIANTS = {"float": {}, "int8-weights": {"weight_quant": True},
            "int8-kv": {"quantized_kv": True},
            "int8-weights+kv": {"weight_quant": True, "quantized_kv": True}}
PROMPT, NEW, SLOTS = 12, 16, 4


def to_numpy(tree):
    """The reference's tree as numpy leaves; QTensors become q/n/width dicts."""
    if isinstance(tree, JQ):
        return {"q": np.asarray(tree.q), "n": np.asarray(tree.n), "width": tree.width,
                "channel_axis": tree.channel_axis}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def smoke():
    jm = j_get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="off")
    jp = jm.init(jax.random.PRNGKey(0))
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (SLOTS, PROMPT), 0, 503,
                                          dtype=jnp.int32))
    tm = get_config("smollm-135m-smoke").build()
    return jm, jp, tm, params_from_numpy(to_numpy(jp), "cpu"), prompts


@pytest.fixture(scope="module")
def reference_tokens(smoke):
    jm, jp, _, _, prompts = smoke
    out = {}
    for name, kw in VARIANTS.items():
        eng = JServeEngine(model=jm, params=jp, max_len=PROMPT + NEW, batch_slots=SLOTS, **kw)
        out[name] = np.asarray(eng.generate(jnp.asarray(prompts), NEW, seed=0))
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_greedy_tokens_match_reference(smoke, reference_tokens, variant):
    _, _, tm, tp, prompts = smoke
    eng = ServeEngine(model=tm, params=tp, max_len=PROMPT + NEW, batch_slots=SLOTS,
                      device="cpu", **VARIANTS[variant])
    got = eng.generate(prompts, NEW, seed=0)
    assert got.dtype == torch.int32 and got.shape == (SLOTS, NEW)
    np.testing.assert_array_equal(got.numpy(), reference_tokens[variant])


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_cache_bytes_match_reference(smoke, quantized_kv):
    jm, jp, tm, tp, _ = smoke
    j = JServeEngine(model=jm, params=jp, max_len=40, batch_slots=3, quantized_kv=quantized_kv)
    t = ServeEngine(model=tm, params=tp, max_len=40, batch_slots=3, quantized_kv=quantized_kv,
                    device="cpu")
    assert t.cache_bytes() == j.cache_bytes()


def test_run_restart_batching_matches_reference(smoke):
    jm, jp, tm, tp, _ = smoke
    rng = np.random.default_rng(0)
    specs = [(i, rng.integers(0, 503, size=8).astype(np.int32), 4 if i % 2 else 7, i)
             for i in range(5)]
    j_eng = JServeEngine(model=jm, params=jp, max_len=15, batch_slots=2,
                         weight_quant=True, quantized_kv=True)
    t_eng = ServeEngine(model=tm, params=tp, max_len=15, batch_slots=2, weight_quant=True,
                        quantized_kv=True, device="cpu")
    want, j_stats = j_run_restart(j_eng, [JRequest(r, p, m, a) for r, p, m, a in specs],
                                  warmup=False)
    got, t_stats = run_restart_batching(t_eng, [Request(r, p, m, a) for r, p, m, a in specs],
                                        warmup=False)
    assert sorted(got) == sorted(want)
    for rid in want:
        g, w = got[rid], want[rid]
        assert g.tokens == w.tokens
        assert (g.admitted_at, g.finished_at, g.latency_steps) == \
            (w.admitted_at, w.finished_at, w.latency_steps)
    assert t_stats.latencies_steps == j_stats.latencies_steps
    assert t_stats.decode_steps == j_stats.decode_steps
    assert t_stats.occupancy == pytest.approx(j_stats.occupancy)
    assert t_stats.peak_cache_bytes == j_stats.peak_cache_bytes


def test_run_restart_rejects_mixed_prompt_lengths(smoke):
    _, _, tm, tp, _ = smoke
    eng = ServeEngine(model=tm, params=tp, max_len=20, batch_slots=2, device="cpu")
    with pytest.raises(ValueError, match="equal prompt lengths"):
        run_restart_batching(eng, [Request(0, [1, 2, 3], 2), Request(1, [1, 2], 2)])


@pytest.mark.parametrize("vocab", [503, 512, 0])
def test_greedy_sampling_masks_the_padded_tail(vocab):
    logits = np.random.default_rng(vocab).normal(0, 1, (3, 512)).astype(np.float32)
    logits[1, 505] = 50.0                     # a winner inside the padded tail
    want = j_sample_tokens(jnp.asarray(logits), None, vocab, 0.0)
    got = sample_tokens(torch.from_numpy(logits), None, vocab, 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_sampling_is_seeded_and_in_vocab(smoke):
    _, _, tm, tp, prompts = smoke
    eng = ServeEngine(model=tm, params=tp, max_len=PROMPT + 6, batch_slots=SLOTS,
                      temperature=1.0, device="cpu")
    a, b = eng.generate(prompts, 6, seed=3), eng.generate(prompts, 6, seed=3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(a.min()) >= 0 and int(a.max()) < 503


def test_sub_int8_weights_wait_for_their_slice(smoke):
    """The weight formats are the reference's: an unknown one such as
    ``"int3"`` is refused by both engines with the same ValueError."""
    jm, jp, tm, tp, _ = smoke
    msg = r"weight_quant='int3': expected True, 'int8', 'int4\[-block\]' or 'int2\[-block\]'"
    with pytest.raises(ValueError, match=msg):
        ServeEngine(model=tm, params=tp, max_len=8, batch_slots=1, weight_quant="int3",
                    device="cpu")
    with pytest.raises(ValueError, match=msg):
        JServeEngine(model=jm, params=jp, max_len=8, batch_slots=1, weight_quant="int3")


@pytest.mark.parametrize("policy", ["lockstep", "restart"])
def test_launch_serve_runs_on_cpu(policy, capsys):
    argv = ["--arch", "smollm-135m-smoke", "--policy", policy, "--slots", "2",
            "--prompt-len", "6", "--requests", "3", "--max-new", "5", "--max-new-min", "3",
            "--arrival-spacing", "1", "--wq", "--qkv", "--device", "cpu"]
    t_launch.main(argv)
    out = capsys.readouterr().out
    assert f"[{policy}] warmup(compile)" in out and "tok/s" in out


def test_launch_serve_names_the_next_slice_for_other_policies():
    """Every policy of the reference's CLI is ported; the paged cache takes
    the chunked and ragged policies only, as in the reference, and refuses
    restart."""
    with pytest.raises(SystemExit, match="requires --policy chunked or ragged"):
        t_launch.main(["--arch", "smollm-135m-smoke", "--policy", "restart", "--paged",
                       "--device", "cpu"])


def test_registry_serves_smollm_and_names_the_waiting_slice():
    """Every id of the reference's registry resolves in the port, at full
    and smoke size, to the reference's id and depth; an unknown id raises
    ``KeyError``.  (No slice is left waiting: the name is kept.)"""
    from repro.models.registry import get_config as j_get_config
    from repro.models.registry import list_archs as j_list_archs
    from repro_torch.models.registry import list_archs

    assert sorted(list_archs()) == sorted(j_list_archs())
    for arch in j_list_archs():
        for size in ("", "-smoke"):
            got, want = get_config(arch + size), j_get_config(arch + size)
            assert (got.arch_id, got.n_layers, got.d_model) == \
                (want.arch_id, want.n_layers, want.d_model)
    assert get_config("smollm-135m").n_layers == 30
    assert get_config("smollm-135m-smoke").d_model == 64
    # the dense-family archs, at full and smoke size
    for arch, layers, d_model in (("glm4-9b", 40, 4096), ("qwen2.5-14b", 48, 5120),
                                  ("command-r-plus-104b", 64, 12288),
                                  ("internvl2-2b", 24, 2048),
                                  # the recurrent archs
                                  ("mamba-130m", 24, 768), ("rwkv6-7b", 32, 4096),
                                  # the encoder-decoder
                                  ("whisper-tiny", 4, 384)):
        full, small = get_config(arch), get_config(arch + "-smoke")
        assert (full.arch_id, full.n_layers, full.d_model) == (arch, layers, d_model)
        assert (small.arch_id, small.n_layers, small.d_model) == (arch + "-smoke", 2, 64)
    assert (get_config("whisper-tiny").enc_layers, get_config("whisper-tiny-smoke").enc_seq) \
        == (4, 16)
    assert (get_config("phi3.5-moe-42b-a6.6b").n_experts,
            get_config("kimi-k2-1t-a32b-smoke").n_layers,
            get_config("jamba-v0.1-52b-smoke").layout) == (16, 3, "mmmammmm")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-17")


def test_entry_points_need_cuda_unless_cpu_is_asked(smoke):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    _, _, tm, tp, _ = smoke
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model=tm, params=tp, max_len=8, batch_slots=1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_launch.main(["--arch", "smollm-135m-smoke", "--policy", "lockstep"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_repro():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(SRC)!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20
