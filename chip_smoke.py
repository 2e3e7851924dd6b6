"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printed as it completes; any failure exits non-zero:
  1. card name and power limit, torch version, CUDA capability (must be 9.0);
  2. build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all at once) and its time; the two weight-only GEMMs
     must hold tensor-core (HMMA) instructions in their machine code, and
     ``qmm`` and ``qconv1d`` integer tensor-core (IMMA) ones and no dp4a;
  3. each kernel against its plain PyTorch version on the card at the
     path's shapes, with kernel, plain and library times (CUDA graphs of
     many launches over rotating inputs larger than the L2) and the least
     time the card could take (bytes at 3.35 TB/s, f32 FMAs at 67 TFLOP/s,
     bf16 products at 989 TFLOP/s (three per f32 product in the weight-only
     GEMMs and the chunk pair), int8 products at 1,979 TOP/s and int16 at a quarter of that
     (four 8-bit products each), H100 SXM data sheet); the integer
     engine's four kernels bit for bit (``qmm`` and ``qmm_requant`` at the
     classifier's (2947, 80) @ (80, 6) and 4096^3, int8 and int16, with
     int32 wrap (int8 all -128 at K = 196608, int16 extreme codes) and
     shifts of 32 or more; ``qconv1d`` at ResNetv1-6's four
     convolution shapes at B=2947 and the edge cases; ``fake_quant`` on a
     120.7 MB activation at every n in [-20, 20]); the chunk kernels (one
     core, a cluster of R blocks per query tile, printed with their register
     counts; bf16x3 tensor-core bounds with the f32 figure beside them) also
     have the cache rows they write held bit for bit and every other row
     held unchanged, at S=2048 from start 0 to 1984, C = 1, 16, 32, D = 16,
     64, 128 and G = 3, 16, with a start on the card and a chunk written
     into pool page 0 under an unmapped entry, and are timed at R = 1, 2, 4,
     8; ``qdecode_attn`` (the paged decode's split walk over the dense
     cache as a pool of page size S) also on post-norm codes with rows at
     kv_len <= 0 and past S, at D=128 and G=16, byte-equal to
     ``qpaged_decode_attn`` under the table {b} at ps = S, timed at R = 1,
     2, 4, 8, and refusing a cache off 16 bytes; the paged kernels run
     over fragmented, out-of-order page tables with pages shared between
     slots, beside the dense kernels on the same contents, and
     ``qpaged_decode_attn`` over a page-size sweep;
     ``qragged_attn`` on the ragged tick (8 decode rows, 2 lanes x 32 chunk
     rows) over the dense identity layout and fragmented tables (page sizes
     16, 1, 5), with edge and all-inert ticks and cross-checks against the
     decode and chunk kernels; both (split across a cluster of R blocks,
     printed with their register counts) also at D = 16, 32, 64, 128 and
     G = 1, 5, 16; ``wq_matmul`` at M = 8, 32 (a mixed tick's
     chunk), 72 and 144 (the ragged ticks' GEMM rows) and 1024;
     ``wq4_matmul`` at the four projection shapes, per-channel and block-32
     scales, M = 8, 32, 72, 144 and 1024, plus an odd K with a partial last
     block, and held (untimed) at scales 2^-n with n in 13-20 and block
     sizes 4, 10 and 16; ``qconv1d`` also past one block's shared memory
     (C=1024 int16 at K=7, and an int32 wrap across channel chunks);
  4. smollm-135m at full width (random weights from a seeded generator,
     int8 weights and int8 KV cache): ``ServeEngine.generate`` (8 slots,
     prompt 128, 32 new tokens), ``run_restart_batching``, and the
     continuous-batching ``Scheduler`` with one-shot and chunked (C = 32)
     admission (the same 16 requests: prompt 128, 32/64 new tokens, arrival
     spacing 2), each with the kernels' launch counts checked against the
     path's expected counts; the logits of a prefill, a decode step and a
     mixed step are held to the plain versions;
  5. the paged engine (``--paged``, the engine's CUDA page size, a pool at
     dense parity) on the same 16 requests, 8 requests sharing a 96-token
     opening, and 8 of the requests oversubscribed at half the pool under
     recompute and under swap preemption (full width, 4 layers deep), with
     launch counts checked; a
     paged mixed step's logits against the plain versions; a paged decode
     tick and mixed tick profiled, syncs counted;
  6. ``Scheduler(chunk_size=32, ragged=True, prefill_lanes=2)`` on the 16
     requests, dense and paged, on the shared prefix and at half the pool
     under recompute and swap (4 layers deep, as in 5), and
     ``bench_burst``'s full burst (16 x 192
     tokens at tick 0, 16 slots, 4 lanes, budget 160) beside the paged
     mixed step, with TTFT in ticks and ms: launch counts exact, greedy
     tokens held to the chunked runs; a ragged tick's logits against the
     plain versions; a dense and a paged ragged tick profiled;
  7. packed int4 weights with block-32 scales (``--wq int4-block``):
     ``generate``, the chunked ``Scheduler`` on the 16 requests, the paged
     engine and the ragged tick, with exact launch counts (7 x 30
     ``wq4_matmul`` per forward, no ``wq_matmul``), logits and generated
     tokens held to the plain versions, paged and ragged tokens held to the
     chunked run; per-channel ``int4`` and ``int2-block`` generate (int2:
     no kernel); an int4 decode step and int8 / int4 forwards at M = 72
     profiled, int8 and int4 ragged runs of 8 requests in turns;
     ``bench_weight_formats`` at its full setting (fp32 / int8 / int4-block,
     16 requests of 256 tokens, chunk 64) at full width and 4 layers deep,
     with its token-identical repeats and int4 kernel bytes <= 0.5x int8;
  8. the paper's integer engine: ResNetv1-6 at filters 80 on 2947
     UCI-HAR-shaped windows (seeded), calibrated on 4 batches of 32,
     integerized int8 per-layer and int16 Q7.9, full-integer forwards with
     exactly 6 ``qconv1d`` and 1 ``qmm`` launches each, logits equal to the
     plain versions', argmax agreement with the EVAL fake-quant forward >
     0.9 and int8 ROM > 3.5x smaller than f32; ``fake_quant`` and
     ``qmm_requant`` through their ``ops`` entry points; inferences/s and a
     profile of each integer forward beside the float forward;
  9. training (``train_end_to_end``): the paper's flow on ResNetv1-6 at
     filters 80 (float training, int8 QAT fine-tuning, calibration,
     integerization, the integer forward over the synthetic test split with
     exactly 6 ``qconv1d`` + 1 ``qmm`` launches and logits equal to the plain
     versions'; accuracies and a profiled step of each training); smollm-135m
     at full width through ``launch.train.main`` (AdamW, B=8, S=128, float
     and ``--qat``: the loss falls; a preempted run resumes exactly; tokens/s,
     a profiled step, syncs, peak memory); the card's gradient held to the
     CPU's at smollm-135m-smoke and ResNet filters 12, float and QAT.
After each phase that runs a weight-only GEMM, each GEMM library's count
of shared-memory grants must be at most 3 (``[grants]``).
Each phase prints its seconds (``[time]``).
The line before the last is a JSON summary per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_S = 67e12         # H100 SXM f32 rate outside the tensor cores
INT8_OPS_S = 1979e12       # H100 SXM dense int8 tensor-core rate
BF16_FLOP_S = 989e12       # H100 SXM dense bf16 tensor-core rate
L2_ROTATE_BYTES = 128 << 20
WQ_RTOL = 2e-5             # |kernel - plain| <= WQ_RTOL * max|plain| (f32 sums, other order)
ATTN_ATOL = 1e-4           # softmax-weighted means of values within +-16
LOGIT_ATOL = 2e-2          # logits after 30 layers; int8 KV codes may flip at trunc edges
FLOAT_KV_LOGIT_ATOL = 1e-4  # the same over a float KV cache: f32 sums in another order only
NO_INT = {"qmm": 0, "qmm_requant": 0, "qconv1d": 0,      # the integer engine's kernels
          "fake_quant": 0}
NO_PAGED = {"qpaged_decode_attn": 0, "qpaged_chunk_attn": 0,   # the dense int8 paths' counts
            "qragged_attn": 0, "wq4_matmul": 0, **NO_INT}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi exit {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def split_registers(log: str, entry: str) -> str:
    """'D/G: registers (spill bytes)' of each instantiation of ``entry``
    (templated on D and the G bucket, or on D alone) in a ``-Xptxas -v``
    build log."""
    import re

    out, key = [], None
    for line in log.splitlines():
        hit = re.search(entry + r"ILi(\d+)E(?:Li(\d+)E)?", line)
        if "Compiling entry" in line:
            key = ("/".join(x for x in hit.groups() if x) if hit else None)
            spill = 0
        elif key and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{key}: {regs}" + (f" ({spill} B spilled)" if spill else ""))
            key = None
    return ", ".join(out)


def graph_ms(torch, calls, iters):
    """Device ms per call: ``iters`` calls cycling through ``calls``,
    captured in one CUDA graph and replayed between CUDA events."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            calls[i % len(calls)]()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del g
    return ms


def bound(nbytes: float, flops: float, rate: float = F32_FLOP_S):
    """(least ms, what bounds it) for ``nbytes`` moved and ``flops`` done at
    ``rate`` operations/s (f32 outside the tensor cores unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rotated(make, nbytes):
    """Enough copies of an input (``make()`` draws one) to rotate past the L2."""
    return [make() for _ in range(max(1, min(1200, math.ceil(L2_ROTATE_BYTES / nbytes))))]


def int_codes(torch, gen, shape, dtype, lo=None):
    """Uniform integer codes over the whole range of ``dtype`` (from ``lo``)."""
    info = torch.iinfo(dtype)
    return torch.randint(info.min if lo is None else lo, info.max + 1, shape, generator=gen,
                         device="cuda", dtype=torch.int32).to(dtype)


def max_err(got, want) -> float:
    """Largest |got - want| over two tensors of integer or f32 values (as
    float64, exact for both)."""
    return float((got.double() - want.double()).abs().max()) if want.numel() else 0.0


def int_rate(dtype):
    """Peak integer operations/s for operands of ``dtype`` on the tensor
    cores: int8 at the int8 rate; int16 at a quarter of it, since the
    kernels do each int16 product as four 8-bit products (a = 256 hi + lo,
    hi signed and lo unsigned bytes; ``csrc/int_mma.cuh``)."""
    import torch

    return INT8_OPS_S if dtype == torch.int8 else INT8_OPS_S / 4


SHALLOW_LAYERS = 4           # depth of the oversubscribed runs and bench_weight_formats
PATH_BATCH = 2947            # UCI-HAR's test split: the integer engine's batch
RESNET_FILTERS = 80          # the widest ResNetv1-6 of the paper's sweep (Tables A3/A4)


def check_qmm(torch, ref, kern, gen):
    """``qmm`` vs plain, bit for bit: the classifier's (2947, 80) @ (80, 6),
    4096^3 and an odd shape, int8 and int16, plus full-range int16 at K=512,
    whose sums overflow int32 and must wrap as the plain version's do.  The
    library time is ``torch._int_mm`` where it takes the shape (int8), else,
    for int8 with K * 2^14 < 2^24, ``torch.matmul`` on the codes as f32
    (exact: every partial sum is an integer below 2^24); int16 has none.
    Untimed: int8 codes all -128 at (16, 196608) @ (196608, 8), where every
    sum is 3 * 2^30 and wraps (K split over 8 cluster ranks), and int16 at
    the extreme codes (-32768, 32767 and their neighbours)."""
    x = torch.full((16, 196608), -128, dtype=torch.int8, device="cuda")
    w = torch.full((196608, 8), -128, dtype=torch.int8, device="cuda")
    got, want = kern(x, w), ref.qmm_ref(x, w)
    check(torch.equal(got, want) and bool((want == -(1 << 30)).all()),
          f"qmm int8 wrap case: kernel {got[0, :4].tolist()}, plain {want[0, :4].tolist()}")
    codes = torch.tensor([-32768, -32767, -256, -1, 0, 1, 255, 256, 32767], dtype=torch.int16,
                         device="cuda")
    for m, k, n in ((128, 512, 128), (100, 300, 50)):
        x = codes[torch.randint(0, len(codes), (m, k), generator=gen, device="cuda")]
        w = codes[torch.randint(0, len(codes), (k, n), generator=gen, device="cuda")]
        got, want = kern(x, w), ref.qmm_ref(x, w)
        check(torch.equal(got, want), f"qmm int16 extreme codes ({m}, {k}) @ ({k}, {n}): differs "
                                      f"from plain at {int((got != want).sum())} entries")
    torch.cuda.synchronize()
    print("[kernel] qmm: equal to plain with int8 codes all -128 at (16, 196608) @ (196608, 8) "
          "(every sum 3 * 2^30 wraps to -2^30) and int16 extreme codes at (128, 512) @ "
          "(512, 128) and (100, 300) @ (300, 50)", flush=True)
    rows = []
    cases = [("classifier", PATH_BATCH, RESNET_FILTERS, 6), ("4096^3", 4096, 4096, 4096),
             ("odd", 100, 300, 50), ("int16 overflow", 128, 512, 128)]
    for label, m, k, n in cases:
        for dt in (torch.int8, torch.int16):
            if label == "int16 overflow" and dt == torch.int8:
                continue
            size = torch.tensor([], dtype=dt).element_size()
            xs = rotated(lambda: int_codes(torch, gen, (m, k), dt), size * (m * k + k * n))
            ws = [int_codes(torch, gen, (k, n), dt) for _ in xs]
            got, want = kern(xs[0], ws[0]), ref.qmm_ref(xs[0], ws[0])
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(got.dtype == torch.int32 and torch.equal(got, want),
                  f"qmm {label} {dt}: differs from plain at "
                  f"{int((got != want).sum())} of {want.numel()} (max_abs_err {err})")
            wide = torch.matmul(xs[0].double(), ws[0].double()).to(torch.int64)
            wraps = bool((wide != want.to(torch.int64)).any())
            del wide
            if label == "int16 overflow":
                check(wraps, "qmm int16 overflow case: no sum passed int32")
            pairs = list(zip(xs, ws))
            iters = max(len(pairs), 8 if m * n * k > 1 << 30 else 64)
            ms = graph_ms(torch, [lambda a=a, b=b: kern(a, b) for a, b in pairs], iters)
            plain = graph_ms(torch, [lambda a=a, b=b: ref.qmm_ref(a, b) for a, b in pairs],
                             iters)
            lib, lib_name = None, "library none"
            if dt == torch.int8 and m > 16 and k % 8 == 0 and n % 8 == 0:
                lib_name = "torch._int_mm"
                lib = graph_ms(torch, [lambda a=a, b=b: torch._int_mm(a, b) for a, b in pairs],
                               iters)
            elif dt == torch.int8 and k << 14 < 1 << 24:
                lib_name = "torch.matmul f32"
                fpairs = [(a.float(), b.float()) for a, b in pairs]
                check(torch.equal(torch.matmul(*fpairs[0]).to(torch.int32), want),
                      f"qmm {label}: f32 matmul of the codes is not exact")
                lib = graph_ms(torch, [lambda a=a, b=b: torch.matmul(a, b) for a, b in fpairs],
                               iters)
                del fpairs
            b_ms, b_by = bound(size * (m * k + k * n) + 4 * m * n, 2.0 * m * k * n, int_rate(dt))
            rows.append(dict(label=label, m=m, k=k, n=n, dtype=str(dt).split(".")[-1], ms=ms,
                             plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                             err=err))
            print(f"[kernel] qmm {label} ({m}, {k}) @ ({k}, {n}) {rows[-1]['dtype']}: equal to "
                  f"plain{' (int32 wrap)' if wraps else ''} | kernel {ms * 1e3:.2f} us | plain "
                  f"{plain * 1e3:.2f} us | {lib_name} "
                  f"{'' if lib is None else f'{lib * 1e3:.2f} us '}| bound "
                  f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
            del xs, ws, pairs
    return rows


def check_qmm_requant(torch, ref, kern, gen):
    """``qmm_requant`` vs plain, bit for bit, over shifts -33, -3, 0, 5, 11,
    31, 32 and 40 (XLA's sign fill and zero past 31), widths 8 and 16, at the
    classifier's shape; timed there and at 4096^3, int8 and int16."""
    rows, err = [], 0.0
    m, k, n = PATH_BATCH, RESNET_FILTERS, 6
    for dt in (torch.int8, torch.int16):
        x, w = int_codes(torch, gen, (m, k), dt), int_codes(torch, gen, (k, n), dt)
        for width in (8, 16):
            for sh in (-33, -3, 0, 5, 11, 31, 32, 40):
                s = torch.tensor(sh, dtype=torch.int32, device="cuda")
                got, want = kern(x, w, s, width=width), ref.qmm_requant_ref(x, w, s, width=width)
                torch.cuda.synchronize()
                err = max(err, max_err(got, want))
                check(got.dtype == want.dtype and torch.equal(got, want),
                      f"qmm_requant {dt} width {width} shift {sh}: differs from plain")
    print("[kernel] qmm_requant: equal to plain at shifts -33 -3 0 5 11 31 32 40, widths 8 "
          "and 16, int8 and int16 operands", flush=True)
    for label, (m, k, n) in (("classifier", (PATH_BATCH, RESNET_FILTERS, 6)),
                             ("4096^3", (4096, 4096, 4096))):
        for dt in (torch.int8, torch.int16):
            size = torch.tensor([], dtype=dt).element_size()
            xs = rotated(lambda: int_codes(torch, gen, (m, k), dt), size * (m * k + k * n))
            ws = [int_codes(torch, gen, (k, n), dt) for _ in xs]
            s = torch.tensor(11, dtype=torch.int32, device="cuda")
            pairs = list(zip(xs, ws))
            iters = max(len(pairs), 8 if m * n * k > 1 << 30 else 64)
            ms = graph_ms(torch, [lambda a=a, b=b: kern(a, b, s) for a, b in pairs], iters)
            plain = graph_ms(torch, [lambda a=a, b=b: ref.qmm_requant_ref(a, b, s)
                                     for a, b in pairs], iters)
            b_ms, b_by = bound(size * (m * k + k * n) + m * n + 4, 2.0 * m * k * n, int_rate(dt))
            rows.append(dict(label=label, m=m, k=k, n=n, dtype=str(dt).split(".")[-1], ms=ms,
                             plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                             err=err))
            print(f"[kernel] qmm_requant {label} ({m}, {k}) @ ({k}, {n}) {rows[-1]['dtype']}, "
                  f"shift 11, width 8: kernel {ms * 1e3:.2f} us | plain {plain * 1e3:.2f} us | "
                  f"library none | bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
            del xs, ws, pairs
    return rows


def check_qconv1d(torch, F, ref, kern, gen):
    """``qconv1d`` vs plain, bit for bit, at ResNetv1-6's four convolution
    shapes at B=2947 (C=9->80 and 80->80 at W=128, the k=1 shortcut, 80->80
    at W=32), int8 and int16, and at the edge cases (stride 2, VALID, odd
    F).  Library: ``F.conv1d`` in f32 on the int8 codes (exact: every sum
    is below 2^24), channels-first; int16 has none."""
    rows = []
    shapes = [("conv1", PATH_BATCH, 128, 9, RESNET_FILTERS, 3, 1, "SAME"),
              ("conv2/3", PATH_BATCH, 128, RESNET_FILTERS, RESNET_FILTERS, 3, 1, "SAME"),
              ("short1", PATH_BATCH, 128, RESNET_FILTERS, RESNET_FILTERS, 1, 1, "SAME"),
              ("conv4/5", PATH_BATCH, 32, RESNET_FILTERS, RESNET_FILTERS, 3, 1, "SAME")]
    edges = [("edge", 2, 128, 9, 16, 3, 1, "SAME"), ("edge", 3, 128, 16, 24, 3, 2, "SAME"),
             ("edge", 2, 50, 4, 8, 3, 1, "VALID"), ("edge", 1, 33, 3, 130, 7, 2, "VALID"),
             ("edge", 5, 127, 80, 77, 5, 2, "SAME"), ("edge", 4, 64, 13, 33, 4, 3, "VALID"),
             ("edge", 2, 65, 80, 40, 1, 2, "SAME"), ("edge", 3, 70, 9, 16, 2, 3, "VALID")]
    for label, b, wd, c, f, ks, st, pad in shapes + edges:
        for dt in (torch.int8, torch.int16):
            size = torch.tensor([], dtype=dt).element_size()
            x, w = int_codes(torch, gen, (b, wd, c), dt), int_codes(torch, gen, (ks, c, f), dt)
            got = kern(x, w, stride=st, padding=pad)
            want = ref.qconv1d_ref(x, w, stride=st, padding=pad)
            torch.cuda.synchronize()
            err = max_err(got, want) if got.shape == want.shape else math.inf
            check(got.dtype == torch.int32 and got.shape == want.shape
                  and torch.equal(got, want),
                  f"qconv1d {label} B={b} W={wd} C={c} F={f} K={ks} stride {st} {pad} {dt}: "
                  f"differs from plain")
            if label == "edge":
                continue
            wout = got.shape[1]
            xs = [x] + rotated(lambda: int_codes(torch, gen, (b, wd, c), dt),
                               size * b * wd * c)[1:]
            iters = max(len(xs), 16)
            ms = graph_ms(torch, [lambda a=a: kern(a, w, stride=st, padding=pad) for a in xs],
                          iters)
            plain = graph_ms(torch, [lambda a=a: ref.qconv1d_ref(a, w, stride=st, padding=pad)
                                     for a in xs], iters)
            lib = None
            if dt == torch.int8:
                xf = [a.to(torch.float32).transpose(1, 2).contiguous() for a in xs[:4]]
                wf = w.to(torch.float32).permute(2, 1, 0).contiguous()
                lib = graph_ms(torch, [lambda a=a: F.conv1d(a, wf, padding=ks // 2)
                                       for a in xf], iters)
                del xf
            b_ms, b_by = bound(size * (b * wd * c + ks * c * f) + 4 * b * wout * f,
                               2.0 * b * wout * f * ks * c, int_rate(dt))
            rows.append(dict(label=label, b=b, w=wd, c=c, f=f, k=ks, dtype=str(dt).split(".")[-1],
                             ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                             err=err))
            print(f"[kernel] qconv1d {label} B={b} W={wd} C={c} F={f} K={ks} "
                  f"{rows[-1]['dtype']}: equal to plain | kernel {ms * 1e3:.2f} us | plain "
                  f"{plain * 1e3:.2f} us | F.conv1d f32 "
                  f"{'none' if lib is None else f'{lib * 1e3:.2f} us'} | bound "
                  f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
            del xs
    print("[kernel] qconv1d: equal to plain on the edge cases (stride 2 and 3, VALID, odd F, "
          "K=1/2/4/5/7, stride above K), int8 and int16", flush=True)
    # Past one block's shared memory a block walks C in chunks, carrying its
    # sums: C=1024 int16 at K=7, and an int32 wrap across channel chunks
    # (all codes -128 at C=65536, K=3: the plain float64 sums are exact while
    # K*C < 2^23).
    from repro_torch.kernels import int_mma

    x, w = (int_codes(torch, gen, (1, 64, 1024), torch.int16),
            int_codes(torch, gen, (7, 1024, 8), torch.int16))
    check(torch.equal(kern(x, w), ref.qconv1d_ref(x, w)),
          "qconv1d C=1024 int16 at K=7 differs from plain")
    x = torch.full((1, 4, 65536), -128, dtype=torch.int8, device="cuda")
    w = torch.full((3, 65536, 8), -128, dtype=torch.int8, device="cuda")
    got, want = kern(x, w), ref.qconv1d_ref(x, w)
    check(torch.equal(got, want) and want[0, 1, 0].item() == 3 * 65536 * 16384 - 2 ** 32,
          f"qconv1d C=65536 int8 wrap case: kernel {got[0, :, 0].tolist()}, plain "
          f"{want[0, :, 0].tolist()}")
    chunks = {}
    for label, (c, k, wd, nb) in (("C=1024 int16 K=7", (1024, 7, 64, 2)),
                                  ("C=65536 int8 K=3", (65536, 3, 4, 1))):
        p = int_mma.conv_plan(1, c, k, 8, wd, 1, nb)
        chunks[label] = math.ceil(k / p.kc) * math.ceil(-(-c // 16) * 16 / p.cc)
    print(f"[kernel] qconv1d: equal to plain at C=1024 int16 K=7 ({chunks['C=1024 int16 K=7']} "
          f"chunks) and at C=65536 int8 K=3 (all codes -128: int32 wraps across "
          f"{chunks['C=65536 int8 K=3']} channel chunks)", flush=True)
    per_forward = {}
    for dt in ("int8", "int16"):
        part = {r["label"]: r for r in rows if r["dtype"] == dt}
        calls = {"conv1": 1, "conv2/3": 2, "short1": 1, "conv4/5": 2}
        per_forward[dt] = {key: (None if any(part[lb][key] is None for lb in calls) else
                                 sum(part[lb][key] * c for lb, c in calls.items()))
                           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"[kernel] qconv1d one {dt} ResNetv1-6 forward (6 calls, B={PATH_BATCH}): "
              f"kernel {per_forward[dt]['ms'] * 1e3:.2f} us | plain "
              f"{per_forward[dt]['plain_ms'] * 1e3:.2f} us | bound "
              f"{per_forward[dt]['bound_ms'] * 1e3:.2f} us", flush=True)
    return rows, per_forward


def check_fake_quant(torch, ref, kern, gen):
    """``fake_quant`` vs plain, bit for bit, on a 2947 x 128 x 80 f32
    activation (120.7 MB) at every n in [-20, 20] (|n| >= 13 included, where
    the factors are the table's, not exact powers of two), widths 8 and 16,
    n as an int and as a device scalar, plus an odd-sized misaligned view
    (the scalar tail).  Timed at n = 4, width 8; bound by bytes."""
    x = torch.randn(PATH_BATCH, 128, RESNET_FILTERS, generator=gen, device="cuda") * 4.0
    err = 0.0
    for width in (8, 16):
        for n in range(-20, 21):
            nt = torch.tensor(n, dtype=torch.int32, device="cuda")
            want = ref.fake_quant_ref(x, n, width=width)
            for arg in (n, nt):
                got = kern(x, arg, width=width)
                err = max(err, max_err(got, want))
                check(torch.equal(got, want), f"fake_quant n={n} width {width}: differs from "
                                              f"plain")
    odd = x.reshape(-1)[1:1000004]
    check(torch.equal(kern(odd, 7), ref.fake_quant_ref(odd, 7)), "fake_quant odd view differs")
    torch.cuda.synchronize()
    print("[kernel] fake_quant: equal to plain at every n in [-20, 20], widths 8 and 16, n as "
          "an int and as a device scalar, and on an odd misaligned view", flush=True)
    xs = [x, torch.randn(PATH_BATCH, 128, RESNET_FILTERS, generator=gen, device="cuda")]
    ms = graph_ms(torch, [lambda a=a: kern(a, 4) for a in xs], 16)
    plain = graph_ms(torch, [lambda a=a: ref.fake_quant_ref(a, 4) for a in xs], 16)
    b_ms, b_by = bound(8.0 * x.numel(), 0.0)
    print(f"[kernel] fake_quant {tuple(x.shape)} f32, n=4: kernel {ms * 1e3:.2f} us | plain "
          f"{plain * 1e3:.2f} us | library none | bound {b_ms * 1e3:.2f} us ({b_by})",
          flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=tuple(x.shape), err=err)


SERVE_SHAPES = {"wq/wo": (576, 576), "wk/wv": (576, 192), "gate/in": (576, 1536),
                "out": (1536, 576)}          # smollm-135m's projections, (K, N)
CALLS_PER_LAYER = {"wq/wo": 2, "wk/wv": 2, "gate/in": 2, "out": 1}


def gemm_bounds(m, k, n, nbytes):
    """(bound ms, by) of an f32 (M, K) @ integer (K, N) product moving
    ``nbytes``: on the bf16 tensor cores at three passes (the kernels'
    design: the least time for exact f32 products), and, for comparison
    with the earlier table, on the f32 CUDA cores."""
    tc = bound(nbytes, 3 * 2.0 * m * k * n, BF16_FLOP_S)
    return tc, bound(nbytes, 2.0 * m * k * n)


def layer_sum(rows, keys=("ms", "plain_ms", "library_ms", "bound_ms", "f32_bound_ms")):
    """One layer's seven projections (CALLS_PER_LAYER) summed per key."""
    layer = {key: sum(r[key] * r["per_layer"] for r in rows) for key in keys}
    layer["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                         else "operations")
    return layer


def check_wq_matmul(torch, ref, wq_cuda, gen):
    """Kernel vs plain at the four projection shapes, per-channel scales
    (plus one per-tensor scale), M = 8 (decode), 32 (a mixed tick's chunk),
    72 and 144 (the ragged tick's T at B=8, L=2, C=32 and at B=16, L=4,
    C=32) and 8*128."""
    from repro_torch.kernels.wq_matmul import plan

    rows, worst = [], 0.0
    for m in (8, 32, 72, 144, 8 * 128):
        for label, (k, n) in SERVE_SHAPES.items():
            copies = max(1, min(1200, math.ceil(L2_ROTATE_BYTES / (k * n))))
            x = torch.randn(m, k, generator=gen, device="cuda")
            ws = [torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(copies)]
            scale = torch.exp2(-torch.randint(5, 10, (n,), generator=gen, device="cuda")
                               .to(torch.float32))
            want = ref.wq_matmul_ref(x, ws[0], scale)
            tol = WQ_RTOL * want.abs().max().item()
            got = wq_cuda(x, ws[0], scale)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(err <= tol, f"wq_matmul M={m} {k}x{n}: max err {err} > {tol}")
            worst = max(worst, err)
            if label == "wq/wo" and m == 72:   # one scale for the whole tensor
                one = scale[:1].clone()
                err = (wq_cuda(x, ws[0], one) - ref.wq_matmul_ref(x, ws[0], one)).abs().max()
                check(err.item() <= WQ_RTOL * ref.wq_matmul_ref(x, ws[0], one).abs().max().item(),
                      f"wq_matmul M={m} {k}x{n} per-tensor scale: max err {err.item()}")
            iters = max(len(ws), 64)
            ms = graph_ms(torch, [lambda w=w: wq_cuda(x, w, scale) for w in ws], iters)
            nbytes = 4 * m * k + k * n + 4 * n + 4 * m * n
            (b_ms, b_by), (f32_ms, _) = gemm_bounds(m, k, n, nbytes)
            deq = [w.to(torch.float32) * scale for w in
                   ws[:max(1, min(len(ws), math.ceil(L2_ROTATE_BYTES / (4 * k * n))))]]
            plain = graph_ms(torch, [lambda w=w: ref.wq_matmul_ref(x, w, scale) for w in ws],
                             iters)
            lib = graph_ms(torch, [lambda w=w: torch.matmul(x, w) for w in deq], iters)
            rows.append(dict(m=m, shape=label, k=k, n=n, err=err, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=b_ms, bound_by=b_by, f32_bound_ms=f32_ms,
                             per_layer=CALLS_PER_LAYER[label]))
            print(f"[kernel] wq_matmul M={m:4d} K={k:4d} N={n:4d} ({label}): "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}) | kernel {ms * 1e3:.2f} us "
                  f"({plan(m, k, n)}) | plain {plain * 1e3:.2f} us | torch.matmul on "
                  f"dequantized {lib * 1e3:.2f} us | bound {b_ms * 1e3:.2f} us ({b_by}; "
                  f"f32 CUDA cores {f32_ms * 1e3:.2f})", flush=True)
            del ws, deq
    layers = {}
    for m in sorted({r["m"] for r in rows}):
        layers[m] = layer = layer_sum([r for r in rows if r["m"] == m])
        what = "decode layer" if m == 8 else "layer"
        print(f"[kernel] wq_matmul one {what} (7 calls, M={m}): kernel {layer['ms'] * 1e3:.2f} "
              f"us | plain {layer['plain_ms'] * 1e3:.2f} us | library "
              f"{layer['library_ms'] * 1e3:.2f} us | bound {layer['bound_ms'] * 1e3:.2f} us "
              f"({layer['bound_by']}; f32 CUDA cores {layer['f32_bound_ms'] * 1e3:.2f})",
              flush=True)
    return rows, layers, worst


def check_wq4_matmul(torch, ref, wq4_cuda, gen):
    """Kernel vs plain at the four projection shapes of smollm-135m with
    per-channel and block-32 scales, M = 8 (decode), 32 (a mixed tick's
    chunk), 72 and 144 (ragged ticks) and 1024 (lockstep prefill), plus an
    odd K with a partial last block.  Codes are uniform int4 bytes,
    scales 2^-n with n in 3-6 (the smoke model's int4 range).  Then, held
    to plain but not timed: scales with n in 13-20 (where the reference's
    table is not exact powers of two) and block sizes 4, 10 and 16 (steps
    that span blocks) at every M."""
    from repro_torch.core.qformat import exp2, unpack_subint8
    from repro_torch.kernels.wq4_matmul import plan

    def inputs(m, k, n, bs, copies, n_lo, n_hi):
        kp, srows = -(-k // 2), (-(-k // bs) if bs else 1)
        x = torch.randn(m, k, generator=gen, device="cuda")
        ws = [torch.randint(-128, 128, (kp, n), generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.int8) for _ in range(copies)]
        ss = [exp2(-torch.randint(n_lo, n_hi + 1, (srows, n), generator=gen, device="cuda",
                                  dtype=torch.int32)) for _ in range(copies)]
        if k % 2:   # the pad nibble of the last byte row is zero, as packing leaves it
            for w in ws:
                w[-1] &= 0x0F
        return x, ws, ss

    def held(m, label, k, n, bs, x, w, s):
        got = wq4_cuda(x, w, s, k=k, block_size=bs)
        want = ref.wq4_matmul_ref(x, w, s, k=k, block_size=bs)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = WQ_RTOL * want.abs().max().item()
        check(err <= tol, f"wq4_matmul M={m} {k}x{n} block {bs}: max err {err} > {tol}")
        return err, tol

    cases = [(m, label, k, n, bs) for m in (8, 32, 72, 144) for bs in (0, 32)
             for label, (k, n) in SERVE_SHAPES.items()]
    cases += [(1024, label, k, n, bs) for bs in (0, 32)
              for label, (k, n) in SERVE_SHAPES.items()]
    cases.append((33, "odd K", 1001, 77, 32))
    rows, worst = [], 0.0
    for m, label, k, n, bs in cases:
        kp, srows = -(-k // 2), (-(-k // bs) if bs else 1)
        copies = max(1, min(1200, math.ceil(L2_ROTATE_BYTES / (kp * n + 4 * srows * n))))
        x, ws, ss = inputs(m, k, n, bs, copies, 3, 6)
        err, tol = held(m, label, k, n, bs, x, ws[0], ss[0])
        worst = max(worst, err)
        n_deq = max(1, min(copies, math.ceil(L2_ROTATE_BYTES / (4 * k * n))))
        deq = []
        for w, s in zip(ws[:n_deq], ss[:n_deq]):
            codes = unpack_subint8(w, 4, k).to(torch.float32)
            deq.append(codes * (s.repeat_interleave(bs, 0)[:k] if bs else s))
        iters = max(copies, 64)
        ms = graph_ms(torch, [lambda w=w, s=s: wq4_cuda(x, w, s, k=k, block_size=bs)
                              for w, s in zip(ws, ss)], iters)
        plain = graph_ms(torch, [lambda w=w, s=s: ref.wq4_matmul_ref(x, w, s, k=k,
                                                                     block_size=bs)
                                 for w, s in zip(ws, ss)], iters)
        lib = graph_ms(torch, [lambda w=w: torch.matmul(x, w) for w in deq], iters)
        (b_ms, b_by), (f32_ms, _) = gemm_bounds(
            m, k, n, 4 * m * k + kp * n + 4 * srows * n + 4 * m * n)
        rows.append(dict(m=m, shape=label, k=k, n=n, block=bs, err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by, f32_bound_ms=f32_ms,
                         per_layer=CALLS_PER_LAYER.get(label, 0)))
        print(f"[kernel] wq4_matmul M={m:4d} K={k:4d} N={n:4d} block {bs:2d} ({label}): "
              f"max_abs_err {err:.3e} (tol {tol:.3e}) | kernel {ms * 1e3:.2f} us "
              f"({plan(m, k, n)}) | plain {plain * 1e3:.2f} us | torch.matmul on dequantized "
              f"{lib * 1e3:.2f} us | bound {b_ms * 1e3:.2f} us ({b_by}; f32 CUDA cores "
              f"{f32_ms * 1e3:.2f})", flush=True)
        del ws, ss, deq
    for m in (8, 32, 72, 144, 1024):
        for bs in (0, 4, 10, 16, 32):
            for label, (k, n) in SERVE_SHAPES.items():
                x, ws, ss = inputs(m, k, n, bs, 1, 13, 20)
                worst = max(worst, held(m, label, k, n, bs, x, ws[0], ss[0])[0])
                if bs in (4, 10, 16):   # the small blocks at the usual exponents too
                    x, ws, ss = inputs(m, k, n, bs, 1, 3, 6)
                    worst = max(worst, held(m, label, k, n, bs, x, ws[0], ss[0])[0])
    print("[kernel] wq4_matmul: within tolerance of plain with scales 2^-n at n in 13-20 "
          "(block 0, 4, 10, 16, 32) and with blocks 4, 10, 16 at n in 3-6, at M = 8, 32, 72, "
          "144, 1024 and the four projection shapes", flush=True)
    layers = {}
    for m, bs in sorted({(r["m"], r["block"]) for r in rows if r["per_layer"]}):
        layers[(m, bs)] = layer = layer_sum(
            [r for r in rows if r["m"] == m and r["block"] == bs and r["per_layer"]])
        print(f"[kernel] wq4_matmul one layer (7 calls) at M={m}, "
              f"{'block 32' if bs else 'per-channel'}: kernel {layer['ms'] * 1e3:.2f} us | "
              f"plain {layer['plain_ms'] * 1e3:.2f} us | library "
              f"{layer['library_ms'] * 1e3:.2f} us | bound {layer['bound_ms'] * 1e3:.2f} us "
              f"({layer['bound_by']}; f32 CUDA cores {layer['f32_bound_ms'] * 1e3:.2f})",
              flush=True)
    return rows, layers, worst


def check_qdecode_attn(torch, F, ref, qd_cuda, qpd_cuda, gen):
    """Kernel vs plain at B=8, Hkv=3.  Uniform codes at D=64, G=3 (Hq=9)
    over S = 192 (the smoke run's cache), 256 and 2048 with per-row live
    lengths, and at S = 192 with one Python-int length, the form
    ``Attention.apply`` passes; then post-norm codes (``pool_codes``) at
    S = 192 and 2048 with rows at kv_len 0, -4 and past S, and at D=128,
    G=16 (Hq=48, the 16-row instantiation past 48 KB of shared memory).
    Every case is also run through ``qpaged_decode_attn`` on the same bytes
    under the table ``arange(B)[:, None]`` at ps = S: the two share one
    body, so the outputs must be equal to the byte.  The S=192 and S=2048
    serving cases are also held and timed at R = 1, 2, 4, 8, and a cache
    off 16 bytes must be refused by the wrapper and by the C entry."""
    from repro_torch.kernels import qdecode_attn as qd_mod

    b, hkv = 8, 3
    rows, worst = [], 0.0
    edge = [2048, 0, 1000, 2100, 333, -4, 64, 1999]
    # (S, lengths, D, G, codes, swept over R)
    cases = [(192, [128 + i for i in range(b)], 64, 3, "uniform", True),
             (192, 191, 64, 3, "uniform", False),
             (256, [256, 1, 100, 255, 17, 64, 200, 129], 64, 3, "uniform", False),
             (2048, [2048, 5, 1000, 2047, 333, 1536, 64, 1999], 64, 3, "uniform", True),
             (192, [150, 0, 191, 300, 1, -4, 192, 100], 64, 3, "post-norm", False),
             (2048, edge, 64, 3, "post-norm", False),
             (2048, edge, 128, 16, "post-norm", False)]
    table = torch.arange(b, dtype=torch.int32, device="cuda")[:, None]
    for s, lens, d, g, codes, sweep in cases:
        hq = g * hkv
        ranks = qd_mod.plan(b, s, hkv, d).ranks
        row_lens = [lens] * b if isinstance(lens, int) else lens
        kv_len = lens if isinstance(lens, int) else torch.tensor(lens, dtype=torch.int32,
                                                                 device="cuda")
        q = torch.randn(b, hq, d, generator=gen, device="cuda")
        copies = max(1, math.ceil(L2_ROTATE_BYTES / (2 * b * s * hkv * d)))
        if codes == "uniform":
            caches = [tuple(torch.randint(-128, 128, (b, s, hkv, d), generator=gen,
                                          device="cuda", dtype=torch.int32).to(torch.int8)
                            for _ in range(2)) for _ in range(copies)]
        else:
            caches = [tuple(pool_codes(torch, gen, (b, s, hkv, d)) for _ in range(2))
                      for _ in range(copies)]
        got = qd_cuda(q, caches[0][0], caches[0][1], 3, 3, kv_len)
        want = ref.qdecode_attn_ref(q, caches[0][0], caches[0][1], 3, 3, kv_len)
        paged = qpd_cuda(q, caches[0][0], caches[0][1], 3, 3, table, kv_len)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        label = f"qdecode_attn S={s} D={d} G={g} {codes} R={ranks}"
        check(err <= ATTN_ATOL, f"{label}: max err {err} > {ATTN_ATOL}")
        check(torch.equal(got, paged), f"{label}: differs from qpaged_decode_attn under the "
                                       f"table arange(B)[:, None] at ps = S")
        worst = max(worst, err)
        mask = (torch.arange(s, device="cuda")[None, :]
                < torch.tensor(row_lens, device="cuda")[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        lib_copies = max(1, min(copies, math.ceil(L2_ROTATE_BYTES / (8 * b * s * hq * d))))
        deq = [tuple(c.to(torch.float32).mul(0.125).repeat_interleave(g, dim=2)
                     .permute(0, 2, 1, 3).contiguous() for c in kv)
               for kv in caches[:lib_copies]]
        iters = max(copies, 64)
        ms = graph_ms(torch, [lambda kv=kv: qd_cuda(q, kv[0], kv[1], 3, 3, kv_len)
                              for kv in caches], iters)
        plain = graph_ms(torch, [lambda kv=kv: ref.qdecode_attn_ref(q, kv[0], kv[1], 3, 3,
                                                                    kv_len)
                                 for kv in caches], iters)
        lib = graph_ms(torch, [lambda kv=kv: F.scaled_dot_product_attention(
            qs, kv[0], kv[1], attn_mask=mask) for kv in deq], iters)
        live = sum(min(n, s) if n > 0 else s for n in row_lens)
        b_ms, b_by = bound(2 * 4 * b * hq * d + 2 * live * hkv * d + 4 * b,
                           4.0 * live * hq * d)
        rows.append(dict(s=s, lens=lens, d=d, g=g, codes=codes, ranks=ranks, err=err, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by))
        form = "int" if isinstance(lens, int) else "(B,) int32"
        print(f"[kernel] {label} B={b} Hq={hq} Hkv={hkv} kv_len={lens} ({form}): "
              f"max_abs_err {err:.3e} (tol {ATTN_ATOL:.0e}), equal to qpaged_decode_attn at "
              f"ps=S | kernel {ms * 1e3:.2f} us | plain {plain * 1e3:.2f} us | sdpa on "
              f"dequantized {lib * 1e3:.2f} us | bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
        del deq
        if sweep:
            cells = []
            for r in (1, 2, 4, 8):
                rerr = max_err(qd_cuda(q, caches[0][0], caches[0][1], 3, 3, kv_len, ranks=r),
                               want)
                check(rerr <= ATTN_ATOL, f"{label} at R={r}: max err {rerr}")
                r_ms = graph_ms(torch, [lambda kv=kv, r=r: qd_cuda(q, kv[0], kv[1], 3, 3, kv_len,
                                                                   ranks=r)
                                        for kv in caches], iters)
                cells.append(f"R={r} {r_ms * 1e3:.2f}")
            print(f"[kernel] {label} rank sweep (us): {' | '.join(cells)}; the rule picks "
                  f"R={ranks}", flush=True)
        del caches
    # a cache off 16 bytes: refused by the wrapper and by the C entry
    b, s, d = 2, 64, 16
    q = torch.zeros(b, 2, d, device="cuda")
    flat = torch.zeros(b * s * d + 16, dtype=torch.int8, device="cuda")
    off = flat[4:4 + b * s * d].view(b, s, 1, d)
    try:
        qd_cuda(q, off, off, 3, 3, 5)
        fail("qdecode_attn took a cache off 16 bytes")
    except ValueError:
        pass
    out = torch.empty_like(q)
    e = qd_mod._kernel()(q.data_ptr(), off.data_ptr(), off.data_ptr(), None, 3, None, 3, None, 0,
                         5, out.data_ptr(), b, s, 1, 2, d, 0.25, 1,
                         torch.cuda.current_stream().cuda_stream)
    check(e == 1, f"qdecode_attn's C entry returned {e} for a cache off 16 bytes, not "
                  f"cudaErrorInvalidValue (1)")
    print("[kernel] qdecode_attn: a cache off 16 bytes is refused (ValueError; the C entry "
          "returns cudaErrorInvalidValue)", flush=True)
    return rows, worst


def check_grants(label, ran=()):
    """The weight-only GEMM libraries each ask for their tile kernels'
    shared memory once per kernel: at most 3 ``cudaFuncSetAttribute`` calls
    a library, however many launches, and at least one in each library of
    ``ran`` (the count is live)."""
    from repro_torch.kernels import wq4_matmul, wq_matmul

    counts = {"wq_matmul": wq_matmul.grants(), "wq4_matmul": wq4_matmul.grants()}
    check(all(n <= 3 for n in counts.values()),
          f"{label}: shared-memory grants {counts}: more than 3 in a library")
    check(all(counts[name] >= 1 for name in ran), f"{label}: grants {counts}, none in {ran}")
    print(f"[grants] after {label}: cudaFuncSetAttribute calls {counts} (at most 3 a library)",
          flush=True)


def chunk_bounds(nbytes, pairs, hq, d):
    """(bf16x3 bound ms, by, f32 bound ms) of a chunk launch: ``nbytes``
    moved, 4 operations per (visible (row, position) pair, query head, dim),
    three bf16 passes on the tensor cores (``csrc/chunk_split.cuh``) and,
    after the slash in PERF.md, the same at the f32 rate."""
    flops = 4.0 * pairs * hq * d
    b_ms, b_by = bound(nbytes, 3 * flops, BF16_FLOP_S)
    return b_ms, b_by, bound(nbytes, flops)[0]


def chunk_rank_sweep(torch, label, call, tiles, hkv, d, walk, iters):
    """Device µs of one chunk case at R = 1, 2, 4, 8 (ranks past the rule's
    limit of one per 64 positions of the reach left out): ``call(ranks)``
    launches the kernel's C entry with that cluster size.  The figures
    behind ``attn_split.chunk_ranks``."""
    from repro_torch.kernels.attn_split import CHUNK_TILE, chunk_ranks

    cells = []
    for r in (1, 2, 4, 8):
        if r <= math.ceil(walk / CHUNK_TILE):
            cells.append(f"R={r} {graph_ms(torch, [lambda r=r: call(r)], iters) * 1e3:.2f}")
    print(f"[kernel] {label} rank sweep (us): {' | '.join(cells)}; the rule picks "
          f"R={chunk_ranks(walk, tiles, hkv, d)}", flush=True)


def chunk_beside(rows, main):
    """The chunk kernels' other timed cases (plain and library timed too),
    so that the S=2048 line a library call used to beat stays beside the
    serving one."""
    keys = ("c", "s", "start", "ranks", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "f32_bound_ms")
    return [{k: r[k] for k in keys} for r in rows if r is not main and "plain_ms" in r]


def check_qchunk_attn(torch, F, ref, qc_cuda, qd_cuda, gen):
    """Kernel vs plain at B=8, Hkv=3: at D=64, G=3 (Hq=9), C=32 at S=192
    (the serving path's chunks; start 160 puts the chunk's end on S) and at
    S=2048 at starts 0, 1000 and 1984 (a cluster of R=8, whose ranks end
    early on the causal limit at start 0), C=16 at an untiled start and at
    S=2048, and C=1 at S=192 and 2048, which is also held to
    ``qdecode_attn`` over the written cache; then C=32 at S=2048 at D=16,
    D=128 and G=16 (Hq=48).  Each launch targets another slot of another
    cache copy, so the prefix comes from device memory.  R is printed on
    each row; the S=2048 and S=192 serving cases are also timed at R = 1,
    2, 4, 8 through the C entry.

    Prefix codes and chunk values have the spread of post-norm K/V on the
    Q4.3 grid (|x| mostly below 2), as the CPU tests draw them, with a few
    past the grid's range so that codes saturate.  Uniform random codes
    (|x| up to 16) give scores of +-40, where any other summation order
    moves the output by about 1e-4."""
    from repro_torch.core import qformat
    from repro_torch.kernels import qchunk_attn as qc_mod
    from repro_torch.kernels.attn_split import chunk_ranks, chunk_tiles

    def codes(shape):
        x = torch.randn(shape, generator=gen, device="cuda").mul(8).round()
        x.view(-1)[::97] = 127
        return x.clamp(-128, 127).to(torch.int8)

    b, hkv = 8, 3
    rows, worst = [], 0.0
    # (C, S, start, D, G, timed against plain and library)
    cases = [(32, 192, 0, 64, 3, True), (32, 192, 96, 64, 3, True), (32, 192, 160, 64, 3, True),
             (32, 2048, 1984, 64, 3, True), (16, 192, 100, 64, 3, True), (1, 192, 150, 64, 3, True),
             (32, 2048, 0, 64, 3, False), (32, 2048, 1000, 64, 3, False),
             (16, 2048, 1500, 64, 3, False), (1, 2048, 2000, 64, 3, False),
             (32, 2048, 1000, 16, 3, False), (32, 2048, 1000, 128, 3, False),
             (32, 2048, 1000, 64, 16, False)]
    for c, s, start, d, g, timed in cases:
        hq = g * hkv
        slot = 5
        tiles = chunk_tiles(c, g)[0]
        ranks = chunk_ranks(s, tiles, hkv, d)
        q = torch.randn(c, hq, d, generator=gen, device="cuda")
        kc, vc = (1.5 * torch.randn(c, hkv, d, generator=gen, device="cuda")
                  for _ in range(2))
        kc.view(-1)[::31] = 20.0
        vc.view(-1)[::37] = -20.0
        copies = max(1, math.ceil(L2_ROTATE_BYTES / (2 * b * s * hkv * d)))
        caches = [(codes((b, s, hkv, d)), codes((b, s, hkv, d))) for _ in range(copies)]
        k0, v0 = caches[0][0].clone(), caches[0][1].clone()
        kk, vk, kp, vp = k0.clone(), v0.clone(), k0.clone(), v0.clone()
        got = qc_cuda(q, kc, vc, kk, vk, 3, 3, slot, start)
        want = ref.qchunk_attn_ref(q, kc, vc, kp, vp, 3, 3, slot, start)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        label = f"qchunk_attn C={c} S={s} start={start} D={d} G={g} R={ranks}"
        check(err <= ATTN_ATOL, f"{label}: max err {err} > {ATTN_ATOL}")
        check(torch.equal(kk, kp) and torch.equal(vk, vp),
              f"{label}: caches differ from the plain version's")
        check(torch.equal(kk[slot, start:start + c], qformat.quantize(kc, 3, 8))
              and torch.equal(vk[slot, start:start + c], qformat.quantize(vc, 3, 8)),
              f"{label}: written rows are not the chunk's codes")
        keep = torch.ones(b, s, dtype=torch.bool, device="cuda")
        keep[slot, start:start + c] = False
        check(torch.equal(kk[keep], k0[keep]) and torch.equal(vk[keep], v0[keep]),
              f"{label}: a row outside the chunk changed")
        note = ""
        if c == 1:
            qd = torch.zeros(b, hq, d, device="cuda")
            qd[slot] = q[0]
            lens = torch.full((b,), start + 1, dtype=torch.int32, device="cuda")
            dec = qd_cuda(qd, kk, vk, 3, 3, lens)[slot]
            torch.cuda.synchronize()
            derr = (dec - got[0]).abs().max().item()
            check(derr <= ATTN_ATOL, f"{label} vs qdecode_attn: max err {derr}")
            note = f" | vs qdecode_attn at kv_len {start + 1}: max_abs_err {derr:.3e}"
        worst = max(worst, err)
        calls = [(kv, j) for kv in caches for j in range(b)]
        iters = max(len(calls), 64)
        ms = graph_ms(torch, [lambda kv=kv, j=j: qc_cuda(q, kc, vc, kv[0], kv[1], 3, 3, j, start)
                              for kv, j in calls], iters)
        pairs = c * start + c * (c + 1) // 2           # visible (query row, position) pairs
        b_ms, b_by, f32_ms = chunk_bounds(2 * start * hkv * d + 2 * c * hkv * d
                                          + 4 * (2 * c * hq * d + 2 * c * hkv * d), pairs, hq, d)
        row = dict(c=c, s=s, start=start, d=d, g=g, ranks=ranks, err=err, ms=ms,
                   bound_ms=b_ms, bound_by=b_by, f32_bound_ms=f32_ms)
        timing = f"kernel {ms * 1e3:.2f} us"
        if timed:
            # library: the chunk's quantize-and-copy, then SDPA over the slot's
            # dequantized, head-expanded rows with the causal offset mask
            end = start + c
            mask = torch.arange(end, device="cuda")[None, :] <= \
                start + torch.arange(c, device="cuda")[:, None]
            qs = q.permute(1, 0, 2)[None]
            lib_copies = max(1, min(copies, math.ceil(L2_ROTATE_BYTES / (8 * end * hq * d))))
            deq = [tuple(qformat.dequantize(x[slot, :end], 3).repeat_interleave(g, dim=1)
                         .permute(1, 0, 2)[None].contiguous() for x in (kp, vp))
                   for _ in range(lib_copies)]

            def lib(kv, kq=kk, vq=vk):
                kq[slot, start:end] = qformat.quantize(kc, 3, 8)
                vq[slot, start:end] = qformat.quantize(vc, 3, 8)
                return F.scaled_dot_product_attention(qs, kv[0], kv[1], attn_mask=mask)

            plain = graph_ms(torch, [lambda kv=kv, j=j: ref.qchunk_attn_ref(
                q, kc, vc, kv[0], kv[1], 3, 3, j, start) for kv, j in calls], iters)
            lib_ms = graph_ms(torch, [lambda kv=kv: lib(kv) for kv in deq], iters)
            del deq
            row.update(plain_ms=plain, library_ms=lib_ms)
            timing += (f" | plain {plain * 1e3:.2f} us | quantize-copy + sdpa "
                       f"{lib_ms * 1e3:.2f} us")
        rows.append(row)
        print(f"[kernel] {label} B={b} Hq={hq} Hkv={hkv}: max_abs_err {err:.3e} (tol "
              f"{ATTN_ATOL:.0e}), written rows bit-identical, other rows unchanged | {timing} | "
              f"bound {b_ms * 1e3:.2f} us ({b_by}; bf16x3) / {f32_ms * 1e3:.2f} us (f32){note}",
              flush=True)
        if (c, start) in ((32, 1984), (32, 160)) and d == 64 and g == 3:
            kv = caches[0]

            def raw(r, kv=kv):
                out = torch.empty_like(q)
                e = qc_mod._kernel()(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), kv[0].data_ptr(),
                                     kv[1].data_ptr(), None, 3, None, 3, out.data_ptr(), b, c, s,
                                     hkv, g, d, slot, start, 1.0 / math.sqrt(d), r,
                                     torch.cuda.current_stream().cuda_stream)
                check(e == 0, f"{label}: launch at R={r} failed: CUDA error {e}")
                return out

            for r in (1, 2, 4, 8):    # every cluster size the rule may pick is right
                if r <= math.ceil(s / 64):
                    rerr = max_err(raw(r), want)
                    check(rerr <= ATTN_ATOL, f"{label} at R={r}: max err {rerr}")
            chunk_rank_sweep(torch, label, raw, tiles, hkv, d, s, 64)
        del caches
    return rows, worst


def paged_layout(torch, gen, b, s, ps, extra_pages=3):
    """A fragmented page table for ``b`` slots of ``s`` logical rows over a
    pool of b * ceil(s / ps) + ``extra_pages`` pages: each slot's pages are
    drawn out of order from a random permutation, and slot 1 maps slot 0's
    first two pages (a shared prefix)."""
    mp = -(-s // ps)
    n_pool = b * mp + extra_pages
    perm = torch.randperm(n_pool, generator=gen, device="cuda").to(torch.int32)
    table = perm[:b * mp].reshape(b, mp).clone()
    table[1, :2] = table[0, :2]
    return table, n_pool, mp


def pool_codes(torch, gen, shape):
    """int8 codes with the spread of post-norm K/V on the Q4.3 grid (|x|
    mostly below 2) and a few saturated ones."""
    x = torch.randn(shape, generator=gen, device="cuda").mul(8).round()
    x.view(-1)[::97] = 127
    return x.clamp(-128, 127).to(torch.int8)


def check_qpaged_decode_attn(torch, F, ref, qpd_cuda, qd_cuda, gen, page_size):
    """Kernel vs plain at B=8, Hq=9, Hkv=3, D=64 over fragmented, out-of-order
    tables with pages shared between two slots' rows, at S = 192 and 2048.
    Live lengths cover 1, a page boundary, a partial last page, the table's
    end, a length past the table (an inactive slot ticking on), and an
    evicted slot (row all -1, length > 0).  Each case is also run through
    ``qdecode_attn`` on the same logical contents laid out densely.  Then the
    page-size sweep: B=8, S=2048 for ps in 16, 32, 64, 128."""
    from repro_torch.kernels.attn_split import split_ranks

    b, hq, hkv, d = 8, 9, 3, 64
    g = hq // hkv
    rows, swept, worst = [], [], 0.0
    cases = [(s, page_size) for s in (192, 2048)] + [(2048, ps) for ps in (16, 32, 64, 128)]
    for s, ps in cases:
        table, n_pool, mp = paged_layout(torch, gen, b, s, ps)
        ranks = split_ranks(mp * ps, b, hkv, d)
        lens = [1, ps, s // 2 + ps // 2 + 1, mp * ps, s - 3, 50, mp * ps + 40, 2 * ps + 1]
        table[5] = -1                                   # evicted, len 50 keeps ticking
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(b, hq, d, generator=gen, device="cuda")
        copies = max(1, math.ceil(L2_ROTATE_BYTES / (2 * n_pool * ps * hkv * d)))
        pools = [(pool_codes(torch, gen, (n_pool, ps, hkv, d)),
                  pool_codes(torch, gen, (n_pool, ps, hkv, d))) for _ in range(copies)]
        kp, vp = pools[0]
        got = qpd_cuda(q, kp, vp, 3, 3, table, kv_len)
        want = ref.qpaged_decode_attn_ref(q, kp, vp, 3, 3, table, kv_len)
        # the same logical contents laid out densely, one copy per pool copy
        dense_pools = [tuple(ref.gather_pages_ref(x, table).contiguous() for x in kv)
                       for kv in pools]
        kd, vd = dense_pools[0]
        dense = qd_cuda(q, kd, vd, 3, 3, kv_len)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        derr = (got - dense).abs().max().item()
        check(err <= ATTN_ATOL, f"qpaged_decode_attn S={s} ps={ps}: max err {err} > {ATTN_ATOL}")
        check(derr <= ATTN_ATOL, f"qpaged_decode_attn S={s} ps={ps}: differs from qdecode_attn "
                                 f"on the dense layout by {derr}")
        worst = max(worst, err)
        iters = max(copies, 64)
        ms = graph_ms(torch, [lambda kv=kv: qpd_cuda(q, kv[0], kv[1], 3, 3, table, kv_len)
                              for kv in pools], iters)
        dense_ms = graph_ms(torch, [lambda kv=kv: qd_cuda(q, kv[0], kv[1], 3, 3, kv_len)
                                    for kv in dense_pools], iters)
        del dense_pools
        if len(rows) == 2 or ps != page_size:      # the page-size sweep
            swept.append(dict(s=s, ps=ps, ms=ms, dense_ms=dense_ms, err=err, ranks=ranks))
            print(f"[kernel] qpaged_decode_attn page-size sweep B={b} S={s} ps={ps} R={ranks}: "
                  f"kernel {ms * 1e3:.2f} us | qdecode_attn on the dense layout "
                  f"{dense_ms * 1e3:.2f} us | max_abs_err {err:.3e}", flush=True)
            del pools
            continue
        plain = graph_ms(torch, [lambda kv=kv: ref.qpaged_decode_attn_ref(
            q, kv[0], kv[1], 3, 3, table, kv_len) for kv in pools], iters)
        # library: gather the pages (index_select), dequantize, expand the
        # heads, and SDPA with the live-length mask
        idx = table.clamp(min=0).reshape(-1).to(torch.int64)
        mask = (torch.arange(mp * ps, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]
        qs = q[:, :, None, :]

        def lib(kv):
            kk, vv = (x.index_select(0, idx).reshape(b, mp * ps, hkv, d).to(torch.float32)
                      .mul(0.125).repeat_interleave(g, dim=2).permute(0, 2, 1, 3) for x in kv)
            return F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask)

        lib_ms = graph_ms(torch, [lambda kv=kv: lib(kv) for kv in pools], iters)
        live = sum(min(n, mp * ps) if n > 0 else ps for n in lens)
        pages = sum(-(-min(n, mp * ps) // ps) if n > 0 else 1 for n in lens)
        b_ms, b_by = bound(2 * 4 * b * hq * d + 2 * live * hkv * d + 4 * pages + 4 * b,
                           4.0 * live * hq * d)
        rows.append(dict(s=s, ps=ps, lens=lens, err=err, dense_err=derr, ms=ms, plain_ms=plain,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, dense_ms=dense_ms,
                         ranks=ranks))
        print(f"[kernel] qpaged_decode_attn B={b} Hq={hq} Hkv={hkv} D={d} S={s} ps={ps} R={ranks} "
              f"kv_len={lens} (slot 5 evicted): max_abs_err {err:.3e} (tol {ATTN_ATOL:.0e}) | "
              f"kernel {ms * 1e3:.2f} us | plain {plain * 1e3:.2f} us | index_select + sdpa "
              f"{lib_ms * 1e3:.2f} us | bound {b_ms * 1e3:.2f} us ({b_by}) | qdecode_attn on "
              f"the dense layout {dense_ms * 1e3:.2f} us, max diff {derr:.3e}", flush=True)
        del pools
    return rows, swept, worst


def check_split_instantiations(torch, ref, qpd_cuda, qr_cuda, qd_cuda, gen):
    """The other instantiations of the split kernels (``csrc/attn_split.cuh``)
    against their plain versions: D in 16, 32, 64, 128 and G in 1, 5, 16
    (the serving shape, D=64 and G=3, is held above), at a walk long enough
    for a cluster, with kv_len 0 and past the table, an evicted slot, a slot
    with a decode row and chunk rows in one tick, a token that sees no
    mapped position, and an inert token; ``qdecode_attn`` on the same
    contents laid out densely (at kv_len 0 the mean of V over the whole
    row).  Returns the worst error."""
    from repro_torch.kernels.attn_split import split_ranks

    b, hkv, ps, worst = 4, 2, 8, 0.0
    for d in (16, 32, 64, 128):
        for g in (1, 5, 16):
            s = 16 * 128
            table, n_pool, mp = paged_layout(torch, gen, b, s, ps)
            table[3] = -1
            kp, vp = (pool_codes(torch, gen, (n_pool, ps, hkv, d)) for _ in range(2))
            lens = torch.tensor([0, s - 5, mp * ps + 9, 7], dtype=torch.int32, device="cuda")
            q = torch.randn(b, g * hkv, d, generator=gen, device="cuda")
            got = qpd_cuda(q, kp, vp, 3, 3, table, lens)
            want = ref.qpaged_decode_attn_ref(q, kp, vp, 3, 3, table, lens)
            # kv_len 0 on a mapped row: the mean of V over its first page
            first = vp[table[0, 0].long()].float().mul(0.125).repeat_interleave(g, dim=1).mean(0)
            slots = [0, 1, 3, 2] + [0] * 16
            pos = [1000, s - 1, 3, -1] + list(range(1001, 1017))
            sl, po = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (slots, pos))
            qt = torch.randn(len(pos), g * hkv, d, generator=gen, device="cuda")
            kn, vn = (torch.randn(len(pos), hkv, d, generator=gen, device="cuda") for _ in range(2))
            kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            rgot = qr_cuda(qt, kn, vn, kk, vk, 3, 3, table, sl, po)
            rwant = ref.qragged_attn_ref(qt, kn, vn, kr, vr, 3, 3, table, sl, po)
            kd, vd = (ref.gather_pages_ref(x, table).contiguous() for x in (kp, vp))
            dgot = qd_cuda(q, kd, vd, 3, 3, lens)
            dwant = ref.qdecode_attn_ref(q, kd, vd, 3, 3, lens)
            torch.cuda.synchronize()
            err = max(max_err(got[1:], want[1:]), max_err(got[0], first),
                      max_err(rgot, rwant), max_err(dgot, dwant))
            label = (f"split kernels D={d} G={g} R={split_ranks(mp * ps, b, hkv, d)} / "
                     f"{split_ranks(mp * ps, len(pos), hkv, d)} / "
                     f"{split_ranks(kd.shape[1], b, hkv, d)}")
            check(err <= ATTN_ATOL, f"{label}: max err {err} > {ATTN_ATOL}")
            check(torch.equal(kk, kr) and torch.equal(vk, vr), f"{label}: pools differ")
            check(not bool(rgot[2:4].any()), f"{label}: a row that sees nothing is not 0")
            worst = max(worst, err)
    print(f"[kernel] qpaged_decode_attn, qragged_attn and qdecode_attn (dense layout) at D in "
          f"(16, 32, 64, 128) x G in (1, 5, 16), S=2048 ps=8: max_abs_err {worst:.3e} (tol "
          f"{ATTN_ATOL:.0e}), pools equal, rows that see nothing 0", flush=True)
    return worst


def check_qpaged_chunk_attn(torch, F, ref, qpc_cuda, qc_cuda, gen, page_size):
    """Kernel vs plain at Hkv=3 into one slot of a fragmented, out-of-order
    8-slot table: slot 1, whose first two pages are slot 0's (a shared
    prefix the chunk reads), or slot 3 when the chunk starts inside them.
    At D=64, G=3 (Hq=9), C=32: start 0, 96, 160 at S=192, 0, 1000 and 1984
    at S=2048, and start 176 at S=192, whose padded tail runs past the table
    (rows 192.. are dropped); C=1 and C=16 at S=2048; start passed as an
    int32 on the card; a chunk written into pool page 0 while an unmapped
    entry of the prefix reads page 0 (it must read the chunk's new codes);
    then D=16, D=128 and G=16 (Hq=48).  The pool bytes must equal the plain
    version's, hold the chunk's codes in the written rows, and hold every
    other byte unchanged.  Each case inside the table is also run through
    ``qchunk_attn`` on the slot's contents laid out densely.  R is printed
    on each row; the S=2048 serving case is also timed at R = 1, 2, 4, 8
    through the C entry."""
    from repro_torch.core import qformat
    from repro_torch.kernels import qpaged_attn as qp_mod
    from repro_torch.kernels.attn_split import chunk_ranks, chunk_tiles

    b, hkv = 8, 3
    rows, worst = [], 0.0
    # (S, start, C, D, G, variant, timed against plain and library)
    cases = [(192, 0, 32, 64, 3, None, True), (192, 96, 32, 64, 3, None, True),
             (192, 160, 32, 64, 3, None, True), (2048, 1984, 32, 64, 3, None, True),
             (192, 176, 32, 64, 3, None, True), (2048, 0, 32, 64, 3, None, False),
             (2048, 1000, 32, 64, 3, None, False), (2048, 2000, 1, 64, 3, None, False),
             (2048, 1500, 16, 64, 3, None, False), (192, 96, 32, 64, 3, "device start", False),
             (192, 96, 32, 64, 3, "page 0", False), (2048, 1000, 32, 16, 3, None, False),
             (2048, 1000, 32, 128, 3, None, False), (2048, 1000, 32, 64, 16, None, False)]
    for s, start, c, d, g, variant, timed in cases:
        hq = g * hkv
        ps = page_size
        table, n_pool, mp = paged_layout(torch, gen, b, s, ps)
        slot = 1 if start >= 2 * ps else 3
        prow = table[slot].contiguous()
        if variant == "page 0":
            # the chunk's first logical page is pool page 0 and the prefix's
            # logical page 2 is unmapped: positions 2 ps + r read page 0's row
            # r, which the chunk writes
            prow = prow.clone()
            hit = (prow == 0).nonzero()
            if len(hit):
                prow[int(hit[0, 0])] = prow[start // ps]
            prow[start // ps] = 0
            prow[2] = -1
        tiles = chunk_tiles(c, g)[0]
        ranks = chunk_ranks(mp * ps, tiles, hkv, d)
        st = torch.full((), start, dtype=torch.int32, device="cuda") \
            if variant == "device start" else start
        q = torch.randn(c, hq, d, generator=gen, device="cuda")
        kc, vc = (1.5 * torch.randn(c, hkv, d, generator=gen, device="cuda") for _ in range(2))
        kc.view(-1)[::31] = 20.0
        vc.view(-1)[::37] = -20.0
        copies = max(1, math.ceil(L2_ROTATE_BYTES / (2 * n_pool * ps * hkv * d)))
        pools = [(pool_codes(torch, gen, (n_pool, ps, hkv, d)),
                  pool_codes(torch, gen, (n_pool, ps, hkv, d))) for _ in range(copies)]
        k0, v0 = pools[0][0].clone(), pools[0][1].clone()
        kk, vk, kp, vp = k0.clone(), v0.clone(), k0.clone(), v0.clone()
        got = qpc_cuda(q, kc, vc, kk, vk, 3, 3, prow, st)
        want = ref.qpaged_chunk_attn_ref(q, kc, vc, kp, vp, 3, 3, prow, start)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        label = (f"qpaged_chunk_attn C={c} S={s} ps={ps} start={start} D={d} G={g} R={ranks}"
                 + (f" ({variant})" if variant else ""))
        check(err <= ATTN_ATOL, f"{label}: max err {err} > {ATTN_ATOL}")
        check(torch.equal(kk, kp) and torch.equal(vk, vp),
              f"{label}: pools differ from the plain version's")
        n_kept = max(0, min(c, mp * ps - start))
        pos = start + torch.arange(n_kept, device="cuda")
        flat = (prow[pos // ps].to(torch.int64) * ps + pos % ps)
        check(torch.equal(kk.view(-1, hkv, d)[flat], qformat.quantize(kc[:n_kept], 3, 8))
              and torch.equal(vk.view(-1, hkv, d)[flat], qformat.quantize(vc[:n_kept], 3, 8)),
              f"{label}: written rows are not the chunk's codes")
        keep = torch.ones(n_pool * ps, dtype=torch.bool, device="cuda")
        keep[flat] = False
        check(torch.equal(kk.view(-1, hkv, d)[keep], k0.view(-1, hkv, d)[keep])
              and torch.equal(vk.view(-1, hkv, d)[keep], v0.view(-1, hkv, d)[keep]),
              f"{label}: a pool row outside the chunk's changed")
        worst = max(worst, err)
        note = ""
        if start + c <= mp * ps:
            # the slot's contents after the write (an unmapped entry reads the
            # page-0 rows the chunk wrote), laid out densely
            kd, vd = (ref.gather_pages_ref(x, prow[None]).contiguous() for x in (kp, vp))
            dense = qc_cuda(q, kc, vc, kd, vd, 3, 3, 0, start)
            torch.cuda.synchronize()
            derr = (got - dense).abs().max().item()
            check(derr <= ATTN_ATOL, f"{label}: differs from qchunk_attn on the dense layout "
                                     f"by {derr}")
            note = f" | qchunk_attn on the dense layout: max diff {derr:.3e}"
        iters = max(copies, 64)
        ms = graph_ms(torch, [lambda kv=kv: qpc_cuda(q, kc, vc, kv[0], kv[1], 3, 3, prow, st)
                              for kv in pools], iters)
        pairs = sum(min(start + i + 1, mp * ps) for i in range(c))   # visible (row, position)
        prefix = min(start, mp * ps)
        b_ms, b_by, f32_ms = chunk_bounds(2 * prefix * hkv * d + 2 * n_kept * hkv * d
                                          + 4 * (2 * c * hq * d + 2 * c * hkv * d) + 4 * mp,
                                          pairs, hq, d)
        row = dict(c=c, s=s, ps=ps, start=start, d=d, g=g, ranks=ranks, err=err, ms=ms,
                   bound_ms=b_ms, bound_by=b_by, f32_bound_ms=f32_ms)
        timing = f"kernel {ms * 1e3:.2f} us"
        if timed:
            if start + c <= mp * ps:
                # timed over every slot's dense copy of every pool copy, as the
                # paged kernel is timed over the pool copies
                dense_caches = [tuple(ref.gather_pages_ref(x, table).contiguous() for x in kv)
                                for kv in pools]
                dense_ms = graph_ms(torch, [lambda kv=kv: qc_cuda(q, kc, vc, kv[0], kv[1], 3, 3,
                                                                  slot, start)
                                            for kv in dense_caches], max(copies, 64))
                del dense_caches
                row.update(dense_ms=dense_ms)
                note += f", {dense_ms * 1e3:.2f} us"
            # library: the chunk's quantize-and-copy into its pool rows, then
            # the slot's pages gathered (index_select), dequantized,
            # head-expanded, and SDPA with the causal offset mask
            idx = prow.clamp(min=0).to(torch.int64)
            mask = torch.arange(mp * ps, device="cuda")[None, :] <= \
                start + torch.arange(c, device="cuda")[:, None]
            qs = q.permute(1, 0, 2)[None]

            def lib(kv):
                kv[0].view(-1, hkv, d)[flat] = qformat.quantize(kc[:n_kept], 3, 8)
                kv[1].view(-1, hkv, d)[flat] = qformat.quantize(vc[:n_kept], 3, 8)
                kk_, vv_ = (x.index_select(0, idx).reshape(mp * ps, hkv, d).to(torch.float32)
                            .mul(0.125).repeat_interleave(g, dim=1).permute(1, 0, 2)[None]
                            for x in kv)
                return F.scaled_dot_product_attention(qs, kk_, vv_, attn_mask=mask)

            plain = graph_ms(torch, [lambda kv=kv: ref.qpaged_chunk_attn_ref(
                q, kc, vc, kv[0], kv[1], 3, 3, prow, start) for kv in pools[:4]], iters)
            lib_ms = graph_ms(torch, [lambda kv=kv: lib(kv) for kv in pools], iters)
            row.update(plain_ms=plain, library_ms=lib_ms)
            timing += (f" | plain {plain * 1e3:.2f} us | quantize-copy + index_select + sdpa "
                       f"{lib_ms * 1e3:.2f} us")
        rows.append(row)
        print(f"[kernel] {label} (slot {slot}, {n_kept} rows kept): max_abs_err {err:.3e} "
              f"(tol {ATTN_ATOL:.0e}), pools equal to the plain version's, written rows the "
              f"chunk's codes, other rows unchanged | {timing} | bound {b_ms * 1e3:.2f} us "
              f"({b_by}; bf16x3) / {f32_ms * 1e3:.2f} us (f32){note}", flush=True)
        if (s, start, c, d, g, variant) == (2048, 1984, 32, 64, 3, None):
            kv = pools[0]

            def raw(r, kv=kv):
                out = torch.empty_like(q)
                e = qp_mod._fns["qpaged_chunk_attn_f32_s8"](
                    q.data_ptr(), kc.data_ptr(), vc.data_ptr(), kv[0].data_ptr(),
                    kv[1].data_ptr(), None, 3, None, 3, prow.data_ptr(), None, start,
                    out.data_ptr(), c, ps, mp, hkv, g, d, 1.0 / math.sqrt(d), r,
                    torch.cuda.current_stream().cuda_stream)
                check(e == 0, f"{label}: launch at R={r} failed: CUDA error {e}")
                return out

            for r in (1, 2, 4, 8):    # every cluster size the rule may pick is right
                rerr = max_err(raw(r), want)
                check(rerr <= ATTN_ATOL, f"{label} at R={r}: max err {rerr}")
            chunk_rank_sweep(torch, label, raw, tiles, hkv, d, mp * ps, 64)
        del pools
    return rows, worst


def ragged_tick_bound(table, ps, slots, pos, hq, hkv, d):
    """(bound ms, by) of one ragged launch from this case's inputs: q, k/v
    new, out, the (T,) slot ids and positions, the table entries walked, the
    written rows, and every pool row some token sees that the tick does not
    write, each once; 4 f32 operations per (visible position, query head,
    dim)."""
    mp = len(table[0])
    t = len(pos)
    written, ends = set(), {}
    pairs = 0
    for sl, p in zip(slots, pos):
        if p < 0:
            continue
        end = min(p + 1, mp * ps)
        ends[sl] = max(ends.get(sl, 0), end)
        pairs += sum(1 for x in range(end) if table[sl][x // ps] >= 0)
        if p // ps < mp and table[sl][p // ps] >= 0:
            written.add(table[sl][p // ps] * ps + p % ps)
    seen, entries = set(), 0
    for sl, end in ends.items():
        entries += -(-end // ps)
        for x in range(end):
            page = table[sl][x // ps]
            if page >= 0:
                seen.add(page * ps + x % ps)
    nbytes = (4 * 2 * t * hq * d + 4 * 2 * t * hkv * d + 8 * t + 4 * entries
              + 2 * hkv * d * (len(written) + len(seen - written)))
    return bound(nbytes, 4.0 * pairs * hq * d)


def check_qragged_attn(torch, F, ref, kern, gen, page_size):
    """Kernel vs plain at B=8, Hq=9, Hkv=3, D=64 on the serving tick of
    ``--policy ragged`` (B=8, L=2, C=32): 8 decode rows, of which the two
    lane slots' are inert, and 2 lanes x 32 chunk rows at start 96, T = 72.
    Layouts: the dense identity layout (a (B, S, Hkv, D) slab under the
    table arange(B)[:, None]) and a fragmented, out-of-order table at page
    size 16 where slot 1 maps slot 0's first two pages (no row of the tick
    writes them), at S = 192 and 2048; page sizes 1 and 5 at S = 192.  Each
    layout also runs an edge tick (a slot with a decode row and chunk rows,
    a position past the table, -1 entries past a slot's last page, an inert
    decode row) and an all-inert tick.  Pools must equal the plain
    version's byte for byte, valid rows be within ATTN_ATOL and inert rows
    exactly 0.  Cross-checks on the same contents: a decode-only tick
    against ``qdecode_attn`` / ``qpaged_decode_attn`` and a one-lane tick
    against ``qchunk_attn`` / ``qpaged_chunk_attn``.  The serving ticks are
    timed: kernel, plain, library (quantize and ``index_put_`` the rows,
    then a per-token gather and SDPA on dequantized, head-expanded K/V with
    a per-token mask) and bound."""
    from repro_torch.core import qformat
    from repro_torch.kernels.attn_split import split_ranks

    b, hq, hkv, d, c = 8, 9, 3, 64, 32
    g = hq // hkv
    lane_slots, start = (2, 6), 96
    i32 = dict(dtype=torch.int32, device="cuda")
    rows, worst = [], 0.0

    def layout(s, ps):
        """(table, n_pool, ps, mp); ps None is the dense identity layout."""
        if ps is None:
            return torch.arange(b, **i32)[:, None].contiguous(), b, s, 1
        table, n_pool, mp = paged_layout(torch, gen, b, s, ps)
        return table, n_pool, ps, mp

    def inputs(t):
        q = torch.randn(t, hq, d, generator=gen, device="cuda")
        kn, vn = (1.5 * torch.randn(t, hkv, d, generator=gen, device="cuda") for _ in range(2))
        kn.view(-1)[::31] = 20.0
        vn.view(-1)[::37] = -20.0
        return q, kn, vn

    def run(label, table, kp, vp, q, kn, vn, slots, pos):
        """Kernel vs plain on copies of the pools; returns (err, kernel pools, out)."""
        sl, po = torch.tensor(slots, **i32), torch.tensor(pos, **i32)
        kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        got = kern.qragged(q, kn, vn, kk, vk, 3, 3, table, sl, po)
        want = ref.qragged_attn_ref(q, kn, vn, kr, vr, 3, 3, table, sl, po)
        torch.cuda.synchronize()
        valid = po >= 0
        err = (got - want)[valid].abs().max().item() if bool(valid.any()) else 0.0
        check(err <= ATTN_ATOL, f"qragged_attn {label}: max err {err} > {ATTN_ATOL}")
        check(torch.equal(kk, kr) and torch.equal(vk, vr),
              f"qragged_attn {label}: pools differ from the plain version's")
        check(not bool(got[~valid].any()), f"qragged_attn {label}: an inert row is not 0")
        return err, kk, vk, got

    decode_pos = {192: [190, 120, 150, 99, 160, 175, 130, 140],
                  2048: [2047, 40, 999, 2046, 332, 1535, 63, 1998]}
    cases = [(192, None), (192, page_size), (2048, None), (2048, page_size), (192, 1), (192, 5)]
    for s, ps_req in cases:
        table, n_pool, ps, mp = layout(s, ps_req)
        lay = "dense identity" if ps_req is None else f"ps={ps}"
        label = f"S={s} {lay}"
        slots = list(range(b)) + [lane_slots[0]] * c + [lane_slots[1]] * c
        pos = list(decode_pos[s]) + list(range(start, start + c)) * 2
        for j in lane_slots:
            pos[j] = -1
        t = len(pos)
        ranks = split_ranks(mp * ps, t, hkv, d)
        q, kn, vn = inputs(t)
        copies = max(1, math.ceil(L2_ROTATE_BYTES / (2 * n_pool * ps * hkv * d)))
        pools = [(pool_codes(torch, gen, (n_pool, ps, hkv, d)),
                  pool_codes(torch, gen, (n_pool, ps, hkv, d))) for _ in range(copies)]
        kp, vp = pools[0]
        err, _, _, _ = run(f"{label} serving tick", table, kp, vp, q, kn, vn, slots, pos)
        worst = max(worst, err)

        # edge tick: lane 0's slot also decodes (row 95, then its chunk at
        # 96..127), slot 7 writes past the table, slot 5's entries past its
        # last page are -1, slot 4's decode row is inert
        etable = table.clone()
        epos = list(pos)
        epos[lane_slots[0]], epos[7], epos[4] = start - 1, mp * ps + 5, -1
        if ps_req is not None:
            etable[5, epos[5] // ps + 1:] = -1
        eerr, _, _, _ = run(f"{label} edge tick", etable, kp, vp, q, kn, vn, slots, epos)
        _, ki, vi, out = run(f"{label} all-inert tick", table, kp, vp, q, kn, vn, slots,
                             [-1] * t)
        check(torch.equal(ki, kp) and torch.equal(vi, vp) and not bool(out.any()),
              f"qragged_attn {label}: the all-inert tick wrote or output something")
        worst = max(worst, eerr)

        # decode-only tick against the decode kernels on the written contents
        dpos = list(decode_pos[s]) + [-1] * (2 * c)
        _, kd, vd, dout = run(f"{label} decode-only tick", table, kp, vp, q, kn, vn, slots, dpos)
        lens = torch.tensor([p + 1 for p in decode_pos[s]], **i32)
        if ps_req is None:
            dec = kern.qdecode(q[:b].contiguous(), kd, vd, 3, 3, lens)
        else:
            dec = kern.qpaged_decode(q[:b].contiguous(), kd, vd, 3, 3, table, lens)
        # one-lane tick against the chunk kernels on the same contents
        lpos = [-1] * b + list(range(start, start + c)) + [-1] * c
        _, kl, vl, lout = run(f"{label} one-lane tick", table, kp, vp, q, kn, vn, slots, lpos)
        kc_, vc_ = kp.clone(), vp.clone()
        qs, ks, vs = (x[b:b + c].contiguous() for x in (q, kn, vn))
        if ps_req is None:
            chunk = kern.qchunk(qs, ks, vs, kc_, vc_, 3, 3, lane_slots[0], start)
        else:
            chunk = kern.qpaged_chunk(qs, ks, vs, kc_, vc_, 3, 3,
                                      table[lane_slots[0]].contiguous(), start)
        torch.cuda.synchronize()
        derr = (dout[:b] - dec).abs().max().item()
        cerr = (lout[b:b + c] - chunk).abs().max().item()
        which = ("qdecode_attn", "qchunk_attn") if ps_req is None \
            else ("qpaged_decode_attn", "qpaged_chunk_attn")
        check(derr <= ATTN_ATOL, f"qragged_attn {label}: decode-only tick differs from "
                                 f"{which[0]} by {derr}")
        check(cerr <= ATTN_ATOL and torch.equal(kl, kc_) and torch.equal(vl, vc_),
              f"qragged_attn {label}: one-lane tick differs from {which[1]} by {cerr} "
              f"(or in the pools)")

        # timing: the serving tick over pool copies rotated past the L2
        sl, po = torch.tensor(slots, **i32), torch.tensor(pos, **i32)
        iters = max(copies, 64)
        ms = graph_ms(torch, [lambda kv=kv: kern.qragged(q, kn, vn, kv[0], kv[1], 3, 3, table,
                                                         sl, po) for kv in pools], iters)
        # the plain and library calls hold (T, S, Hkv, D) f32 copies of every
        # token's slot (GBs at S=2048): fewer of them in one graph
        few = iters if s <= 192 else 16
        plain = graph_ms(torch, [lambda kv=kv: ref.qragged_attn_ref(
            q, kn, vn, kv[0], kv[1], 3, 3, table, sl, po) for kv in pools[:4]], few)
        # library: quantize and index_put_ the written rows, then each token's
        # slot gathered, dequantized, head-expanded, and SDPA with its mask
        tab = table.cpu().tolist()
        wrote = [(u, tab[sl_][p // ps] * ps + p % ps) for u, (sl_, p) in enumerate(zip(slots, pos))
                 if p >= 0 and p // ps < mp and tab[sl_][p // ps] >= 0]
        w_tok = torch.tensor([u for u, _ in wrote], dtype=torch.int64, device="cuda")
        w_row = torch.tensor([r for _, r in wrote], dtype=torch.int64, device="cuda")
        idx = table[sl.to(torch.int64)].clamp(min=0).to(torch.int64)       # (T, mp)
        mapped = torch.repeat_interleave(table[sl.to(torch.int64)] >= 0, ps, dim=1)
        vis = (torch.arange(mp * ps, device="cuda")[None, :] <= po[:, None]) & mapped
        vis[:, 0] |= ~vis.any(dim=1)     # inert rows attend row 0: their output is unused
        mask = vis[:, None, None, :]
        qq = q[:, :, None, :]
        kq, vq = qformat.quantize(kn[w_tok], 3, 8), qformat.quantize(vn[w_tok], 3, 8)

        def lib(kv):
            kv[0].view(-1, hkv, d)[w_row] = kq
            kv[1].view(-1, hkv, d)[w_row] = vq
            kk_, vv_ = (x[idx].reshape(t, mp * ps, hkv, d).to(torch.float32).mul(0.125)
                        .repeat_interleave(g, dim=2).permute(0, 2, 1, 3) for x in kv)
            return F.scaled_dot_product_attention(qq, kk_, vv_, attn_mask=mask)

        lib_ms = graph_ms(torch, [lambda kv=kv: lib(kv) for kv in pools[:4]], few)
        b_ms, b_by = ragged_tick_bound(tab, ps, slots, pos, hq, hkv, d)
        rows.append(dict(s=s, ps=ps, layout=lay, t=t, err=err, edge_err=eerr,
                         decode_err=derr, chunk_err=cerr, ms=ms, plain_ms=plain,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, ranks=ranks))
        print(f"[kernel] qragged_attn B={b} Hq={hq} Hkv={hkv} D={d} T={t} (8 decode rows, 2 "
              f"inert; 2 lanes x {c} at start {start}) S={s} {lay} R={ranks}: max_abs_err "
              f"{err:.3e}, edge "
              f"tick {eerr:.3e} (tol {ATTN_ATOL:.0e}), pools equal to the plain version's, "
              f"inert rows 0, all-inert tick writes nothing | vs {which[0]} {derr:.3e}, vs "
              f"{which[1]} {cerr:.3e} | kernel {ms * 1e3:.2f} us | plain {plain * 1e3:.2f} us "
              f"| index_put_ + gather + sdpa {lib_ms * 1e3:.2f} us | bound {b_ms * 1e3:.2f} us "
              f"({b_by})", flush=True)
        del pools
    return rows, worst


def integer_forward(torch, label, model, params, x, pol):
    """Calibrate ResNetv1-6's ``params`` under ``pol`` on 4 batches of 32 of
    ``x``, integerize, quantize ``x`` and run the full-integer forward over
    it through the port's entry points (``ptq.calibrate``,
    ``integerize.integerize``, ``integerize.quantize_input``,
    ``ResNetV1_6.apply``).  Held: 6 ``qconv1d`` and 1 ``qmm`` launches and no
    other kernel; finite (B, 6) logits equal to the same forward under
    ``ops.FORCE = "plain"``; argmax agreement with the EVAL fake-quant
    forward > 0.9."""
    from repro_torch.core import integerize, ptq
    from repro_torch.core.policy import QMode
    from repro_torch.kernels import ops
    from repro_torch.nn.module import Context

    t0 = time.perf_counter()
    qstate = ptq.calibrate(model.apply, params, [x[i * 32:(i + 1) * 32] for i in range(4)], pol)
    iparams = integerize.integerize(params, pol, qstate)
    xq = integerize.quantize_input(x, qstate, "resnet6/conv1/in", pol.act_bits)
    ictx = Context(policy=pol.with_mode(QMode.INTEGER), qstate=qstate)
    torch.cuda.synchronize()
    prep = time.perf_counter() - t0
    per_forward = dict(dict.fromkeys(ops.launch_counts(), 0), qconv1d=6, qmm=1)
    with torch.no_grad():
        ops.reset_launch_counts()
        out = model.apply(iparams, xq, ictx)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ops.FORCE = "plain"
        try:
            plain = model.apply(iparams, xq, ictx)
        finally:
            ops.FORCE = None
        eval_logits = model.apply(params, x, Context(policy=pol, qstate=qstate))
    check(counts == per_forward, f"{label} integer forward launch counts {counts} != "
                                 f"expected {per_forward}")
    check(tuple(out.shape) == (x.shape[0], 6) and bool(torch.isfinite(out).all()),
          f"{label} integer logits: shape {tuple(out.shape)} or not finite")
    check(torch.equal(out, plain), f"{label} integer logits differ from the plain "
                                   f"versions' at {int((out != plain).sum())} entries")
    agree = (out.argmax(-1) == eval_logits.argmax(-1)).float().mean().item()
    check(agree > 0.9, f"{label}: integer vs EVAL argmax agreement {agree:.4f} <= 0.9")
    return SimpleNamespace(qstate=qstate, iparams=iparams, xq=xq, ictx=ictx, out=out,
                           counts=counts, agree=agree, prep=prep)


def integer_end_to_end(torch, card):
    """The paper's integer engine at full width: ResNetv1-6 at filters 80 on
    UCI-HAR-shaped inputs (2947 windows of 128 x 9, the size of its test
    split, from a seeded generator; seeded random float weights), calibrated
    on 4 batches of 32, integerized int8 per-layer and int16 Q7.9, then the
    full-integer forward over all 2947 windows through the port's entry
    points (``build_resnet``, ``ptq.calibrate``, ``integerize.integerize``,
    ``integerize.quantize_input``, ``ResNetV1_6.apply``).  Held per forward:
    6 ``qconv1d`` and 1 ``qmm`` launches and no other kernel; integer logits
    equal to the same forward under ``ops.FORCE = "plain"``; argmax
    agreement with the EVAL fake-quant forward > 0.9; int8 ROM f32/int8 >
    3.5.  Then the two kernels that lie on no model path through their
    public entry points on the same data: ``ops.fake_quant_fused`` on the
    input at conv1's input exponent (equal to the EVAL forward's
    ``quantizers.fake_quant``) and ``ops.qmm_requant`` of the classifier's
    weights.  Returns the launches of these counted runs."""
    from repro_torch.configs.microai_resnet import build_resnet
    from repro_torch.core import integerize
    from repro_torch.core.policy import QMode, QuantPolicy
    from repro_torch.core.quantizers import fake_quant
    from repro_torch.kernels import ops, ref
    from repro_torch.nn.module import Context

    t0 = time.perf_counter()
    model = build_resnet("uci-har", filters=RESNET_FILTERS, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = model.init(gen)
    x = torch.randn(PATH_BATCH, 128, 9, generator=gen, device="cuda")
    zero = dict.fromkeys(ops.launch_counts(), 0)
    per_forward = dict(zero, qconv1d=6, qmm=1)
    launches = dict(zero)
    torch.cuda.synchronize()
    print(f"[int] ResNetv1-6 (UCI-HAR shape 128 x 9, 6 classes), filters {RESNET_FILTERS}, "
          f"B={PATH_BATCH}; init {time.perf_counter() - t0:.2f}s", flush=True)
    with torch.no_grad():
        float_logits = model.apply(params, x, Context())
    check(tuple(float_logits.shape) == (PATH_BATCH, 6) and bool(torch.isfinite(float_logits)
                                                               .all()), "float logits")
    rom_f32 = integerize.model_rom_bytes(params)
    policies = (("int8 per-layer", QuantPolicy(mode=QMode.EVAL, weight_bits=8, act_bits=8)),
                ("int16 Q7.9", QuantPolicy.int16_ptq()))
    site = "resnet6/conv1/in"
    for label, pol in policies:
        run = integer_forward(torch, label, model, params, x, pol)
        qstate, iparams, xq, ictx, out = run.qstate, run.iparams, run.xq, run.ictx, run.out
        for k, v in run.counts.items():
            launches[k] += v
        rom = integerize.model_rom_bytes(iparams)
        if pol.act_bits == 8:
            check(rom_f32 / rom > 3.5, f"int8 ROM {rom} B vs f32 {rom_f32} B: ratio <= 3.5")
        print(f"[int] {label}: calibrate + integerize + quantize input {run.prep:.2f}s | integer "
              f"forward launches {run.counts} == expected (6 qconv1d + 1 qmm) | integer logits "
              f"equal to plain ({PATH_BATCH} x 6) | argmax agreement with EVAL {run.agree:.4f} | "
              f"float agreement {(out.argmax(-1) == float_logits.argmax(-1)).float().mean().item():.4f}"
              f" | ROM {rom} B (f32 {rom_f32} B, {rom_f32 / rom:.2f}x) | card {card}", flush=True)

        # the kernels on no model path, through their public entry points
        n_in = qstate[site]
        ops.reset_launch_counts()
        fq = ops.fake_quant_fused(x, n_in, width=pol.act_bits)
        fc = iparams["fc"]
        h = int_codes(torch, gen, (PATH_BATCH, RESNET_FILTERS), fc["kernel"].q.dtype, lo=0)
        shift = (qstate["resnet6/add2/out"] + fc["kernel"].n - fc["n_out"]).to(torch.int32)
        rq = ops.qmm_requant(h, fc["kernel"].q, shift, width=pol.act_bits)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts == dict(zero, fake_quant=1, qmm_requant=1),
              f"{label} entry points launch counts {counts}")
        for k, v in counts.items():
            launches[k] += v
        check(torch.equal(fq, fake_quant(x, n_in, pol.act_bits)),
              f"{label}: fake_quant_fused differs from quantizers.fake_quant")
        check(torch.equal(rq, ref.qmm_requant_ref(h, fc["kernel"].q, shift, width=pol.act_bits)),
              f"{label}: qmm_requant differs from plain")
        print(f"[int] {label}: ops.fake_quant_fused on the input at n={int(n_in)} equals "
              f"quantizers.fake_quant; ops.qmm_requant of the classifier (shift {int(shift)}) "
              f"equals plain; launches {counts}", flush=True)

        # throughput and where the time goes, beside the float forward
        def forward(st, p=iparams, a=xq, c=ictx):
            model.apply(p, a, c)
            return st

        with torch.no_grad():
            for _ in range(2):
                model.apply(iparams, xq, ictx)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = 10
            for _ in range(reps):
                model.apply(iparams, xq, ictx)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps
        print(f"[int] {label} integer forward: {PATH_BATCH / wall:.1f} inferences/s, "
              f"{wall * 1e3:.2f} ms wall per forward of {PATH_BATCH}; card {card}", flush=True)
        profile_steps(torch, f"{label} integer forward (B={PATH_BATCH})", forward, None, card)
        del run, iparams, xq, out, fq, rq

    def float_forward(st):
        model.apply(params, x, Context())
        return st

    with torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(10):
            model.apply(params, x, Context())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 10
    print(f"[int] float forward: {PATH_BATCH / wall:.1f} inferences/s, {wall * 1e3:.2f} ms wall "
          f"per forward of {PATH_BATCH}; card {card}", flush=True)
    profile_steps(torch, f"float forward (B={PATH_BATCH})", float_forward, None, card)
    return launches


RESNET_FLOAT_ITERS = 400     # examples/qat_deploy_integer.py's float training: 400 at lr 0.02
RESNET_QAT_ITERS = 200       # and its int8 QAT fine-tuning: 200 at lr 0.01
LM_STEPS = 30                # smollm-135m float steps (AdamW, B=8, S=128); restart at half
LM_QAT_STEPS = 20            # smollm-135m int8 QAT steps
QAT_FLIP_SHARE = 1e-3        # the CPU tests' cap on flipped codes (tests/test_torch_train.py)


def grad_misses(torch, got, want, rtol=1e-4, atol_share=1e-6) -> int:
    """Elements of ``got`` outside rtol plus atol_share x max|want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    atol = atol_share * want.abs().max().item() if want.numel() else 0.0
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def step_vs_cpu(torch, label, loss_fn, params, args, qat):
    """One gradient of ``loss_fn(params, *args)`` on the card against the
    same on the CPU, from the same parameters and inputs: the loss at rtol
    1e-5 and every gradient leaf at rtol 1e-4 plus 1e-6 x its max |grad|.

    Under QAT a value that a sum in another order puts on the other side of
    a grid edge takes the next code, and the change spreads through every
    later layer, so the two runs are not compared code for code: the CPU
    run computes each fake-quantized tensor, counts where it differs from
    the card's (at most ``QAT_FLIP_SHARE`` of all values may) and then goes
    on with the card's values (straight-through gradient as before), so the
    loss and the gradients are held at the float tolerances above."""
    from repro_torch.core import quantizers
    from repro_torch.nn.module import tree_leaves, tree_to
    from repro_torch.train.trainer import value_and_grad

    cpu = [{k: v.to("cpu") for k, v in a.items()} if isinstance(a, dict) else a.to("cpu")
           for a in args]
    card_values, seen = [], {"calls": 0, "flips": 0, "values": 0}
    plain_fq = quantizers.fake_quant

    def on_card(x, n, width):
        y = plain_fq(x, n, width)
        card_values.append(y.detach().cpu())
        return y

    def on_cpu(x, n, width):
        own = plain_fq(x, n, width)
        card = card_values[seen["calls"]]
        seen["calls"] += 1
        check(card.shape == own.shape, f"{label}: fake-quant call {seen['calls']} shape")
        seen["flips"] += int((own != card).sum())
        seen["values"] += own.numel()
        return own + (card - own).detach()     # grid values: the difference is exact

    try:
        quantizers.fake_quant = on_card
        (l_gpu, _), g_gpu = value_and_grad(loss_fn, params, *args)
        quantizers.fake_quant = on_cpu
        (l_cpu, _), g_cpu = value_and_grad(loss_fn, tree_to(params, "cpu"), *cpu)
    finally:
        quantizers.fake_quant = plain_fq
    check(seen["calls"] == len(card_values), f"{label}: fake-quant calls differ")
    rel = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
    pairs = list(zip(tree_leaves(g_gpu), tree_leaves(g_cpu)))
    misses = sum(grad_misses(torch, a, b) for a, b in pairs)
    total = sum(b.numel() for _, b in pairs)
    print(f"[train] card vs CPU, {label}: loss {l_gpu.item():.6f} vs {l_cpu.item():.6f} (rel "
          f"{rel:.2e}); {misses} of {total} gradient elements outside rtol 1e-4 + 1e-6 max|g|"
          + (f"; fake-quantized values the CPU puts on another code: {seen['flips']} of "
             f"{seen['values']} (the CPU went on with the card's)" if qat else ""), flush=True)
    check(rel <= 1e-5, f"{label}: card loss {l_gpu.item()} vs CPU {l_cpu.item()} (rel {rel:.2e})")
    check(misses == 0, f"{label}: {misses} of {total} gradient elements differ from the CPU's")
    check(seen["flips"] <= QAT_FLIP_SHARE * max(seen["values"], 1),
          f"{label}: {seen['flips']} of {seen['values']} fake-quantized values differ")


def train_end_to_end(torch, card):
    """Training through the port's entry points, on the card:

    (a) the paper's flow on ResNetv1-6 at filters 80 on UCI-HAR-shaped
        seeded data (``bench.common.dataset``): float training
        (``train_resnet``, batch 64, the example's 400 iterations), int8 QAT
        fine-tuning from those parameters (200), calibration on 4 batches of
        32, integerization int8 per-layer and the full-integer forward over
        the test split with exactly 6 ``qconv1d`` and 1 ``qmm`` launches and
        logits equal to the plain versions'; accuracies, iterations/s and a
        profiled step of each;
    (b) smollm-135m at full width through ``launch.train.main``: AdamW, B=8,
        S=128, float (the loss must fall) and ``--qat``; a run preempted
        after its half-way checkpoint and launched again resumes at that
        step and ends with the state of the uninterrupted run; tokens/s,
        step wall time, a profiled step, syncs and peak memory;
    (c) the card's gradient held to the CPU's at smollm-135m-smoke and at
        ResNet filters 12, float and QAT.
    Training itself launches none of the port's kernels (the counts stay
    0); returns the integer evaluation's launches."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.bench import common
    from repro_torch.configs.microai_resnet import build_resnet
    from repro_torch.core.policy import QMode, QuantPolicy
    from repro_torch.data.pipeline import markov_batch_fn
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import get_config
    from repro_torch.nn.module import Context, tree_leaves
    from repro_torch.optim import adamw, sgd
    from repro_torch.train.trainer import init_train_state, make_train_step, value_and_grad

    zero = dict.fromkeys(ops.launch_counts(), 0)
    qat_pol = QuantPolicy.int8_qat()
    eval_pol = QuantPolicy(mode=QMode.EVAL, weight_bits=8, act_bits=8)

    # -- (a) float -> int8 QAT -> integer, ResNetv1-6 at filters 80 ------------
    x_tr, y_tr, x_te, y_te = common.dataset("uci-har")
    runs = {}
    ops.reset_launch_counts()
    for label, iters, kw in (("float", RESNET_FLOAT_ITERS, {}),
                             ("int8 QAT", RESNET_QAT_ITERS, dict(policy=qat_pol, lr=0.01))):
        if label != "float":
            kw["init_params"] = runs["float"][1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, params, test = common.train_resnet("uci-har", RESNET_FILTERS, iters=iters,
                                                  batch=64, device="cuda", **kw)
        torch.cuda.synchronize()
        runs[label] = (model, params, time.perf_counter() - t0, iters)
    counts = ops.launch_counts()
    check(counts == zero, f"ResNet training launched the port's kernels: {counts}")
    model, fparams = runs["float"][:2]
    qparams = runs["int8 QAT"][1]
    acc_f = common.accuracy(model, fparams, test)
    acc_q = common.accuracy(model, qparams, test, eval_pol)
    check(acc_f > 0.5, f"ResNetv1-6 float accuracy {acc_f:.4f} <= 0.5: the task was not learned")
    check(acc_q > 0.5, f"ResNetv1-6 int8 QAT accuracy {acc_q:.4f} <= 0.5")
    for label, (_, _, secs, iters) in runs.items():
        print(f"[train] ResNetv1-6 filters {RESNET_FILTERS} {label} training: {iters} iterations "
              f"of batch 64 in {secs:.2f}s, {iters / secs:.1f} iterations/s (the whole "
              f"train_resnet call); card {card}", flush=True)
    print(f"[train] ResNetv1-6 accuracy on the synthetic test split ({len(y_te)} windows): "
          f"float {acc_f:.4f}, int8 QAT under EVAL fake-quant {acc_q:.4f}", flush=True)

    x_dev = torch.from_numpy(x_te).to("cuda")
    run = integer_forward(torch, "QAT-trained int8 per-layer", model, qparams, x_dev, eval_pol)
    acc_i = (run.out.argmax(-1) == torch.from_numpy(y_te).to("cuda")).float().mean().item()
    print(f"[train] calibrate (4 x 32) -> integerize int8 per-layer -> integer forward over the "
          f"test split: launches {run.counts} == expected (6 qconv1d + 1 qmm); logits equal to "
          f"plain; integer accuracy {acc_i:.4f} (argmax agreement with EVAL {run.agree:.4f}); "
          f"card {card}", flush=True)

    xb = torch.from_numpy(x_tr[:64]).to("cuda")
    yb = torch.from_numpy(y_tr[:64]).to("cuda")
    opt = sgd(momentum=0.9, weight_decay=5e-4)
    for label, pol, p0 in (("float", QuantPolicy.float32(), fparams),
                           ("int8 QAT", qat_pol, qparams)):
        loss_fn = common.nll_loss(model, pol)

        def resnet_step(st, loss_fn=loss_fn):
            p, o = st
            (_, _), g = value_and_grad(loss_fn, p, xb, yb)
            return opt.update(g, o, p, 0.01)

        profile_steps(torch, f"ResNetv1-6 filters {RESNET_FILTERS} {label} training step "
                             f"(B=64)", resnet_step, (p0, opt.init(p0)), card, grad=True)

    # -- (b) smollm-135m at full width through launch.train.main --------------
    cfg = get_config("smollm-135m")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        args = ["--arch", "smollm-135m", "--batch", "8", "--seq", "128",
                "--steps", str(LM_STEPS), "--ckpt-every", str(LM_STEPS // 2), "--log-every", "5"]
        records = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole = launch_train.main(args + ["--ckpt-dir", str(tmp / "whole")],
                                  on_step=lambda st, m, dt: records.append((m["loss"], dt)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = [r[0] for r in records]
        check(len(losses) == LM_STEPS and all(np.isfinite(losses)), "smollm-135m float losses")
        check(np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5,
              f"smollm-135m float loss did not fall: {losses}")
        step_ms = float(np.median([r[1] for r in records[1:]])) * 1e3
        print(f"[train] smollm-135m float (AdamW, B=8, S=128) through launch.train.main: "
              f"{LM_STEPS} steps in {secs:.2f}s (init and checkpoints included); loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (first five {np.mean(losses[:5]):.4f}, last "
              f"five {np.mean(losses[-5:]):.4f}); step wall {step_ms:.2f} ms median (the metrics "
              f"read back), {8 * 128 / step_ms * 1e3:.1f} tokens/s; max memory allocated "
              f"{peak / 2 ** 30:.3f} GiB; card {card}", flush=True)

        class Preempted(Exception):
            pass

        def preempt(step, metrics, dt):
            if step == LM_STEPS // 2 - 1:
                raise Preempted

        try:
            launch_train.main(args + ["--ckpt-dir", str(tmp / "cut")], on_step=preempt)
            fail("the preempted run was not stopped")
        except Preempted:
            pass
        resumed_steps = []
        resumed = launch_train.main(args + ["--ckpt-dir", str(tmp / "cut")],
                                    on_step=lambda st, m, dt: resumed_steps.append(st))
        check(resumed_steps == list(range(LM_STEPS // 2, LM_STEPS)),
              f"the restart ran steps {resumed_steps}")
        diff = max((a.double() - b.double()).abs().max().item()
                   for a, b in zip(tree_leaves(resumed), tree_leaves(whole)))
        check(int(resumed["step"]) == LM_STEPS and diff <= 1e-6,
              f"restarted state differs from the uninterrupted run's by {diff}")
        print(f"[train] smollm-135m restart: preempted after the step-{LM_STEPS // 2} "
              f"checkpoint, launched again, resumed at step {resumed_steps[0]}, final state "
              f"(params, AdamW m/v/t, step) max |diff| vs the uninterrupted run {diff:.3g}",
              flush=True)
        del whole, resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    records = []
    torch.cuda.reset_peak_memory_stats()
    launch_train.main(["--arch", "smollm-135m", "--batch", "8", "--seq", "128", "--qat",
                       "--steps", str(LM_QAT_STEPS), "--log-every", "5"],
                      on_step=lambda st, m, dt: records.append((m["loss"], dt)))
    peak_q = torch.cuda.max_memory_allocated()
    losses = [r[0] for r in records]
    check(all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5,
          f"smollm-135m QAT loss did not fall: {losses}")
    step_ms = float(np.median([r[1] for r in records[1:]])) * 1e3
    print(f"[train] smollm-135m int8 QAT through launch.train.main --qat: loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}; step wall {step_ms:.2f} ms median, "
          f"{8 * 128 / step_ms * 1e3:.1f} tokens/s; max memory allocated "
          f"{peak_q / 2 ** 30:.3f} GiB; card {card}", flush=True)

    model = cfg.build()
    batch = markov_batch_fn(cfg.vocab, 8, 128, seed=0)(0)
    for label, pol in (("float", None), ("int8 QAT", qat_pol)):
        opt = adamw(weight_decay=0.01)
        state = init_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0),
                                 "cuda")
        step_fn = make_train_step(model, opt, 3e-3, policy=pol)
        profile_steps(torch, f"smollm-135m {label} training step (AdamW, B=8, S=128)",
                      lambda st, f=step_fn: f(st, batch)[0], state, card, steps=4, grad=True)
        del state

    # -- (c) the card's gradient against the CPU's -----------------------------
    smoke = get_config("smollm-135m-smoke").build()
    sp = smoke.init(torch.Generator(device="cuda").manual_seed(1), "cuda")
    sb = {k: torch.from_numpy(v).to("cuda")
          for k, v in markov_batch_fn(503, 4, 32, seed=3)(0).items()}
    small = build_resnet("uci-har", filters=12, device="cuda")
    rp = small.init(torch.Generator(device="cuda").manual_seed(2))
    for label, pol in (("float", QuantPolicy.float32()), ("int8 QAT", qat_pol)):
        qat = pol.mode is QMode.QAT
        step_vs_cpu(torch, f"smollm-135m-smoke {label}",
                    lambda p, b, pol=pol: smoke.loss(p, b, Context(policy=pol, train=True)),
                    sp, (sb,), qat)
        step_vs_cpu(torch, f"ResNetv1-6 filters 12 {label}", common.nll_loss(small, pol), rp,
                    (xb, yb), qat)
    return run.counts


def check_served(label, results, reqs, vocab) -> None:
    """Every request served ``ok`` with its ``max_new`` tokens, all in the vocab."""
    check(sorted(results) == sorted(r.rid for r in reqs), f"{label} lost requests")
    for req in reqs:
        r = results[req.rid]
        check(r.status == "ok" and len(r.tokens) == req.max_new
              and all(0 <= t < vocab for t in r.tokens),
              f"{label}: request {req.rid} ended {r.status} with {len(r.tokens)} tokens")


def logits_vs_plain(torch, label, engine, prompts, atol=LOGIT_ATOL) -> None:
    """A prefill's and the first decode step's logits through the kernels,
    held to the plain versions' on the same card: within ``atol``, and the
    same greedy token wherever the plain top-2 margin exceeds it."""
    from repro_torch.kernels import ops

    def first_logits():
        with torch.inference_mode():
            l0, cache = engine.prefill(prompts, engine.new_cache())
            tok = torch.argmax(l0, dim=-1, keepdim=True).to(torch.int32)
            l1, _ = engine.decode(tok, cache)
        return l0, l1

    k0, k1 = first_logits()
    ops.FORCE = "plain"
    try:
        p0, p1 = first_logits()
    finally:
        ops.FORCE = None
    for name, a, b in ((f"{label}prefill", k0, p0), (f"{label}first decode step", k1, p1)):
        check(bool(torch.isfinite(a).all()), f"{name} logits not finite")
        err = (a - b).abs().max().item()
        check(err <= atol, f"{name} logits: max err {err} > {atol}")
        top2 = torch.topk(b, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > atol
        same = torch.argmax(a, -1) == torch.argmax(b, -1)
        check(bool(same[clear].all()), f"{name}: greedy token differs on a clear margin")
        print(f"[e2e] {name} logits {tuple(a.shape)}: max_abs_err vs plain {err:.3e} "
              f"(tol {atol}); greedy tokens equal on {int(clear.sum())}/{len(clear)} "
              f"rows with a clear top-2 margin", flush=True)


def kv_code_flips(torch, label, engine, prompts) -> None:
    """One prefill through the kernels and one through the plain versions:
    the logit gap and how many int8 KV codes of the two caches differ (a
    value at a truncation edge lands on either side as the f32 sums' order
    changes)."""
    from repro_torch.kernels import ops

    def prefill():
        with torch.inference_mode():
            return engine.prefill(prompts, engine.new_cache())

    kl, kc = prefill()
    ops.FORCE = "plain"
    try:
        pl, pc = prefill()
    finally:
        ops.FORCE = None
    flips = sum(int((a["kv"][t] != b["kv"][t]).sum()) for a, b in zip(kc["body"], pc["body"])
                for t in ("k", "v"))
    total = sum(a["kv"][t].numel() for a in kc["body"] for t in ("k", "v"))
    print(f"[e2e] {label} prefill: logits max_abs_err vs plain {(kl - pl).abs().max().item():.3e} "
          f"(not held here); int8 KV codes differing from the plain versions' cache "
          f"{flips} of {total}", flush=True)


def greedy_check(torch, label, got, want, reqs, engine, vocab) -> None:
    """Tokens equal to ``want``'s; where a stream diverges, the prompt and
    ``want``'s tokens before the divergence are prefilled (plain lockstep
    path) and the top-2 margin there must be within LOGIT_ATOL."""
    import numpy as np

    by_rid = {r.rid: r for r in reqs}
    same = total = 0
    flips = []
    for rid in want:
        a, w = got[rid].tokens, want[rid].tokens
        total += len(w)
        i = next((k for k, (x, y) in enumerate(zip(a, w)) if x != y), None)
        same += len(w) if i is None else i
        if i is None:
            continue
        seq = np.concatenate([np.asarray(by_rid[rid].prompt, np.int32).reshape(-1),
                              np.asarray(w[:i], np.int32)])[None]
        with torch.inference_mode():
            logits, _ = engine.prefill(torch.from_numpy(seq).cuda(),
                                       engine.new_cache(batch=1))
        top2 = torch.topk(logits[0, :vocab], 2).values
        margin = (top2[0] - top2[1]).item()
        check(margin <= LOGIT_ATOL, f"{label}: request {rid} diverges at token {i} where "
                                    f"the top-2 margin is {margin:.3e} > {LOGIT_ATOL}")
        flips.append((rid, i, round(margin, 6)))
    print(f"[e2e] {label}: greedy tokens agree on {same}/{total} before any divergence; "
          f"divergences (rid, token, top-2 margin) {flips}", flush=True)


def paged_engine(env, pool=None):
    """The paged engine of the serving phases (page size ``CUDA_PAGE_SIZE``;
    ``pool`` pages, dense parity by default) for ``env``'s model: the
    full-depth one, or ``env.shallow``."""
    from repro_torch.serve import ServeEngine

    return ServeEngine(model=env.model, params=env.params, max_len=env.max_len,
                       batch_slots=env.slots, weight_quant=True, quantized_kv=True,
                       device="cuda", paged_kv=True, kv_pool_pages=pool)


def profile_steps(torch, label, step, state, card, steps: int = 8, grad: bool = False):
    """Where a step's time goes: the host-device synchronizations one step
    makes (``torch.cuda.set_sync_debug_mode``), wall time per step without
    the profiler, then device time per step by kernel under
    ``torch.profiler`` and the device's idle share of the unprofiled wall
    time.  ``step(state)`` returns the next state.  Serving steps run under
    ``torch.inference_mode``; a training step (``grad``) runs outside it.
    Returns the wall and device busy ms per step and the per-kernel rows, or
    None when the profiler recorded no device time."""
    import contextlib
    import warnings

    from torch.profiler import ProfilerActivity, profile

    def run(st, n=steps):
        for _ in range(n):
            st = step(st)
        return st

    with contextlib.nullcontext() if grad else torch.inference_mode():
        state = run(state)                      # warm
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state = run(state, 1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "called a synchronizing" in str(w.message)]
        print(f"[profile] {label}: {len(syncs)} host-device synchronizations in one step"
              + (f" (first: {syncs[0][:120]})" if syncs else ""), flush=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(state)
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue    # host-side ops also report their kernels' time
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / steps, e.count / steps, e.key))
    if not rows:
        print(f"[profile] {label}: {wall_ms:.2f} ms wall; device time not measured "
              "(the profiler recorded no device events)", flush=True)
        return None
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"[profile] {label}: {wall_ms:.2f} ms wall without the profiler | device busy "
          f"{busy_us / 1e3:.3f} ms in {launches:.0f} kernels | device idle "
          f"{1 - busy_us / 1e3 / wall_ms:.3f} of the wall time | host time per kernel "
          f"{wall_ms * 1e3 / launches:.1f} us | card {card}", flush=True)
    for t, n, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile]   {t:9.1f} us/step  {n:5.0f} launches/step  {key[:90]}", flush=True)
    host = sorted(((e.self_cpu_time_total / steps, e.count / steps, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU),
                  reverse=True)
    print(f"[profile] {label}: host self time by op under the profiler (top 6)", flush=True)
    for t, n, key in host[:6]:
        print(f"[profile]   host {t:9.1f} us/step  {n:5.0f} calls/step  {key[:70]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3, "rows": rows}


def end_to_end(torch, card):
    """smollm-135m at full width through the port's serving entry points."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_workload, report
    from repro_torch.models.registry import get_config
    from repro_torch.serve import ServeEngine, run_restart_batching
    from repro_torch.serve.engine import make_decode_step, make_mixed_step

    phase_t0 = time.perf_counter()
    cfg = get_config("smollm-135m")
    model = cfg.build()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    slots, plen, max_new = 8, 128, 64   # the served requests' horizons are 32 and 64
    new = 32                              # the lockstep generate horizon
    engine = ServeEngine(model=model, params=params, max_len=plen + max_new, batch_slots=slots,
                         weight_quant=True, quantized_kv=True, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (slots, plen), device="cuda", dtype=torch.int32,
                            generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    print(f"[e2e] smollm-135m: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; init + "
          f"int8 integerize {time.perf_counter() - t0:.2f}s", flush=True)
    n_layers = cfg.n_layers
    per_forward = 7 * n_layers

    # -- the main path: generate, counted ------------------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, new)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts_gen = ops.launch_counts()
    want = {"wq_matmul": per_forward * new, "qdecode_attn": n_layers * (new - 1),
            "qchunk_attn": 0, **NO_PAGED}
    check(counts_gen == want, f"generate launch counts {counts_gen} != expected {want}")
    check(tuple(out.shape) == (slots, new), f"generate output shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "generated ids outside the vocab")
    print(f"[e2e] generate: launches {counts_gen} == expected (7 x {n_layers} wq_matmul per "
          f"forward, {n_layers} qdecode_attn per decode step); first call {first_s:.2f}s",
          flush=True)

    # -- logits against the plain versions on the same card -------------------
    logits_vs_plain(torch, "", engine, prompts)
    ops.FORCE = "plain"
    try:
        plain_out = engine.generate(prompts, new)
    finally:
        ops.FORCE = None
    agree = (out == plain_out).float().mean().item()

    t0 = time.perf_counter()
    engine.generate(prompts, new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[e2e] generate {slots}x{new} tokens: steady {slots * new / dt:.1f} tok/s "
          f"({dt * 1e3 / new:.2f} ms per step, prefill included); token agreement with "
          f"the plain versions {agree:.4f}; card {card}", flush=True)

    def decode_step(st):
        cache, tok = st
        logits, cache = engine.decode(tok, cache)
        return cache, torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)

    with torch.inference_mode():
        logits, cache = engine.prefill(prompts, engine.new_cache())
    profile_steps(torch, f"decode step (B={slots})", decode_step,
                  (cache, torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)), card)

    # -- the restart-the-batch policy, counted ---------------------------------
    args = SimpleNamespace(requests=16, arrival_spacing=2, prompt_len=plen, max_new=max_new,
                           max_new_min=32, seed=0)
    reqs = build_workload(args, cfg.vocab)
    ops.reset_launch_counts()
    results, stats = run_restart_batching(engine, reqs, seed=0)
    counts_rr = ops.launch_counts()
    horizons = {r.admitted_at: r.finished_at - r.admitted_at for r in results.values()}
    steps = sum(horizons.values())
    warm = max(r.max_new for r in reqs)
    want = {"wq_matmul": per_forward * (steps + warm),
            "qdecode_attn": n_layers * (steps - len(horizons) + warm - 1), "qchunk_attn": 0,
            **NO_PAGED}
    check(counts_rr == want, f"restart launch counts {counts_rr} != expected {want}")
    check(len(results) == len(reqs), "restart lost requests")
    for r, req in ((results[q.rid], q) for q in reqs):
        check(len(r.tokens) == req.max_new and all(0 <= t < cfg.vocab for t in r.tokens),
              f"request {r.rid}: bad tokens")
    report("restart", stats)
    print(f"[e2e] restart: {len(results)} requests in {len(horizons)} batches; launches "
          f"{counts_rr} == expected; card {card}", flush=True)
    summaries = {"restart": dict(stats.summary(), **{
        f"p{q}_ttft_steps": float(np.percentile([r.admitted_at - r.arrival
                                                  for r in results.values()], q))
        for q in (50, 99)})}
    launches = {k: counts_gen[k] + counts_rr[k] for k in counts_gen}

    # -- continuous batching, one-shot and chunked admission, counted ----------
    chunk = 32
    outs = {}
    for label, kw in (("one-shot", {}), ("chunked", {"chunk_size": chunk})):
        sched = engine.scheduler(**kw)
        ops.reset_launch_counts()
        results, stats = sched.run(reqs, seed=0)
        counts = ops.launch_counts()
        ticks, chunks = stats.decode_steps, stats.prefill_chunks
        if label == "one-shot":
            # warm-up: one prefill (one prompt length) and one decode step
            want = {"wq_matmul": per_forward * (ticks + len(reqs) + 2),
                    "qdecode_attn": n_layers * (ticks + 1), "qchunk_attn": 0, **NO_PAGED}
        else:
            # warm-up: one mixed step (decode half + chunk half) and one decode step
            check(chunks == len(reqs) * -(-plen // chunk), f"chunked: {chunks} chunks")
            want = {"wq_matmul": per_forward * (ticks + chunks + 3),
                    "qdecode_attn": n_layers * (ticks + 2),
                    "qchunk_attn": n_layers * (chunks + 1), **NO_PAGED}
        check(counts == want, f"{label} launch counts {counts} != expected {want}")
        check_served(label, results, reqs, cfg.vocab)
        report(label, stats)
        print(f"[e2e] {label}: {len(results)} requests ok, {ticks} ticks, {chunks} chunks; "
              f"launches {counts} == expected; card {card}", flush=True)
        outs[label] = results
        summaries[label] = stats.summary()
        launches = {k: launches.get(k, 0) + counts[k] for k in counts}
    ops.FORCE = "plain"
    try:
        plain_res, _ = engine.scheduler(chunk_size=chunk).run(reqs, seed=0, warmup=False)
    finally:
        ops.FORCE = None

    def agreement(a, b):
        pairs = [(x, y) for rid in a for x, y in zip(a[rid].tokens, b[rid].tokens)]
        return sum(x == y for x, y in pairs) / len(pairs)

    print(f"[e2e] chunked tokens: agreement with the plain versions' chunked run "
          f"{agreement(outs['chunked'], plain_res):.4f}, with the one-shot run "
          f"{agreement(outs['chunked'], outs['one-shot']):.4f}", flush=True)
    for label in ("one-shot", "chunked", "restart"):
        m = summaries[label]
        print(f"[e2e] {label}: steady {m['steady_tok_s']:.1f} tok/s | occupancy "
              f"{m['occupancy']:.3f} | latency p50/p99 {m['p50_latency_steps']:.0f}/"
              f"{m['p99_latency_steps']:.0f} steps | ttft p50/p99 "
              f"{m['p50_ttft_steps']:.0f}/{m['p99_ttft_steps']:.0f} steps | "
              f"admission stalls {m['admission_stalls']} | stalled chunks "
              f"{m['stalled_chunks']} | card {card}", flush=True)

    # -- one mixed step's logits against the plain versions ---------------------
    from repro_torch.nn.attention import KVChunk
    from repro_torch.nn.module import Context

    def mixed_logits(cache, tok, ctok):
        with torch.inference_mode():
            ld, cache = engine.model.apply(engine.params, tok, Context(), cache=cache,
                                           decode=True)
            lc, cache = engine.model.apply(engine.params, ctok, Context(), cache=cache,
                                           decode=True, chunk=KVChunk(3, 96, chunk),
                                           logit_pos=chunk - 1)
        return ld[:, -1], lc[:, 0]

    g2 = torch.Generator(device="cuda").manual_seed(2)
    cache = engine.new_cache(per_slot=True)
    with torch.inference_mode():
        for j in range(slots):                  # 96-token prefixes, chunk by chunk
            toks = torch.randint(0, cfg.vocab, (1, 96), generator=g2, device="cuda",
                                 dtype=torch.int32)
            for c0 in range(0, 96, chunk):
                _, cache = engine.model.apply(engine.params, toks[:, c0:c0 + chunk], Context(),
                                              cache=cache, decode=True,
                                              chunk=KVChunk(j, c0, chunk), logit_pos=chunk - 1)
    tok = torch.randint(0, cfg.vocab, (slots, 1), generator=g2, device="cuda", dtype=torch.int32)
    ctok = torch.randint(0, cfg.vocab, (1, chunk), generator=g2, device="cuda", dtype=torch.int32)

    def copy(c):
        return {"body": [{"kv": dict(n["kv"], k=n["kv"]["k"].clone(), v=n["kv"]["v"].clone(),
                                     len=n["kv"]["len"].clone())} for n in c["body"]]}

    base = copy(cache)
    kd, kc_ = mixed_logits(copy(base), tok, ctok)
    ops.FORCE = "plain"
    try:
        pd, pc = mixed_logits(copy(base), tok, ctok)
    finally:
        ops.FORCE = None
    for name, a, b in (("mixed step, decode half", kd, pd), ("mixed step, chunk half", kc_, pc)):
        check(bool(torch.isfinite(a).all()), f"{name} logits not finite")
        err = (a - b).abs().max().item()
        check(err <= LOGIT_ATOL, f"{name} logits: max err {err} > {LOGIT_ATOL}")
        print(f"[e2e] {name} logits {tuple(a.shape)}: max_abs_err vs plain {err:.3e} "
              f"(tol {LOGIT_ATOL})", flush=True)

    decode = make_decode_step(engine.model)

    def decode_tick(st):
        cache, tok = st
        nxt, cache = decode(engine.params, tok, cache, None)
        return cache, nxt

    profile_steps(torch, f"per-slot decode tick (B={slots})", decode_tick, (copy(base), tok),
                  card)
    mixed = make_mixed_step(engine.model)

    def mixed_tick(st):
        cache, tok = st
        nxt, _, cache = mixed(engine.params, tok, cache, None, ctok, 3, 96, chunk)
        return cache, nxt

    profile_steps(torch, f"mixed tick (B={slots}, C={chunk}, start 96)", mixed_tick,
                  (copy(base), tok), card)
    env = SimpleNamespace(model=model, params=params, cfg=cfg, reqs=reqs, dense=outs["chunked"],
                          slots=slots, max_len=plen + max_new, chunk=chunk, n_layers=n_layers,
                          agreement=agreement, engine=engine, prompts=prompts, new=new)
    # the oversubscribed runs repeat the paged path under pressure: at full
    # width but SHALLOW_LAYERS deep (their schedules do not depend on depth)
    shallow = dataclasses.replace(cfg, n_layers=SHALLOW_LAYERS).build()
    env.shallow = SimpleNamespace(
        model=shallow, params=shallow.init(torch.Generator(device="cuda").manual_seed(10),
                                           "cuda"),
        max_len=env.max_len, slots=slots, n_layers=SHALLOW_LAYERS)
    env.shallow.engine = ServeEngine(model=shallow, params=env.shallow.params,
                                     max_len=env.max_len, batch_slots=slots, weight_quant=True,
                                     quantized_kv=True, device="cuda")
    check_grants("the dense serving phase", ran=("wq_matmul",))
    print(f"[time] dense serving phase {time.perf_counter() - phase_t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    paged_launches, env.chunked, env.shared_reqs = paged_end_to_end(torch, card, env)
    env.chunked["dense"] = outs["chunked"]
    check_grants("the paged phase", ran=("wq_matmul",))
    print(f"[time] paged phase {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    ragged_launches = ragged_end_to_end(torch, card, env)
    check_grants("the ragged phase", ran=("wq_matmul",))
    print(f"[time] ragged phase {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    subint8_launches = subint8_end_to_end(torch, card, env)
    check_grants("the sub-int8 phase", ran=("wq_matmul", "wq4_matmul"))
    print(f"[time] sub-int8 phase {time.perf_counter() - t0:.1f}s", flush=True)
    return {k: sum(part.get(k, 0) for part in (launches, paged_launches, ragged_launches,
                                               subint8_launches))
            for k in subint8_launches}


def paged_end_to_end(torch, card, env):
    """``--paged``: the chunked policy over a page pool at full width, with
    prefix sharing and with oversubscription under both preemption
    policies, each run's launch counts checked; a paged mixed step's logits
    against the plain versions; a paged decode tick and mixed tick
    profiled.  Returns the launches, each run's results by name (the ragged
    phase's yardstick) and the shared-prefix requests."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.nn.module import Context
    from repro_torch.serve import Request
    from repro_torch.serve.engine import make_decode_step, make_mixed_step

    slots, chunk, n_layers, cfg = env.slots, env.chunk, env.n_layers, env.cfg
    per_forward = 7 * n_layers

    def counted_run(label, engine, reqs, layers=n_layers, **kw):
        """One scheduler run from zeroed counts; the counts must be the
        chunked path's with the paged kernels in place of the dense ones
        (warm-up: one mixed step and one decode step), for a model
        ``layers`` deep."""
        ops.reset_launch_counts()
        results, stats = engine.scheduler(chunk_size=chunk, **kw).run(reqs, seed=0)
        counts = ops.launch_counts()
        ticks, chunks = stats.decode_steps, stats.prefill_chunks
        want = {"wq_matmul": 7 * layers * (ticks + chunks + 3), "qdecode_attn": 0,
                "qchunk_attn": 0, "qpaged_decode_attn": layers * (ticks + 2),
                "qpaged_chunk_attn": layers * (chunks + 1), "qragged_attn": 0,
                "wq4_matmul": 0, **NO_INT}
        check(counts == want, f"{label} launch counts {counts} != expected {want}")
        check_served(label, results, reqs, cfg.vocab)
        report(label, stats)
        print(f"[e2e] {label}: {len(results)} requests ok, {ticks} ticks, {chunks} chunks; "
              f"launches {counts} == expected; card {card}", flush=True)
        return results, stats, counts

    paged = paged_engine(env)
    ps, parity = paged.page_size, paged.kv_num_pages
    print(f"[e2e] paged KV: page size {ps} (the engine's CUDA default), table "
          f"{paged.kv_max_pages} pages per slot, pool {parity} pages (dense parity)",
          flush=True)
    launches = {}
    summaries = {}
    results = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # -- the main path: paged chunked serving of the 16 requests -----------------
    res, stats, counts = counted_run("paged", paged, env.reqs)
    results["paged"] = res
    add(counts)
    summaries["paged"] = stats.summary()
    print(f"[e2e] paged tokens: agreement with the dense chunked run "
          f"{env.agreement(res, env.dense):.4f}", flush=True)

    # -- prefix sharing: 8 prompts with one 96-token opening ----------------------
    g = np.random.default_rng(3)
    opening = g.integers(0, cfg.vocab, size=96).astype(np.int32)
    shared_reqs = [Request(rid=i, prompt=np.concatenate(
        [opening, g.integers(0, cfg.vocab, size=32).astype(np.int32)]), max_new=16,
        arrival=2 * i) for i in range(8)]
    results["shared"], stats, counts = counted_run("paged, shared prefix", paged, shared_reqs)
    add(counts)
    check(stats.shared_pages_mapped > 0, "prefix sharing mapped no shared page")
    summaries["shared"] = stats.summary()

    # -- oversubscription: half the pool, both preemption policies, 8 requests,
    #    on the shallow model -------------------------------------------------------
    half = paged_engine(env.shallow, parity // 2)
    for policy in ("recompute", "swap"):
        label = (f"paged, oversubscribed ({parity // 2} pages, {env.shallow.n_layers} layers), "
                 f"{policy}")
        got, stats, counts = counted_run(label, half, env.reqs[:8], env.shallow.n_layers,
                                         oversubscribe=True, preempt_policy=policy)
        add(counts)
        check(stats.grown_pages > 0 and stats.preemptions > 0,
              f"{label}: grown {stats.grown_pages}, preemptions {stats.preemptions}")
        summaries[policy] = stats.summary()
        results[policy] = got
    print(f"[e2e] paged, oversubscribed: swap's greedy tokens agree with recompute's on "
          f"{env.agreement(results['swap'], results['recompute']):.4f}", flush=True)
    del half
    for label, m in summaries.items():
        print(f"[e2e] paged {label}: steady {m['steady_tok_s']:.1f} tok/s | latency p50/p99 "
              f"{m['p50_latency_steps']:.0f}/{m['p99_latency_steps']:.0f} ticks | ttft "
              f"p50/p99 {m['p50_ttft_steps']:.0f}/{m['p99_ttft_steps']:.0f} ticks | pages peak "
              f"{m['peak_pages_in_use']}, stalls {m['page_stalls']}, fill "
              f"{m['page_occupancy']:.3f} | shared {m['shared_pages_mapped']} | grown "
              f"{m['grown_pages']}, preempted {m['preemptions']}, resumed {m['resumes']}, "
              f"swapped {m['swapped_pages']} pages ({m['swap_peak_bytes']} B peak) | card "
              f"{card}", flush=True)

    # -- a paged mixed step's logits against the plain versions -------------------
    from repro_torch.nn.attention import KVChunk
    from repro_torch.serve.slot_state import set_cache_page_row

    g2 = torch.Generator(device="cuda").manual_seed(4)
    cache = paged.new_cache(per_slot=True)
    perm = torch.randperm(parity, generator=g2, device="cuda").reshape(slots, -1).cpu().numpy()
    with torch.inference_mode():
        for j in range(slots):                 # fragmented rows, 96-token prefixes
            cache = set_cache_page_row(cache, j, perm[j])
            toks = torch.randint(0, cfg.vocab, (1, 96), generator=g2, device="cuda",
                                 dtype=torch.int32)
            for c0 in range(0, 96, chunk):
                _, cache = env.model.apply(paged.params, toks[:, c0:c0 + chunk], Context(),
                                           cache=cache, decode=True,
                                           chunk=KVChunk(j, c0, chunk), logit_pos=chunk - 1)
    tok = torch.randint(0, cfg.vocab, (slots, 1), generator=g2, device="cuda", dtype=torch.int32)
    ctok = torch.randint(0, cfg.vocab, (1, chunk), generator=g2, device="cuda",
                         dtype=torch.int32)

    def copy(c):
        """A paged cache with the same contents (the pools keep their spare row)."""
        new = paged.new_cache(per_slot=True)
        for dst, src in zip(new["body"], c["body"]):
            for name in ("k", "v", "page_table", "len"):
                dst["kv"][name].copy_(src["kv"][name])
        return new

    def mixed_logits(c):
        with torch.inference_mode():
            ld, c = env.model.apply(paged.params, tok, Context(), cache=c, decode=True)
            lc, c = env.model.apply(paged.params, ctok, Context(), cache=c, decode=True,
                                    chunk=KVChunk(3, 96, chunk), logit_pos=chunk - 1)
        return ld[:, -1], lc[:, 0]

    kd, kc = mixed_logits(copy(cache))
    ops.FORCE = "plain"
    try:
        pd, pc = mixed_logits(copy(cache))
    finally:
        ops.FORCE = None
    for name, a, b in (("paged mixed step, decode half", kd, pd),
                       ("paged mixed step, chunk half", kc, pc)):
        check(bool(torch.isfinite(a).all()), f"{name} logits not finite")
        err = (a - b).abs().max().item()
        check(err <= LOGIT_ATOL, f"{name} logits: max err {err} > {LOGIT_ATOL}")
        print(f"[e2e] {name} logits {tuple(a.shape)}: max_abs_err vs plain {err:.3e} "
              f"(tol {LOGIT_ATOL})", flush=True)

    decode = make_decode_step(env.model)
    mixed = make_mixed_step(env.model)

    def decode_tick(st):
        c, t = st
        nxt, c = decode(paged.params, t, c, None)
        return c, nxt

    def mixed_tick(st):
        c, t = st
        nxt, _, c = mixed(paged.params, t, c, None, ctok, 3, 96, chunk)
        return c, nxt

    profile_steps(torch, f"paged decode tick (B={slots}, ps={ps})", decode_tick,
                  (copy(cache), tok), card)
    profile_steps(torch, f"paged mixed tick (B={slots}, C={chunk}, start 96, ps={ps})",
                  mixed_tick, (copy(cache), tok), card)
    return launches, results, shared_reqs


def ragged_end_to_end(torch, card, env):
    """``--policy ragged``: one ragged forward per tick (B=8, 2 lanes of C=32,
    T = 72) at full width on the dense cache and the paged pool, with prefix
    sharing, at half the pool under recompute and swap, and on the burst of
    ``benchmarks/serve_bench.py::bench_burst`` (16 x 192 tokens at tick 0,
    16 slots, 4 lanes, budget 160, page 16) beside the single-lane paged
    mixed step.  Every run's launch counts are exact, every request ``ok``,
    and its greedy tokens are those of the chunked run of the same workload
    wherever the top-2 margin exceeds LOGIT_ATOL.  A ragged tick's logits
    are held to the plain versions, and a dense and a paged ragged tick are
    profiled."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.nn.attention import KVChunk, RaggedBatch
    from repro_torch.nn.module import Context
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.lanes import RaggedTick

    slots, chunk, n_layers, cfg = env.slots, env.chunk, env.n_layers, env.cfg
    per_forward = 7 * n_layers
    lanes = 2
    others = {"qdecode_attn": 0, "qchunk_attn": 0, "qpaged_decode_attn": 0,
              "qpaged_chunk_attn": 0, "wq4_matmul": 0, **NO_INT}
    launches, summaries = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def counted_run(label, engine, reqs, n_lanes=lanes, time_ticks=False, layers=n_layers,
                    **kw):
        """One ragged run from zeroed counts: every tick, the warm-up's
        included, is one forward of 7 x ``layers`` wq_matmul and ``layers``
        qragged_attn.  ``time_ticks`` (the burst) syncs every tick for
        wall-clock TTFT; the other runs do not, as the chunked runs they are
        compared with."""
        ops.reset_launch_counts()
        results, stats = engine.scheduler(chunk_size=chunk, ragged=True, prefill_lanes=n_lanes,
                                          **kw).run(reqs, seed=0, time_ticks=time_ticks)
        counts = ops.launch_counts()
        ticks = stats.decode_steps
        want = {"wq_matmul": 7 * layers * (ticks + 1), "qragged_attn": layers * (ticks + 1),
                **others}
        check(counts == want, f"{label} launch counts {counts} != expected {want}")
        check_served(label, results, reqs, cfg.vocab)
        report(label, stats)
        print(f"[e2e] {label}: {len(results)} requests ok, {ticks} ticks, "
              f"{stats.prefill_chunks} chunks; launches {counts} == expected; card {card}",
              flush=True)
        add(counts)
        summaries[label] = stats.summary()
        return results, stats

    dense, paged = env.engine, paged_engine(env)
    parity = paged.kv_num_pages
    # -- the main path: ragged serving of the 16 requests, dense and paged -------
    res, _ = counted_run("ragged", dense, env.reqs)
    greedy_check(torch, "ragged", res, env.chunked["dense"], env.reqs, dense, cfg.vocab)
    res, _ = counted_run("ragged, paged", paged, env.reqs)
    greedy_check(torch, "ragged, paged", res, env.chunked["paged"], env.reqs, dense, cfg.vocab)
    res, stats = counted_run("ragged, paged, shared prefix", paged, env.shared_reqs)
    check(stats.shared_pages_mapped > 0, "ragged prefix sharing mapped no shared page")
    greedy_check(torch, "ragged, paged, shared prefix", res, env.chunked["shared"],
                 env.shared_reqs, dense, cfg.vocab)
    half = paged_engine(env.shallow, parity // 2)
    for policy in ("recompute", "swap"):
        label = (f"ragged, paged, oversubscribed ({parity // 2} pages, {env.shallow.n_layers} "
                 f"layers), {policy}")
        res, stats = counted_run(label, half, env.reqs[:8], layers=env.shallow.n_layers,
                                 oversubscribe=True, preempt_policy=policy)
        check(stats.grown_pages > 0 and stats.preemptions > 0,
              f"{label}: grown {stats.grown_pages}, preemptions {stats.preemptions}")
        greedy_check(torch, label, res, env.chunked[policy], env.reqs[:8], env.shallow.engine,
                     cfg.vocab)
    del half

    # -- the burst: bench_burst's full setting, ragged and paged mixed -----------
    wl = dict(n_requests=16, plen=192, max_new=16, slots=16, chunk=32, lanes=4, budget=160,
              page=16)
    rng = np.random.default_rng(0)
    burst_reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=wl["plen"],
                                                     dtype=np.int32),
                          max_new=wl["max_new"], arrival=0) for i in range(wl["n_requests"])]
    burst = ServeEngine(model=env.model, params=env.params, max_len=wl["plen"] + wl["max_new"],
                        batch_slots=wl["slots"], weight_quant=True, quantized_kv=True,
                        device="cuda", paged_kv=True, page_size=wl["page"])
    ops.reset_launch_counts()
    m_res, m_st = burst.scheduler(chunk_size=wl["chunk"], token_budget=wl["budget"]).run(
        burst_reqs, seed=0, time_ticks=True)
    counts = ops.launch_counts()
    ticks, chunks = m_st.decode_steps, m_st.prefill_chunks
    want = {"wq_matmul": per_forward * (ticks + chunks + 3), "qdecode_attn": 0,
            "qchunk_attn": 0, "qpaged_decode_attn": n_layers * (ticks + 2),
            "qpaged_chunk_attn": n_layers * (chunks + 1), "qragged_attn": 0,
            "wq4_matmul": 0, **NO_INT}
    check(counts == want, f"burst, paged mixed launch counts {counts} != expected {want}")
    check_served("burst, paged mixed", m_res, burst_reqs, cfg.vocab)
    report("burst, paged mixed", m_st)
    add(counts)
    summaries["burst, paged mixed"] = m_st.summary()
    r_res, r_st = counted_run(f"burst, ragged ({wl['lanes']} lanes, budget {wl['budget']})",
                              burst, burst_reqs, n_lanes=wl["lanes"], time_ticks=True,
                              token_budget=wl["budget"])
    greedy_check(torch, "burst, ragged", r_res, m_res, burst_reqs, burst, cfg.vocab)
    msum, rsum = m_st.summary(), r_st.summary()
    print(f"[e2e] burst (16 x 192 tokens at tick 0, 16 slots, chunk 32, budget 160, page 16): "
          f"TTFT p50/p99 paged mixed {msum['p50_ttft_steps']:.0f}/{msum['p99_ttft_steps']:.0f} "
          f"ticks, {msum['p50_ttft_ms']:.1f}/{msum['p99_ttft_ms']:.1f} ms -> ragged "
          f"{rsum['p50_ttft_steps']:.0f}/{rsum['p99_ttft_steps']:.0f} ticks, "
          f"{rsum['p50_ttft_ms']:.1f}/{rsum['p99_ttft_ms']:.1f} ms | ticks {m_st.decode_steps} "
          f"-> {r_st.decode_steps} | steady {m_st.steady_tok_s:.1f} -> {r_st.steady_tok_s:.1f} "
          f"tok/s | card {card}", flush=True)
    del burst
    for label, m in summaries.items():
        timed = (f", {m['p50_latency_ms']:.1f}/{m['p99_latency_ms']:.1f} ms",
                 f", {m['p50_ttft_ms']:.1f}/{m['p99_ttft_ms']:.1f} ms") \
            if m["p99_ttft_ms"] > 0 else ("", "")
        print(f"[e2e] {label}: steady {m['steady_tok_s']:.1f} tok/s | latency p50/p99 "
              f"{m['p50_latency_steps']:.0f}/{m['p99_latency_steps']:.0f} ticks{timed[0]} | "
              f"ttft p50/p99 {m['p50_ttft_steps']:.0f}/{m['p99_ttft_steps']:.0f} "
              f"ticks{timed[1]} | chunks {m['prefill_chunks']} "
              f"(stalled {m['stalled_chunks']}) | pages peak {m['peak_pages_in_use']}, stalls "
              f"{m['page_stalls']} | shared {m['shared_pages_mapped']} | grown "
              f"{m['grown_pages']}, preempted {m['preemptions']}, resumed {m['resumes']}, "
              f"swapped {m['swapped_pages']} | card {card}", flush=True)

    # -- one ragged tick's logits against the plain versions, dense and paged ----
    g2 = torch.Generator(device="cuda").manual_seed(5)
    lane_slots, start = (2, 6), 96
    live = [j for j in range(slots) if j not in lane_slots]
    meta = RaggedTick(
        sids=np.asarray(list(range(slots)) + [lane_slots[0]] * chunk + [lane_slots[1]] * chunk,
                        np.int32),
        poss=np.asarray([start if j in live else -1 for j in range(slots)]
                        + list(range(start, start + chunk)) * 2, np.int32),
        ctok=torch.randint(0, cfg.vocab, (lanes, chunk), generator=g2, device="cuda",
                           dtype=torch.int32).cpu().numpy(),
        lrows=np.asarray(list(range(slots)) + [slots + chunk - 1, slots + 2 * chunk - 1],
                         np.int32), ran=[], stalled=0)
    tok = torch.randint(0, cfg.vocab, (slots, 1), generator=g2, device="cuda", dtype=torch.int32)

    def prefixed(engine):
        """A per-slot cache whose 8 slots hold 96-token prefixes (chunked
        prefill), on fragmented pages when paged."""
        cache = engine.new_cache(per_slot=True)
        if engine.paged_kv:
            from repro_torch.serve.slot_state import set_cache_page_row

            perm = torch.randperm(engine.kv_num_pages, generator=g2, device="cuda")
            perm = perm.reshape(slots, -1).cpu().numpy()
            for j in range(slots):
                cache = set_cache_page_row(cache, j, perm[j])
        with torch.inference_mode():
            for j in range(slots):
                toks = torch.randint(0, cfg.vocab, (1, start), generator=g2, device="cuda",
                                     dtype=torch.int32)
                for c0 in range(0, start, chunk):
                    _, cache = env.model.apply(engine.params, toks[:, c0:c0 + chunk], Context(),
                                               cache=cache, decode=True,
                                               chunk=KVChunk(j, c0, chunk), logit_pos=chunk - 1)
        return cache

    def clone(engine, c):
        new = engine.new_cache(per_slot=True)
        for dst, src in zip(new["body"], c["body"]):
            for name in [n for n in ("k", "v", "page_table", "len") if n in src["kv"]]:
                dst["kv"][name].copy_(src["kv"][name])
        return new

    def tick_logits(engine, c):
        dev = {k: torch.from_numpy(getattr(meta, k)).cuda() for k in ("sids", "poss", "ctok",
                                                                        "lrows")}
        flat = torch.cat([tok[:, 0], dev["ctok"].reshape(-1)])[None]
        with torch.inference_mode():
            logits, _ = env.model.apply(engine.params, flat, Context(), cache=c, decode=True,
                                        ragged=RaggedBatch(dev["sids"], dev["poss"]),
                                        logit_rows=dev["lrows"])
        return logits[0]

    active = torch.tensor([j in live for j in range(slots)], device="cuda")
    for name, engine in (("dense", dense), ("paged", paged)):
        cache = prefixed(engine)
        k_l = tick_logits(engine, clone(engine, cache))
        ops.FORCE = "plain"
        try:
            p_l = tick_logits(engine, clone(engine, cache))
        finally:
            ops.FORCE = None
        check(bool(torch.isfinite(k_l).all()), f"{name} ragged tick logits not finite")
        err = (k_l - p_l).abs().max().item()
        check(err <= LOGIT_ATOL, f"{name} ragged tick logits: max err {err} > {LOGIT_ATOL}")
        top2 = torch.topk(p_l[:, :cfg.vocab], 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LOGIT_ATOL
        same = torch.argmax(k_l, -1) == torch.argmax(p_l, -1)
        check(bool(same[clear].all()), f"{name} ragged tick: greedy token differs on a clear "
                                       f"margin")
        print(f"[e2e] {name} ragged tick logits {tuple(k_l.shape)} (6 decode rows at 96, 2 lanes "
              f"x {chunk} at 96): max_abs_err vs plain {err:.3e} (tol {LOGIT_ATOL}); greedy "
              f"tokens equal on {int(clear.sum())}/{len(clear)} rows with a clear top-2 margin",
              flush=True)
        sched = engine.scheduler(chunk_size=chunk, ragged=True, prefill_lanes=lanes)

        def ragged_tick(st, sched=sched):
            c, t = st
            nxt, _, c = sched._masked_ragged(t, c, None, active, meta)
            return c, nxt

        prof = profile_steps(torch, f"{name} ragged tick (B={slots}, L={lanes}, C={chunk}, "
                                    f"start 96, T={slots + lanes * chunk})", ragged_tick,
                             (clone(engine, cache), tok), card)
        if prof is not None:
            wq = [(t, n) for t, n, key in prof["rows"] if "wq_matmul" in key]
            print(f"[profile] {name} ragged tick: wq_matmul at M=T={slots + lanes * chunk} "
                  f"{sum(t for t, _ in wq):.1f} us/tick of device time in "
                  f"{sum(n for _, n in wq):.0f} launches ({sum(t for t, _ in wq) / 1e3 / prof['busy_ms']:.3f} "
                  f"of the device busy time)", flush=True)
    return launches


def subint8_end_to_end(torch, card, env):
    """``--wq int4-block`` (block 32) at full width: ``generate``, the chunked
    ``Scheduler`` on the 16 requests, the paged engine and the ragged tick,
    each with exact launch counts (7 x 30 ``wq4_matmul`` per forward, no
    ``wq_matmul``); prefill and decode logits and the generated tokens held
    to the plain versions; the paged and ragged tokens held to the chunked
    run; one per-channel ``int4`` and one ``int2-block`` generate (int2
    weights take the plain unpack-and-matmul, as the reference routes them:
    no kernel); an int4 decode step profiled; the int8 KV codes that flip
    between the kernels' and the plain versions' prefills; int8 and
    int4-block ragged runs in turns and a forward at M = 72 of each
    profiled; and
    ``benchmarks/serve_bench.py::bench_weight_formats`` at its full setting
    (fp32 / int8 / int4-block) on the ``SHALLOW_LAYERS``-deep model, with
    the reference's rule that int4 kernel bytes are at most half of
    int8's."""
    from types import SimpleNamespace as NS

    from repro_torch.bench.serve_bench import bench_weight_formats
    from repro_torch.core.qformat import PackedQTensor
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.nn.module import tree_leaves
    from repro_torch.serve import ServeEngine

    slots, chunk, n_layers, cfg, new = env.slots, env.chunk, env.n_layers, env.cfg, env.new
    per_forward = 7 * n_layers
    zero = dict.fromkeys(ops.launch_counts(), 0)
    launches, summaries = dict(zero), {}

    def engine(fmt, quantized_kv=True, **kw):
        eng = ServeEngine(model=env.model, params=env.params, max_len=env.max_len,
                          batch_slots=slots, weight_quant=fmt, quantized_kv=quantized_kv,
                          device="cuda", **kw)
        packed = [leaf for leaf in tree_leaves(eng.params) if isinstance(leaf, PackedQTensor)]
        width, block = {"int4-block": (4, 32), "int4": (4, None), "int2-block": (2, 32)}[fmt]
        check(len(packed) == 7 and all((p.width, p.block_size) == (width, block)
                                       for p in packed),
              f"{fmt}: the engine's GEMM kernels are not packed int{width}")
        return eng

    def counted(label, want, fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = dict(zero, **want)
        check(counts == want, f"{label} launch counts {counts} != expected {want}")
        for k, v in counts.items():
            launches[k] += v
        return out

    def generated(label, eng, kernel_launches, float_kv=None):
        """A counted generate, its logits and tokens held to the plain
        versions'; with ``float_kv`` (the same weights over a float KV
        cache) the logits are held there instead, at FLOAT_KV_LOGIT_ATOL,
        and the tokens are not compared."""
        t0 = time.perf_counter()
        out = counted(f"{label} generate", {"qdecode_attn": n_layers * (new - 1),
                                            "wq4_matmul": kernel_launches * new},
                      lambda: eng.generate(env.prompts, new))
        dt = time.perf_counter() - t0
        check(tuple(out.shape) == (slots, new), f"{label} generate shape {tuple(out.shape)}")
        print(f"[e2e] {label} generate {slots}x{new}: {kernel_launches} wq4_matmul per "
              f"forward, 0 wq_matmul (counts exact); first call {dt:.2f}s; card {card}",
              flush=True)
        if float_kv is not None:
            kv_code_flips(torch, label, eng, env.prompts)
            logits_vs_plain(torch, f"{label}, float KV cache, ", float_kv, env.prompts,
                            FLOAT_KV_LOGIT_ATOL)
            return
        logits_vs_plain(torch, f"{label} ", eng, env.prompts)
        ops.FORCE = "plain"
        try:
            plain = eng.generate(env.prompts, new)
        finally:
            ops.FORCE = None
        rows = [NS(rid=i, prompt=env.prompts[i].cpu().numpy()) for i in range(slots)]
        greedy_check(torch, f"{label} generate vs plain", {i: NS(tokens=out[i].tolist())
                                                           for i in range(slots)},
                     {i: NS(tokens=plain[i].tolist()) for i in range(slots)}, rows, eng,
                     cfg.vocab)

    def scheduled(label, eng, want_of, **kw):
        """One counted scheduler run of the 16 requests (warm-up included)."""
        ops.reset_launch_counts()
        results, stats = eng.scheduler(chunk_size=chunk, **kw).run(env.reqs, seed=0)
        counts = ops.launch_counts()
        want = dict(zero, **want_of(stats.decode_steps, stats.prefill_chunks))
        check(counts == want, f"{label} launch counts {counts} != expected {want}")
        for k, v in counts.items():
            launches[k] += v
        check_served(label, results, env.reqs, cfg.vocab)
        report(label, stats)
        summaries[label] = stats.summary()
        print(f"[e2e] {label}: {len(results)} requests ok, {stats.decode_steps} ticks, "
              f"{stats.prefill_chunks} chunks; launches {counts} == expected; card {card}",
              flush=True)
        return results

    # -- the main path: int4 weights with block-32 scales --------------------------
    int4 = engine("int4-block")
    generated("int4-block", int4, per_forward)
    chunked = scheduled("int4-block chunked", int4, lambda t, c: {
        "wq4_matmul": per_forward * (t + c + 3), "qdecode_attn": n_layers * (t + 2),
        "qchunk_attn": n_layers * (c + 1)})
    paged = engine("int4-block", paged_kv=True)
    res = scheduled("int4-block chunked, paged", paged, lambda t, c: {
        "wq4_matmul": per_forward * (t + c + 3), "qpaged_decode_attn": n_layers * (t + 2),
        "qpaged_chunk_attn": n_layers * (c + 1)})
    greedy_check(torch, "int4-block paged", res, chunked, env.reqs, int4, cfg.vocab)
    del paged
    res = scheduled("int4-block ragged", int4, lambda t, c: {
        "wq4_matmul": per_forward * (t + 1), "qragged_attn": n_layers * (t + 1)},
        ragged=True, prefill_lanes=2)
    greedy_check(torch, "int4-block ragged", res, chunked, env.reqs, int4, cfg.vocab)

    def decode_step(st):
        cache, tok = st
        logits, cache = int4.decode(tok, cache)
        return cache, torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)

    with torch.inference_mode():
        logits, cache = int4.prefill(env.prompts, int4.new_cache())
    prof = profile_steps(torch, f"int4-block decode step (B={slots})", decode_step,
                         (cache, torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)),
                         card)
    if prof is not None:
        wq4 = sum(t for t, _, key in prof["rows"] if "wq4_matmul" in key)
        print(f"[profile] int4-block decode step: wq4_matmul {wq4:.1f} us/step of device "
              f"time ({wq4 / 1e3 / prof['busy_ms']:.3f} of the device busy time)", flush=True)
    kv_code_flips(torch, "int4-block", int4, env.prompts)

    # -- int8 against int4-block in turns: ragged runs of 8 requests and one
    #    forward at M=72 ------------------------------------------------------------
    for fmt, eng in (("int8", env.engine), ("int4-block", int4), ("int4-block", int4),
                     ("int8", env.engine)):
        _, stats = eng.scheduler(chunk_size=chunk, ragged=True, prefill_lanes=2).run(
            env.reqs[:8], seed=0)
        print(f"[e2e] in turns, {fmt} ragged: steady {stats.steady_tok_s:.1f} tok/s over "
              f"{stats.decode_steps} ticks; card {card}", flush=True)
    tok72 = torch.randint(0, cfg.vocab, (1, slots + 2 * chunk), device="cuda", dtype=torch.int32,
                          generator=torch.Generator(device="cuda").manual_seed(6))
    for fmt, eng in (("int8", env.engine), ("int4-block", int4)):
        def forward(st, eng=eng):
            eng.prefill(tok72, eng.new_cache(batch=1))
            return st

        prof = profile_steps(torch, f"{fmt} forward at M={tok72.shape[1]} (a batch-1 prefill)",
                             forward, None, card)
        if prof is not None:
            gemm = sum(t for t, _, key in prof["rows"] if "wq" in key)
            print(f"[profile] {fmt} forward at M={tok72.shape[1]}: weight GEMM kernels "
                  f"{gemm:.1f} us of {prof['busy_ms'] * 1e3:.1f} us device time", flush=True)
    del int4, cache

    # -- the other packed formats: per-channel int4, and int2 through no kernel ----
    # Per-channel int4 flips more int8 KV codes at truncation edges between the
    # kernels' and the plain versions' sums than block 32 does (kv_code_flips
    # prints both), enough to move its logits past LOGIT_ATOL on an H100; so
    # its logits are held to the plain versions over a float KV cache, where
    # only the order of the f32 sums differs.
    generated("int4 (per-channel)", engine("int4"), per_forward,
              float_kv=engine("int4", quantized_kv=False))
    generated("int2-block", engine("int2-block"), 0)

    # -- bench_weight_formats at its full workload, full width, SHALLOW_LAYERS deep --
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        frontier = bench_weight_formats(env.shallow.model, env.shallow.params, cfg.vocab,
                                        smoke=False, device="cuda")
    except RuntimeError as e:
        fail(f"bench_weight_formats: {e}")
    counts = ops.launch_counts()
    check(counts["wq4_matmul"] > 0 and counts["wq_matmul"] > 0,
          f"bench_weight_formats launched {counts}")
    for k, v in counts.items():
        launches[k] += v
    ratio = frontier["int4"]["kernel_bytes"] / frontier["int8"]["kernel_bytes"]
    check(ratio <= 0.5, f"int4 kernel payload {ratio:.3f}x int8 > 0.5x: packing is broken")
    wl = frontier["workload"]
    print(f"[e2e] bench_weight_formats ({SHALLOW_LAYERS} layers, {wl['n_requests']} requests, "
          f"prompt "
          f"{wl['prompt_len']}, {wl['short_new']}/{wl['long_new']} new, {wl['slots']} slots, "
          f"chunk {wl['chunk']}, block {wl['weight_block']}) in "
          f"{time.perf_counter() - t0:.1f}s: " + " | ".join(
              f"{name} {frontier[name]['tok_s']:.1f} tok/s, kernel {frontier[name]['kernel_bytes']}"
              f" B, tables {frontier[name]['table_bytes']} B, scales "
              f"{frontier[name]['scale_bytes']} B" for name in ("fp32", "int8", "int4"))
          + f" | int4/int8 kernel bytes {ratio:.3f}; repeats token-identical; launches "
          f"{counts}; card {card}", flush=True)
    for label, m in summaries.items():
        print(f"[e2e] {label}: steady {m['steady_tok_s']:.1f} tok/s | latency p50/p99 "
              f"{m['p50_latency_steps']:.0f}/{m['p99_latency_steps']:.0f} ticks | ttft p50/p99 "
              f"{m['p50_ttft_steps']:.0f}/{m['p99_ttft_steps']:.0f} ticks | chunks "
              f"{m['prefill_chunks']} | card {card}", flush=True)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is visible: this script measures the port on the GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import torch.nn.functional as F

        from repro_torch.kernels import _build, ref
        from repro_torch.kernels.fake_quant import fake_quant_cuda
        from repro_torch.kernels.qchunk_attn import qchunk_attn_cuda
        from repro_torch.kernels.qconv1d import qconv1d_cuda
        from repro_torch.kernels.qmm import qmm_cuda, qmm_requant_cuda
        from repro_torch.kernels.qdecode_attn import qdecode_attn_cuda
        from repro_torch.kernels.qpaged_attn import (qpaged_chunk_attn_cuda,
                                                     qpaged_decode_attn_cuda)
        from repro_torch.kernels.qragged_attn import qragged_attn_cuda
        from repro_torch.kernels.wq4_matmul import wq4_matmul_cuda
        from repro_torch.kernels.wq_matmul import wq_matmul_cuda
        from repro_torch.serve.engine import CUDA_PAGE_SIZE
    except ImportError as e:
        fail(f"the port is not importable next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"[card] {card} | torch {torch.__version__} (CUDA {torch.version.cuda}) | "
          f"capability {cap}", flush=True)
    check(cap == (9, 0), f"capability {cap}: the kernels are built for sm_90a")

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"[build] {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())}; all "
          f"{time.perf_counter() - t0:.1f}s (nvcc in parallel)", flush=True)
    for name in _build.KERNELS:
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    for name, entry in (("qdecode_attn", "qdecode_attn_kernel"),
                        ("qpaged_attn", "qpaged_decode_kernel"),
                        ("qragged_attn", "qragged_kernel")):
        log = _build.library_path(name).with_suffix(".log").read_text()
        print(f"[build] {name}: the split kernel's registers by (D, G bucket): "
              f"{split_registers(log, entry)}", flush=True)
    for name, entry in (("qchunk_attn", "qchunk_attn_kernel"),
                        ("qpaged_attn", "qpaged_chunk_kernel")):
        log = _build.library_path(name).with_suffix(".log").read_text()
        print(f"[build] {name}: the chunk kernel's registers by D: "
              f"{split_registers(log, entry)}", flush=True)
    # the GEMMs run on the tensor cores: HMMA in the weight-only GEMMs' machine
    # code, IMMA (integer) and no dp4a in the integer kernels'
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    check(cuobjdump.exists(), f"{cuobjdump} not found: cannot read the GEMMs' machine code")
    for name, op in (("wq_matmul", "HMMA"), ("wq4_matmul", "HMMA"), ("qmm", "IMMA"),
                     ("qconv1d", "IMMA")):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, timeout=120).stdout.splitlines()
        found = sum(op in line for line in sass)
        dp4a = sum("IDP" in line for line in sass)
        check(found > 0, f"{name}: no {op} instruction in its machine code")
        check(dp4a == 0, f"{name}: {dp4a} dp4a (IDP) instructions in its machine code")
        print(f"[build] {name}: {found} {op} (tensor-core) instructions and no dp4a in its "
              f"machine code", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    t1 = time.perf_counter()
    _, wq_layers, wq_err = check_wq_matmul(torch, ref, wq_matmul_cuda, gen)
    check_grants("the wq_matmul kernel check", ran=("wq_matmul",))
    _, wq4_layers, wq4_err = check_wq4_matmul(torch, ref, wq4_matmul_cuda, gen)
    check_grants("the wq4_matmul kernel check", ran=("wq_matmul", "wq4_matmul"))
    qd_rows, qd_err = check_qdecode_attn(torch, F, ref, qdecode_attn_cuda,
                                         qpaged_decode_attn_cuda, gen)
    qc_rows, qc_err = check_qchunk_attn(torch, F, ref, qchunk_attn_cuda, qdecode_attn_cuda, gen)
    pd_rows, _, pd_err = check_qpaged_decode_attn(torch, F, ref, qpaged_decode_attn_cuda,
                                                  qdecode_attn_cuda, gen, CUDA_PAGE_SIZE)
    pc_rows, pc_err = check_qpaged_chunk_attn(torch, F, ref, qpaged_chunk_attn_cuda,
                                              qchunk_attn_cuda, gen, CUDA_PAGE_SIZE)
    qr_rows, qr_err = check_qragged_attn(torch, F, ref, SimpleNamespace(
        qragged=qragged_attn_cuda, qdecode=qdecode_attn_cuda, qchunk=qchunk_attn_cuda,
        qpaged_decode=qpaged_decode_attn_cuda, qpaged_chunk=qpaged_chunk_attn_cuda),
        gen, CUDA_PAGE_SIZE)
    check_split_instantiations(torch, ref, qpaged_decode_attn_cuda, qragged_attn_cuda,
                               qdecode_attn_cuda, gen)
    t_int = time.perf_counter()
    qmm_rows = check_qmm(torch, ref, qmm_cuda, gen)
    qmr_rows = check_qmm_requant(torch, ref, qmm_requant_cuda, gen)
    qconv_rows, _ = check_qconv1d(torch, F, ref, qconv1d_cuda, gen)
    fq_row = check_fake_quant(torch, ref, fake_quant_cuda, gen)
    t2 = time.perf_counter()
    print(f"[time] kernel checks: serving kernels {t_int - t1:.1f}s, integer-engine kernels "
          f"{t2 - t_int:.1f}s", flush=True)
    launches = end_to_end(torch, card)
    t3 = time.perf_counter()
    int_launches = integer_end_to_end(torch, card)
    t4 = time.perf_counter()
    print(f"[time] integer engine phase {t4 - t3:.1f}s", flush=True)
    train_launches = train_end_to_end(torch, card)
    t5 = time.perf_counter()
    print(f"[time] training phase {t5 - t4:.1f}s", flush=True)
    print(f"[time] build {t1 - t0:.1f}s | kernel checks {t2 - t1:.1f}s | serving "
          f"{t3 - t2:.1f}s | integer engine {t4 - t3:.1f}s | training {t5 - t4:.1f}s | all "
          f"{t5 - t0:.1f}s", flush=True)
    launches = {k: launches.get(k, 0) + int_launches.get(k, 0) + train_launches.get(k, 0)
                for k in int_launches}

    wq_main = wq_layers[8]
    qd_main = next(r for r in qd_rows if r["s"] == 2048 and r["codes"] == "uniform")
    qc_main = qc_rows[1]
    kernels = [
        {"name": "wq_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/wq_matmul.cu",
         "replaces": "src/repro/kernels/wq_matmul.py:51",
         "launches": launches["wq_matmul"], "max_abs_err": wq_err,
         "ms": wq_main["ms"], "plain_ms": wq_main["plain_ms"],
         "bound_ms": wq_main["bound_ms"], "bound_by": wq_main["bound_by"],
         "library_ms": wq_main["library_ms"],
         "shape": "one decode layer: 7 calls at M=8 (576x576 x2, 576x192 x2, "
                  "576x1536 x2, 1536x576)"},
        {"name": "qdecode_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qdecode_attn.cu",
         "replaces": "src/repro/kernels/qdecode_attn.py:65",
         "launches": launches["qdecode_attn"], "max_abs_err": qd_err,
         "ms": qd_main["ms"], "plain_ms": qd_main["plain_ms"],
         "bound_ms": qd_main["bound_ms"], "bound_by": qd_main["bound_by"],
         "library_ms": qd_main["library_ms"],
         "shape": f"B=8 Hq=9 Hkv=3 D=64 S={qd_main['s']} kv_len={qd_main['lens']}",
         "ranks": qd_main["ranks"],
         "beside": [{k: r[k] for k in ("s", "lens", "d", "g", "codes", "ranks", "ms",
                                       "plain_ms", "library_ms", "bound_ms", "bound_by")}
                    for r in qd_rows if r is not qd_main]},
        {"name": "qchunk_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qchunk_attn.cu",
         "replaces": "src/repro/kernels/qchunk_attn.py:107",
         "launches": launches["qchunk_attn"], "max_abs_err": qc_err,
         "ms": qc_main["ms"], "plain_ms": qc_main["plain_ms"],
         "bound_ms": qc_main["bound_ms"], "bound_by": qc_main["bound_by"],
         "library_ms": qc_main["library_ms"],
         "shape": f"B=8 Hq=9 Hkv=3 D=64 C={qc_main['c']} S={qc_main['s']} "
                  f"start={qc_main['start']} (the serving path's last chunk)",
         "ranks": qc_main["ranks"], "f32_bound_ms": qc_main["f32_bound_ms"],
         "beside": chunk_beside(qc_rows, qc_main)},
    ]
    pd_main, pc_main = pd_rows[0], pc_rows[1]
    kernels += [
        {"name": "qpaged_decode_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qpaged_attn.cu",
         "replaces": "src/repro/kernels/qpaged_attn.py:102",
         "launches": launches["qpaged_decode_attn"], "max_abs_err": pd_err,
         "ms": pd_main["ms"], "plain_ms": pd_main["plain_ms"],
         "bound_ms": pd_main["bound_ms"], "bound_by": pd_main["bound_by"],
         "library_ms": pd_main["library_ms"],
         "shape": f"B=8 Hq=9 Hkv=3 D=64 S={pd_main['s']} ps={pd_main['ps']} "
                  f"kv_len={pd_main['lens']} (slot 5 evicted)", "ranks": pd_main["ranks"]},
        {"name": "qpaged_chunk_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qpaged_attn.cu",
         "replaces": "src/repro/kernels/qpaged_attn.py:247",
         "launches": launches["qpaged_chunk_attn"], "max_abs_err": pc_err,
         "ms": pc_main["ms"], "plain_ms": pc_main["plain_ms"],
         "bound_ms": pc_main["bound_ms"], "bound_by": pc_main["bound_by"],
         "library_ms": pc_main["library_ms"],
         "shape": f"Hq=9 Hkv=3 D=64 C={pc_main['c']} S={pc_main['s']} ps={pc_main['ps']} "
                  f"start={pc_main['start']} (the serving path's last chunk)",
         "ranks": pc_main["ranks"], "f32_bound_ms": pc_main["f32_bound_ms"],
         "beside": chunk_beside(pc_rows, pc_main)},
    ]
    qr_main = qr_rows[0]
    kernels.append(
        {"name": "qragged_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qragged_attn.cu",
         "replaces": "src/repro/kernels/qragged_attn.py:123",
         "launches": launches["qragged_attn"], "max_abs_err": qr_err,
         "ms": qr_main["ms"], "plain_ms": qr_main["plain_ms"],
         "bound_ms": qr_main["bound_ms"], "bound_by": qr_main["bound_by"],
         "library_ms": qr_main["library_ms"],
         "shape": f"B=8 Hq=9 Hkv=3 D=64 T={qr_main['t']} (8 decode rows, 2 inert; 2 lanes x 32 "
                  f"at start 96) S={qr_main['s']} {qr_main['layout']} (the ragged serving "
                  f"tick)", "ranks": qr_main["ranks"]})
    wq4_main = wq4_layers[(8, 32)]
    kernels.insert(1, {
        "name": "wq4_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wq4_matmul.cu",
        "replaces": "src/repro/kernels/wq_matmul.py:130",
        "launches": launches["wq4_matmul"], "max_abs_err": wq4_err,
        "ms": wq4_main["ms"], "plain_ms": wq4_main["plain_ms"],
        "bound_ms": wq4_main["bound_ms"], "bound_by": wq4_main["bound_by"],
        "library_ms": wq4_main["library_ms"],
        "shape": "one decode layer, int4 with block-32 scales: 7 calls at M=8 (576x576 x2, "
                 "576x192 x2, 576x1536 x2, 1536x576)"})
    qmm_main = next(r for r in qmm_rows if r["label"] == "classifier" and r["dtype"] == "int8")
    qmr_main = next(r for r in qmr_rows if r["label"] == "classifier" and r["dtype"] == "int8")
    qconv_main = next(r for r in qconv_rows if r["label"] == "conv2/3" and r["dtype"] == "int8")

    def beside(rows, main):
        """The other timed shapes of a kernel, so that every line a library
        call beat stays visible beside the main one."""
        keys = ("label", "dtype", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        return [{k: r[k] for k in keys} for r in rows if r is not main]

    for name, source, replaces, row, shape, others in (
            ("qmm", "qmm.cu", "qmm.py:77", qmm_main,
             f"the classifier: ({PATH_BATCH}, {RESNET_FILTERS}) @ ({RESNET_FILTERS}, 6) int8",
             beside(qmm_rows, qmm_main)),
            ("qmm_requant", "qmm.cu", "qmm.py:118", qmr_main,
             f"({PATH_BATCH}, {RESNET_FILTERS}) @ ({RESNET_FILTERS}, 6) int8, shift 11, width 8",
             beside(qmr_rows, qmr_main)),
            ("qconv1d", "qconv1d.cu", "qconv1d.py:36", qconv_main,
             f"conv2/3: B={PATH_BATCH} W=128 C={RESNET_FILTERS} F={RESNET_FILTERS} K=3 int8 "
             f"SAME", beside(qconv_rows, qconv_main)),
            ("fake_quant", "fake_quant.cu", "fake_quant.py:30", fq_row,
             f"{fq_row['shape']} f32, n=4, width 8", [])):
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": launches[name],
            "max_abs_err": row["err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape,
            **({"beside": others} if others else {})})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
