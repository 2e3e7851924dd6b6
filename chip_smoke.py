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
     (C=1024 int16 at K=7, and an int32 wrap across channel chunks); at the
     dense-family archs' shapes, ``wq_matmul`` at glm4-9b's projections
     (M = 8 and 32; K = 13696 = 107 x 128 for the down projection) and
     qwen2.5-14b's untied head (N = 152064), and the five attention kernels
     at D=128 and G = 2, 5, 12, 16 (internvl, qwen, command-r, glm4) over
     post-norm codes on glm4-9b's served cache (B=8, S=160, C=32 at start
     96, the ragged tick's 8 decode rows and 2 lanes), timed beside their
     plain versions and library calls;
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
  6. ``[hardened]``: ``bench_chaos``'s smoke workload and fault plan (10
     requests, prompt 64, 48 new tokens, 10 slots, a pool of 21 pages, swap
     preemption, deadline 600, ``max_queue`` 10; alloc_fail {6, 7},
     swap_fail {6, 7, 9}, admit_stall {3}, nan {40: 2}) at full width, 4
     layers deep, unaudited, audited and audited under the plan: launch counts
     exact and equal (audit adds none), the non-faulted streams equal to
     the fault-free run's, exactly the NaN victim ``failed``, every tick
     audited, wall and syncs per tick printed; the plan on the ragged tick
     (2 lanes, 4 layers deep); a faulted run at temperature 0.7 (no
     device-side assert); ``launch.serve`` with the five hardening flags;
     an audited paged decode and mixed tick profiled;
  7. ``Scheduler(chunk_size=32, ragged=True, prefill_lanes=2)`` on the 16
     requests, dense and paged, on the shared prefix and at half the pool
     under recompute and swap (4 layers deep, as in 5), and
     ``bench_burst``'s full burst (16 x 192
     tokens at tick 0, 16 slots, 4 lanes, budget 160) beside the paged
     mixed step, with TTFT in ticks and ms: launch counts exact, greedy
     tokens held to the chunked runs; a ragged tick's logits against the
     plain versions; a dense and a paged ragged tick profiled;
  8. packed int4 weights with block-32 scales (``--wq int4-block``):
     ``generate``, the chunked ``Scheduler`` on 8 of the 16 requests, the
     paged engine and the ragged tick, with exact launch counts (7 x 30
     ``wq4_matmul`` per forward, no ``wq_matmul``), logits and generated
     tokens held to the plain versions, paged and ragged tokens held to the
     chunked run; per-channel ``int4`` and ``int2-block`` generate (int2:
     no kernel); an int4 decode step and int8 / int4 forwards at M = 72
     profiled, int8 and int4 ragged runs of 4 requests in turns;
     ``bench_weight_formats`` at its full setting (fp32 / int8 / int4-block,
     16 requests of 256 tokens, chunk 64) at full width and 4 layers deep,
     with its token-identical repeats and int4 kernel bytes <= 0.5x int8;
  9. the paper's integer engine: ResNetv1-6 at filters 80 on 2947
     UCI-HAR-shaped windows (seeded), calibrated on 4 batches of 32,
     integerized int8 per-layer and int16 Q7.9, full-integer forwards with
     exactly 6 ``qconv1d`` and 1 ``qmm`` launches each, logits equal to the
     plain versions', argmax agreement with the EVAL fake-quant forward >
     0.9 and int8 ROM > 3.5x smaller than f32; ``fake_quant`` and
     ``qmm_requant`` through their ``ops`` entry points; inferences/s and a
     profile of each integer forward beside the float forward;
  10. training (``train_end_to_end``): the paper's flow on ResNetv1-6 at
     filters 80 (float training, int8 QAT fine-tuning, calibration,
     integerization, the integer forward over the synthetic test split with
     exactly 6 ``qconv1d`` + 1 ``qmm`` launches and logits equal to the plain
     versions'; accuracies and a profiled step of each training); smollm-135m
     at full width through ``launch.train.main`` (AdamW, B=8, S=128, float
     and ``--qat``: the loss falls; a preempted run resumes exactly; tokens/s,
     a profiled step, syncs, peak memory); the card's gradient held to the
     CPU's at smollm-135m-smoke and ResNet filters 12, float and QAT;
  11. ``[archs]`` (``archs_end_to_end``): glm4-9b at its published width and
     depth (8.78 B parameters, seeded), int8 weights and KV, served through
     ``launch.serve.main`` (``--policy chunked --paged``, 8 requests of 128 +
     32 tokens, 8 slots): every request ``ok``, launch counts exact, peak
     memory printed; on the same weights a lockstep prefill and decode step
     and a chunked prefill held to the plain versions, a decode step
     profiled; then qwen2.5-14b (8 of 48 layers), command-r-plus-104b (2 of
     64) and internvl2-2b (whole, one forward over its 256-position stub
     prefix) at full width, each held to the plain versions with launch
     counts exact, each freed before the next.
  12. ``[recurrent]`` (``recurrent_end_to_end``): rwkv6-7b (32 layers,
     d_model 4096, 7.25 B parameters) and mamba-130m (24 layers, d_model
     768) whole, seeded, int8 weights, served through ``launch.serve.main``
     (``--policy chunked``, mamba also ``scheduler``; 8 requests of 128 + 32
     tokens, 8 slots, chunk 32): every request ``ok``, ``wq_matmul`` counts
     exact (8 a layer for rwkv, 6 for mamba, per forward); on the same
     weights a decode step's and a chunk's logits held to the plain
     versions from one shared state, a mixed tick's inactive slots'
     recurrent rows bit for bit, an audited run clean with one read-back a
     tick, the decode step and mixed tick profiled (``wq_matmul``'s share),
     the scans' per-token kernels counted; in the kernel phase,
     ``wq_matmul`` at the two archs' eight (K, N) at M = 8 and 32.
  13. ``[encdec]`` (``encdec_end_to_end``): whisper-tiny whole (4 + 4
     layers, d_model 384, 6 heads over 6 KV heads of 64, 1500 encoder
     frames), seeded float32 weights and int8 KV, served through the
     ``Scheduler`` with ``Request.enc`` (8 requests of 32 + 64 tokens, the
     encoder outputs of 1500 seeded stub frames, 8 slots, chunk 32):
     chunked dense and paged, ragged (2 lanes) dense and paged, audited
     (one read-back a tick), without the cross-attention cache, and runs at
     1000 and 500 encoder frames; attention-kernel counts exact and no
     ``wq_matmul``, every request ``ok``, streams held to the chunked run's;
     on one shared state a decode step and a chunk held to the plain
     versions, cached cross-attention to the re-projected one over reused
     slots, cross bytes per slot, peak memory, a decode step and a mixed
     tick profiled; in the kernel phase, the five attention kernels at G = 1
     (B=8, D=64, S = 96 and 2048).
  14. ``[moe]`` (``moe_end_to_end``): phi3.5-moe-42b-a6.6b at its published
     width (d_model 4096, 32/8 heads of 128, 16 experts of 6400, top-2,
     LayerNorm, untied head over 32064), 8 of its 32 layers (10.66 B
     parameters: the whole model's 168 GB of float32 init cannot be held),
     seeded, int8 weights and KV, served through ``launch.serve.main`` (8
     requests of 32 + 64 tokens, arrival spacing 2, 8 slots, chunk 32):
     ``chunked --paged``, ``ragged`` and ``chunked --audit``; on the last
     run's engine a decode step and a chunk held to the plain versions on
     one shared cache, with the tokens whose expert choice differs between
     the two paths counted (a miss is held again under the kernel path's
     routing), and a decode step and a mixed tick profiled; jamba-v0.1-52b's
     first period (8 of 32 layers) at full width served ``chunked`` and held
     and profiled the same way; kimi-k2-1t-a32b at smoke width (its dense
     prelude layer and shared expert) served ``chunked``.  Launch counts
     exact in every run, every request ``ok``, peak memory printed.  In the
     kernel phase (``check_moe_kernels``): the five attention kernels at G =
     4 (Hq = 32, Hkv = 8, D = 128, B = 8; S = 160 and 2048), ``wq_matmul`` at
     phi's projections and head and jamba's Mamba and dense-FFN shapes (M =
     8 and 32), and one phi layer's expert products (the int8 stacks
     dequantized whole, as the reference does) against their byte bound.
  15. ``[dist]`` (``dist_end_to_end``): the data axis over torch.distributed:
     world 1 over NCCL in this process and world 2 over gloo, ranks of this
     script under ``torchrun --standalone`` (``--dist-rank``) with both on
     the one card (NCCL takes one rank a card), each running ``launch.train.main --mesh
     W,1`` (smollm-135m at full width, AdamW, B=8, S=128) float and
     ``--qat`` and ``make_dp_shardmap_train_step`` with ``compress_bits`` 8
     and 0, 4 steps each: the loss falls, every rank's parameters equal rank
     0's after every step, the compressed mean within one grid step of the
     exact one, world 1's losses those of the run without a group (rtol
     1e-5); step wall and device ms, the gradient all-reduce's ms and
     payload bytes and peak memory a rank printed.  GPipe is held on the
     CPU tests only (no CUDA send/recv in gloo; NCCL needs a second card).
  16. ``[shard]`` (``shard_end_to_end``): the model axis, world 4 over gloo
     on the one card, mesh (2, 2), ranks of this script under ``torchrun``
     (``--shard-rank``; gloo's CUDA gathers made of all-reduces), against
     world 1 in this process: ``launch.train.main --mesh 2,2``
     (smollm-135m at full width, AdamW, B=8, S=128, float and ``--qat``, 2
     steps: step 0's loss at rtol 1e-5, replicated leaves equal on every
     rank), the gradient through one SGD step (float every value at rtol
     1e-4, QAT all but 1e-3), one ``int8_weight_gather`` step, and
     phi3.5-moe (full width, one layer, int8 weights and KV) decoding one
     step weight-stationary on each rank's rows of world 1's cache (rtol
     2e-4, argmax equal, ``wq_matmul`` and ``qdecode_attn`` launched);
     step wall and device ms, collective calls, bytes and ms by axis and
     kind, and peak memory a rank printed.  Then its serving part
     (``shard_serving``, world 1 in this process and each rank):
     ``ServeEngine(mesh=)`` with smollm-135m at full width cut to 8 of 30
     layers (int8 weights and KV, 8 slots, 8 requests of 32 + 16) under
     ``scheduler``, ``chunked --paged`` (page 16) and ``ragged`` (2
     lanes), and phi3.5-moe's one layer under ``chunked``: every request
     ``ok``, every rank's streams world 1's, launches exact on each rank
     (the chunk kernels on the chunk's owner only); a tick's wall ms and
     the collective calls and bytes a tick by axis and kind printed.  Then
     the page pool's features and hardened serving (``SHARD_SERVE_MORE``):
     ``chunked --paged`` oversubscribed at half the pool under ``swap``, a
     paged prefix-sharing run, and an audited ``ragged --paged`` run with
     a fault plan (``alloc_fail``, a NaN on slot 5, data rank 1's, and one
     forced preemption): each request's status and stream world 1's on
     every rank, every rank's counters the same, each rank's decode
     kernel launched ticks x layers times; a tick's wall ms, its
     collectives by axis and kind, the audit's read-backs and the page-0
     mirror's broadcasts (calls, bytes and ms) a tick printed.  The kernel
     phase holds ``wq_matmul`` at the column blocks the decode gives it
     (``check_shard_kernels``).
  17. ``[account]`` (``account_end_to_end``): the dry-run account
     (``launch/dryrun.py``) held to the card.  smollm-135m ``decode_32k
     --wq --qkv`` at mesh 1 x 1 and full width: the account's argument
     bytes on ``meta``, then the same int8 parameters, the (128, 1) tokens
     and the 48.3 GB int8 cache allocated on the card, whose allocator's
     requested bytes must grow by exactly the account's; one decode step
     at kv_len 32768 with its launches exact, its CUDA-event time beside
     the account's roofline terms (FLOPs over the bf16 peak, argument bytes
     over HBM) and its peak memory beside the arguments; ``qdecode_attn``
     alone at S = 32768 (B = 128, and B = 8 held to its plain version, with
     sdpa on dequantized K/V beside it) and the ranks ``split_ranks``
     picks.  smollm-135m ``train_4k``: the f32 parameters, SGD momentum and
     the (256, 4096) batch allocated against the account, then the first 2
     micro-batches of ``microbatch_split`` 64 under ``remat="off"`` and
     ``"none"`` with their peak memory (none's must be lower).  Every arch
     x shape's argument bytes at 1 x 1 on ``meta`` (f32, and int8 weights
     and KV for serving) against the card's memory, and smollm-135m's
     ``train_4k`` and ``decode_32k --wq --qkv`` at the 16 x 16 production
     mesh over a fake process group, collectives on both axes: these run
     on the host's cores in a process of their own (``--account-cells``,
     no card visible), started after the build, and the phase reads them.
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


SHALLOW_LAYERS = 4           # depth of the oversubscribed runs, bench_weight_formats and
#                              the hardened chaos lane
SUBINT8_REQUESTS = 8         # of the 16: the int4-block scheduler runs
TURN_REQUESTS = 4            # of the 16: the int8 / int4-block ragged runs in turns (8
#                              until the mesh's pool runs of [shard] needed the time)
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


def wq_case(torch, ref, wq_cuda, gen, m, label, k, n, per_layer=1):
    """One ``wq_matmul`` shape against its plain version on per-channel
    scales, timed (kernel, plain, ``torch.matmul`` on the dequantized
    weight) over weight copies rotated past the L2; the row."""
    from repro_torch.kernels.wq_matmul import plan

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
    if label == "wq/wo" and m == 72:   # one scale for the whole tensor
        one = scale[:1].clone()
        e1 = (wq_cuda(x, ws[0], one) - ref.wq_matmul_ref(x, ws[0], one)).abs().max()
        check(e1.item() <= WQ_RTOL * ref.wq_matmul_ref(x, ws[0], one).abs().max().item(),
              f"wq_matmul M={m} {k}x{n} per-tensor scale: max err {e1.item()}")
    del want, got
    iters = max(len(ws), 64)
    ms = graph_ms(torch, [lambda w=w: wq_cuda(x, w, scale) for w in ws], iters)
    nbytes = 4 * m * k + k * n + 4 * n + 4 * m * n
    (b_ms, b_by), (f32_ms, _) = gemm_bounds(m, k, n, nbytes)
    deq = [w.to(torch.float32) * scale for w in
           ws[:max(1, min(len(ws), math.ceil(L2_ROTATE_BYTES / (4 * k * n))))]]
    plain = graph_ms(torch, [lambda w=w: ref.wq_matmul_ref(x, w, scale) for w in ws], iters)
    lib = graph_ms(torch, [lambda w=w: torch.matmul(x, w) for w in deq], iters)
    print(f"[kernel] wq_matmul M={m:4d} K={k:4d} N={n:4d} ({label}): "
          f"max_abs_err {err:.3e} (tol {tol:.3e}) | kernel {ms * 1e3:.2f} us "
          f"({plan(m, k, n)}) | plain {plain * 1e3:.2f} us | torch.matmul on "
          f"dequantized {lib * 1e3:.2f} us | bound {b_ms * 1e3:.2f} us ({b_by}; "
          f"f32 CUDA cores {f32_ms * 1e3:.2f})", flush=True)
    return dict(m=m, shape=label, k=k, n=n, err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, f32_bound_ms=f32_ms, per_layer=per_layer)


def check_wq_matmul(torch, ref, wq_cuda, gen):
    """Kernel vs plain at the four projection shapes, per-channel scales
    (plus one per-tensor scale), M = 8 (decode), 32 (a mixed tick's chunk),
    72 and 144 (the ragged tick's T at B=8, L=2, C=32 and at B=16, L=4,
    C=32) and 8*128."""
    rows = [wq_case(torch, ref, wq_cuda, gen, m, label, k, n, CALLS_PER_LAYER[label])
            for m in (8, 32, 72, 144, 8 * 128) for label, (k, n) in SERVE_SHAPES.items()]
    layers = {}
    for m in sorted({r["m"] for r in rows}):
        layers[m] = layer = layer_sum([r for r in rows if r["m"] == m])
        what = "decode layer" if m == 8 else "layer"
        print(f"[kernel] wq_matmul one {what} (7 calls, M={m}): kernel {layer['ms'] * 1e3:.2f} "
              f"us | plain {layer['plain_ms'] * 1e3:.2f} us | library "
              f"{layer['library_ms'] * 1e3:.2f} us | bound {layer['bound_ms'] * 1e3:.2f} us "
              f"({layer['bound_by']}; f32 CUDA cores {layer['f32_bound_ms'] * 1e3:.2f})",
              flush=True)
    return rows, layers, max(r["err"] for r in rows)


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


# The dense-family archs' shapes (``[archs]``): their GQA groups at D=128,
# (arch, Hq, Hkv), and glm4-9b's projections and qwen2.5-14b's untied head,
# (label, K, N, calls per layer).
ARCH_HEADS = (("internvl2-2b", 16, 8), ("qwen2.5-14b", 40, 8),
              ("command-r-plus-104b", 96, 8), ("glm4-9b", 32, 2))
ARCH_GEMMS = (("glm4 wq/wo", 4096, 4096, 2), ("glm4 wk/wv", 4096, 256, 2),
              ("glm4 gate/in", 4096, 13696, 2), ("glm4 out", 13696, 4096, 1),
              ("qwen lm_head", 5120, 152064, 0))
ARCH_S, ARCH_B, ARCH_C, ARCH_START = 160, 8, 32, 96   # glm4-9b's served cache and chunk


def check_arch_kernels(torch, F, ref, kern, gen, page_size):
    """The kernels at the dense-family archs' shapes, against their plain
    versions and timed beside them (kernel, plain, library, bound):
    ``wq_matmul`` at glm4-9b's projections (M = 8 and 32) and qwen2.5-14b's
    untied head (M = 8, N = 152064); the five attention kernels at D = 128
    and G = 2, 5, 12, 16 (internvl, qwen, command-r, glm4), B = 8 over the
    served cache (S = 160; paged at ``page_size`` through a fragmented
    table), a C = 32 chunk at start 96, and the ragged tick (8 decode rows,
    2 lanes x 32), all over post-norm codes.  Chunk and ragged writes must
    equal the plain versions' bytes.  Returns the rows by kernel and the
    worst error."""
    out = {"wq_matmul": [wq_case(torch, ref, kern.wq, gen, m, label, k, n, per)
                         for label, k, n, per in ARCH_GEMMS for m in ((8,) if per == 0
                                                                      else (8, 32))]}
    glm = [r for r in out["wq_matmul"] if r["shape"].startswith("glm4")]
    for m in (8, 32):
        layer = layer_sum([r for r in glm if r["m"] == m])
        out["wq_matmul"].append(dict(layer, m=m, shape="glm4 layer (7 calls)", err=0.0))
        print(f"[kernel] wq_matmul one glm4-9b layer (7 calls, M={m}): kernel "
              f"{layer['ms'] * 1e3:.2f} us | plain {layer['plain_ms'] * 1e3:.2f} us | library "
              f"{layer['library_ms'] * 1e3:.2f} us | bound {layer['bound_ms'] * 1e3:.2f} us "
              f"({layer['bound_by']})", flush=True)
    worst = max(r["err"] for r in out["wq_matmul"])

    for name in ATTN_KERNELS:
        out[name] = []
    for arch, hq, hkv in ARCH_HEADS:
        attention_cells(torch, F, ref, kern, gen, out, arch, hq, hkv, d=128, s=ARCH_S,
                        start=ARCH_START, lens=[160, 1, 100, 159, 17, 64, 128, 129],
                        ps=page_size)
    worst = max([worst] + [r["err"] for rows in out.values() for r in rows])
    return out, worst


ATTN_KERNELS = ("qdecode_attn", "qpaged_decode_attn", "qchunk_attn", "qpaged_chunk_attn",
                "qragged_attn")


def attention_cells(torch, F, ref, kern, gen, out, arch, hq, hkv, d, s, start, lens, ps):
    """The five attention kernels (``kern.qd``, ``qpd``, ``qc``, ``qpc``,
    ``qr``) at one cell: B = 8 slots of Hq query heads over Hkv KV heads of
    ``d`` over a served cache of ``s`` rows with live lengths ``lens`` (paged
    at ``ps`` through a fragmented table), a C = 32 chunk at ``start`` and
    the ragged tick (8 decode rows, 2 lanes x 32), all over post-norm
    codes.  Each is held to its plain version (chunk and ragged writes byte
    for byte) and timed beside it, a library call and its bound; the rows
    are appended to ``out[kernel]``, labelled ``arch``."""
    from repro_torch.core import qformat
    from repro_torch.kernels.attn_split import chunk_ranks, chunk_tiles, split_ranks

    b, c = ARCH_B, ARCH_C
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    live = sum(lens)
    pairs = c * start + c * (c + 1) // 2

    def add(name, arch, g, hq, hkv, ranks, err, calls, plain_calls, lib_calls, bnd):
        iters = max(len(calls), 64)
        ms = graph_ms(torch, calls, iters)
        plain = graph_ms(torch, plain_calls, iters)
        lib = graph_ms(torch, lib_calls, iters)
        b_ms, b_by = bnd[:2]
        out[name].append(dict(arch=arch, g=g, hq=hq, hkv=hkv, d=d, s=s, ranks=ranks, err=err,
                              ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                              bound_by=b_by))
        print(f"[kernel] {name} {arch}: B={b} Hq={hq} Hkv={hkv} D={d} G={g} S={s} R={ranks}: "
              f"max_abs_err {err:.3e} (tol {ATTN_ATOL:.0e}) | kernel {ms * 1e3:.2f} us | "
              f"plain {plain * 1e3:.2f} us | library {lib * 1e3:.2f} us | bound "
              f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)

    g = hq // hkv
    # -- the dense decode, over post-norm codes ------------------------------
    q = torch.randn(b, hq, d, generator=gen, device="cuda")
    copies = max(1, math.ceil(L2_ROTATE_BYTES / (2 * b * s * hkv * d)))
    caches = [tuple(pool_codes(torch, gen, (b, s, hkv, d)) for _ in range(2))
              for _ in range(copies)]
    err = max_err(kern.qd(q, *caches[0], 3, 3, kv_len),
                  ref.qdecode_attn_ref(q, *caches[0], 3, 3, kv_len))
    check(err <= ATTN_ATOL, f"qdecode_attn {arch}: max err {err} > {ATTN_ATOL}")
    mask = (torch.arange(s, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    deq = [tuple(x.to(torch.float32).mul(0.125).repeat_interleave(g, dim=2)
                 .permute(0, 2, 1, 3).contiguous() for x in kv) for kv in caches[:4]]
    add("qdecode_attn", arch, g, hq, hkv, split_ranks(s, b, hkv, d), err,
        [lambda kv=kv: kern.qd(q, kv[0], kv[1], 3, 3, kv_len) for kv in caches],
        [lambda kv=kv: ref.qdecode_attn_ref(q, kv[0], kv[1], 3, 3, kv_len)
         for kv in caches],
        [lambda kv=kv: F.scaled_dot_product_attention(qs, kv[0], kv[1], attn_mask=mask)
         for kv in deq],
        bound(2 * 4 * b * hq * d + 2 * live * hkv * d + 4 * b, 4.0 * live * hq * d))
    del deq

    # -- the dense chunk into slot 5 at ``start`` -------------------------------
    slot = 5
    qc = torch.randn(c, hq, d, generator=gen, device="cuda")
    kc, vc = (1.5 * torch.randn(c, hkv, d, generator=gen, device="cuda") for _ in range(2))
    kc.view(-1)[::31] = 20.0
    vc.view(-1)[::37] = -20.0
    kk, vk, kp, vp = (x.clone() for x in (*caches[0], *caches[0]))
    err = max_err(kern.qc(qc, kc, vc, kk, vk, 3, 3, slot, start),
                  ref.qchunk_attn_ref(qc, kc, vc, kp, vp, 3, 3, slot, start))
    check(err <= ATTN_ATOL and torch.equal(kk, kp) and torch.equal(vk, vp),
          f"qchunk_attn {arch}: max err {err} (tol {ATTN_ATOL}) or caches differ")
    end = start + c
    cmask = torch.arange(end, device="cuda")[None, :] <= \
        start + torch.arange(c, device="cuda")[:, None]
    qcs = qc.permute(1, 0, 2)[None]
    cdeq = [tuple(qformat.dequantize(x[slot, :end], 3).repeat_interleave(g, dim=1)
                  .permute(1, 0, 2)[None].contiguous() for x in (kp, vp)) for _ in range(4)]

    def chunk_lib(kv, kq=kk, vq=vk):
        kq[slot, start:end] = qformat.quantize(kc, 3, 8)
        vq[slot, start:end] = qformat.quantize(vc, 3, 8)
        return F.scaled_dot_product_attention(qcs, kv[0], kv[1], attn_mask=cmask)

    calls = [(kv, j) for kv in caches for j in range(b)]
    add("qchunk_attn", arch, g, hq, hkv, chunk_ranks(s, chunk_tiles(c, g)[0], hkv, d), err,
        [lambda kv=kv, j=j: kern.qc(qc, kc, vc, kv[0], kv[1], 3, 3, j, start)
         for kv, j in calls],
        [lambda kv=kv, j=j: ref.qchunk_attn_ref(qc, kc, vc, kv[0], kv[1], 3, 3, j, start)
         for kv, j in calls[:16]],
        [lambda kv=kv: chunk_lib(kv) for kv in cdeq],
        chunk_bounds(2 * start * hkv * d + 2 * c * hkv * d
                     + 4 * (2 * c * hq * d + 2 * c * hkv * d), pairs, hq, d))
    del caches, cdeq

    # -- the paged decode and chunk through a fragmented table ---------------
    table, n_pool, mp = paged_layout(torch, gen, b, s, ps)
    copies = max(1, math.ceil(L2_ROTATE_BYTES / (2 * n_pool * ps * hkv * d)))
    pools = [tuple(pool_codes(torch, gen, (n_pool, ps, hkv, d)) for _ in range(2))
             for _ in range(copies)]
    err = max_err(kern.qpd(q, *pools[0], 3, 3, table, kv_len),
                  ref.qpaged_decode_attn_ref(q, *pools[0], 3, 3, table, kv_len))
    check(err <= ATTN_ATOL, f"qpaged_decode_attn {arch}: max err {err} > {ATTN_ATOL}")
    idx = table.clamp(min=0).reshape(-1).to(torch.int64)
    pmask = (torch.arange(mp * ps, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]

    def paged_lib(kv):
        kk_, vv_ = (x.index_select(0, idx).reshape(b, mp * ps, hkv, d).to(torch.float32)
                    .mul(0.125).repeat_interleave(g, dim=2).permute(0, 2, 1, 3) for x in kv)
        return F.scaled_dot_product_attention(qs, kk_, vv_, attn_mask=pmask)

    pages = sum(-(-n // ps) for n in lens)
    add("qpaged_decode_attn", arch, g, hq, hkv, split_ranks(mp * ps, b, hkv, d), err,
        [lambda kv=kv: kern.qpd(q, kv[0], kv[1], 3, 3, table, kv_len) for kv in pools],
        [lambda kv=kv: ref.qpaged_decode_attn_ref(q, kv[0], kv[1], 3, 3, table, kv_len)
         for kv in pools],
        [lambda kv=kv: paged_lib(kv) for kv in pools[:4]],
        bound(2 * 4 * b * hq * d + 2 * live * hkv * d + 4 * pages + 4 * b,
              4.0 * live * hq * d))
    prow = table[1].contiguous()                   # slot 1: a shared two-page prefix
    kk, vk, kp, vp = (x.clone() for x in (*pools[0], *pools[0]))
    err = max_err(kern.qpc(qc, kc, vc, kk, vk, 3, 3, prow, start),
                  ref.qpaged_chunk_attn_ref(qc, kc, vc, kp, vp, 3, 3, prow, start))
    check(err <= ATTN_ATOL and torch.equal(kk, kp) and torch.equal(vk, vp),
          f"qpaged_chunk_attn {arch}: max err {err} (tol {ATTN_ATOL}) or pools differ")
    rows_w = torch.tensor([int(prow[(start + i) // ps]) * ps + (start + i) % ps
                           for i in range(c)], dtype=torch.int64, device="cuda")
    ridx = prow.clamp(min=0).to(torch.int64)
    rmask = torch.arange(mp * ps, device="cuda")[None, :] <= \
        start + torch.arange(c, device="cuda")[:, None]

    def paged_chunk_lib(kv):
        kv[0].view(-1, hkv, d)[rows_w] = qformat.quantize(kc, 3, 8)
        kv[1].view(-1, hkv, d)[rows_w] = qformat.quantize(vc, 3, 8)
        kk_, vv_ = (x.index_select(0, ridx).reshape(mp * ps, hkv, d).to(torch.float32)
                    .mul(0.125).repeat_interleave(g, dim=1).permute(1, 0, 2)[None]
                    for x in kv)
        return F.scaled_dot_product_attention(qcs, kk_, vv_, attn_mask=rmask)

    add("qpaged_chunk_attn", arch, g, hq, hkv,
        chunk_ranks(mp * ps, chunk_tiles(c, g)[0], hkv, d), err,
        [lambda kv=kv: kern.qpc(qc, kc, vc, kv[0], kv[1], 3, 3, prow, start)
         for kv in pools],
        [lambda kv=kv: ref.qpaged_chunk_attn_ref(qc, kc, vc, kv[0], kv[1], 3, 3, prow,
                                                 start) for kv in pools[:4]],
        [lambda kv=kv: paged_chunk_lib(kv) for kv in pools[:4]],
        chunk_bounds(2 * start * hkv * d + 2 * c * hkv * d
                     + 4 * (2 * c * hq * d + 2 * c * hkv * d) + 4 * mp, pairs, hq, d))

    # -- the ragged tick: 8 decode rows (the lane slots' inert), 2 lanes ------
    lane_slots = (2, 6)
    slots = list(range(b)) + [lane_slots[0]] * c + [lane_slots[1]] * c
    pos = [n - 1 for n in lens] + list(range(start, start + c)) * 2
    for j in lane_slots:
        pos[j] = -1
    t = len(pos)
    sl, po = (torch.tensor(x, dtype=torch.int32, device="cuda") for x in (slots, pos))
    qt = torch.randn(t, hq, d, generator=gen, device="cuda")
    kn, vn = (1.5 * torch.randn(t, hkv, d, generator=gen, device="cuda") for _ in range(2))
    kk, vk, kp, vp = (x.clone() for x in (*pools[0], *pools[0]))
    got = kern.qr(qt, kn, vn, kk, vk, 3, 3, table, sl, po)
    want = ref.qragged_attn_ref(qt, kn, vn, kp, vp, 3, 3, table, sl, po)
    valid = po >= 0
    err = max_err(got[valid], want[valid])
    check(err <= ATTN_ATOL and torch.equal(kk, kp) and torch.equal(vk, vp)
          and not bool(got[~valid].any()),
          f"qragged_attn {arch}: max err {err} (tol {ATTN_ATOL}), pools or inert rows differ")
    tab = table.cpu().tolist()
    wrote = [(u, tab[a][p // ps] * ps + p % ps) for u, (a, p) in enumerate(zip(slots, pos))
             if p >= 0]
    w_tok = torch.tensor([u for u, _ in wrote], dtype=torch.int64, device="cuda")
    w_row = torch.tensor([r for _, r in wrote], dtype=torch.int64, device="cuda")
    gidx = table[sl.to(torch.int64)].clamp(min=0).to(torch.int64)
    vis = torch.arange(mp * ps, device="cuda")[None, :] <= po[:, None]
    vis[:, 0] |= ~vis.any(dim=1)     # inert rows attend row 0: their output is unused
    qq, gmask = qt[:, :, None, :], vis[:, None, None, :]
    kq, vq = qformat.quantize(kn[w_tok], 3, 8), qformat.quantize(vn[w_tok], 3, 8)

    def ragged_lib(kv):
        kv[0].view(-1, hkv, d)[w_row] = kq
        kv[1].view(-1, hkv, d)[w_row] = vq
        kk_, vv_ = (x[gidx].reshape(t, mp * ps, hkv, d).to(torch.float32).mul(0.125)
                    .repeat_interleave(g, dim=2).permute(0, 2, 1, 3) for x in kv)
        return F.scaled_dot_product_attention(qq, kk_, vv_, attn_mask=gmask)

    add("qragged_attn", arch, g, hq, hkv, split_ranks(mp * ps, t, hkv, d), err,
        [lambda kv=kv: kern.qr(qt, kn, vn, kv[0], kv[1], 3, 3, table, sl, po)
         for kv in pools],
        [lambda kv=kv: ref.qragged_attn_ref(qt, kn, vn, kv[0], kv[1], 3, 3, table, sl, po)
         for kv in pools[:4]],
        [lambda kv=kv: ragged_lib(kv) for kv in pools[:4]],
        ragged_tick_bound(tab, ps, slots, pos, hq, hkv, d))
    del pools


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
# smollm-135m float steps (AdamW, B=8, S=128; restart at half) and int8 QAT
# steps: 30 and 20 until [shard]'s serving part took their place (10 and 10:
# the loss still falls by over 0.5 between the first and last five steps)
LM_STEPS = 10
LM_QAT_STEPS = 10
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
                      lambda st, f=step_fn: f(st, batch)[0], state, card, grad=True)
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


def kv_code_flips(torch, label, engine, prompts):
    """One prefill through the kernels and one through the plain versions:
    the logit gap and how many int8 KV codes of the two caches differ (a
    value at a truncation edge lands on either side as the f32 sums' order
    changes).  Returns the kernels' prefill (logits, cache)."""
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
    return kl, kc


def greedy_check(torch, label, got, want, reqs, engine, vocab, enc_of=None) -> None:
    """Tokens equal to ``want``'s; where a stream diverges, the prompt and
    ``want``'s tokens before the divergence are prefilled (plain lockstep
    path, with the request's encoder output from ``enc_of`` for an EncDec
    model) and the top-2 margin there must be within LOGIT_ATOL."""
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
            logits, _ = engine.prefill(torch.from_numpy(seq).cuda(), engine.new_cache(batch=1),
                                       *(() if enc_of is None else (enc_of[rid],)))
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


def profile_steps(torch, label, step, state, card, steps: int = 1, grad: bool = False):
    """Where a step's time goes: the host-device synchronizations one step
    makes (``torch.cuda.set_sync_debug_mode``), wall time per step without
    the profiler, then device time per step by kernel under
    ``torch.profiler`` and the device's idle share of the unprofiled wall
    time.  ``step(state)`` returns the next state.  Serving steps run under
    ``torch.inference_mode``; a training step (``grad``) runs outside it.
    ``steps`` steps are timed and ``steps`` profiled, 1 by default: the
    trace's events, not the steps, cost most of a profile's time (the
    script must stay well inside its 1200 s; 2 by default until the
    serving part of ``[shard]`` needed the time).
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
    averages = prof.key_averages()      # one pass over the trace's events
    for e in averages:
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
                   for e in averages
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
    hardened_launches = hardened_end_to_end(torch, card, env)
    check_grants("the hardened phase", ran=("wq_matmul",))
    print(f"[time] hardened phase {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    ragged_launches = ragged_end_to_end(torch, card, env)
    check_grants("the ragged phase", ran=("wq_matmul",))
    print(f"[time] ragged phase {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    subint8_launches = subint8_end_to_end(torch, card, env)
    check_grants("the sub-int8 phase", ran=("wq_matmul", "wq4_matmul"))
    print(f"[time] sub-int8 phase {time.perf_counter() - t0:.1f}s", flush=True)
    return {k: sum(part.get(k, 0) for part in (launches, paged_launches, hardened_launches,
                                               ragged_launches, subint8_launches))
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
    # the hardened phase profiles its audited ticks from this state
    env.paged_tick = SimpleNamespace(engine=paged, cache=cache, tok=tok, ctok=ctok, copy=copy)
    return launches, results, shared_reqs


def hardened_end_to_end(torch, card, env):
    """``[hardened]``: hardened serving on the paged main path, with
    ``bench_chaos``'s smoke workload and fault plan (10 requests, prompt 64,
    48 new tokens, 10 slots, chunk 32, page 16, a pool of 21 pages, swap
    preemption, deadline 600, ``max_queue`` 10): at full width,
    ``SHALLOW_LAYERS`` deep (the depth of 30 until the mesh's pool runs of
    ``[shard]`` needed the time), unaudited, audited and audited under the
    plan (launch counts exact and
    equal, audit adding none; the non-faulted streams equal, the NaN victim
    alone ``failed``; syncs and wall time per tick); the same plan on the
    ragged tick with two lanes ``SHALLOW_LAYERS`` deep; ``launch.serve``'s
    five hardening flags; a faulted run at temperature 0.7; an audited
    paged decode and mixed tick profiled on the paged phase's state."""
    import contextlib
    import io
    import warnings

    from repro_torch.bench.serve_bench import chaos_scheduler, chaos_setup, check_chaos_run
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import report
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import make_decode_step, make_mixed_step
    from repro_torch.serve.slot_state import find_paged_kv

    cfg = env.cfg
    wl, reqs, plan = chaos_setup(cfg.vocab, smoke=True)
    max_len = wl["plen"] + wl["max_new"]
    launches = {}
    marks = [("start", time.perf_counter())]

    def engine(model, params, **kw):
        return ServeEngine(model=model, params=params, max_len=max_len,
                           batch_slots=wl["slots"], weight_quant=True, quantized_kv=True,
                           device="cuda", paged_kv=True, page_size=wl["page"],
                           kv_pool_pages=wl["pool_pages"], **kw)

    def counted(label, sched, layers, ragged=False, **run_kw):
        """One run from zeroed counts with its host-device synchronizations
        counted (``set_sync_debug_mode``); the launch counts must be the
        chunked (or ragged) paged path's for a model ``layers`` deep."""
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res, st = sched.run(reqs, seed=0, **run_kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counts = ops.launch_counts()
        syncs = sum("called a synchronizing" in str(w.message) for w in caught)
        ticks, chunks = st.decode_steps, st.prefill_chunks
        zero = {k: 0 for k in counts}
        if ragged:
            want = dict(zero, wq_matmul=7 * layers * (ticks + 1),
                        qragged_attn=layers * (ticks + 1))
        else:
            want = dict(zero, wq_matmul=7 * layers * (ticks + chunks + 3),
                        qpaged_decode_attn=layers * (ticks + 2),
                        qpaged_chunk_attn=layers * (chunks + 1))
        check(counts == want, f"{label} launch counts {counts} != expected {want}")
        check(sorted(res) == sorted(r.rid for r in reqs), f"{label}: lost requests")
        if sched.audit:
            # paged: the flags mid-tick and the table and lens at its end
            check(st.audited_ticks == ticks and st.audit_reads == 2 * ticks,
                  f"{label}: audited {st.audited_ticks} of {ticks} ticks in "
                  f"{st.audit_reads} read-backs")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        report(label, st)
        statuses = {s: sum(r.status == s for r in res.values())
                    for s in sorted({r.status for r in res.values()})}
        print(f"[hardened] {label}: {ticks} ticks, {chunks} chunks; launches {counts} == "
              f"expected; {st.steady_s * 1e3 / ticks:.2f} ms wall per tick; {syncs} host-device "
              f"synchronizations in the run ({syncs / ticks:.3f} per tick), audit read-backs "
              f"{st.audit_reads}; statuses {statuses}; card {card}", flush=True)
        return res, st, counts, syncs

    # -- 1. the chaos lane at full width, SHALLOW_LAYERS deep: unaudited, audited,
    #       faulted ------------------------------------------------------------------
    full = engine(env.shallow.model, env.shallow.params)
    kw = dict(chunk_size=wl["chunk"], prefix_sharing=False, oversubscribe=True,
              preempt_policy="swap", max_queue=wl["max_queue"], reject_policy="reject")
    plain_res, plain_st, plain_counts, plain_syncs = counted(
        "hardened, unaudited", full.scheduler(**kw), SHALLOW_LAYERS)
    ref_res, ref_st, ref_counts, ref_syncs = counted(
        "hardened, audited", chaos_scheduler(full, wl), SHALLOW_LAYERS)
    check(plain_counts == ref_counts, f"audit changed the launches: {plain_counts} -> "
                                      f"{ref_counts}")
    check(all(plain_res[r].tokens == ref_res[r].tokens and plain_res[r].status == "ok"
              for r in plain_res), "the audited run's streams differ from the unaudited run's")
    f_res, f_st, _, f_syncs = counted("hardened, audited, faulted", chaos_scheduler(full, wl),
                                      SHALLOW_LAYERS, fault_plan=plan)
    rec = check_chaos_run("smollm-135m", reqs, ref_res, ref_st, f_res, f_st)
    check(rec["nonfaulted_completion_rate"] == 1.0, f"non-faulted completion {rec}")
    print(f"[hardened] chaos lane ({SHALLOW_LAYERS} layers): {json.dumps(rec)}", flush=True)
    marks.append(("chaos lane", time.perf_counter()))
    ms = {name: st.steady_s * 1e3 / st.decode_steps
          for name, st in (("unaudited", plain_st), ("audited", ref_st), ("faulted", f_st))}
    print(f"[hardened] per tick, unaudited / audited / audited under faults: wall "
          f"{ms['unaudited']:.2f} / {ms['audited']:.2f} / {ms['faulted']:.2f} ms; syncs "
          f"{plain_syncs / plain_st.decode_steps:.3f} / {ref_syncs / ref_st.decode_steps:.3f} / "
          f"{f_syncs / f_st.decode_steps:.3f}; audit read-backs {plain_st.audit_reads} / "
          f"{ref_st.audit_reads} / {f_st.audit_reads} over {plain_st.decode_steps} / "
          f"{ref_st.decode_steps} / {f_st.decode_steps} ticks; card {card}", flush=True)
    del full

    # -- 2. the same plan on the ragged tick, two lanes, SHALLOW_LAYERS deep ---------
    shallow = engine(env.shallow.model, env.shallow.params)
    rkw = dict(ragged=True, prefill_lanes=2)
    r_ref, r_ref_st, _, _ = counted("hardened ragged, audited",
                                    chaos_scheduler(shallow, wl, **rkw), SHALLOW_LAYERS,
                                    ragged=True)
    r_f, r_f_st, _, _ = counted("hardened ragged, audited, faulted",
                                chaos_scheduler(shallow, wl, **rkw), SHALLOW_LAYERS, ragged=True,
                                fault_plan=plan)
    rec = check_chaos_run("ragged", reqs, r_ref, r_ref_st, r_f, r_f_st)
    check(rec["nonfaulted_completion_rate"] == 1.0, f"ragged non-faulted completion {rec}")
    print(f"[hardened] chaos lane, ragged ({SHALLOW_LAYERS} layers, 2 lanes): "
          f"{json.dumps(rec)}", flush=True)
    marks.append(("ragged lane", time.perf_counter()))

    # -- 3. a faulted run at temperature 0.7: no device-side assert ------------------
    warm = engine(env.shallow.model, env.shallow.params, temperature=0.7)
    t_res, t_st, _, _ = counted("hardened, temperature 0.7, faulted",
                                chaos_scheduler(warm, wl), SHALLOW_LAYERS, fault_plan=plan)
    torch.cuda.synchronize()
    failed = [r for r in t_res.values() if r.status == "failed"]
    check(len(failed) == 1 and t_st.nan_evictions == 1, f"temperature 0.7: failed {failed}")
    check(all(r.status == "ok" and len(r.tokens) == wl["max_new"]
              and all(0 <= x < cfg.vocab for x in r.tokens)
              for r in t_res.values() if r is not failed[0]),
          "temperature 0.7: a non-faulted request degraded")
    print(f"[hardened] temperature 0.7 under the plan: rid {failed[0].rid} alone failed "
          f"(after {len(failed[0].tokens)} tokens), no device-side assert", flush=True)
    del shallow, warm
    marks.append(("temperature 0.7", time.perf_counter()))

    # -- 4. launch.serve with the five hardening flags, on the card -------------------
    fault = json.dumps({"alloc_fail": [6, 7], "swap_fail": [6, 7, 9], "admit_stall": [3],
                        "nan": [[12, 1]]})
    argv = ["--arch", "smollm-135m", "--policy", "chunked", "--paged", "--page-size", "16",
            "--chunk-size", "32", "--slots", "4", "--prompt-len", "64", "--requests", "8",
            "--max-new", "32", "--arrival-spacing", "1", "--oversubscribe",
            "--preempt-policy", "swap", "--pool-pages", "14", "--deadline-steps", "400",
            "--max-queue", "4", "--reject-policy", "shed_oldest", "--audit",
            "--fault-plan", fault, "--wq", "--qkv"]
    ops.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_res = serve_main(argv)
    counts = ops.launch_counts()
    print(buf.getvalue(), end="", flush=True)
    line = next((ln for ln in buf.getvalue().splitlines() if ln.startswith("[chunked]")), "")
    for part in ("| completion ", "| audited ", "| faults "):
        check(part in line, f"launch.serve's report line lacks '{part.strip('| ')}': {line}")
    check(sum(r.status == "failed" for r in cli_res.values()) >= 1
          and counts["wq_matmul"] > 0 and counts["qpaged_decode_attn"] > 0
          and counts["qpaged_chunk_attn"] > 0, f"launch.serve: {counts}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    print(f"[hardened] launch.serve {' '.join(argv[:4])} ... with the five flags: statuses "
          f"{sorted(r.status for r in cli_res.values())}; launches {counts}", flush=True)
    marks.append(("launch.serve", time.perf_counter()))

    # -- 5. an audited paged decode and mixed tick, on the paged phase's state
    #    (whose unaudited ticks it profiled in this run) ----------------------------------
    pt = env.paged_tick
    params, slots = pt.engine.params, env.slots
    zero = torch.zeros(slots, dtype=torch.float32, device="cuda")
    decode_h = make_decode_step(env.model, with_health=True)
    mixed_h = make_mixed_step(env.model, with_health=True)

    def snapshot(c):
        kv = find_paged_kv(c)
        return torch.cat([kv["page_table"].reshape(-1), kv["len"]])

    def audited_decode_tick(st):
        # the audited scheduler's tick: the step with its poison, a read-back of
        # the flags, then one of the table and lens at the tick's end
        c, t = st
        nxt, ok, c = decode_h(params, t, c, None, zero)
        ok.to(torch.int32).cpu()
        snapshot(c).cpu()
        return c, nxt

    def audited_mixed_tick(st):
        c, t = st
        nxt, _, dok, fok, c = mixed_h(params, t, c, None, pt.ctok, 3, 96, env.chunk, zero)
        torch.cat([dok.to(torch.int32), fok.to(torch.int32)]).cpu()
        snapshot(c).cpu()
        return c, nxt

    profile_steps(torch, f"audited paged decode tick (B={slots}, ps={pt.engine.page_size})",
                  audited_decode_tick, (pt.copy(pt.cache), pt.tok), card)
    profile_steps(torch, f"audited paged mixed tick (B={slots}, C={env.chunk}, start 96, "
                         f"ps={pt.engine.page_size})", audited_mixed_tick,
                  (pt.copy(pt.cache), pt.tok), card)
    marks.append(("profiles", time.perf_counter()))
    print("[time] hardened phase by part: " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}s" for i, (name, t) in enumerate(marks[1:])), flush=True)
    return launches


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
            nxt, _, _, c = sched._masked_ragged(t, c, None, active, meta)
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

    # 8 of the 16 requests (all 16 until the mesh's pool runs of [shard]
    # needed the time)
    reqs = env.reqs[:SUBINT8_REQUESTS]

    def scheduled(label, eng, want_of, **kw):
        """One counted scheduler run of ``reqs`` (warm-up included)."""
        ops.reset_launch_counts()
        results, stats = eng.scheduler(chunk_size=chunk, **kw).run(reqs, seed=0)
        counts = ops.launch_counts()
        want = dict(zero, **want_of(stats.decode_steps, stats.prefill_chunks))
        check(counts == want, f"{label} launch counts {counts} != expected {want}")
        for k, v in counts.items():
            launches[k] += v
        check_served(label, results, reqs, cfg.vocab)
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
    greedy_check(torch, "int4-block paged", res, chunked, reqs, int4, cfg.vocab)
    del paged
    res = scheduled("int4-block ragged", int4, lambda t, c: {
        "wq4_matmul": per_forward * (t + 1), "qragged_attn": n_layers * (t + 1)},
        ragged=True, prefill_lanes=2)
    greedy_check(torch, "int4-block ragged", res, chunked, reqs, int4, cfg.vocab)

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

    # -- int8 against int4-block in turns: ragged runs of TURN_REQUESTS requests
    #    and one forward at M=72 -----------------------------------------------------
    for fmt, eng in (("int8", env.engine), ("int4-block", int4), ("int4-block", int4),
                     ("int8", env.engine)):
        _, stats = eng.scheduler(chunk_size=chunk, ragged=True, prefill_lanes=2).run(
            env.reqs[:TURN_REQUESTS], seed=0)
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


ARCH_CUTS = (("qwen2.5-14b", 8), ("command-r-plus-104b", 2), ("internvl2-2b", None))
GIB = float(1 << 30)


def lockstep_counts(cfg, n_layers, forwards, decodes):
    """The kernel counts of ``forwards`` lockstep forwards over a dense int8
    cache, ``decodes`` of them decode steps: 7 ``wq_matmul`` a layer, one
    more for an untied head, one ``qdecode_attn`` a layer per decode step."""
    from repro_torch.kernels import ops

    per = 7 * n_layers + (0 if cfg.tie_embeddings else 1)
    return dict({k: 0 for k in ops.launch_counts()}, wq_matmul=per * forwards,
                qdecode_attn=n_layers * decodes)


def copy_cache(c):
    """A copy of a serving cache's K/V and lengths (tensors cloned)."""
    return {"body": [{"kv": {k: v.clone() if hasattr(v, "clone") else v
                             for k, v in n["kv"].items()}} for n in c["body"]]}


def chunk_vs_plain(torch, label, engine, chunk, start, misses, slot=3):
    """One chunked prefill (``chunk`` tokens at ``start`` into ``slot`` of a
    per-slot int8 cache whose first ``start`` rows were written chunk by
    chunk) through the kernels and through the plain versions on copies of
    the same cache: the logits of its last row within LOGIT_ATOL (a miss is
    appended to ``misses``).  Returns the counts of the kernel forward."""
    from repro_torch.kernels import ops
    from repro_torch.nn.attention import KVChunk
    from repro_torch.nn.module import Context

    gen = torch.Generator(device="cuda").manual_seed(4)
    vocab = engine.model.vocab
    toks = torch.randint(0, vocab, (1, start + chunk), generator=gen, device="cuda",
                         dtype=torch.int32)

    def forward(cache, c0):
        return engine.model.apply(engine.params, toks[:, c0:c0 + chunk], Context(),
                                  cache=cache, decode=True, chunk=KVChunk(slot, c0, chunk),
                                  logit_pos=chunk - 1)

    with torch.inference_mode():
        cache = engine.new_cache(per_slot=True)
        for c0 in range(0, start, chunk):
            _, cache = forward(cache, c0)
        copy = copy_cache(cache)
        ops.reset_launch_counts()
        got, _ = forward(cache, start)
        counts = ops.launch_counts()
        ops.FORCE = "plain"
        try:
            want, _ = forward(copy, start)
        finally:
            ops.FORCE = None
    layers = engine.model.stack.n_layers
    want_counts = dict({k: 0 for k in counts}, qchunk_attn=layers,
                       wq_matmul=7 * layers + (0 if engine.model.tie_embeddings else 1))
    check(counts == want_counts, f"{label} chunk launch counts {counts} != {want_counts}")
    check(bool(torch.isfinite(got).all()), f"{label} chunk logits not finite")
    err = (got - want).abs().max().item()
    if err > LOGIT_ATOL:
        misses.append(f"{label} chunk at start {start}: logits max err {err} > {LOGIT_ATOL}")
    print(f"[archs] {label}: a chunked prefill (C={chunk} at start {start}, slot {slot}) "
          f"logits {tuple(got.shape)} max_abs_err vs plain {err:.3e} (tol {LOGIT_ATOL}); "
          f"launches {counts} == expected", flush=True)
    return counts


def decode_vs_plain(torch, label, engine, prompts, misses):
    """The prompts prefilled through the kernels and, apart, through the
    plain versions (``kv_code_flips``: printed, not held; a K/V value at a
    truncation edge lands on either side as the f32 sums' order changes,
    and every later layer carries the flip on).  Then one decode step from
    copies of the kernels' cache, through each: its logits within
    LOGIT_ATOL and the same greedy token wherever the plain top-2 margin
    exceeds it (a miss is appended to ``misses``).  Returns the counts of
    the kernel decode step."""
    from repro_torch.kernels import ops

    kl, kc = kv_code_flips(torch, f"archs: {label}", engine, prompts)
    tok = torch.argmax(kl, dim=-1, keepdim=True).to(torch.int32)
    base = copy_cache(kc)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got, _ = engine.decode(tok, kc)
        counts = ops.launch_counts()
        ops.FORCE = "plain"
        try:
            want, _ = engine.decode(tok, base)
        finally:
            ops.FORCE = None
    check(bool(torch.isfinite(got).all()), f"{label} decode step logits not finite")
    err = (got - want).abs().max().item()
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > LOGIT_ATOL
    same = bool((torch.argmax(got, -1) == torch.argmax(want, -1))[clear].all())
    if err > LOGIT_ATOL or not same:
        misses.append(f"{label} decode step: logits max err {err} (tol {LOGIT_ATOL}), greedy "
                      f"tokens equal on the clear rows: {same}")
    print(f"[archs] {label}: a decode step from the same cache: logits {tuple(got.shape)} "
          f"max_abs_err vs plain {err:.3e} (tol {LOGIT_ATOL}); greedy tokens equal on the "
          f"{int(clear.sum())}/{len(clear)} rows with a clear top-2 margin: {same}; launches "
          f"{counts}", flush=True)
    return counts


def archs_end_to_end(torch, card):
    """``[archs]``: the dense-family variants.  glm4-9b at its published width
    and depth (40 layers, d_model 4096, 32/2 heads of 128, d_ff 13696, vocab
    151552, QKV bias), seeded random weights, int8 weight-only and an int8
    KV cache, served through ``launch.serve.main`` (``--policy chunked
    --paged``, 8 requests, prompt 128, 32 new tokens, 8 slots, chunk 32):
    every request ``ok``, launch counts exact; then, on the same weights, a
    lockstep prefill and decode step and a chunked prefill held to the plain
    versions, and a decode step profiled.  Then qwen2.5-14b (8 of 48 layers,
    untied head), command-r-plus-104b (2 of 64 layers: LayerNorm, the
    parallel block, a tied head over 256000) and internvl2-2b whole (one
    forward over its 256-position stub prefix, then text only), each at
    full width: a prefill and decode step and a chunked prefill held to
    the plain versions, a few decode steps counted.  Each model is freed
    before the next; peak memory is printed per model and must fit the
    card.  Returns the launches of the counted runs."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.registry import get_config
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import make_prefill_step
    from repro_torch.serve.scheduler import Scheduler

    phase_t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    launches, misses = {}, []       # misses: comparisons past LOGIT_ATOL, failed at the end

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def fresh():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak(label, cfg):
        got = torch.cuda.max_memory_allocated()
        check(got < total, f"{label}: peak memory {got / GIB:.2f} GiB past the card's")
        head = 4 * cfg.vocab_padded * cfg.d_model
        print(f"[archs] {label}: peak memory {got / GIB:.2f} GiB of the card's "
              f"{total / GIB:.2f} (torch.cuda.max_memory_allocated); "
              + (f"the tied head's dequantized f32 table, a transient of every forward, "
                 f"{head / GIB:.2f} GiB ({cfg.vocab_padded} x {cfg.d_model})"
                 if cfg.tie_embeddings else "untied head through wq_matmul, no f32 table")
              + f" | card {card}", flush=True)

    # -- 1. glm4-9b at full width and depth through launch.serve ------------------
    fresh()
    cfg = get_config("glm4-9b")
    n_layers, slots, plen, new, chunk = cfg.n_layers, 8, 128, 32, 32
    print(f"[archs] glm4-9b: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, qkv_bias {cfg.qkv_bias}: {cfg.param_count() / 1e9:.2f} B parameters, "
          f"{4 * cfg.param_count() / 1e9:.1f} GB as float32; nothing cut", flush=True)
    argv = ["--arch", "glm4-9b", "--policy", "chunked", "--paged", "--requests", "8",
            "--slots", str(slots), "--prompt-len", str(plen), "--max-new", str(new),
            "--chunk-size", str(chunk), "--arrival-spacing", "2", "--wq", "--qkv"]
    stats = []
    run = Scheduler.run

    def counted_run(self, *a, **k):
        out = run(self, *a, **k)
        stats.append(out[1])
        return out

    Scheduler.run = counted_run
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        results = launch_serve.main(argv)
    finally:
        Scheduler.run = run
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = stats[0]
    ticks, chunks = st.decode_steps, st.prefill_chunks
    # warm-up: one mixed step (decode half + chunk half) and one decode step
    want = dict({k: 0 for k in counts}, wq_matmul=7 * n_layers * (ticks + chunks + 3),
                qpaged_decode_attn=n_layers * (ticks + 2),
                qpaged_chunk_attn=n_layers * (chunks + 1))
    check(counts == want, f"glm4-9b launch.serve launch counts {counts} != expected {want}")
    check(chunks == 8 * -(-plen // chunk), f"glm4-9b: {chunks} chunks")
    check(sorted(results) == list(range(8)), f"glm4-9b: results for {sorted(results)}")
    for rid, r in results.items():
        check(r.status == "ok" and len(r.tokens) == new
              and all(0 <= t < cfg.vocab for t in r.tokens),
              f"glm4-9b: request {rid} ended {r.status} with {len(r.tokens)} tokens")
    add(counts)
    summ = st.summary()
    print(f"[archs] glm4-9b launch.serve {' '.join(argv[2:])}: 8 requests ok, {ticks} ticks, "
          f"{chunks} chunks; launches {counts} == expected; steady {summ['steady_tok_s']:.1f} "
          f"tok/s ({st.steady_s * 1e3 / ticks:.2f} ms a tick); ttft p50/p99 "
          f"{summ['p50_ttft_steps']:.0f}/{summ['p99_ttft_steps']:.0f} ticks; main() "
          f"{serve_s:.1f}s with init and int8 integerize | card {card}", flush=True)
    peak("glm4-9b launch.serve", cfg)
    del results, stats

    # the same seeded weights on a lockstep engine: kernels against plain
    fresh()
    t0 = time.perf_counter()
    model = cfg.build()
    engine = ServeEngine(model=model, params=model.init(
        torch.Generator(device="cuda").manual_seed(0), "cuda"), max_len=plen + new,
        batch_slots=slots, weight_quant=True, quantized_kv=True, device="cuda",
        own_params=True)
    torch.cuda.synchronize()
    print(f"[archs] glm4-9b: init + int8 integerize leaf by leaf {time.perf_counter() - t0:.2f}s,"
          f" peak {torch.cuda.max_memory_allocated() / GIB:.2f} GiB", flush=True)
    prompts = torch.randint(0, cfg.vocab, (slots, plen), device="cuda", dtype=torch.int32,
                            generator=torch.Generator(device="cuda").manual_seed(1))
    counts = decode_vs_plain(torch, "glm4-9b", engine, prompts, misses)
    check(counts == lockstep_counts(cfg, n_layers, 1, 1), f"glm4-9b decode step: {counts}")
    add(counts)
    ops.reset_launch_counts()
    out = engine.generate(prompts, 4)
    counts = ops.launch_counts()
    check(counts == lockstep_counts(cfg, n_layers, 4, 3), f"glm4-9b generate: {counts}")
    check(tuple(out.shape) == (slots, 4), f"glm4-9b generate shape {tuple(out.shape)}")
    add(counts)
    add(chunk_vs_plain(torch, "glm4-9b", engine, chunk, 96, misses))

    def decode_step(state):
        cache, tok = state
        logits, cache = engine.decode(tok, cache)
        return cache, torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)

    with torch.inference_mode():
        logits, cache = engine.prefill(prompts, engine.new_cache())
    profile_steps(torch, f"glm4-9b decode step (B={slots}, 40 layers)", decode_step,
                  (cache, torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)), card)
    peak("glm4-9b lockstep", cfg)
    del engine, model, cache, logits, prompts

    # -- 2. the other three at full width, depth cut ------------------------------
    for arch, cut in ARCH_CUTS:
        fresh()
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = full if cut is None else dataclasses.replace(full, n_layers=cut)
        model = cfg.build()
        max_len = cfg.vis_seq + 64 + 8
        engine = ServeEngine(model=model, params=model.init(
            torch.Generator(device="cuda").manual_seed(0), "cuda"), max_len=max_len,
            batch_slots=slots, weight_quant=True, quantized_kv=True, device="cuda",
            own_params=True)
        torch.cuda.synchronize()
        cut_note = ("nothing cut" if cut is None else
                    f"cut to {cut} of {full.n_layers} layers (the width is the published one)")
        print(f"[archs] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
              f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab}, norm {cfg.norm}, parallel {cfg.parallel_block}, tied "
              f"{cfg.tie_embeddings}, vis_seq {cfg.vis_seq}; {cut_note}: "
              f"{cfg.param_count() / 1e9:.2f} B parameters, {4 * cfg.param_count() / 1e9:.1f} "
              f"GB as float32; init + int8 integerize {time.perf_counter() - t0:.2f}s",
              flush=True)
        prompts = torch.randint(0, cfg.vocab, (slots, 32), device="cuda", dtype=torch.int32,
                                generator=torch.Generator(device="cuda").manual_seed(1))
        if cfg.vis_seq:
            # one forward over the stub vision prefix and the prompt, kernels vs plain
            # one forward over the stub vision prefix and the prompt through the
            # serving prefill step: into the int8 cache (counted), and into a
            # float cache through the kernels and the plain versions (held;
            # only the GEMMs' sums differ there)
            emb = torch.randn(slots, cfg.vis_seq, cfg.d_model, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(3))
            prefill = make_prefill_step(model)

            def prefixed(cache):
                with torch.inference_mode():
                    return prefill(engine.params, prompts, cache, embeds=emb)

            ops.reset_launch_counts()
            got, cache = prefixed(engine.new_cache())
            counts = ops.launch_counts()
            check(counts == lockstep_counts(cfg, cfg.n_layers, 1, 0),
                  f"{arch} prefixed forward: {counts}")
            lens = {int(x) for x in torch.as_tensor(cache["body"][0]["kv"]["len"])
                    .reshape(-1).tolist()}
            check(lens == {cfg.vis_seq + 32} and bool(torch.isfinite(got).all()),
                  f"{arch}: cache len {lens} after the prefix, or logits not finite")
            add(counts)
            del cache

            def float_cache():
                return model.init_cache(slots, max_len, quantized_kv=False, device="cuda")

            got, _ = prefixed(float_cache())
            ops.FORCE = "plain"
            try:
                want, _ = prefixed(float_cache())
            finally:
                ops.FORCE = None
            err = (got - want).abs().max().item()
            if err > LOGIT_ATOL:
                misses.append(f"{arch} prefixed forward: max err {err} > {LOGIT_ATOL}")
            print(f"[archs] {arch}: one forward over the {cfg.vis_seq}-position stub prefix "
                  f"and a 32-token prompt: int8 cache len {cfg.vis_seq + 32}, launches "
                  f"{counts}; over a float cache, last logits {tuple(got.shape)} max_abs_err "
                  f"vs plain {err:.3e} (tol {LOGIT_ATOL}); serving below is text only",
                  flush=True)
            del emb, got, want
        counts = decode_vs_plain(torch, arch, engine, prompts, misses)
        check(counts == lockstep_counts(cfg, cfg.n_layers, 1, 1), f"{arch} decode: {counts}")
        add(counts)
        ops.reset_launch_counts()
        out = engine.generate(prompts, 4)
        counts = ops.launch_counts()
        check(counts == lockstep_counts(cfg, cfg.n_layers, 4, 3), f"{arch} generate: {counts}")
        check(bool(((out >= 0) & (out < cfg.vocab)).all()), f"{arch}: ids outside the vocab")
        add(counts)
        print(f"[archs] {arch}: generate {slots} x 4 tokens (prefill + 3 decode steps); "
              f"launches {counts} == expected", flush=True)
        add(chunk_vs_plain(torch, arch, engine, 32, 32, misses))
        peak(arch, cfg)
        del engine, model, prompts, out
    fresh()
    print(f"[time] archs phase {time.perf_counter() - phase_t0:.1f}s", flush=True)
    check(not misses, "archs: " + "; ".join(misses))
    return launches


# The recurrent archs' projections through wq_matmul, (label, K, N, calls a layer):
# mamba-130m's in/x/out_proj and gated FFN, rwkv6-7b's five time-mix and
# three channel-mix projections (dt_proj, 48 -> 1536, stays float).
REC_GEMMS = (("mamba in_proj", 768, 3072, 1), ("mamba x_proj", 1536, 80, 1),
             ("mamba out_proj", 1536, 768, 1), ("mamba gate/in", 768, 2048, 2),
             ("mamba ffn out", 2048, 768, 1),
             ("rwkv wr/wk/wv/wg/wo, cm wr", 4096, 4096, 6), ("rwkv cm wk", 4096, 14336, 1),
             ("rwkv cm wv", 14336, 4096, 1))
REC_LAYER_GEMMS = {"mamba-130m": 6, "rwkv6-7b": 8}   # wq_matmul launches a layer


def check_recurrent_kernels(torch, ref, wq_cuda, gen):
    """``wq_matmul`` at the recurrent archs' (K, N), M = 8 (a decode step of
    8 slots) and 32 (a chunk), against its plain version and timed beside
    it and ``torch.matmul`` on the dequantized weight; one layer's calls
    summed per arch.  Returns the rows and the worst error."""
    rows = [wq_case(torch, ref, wq_cuda, gen, m, label, k, n, per)
            for label, k, n, per in REC_GEMMS for m in (8, 32)]
    for short, arch in (("mamba", "mamba-130m"), ("rwkv", "rwkv6-7b")):
        for m in (8, 32):
            layer = layer_sum([r for r in rows if r["m"] == m and r["shape"].startswith(short)])
            rows.append(dict(layer, m=m, shape=f"{arch} layer", err=0.0, k=0, n=0, per_layer=0))
            print(f"[kernel] wq_matmul one {arch} layer ({REC_LAYER_GEMMS[arch]} "
                  f"calls, M={m}): kernel {layer['ms'] * 1e3:.2f} us | plain "
                  f"{layer['plain_ms'] * 1e3:.2f} us | library {layer['library_ms'] * 1e3:.2f} us "
                  f"| bound {layer['bound_ms'] * 1e3:.2f} us ({layer['bound_by']})", flush=True)
    return rows, max(r["err"] for r in rows)


def device_kernels(torch, fn) -> int:
    """Device kernels ``fn()`` launches, counted by ``torch.profiler`` (0 when
    the profiler records no device events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA))


def recurrent_arch(torch, card, arch, launches, misses, policies):
    """One recurrent arch at its published width and depth, int8 weights:
    ``launch.serve.main`` under each of ``policies`` (8 requests of 128 + 32
    tokens, 8 slots, chunk 32) with exact ``wq_matmul`` counts and every
    request ``ok``; then on a lockstep engine of the same seeded weights a
    decode step's and a chunk's logits held to the plain versions on one
    shared state, a mixed tick leaving its inactive slots' recurrent rows
    bit for bit, an audited run clean, the decode step and the mixed tick
    profiled, and the scans' per-token launches counted.  Returns the
    engine's state bytes per slot."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.registry import get_config
    from repro_torch.nn.attention import KVChunk, host_tensor
    from repro_torch.nn.module import Context
    from repro_torch.serve import Request, ServeEngine, state_bytes_per_slot
    from repro_torch.serve.scheduler import Scheduler

    cfg = get_config(arch)
    per_fwd = REC_LAYER_GEMMS[arch] * cfg.n_layers
    slots, plen, new, chunk = 8, 128, 32, 32
    total = torch.cuda.get_device_properties(0).total_memory
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def fresh():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak(label):
        got = torch.cuda.max_memory_allocated()
        check(got < total, f"{label}: peak memory {got / GIB:.2f} GiB past the card's")
        print(f"[recurrent] {label}: peak memory {got / GIB:.2f} GiB of {total / GIB:.2f} "
              f"(torch.cuda.max_memory_allocated) | card {card}", flush=True)

    print(f"[recurrent] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, layout "
          f"{cfg.layout!r}, ffn {cfg.ffn_kind}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
          f"{cfg.param_count() / 1e9:.3f} B parameters, {4 * cfg.param_count() / 1e9:.1f} GB "
          f"as float32; nothing cut; {per_fwd} wq_matmul a forward", flush=True)
    for policy in policies:
        fresh()
        argv = ["--arch", arch, "--policy", policy, "--requests", "8", "--slots",
                str(slots), "--prompt-len", str(plen), "--max-new", str(new), "--chunk-size",
                str(chunk), "--arrival-spacing", "2", "--wq"]
        stats = []
        run = Scheduler.run

        def counted_run(self, *a, **k):
            out = run(self, *a, **k)
            stats.append(out[1])
            return out

        Scheduler.run = counted_run
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            results = launch_serve.main(argv)
        finally:
            Scheduler.run = run
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        st = stats[0]
        ticks, chunks = st.decode_steps, st.prefill_chunks
        if policy == "chunked":
            # warm-up: one mixed step (two forwards) and one decode step
            forwards = ticks + chunks + 3
            check(chunks == 8 * -(-plen // chunk), f"{arch}: {chunks} chunks")
        else:
            # one-shot: a prefill per admission, one decode a tick; warm-up: one
            # prefill (one prompt length) and one decode step
            forwards = ticks + 8 + 2
        want = dict({k: 0 for k in counts}, wq_matmul=per_fwd * forwards)
        check(counts == want, f"{arch} launch.serve --policy {policy}: launch counts {counts} "
                              f"!= expected {want}")
        check(sorted(results) == list(range(8)), f"{arch}: results for {sorted(results)}")
        for rid, r in results.items():
            check(r.status == "ok" and len(r.tokens) == new
                  and all(0 <= t < cfg.vocab for t in r.tokens),
                  f"{arch}: request {rid} ended {r.status} with {len(r.tokens)} tokens")
        check(st.state_kinds == "recurrent", f"{arch}: state kinds {st.state_kinds!r}")
        add(counts)
        summ = st.summary()
        print(f"[recurrent] {arch} launch.serve {' '.join(argv[2:])}: 8 requests ok, {ticks} "
              f"ticks, {chunks} chunks; launches {counts} == expected; steady "
              f"{summ['steady_tok_s']:.1f} tok/s ({st.steady_s * 1e3 / ticks:.2f} ms a tick); "
              f"ttft p50/p99 {summ['p50_ttft_steps']:.0f}/{summ['p99_ttft_steps']:.0f} ticks; "
              f"cache {st.peak_cache_bytes} B; main() {serve_s:.1f}s with init and int8 "
              f"integerize | card {card}", flush=True)
        peak(f"{arch} launch.serve --policy {policy}")
        del results, stats
        part(f"launch.serve {policy}")

    # -- the same seeded weights on a lockstep engine -----------------------------
    fresh()
    model = cfg.build()
    engine = ServeEngine(model=model, params=model.init(
        torch.Generator(device="cuda").manual_seed(0), "cuda"), max_len=plen + new,
        batch_slots=slots, weight_quant=True, device="cuda", own_params=True)
    prompts = torch.randint(0, cfg.vocab, (slots, plen), device="cuda", dtype=torch.int32,
                            generator=torch.Generator(device="cuda").manual_seed(1))
    bytes_per_slot = state_bytes_per_slot(engine.new_cache(per_slot=True), slots)
    with torch.inference_mode():
        ops.reset_launch_counts()
        logits, shared = engine.prefill(prompts, engine.new_cache(per_slot=True))
        counts = ops.launch_counts()
    check(counts["wq_matmul"] == per_fwd, f"{arch} prefill: {counts}")
    add(counts)
    part("lockstep init and prefill")
    tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    ctok = torch.randint(0, cfg.vocab, (1, chunk), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(2))

    def held(label, fn):
        """``fn(cache)`` (logits, cache) through the kernels and the plain
        versions from the one shared state: logits within LOGIT_ATOL, the same
        greedy token where the plain top-2 margin is clear."""
        with torch.inference_mode():
            ops.reset_launch_counts()
            got, _ = fn(shared)
            counts = ops.launch_counts()
            ops.FORCE = "plain"
            try:
                want, _ = fn(shared)
            finally:
                ops.FORCE = None
        check(bool(torch.isfinite(got).all()), f"{arch} {label}: logits not finite")
        check(counts == dict({k: 0 for k in counts}, wq_matmul=per_fwd),
              f"{arch} {label}: launch counts {counts}")
        err = (got - want).abs().max().item()
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > LOGIT_ATOL
        same = bool((torch.argmax(got, -1) == torch.argmax(want, -1))[clear].all())
        if err > LOGIT_ATOL or not same:
            misses.append(f"{arch} {label}: logits max err {err} (tol {LOGIT_ATOL}), greedy "
                          f"equal on the clear rows: {same}")
        print(f"[recurrent] {arch} {label} from one shared state: logits {tuple(got.shape)} "
              f"max_abs_err vs plain {err:.3e} (tol {LOGIT_ATOL}); greedy equal on "
              f"{int(clear.sum())}/{clear.numel()} clear rows: {same}; launches {counts}",
              flush=True)
        add(counts)

    held("decode step (B=8)", lambda c: engine.decode(tok, c))
    held(f"chunk (C={chunk} into slot 3)", lambda c: model.apply(
        engine.params, ctok, Context(), cache=c, decode=True,
        chunk=KVChunk(slot=3, start=0, length=chunk), logit_pos=chunk - 1))

    # -- a mixed tick: inactive rows bit for bit ------------------------------------
    sched = engine.scheduler(chunk_size=chunk)
    active = np.array([1, 1, 0, 1, 0, 1, 1, 0], dtype=np.bool_)
    lane = 4
    with torch.inference_mode():
        ops.reset_launch_counts()
        _, _, _, after = sched._masked_mixed(tok, shared, None, host_tensor(active, "cuda"),
                                             ctok, lane, 0, chunk)
        counts = ops.launch_counts()
    check(counts["wq_matmul"] == 2 * per_fwd, f"{arch} mixed tick: {counts}")
    add(counts)
    kept = moved = 0
    for pos, node in enumerate(shared["body"]):
        for key in node:
            for leaf, old in ((after["body"][pos][key][k], node[key][k]) for k in node[key]):
                for j in range(slots):
                    a, b = leaf[:, j], old[:, j]
                    if not active[j] and j != lane:
                        check(torch.equal(a, b), f"{arch} mixed tick: inactive slot {j}'s "
                                                 f"{key} row changed")
                        kept += 1
                    elif not torch.equal(a, b):
                        moved += 1
    check(moved > 0, f"{arch} mixed tick: no live row moved")
    print(f"[recurrent] {arch} mixed tick (active {active.astype(int).tolist()}, chunk into slot "
          f"{lane}): {kept} inactive (slot, leaf) rows bit-identical, {moved} live rows "
          f"advanced", flush=True)

    part("kernels vs plain, mixed tick")

    # -- an audited run, clean -------------------------------------------------------
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=64, dtype=np.int32),
                    max_new=16, arrival=2 * i) for i in range(6)]
    ops.reset_launch_counts()
    res, st = engine.scheduler(chunk_size=chunk, audit=True).run(reqs)
    counts = ops.launch_counts()
    check(all(res[r.rid].status == "ok" for r in reqs), f"{arch} audited run: "
          f"{[res[r.rid].status for r in reqs]}")
    check(st.audited_ticks == st.decode_steps and st.audit_reads == st.decode_steps,
          f"{arch} audited run: {st.audited_ticks} audited / {st.audit_reads} reads of "
          f"{st.decode_steps} ticks")
    check(counts == dict({k: 0 for k in counts},
                         wq_matmul=per_fwd * (st.decode_steps + st.prefill_chunks + 3)),
          f"{arch} audited run: launch counts {counts}")
    add(counts)
    print(f"[recurrent] {arch} audited run (6 requests of 64 + 16, chunk {chunk}): every tick "
          f"audited clean ({st.audited_ticks}), one read-back a tick ({st.audit_reads}); "
          f"launches {counts} == expected", flush=True)

    part("audited run")

    # -- profiles, and the scans' per-token launches -------------------------------
    def decode_step(state):
        cache, t = state
        lg, cache = engine.decode(t, cache)
        return cache, torch.argmax(lg, dim=-1, keepdim=True).to(torch.int32)

    act = host_tensor(np.arange(slots) != lane, "cuda")

    def mixed_tick(state):
        cache, t = state
        t, _, _, cache = sched._masked_mixed(t, cache, None, act, ctok, lane, 0, chunk)
        return cache, t

    for label, step in (("decode step", decode_step), ("mixed tick", mixed_tick)):
        prof = profile_steps(torch, f"{arch} {label} (B={slots}" +
                             (f", C={chunk})" if label == "mixed tick" else ")"), step,
                             (shared, tok), card)
        if prof is not None:
            wq = sum(r[0] for r in prof["rows"] if "wq_matmul_kernel" in r[2]) / 1e3
            print(f"[recurrent] {arch} {label}: wq_matmul {wq:.3f} ms of {prof['busy_ms']:.3f} "
                  f"ms device busy ({wq / prof['busy_ms']:.3f})", flush=True)

    def chunk_forward(c_len):
        toks = ctok[:, :c_len]
        return lambda: model.apply(engine.params, toks, Context(), cache=shared, decode=True,
                                   chunk=KVChunk(slot=lane, start=0, length=c_len),
                                   logit_pos=c_len - 1)

    # the per-token loops make a chunk forward's kernel count linear in C: two
    # short chunks give its slope, and the C=32 count follows from it
    with torch.inference_mode():
        k2 = device_kernels(torch, chunk_forward(2))
        k1 = device_kernels(torch, chunk_forward(1))
    if k2 and k1:
        per_tok = k2 - k1
        k_chunk = k1 + per_tok * (chunk - 1)
        print(f"[recurrent] {arch} chunk forward: {k2} kernels at C=2, {k1} at C=1: the scans' "
              f"per-token loops add {per_tok} kernels a token, {per_tok * chunk} of the "
              f"{k_chunk} of a {chunk}-token chunk", flush=True)
    peak(f"{arch} lockstep checks")
    part("profiles")
    print(f"[recurrent] {arch}: state bytes per slot {bytes_per_slot} (constant in max_len)",
          flush=True)
    print(f"[time] {arch} by part: " + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items()),
          flush=True)
    del engine, model, shared, sched, logits
    fresh()
    return bytes_per_slot


def recurrent_end_to_end(torch, card):
    """``[recurrent]``: rwkv6-7b (32 layers, d_model 4096, 64 heads of 64,
    d_ff 14336, vocab 65536: 7.25 B parameters) and mamba-130m (24 layers,
    d_model 768, d_inner 1536, d_state 16, d_conv 4, dt_rank 48, vocab
    50280) whole, seeded random weights, int8 weight-only, served through
    ``launch.serve.main`` (``--policy chunked``; mamba also ``scheduler``,
    the one-shot admission) and held as ``recurrent_arch`` says.  Returns
    the launches of the counted runs."""
    phase_t0 = time.perf_counter()
    launches, misses = {}, []
    recurrent_arch(torch, card, "rwkv6-7b", launches, misses, ("chunked",))
    recurrent_arch(torch, card, "mamba-130m", launches, misses, ("chunked", "scheduler"))
    print(f"[time] recurrent phase {time.perf_counter() - phase_t0:.1f}s", flush=True)
    check(not misses, "recurrent: " + "; ".join(misses))
    return launches


ENCDEC_SLOTS, ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_CHUNK = 8, 32, 64, 32
# whisper-tiny's kernel cells: the served cache (prompt 32 + 64 new, the chunk
# at start 0) and a long one (the chunk at start 1984); 8 live lengths each
ENCDEC_CELLS = ((96, 0, [96, 1, 33, 95, 64, 17, 40, 90]),
                (2048, 1984, [2048, 1, 1000, 2047, 17, 640, 1500, 129]))
CROSS_ATOL = 1e-4          # cached vs re-projected cross-attention: f32 sums in another order


def check_encdec_kernels(torch, F, ref, kern, gen, page_size):
    """The five attention kernels at whisper-tiny's shapes: G = 1 (6 query
    heads over 6 KV heads of 64), B = 8, over ``ENCDEC_CELLS`` (S = 96 and
    2048; paged at ``page_size``), through ``attention_cells``.  Returns the
    rows by kernel and the worst error."""
    out = {name: [] for name in ATTN_KERNELS}
    for s, start, lens in ENCDEC_CELLS:
        attention_cells(torch, F, ref, kern, gen, out, "whisper-tiny", 6, 6, 64, s=s,
                        start=start, lens=lens, ps=page_size)
    return out, max(r["err"] for rows in out.values() for r in rows)


def encdec_end_to_end(torch, card):
    """``[encdec]``: whisper-tiny whole (4 encoder + 4 decoder layers, d_model
    384, 6 heads of 64 over 6 KV heads, d_ff 1536, vocab 51865, 1500 encoder
    frames, 32768 learned decoder positions), seeded random float32 weights,
    int8 KV.  8 requests of 32 + 64 tokens (arrivals 2 ticks apart, 8 slots,
    chunk 32), each with the encoder output of 1500 seeded stub frames,
    served through the ``Scheduler``: chunked (dense and paged), ragged
    with 2 lanes (dense and paged), audited, and without the cross-attention
    cache; then, one encoder shape per run as in the reference, 2 requests
    at 1000 frames and 2 at 500.  Every run's attention-kernel counts are
    exact from its schedule, no ``wq_matmul``, every request ``ok``, each
    stream the chunked run's (or diverging only at a top-2 margin within
    LOGIT_ATOL).  On one shared state a decode step's and a chunk's logits
    are held to the plain versions, and cached cross-attention to the
    re-projected one over slots rewritten with shorter encoder outputs;
    the cross bytes per slot, peak memory and the profiles of a decode step
    and a mixed tick are printed.  Returns the launches of the counted
    runs."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_config
    from repro_torch.nn.attention import KVChunk, host_tensor
    from repro_torch.nn.module import Context, param_count
    from repro_torch.serve import Request, ServeEngine, state_bytes_per_slot

    phase_t0 = time.perf_counter()
    cfg = get_config("whisper-tiny")
    slots, plen, new, chunk = ENCDEC_SLOTS, ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_CHUNK
    shorter = (2 * cfg.enc_seq // 3, cfg.enc_seq // 3)        # 1000 and 500 frames
    n_layers = cfg.n_layers
    launches, misses = {}, []
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = cfg.build()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    print(f"[encdec] whisper-tiny: {cfg.enc_layers} encoder + {n_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim} (G = 1), d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.enc_seq} encoder "
          f"frames, {model.max_target_len} learned decoder positions: "
          f"{param_count(params) / 1e6:.2f} M parameters in the tree "
          f"({cfg.param_count() / 1e6:.2f} M by the reference's formula); float32 weights, "
          f"int8 KV; nothing cut", flush=True)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    fgen = torch.Generator(device="cuda").manual_seed(7)

    def encoded(n, frames):
        """Encoder outputs (n, frames, D) of seeded stub frame embeddings."""
        with torch.inference_mode():
            emb = torch.randn((n, frames, cfg.d_model), generator=fgen, device="cuda")
            return model.encode(params, emb, Context())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = encoded(slots, cfg.enc_seq)
    torch.cuda.synchronize()
    check(enc.shape == (slots, cfg.enc_seq, cfg.d_model) and bool(torch.isfinite(enc).all()),
          f"encdec: encoder output {tuple(enc.shape)} not finite or misshapen")
    print(f"[encdec] model.encode of {slots} x {cfg.enc_seq} stub frames: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call) | card {card}", flush=True)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab, size=(slots, plen), dtype=np.int32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=new, arrival=2 * i, enc=enc[i:i + 1])
            for i in range(slots)]
    enc_of = {r.rid: r.enc for r in reqs}

    def engine(**kw):
        return ServeEngine(model=model, params=params, max_len=plen + new, batch_slots=slots,
                           quantized_kv=True, device="cuda", **kw)

    dense, paged, uncached = engine(), engine(paged_kv=True), engine(cross_attn_cache=False)
    chunked = lambda t, c: {"qdecode_attn": n_layers * (t + 2),
                            "qchunk_attn": n_layers * (c + 1)}
    paged_chunked = lambda t, c: {"qpaged_decode_attn": n_layers * (t + 2),
                                  "qpaged_chunk_attn": n_layers * (c + 1)}
    ragged = lambda t, c: {"qragged_attn": n_layers * (t + 1)}

    def counted(label, eng, want_of, run_reqs=reqs, **kw):
        """One counted run: exact launch counts, every request ``ok``."""
        sched = eng.scheduler(chunk_size=chunk, **kw)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res, st = sched.run(run_reqs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = dict({k: 0 for k in counts}, **want_of(st.decode_steps, st.prefill_chunks))
        check(counts == want, f"encdec {label}: launch counts {counts} != expected {want}")
        check(st.prefill_chunks == len(run_reqs) * -(-plen // chunk),
              f"encdec {label}: {st.prefill_chunks} chunks")
        check_served(f"encdec {label}", res, run_reqs, cfg.vocab)
        kinds = "kv+cross" if eng.cross_attn_cache else "kv"
        check(st.state_kinds == kinds, f"encdec {label}: state kinds {st.state_kinds!r}")
        add(counts)
        summ = st.summary()
        print(f"[encdec] {label}: {len(run_reqs)} requests ok, {st.decode_steps} ticks, "
              f"{st.prefill_chunks} chunks; launches {counts} == expected; steady "
              f"{summ['steady_tok_s']:.1f} tok/s ({st.steady_s * 1e3 / st.decode_steps:.2f} ms "
              f"a tick); ttft p50/p99 {summ['p50_ttft_steps']:.0f}/{summ['p99_ttft_steps']:.0f} "
              f"ticks; state {st.state_kinds}; cache {st.peak_cache_bytes} B; run() "
              f"{secs:.2f}s with warm-up | card {card}", flush=True)
        return res, st

    base, _ = counted("chunked (dense)", dense, chunked)
    for label, eng, want_of, kw in (
            ("chunked (paged, ps 16)", paged, paged_chunked, {}),
            ("ragged (2 lanes, dense)", dense, ragged, {"ragged": True, "prefill_lanes": 2}),
            ("ragged (2 lanes, paged)", paged, ragged, {"ragged": True, "prefill_lanes": 2}),
            ("chunked without the cross-attention cache", uncached, chunked, {})):
        res, _ = counted(label, eng, want_of, **kw)
        greedy_check(torch, f"encdec {label} vs chunked (dense)", res, base, reqs, dense,
                     cfg.vocab, enc_of)
    res, st = counted("chunked, audited", dense, chunked, audit=True)
    check(st.audited_ticks == st.decode_steps and st.audit_reads == st.decode_steps,
          f"encdec audited run: {st.audited_ticks} audited / {st.audit_reads} reads of "
          f"{st.decode_steps} ticks")
    greedy_check(torch, "encdec audited vs chunked (dense)", res, base, reqs, dense, cfg.vocab,
                 enc_of)
    print(f"[encdec] audited run: every tick audited clean ({st.audited_ticks}), one "
          f"read-back a tick ({st.audit_reads}): the cross lengths ride the health flags' copy",
          flush=True)
    for frames in shorter:
        short = encoded(2, frames)
        run_reqs = [Request(rid=100 + i, prompt=prompts[i], max_new=new, arrival=2 * i,
                            enc=short[i:i + 1]) for i in range(2)]
        res, _ = counted(f"chunked at {frames} encoder frames", dense, chunked, run_reqs)
        want, _ = uncached.scheduler(chunk_size=chunk).run(run_reqs, warmup=False)
        greedy_check(torch, f"encdec {frames} frames: cached vs re-projected", res, want,
                     run_reqs, dense, cfg.vocab, {r.rid: r.enc for r in run_reqs})
    t_runs = time.perf_counter()

    # -- one shared state: 8 slots, each with its cross rows and a 32-token prompt ---
    def clone(c):
        return {"body": [dict(n, kv={k: v.clone() if hasattr(v, "clone") else v
                                     for k, v in n["kv"].items()}) for n in c["body"]]}

    with torch.inference_mode():
        shared = dense.new_cache(per_slot=True)
        ops.reset_launch_counts()
        for j in range(slots):
            shared = model.write_cross_kv(params, shared, enc[j:j + 1], j, Context())
            _, shared = model.apply(params, torch.from_numpy(prompts[j:j + 1]).cuda(), Context(),
                                    cache=shared, decode=True, chunk=KVChunk(j, 0, plen),
                                    logit_pos=plen - 1, enc=enc[j:j + 1])
        counts = ops.launch_counts()
    check(counts == dict({k: 0 for k in counts}, qchunk_attn=n_layers * slots),
          f"encdec shared state: launch counts {counts}")
    add(counts)
    tok = torch.randint(0, cfg.vocab, (slots, 1), device="cuda", dtype=torch.int32,
                        generator=torch.Generator(device="cuda").manual_seed(1))
    ctok = torch.randint(0, cfg.vocab, (1, chunk), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(2))

    def held(label, fn, want_counts):
        with torch.inference_mode():
            ops.reset_launch_counts()
            got, _ = fn(clone(shared))
            counts = ops.launch_counts()
            ops.FORCE = "plain"
            try:
                want, _ = fn(clone(shared))
            finally:
                ops.FORCE = None
        check(bool(torch.isfinite(got).all()), f"encdec {label}: logits not finite")
        check(counts == dict({k: 0 for k in counts}, **want_counts),
              f"encdec {label}: launch counts {counts}")
        err = (got - want).abs().max().item()
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > LOGIT_ATOL
        same = bool((torch.argmax(got, -1) == torch.argmax(want, -1))[clear].all())
        if err > LOGIT_ATOL or not same:
            misses.append(f"{label}: logits max err {err} (tol {LOGIT_ATOL}), greedy equal on "
                          f"the clear rows: {same}")
        print(f"[encdec] {label} from one shared state: logits {tuple(got.shape)} max_abs_err "
              f"vs plain {err:.3e} (tol {LOGIT_ATOL}); greedy equal on {int(clear.sum())}/"
              f"{clear.numel()} clear rows: {same}; launches {counts}", flush=True)
        add(counts)

    held("decode step (B=8)", lambda c: dense.decode(tok, c, enc),
         {"qdecode_attn": n_layers})
    held(f"chunk (C={chunk} at {plen} into slot 3)", lambda c: model.apply(
        params, ctok, Context(), cache=c, decode=True, chunk=KVChunk(3, plen, chunk),
        logit_pos=chunk - 1, enc=enc[3:4]), {"qchunk_attn": n_layers})

    # -- cached vs re-projected cross-attention, slots 6 and 7 reused shorter ------
    lens = [cfg.enc_seq] * (slots - 2) + list(shorter)
    short = {n: encoded(1, n) for n in shorter}
    with torch.inference_mode():
        state = clone(shared)
        for j, n in zip((6, 7), shorter):
            state = model.write_cross_kv(params, state, short[n], j, Context())
        xlen = state["body"][0]["xkv"]["xlen"]
        check(xlen.tolist() == [lens] * n_layers, f"encdec: xlen {xlen.tolist()}")
        got, _ = dense.decode(tok, clone(state), enc)
        worst = 0.0
        for n in sorted(set(lens)):
            rows = [j for j, x in enumerate(lens) if x == n]
            e = enc[:, :n].clone()
            for j in rows:
                if n != cfg.enc_seq:
                    e[j] = short[n][0]
            plain_state = {"body": [{"kv": n_["kv"]} for n_ in clone(state)["body"]]}
            want, _ = dense.decode(tok, plain_state, e)
            worst = max(worst, (got[rows] - want[rows]).abs().max().item())
    check(worst <= CROSS_ATOL, f"encdec: cached vs re-projected cross-attention logits max "
                               f"err {worst} > {CROSS_ATOL}")
    print(f"[encdec] cached vs re-projected cross-attention, one decode step over encoder "
          f"lengths {lens} (slots 6 and 7 rewritten shorter over {cfg.enc_seq}-row ones): logits "
          f"max_abs_err {worst:.3e} (tol {CROSS_ATOL})", flush=True)

    # -- bytes and memory ---------------------------------------------------------------
    per_slot = state_bytes_per_slot(dense.new_cache(per_slot=True), slots)
    predicted = 2 * n_layers * cfg.enc_seq * cfg.n_kv_heads * cfg.head_dim * 4 + 4 * n_layers
    check(per_slot["cross"] == predicted, f"encdec: cross bytes per slot {per_slot['cross']} != "
                                          f"predicted {predicted}")
    peak = torch.cuda.max_memory_allocated()
    check(peak < total, f"encdec: peak memory {peak / GIB:.2f} GiB past the card's")
    print(f"[encdec] state bytes per slot {per_slot} (cross: 2 x {n_layers} layers x "
          f"{cfg.enc_seq} x {cfg.n_kv_heads} x {cfg.head_dim} float32 + {n_layers} xlen = "
          f"{predicted}); cache_bytes per-slot {dense.cache_bytes(per_slot=True)} B; peak "
          f"memory {peak / GIB:.2f} GiB of {total / GIB:.2f} (torch.cuda.max_memory_allocated) "
          f"| card {card}", flush=True)

    # -- profiles ----------------------------------------------------------------------
    sched = dense.scheduler(chunk_size=chunk)
    lane = 4
    act = host_tensor(np.arange(slots) != lane, "cuda")

    def decode_step(st):
        c, t = st
        lg, c = dense.decode(t, c, enc)
        return c, torch.argmax(lg, dim=-1, keepdim=True).to(torch.int32)

    def mixed_tick(st):
        c, t = st
        t, _, _, c = sched._masked_mixed(t, c, None, act, ctok, lane, 0, chunk, None, enc)
        return c, t

    for label, step in (("decode step", decode_step), ("mixed tick", mixed_tick)):
        prof = profile_steps(torch, f"whisper-tiny {label} (B={slots}" +
                             (f", C={chunk})" if label == "mixed tick" else ")"), step,
                             (clone(shared), tok), card)
        if prof is not None:
            attn = sum(r[0] for r in prof["rows"] if "attn" in r[2] or "chunk" in r[2]) / 1e3
            print(f"[encdec] whisper-tiny {label}: the attention kernels {attn:.3f} ms of "
                  f"{prof['busy_ms']:.3f} ms device busy", flush=True)
    print(f"[time] encdec phase {time.perf_counter() - phase_t0:.1f}s (runs "
          f"{t_runs - phase_t0:.1f}s)", flush=True)
    check(not misses, "encdec: " + "; ".join(misses))
    del model, params, dense, paged, uncached, shared, state, sched
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches


# The MoE and hybrid archs' shapes (``[moe]``): G = 4 at D = 128 (phi3.5-moe and
# jamba: 32 query heads over 8 KV heads of 128) over the served cache (S = 160,
# the chunk at start 96) and a long one (S = 2048, start 1984); phi's projections
# and untied head, jamba's Mamba projections (dt_proj, 256 -> 8192, stays float)
# and dense FFN, (label, K, N, calls a layer).
MOE_CELLS = ((160, 96, [160, 1, 100, 159, 17, 64, 128, 129]),
             (2048, 1984, [2048, 1, 1000, 2047, 17, 640, 1500, 129]))
MOE_GEMMS = (("phi wq/wo", 4096, 4096, 2), ("phi wk/wv", 4096, 1024, 2),
             ("phi lm_head", 4096, 32064, 0), ("jamba in_proj", 4096, 16384, 1),
             ("jamba x_proj", 8192, 288, 1), ("jamba out_proj", 8192, 4096, 1),
             ("jamba gate/in", 4096, 14336, 2), ("jamba ffn out", 14336, 4096, 1))
MOE_CUTS = (("phi3.5-moe-42b-a6.6b", 8), ("jamba-v0.1-52b", 8))    # (arch, layers served)
MOE_SLOTS, MOE_PROMPT, MOE_NEW, MOE_CHUNK = 8, 32, 64, 32


def events_ms(torch, fn, iters):
    """Device ms per call of ``fn`` between CUDA events (for calls of
    milliseconds that allocate, where a graph would pin their transients)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def moe_expert_case(torch, gen, card):
    """One phi3.5-moe layer's experts (E = 16, D = 4096, F = 6400, top-2)
    through ``MoE.experts`` on int8 stacks (per (expert, column) scales) at
    a decode step's capacity (B = 8: C = 2) and a chunk's (C = 32: 5): the
    three stacks dequantized whole to float32 and multiplied, as the
    reference does, timed against the bound of reading the codes once and
    against the same products on stacks dequantized ahead (``torch.bmm``,
    what a float32 model pays).  Returns the rows."""
    from repro_torch.core.qformat import QTensor
    from repro_torch.nn.module import Context
    from repro_torch.nn.moe import MoE

    e, d, f = 16, 4096, 6400
    moe = MoE(d, f, e, 2)
    params = {"experts": {}}
    for name, shape in (("w_gate", (e, d, f)), ("w_in", (e, d, f)), ("w_out", (e, f, d))):
        q = torch.randint(-128, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        n = torch.randint(8, 12, (e, 1, shape[2]), generator=gen, device="cuda",
                          dtype=torch.int32)
        params["experts"][name] = {"kernel": QTensor(q, n, 8)}
    codes = 3 * e * d * f
    rows = []
    with torch.inference_mode():
        deq = {k: v["kernel"].dequantize() for k, v in params["experts"].items()}
        for cap in (2, 5):
            xe = torch.randn(e, cap, d, generator=gen, device="cuda")
            got = moe.experts(params, xe, Context())

            def library():
                h = torch.nn.functional.silu(torch.bmm(xe, deq["w_gate"])) \
                    * torch.bmm(xe, deq["w_in"])
                return torch.bmm(h, deq["w_out"])

            err = (got - library()).abs().max().item()
            tol = WQ_RTOL * library().abs().max().item()
            check(err <= tol, f"MoE experts C={cap}: max err {err} vs the f32 bmm (tol {tol})")
            ms = events_ms(torch, lambda: moe.experts(params, xe, Context()), 5)
            lib = events_ms(torch, library, 5)
            nbytes = codes + 4 * 3 * e * f + 2 * 4 * e * cap * d
            b_ms, b_by = bound(nbytes, 3 * 2.0 * e * cap * d * f)
            design = (codes + 2 * 4 * codes) / HBM_BYTES_S * 1e3
            rows.append(dict(cap=cap, err=err, ms=ms, library_ms=lib, bound_ms=b_ms,
                             bound_by=b_by, design_bytes_ms=design))
            print(f"[kernel] MoE experts, one phi3.5-moe layer (E={e}, D={d}, F={f}, C={cap}): "
                  f"dequantize-and-product {ms * 1e3:.2f} us | bmm on stacks dequantized ahead "
                  f"{lib * 1e3:.2f} us | bound {b_ms * 1e3:.2f} us ({b_by}: the int8 codes "
                  f"read once, {codes / 1e9:.3f} GB) | the design's bytes (codes read, f32 "
                  f"written and read back) {design * 1e3:.2f} us | max_abs_err {err:.3e} | "
                  f"card {card}", flush=True)
    del deq, params
    torch.cuda.empty_cache()
    return rows


def check_moe_kernels(torch, F, ref, kern, gen, page_size, card):
    """The kernels at the MoE and hybrid archs' shapes, against their plain
    versions and timed beside them: ``wq_matmul`` at ``MOE_GEMMS`` (M = 8
    and 32; phi's head at M = 8), the five attention kernels at G = 4
    (Hq = 32, Hkv = 8, D = 128, B = 8) over ``MOE_CELLS`` (paged at
    ``page_size``), one phi layer's expert products (``moe_expert_case``)
    and the routing softmax at E = 16 and 384 (``routing_softmax_cost``:
    in a process that has profiled before, it read fewer kernels than the
    call makes).  Returns the rows by kernel, the expert
    rows, the worst error and the softmax's cost by E."""
    out = {"wq_matmul": [wq_case(torch, ref, kern.wq, gen, m, label, k, n, per)
                         for label, k, n, per in MOE_GEMMS
                         for m in ((8,) if per == 0 else (8, 32))]}
    for short, label in (("phi w", "phi3.5-moe attention layer"),
                         ("jamba", "jamba Mamba layer + dense FFN")):
        for m in (8, 32):
            rows = [r for r in out["wq_matmul"] if r["m"] == m and r["shape"].startswith(short)]
            calls = sum(r["per_layer"] for r in rows)
            layer = layer_sum(rows)
            out["wq_matmul"].append(dict(layer, m=m, shape=label, err=0.0))
            print(f"[kernel] wq_matmul {label} ({calls} calls, M={m}): kernel "
                  f"{layer['ms'] * 1e3:.2f} us | plain {layer['plain_ms'] * 1e3:.2f} us | library "
                  f"{layer['library_ms'] * 1e3:.2f} us | bound {layer['bound_ms'] * 1e3:.2f} us "
                  f"({layer['bound_by']})", flush=True)
    for name in ATTN_KERNELS:
        out[name] = []
    for s, start, lens in MOE_CELLS:
        attention_cells(torch, F, ref, kern, gen, out, "phi3.5-moe/jamba", 32, 8, d=128, s=s,
                        start=start, lens=lens, ps=page_size)
    experts = moe_expert_case(torch, gen, card)
    softmax = {}
    for e in (16, 384):     # phi's and jamba's experts; kimi-k2's
        softmax[e] = routing_softmax_cost(torch, 8, e)
        if softmax[e] is not None:
            print(f"[kernel] MoE routing softmax (softmax_f32 at 8 x {e}: XLA's CPU exp and a "
                  f"left-to-right row sum, op by op): {softmax[e][0]:.0f} kernels, "
                  f"{softmax[e][1]:.1f} us device a call | card {card}", flush=True)
    worst = max(r["err"] for rows in out.values() for r in rows)
    return out, experts, worst, softmax


def wq_per_forward(model) -> int:
    """``wq_matmul`` launches of one forward: 4 an attention layer, 3 a Mamba
    one (dt_proj stays float), 3 a dense gated FFN or a shared expert (the
    routed experts and the router take none), 1 an untied head."""
    stack = model.stack
    total = 0
    for blk in stack.blocks:
        total += 4 if blk.mixer == "attn" else 3
        total += 3 if blk.ffn != "moe" or blk.n_shared_experts else 0
    return total + (0 if model.tie_embeddings else 1)


def clone_tree(tree):
    """A copy of a cache tree with every tensor cloned."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone_tree(v) for v in tree]
    return tree.clone() if hasattr(tree, "clone") else tree


def moe_serve(torch, card, arch, cfg, argv, expected, launches, engines):
    """``launch.serve.main(argv)`` for ``arch`` served at ``cfg`` (the
    launcher's ``get_config`` answers it), its engine kept in ``engines``:
    every request ``ok``, launch counts ``expected(stats)``, the report's
    state kinds and peak memory printed.  Returns the stats."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.scheduler import Scheduler

    stats, run, made = [], Scheduler.run, []
    real_cfg, real_engine = launch_serve.get_config, launch_serve.ServeEngine

    def counted_run(self, *a, **k):
        out = run(self, *a, **k)
        stats.append(out[1])
        return out

    def kept_engine(**kw):
        made.append(real_engine(**kw))
        return made[-1]

    engines.clear()             # the previous run's engine goes before this one's init
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    Scheduler.run = counted_run
    launch_serve.get_config = lambda a: cfg if a == arch else real_cfg(a)
    launch_serve.ServeEngine = kept_engine
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        results = launch_serve.main(argv)
    finally:
        Scheduler.run = run
        launch_serve.get_config, launch_serve.ServeEngine = real_cfg, real_engine
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = stats[0]
    want = dict({k: 0 for k in counts}, **expected(st))
    label = f"{arch} launch.serve {' '.join(argv[2:])}"
    check(counts == want, f"{label}: launch counts {counts} != expected {want}")
    n_req = int(argv[argv.index("--requests") + 1])
    check(sorted(results) == list(range(n_req)), f"{label}: results for {sorted(results)}")
    for rid, r in results.items():
        check(r.status == "ok" and len(r.tokens) == int(argv[argv.index("--max-new") + 1])
              and all(0 <= t < cfg.vocab for t in r.tokens),
              f"{label}: request {rid} ended {r.status} with {len(r.tokens)} tokens")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    summ = st.summary()
    peak = torch.cuda.max_memory_allocated() / GIB
    print(f"[moe] {label}: {n_req} requests ok, {st.decode_steps} ticks, {st.prefill_chunks} "
          f"chunks, state {st.state_kinds}; launches {counts} == expected; steady "
          f"{summ['steady_tok_s']:.1f} tok/s ({st.steady_s * 1e3 / st.decode_steps:.2f} ms a "
          f"tick); ttft p50/p99 {summ['p50_ttft_steps']:.0f}/{summ['p99_ttft_steps']:.0f} "
          f"ticks; audited ticks {st.audited_ticks}; main() {secs:.1f}s with init and int8 "
          f"integerize; peak memory {peak:.2f} GiB (torch.cuda.max_memory_allocated) | card "
          f"{card}", flush=True)
    check(peak * GIB < torch.cuda.get_device_properties(0).total_memory,
          f"{label}: peak memory {peak:.2f} GiB past the card's")
    engines[:] = made[-1:]
    return st


def moe_held(torch, label, engine, misses, per, attn):
    """A decode step (B = 8) and a chunk (C = 32 into slot 3 at start 32) on
    one shared cache through the kernels and through the plain versions:
    logits within LOGIT_ATOL and the same greedy token where the plain top-2
    margin is clear.  The expert choices of the two paths are recorded
    (``MoE.route``) and the tokens whose expert set differs counted; if
    the logits miss, the plain path is run again under the kernel path's
    routing and held to the same limit.  Each kernel run's launches are
    exact: ``per`` ``wq_matmul`` and ``attn`` attention launches.  Returns
    the kernel runs' counts, the lockstep cache and the next token."""
    from repro_torch.kernels import ops
    from repro_torch.nn.attention import KVChunk
    from repro_torch.nn.module import Context
    from repro_torch.nn.moe import MoE

    model, params = engine.model, engine.params
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, model.vocab, (MOE_SLOTS, MOE_PROMPT), generator=gen,
                            device="cuda", dtype=torch.int32)
    ctok = torch.randint(0, model.vocab, (1, 2 * MOE_CHUNK), generator=gen, device="cuda",
                         dtype=torch.int32)
    with torch.inference_mode():
        logits, lock = engine.prefill(prompts, engine.new_cache())
        slot_cache = model.init_cache(MOE_SLOTS, MOE_PROMPT + MOE_NEW,
                                      quantized_kv=engine.quantized_kv, device="cuda",
                                      per_slot_len=True)
        _, slot_cache = model.apply(params, ctok[:, :MOE_CHUNK], Context(), cache=slot_cache,
                                    decode=True, chunk=KVChunk(3, 0, MOE_CHUNK),
                                    logit_pos=MOE_CHUNK - 1)
    tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    counts_all = {}
    real_route = MoE.route
    for name, fn, base, kernel in (
            ("decode step (B=8)", lambda c: engine.decode(tok, c), lock, "qdecode_attn"),
            (f"chunk (C={MOE_CHUNK} into slot 3 at start {MOE_CHUNK})",
             lambda c: model.apply(params, ctok[:, MOE_CHUNK:], Context(), cache=c,
                                   decode=True, chunk=KVChunk(3, MOE_CHUNK, MOE_CHUNK),
                                   logit_pos=MOE_CHUNK - 1), slot_cache, "qchunk_attn")):
        routes = {"kernels": [], "plain": []}

        def run(path, replay=None):
            def route(self, probs_sel, cap):
                out = replay.pop(0) if replay is not None else real_route(self, probs_sel, cap)
                routes[path].append(out)
                return out
            MoE.route = route
            try:
                with torch.inference_mode():
                    return fn(clone_tree(base))[0]
            finally:
                MoE.route = real_route

        ops.reset_launch_counts()
        got = run("kernels")
        counts = ops.launch_counts()
        check(counts == dict({k: 0 for k in counts}, wq_matmul=per, **{kernel: attn}),
              f"{label} {name}: launch counts {counts}")
        ops.FORCE = "plain"
        try:
            want = run("plain")
            diff = sum(int((a[0].sort(-1).values != b[0].sort(-1).values).any(-1).sum())
                       for a, b in zip(routes["kernels"], routes["plain"]))
            tokens = sum(a[0].shape[0] for a in routes["kernels"])
            err = (got - want).abs().max().item()
            replayed = None
            if err > LOGIT_ATOL and diff:
                replay = list(routes["kernels"])
                routes["plain"] = []
                want = run("plain", replay)
                replayed = err
                err = (got - want).abs().max().item()
        finally:
            ops.FORCE = None
        check(bool(torch.isfinite(got).all()), f"{label} {name}: logits not finite")
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > LOGIT_ATOL
        same = bool((torch.argmax(got, -1) == torch.argmax(want, -1))[clear].all())
        if err > LOGIT_ATOL or not same:
            misses.append(f"{label} {name}: logits max err {err} (tol {LOGIT_ATOL}), greedy "
                          f"equal on the clear rows: {same}")
        print(f"[moe] {label} {name} from one shared cache: logits {tuple(got.shape)} "
              f"max_abs_err vs plain {err:.3e} (tol {LOGIT_ATOL})"
              + (f" under the kernel path's routing ({replayed:.3e} under its own)"
                 if replayed is not None else "")
              + f"; tokens whose expert choice differs between the paths {diff} of {tokens} "
              f"({len(routes['kernels'])} MoE layers); greedy equal on {int(clear.sum())}/"
              f"{clear.numel()} clear rows: {same}; launches {counts}", flush=True)
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
    return counts_all, lock, tok


def moe_profiles(torch, label, engine, card, cache, tok, softmax):
    """A decode step (B = 8) and a mixed tick (C = 32, slot 4 prefilling)
    profiled, with ``wq_matmul``'s and the attention kernels' shares and
    the routing softmax's (``softmax``: its kernels and device us a call,
    from ``routing_softmax_cost``)."""
    import numpy as np

    from repro_torch.nn.attention import host_tensor

    sched = engine.scheduler(chunk_size=MOE_CHUNK)
    lane = 4
    act = host_tensor(np.arange(MOE_SLOTS) != lane, "cuda")
    ctok = torch.randint(0, engine.model.vocab, (1, MOE_CHUNK), device="cuda",
                         dtype=torch.int32, generator=torch.Generator(device="cuda").manual_seed(9))
    pcache = engine.new_cache(per_slot=True)

    def decode_step(state):
        c, t = state
        lg, c = engine.decode(t, c)
        return c, torch.argmax(lg, dim=-1, keepdim=True).to(torch.int32)

    def mixed_tick(state):
        c, t = state
        t, _, _, c = sched._masked_mixed(t, c, None, act, ctok, lane, 0, MOE_CHUNK)
        return c, t

    kernels = {}
    for name, step, state in (("decode step", decode_step, (cache, tok)),
                              ("mixed tick", mixed_tick, (pcache, tok))):
        prof = profile_steps(torch, f"{label} {name} (B={MOE_SLOTS}"
                             + (f", C={MOE_CHUNK})" if name == "mixed tick" else ")"), step,
                             state, card)
        if prof is not None:
            busy = prof["busy_ms"]
            kernels[name] = sum(r[1] for r in prof["rows"])
            wq = sum(r[0] for r in prof["rows"] if "wq_matmul_kernel" in r[2]) / 1e3
            attn = sum(r[0] for r in prof["rows"] if "attn" in r[2] or "chunk" in r[2]) / 1e3
            print(f"[moe] {label} {name}: wq_matmul {wq:.3f} ms, attention kernels {attn:.3f} "
                  f"ms of {busy:.3f} ms device busy; the rest (expert dequantize and products, "
                  f"routing, the Mamba scans) {busy - wq - attn:.3f} ms", flush=True)
    if softmax is not None and "decode step" in kernels:
        layers = sum(b.ffn == "moe" for b in engine.model.stack.blocks)
        print(f"[moe] {label} routing softmax ({softmax[0]:.0f} kernels, {softmax[1]:.1f} us "
              f"device a call at {MOE_SLOTS} x 16 in the kernel phase) x {layers} MoE layers: "
              f"{softmax[0] * layers:.0f} of the decode step's {kernels['decode step']:.0f} "
              f"kernels, {softmax[1] * layers / 1e3:.3f} ms of its device time | card {card}",
              flush=True)


def routing_softmax_cost(torch, t, e, calls: int = 4):
    """The kernels one ``softmax_f32`` call launches at (t, e) and their
    device us, averaged over ``calls`` calls under ``torch.profiler`` (host
    and device activities, as ``profile_steps`` records them); None when it
    recorded no device time.  The routing's softmax emulates XLA's CPU
    exponential and row sum op by op, so its launches grow with the
    experts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.nn.moe import softmax_f32

    x = torch.randn(t, e, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    with torch.inference_mode():
        softmax_f32(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                softmax_f32(x)
            torch.cuda.synchronize()
    n = us = 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t_us = getattr(ev, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(ev, "self_cuda_time_total", 0)
        if t_us > 0:
            n, us = n + ev.count, us + t_us
    return (n / calls, us / calls) if n else None


def moe_end_to_end(torch, card, softmax):
    """``[moe]``: phi3.5-moe-42b-a6.6b at its published width (d_model 4096,
    32/8 heads of 128, 16 experts of 6400, top-2, LayerNorm, untied head over
    32064), 8 of its 32 layers, seeded, int8 weights and KV, served through
    ``launch.serve.main`` (8 requests of 32 + 64 tokens, arrival spacing 2, 8
    slots, chunk 32): ``chunked --paged``, ``ragged`` and ``chunked --audit``;
    then on the last run's engine a decode step and a chunk held to the plain
    versions (expert choices of the two paths counted) and both profiled.
    Then jamba-v0.1-52b's first period (8 of 32 layers: 7 Mamba, 1
    attention, MoE at the odd ones) at full width served ``chunked`` and held
    and profiled the same way, and kimi-k2-1t-a32b at its smoke width served
    ``chunked`` (its dense prelude layer and shared expert).  Launch counts
    are exact in every run.  Returns the launches of the counted runs."""
    from repro_torch.models.registry import get_config

    phase_t0 = time.perf_counter()
    launches, misses, engines = {}, [], []
    common = ["--requests", "8", "--slots", str(MOE_SLOTS), "--prompt-len", str(MOE_PROMPT),
              "--max-new", str(MOE_NEW), "--chunk-size", str(MOE_CHUNK), "--arrival-spacing",
              "2", "--wq", "--qkv"]
    for arch, cut in MOE_CUTS:
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=cut)
        model = cfg.build()
        per, attn = wq_per_forward(model), model.stack.attention_layers
        print(f"[moe] {arch}: {cut} of {full.n_layers} layers at the published width (d_model "
              f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, "
              f"{cfg.n_experts} experts of {cfg.d_ff}, top-{cfg.top_k}, layout {cfg.layout!r}, "
              f"MoE every {cfg.moe_every} from {cfg.moe_offset}, norm {cfg.norm}, tied "
              f"{cfg.tie_embeddings}, vocab {cfg.vocab}): {cfg.param_count() / 1e9:.2f} B "
              f"parameters, {4 * cfg.param_count() / 1e9:.1f} GB as float32 at init; "
              f"{per} wq_matmul and {attn} attention launches a forward", flush=True)
        del model

        def chunked(st, dense=True):
            ticks, chunks = st.decode_steps, st.prefill_chunks
            check(chunks == 8 * -(-MOE_PROMPT // MOE_CHUNK), f"{arch}: {chunks} chunks")
            d, c = ("qdecode_attn", "qchunk_attn") if dense else \
                ("qpaged_decode_attn", "qpaged_chunk_attn")
            # warm-up: one mixed step (decode half + chunk half) and one decode step
            return {"wq_matmul": per * (ticks + chunks + 3), d: attn * (ticks + 2),
                    c: attn * (chunks + 1)}

        if arch.startswith("phi"):
            runs = ((["--policy", "chunked", "--paged"], lambda st: chunked(st, dense=False)),
                    (["--policy", "ragged"],
                     lambda st: {"wq_matmul": per * (st.decode_steps + 1),
                                 "qragged_attn": attn * (st.decode_steps + 1)}),
                    (["--policy", "chunked", "--audit"], chunked))
        else:
            runs = ((["--policy", "chunked"], chunked),)
        for extra, expected in runs:
            st = moe_serve(torch, card, arch, cfg, ["--arch", arch] + extra + common, expected,
                           launches, engines)
            check(st.state_kinds == ("kv+recurrent" if cfg.layout != "a" else "kv"),
                  f"{arch}: state kinds {st.state_kinds!r}")
            if "--audit" in extra:
                check(st.audited_ticks == st.decode_steps == st.audit_reads,
                      f"{arch} audited run: {st.audited_ticks} audited, {st.audit_reads} "
                      f"reads, {st.decode_steps} ticks")
        engine = engines.pop()
        counts, cache, tok = moe_held(torch, arch, engine, misses, per, attn)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        moe_profiles(torch, arch, engine, card, cache, tok, softmax)
        print(f"[moe] {arch}: peak memory {torch.cuda.max_memory_allocated() / GIB:.2f} GiB "
              f"over its lockstep checks and profiles | card {card}", flush=True)
        del engine, cache
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"[time] {arch} {time.perf_counter() - t_arch:.1f}s", flush=True)

    # -- kimi-k2 at smoke width: the dense prelude and the shared expert -----------
    cfg = get_config("kimi-k2-1t-a32b-smoke")
    model = cfg.build()
    per, attn = wq_per_forward(model), model.stack.attention_layers
    check((per, attn) == (22, 3), f"kimi-k2-smoke: {per} wq_matmul, {attn} attention a forward")

    def kimi_counts(st):
        ticks, chunks = st.decode_steps, st.prefill_chunks
        return {"wq_matmul": per * (ticks + chunks + 3), "qdecode_attn": attn * (ticks + 2),
                "qchunk_attn": attn * (chunks + 1)}

    moe_serve(torch, card, cfg.arch_id, cfg, ["--arch", cfg.arch_id, "--policy", "chunked"]
              + common, kimi_counts, launches, engines)
    engines.clear()
    print(f"[time] moe phase {time.perf_counter() - phase_t0:.1f}s", flush=True)
    check(not misses, "moe: " + "; ".join(misses))
    return launches



# --------------------------------------------------------------------------
# [dist]: the data axis over torch.distributed (world 1 here, world 2 under torchrun)
# --------------------------------------------------------------------------

DIST_STEPS = 3              # steps of each configuration (4 until the remat of
                            # launch.train and [account] needed the time)
DIST_PROFILED = 2           # the step profiled on rank 0 (kept out of the wall median)
DIST_ARGS = ["--arch", "smollm-135m", "--batch", "8", "--seq", "128", "--steps",
             str(DIST_STEPS), "--log-every", "100"]
DIST_TIMEOUT = 300          # seconds a launch of the ranks may take


def dist_start(world: int, backend: str, out: Path):
    """Start ``torchrun --standalone --nproc-per-node world`` of this
    script's rank program on ``backend``; the ranks start their timed work
    once ``out/go`` exists (:func:`dist_wait` reads their results)."""
    import os

    out.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(Path(__file__).resolve().parent / "src"), env.get("PYTHONPATH")) if p)
    # the machine's only interface may be loopback: name it for gloo and NCCL
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", str(Path(__file__).resolve()), "--dist-rank", backend,
           str(out)]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)


def dist_ready(proc, world: int, out: Path, tag: str = "[dist]") -> None:
    """Wait until every rank has formed its group and waits for the word."""
    deadline = time.perf_counter() + DIST_TIMEOUT
    while not all((out / f"ready{r}").exists() for r in range(world)):
        if proc.poll() is not None or time.perf_counter() > deadline:
            print(dist_kill(proc)[-6000:], flush=True)
            fail(f"{tag} the {world} ranks did not come up")
        time.sleep(0.05)


def dist_kill(proc) -> str:
    """Kill and reap the launch and its ranks (one process group); its
    remaining output."""
    import os
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    return proc.communicate()[0] or ""


def dist_wait(proc, world: int, backend: str, out: Path, tag: str = "[dist]") -> list:
    """Give the ranks their word to start and return each rank's results.
    The ranks are killed and reaped whatever happens; a rank that fails
    fails the phase."""
    (out / "go").touch()
    log = ""
    try:
        log, _ = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            log += dist_kill(proc)
    if proc.returncode != 0:
        print(log[-6000:], flush=True)
        fail(f"{tag} {world} rank(s) over {backend} exited {proc.returncode}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def dist_rank(backend: str, out: str) -> int:
    """The rank program of ``[dist]``, started by ``torchrun``: forms the
    group on the card over ``backend`` and runs every configuration; writes
    ``rank<r>.json`` into ``out``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import init_process_group

    t_start = time.time()
    init_process_group(torch.device("cuda"), backend)
    try:
        # the parent may still be on the card: start the timed work on its word
        Path(out, f"ready{dist.get_rank()}").touch()
        go = Path(out, "go")
        deadline = time.perf_counter() + DIST_TIMEOUT
        while not go.exists():
            check(time.perf_counter() < deadline, f"[dist] {go} never came")
            time.sleep(0.05)
        res = dist_rank_runs(torch, dist)
        res["clock"] = {"start": t_start, "end": time.time()}
        Path(out, f"rank{dist.get_rank()}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def dist_rank_runs(torch, dist) -> dict:
    """On every rank: ``launch.train.main --mesh W,1`` float and ``--qat``
    (``DIST_ARGS``), then ``make_dp_shardmap_train_step`` with
    ``compress_bits`` 8 and 0 (AdamW 3e-3 on the same Markov batches), each
    for ``DIST_STEPS`` steps: losses, step wall ms, the profiled step's
    device busy ms and all-reduce calls, the gradient all-reduce alone,
    its payload bytes, peak memory, a checksum of the parameters after
    every step and the final parameters held to rank 0's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import markov_batch_fn
    from repro_torch.dist.compress import (compressed_grad_allreduce, grad_allreduce_mean,
                                           wire_bytes)
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.nn.module import Context, tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_host_mesh(world, 1, "cuda")
    group = mesh.get_group("data")

    def checksum(params):
        """Per leaf: the float64 sum of the values and the sum of their bit
        patterns (device tensors; no read-back)."""
        leaves = tree_leaves(params)
        return torch.stack([torch.stack([t.double().sum() for t in leaves]),
                            torch.stack([t.view(torch.int32).to(torch.int64).sum()
                                         for t in leaves]).double()])

    def agree(checks, params) -> dict:
        """Whether every rank's checksums of every step and final parameters
        equal rank 0's (a broadcast and ``torch.equal`` leaf by leaf)."""
        same = True
        for t in tree_leaves(params):
            ref = t.clone()
            dist.broadcast(ref, src=dist.get_global_rank(group, 0), group=group)
            same = same and torch.equal(ref, t)
        mine = torch.stack(checks).cpu().tolist()
        every = [None] * world
        dist.all_gather_object(every, (mine, same), group=group)
        return {"steps_equal": all(e[0] == every[0][0] for e in every),
                "final_equal": all(e[1] for e in every)}

    parts = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return out

    def profiled(fn):
        """``fn()`` under the profiler, tracing the card only (a host trace
        of a QAT step's ops costs seconds to read back): (its result, device
        busy ms, ``dist.all_reduce`` calls it made)."""
        calls = [0]
        real = dist.all_reduce

        def counted(*a, **k):
            calls[0] += 1
            return real(*a, **k)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce = counted
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
        finally:
            dist.all_reduce = real
        t1 = time.perf_counter()
        # the raw device activities (kernels, copies, fills), summed without
        # building the profiler's per-op tables (seconds for a QAT step)
        busy_ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA)
        parts["profile_step"] = parts.get("profile_step", 0.0) + t1 - t0
        parts["profile_read"] = parts.get("profile_read", 0.0) + time.perf_counter() - t1
        # no device events: the profiler did not trace the card (not measured)
        return out, (busy_ns / 1e6 if busy_ns else None), calls[0]

    def collective_ms(fn, reps: int = 2) -> float:
        """The best wall ms of ``reps`` calls of ``fn()`` (one gradient
        all-reduce), every rank starting together."""
        times = []
        for _ in range(reps):
            dist.barrier(group=group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    res = {"rank": rank, "world": world, "backend": dist.get_backend(group),
           "device": torch.cuda.get_device_name(torch.cuda.current_device()), "runs": {}}

    # -- launch.train.main --mesh W,1, float and --qat ------------------------
    for label, extra in (("float", []), ("qat", ["--qat"])):
        t_run = time.perf_counter()
        checks, records, prof = [], [], {}
        made = launch_train.make_train_step

        def watched(*a, made=made, checks=checks, prof=prof, **k):
            step_fn = made(*a, **k)

            def step(state, batch):
                if len(checks) == DIST_PROFILED and rank == 0:
                    (state, mets), prof["busy_ms"], prof["allreduces"] = profiled(
                        lambda: step_fn(state, batch))
                else:
                    state, mets = step_fn(state, batch)
                checks.append(checksum(state["params"]))
                return state, mets
            return step

        launch_train.make_train_step = watched
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        try:
            state = timed("main", lambda: launch_train.main(
                DIST_ARGS + ["--mesh", f"{world},1"] + extra,
                on_step=lambda s, m, dt, r=records: r.append((m["loss"], dt))))
        finally:
            launch_train.make_train_step = made
        peak = torch.cuda.max_memory_allocated() - held
        grads = state["params"]            # the gradient tree's shapes
        res["runs"][label] = {
            "losses": [r[0] for r in records],
            "step_ms": [r[1] * 1e3 for r in records], **prof, "peak_bytes": peak,
            "allreduce_ms": timed("collective", lambda: collective_ms(
                lambda: grad_allreduce_mean(grads, group))),
            "payload_bytes": wire_bytes(grads),
            **timed("agree", lambda: agree(checks, state["params"])),
            "seconds": time.perf_counter() - t_run}
        del state, grads

    # -- make_dp_shardmap_train_step, compress_bits 8 and 0 --------------------
    cfg = get_config("smollm-135m")
    model = cfg.build()
    opt = adamw(weight_decay=0.01)
    bf = markov_batch_fn(cfg.vocab, 8, 128, seed=0)
    for bits in (8, 0):
        t_run = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        state = trainer.init_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0),
                                         "cuda")
        step_fn = trainer.make_dp_shardmap_train_step(model, opt, 3e-3, mesh,
                                                      compress_bits=bits)
        checks, losses, walls, prof = [], [], [], {}
        for s in range(DIST_STEPS):
            batch = bf(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if s == DIST_PROFILED and rank == 0:
                (state, mets), prof["busy_ms"], prof["allreduces"] = profiled(
                    lambda: step_fn(state, batch))
            else:
                state, mets = step_fn(state, batch)
            losses.append(mets["loss"].item())
            walls.append((time.perf_counter() - t0) * 1e3)
            checks.append(checksum(state["params"]))
        peak = torch.cuda.max_memory_allocated() - held
        run = {"losses": losses, "step_ms": walls, **prof, "peak_bytes": peak,
               "payload_bytes": wire_bytes(state["params"], bits),
               **agree(checks, state["params"])}
        # this rank's gradient on its slice of batch 0: the exact mean, and
        # the compressed one (within a grid step of it) and its all-reduce
        local, _ = trainer._slices(bf(0), group)
        (_, _), g = trainer.value_and_grad(
            lambda p, b: model.loss(p, b, Context(train=True)), state["params"],
            trainer.to_device(local, "cuda"))
        exact = grad_allreduce_mean(g, group)
        if bits:
            err = state["err"]
            run["allreduce_ms"] = collective_ms(
                lambda: compressed_grad_allreduce(g, group, bits=bits, error_state=err))
            mean, _ = compressed_grad_allreduce(g, group, bits=bits)
            ma = torch.stack([t.abs().amax() for t in tree_leaves(g)])
            dist.all_reduce(ma, op=dist.ReduceOp.MAX, group=group)
            worst = torch.stack([(a - b).abs().amax() for a, b in
                                 zip(tree_leaves(mean), tree_leaves(exact))]) / (ma / 2 ** (bits - 2))
            run["worst_err_in_grid_steps"] = worst.max().item()
        else:
            run["allreduce_ms"] = collective_ms(lambda: grad_allreduce_mean(g, group))
        run["seconds"] = time.perf_counter() - t_run
        res["runs"][f"dp{bits}"] = run
        del state, g, exact
        torch.cuda.empty_cache()
    res["parts"] = parts
    return res


def dist_world1(torch) -> dict:
    """World 1 over NCCL in this process: the rank program of
    :func:`dist_rank` on a group of one, formed from the variables that
    ``torchrun --nproc-per-node 1`` would set (a free local port), so that
    ``launch.train.main`` takes its distributed path; the variables are
    restored and the group destroyed after."""
    import os
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        init_process_group(torch.device("cuda"), "nccl")
        try:
            return dist_rank_runs(torch, dist)
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dist_end_to_end(torch, card) -> None:
    """``[dist]``: the data axis on the one card.  NCCL takes one rank a
    card, so world 1 runs over NCCL and world 2 over gloo (whose all-reduce
    and broadcast take CUDA tensors) with both ranks on the card; GPipe's
    point-to-point sends are in neither set here (gloo carries no CUDA
    send/recv, NCCL needs a second card), so it is held on the CPU tests
    only.  Each world runs ``launch.train.main --mesh W,1`` (smollm-135m at
    full width, AdamW, B=8, S=128, float and ``--qat``) and
    ``make_dp_shardmap_train_step`` with ``compress_bits`` 8 and 0, 4 steps
    each: the loss falls, every rank's parameters equal rank 0's after every
    step, the compressed mean is within one grid step of the exact mean,
    and world 1's losses equal those of the run without a process group
    (rtol 1e-5).  Prints step wall and device ms, the gradient all-reduce's
    ms and payload bytes, and peak memory a rank (above what the process
    held before), per configuration.  World 1 runs in this process
    (:func:`dist_world1`); world 2 is ``torchrun --standalone
    --nproc-per-node 2`` of this script (:func:`dist_rank`), whose ranks
    start up meanwhile and wait, idle, until world 1 has ended."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch import train as launch_train

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    summary = {}
    try:
        # world 2's ranks start up (torch, CUDA, gloo) while this process
        # trains without a group and then runs world 1; they time nothing
        # before dist_wait's word
        out2 = tmp / "gloo2"
        t2_clock = time.time()
        proc = dist_start(2, "gloo", out2)
        try:
            plain = {}
            for label, extra in (("float", []), ("qat", ["--qat"])):
                losses = []
                launch_train.main(DIST_ARGS + extra,
                                  on_step=lambda s, m, dt, l=losses: l.append(m["loss"]))
                plain[label] = losses
            print(f"[dist] the runs without a process group: "
                  f"{time.perf_counter() - phase_t0:.1f}s", flush=True)
            dist_ready(proc, 2, out2)
            gc.collect()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            world1 = [dist_world1(torch)]
            secs = {1: time.perf_counter() - t1}
        except BaseException:
            dist_kill(proc)
            raise
        t2 = time.perf_counter()
        world2 = dist_wait(proc, 2, "gloo", out2)
        secs[2] = time.perf_counter() - t2
        clock = world2[0]["clock"]
        print(f"[dist] world 2 over gloo: rank 0 came up {clock['start'] - t2_clock:.1f}s after "
              f"the launch, waited for world 1, and ended "
              f"{time.time() - clock['end']:.1f}s before the launch's end", flush=True)
        for world, backend, ranks in ((1, "nccl", world1), (2, "gloo", world2)):
            print(f"[dist] world {world} over {backend}: {secs[world]:.1f}s of every "
                  f"configuration; rank 0's parts (s): " + ", ".join(
                      f"{k} {v:.1f}" for k, v in ranks[0]["parts"].items()), flush=True)
            check(all(r["backend"] == backend for r in ranks),
                  f"[dist] a rank's group is not on {backend}: {[r['backend'] for r in ranks]}")
            for name, r0 in ranks[0]["runs"].items():
                runs = [r["runs"][name] for r in ranks]
                label = f"world {world} over {backend}, {name}"
                losses = r0["losses"]
                check(len(losses) == DIST_STEPS and all(np.isfinite(losses)), f"[dist] {label} losses {losses}")
                check(losses[-1] < losses[0], f"[dist] {label}: the loss did not fall: {losses}")
                check(all(r["steps_equal"] and r["final_equal"] for r in runs),
                      f"[dist] {label}: the ranks' parameters differ")
                if world == 1 and name in plain:
                    check(np.allclose(losses, plain[name], rtol=1e-5, atol=0),
                          f"[dist] {label}: losses {losses} against the run without a group "
                          f"{plain[name]}")
                if "worst_err_in_grid_steps" in r0:
                    worst = max(r["worst_err_in_grid_steps"] for r in runs)
                    check(worst <= 1.0, f"[dist] {label}: the compressed mean is {worst:.3f} "
                                        "grid steps from the exact mean")
                wall = float(np.median([t for i, t in enumerate(r0["step_ms"])
                                        if i not in (0, DIST_PROFILED)]))
                peak = max(r["peak_bytes"] for r in runs)
                row = {"world": world, "backend": backend, "config": name, "losses": losses,
                       "step_wall_ms": wall, "device_busy_ms": r0.get("busy_ms"),
                       "allreduces_a_step": r0.get("allreduces"),
                       "allreduce_ms": float(np.median([r["allreduce_ms"] for r in runs])),
                       "payload_bytes": r0["payload_bytes"], "peak_gib_a_rank": peak / 2 ** 30,
                       "worst_err_in_grid_steps": r0.get("worst_err_in_grid_steps"),
                       "seconds": r0["seconds"]}
                summary[f"{world}/{name}"] = row
                busy = ("not measured" if row["device_busy_ms"] is None
                        else f"{row['device_busy_ms']:.3f} ms")
                print(f"[dist] {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; step wall "
                      f"{wall:.2f} ms (median of the steps but 0 and {DIST_PROFILED}), device busy {busy} "
                      f"(step {DIST_PROFILED} profiled on rank 0, {row['allreduces_a_step']:.0f} "
                      f"all-reduce calls); gradient all-reduce alone {row['allreduce_ms']:.2f} ms, "
                      f"{row['payload_bytes']} payload bytes a rank a step; peak memory "
                      f"{row['peak_gib_a_rank']:.3f} GiB a rank; parameters equal on every rank "
                      f"after every step" + (
                          "" if row["worst_err_in_grid_steps"] is None else
                          f"; compressed mean within {row['worst_err_in_grid_steps']:.3f} grid "
                          f"steps of the exact mean") + f"; {row['seconds']:.1f}s; card {card}",
                      flush=True)
        check(all(np.allclose(summary[f"1/{k}"]["losses"], plain[k], rtol=1e-5)
                  for k in plain), "[dist] world 1 does not follow the run without a group")
        print(f"[dist] world 1 over nccl follows launch.train without a process group: float "
              f"{plain['float']} and QAT {plain['qat']} losses within rtol 1e-5", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("[dist] " + json.dumps({"dist": list(summary.values())}), flush=True)
    print(f"[time] dist phase {time.perf_counter() - phase_t0:.1f}s", flush=True)


SHARD_STEPS = 2             # steps of each launch.train run under --mesh 2,2 (3 until
#                             the serving part of [shard] needed the time)
SHARD_ARGS = ["--arch", "smollm-135m", "--batch", "8", "--seq", "128", "--steps",
              str(SHARD_STEPS), "--log-every", "100"]
SHARD_MOE = "phi3.5-moe-42b-a6.6b"
SHARD_MOE_B, SHARD_MOE_PROMPT, SHARD_MOE_MAX = 4, 8, 16
SHARD_GEMMS = (("phi wq/wo block", 4096, 2048), ("phi wk/wv block", 4096, 512),
               ("phi lm_head block", 4096, 16032))      # N halved over model; M = 2 rows a rank
SHARD_TIMEOUT = 300         # seconds a launch of the ranks may take
# the serving part: smollm-135m at full width cut to 8 of its 30 layers, int8
# weights and KV, 8 slots (4 a data rank), 8 requests of 32 + 16 tokens at
# tick 0; then phi3.5-moe's one layer (SHARD_MOE) under chunked
SHARD_SERVE_LAYERS = 8
SHARD_SERVE_SLOTS, SHARD_SERVE_PROMPT, SHARD_SERVE_NEW = 8, 32, 16
SHARD_SERVE_CHUNK, SHARD_SERVE_PAGE = 32, 16
SHARD_SERVE_POLICIES = {
    "scheduler": ({}, {}),
    "chunked --paged": ({"paged_kv": True, "page_size": SHARD_SERVE_PAGE},
                        {"chunk_size": SHARD_SERVE_CHUNK, "prefix_sharing": False}),
    "ragged": ({}, {"chunk_size": SHARD_SERVE_CHUNK, "ragged": True, "prefill_lanes": 2}),
}
SHARD_SERVE_MOE = ("phi3.5-moe chunked", {}, {"chunk_size": SHARD_SERVE_CHUNK})
# the page pool's features and hardened serving on 8 requests within the
# same 48 rows: name -> (ServeEngine kw, Scheduler kw, run kw, prompt
# tokens, new tokens, tokens every prompt shares)
_PAGED = {"paged_kv": True, "page_size": SHARD_SERVE_PAGE}
SHARD_SERVE_MORE = {
    # half the dense-parity pool, 12 pages of 16 (6 a data rank's block):
    # prompts of 24 reserve 2 pages, and 3 slots of a block then grow past it
    "chunked --paged --oversubscribe (swap, half the pool)": (
        dict(_PAGED, kv_pool_pages=SHARD_SERVE_SLOTS * 3 // 2),
        {"chunk_size": SHARD_SERVE_CHUNK, "prefix_sharing": False, "oversubscribe": True,
         "preempt_policy": "swap"}, {}, 24, 16, 0),
    "chunked --paged, prefix sharing": (_PAGED, {"chunk_size": SHARD_SERVE_CHUNK}, {},
                                        SHARD_SERVE_PROMPT, 8, SHARD_SERVE_PAGE),
    "ragged --paged --audit, faulted": (
        _PAGED, {"chunk_size": SHARD_SERVE_CHUNK, "ragged": True, "prefill_lanes": 2,
                 "prefix_sharing": False, "audit": True},
        {"fault_plan": {"alloc_fail": [1], "nan": [[6, 5]]}, "preempts": {2: 4}},
        SHARD_SERVE_PROMPT, SHARD_SERVE_NEW, 0),
}
SHARD_SERVE_BUDGET = 90.0   # seconds the serving part may add to [shard]
SHARD_PARAM_RTOL, SHARD_PARAM_ATOL = 1e-4, 1e-6
SHARD_QAT_FLIP_SHARE = 1e-3  # QAT's codes a sum in another order moves (tests' QAT_FLIP_SHARE)


def check_shard_kernels(torch, ref, wq_cuda, gen):
    """``wq_matmul`` at the column blocks the sharded decode gives it
    (phi3.5-moe's projections with N halved over ``model``, K whole after
    the ``data`` gather, M = 2: a data rank's rows of B = 4), against its
    plain version and timed beside it."""
    return [wq_case(torch, ref, wq_cuda, gen, 2, label, k, n) for label, k, n in SHARD_GEMMS]


def shard_start(out: Path):
    """``torchrun --standalone --nproc-per-node 4`` of this script's rank
    program of ``[shard]`` over gloo on the card (:func:`shard_rank`)."""
    import os

    out.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(Path(__file__).resolve().parent / "src"), env.get("PYTHONPATH")) if p)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=4",
           str(Path(__file__).resolve()), "--shard-rank", str(out)]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)


def shard_rank(out: str) -> int:
    """The rank program of ``[shard]``: a gloo group of four ranks on the
    card, mesh (2, 2); waits for ``out/go``, runs :func:`shard_rank_runs`
    and writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import init_process_group

    t_start = time.time()
    init_process_group(torch.device("cuda"), "gloo")
    try:
        Path(out, f"ready{dist.get_rank()}").touch()
        go = Path(out, "go")
        deadline = time.perf_counter() + SHARD_TIMEOUT
        while not go.exists():
            check(time.perf_counter() < deadline, f"[shard] {go} never came")
            time.sleep(0.05)
        res = shard_rank_runs(torch, dist, Path(out))
        res["clock"] = {"start": t_start, "end": time.time()}
        Path(out, f"rank{dist.get_rank()}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def busy_ms(torch, fn):
    """(``fn()``, the device's busy ms while it ran, summed from the raw
    profiler events; None where the profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy_ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA)
    return out, (busy_ns / 1e6 if busy_ns else None)


def _keyed(d) -> dict:
    return {f"{a}/{k}": v for (a, k), v in d.items()}


def shard_rank_runs(torch, dist, out: Path) -> dict:
    """On every rank of the (2, 2) mesh: ``launch.train.main --mesh 2,2``
    float and ``--qat`` (``SHARD_ARGS``), then one float step with
    ``int8_weight_gather``, then phi3.5-moe's weight-stationary decode.
    Each run: its losses, step wall ms, collective calls / bytes / ms by
    axis and kind (step 1 timed), the device's busy ms of one more step
    (rank 0), peak memory; the params gathered whole and held to world 1's
    (rank 0), and the replicated leaves' checksums."""
    from repro_torch.core.qformat import QTensor
    from repro_torch.data.pipeline import markov_batch_fn
    from repro_torch.dist import shard_ops, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.nn.module import Context, tree_leaves, tree_to
    from repro_torch.optim import adamw, sgd
    from repro_torch.train import trainer

    rank = dist.get_rank()
    mesh = make_host_mesh(2, 2, "cuda")
    rules = sharding.make_axis_rules(mesh)
    res = {"rank": rank, "backend": dist.get_backend(), "form": shard_ops.form(mesh, "cuda"),
           "device": torch.cuda.get_device_name(torch.cuda.current_device()), "runs": {}}
    cfg = get_config(SHARD_ARGS[1])
    model = cfg.build()
    whole_specs = sharding.param_pspecs(model.init(torch.Generator(), "meta"), mesh, rules)

    def replicated_sums(params) -> list:
        """Per replicated leaf: the sum of its bit patterns and of its values."""
        return [[t.view(torch.int32).to(torch.int64).sum().item(), t.double().sum().item()]
                for t, sp in sharding.leaves_with_specs(params, whole_specs)
                if not sharding.sharded(sp)]

    def against_world1(label, params) -> dict:
        """The params gathered whole against world 1's (rank 0): values
        beyond rtol/atol, the worst relative difference."""
        whole = sharding.gather_tree(params, whole_specs, mesh)
        if rank != 0:
            return {}
        w1 = torch.load(out / f"world1_{label}.pt", weights_only=False)
        misses, worst, total = 0, 0.0, 0
        for a, b in zip(tree_leaves(whole), tree_leaves(w1)):
            b = b.to(a.device)
            diff = (a - b).abs()
            misses += int((diff > SHARD_PARAM_ATOL + SHARD_PARAM_RTOL * b.abs()).sum())
            worst = max(worst, (diff / b.abs().clamp(min=1e-30)).max().item())
            total += a.numel()
        return {"param_misses": misses, "param_worst_rel": worst, "params": total}

    for label, extra in (("float", []), ("qat", ["--qat"])):
        t_run = time.perf_counter()
        made = launch_train.make_train_step
        got = {"counts": [], "walls": []}

        def watched(*a, made=made, got=got, **k):
            fn = made(*a, **k)

            def step(state, batch):
                # step 1 is the measured one: every collective timed, and on
                # rank 0 the device's busy time
                i = len(got["counts"])
                shard_ops.reset_collective_counts()
                shard_ops.time_collectives(i == 1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    if i == 1 and rank == 0:
                        new, got["busy"] = busy_ms(torch, lambda: fn(state, batch))
                    else:
                        new = fn(state, batch)
                    torch.cuda.synchronize()
                finally:
                    shard_ops.time_collectives(False)
                got["walls"].append((time.perf_counter() - t0) * 1e3)
                got["counts"].append(_keyed(shard_ops.collective_counts()))
                if i == 1:
                    got["coll_ms"] = _keyed(shard_ops.collective_ms())
                return new
            return step

        losses = []
        launch_train.make_train_step = watched
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        try:
            state = launch_train.main(SHARD_ARGS + ["--mesh", "2,2"] + extra,
                                      on_step=lambda s, m, dt: losses.append(m["loss"]))
        finally:
            launch_train.make_train_step = made
        peak = torch.cuda.max_memory_allocated() - held
        res["runs"][label] = {"losses": losses, "step_ms": got["walls"],
                              "busy_ms": got.get("busy"),
                              "counts": got["counts"][1], "coll_ms": got["coll_ms"],
                              "peak_bytes": peak, "replicated": replicated_sums(state["params"]),
                              **against_world1(label, state["params"]),
                              "seconds": time.perf_counter() - t_run}
        del state
        torch.cuda.empty_cache()

    # -- the sharded gradient: one SGD step (lr 1, no momentum) float and QAT --
    t_run = time.perf_counter()
    plain_sgd = sgd(momentum=0.0)
    for label, policy in (("float", None), ("qat", QuantPolicy.int8_qat())):
        state = trainer.shard_state(trainer.init_train_state(
            model, plain_sgd, torch.Generator(device="cuda").manual_seed(0), "cuda"), mesh, rules)
        state, mets = trainer.make_train_step(model, plain_sgd, 1.0, mesh=mesh, axis_rules=rules,
                                              policy=policy)(
            state, markov_batch_fn(cfg.vocab, 8, 128, seed=0)(0))
        res["runs"][f"sgd_{label}"] = {"losses": [mets["loss"].item()],
                                       **against_world1(f"sgd_{label}", state["params"])}
        del state
    res["runs"]["sgd_float"]["seconds"] = time.perf_counter() - t_run

    # -- one float step with int8_weight_gather -------------------------------
    t_run = time.perf_counter()
    opt = adamw(weight_decay=0.01)
    state = trainer.shard_state(trainer.init_train_state(
        model, opt, torch.Generator(device="cuda").manual_seed(0), "cuda"), mesh, rules)
    step_fn = trainer.make_train_step(model, opt, 3e-3, mesh=mesh, axis_rules=rules,
                                      int8_weight_gather=True)
    shard_ops.reset_collective_counts()
    state, mets = step_fn(state, markov_batch_fn(cfg.vocab, 8, 128, seed=0)(0))
    res["runs"]["int8_gather"] = {"losses": [mets["loss"].item()],
                                  "counts": _keyed(shard_ops.collective_counts()),
                                  "seconds": time.perf_counter() - t_run}
    del state, step_fn
    torch.cuda.empty_cache()

    # -- phi3.5-moe's weight-stationary decode --------------------------------
    t_run = time.perf_counter()
    moe_cfg = dataclasses.replace(get_config(SHARD_MOE), n_layers=1)
    moe = moe_cfg.build()
    io = torch.load(out / "phi_io.pt", weights_only=False)
    host = torch.load(out / "phi.pt", mmap=True, weights_only=False)
    specs = sharding.param_pspecs(host, mesh, rules, serve=True)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = tree_to(sharding.shard_tree(host, specs, mesh), "cuda")    # the shard alone
    del host
    rows = slice(shard_ops.axis_index(mesh, "data") * SHARD_MOE_B // 2,
                 (shard_ops.axis_index(mesh, "data") + 1) * SHARD_MOE_B // 2)
    cache = tree_to(sharding.shard_tree(io["cache"], sharding.cache_rows_pspecs(
        io["cache"], mesh, rules), mesh), "cuda")
    nxt = io["nxt"][rows].to("cuda")
    ctx = Context(mesh=mesh, axis_rules=rules)

    def decode():
        return moe.apply(params, nxt, ctx, cache=copy_cache(cache), decode=True)[0]

    with torch.inference_mode():
        ops.reset_launch_counts()
        shard_ops.reset_collective_counts()
        logits = decode()
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        counts = _keyed(shard_ops.collective_counts())
        want = io["logits"][rows].to("cuda")
        err = (logits - want).abs()
        ok = bool((err <= 2e-4 + 2e-4 * want.abs()).all())
        same_argmax = bool(torch.equal(logits[:, -1].argmax(-1), want[:, -1].argmax(-1)))
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    expert_bytes = _expert_shard_bytes(params)
    res["runs"]["decode"] = {"max_abs_err": err.max().item(), "within": ok,
                             "argmax_equal": same_argmax, "launches": launches,
                             "counts": counts, "step_ms": walls,
                             "expert_shard_bytes": expert_bytes,
                             "peak_bytes": torch.cuda.max_memory_allocated() - held,
                             "seconds": time.perf_counter() - t_run}
    del params, cache
    torch.cuda.empty_cache()

    # -- ServeEngine(mesh=) and the scheduler's policies ----------------------
    res["serve"] = shard_serving(torch, mesh, rules,
                                 torch.load(out / "phi.pt", mmap=True, weights_only=False))
    return res


def _expert_shard_bytes(params) -> int:
    """Bytes of this rank's expert codes (every MoE layer's three stacks)."""
    from repro_torch.core.qformat import QTensor

    total = 0

    def walk(node, under):
        nonlocal total
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, under or k == "experts")
        elif isinstance(node, list):
            for v in node:
                walk(v, under)
        elif under and isinstance(node, QTensor):
            total += node.q.numel() * node.q.element_size()
    walk(params, False)
    return total


def shard_serving(torch, mesh, rules, phi_params) -> dict:
    """The serving part of ``[shard]`` at world 1 (``mesh`` None, this
    process, no group) or on one rank of the (2, 2) mesh: smollm-135m at
    full width cut to ``SHARD_SERVE_LAYERS`` layers (seed 0 on the card,
    int8 weights and KV) under each ``SHARD_SERVE_POLICIES`` policy, then
    phi3.5-moe's one layer (``phi_params``, int8) under ``chunked``, then
    smollm-135m under each ``SHARD_SERVE_MORE`` run: 8 slots, 8 requests
    of 32 + 16 tokens, no warm-up (the kernels are built and bound).  Per
    run: each request's tokens and status, the ticks, the wall ms a tick,
    the launches, the collective calls and bytes by (axis, kind) and the
    page-0 mirror's ms, the counters of the summary, the peak memory above
    what was held, and at world 1 the slot of each chunk (the owner of its
    chunk launches on the mesh)."""
    import numpy as np

    from repro_torch.core.integerize import integerize_weights_only
    from repro_torch.dist import shard_ops
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_config
    from repro_torch.serve import FaultPlan, Request, ServeEngine

    def serve(model, params, ekw, skw, rkw=None, plen=SHARD_SERVE_PROMPT, new=SHARD_SERVE_NEW,
              shared=0):
        rng = np.random.default_rng(5)
        prompts = rng.integers(1, model.vocab, size=(SHARD_SERVE_SLOTS, SHARD_SERVE_PROMPT)
                               ).astype(np.int32)[:, :plen]
        prompts[:, :shared] = prompts[0, :shared]
        reqs = [Request(rid=i, prompt=prompts[i], max_new=new) for i in range(SHARD_SERVE_SLOTS)]
        rkw = dict(rkw or {})
        if "fault_plan" in rkw:
            rkw["fault_plan"] = FaultPlan.from_json(rkw["fault_plan"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = ServeEngine(model, params, max_len=SHARD_SERVE_PROMPT + SHARD_SERVE_NEW,
                          batch_slots=SHARD_SERVE_SLOTS, quantized_kv=True, weight_quant=True,
                          device="cuda", mesh=mesh, axis_rules=rules, **ekw)
        sched = eng.scheduler(**skw)
        chunks = []
        if mesh is None and "chunk_size" in skw and not skw.get("ragged"):
            mixed = sched._mixed

            def recorded(*a, **k):
                chunks.append(int(a[5]))          # (params, tok, cache, gen, ctok, slot, ...)
                return mixed(*a, **k)
            sched._mixed = recorded
        ops.reset_launch_counts()
        shard_ops.reset_collective_counts()
        shard_ops.time_collectives(True, kinds=("page0",))
        try:
            res, st = sched.run(reqs, warmup=False, **rkw)
        finally:
            shard_ops.time_collectives(False)
        torch.cuda.synchronize()
        summary = st.summary()
        return {"tokens": [res[i].tokens for i in range(len(reqs))],
                "status": [res[i].status for i in range(len(reqs))],
                "ticks": st.decode_steps, "tick_ms": st.steady_s / st.decode_steps * 1e3,
                "launches": {k: v for k, v in ops.launch_counts().items() if v},
                "counts": _keyed(shard_ops.collective_counts()),
                "coll_ms": _keyed(shard_ops.collective_ms()), "chunk_slots": chunks,
                "counters": {k: v for k, v in summary.items() if k not in SERVE_WALL},
                "peak_bytes": torch.cuda.max_memory_allocated() - held,
                "layers": model.stack.attention_layers,
                "seconds": time.perf_counter() - t0}

    t_part = time.perf_counter()
    runs = {}
    model = dataclasses.replace(get_config("smollm-135m"), n_layers=SHARD_SERVE_LAYERS).build()
    params = integerize_weights_only(model.init(torch.Generator(device="cuda").manual_seed(0),
                                                "cuda"), release=True)
    with torch.inference_mode():
        for name, (ekw, skw) in SHARD_SERVE_POLICIES.items():
            runs[name] = serve(model, params, ekw, skw)
        t_more = time.perf_counter()
        for name, (ekw, skw, rkw, plen, new, shared) in SHARD_SERVE_MORE.items():
            runs[name] = serve(model, params, ekw, skw, rkw, plen, new, shared)
        more_s = time.perf_counter() - t_more
        del params
        moe = dataclasses.replace(get_config(SHARD_MOE), n_layers=1).build()
        name, ekw, skw = SHARD_SERVE_MOE
        runs[name] = serve(moe, phi_params, ekw, skw)
    torch.cuda.empty_cache()
    return {"runs": runs, "seconds": time.perf_counter() - t_part, "more_seconds": more_s}


#: the summary fields that are wall time (the ranks' differ)
SERVE_WALL = ("steady_tok_s", "compile_s", "steady_s", "p50_latency_ms", "p99_latency_ms",
              "p50_ttft_ms", "p99_ttft_ms")


def shard_serving_checks(ranks, world1, held, card) -> float:
    """Print and hold the serving part of ``[shard]``.  The policies'
    runs: every request ``ok`` on every rank, its tokens world 1's, and
    each rank's launches exact: world 1's for ``wq_matmul`` and the decode
    and ragged kernels (every data rank runs every forward), and for the
    chunk kernels one a layer for each chunk whose slot the rank's data
    index holds.  The ``SHARD_SERVE_MORE`` runs: every request's status
    and tokens world 1's on every rank, every rank's counters rank 0's,
    and each rank's decode kernel launched ticks x layers times (a rank's
    block may change its schedule against world 1's, so the rest of its
    launches are printed).  Prints each run's wall ms a tick (rank 0 and
    world 1), the collective calls and bytes a tick by axis and kind (rank
    0), and for the new runs the audit's read-backs and the page-0
    mirror's broadcasts a tick.  Returns the part's seconds (world 1's and
    rank 0's)."""
    per_rank = SHARD_SERVE_SLOTS // 2
    for name, w in world1["serve"]["runs"].items():
        rs = [r["serve"]["runs"][name] for r in ranks]
        r0 = rs[0]
        by_axis = {}
        for key, (calls, nbytes) in r0["counts"].items():
            axis, kind = key.split("/")
            a = by_axis.setdefault(axis, {"calls": 0, "bytes": 0, "kinds": {}})
            a["calls"] += calls
            a["bytes"] += nbytes
            a["kinds"][kind] = [round(calls / r0["ticks"], 2), round(nbytes / r0["ticks"])]
        per_tick = {a: {"calls": round(v["calls"] / r0["ticks"], 2),
                        "bytes": round(v["bytes"] / r0["ticks"]), "by kind": v["kinds"]}
                    for a, v in by_axis.items()}
        plen, new = SHARD_SERVE_MORE[name][3:5] if name in SHARD_SERVE_MORE \
            else (SHARD_SERVE_PROMPT, SHARD_SERVE_NEW)
        print(f"[shard] serving {name} (8 slots, 8 requests of {plen} + {new}, int8 weights "
              f"and KV, {r0['layers']} layers): {r0['ticks']} "
              f"ticks (world 1 {w['ticks']}); wall {r0['tick_ms']:.2f} ms a tick on rank 0 "
              f"(world 1 {w['tick_ms']:.2f}); streams equal world 1's on "
              f"{sum(r['tokens'] == w['tokens'] for r in rs)} of 4 ranks; launches rank 0 "
              f"{r0['launches']} (world 1 {w['launches']}); peak memory a rank "
              f"{max(r['peak_bytes'] for r in rs) / GIB:.3f} GiB (world 1 "
              f"{w['peak_bytes'] / GIB:.3f}); {r0['seconds']:.1f}s on rank 0; card {card}",
              flush=True)
        print(f"[shard] serving {name} collectives a tick (rank 0, calls and bytes handed in): "
              + json.dumps(per_tick), flush=True)
        if name in SHARD_SERVE_MORE:
            shard_serving_more(name, rs, w, held)
            continue
        held(all(st == "ok" for st in w["status"]), f"serving {name}: world 1 {w['status']}")
        for i, r in enumerate(rs):
            held(all(st == "ok" for st in r["status"]), f"serving {name}: rank {i} {r['status']}")
            held(r["tokens"] == w["tokens"], f"serving {name}: rank {i}'s streams differ from "
                                             f"world 1's")
            want = dict(w["launches"])
            for k in ("qchunk_attn", "qpaged_chunk_attn"):
                if k in want:
                    want[k] = w["layers"] * sum(s // per_rank == i // 2 for s in w["chunk_slots"])
            want = {k: v for k, v in want.items() if v}
            held(r["launches"] == want, f"serving {name}: rank {i} launched {r['launches']}, "
                                        f"expected {want}")
        held(w["launches"].get("wq_matmul", 0) > 0 and any(
            w["launches"].get(k, 0) > 0 for k in ("qdecode_attn", "qpaged_decode_attn",
                                                   "qragged_attn")),
             f"serving {name}: world 1 launched {w['launches']}")
    more = world1["serve"]["more_seconds"] + ranks[0]["serve"]["more_seconds"]
    print(f"[time] shard serving's pool and hardened runs {more:.1f}s (world 1 "
          f"{world1['serve']['more_seconds']:.1f}s + rank 0 "
          f"{ranks[0]['serve']['more_seconds']:.1f}s)", flush=True)
    return world1["serve"]["seconds"] + ranks[0]["serve"]["seconds"]


def shard_serving_more(name, rs, w, held) -> None:
    """Print and hold one ``SHARD_SERVE_MORE`` run (``shard_serving_checks``)."""
    r0 = rs[0]
    dec = "qragged_attn" if SHARD_SERVE_MORE[name][1].get("ragged") else "qpaged_decode_attn"
    c0 = r0["counters"]
    p0 = r0["counts"].get("data/page0", [0, 0])
    p0_ms = r0["coll_ms"].get("data/page0", 0.0)
    keys = ("page_stalls", "grown_pages", "preemptions", "resumes", "swapped_pages",
            "resume_stalls", "prefix_hits", "shared_pages_mapped", "cow_copies", "fault_events",
            "nan_evictions", "failed", "audited_ticks", "audit_reads")
    print(f"[shard] serving {name}: statuses {r0['status']} (world 1 {w['status']}); counters "
          f"rank 0 {json.dumps({k: c0[k] for k in keys})} (world 1 "
          f"{json.dumps({k: w['counters'][k] for k in keys})}); audit read-backs "
          f"{c0['audit_reads'] / r0['ticks']:.2f} a tick; the page-0 mirror "
          f"{p0[0] / r0['ticks']:.2f} broadcasts, {p0[1] / r0['ticks']:.0f} bytes, "
          f"{p0_ms / r0['ticks']:.3f} ms a tick on rank 0 ({p0[0]} broadcasts, {p0_ms:.2f} ms "
          f"in all); rank 0's launches beside its {dec} {r0['launches']}", flush=True)
    held(any(st == "ok" for st in w["status"]), f"serving {name}: world 1 {w['status']}")
    for i, r in enumerate(rs):
        held(r["status"] == w["status"], f"serving {name}: rank {i}'s statuses {r['status']} "
                                         f"differ from world 1's {w['status']}")
        held(r["tokens"] == w["tokens"], f"serving {name}: rank {i}'s streams differ from "
                                         f"world 1's")
        held(r["counters"] == c0, f"serving {name}: rank {i}'s counters differ from rank 0's")
        held(r["launches"].get(dec, 0) == r["ticks"] * r["layers"],
             f"serving {name}: rank {i} launched {dec} {r['launches'].get(dec, 0)} times in "
             f"{r['ticks']} ticks of {r['layers']} layers")
    held(w["launches"].get(dec, 0) == w["ticks"] * w["layers"],
         f"serving {name}: world 1 launched {dec} {w['launches'].get(dec, 0)} times in "
         f"{w['ticks']} ticks of {w['layers']} layers")


def shard_world1(torch, out: Path) -> dict:
    """World 1 of ``[shard]`` in this process, no process group: the same
    ``launch.train.main`` runs (their params saved for the ranks), one
    ``int8_weight_gather`` step, and phi3.5-moe cut to one layer built on
    the host from seed 0, integerized there (int8 weights) and saved for
    the ranks, then prefilled on the card (int8 KV) and decoded one step:
    the cache, tokens and logits saved for the ranks."""
    from repro_torch.core.integerize import integerize_weights_only
    from repro_torch.data.pipeline import markov_batch_fn
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.nn.module import Context, tree_to
    from repro_torch.optim import adamw, sgd
    from repro_torch.train import trainer

    res = {}
    for label, extra in (("float", []), ("qat", ["--qat"])):
        losses = []
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        made = launch_train.make_train_step
        got = {"walls": []}

        def watched(*a, made=made, got=got, **k):
            fn = made(*a, **k)

            def step(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if len(got["walls"]) == 1:        # step 1 measured, as on the ranks
                    new, got["busy"] = busy_ms(torch, lambda: fn(state, batch))
                else:
                    new = fn(state, batch)
                torch.cuda.synchronize()
                got["walls"].append((time.perf_counter() - t0) * 1e3)
                return new
            return step

        launch_train.make_train_step = watched
        try:
            state = launch_train.main(SHARD_ARGS + extra,
                                      on_step=lambda s, m, dt: losses.append(m["loss"]))
        finally:
            launch_train.make_train_step = made
        peak = torch.cuda.max_memory_allocated() - held
        torch.save(tree_to(state["params"], "cpu"), out / f"world1_{label}.pt")
        res[label] = {"losses": losses, "step_ms": got["walls"], "busy_ms": got.get("busy"),
                      "peak_bytes": peak}
        del state
    cfg = get_config(SHARD_ARGS[1])
    model = cfg.build()
    batch = markov_batch_fn(cfg.vocab, 8, 128, seed=0)(0)
    plain_sgd = sgd(momentum=0.0)
    for label, policy in (("float", None), ("qat", QuantPolicy.int8_qat())):
        state = trainer.init_train_state(model, plain_sgd,
                                         torch.Generator(device="cuda").manual_seed(0), "cuda")
        state, mets = trainer.make_train_step(model, plain_sgd, 1.0, policy=policy)(state, batch)
        torch.save(tree_to(state["params"], "cpu"), out / f"world1_sgd_{label}.pt")
        res[f"sgd_{label}"] = {"losses": [mets["loss"].item()]}
    opt = adamw(weight_decay=0.01)
    state = trainer.init_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0),
                                     "cuda")
    _, mets = trainer.make_train_step(model, opt, 3e-3, int8_weight_gather=True)(state, batch)
    res["int8_gather"] = {"losses": [mets["loss"].item()]}
    del state
    torch.cuda.empty_cache()

    # phi3.5-moe cut to one layer, made from the seed here and handed to the
    # ranks through host memory: each rank moves only its shard to the card
    t0 = time.perf_counter()
    moe = dataclasses.replace(get_config(SHARD_MOE), n_layers=1).build()
    params = integerize_weights_only(moe.init(torch.Generator(device="cuda").manual_seed(0),
                                              "cuda"), release=True)
    torch.save(tree_to(params, "cpu"), out / "phi.pt")
    res["phi_host_s"] = time.perf_counter() - t0
    toks = (torch.arange(SHARD_MOE_B * SHARD_MOE_PROMPT, dtype=torch.int32)
            .reshape(SHARD_MOE_B, SHARD_MOE_PROMPT) % moe.vocab).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with torch.inference_mode():
        cache = moe.init_cache(SHARD_MOE_B, SHARD_MOE_MAX, quantized_kv=True, device="cuda")
        lg, cache = moe.apply(params, toks, Context(), cache=cache, decode=True)
        nxt = lg[:, -1:].argmax(-1).to(torch.int32)
        saved = tree_to(copy_cache(cache), "cpu")
        logits, _ = moe.apply(params, nxt, Context(), cache=cache, decode=True)
        walls = []
        for _ in range(3):
            c = copy_cache(saved)
            c = tree_to(c, "cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            moe.apply(params, nxt, Context(), cache=c, decode=True)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
    res["decode"] = {"step_ms": walls, "peak_bytes": torch.cuda.max_memory_allocated() - held}
    torch.save({"cache": saved, "nxt": nxt.cpu(), "logits": logits.cpu(), "toks": toks.cpu()},
               out / "phi_io.pt")
    del cache
    res["serve"] = shard_serving(torch, None, None, params)
    del params
    torch.cuda.empty_cache()
    return res


def shard_end_to_end(torch, card) -> dict:
    """``[shard]``: the model axis on the one card.  Four gloo ranks
    (``torchrun --standalone --nproc-per-node 4`` of this script's
    :func:`shard_rank`) share the card as a (2, 2) mesh, their gathers
    made of all-reduces (gloo carries no CUDA all-gather): full-width
    smollm-135m through ``launch.train.main --mesh 2,2`` (AdamW, B=8,
    S=128, float and ``--qat``, ``SHARD_STEPS`` steps each), each held to
    world 1 in this process: step 0's loss at rtol 1e-5, replicated leaves
    identical on every rank, and the gathered params after them printed against
    world 1's (AdamW's first update is lr * g / (|g| + eps): a gradient
    near zero takes its sign from the order of its sums, so the params are
    held through the gradient instead: one SGD step at lr 1 from the same
    init, the gathered params p - g within rtol 1e-4 (atol 1e-6) of world
    1's for every value, float, and for all but 1e-3 of them under QAT);
    one float step with ``int8_weight_gather`` (the loss at rtol 1e-5).
    Then phi3.5-moe at full width cut to one layer, int8 weights and int8
    KV, made from the seed in this process and handed to the ranks through
    host memory (each moves only its shard to the card): world 1 prefills
    8 tokens at B=4 and decodes one step, the ranks decode the same step
    on their rows of that cache through the weight-stationary dispatch
    (logits within rtol 2e-4, argmax equal, ``wq_matmul`` and
    ``qdecode_attn`` launched).  Prints step ms (wall and device),
    collective ms and bytes by axis and kind, int8 against float32 gather
    bytes, the decode's sums against its expert shards' bytes, and peak
    memory a rank against world 1's; every check is made after every line
    is printed.  Returns rank 0's decode launch counts."""
    import shutil
    import tempfile

    import numpy as np

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    out = tmp / "shard4"
    failed = []

    def held(cond, msg):
        if not cond:
            print(f"[shard] FAILED CHECK: {msg}", flush=True)
            failed.append(msg)

    try:
        t_launch = time.time()
        proc = shard_start(out)
        try:
            world1 = shard_world1(torch, out)
            print(f"[shard] world 1 (no group): {time.perf_counter() - phase_t0:.1f}s, of "
                  f"which phi3.5-moe made, integerized and saved {world1['phi_host_s']:.1f}s",
                  flush=True)
            dist_ready(proc, 4, out, "[shard]")
        except BaseException:
            dist_kill(proc)
            raise
        t_ranks = time.perf_counter()
        ranks = dist_wait(proc, 4, "gloo", out, "[shard]")
        print(f"[shard] world 4 over gloo, mesh (2, 2): {time.perf_counter() - t_ranks:.1f}s "
              f"after the word; rank 0 came up {ranks[0]['clock']['start'] - t_launch:.1f}s "
              f"after the launch; collectives in the {ranks[0]['form']!r} form; rank 0's runs "
              + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in ranks[0]["runs"].items()
                          if "seconds" in v), flush=True)
        held(all(r["backend"] == "gloo" for r in ranks), "a rank is not on gloo")
        held(all(r["form"] == "all_reduce" for r in ranks),
             "gloo on the card must take the all-reduce form")
        for label in ("float", "qat"):
            runs = [r["runs"][label] for r in ranks]
            r0, w1 = runs[0], world1[label]
            losses = r0["losses"]
            coll = {k: [r0["counts"][k][0], r0["counts"][k][1],
                        float(np.median([r["coll_ms"].get(k, 0.0) for r in runs]))]
                    for k in r0["counts"]}
            print(f"[shard] {label} (AdamW): loss {losses} (world 1 {w1['losses']}); gathered "
                  f"params after {SHARD_STEPS} steps: {r0['param_misses']} of {r0['params']} "
                  f"beyond rtol {SHARD_PARAM_RTOL} (atol {SHARD_PARAM_ATOL}) of world 1's, worst "
                  f"rel {r0['param_worst_rel']:.3e}; step wall ms "
                  f"{[round(t, 2) for t in r0['step_ms']]} (world 1 "
                  f"{[round(t, 2) for t in w1['step_ms']]}; step 1 with every collective "
                  f"synchronized and profiled on rank 0); device busy that step "
                  + ("not measured" if r0["busy_ms"] is None else f"{r0['busy_ms']:.2f} ms")
                  + " on rank 0 (world 1 "
                  + ("not measured" if w1["busy_ms"] is None else f"{w1['busy_ms']:.2f} ms")
                  + f"); peak memory a rank {max(r['peak_bytes'] for r in runs) / GIB:.3f} GiB "
                  f"(world 1 {w1['peak_bytes'] / GIB:.3f} GiB); {r0['seconds']:.1f}s; card "
                  f"{card}", flush=True)
            print(f"[shard] {label} collectives a step (step 1, rank 0: calls, bytes handed in; "
                  f"median ms over the ranks): " + json.dumps(coll), flush=True)
            held(len(losses) == SHARD_STEPS and all(np.isfinite(losses)),
                 f"{label} losses {losses}")
            held(np.isclose(losses[0], w1["losses"][0], rtol=1e-5, atol=0),
                 f"{label}: step 0's loss {losses[0]} against world 1's {w1['losses'][0]}")
            held(all(r["replicated"] == r0["replicated"] for r in runs),
                 f"{label}: a replicated leaf differs between the ranks")
            g = ranks[0]["runs"][f"sgd_{label}"]
            share = g["param_misses"] / g["params"]
            print(f"[shard] {label} gradient (one SGD step at lr 1): loss {g['losses'][0]:.6f} "
                  f"(world 1 {world1[f'sgd_{label}']['losses'][0]:.6f}); p - g gathered: "
                  f"{g['param_misses']} of {g['params']} values beyond rtol {SHARD_PARAM_RTOL} "
                  f"(atol {SHARD_PARAM_ATOL}), worst rel {g['param_worst_rel']:.3e}", flush=True)
            held(np.isclose(g["losses"][0], world1[f"sgd_{label}"]["losses"][0], rtol=1e-5,
                            atol=0), f"{label} SGD step: loss against world 1's")
            held(share <= (SHARD_QAT_FLIP_SHARE if label == "qat" else 0.0),
                 f"{label} SGD step: {g['param_misses']} of {g['params']} gathered params "
                 f"beyond rtol {SHARD_PARAM_RTOL} of world 1's")
        i8 = ranks[0]["runs"]["int8_gather"]
        f32_gather = ranks[0]["runs"]["float"]["counts"].get("data/gather", [0, 0])[1]
        i8_gather = i8["counts"].get("data/int8_gather", [0, 0])[1]
        print(f"[shard] int8_weight_gather step: loss {i8['losses'][0]:.6f} (world 1 "
              f"{world1['int8_gather']['losses'][0]:.6f}); weights over data: {i8_gather} bytes "
              f"of int8 codes against {f32_gather} bytes of float32 in the float step (rank 0, "
              f"the all-reduce form's buffers); every collective {json.dumps(i8['counts'])}; "
              f"{i8['seconds']:.1f}s", flush=True)
        held(np.isclose(i8["losses"][0], world1["int8_gather"]["losses"][0], rtol=1e-5, atol=0),
             f"int8_weight_gather: loss {i8['losses'][0]} against world 1's "
             f"{world1['int8_gather']['losses'][0]}")
        held(0 < i8_gather < f32_gather, f"int8 gather bytes {i8_gather} against float32 "
                                         f"{f32_gather}")
        dec = [r["runs"]["decode"] for r in ranks]
        launches = dec[0]["launches"]
        psum = dec[0]["counts"].get("data/psum", [0, 0])
        print(f"[shard] phi3.5-moe weight-stationary decode (1 layer, full width, int8 weights "
              f"and KV, B={SHARD_MOE_B}): max_abs_err against world 1 "
              f"{max(d['max_abs_err'] for d in dec):.3e}, within rtol/atol 2e-4 "
              f"{all(d['within'] for d in dec)}, argmax equal "
              f"{all(d['argmax_equal'] for d in dec)}; step wall ms "
              f"{[round(t, 2) for t in dec[0]['step_ms']]} (world 1 "
              f"{[round(t, 2) for t in world1['decode']['step_ms']]}); sums over data "
              f"{psum[0]} calls, {psum[1]} bytes, against the expert shard's "
              f"{dec[0]['expert_shard_bytes']} bytes of codes a rank (a gather over data would "
              f"hand in those and assemble {2 * dec[0]['expert_shard_bytes']}); launches "
              f"{launches}; peak memory a rank {max(d['peak_bytes'] for d in dec) / GIB:.3f} GiB "
              f"(world 1 {world1['decode']['peak_bytes'] / GIB:.3f} GiB); every collective "
              f"{json.dumps(dec[0]['counts'])}; {dec[0]['seconds']:.1f}s; card {card}",
              flush=True)
        held(all(d["within"] for d in dec), "decode logits beyond rtol/atol 2e-4 of world 1's")
        held(all(d["argmax_equal"] for d in dec), "decode argmax differs from world 1's")
        held(launches.get("wq_matmul", 0) > 0 and launches.get("qdecode_attn", 0) > 0,
             f"the decode did not launch wq_matmul and qdecode_attn: {launches}")
        serve_s = shard_serving_checks(ranks, world1, held, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[time] shard phase {time.perf_counter() - phase_t0:.1f}s; its serving "
          f"part {serve_s:.1f}s (world 1 {world1['serve']['seconds']:.1f}s + rank 0 "
          f"{ranks[0]['serve']['seconds']:.1f}s; budget {SHARD_SERVE_BUDGET:.0f} s)", flush=True)
    check(not failed, f"[shard] {len(failed)} check(s) failed: {failed}")
    return launches


# --------------------------------------------------------------------------
# [account]: the one-card dry-run account against the card's own allocation
# --------------------------------------------------------------------------

ACCOUNT_S = 32768          # decode_32k's cache length
ACCOUNT_PLAIN_B = 8        # qdecode_attn's plain version at S = 32768 (0.4 GB dequantized)
ACCOUNT_MB_ROWS = 4        # train_4k rows a micro-batch: microbatch_split 64 of 256 rows
ACCOUNT_MB_RUN = 2         # the micro-batches run of that split


def allocator_bytes(torch):
    """(requested, allocated) bytes the caching allocator holds now."""
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    return stats["requested_bytes.all.current"], stats["allocated_bytes.all.current"]


def held_to_account(torch, label, card, before, trees, account: int) -> None:
    """The card's allocation since ``before`` against the account's bytes:
    the bytes requested equal it exactly, and the bytes allocated exceed it
    by the caching allocator's rounding alone, under 2 MiB a tensor (a block
    is its request rounded up to 512 bytes, and a fresh segment's tail under
    1 MiB stays in the block)."""
    from repro_torch.launch import analysis

    req, alloc = allocator_bytes(torch)
    d_req, d_alloc = req - before[0], alloc - before[1]
    tensors = analysis._tensors(trees)
    storages = {t.untyped_storage().data_ptr() for t in tensors}
    check(len(storages) == len(tensors), f"[account] {label}: tensors share storage")
    check(d_req == account, f"[account] {label}: the card's requested bytes grew by {d_req:,}, "
                            f"the account says {account:,}")
    check(0 <= d_alloc - d_req < len(tensors) * (2 << 20),
          f"[account] {label}: allocated {d_alloc:,} against requested {d_req:,} over "
          f"{len(tensors)} tensors")
    print(f"[account] {label}: the card allocated {d_req:,} requested bytes == the account's "
          f"{account:,} ({len(tensors)} tensors; {d_alloc:,} allocated, the allocator's "
          f"rounding {d_alloc - d_req:,}) | {card}", flush=True)


def account_decode(torch, card, launches) -> dict:
    """smollm-135m ``decode_32k --wq --qkv`` at mesh 1 x 1: the cell
    allocated on the card against the account, one decode step beside its
    roofline terms and peak memory, ``qdecode_attn`` alone at S = 32768."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import qdecode_attn as qd_mod
    from repro_torch.kernels.qdecode_attn import qdecode_attn_cuda
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch.mesh import HW
    from repro_torch.models.registry import get_config
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import make_decode_step

    cfg = get_config("smollm-135m")
    opts = dryrun.parse_args(["--mesh", "1,1", "--wq", "--qkv"])
    t0 = time.perf_counter()
    rec = dryrun.build_cell("smollm-135m", "decode_32k", None, opts)
    mem, flops = rec["memory"], rec["cost"]["flops"]
    print(f"[account] smollm-135m decode_32k --wq --qkv (mesh 1 x 1, meta): arguments "
          f"{mem['argument_size_in_bytes']:,} bytes ({mem['arguments']}), outputs "
          f"{mem['output_size_in_bytes']:,} (aliased {mem['alias_size_in_bytes']:,}), FLOPs "
          f"{flops:.4g} ({rec['cost']['flops_by_op']}); {time.perf_counter() - t0:.2f}s",
          flush=True)
    sh = dryrun.SHAPES["decode_32k"]
    # a warm-up: the int8 path's persistent tables on the card come first
    small = get_config("smollm-135m-smoke").build()
    ServeEngine(small, small.init(torch.Generator(device="cuda").manual_seed(0), "cuda"),
                max_len=16, batch_slots=1, quantized_kv=True, weight_quant=True, device="cuda")
    before = allocator_bytes(torch)
    model = cfg.build()
    engine = ServeEngine(model, model.init(torch.Generator(device="cuda").manual_seed(0), "cuda"),
                         max_len=sh.seq_len, batch_slots=sh.global_batch, quantized_kv=True,
                         weight_quant=True, device="cuda", own_params=True)
    cache = engine.new_cache()
    token = torch.randint(0, cfg.vocab, (sh.global_batch, 1), dtype=torch.int32, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    held_to_account(torch, "smollm-135m decode_32k --wq --qkv", card, before,
                    [engine.params, token, cache], mem["argument_size_in_bytes"])

    # one decode step over the whole cache: the last position of S
    for node in cache["body"]:
        node["kv"]["len"] = sh.seq_len - 1
    step = make_decode_step(model)
    ops.reset_launch_counts()
    nxt, _ = step(engine.params, token, cache, None)
    torch.cuda.synchronize()
    want = lockstep_counts(cfg, cfg.n_layers, 1, 1)
    check(ops.launch_counts() == want, f"[account] decode step launches {ops.launch_counts()} "
                                       f"!= {want}")
    for k, v in ops.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    check(tuple(nxt.shape) == (sh.global_batch, 1) and bool(((nxt >= 0) & (nxt < cfg.vocab))
                                                             .all()),
          "[account] the decode step's tokens are not (B, 1) ids of the vocab")
    held = allocator_bytes(torch)[1]
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        step(engine.params, token, cache, None)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / iters
    peak = torch.cuda.max_memory_allocated() - held
    t_flops = flops / HW["peak_bf16_flops"] * 1e3
    t_bytes = mem["argument_size_in_bytes"] / HW["hbm_bytes_per_s"] * 1e3
    print(f"[account] decode step at kv_len {sh.seq_len} (B={sh.global_batch}): {step_ms:.3f} ms "
          f"(CUDA events, {iters} steps) | roofline terms: FLOPs / bf16 peak {t_flops:.4f} ms, "
          f"argument bytes / HBM {t_bytes:.3f} ms | its peak memory above the arguments "
          f"{peak:,} bytes beside the arguments' {mem['argument_size_in_bytes']:,} | launches "
          f"{want['wq_matmul']} wq_matmul + {want['qdecode_attn']} qdecode_attn | {card}",
          flush=True)

    # qdecode_attn alone at S = 32768, on layer 0 of the cache
    b, hkv, d, g = sh.global_batch, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    hq = hkv * g
    gen = torch.Generator(device="cuda").manual_seed(2)
    k0, v0 = cache["body"][0]["kv"]["k"][0], cache["body"][0]["kv"]["v"][0]
    pb = ACCOUNT_PLAIN_B
    for c in (k0, v0):
        c[:pb].copy_(int_codes(torch, gen, (pb, sh.seq_len, hkv, d), torch.int8))
    q = torch.randn(b, hq, d, generator=gen, device="cuda")
    s = sh.seq_len
    got = qdecode_attn_cuda(q[:pb], k0[:pb], v0[:pb], 3, 3, s)
    want_o = ref.qdecode_attn_ref(q[:pb], k0[:pb], v0[:pb], 3, 3, s)
    err = max_err(got, want_o)
    check(err <= ATTN_ATOL, f"[account] qdecode_attn S={s} B={pb}: max err {err} > {ATTN_ATOL}")
    rows = {}
    for bb in (pb, b):
        live = bb * s
        b_ms, b_by = bound(2 * 4 * bb * hq * d + 2 * live * hkv * d + 4 * bb, 4.0 * live * hq * d)
        ms = graph_ms(torch, [lambda bb=bb: qdecode_attn_cuda(q[:bb], k0[:bb], v0[:bb], 3, 3, s)],
                      10)
        rows[bb] = dict(b=bb, s=s, ranks=qd_mod.plan(bb, s, hkv, d).ranks, ms=ms, bound_ms=b_ms,
                        bound_by=b_by)
    small_row = rows[pb]
    small_row["plain_ms"] = graph_ms(
        torch, [lambda: ref.qdecode_attn_ref(q[:pb], k0[:pb], v0[:pb], 3, 3, s)], 4)
    deq = [c[:pb].to(torch.float32).mul(0.125).repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
           .contiguous() for c in (k0, v0)]
    small_row["library_ms"] = graph_ms(torch, [lambda: F.scaled_dot_product_attention(
        q[:pb, :, None, :], deq[0], deq[1])], 4)
    del deq
    small_row["err"] = err
    for r in rows.values():
        print(f"[kernel] qdecode_attn S={s} B={r['b']} Hq={hq} Hkv={hkv} D={d} (the decode_32k "
              f"cell's layer): kernel {r['ms'] * 1e3:.2f} us"
              + (f" | plain {r['plain_ms'] * 1e3:.2f} us | sdpa on dequantized "
                 f"{r['library_ms'] * 1e3:.2f} us | max_abs_err {err:.3e}" if r is small_row
                 else "")
              + f" | bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); split_ranks picks "
                f"R={r['ranks']} | {card}", flush=True)
    del engine, cache, token, k0, v0
    torch.cuda.empty_cache()
    return {"decode_ms": step_ms, "rows": list(rows.values())}


def account_train(torch, card) -> None:
    """smollm-135m ``train_4k`` at mesh 1 x 1: the state and batch allocated
    on the card against the account, then the first micro-batches of a
    ``microbatch_split`` the card holds, under ``remat="off"`` and
    ``"none"``, with their peak memory."""
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import get_config
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import make_train_step

    cfg = get_config("smollm-135m")
    rec = dryrun.build_cell("smollm-135m", "train_4k", None,
                            dryrun.parse_args(["--mesh", "1,1"]), run=False)
    sh = dryrun.SHAPES["train_4k"]
    before = allocator_bytes(torch)
    opt = sgd(momentum=0.9, weight_decay=5e-4)
    params = cfg.build().init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab, (sh.global_batch, sh.seq_len), dtype=torch.int32,
                              device="cuda", generator=gen) for k in ("tokens", "labels")}
    held_to_account(torch, "smollm-135m train_4k (f32 parameters, SGD momentum, the "
                           f"({sh.global_batch}, {sh.seq_len}) batch)", card, before,
                    [state, batch], rec["memory"]["argument_size_in_bytes"])
    split = sh.global_batch // ACCOUNT_MB_ROWS
    part = {k: v[:ACCOUNT_MB_ROWS * ACCOUNT_MB_RUN] for k, v in batch.items()}
    # a warm-up of the step's kernels, one row a micro-batch
    make_train_step(cfg.build(remat="off"), opt, 0.01, microbatch_split=ACCOUNT_MB_RUN)(
        state, {k: v[:ACCOUNT_MB_RUN] for k, v in part.items()})
    peaks = {}
    for remat in ("off", "none"):
        step = make_train_step(cfg.build(remat=remat), opt, 0.01, microbatch_split=ACCOUNT_MB_RUN)
        torch.cuda.synchronize()
        held = allocator_bytes(torch)[1]
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        new, mets = step(state, part)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        peaks[remat] = torch.cuda.max_memory_allocated() - held
        check(bool(torch.isfinite(mets["loss"])), f"[account] train_4k remat={remat}: loss "
                                                  f"{mets['loss'].item()}")
        print(f"[account] smollm-135m train_4k, remat={remat}: the first {ACCOUNT_MB_RUN} of "
              f"microbatch_split {split} ({ACCOUNT_MB_ROWS} x {sh.seq_len} tokens each) in "
              f"{ms:.1f} ms (the whole step about {ms / ACCOUNT_MB_RUN * split / 1e3:.1f} s), "
              f"loss {mets['loss'].item():.4f}, peak memory above the state and batch "
              f"{peaks[remat]:,} bytes | {card}", flush=True)
        del new, mets, step
    check(peaks["none"] < peaks["off"], f"[account] remat none's peak {peaks['none']:,} is not "
                                        f"below off's {peaks['off']:,}")
    del state, batch, params, part
    torch.cuda.empty_cache()


ACCOUNT_CELLS_TIMEOUT = 600  # seconds the meta cells may take after the build


def account_cells(out: str) -> int:
    """The program of ``--account-cells``, started by
    :func:`account_cells_start` with no card visible: every arch x shape's
    argument bytes at mesh 1 x 1 on meta (f32 weights and KV; int8 weights
    and KV for serving), then smollm-135m's ``train_4k`` and ``decode_32k
    --wq --qkv`` run at the 16 x 16 production mesh over a fake group;
    writes ``out`` (JSON)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    cells = []
    for flags in ([], ["--wq", "--qkv"]):
        opts = dryrun.parse_args(["--mesh", "1,1", *flags])
        for arch, shape in dryrun.all_cells():
            if flags and dryrun.SHAPES[shape].kind == "train":
                continue
            rec = dryrun.build_cell(arch, shape, None, opts, run=False)
            cells.append({"arch": arch, "shape": shape, "variant": rec["variant"],
                          "argument_bytes": rec["memory"]["argument_size_in_bytes"],
                          **({"refused": rec["refused"][:60]} if "refused" in rec else {})})
    t1 = time.perf_counter()
    mesh16 = []
    for shape, flags in (("train_4k", []), ("decode_32k", ["--wq", "--qkv"])):
        rec = dryrun.run_cell("smollm-135m", shape, dryrun.parse_args(flags))
        mesh16.append({"shape": shape, "flags": flags, "refused": rec.get("refused"),
                       "argument_bytes": rec["memory"]["argument_size_in_bytes"],
                       "flops": rec["cost"].get("flops"),
                       "wire_bytes": rec["collective_wire_bytes"],
                       "by_axis": rec["collectives_by_axis"]})
    Path(out).write_text(json.dumps({"cells": cells, "mesh16": mesh16,
                                     "seconds": [t1 - t0, time.perf_counter() - t1]}))
    return 0


def account_cells_start():
    """Start :func:`account_cells` in a process of its own, on the host's
    cores while the card works (the cells allocate nothing, on ``meta``);
    :func:`account_fits` reads it.  The process is killed at exit if it
    still runs."""
    import atexit
    import os
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_account_"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = open(tmp / "log", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--account-cells",
                             str(tmp / "cells.json")], env=env, stdout=log,
                            stderr=subprocess.STDOUT, start_new_session=True)
    log.close()
    atexit.register(dist_kill, proc)
    return proc, tmp, time.perf_counter()


def account_fits(torch, card, started) -> None:
    """:func:`account_cells`' result against the card's memory: which
    cells' arguments fit one card, and smollm-135m's collectives on both
    axes of the 16 x 16 mesh."""
    import shutil

    proc, tmp, t0 = started
    wait_t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=max(1.0, ACCOUNT_CELLS_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        dist_kill(proc)
        rc = "killed at its time limit"
    waited = time.perf_counter() - wait_t0
    if rc != 0:
        print((tmp / "log").read_text()[-6000:], flush=True)
        fail(f"[account] the cells on meta exited {rc}")
    res = json.loads((tmp / "cells.json").read_text())
    shutil.rmtree(tmp, ignore_errors=True)
    total = torch.cuda.get_device_properties(0).total_memory
    cells = [dict(c, fits=c["argument_bytes"] <= total) for c in res["cells"]]
    fit = [f"{c['arch']} {c['shape']} {c['variant']}"
           + (" (refused)" if "refused" in c else "") for c in cells if c["fits"]]
    print(f"[account] {len(fit)} of {len(cells)} cells' arguments fit one card's "
          f"{total:,} bytes: {'; '.join(fit)} | {card}", flush=True)
    print("[account] " + json.dumps({"fits": cells}), flush=True)
    for rec in res["mesh16"]:
        by_axis = rec["by_axis"]
        check(rec["refused"] is None and all(by_axis.get(a) for a in ("data", "model")),
              f"[account] smollm-135m {rec['shape']} at 16 x 16: refused {rec['refused']}, "
              f"collectives {by_axis}")
        print(f"[account] smollm-135m {rec['shape']} {' '.join(rec['flags'])} at the 16 x 16 "
              f"production mesh (fake group, meta): arguments {rec['argument_bytes']:,} bytes "
              f"a device, FLOPs {rec['flops']:.4g}, wire bytes {rec['wire_bytes']:.4g} "
              f"({json.dumps(by_axis)})", flush=True)
    print(f"[account] the cells on meta ran beside the other phases: 1 x 1 "
          f"{res['seconds'][0]:.1f}s, 16 x 16 {res['seconds'][1]:.1f}s; the phase waited "
          f"{waited:.1f}s for them", flush=True)


def account_end_to_end(torch, card, cells) -> dict:
    """``[account]``: the dry-run account (``launch/dryrun.py``) held to
    the card; ``cells`` is :func:`account_cells_start`'s process."""
    phase_t0 = time.perf_counter()
    launches = {}
    t0 = time.perf_counter()
    decode = account_decode(torch, card, launches)
    t1 = time.perf_counter()
    account_train(torch, card)
    t2 = time.perf_counter()
    account_fits(torch, card, cells)
    t3 = time.perf_counter()
    print(f"[time] account phase {t3 - phase_t0:.1f}s (decode {t1 - t0:.1f}s, train "
          f"{t2 - t1:.1f}s, the cells on meta {t3 - t2:.1f}s of it)", flush=True)
    return {"launches": launches, **decode}


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

        from repro_torch.kernels import _build, ops, ref
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
    # [account]'s cells on meta run on the host's cores beside the phases
    cells = account_cells_start()

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
    t_arch = time.perf_counter()
    arch_rows, arch_err = check_arch_kernels(torch, F, ref, SimpleNamespace(
        wq=wq_matmul_cuda, qd=qdecode_attn_cuda, qpd=qpaged_decode_attn_cuda,
        qc=qchunk_attn_cuda, qpc=qpaged_chunk_attn_cuda, qr=qragged_attn_cuda), gen,
        CUDA_PAGE_SIZE)
    check_grants("the archs' kernel shapes", ran=("wq_matmul",))
    t_rec = time.perf_counter()
    rec_rows, rec_err = check_recurrent_kernels(torch, ref, wq_matmul_cuda, gen)
    check_grants("the recurrent archs' kernel shapes", ran=("wq_matmul",))
    t_enc = time.perf_counter()
    enc_rows, enc_err = check_encdec_kernels(torch, F, ref, SimpleNamespace(
        qd=qdecode_attn_cuda, qpd=qpaged_decode_attn_cuda, qc=qchunk_attn_cuda,
        qpc=qpaged_chunk_attn_cuda, qr=qragged_attn_cuda), gen, CUDA_PAGE_SIZE)
    t_moe = time.perf_counter()
    moe_rows, _, moe_err, moe_softmax = check_moe_kernels(torch, F, ref, SimpleNamespace(
        wq=wq_matmul_cuda, qd=qdecode_attn_cuda, qpd=qpaged_decode_attn_cuda,
        qc=qchunk_attn_cuda, qpc=qpaged_chunk_attn_cuda, qr=qragged_attn_cuda), gen,
        CUDA_PAGE_SIZE, card)
    check_grants("the MoE and hybrid archs' kernel shapes", ran=("wq_matmul",))
    shard_rows = check_shard_kernels(torch, ref, wq_matmul_cuda, gen)
    t_int = time.perf_counter()
    print(f"[time] the archs' kernel shapes {t_rec - t_arch:.1f}s, the recurrent archs' "
          f"{t_enc - t_rec:.1f}s, whisper-tiny's {t_moe - t_enc:.1f}s, the MoE and hybrid "
          f"archs' {t_int - t_moe:.1f}s", flush=True)
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
    arch_launches = archs_end_to_end(torch, card)
    check_grants("the archs phase", ran=("wq_matmul",))
    t6 = time.perf_counter()
    rec_launches = recurrent_end_to_end(torch, card)
    check_grants("the recurrent phase", ran=("wq_matmul",))
    t7 = time.perf_counter()
    enc_launches = encdec_end_to_end(torch, card)
    t8 = time.perf_counter()
    moe_launches = moe_end_to_end(torch, card, moe_softmax[16])
    check_grants("the moe phase", ran=("wq_matmul",))
    t9 = time.perf_counter()
    ops.reset_launch_counts()
    dist_end_to_end(torch, card)
    check(ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0),
          f"[dist] the data-parallel steps launched the port's kernels: {ops.launch_counts()}")
    t10 = time.perf_counter()
    shard_launches = shard_end_to_end(torch, card)
    check_grants("the shard phase", ran=("wq_matmul",))
    t11 = time.perf_counter()
    account = account_end_to_end(torch, card, cells)
    check_grants("the account phase", ran=("wq_matmul",))
    t12 = time.perf_counter()
    print(f"[time] build {t1 - t0:.1f}s | kernel checks {t2 - t1:.1f}s | serving "
          f"{t3 - t2:.1f}s | integer engine {t4 - t3:.1f}s | training {t5 - t4:.1f}s | archs "
          f"{t6 - t5:.1f}s | recurrent {t7 - t6:.1f}s | encdec {t8 - t7:.1f}s | moe "
          f"{t9 - t8:.1f}s | dist {t10 - t9:.1f}s | shard {t11 - t10:.1f}s | account "
          f"{t12 - t11:.1f}s | all {t12 - t0:.1f}s", flush=True)
    launches = {k: sum(part.get(k, 0) for part in (launches, int_launches, train_launches,
                                                   arch_launches, rec_launches, enc_launches,
                                                   moe_launches, shard_launches,
                                                   account["launches"]))
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
                    for r in qd_rows if r is not qd_main],
         "decode_32k": account["rows"]},
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
    arch_keys = ("arch", "m", "shape", "k", "n", "g", "hq", "hkv", "d", "s", "ranks", "err",
                 "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    for entry in kernels:
        if entry["name"] in arch_rows:
            entry["archs"] = [{k: r[k] for k in arch_keys if k in r}
                              for r in arch_rows[entry["name"]]]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       max(r["err"] for r in arch_rows[entry["name"]]))
    print(f"[kernel] the archs' shapes: worst max_abs_err {arch_err:.3e}", flush=True)
    for entry in kernels:
        if entry["name"] in enc_rows:
            entry["whisper-tiny"] = [{k: r[k] for k in arch_keys if k in r}
                                     for r in enc_rows[entry["name"]]]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       max(r["err"] for r in enc_rows[entry["name"]]))
    print(f"[kernel] whisper-tiny's shapes (G = 1): worst max_abs_err {enc_err:.3e}",
          flush=True)
    for entry in kernels:
        if entry["name"] in moe_rows:
            entry["moe"] = [{k: r[k] for k in arch_keys if k in r}
                            for r in moe_rows[entry["name"]]]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       max(r["err"] for r in moe_rows[entry["name"]]))
    print(f"[kernel] the MoE and hybrid archs' shapes (G = 4; phi3.5-moe's and jamba's "
          f"GEMMs): worst max_abs_err {moe_err:.3e}", flush=True)
    wq_entry = next(e for e in kernels if e["name"] == "wq_matmul")
    wq_entry["recurrent"] = [{k: r[k] for k in ("m", "shape", "k", "n", "err", "ms", "plain_ms",
                                                "library_ms", "bound_ms", "bound_by")}
                             for r in rec_rows]
    wq_entry["max_abs_err"] = max(wq_entry["max_abs_err"], rec_err)
    wq_entry["shard"] = [{k: r[k] for k in ("m", "shape", "k", "n", "err", "ms", "plain_ms",
                                            "library_ms", "bound_ms", "bound_by")}
                         for r in shard_rows]
    wq_entry["max_abs_err"] = max(wq_entry["max_abs_err"], max(r["err"] for r in shard_rows))
    print(f"[kernel] the recurrent archs' shapes: worst max_abs_err {rec_err:.3e}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--account-cells"]:
        sys.exit(account_cells(sys.argv[2]))
    sys.exit(main())
