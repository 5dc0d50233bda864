"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py            # what the checks need
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of requests and steps
    python3 chip_smoke.py --loader-e2e [threads,grain,...]  # only the CLI at 20 batches a
                                     # pass under each loader named, each in its own process
    python3 chip_smoke.py --serve-only  # only the build and the serving path's checks
                                     # and request latency, then the export phase

Builds the hand-written CUDA kernels from ``maestro_tpu_torch/csrc`` (and
reports the attention and pool kernels' registers, shared memory and spills
from the ``ptxas`` log), holds each against its plain PyTorch version on the card (the
attention kernels also at one row past a 128-row tile for every head dim, at
the full-length trunk at batch 1, at the baseline adapters' lengths and heads,
at the shapes the releases' head splits add, and twice on the same inputs: dk and dv
bit-identical, dq within 1 bf16 ulp of max(|dq|, rms(dq)); the pool
backward twice as well: dx and the parameter gradients bit-identical), then
drives the port's main paths with seeded random weights and inputs (MAE
medium, FLAIR-HUB plan, group fusion, 3 trunk blocks, bf16 compute, fp32
parameters):

* serving — ``serve.make_predict_fn(model, "finetune")`` for requests of batch
  1, 4 and 8: launch counts, shapes, finiteness and agreement with the same
  model run through the plain versions;
* serving artifacts and int8 serving (phase ``export``, also under
  ``--serve-only``) — the finetune predict exported by
  ``serve.export_predict`` with a symbolic batch (traced at batch 4), saved
  and loaded, and the same for the model of ``quant.quantize_params``:
  seconds and bytes; requests of batch 1, 4 and 8 through eager, the
  artifact, int8 eager and the int8 artifact, each launching the attention
  and pool kernels 39 and 16 times with no plain version, the artifacts
  within the serving tolerance of their eager paths and the int8 logits at
  cosine >= 0.995 against fp, every int8 product of int8 eager at batch 1
  and 8 within its output's rounding (plus 1e-5 of its max |y|) of an fp64
  recomputation; median
  latency of each; ``_int_mm`` calls a request at batch 8 (profiler);
  with ``--profile`` the host cost of the ops' dispatch;
* pretraining — ``train.steps.make_pretrain_step`` (token-space l1_norm loss,
  AdamW with the closed-form OneCycle schedule): three steps at batch 8
  through the kernels and through the plain versions from the same weights
  and masks, with launch counts per step; then timed steps at batch 48;
* finetuning and probing — ``train.steps.make_supervised_step`` (the
  ``cosia`` segmentation head, 15 classes, its date pool over 26 dates, each
  chunk of ref rows recomputed in the backward):
  three steps of each phase at batch 8 through the kernels and through the
  plain versions from the same weights, with launch counts per step and the
  step-1 gradients (all trained parameters, the pool's, the encoders') held
  against the plain path by cosine; then timed steps
  at the JAX bench's batches (finetune 32 with 4 ref rows a head chunk, probe
  48 with 2), the EMA update and the batch-32 EMA eval step;
* the pretrain eval step (``make_pretrain_eval_step``, pixel-space loss) at
  batch 48, kernel path against plain path, timed;
* ``skip_nonfinite`` finetune steps at batch 8: a step on a batch with a NaN
  in one raster is dropped (parameters, moments, schedule count
  bit-identical), the next good one applied, and the option adds no host
  sync to a step (``torch.cuda.set_sync_debug_mode``);
* finetune steps at batch 32 with ``remat="dots"`` and with none: step time,
  peak memory, and the two held together by their first losses;
* the baseline adapters — DINOv2 large, DOFA base, CROMA base (late and
  inter), SatMAE large and Prithvi large v2 on PASTIS-HD synthetic batches:
  three finetune and three probe steps at batch 8 through the kernels and
  through the plain versions from the same weights (losses, step-1
  gradients of all trained parameters and of the attention weights alone,
  frozen roles, launches a step against a table; DINOv2's LayerScale drawn
  near 1 so that attention reaches the loss), then timed steps at batch 32;
* the experiment path — ``maestro_tpu_torch.main.main`` (the CLI) over 32
  FLAIR-HUB tiles written to a temporary directory (``.npy`` tiles, CSV
  tables), batch 16, ``data.loader=auto`` (worker processes on an 8-core
  host), EMA, pretrain 1 epoch, probe 3 (val epochs 2 and 3
  replayed from the frozen-trunk feature cache), finetune 2 (cosia monitor,
  test on the best checkpoint): every phase's losses, checkpoints and files;
  each kernel's launches per pass (train, eval, replay, the cache's first-
  replay check, image logging) equal to batches x launches a batch, and no
  plain version run; the cached probe's val metrics against an uncached probe
  run from the same pretrain checkpoint; the newest finetune checkpoint
  restored bit-identically; the host syncs of every train epoch; and per
  phase the epoch and in-epoch step times against a staged-once step at the
  same batch, the device's idle share over a train epoch, peak memory, the
  loader alone (threads and processes), the host's cast and pinned copy
  alone, and the checkpoint saves' blocking and background times;
* the released weights (phase ``released``) — a seeded MAE medium release
  in the reference's lightning layout through the ``port_checkpoint`` CLI
  (every tensor bit-identical, only the heads fresh, the reference head
  splits 12 x 64 / 16 x 32 printed and recorded); pretrain and finetune
  steps from it at those splits, kernel path against plain path at batch 8
  and timed at 48 and 32; the attention forward and backward timed at
  ``[48, 1024, 16, 32]`` and ``[32, 1880, 12, 64]`` beside SDPA; the CLI from
  the ported weights over the same tiles (pretrain 1, finetune 1; launches
  per pass, no plain version) and ``scripts/predict`` from its finetune
  checkpoint (files, dtypes, EMA weights, launches, tiles/s); then each
  adapter's default release (DINOv2-L, DOFA-B, CROMA-B, SatMAE-L, Prithvi-L
  v2 TL) drawn from a seed in its release layout, ported by the ``port_fm``
  CLI (manifest clean, no backbone parameter fresh), one probe and one
  finetune step from it at batch 8, kernel path against plain path;
* a baseline through the CLI — ``model.model=dinov2 model.model_size=large
  model.fusion_mode=shared`` over the same tiles (aerial 448 px, S2 and S1
  28 px), batch 8, probe 1 epoch and finetune 1, warm-started through
  ``model.pretrained_path`` from the DINOv2-L release ported above: each
  kernel's launches per pass equal to batches x launches a batch, and no
  plain version run;
* multi-process training (phase ``parallel``, ``parallel/``): (a) one rank
  over NCCL in this process, pretrain and finetune steps at batch 8 under
  DDP and under FSDP2 against the unwrapped steps (loss, update cosine and
  distance, step 2 included, the pools' weights scaled between the steps so
  that a stale bf16 copy would show; the same launches a step, no plain
  version), the step ms and peak memory of each; (b) two DDP ranks sharing
  the card over gloo (spawned; 8 rows each of a global batch 16) against one
  process at batch 16; (c) the CLI under ``python -m torch.distributed.run
  --standalone --nproc_per_node=1`` with ``trainer.fsdp=true`` over the
  tiles (pretrain, probe, finetune 1 epoch each), its finetune checkpoint
  evaluated in this plain process (``run.eval_only``) to the same test
  metrics.

The loss forward of a pretrain step is one grouped launch over the five
modalities; it is also held against its plain version at the five FLAIR
shapes, grouped, at batch 8 and 48, and two grouped calls must give the same
bits.

Output: one JSON object per line.  The second-to-last line is the
``{"kernels": [...]}`` record, the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises: the exit code is then non-zero and no result line is
printed.  Without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# published dense peaks of one H100 SXM (NVIDIA data sheet), for the kernel bounds
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# dense bf16 peak by the name nvidia-smi gives, for the train step's MFU
BF16_PEAK_BY_NAME = {"H100 80GB HBM3": 989e12, "H100 SXM": 989e12, "H100 NVL": 835e12,
                     "H100 PCIe": 756e12}
HEAD_START_CYCLES = 10_000_000  # device spin before timed launches, 5-6 ms at 1.7-2 GHz

# Kernel vs plain version: |got - want| <= tol * (|want| + rms(want)) per element,
# so the tolerance follows the data (attention outputs shrink as sqrt(1/L)).
BF16_ULP = 2.0**-7
ATTN_TOL = {torch.bfloat16: 4 * BF16_ULP, torch.float32: 1e-4}
# backward (bf16 in, P and dS rounded to bf16 as operands) vs fp32 autograd of
# the plain version on the same inputs: the forward's tolerance (0.57 of it is
# the most an H100 read over the pretrain shapes)
ATTN_BWD_TOL = ATTN_TOL
LSE_ABS_TOL = 1e-3
POOL_TOL = {torch.bfloat16: 4 * BF16_ULP, torch.float32: 0.1}  # fp32 x: bf16 matmul operands
# pool backward vs fp32 autograd of the plain version on the same inputs: dx
# per element at 8 bf16 ulp of (|want| + rms(want)) for both dtypes (y, W_kv
# and [dk, dv] are bf16 operands and the pivot reads the saved bf16 out; an
# H100 read at most 0.038 x (|want| + rms), 0.61 of this); the four parameter
# gradients, sums over 10^4-10^5 rows, by relative norm (an H100 read at most
# 5.8e-3)
POOL_BWD_DX_TOL = 2 * 4 * BF16_ULP
POOL_BWD_PARAM_RTOL = 2e-2
POOL_STATS_TOL = {torch.bfloat16: 1e-3, torch.float32: 5e-2}
# fused loss: sums differ from the plain version by summation order only
LOSS_SUM_RTOL = 1e-4
# d_rec of l2: one rounding to r's dtype; l1: +-g*m, a sign flips only where
# t_norm - r rounds to about 0, allowed for at most this share of elements
LOSS_GRAD_TOL = {torch.bfloat16: 2 * BF16_ULP, torch.float32: 1e-5}
LOSS_SIGN_FLIP_SHARE = 1e-5
# kernel path vs plain path through 12 bf16 blocks, relative to max |logit|
# (about 3x the 0.0077 this comparison reads on an H100)
LOGITS_REL_TOL = 0.025
ARGMAX_AGREE_MIN = 0.97
# train steps, kernel path vs plain path (bf16 both): loss per step, and the
# relative norm |p1 - p0| / |p0| of the update of step 1
STEP_LOSS_RTOL = 1e-3  # an H100 read 3.4e-6
STEP_UPDATE_RTOL = 0.05
# step-1 gradients, kernel path vs plain path: the seg head pool's parameters,
# every trained parameter, and (finetune) the encoders' alone; an H100 read
# 0.999999 for the first two
GRAD_COS_MIN = 0.99

# 129: one row past a 128-row tile; every head dim is also checked at the ragged 50,
# 129, 200, 400 and 1880
ATTN_CHECK_LENGTHS = (50, 129, 200, 256, 400, 1024, 1880)
# (16, 64): the baseline adapters' DINOv2 / SatMAE / Prithvi large heads
ATTN_CHECK_HEADS = ((6, 128), (12, 64), (3, 64), (16, 32), (8, 96), (16, 64))
ATTN_CHECK_BATCH = {(6, 128): 8}  # the serving path's heads at its largest batch; else 2
# the forward lengths the baseline adapters run, at batch 8 and their heads (16 x 64
# large, 12 x 64 base): 2 (PASTIS-HD S2 / S1 under DINOv2 and DOFA: one patch + CLS),
# 5 (the CLI run's S2 / S1), 17 (SatMAE, Prithvi: 16 dates + CLS; the CLI run's
# spot), 101 / 122 (PASTIS-HD spot under DOFA / DINOv2), 1025 / 1297 (the CLI run's
# aerial and DEM)
ADAPTER_FWD_LENGTHS = (2, 5, 17, 101, 122, 1025, 1297)
ADAPTER_FWD_HEADS = ((16, 64), (12, 64))
# the shapes a MAESTRO release runs at its reference head splits (encoder 12 x 64,
# decoder 16 x 32; phase ``released``), forward and backward: the decoders at full
# stream length (aerial 1024, S2 400), the encoders at kept tokens (the aerial's 256,
# the trunk's 470), the finetune trunk at full length.  Their inputs come from a
# generator of their own (RELEASED_SEED), so that the other checks draw what they
# drew before these were added
RELEASED_ATTN_SHAPES = ((8, 1024, 16, 32), (8, 400, 16, 32), (8, 256, 12, 64),
                        (8, 470, 12, 64), (2, 1880, 12, 64))
RELEASED_SEED = 12
# the pretrain path's attention shapes at batch 8 (kept tokens 50..470 in the
# encoders and the trunk, full lengths in the decoders), then the other head
# dims, a length past 1536 and the full-length trunk of the supervised steps
BWD_CHECK_SHAPES = (
    [(8, l, 6, 128) for l in (50, 64, 100, 256, 470)]
    + [(8, l, 4, 128) for l in (200, 256, 400, 1024)]
    + [(2, 200, 12, 64), (2, 130, 16, 32), (2, 100, 8, 96), (2, 1600, 4, 128)]
    + [(2, 1880, 6, 128)]  # the finetune step's trunk, full length
    # one row past a tile at every head dim, and the full-length trunk at batch 1
    + [(2, 129, h, d) for h, d in ((6, 128), (12, 64), (16, 32), (8, 96))]
    + [(1, 1880, 6, 128)]
    # the baseline adapters at 16 x 64: PASTIS-HD spot under DINOv2 (121 patches
    # + CLS), the FLAIR-HUB aerial at 448 px (1024 + CLS) and DEM at 512 px
    + [(8, 122, 16, 64), (8, 1025, 16, 64), (2, 1297, 16, 64)]
)
# two backward calls on the same inputs: dk, dv bit-identical, dq (summed in an
# order that varies) within 1 bf16 ulp, taken at max(|dq|, rms(dq)) as the other
# checks take their tolerance at |want| + rms (an entry near 0 is a sum that
# cancels, and moves by more of its own ulps)
REPEAT_CHECK_SHAPES = ((8, 470, 6, 128), (2, 1880, 6, 128), (2, 129, 16, 32))
# the attention kernels of csrc/flash_attention*.cu, for the ptxas report
ATTN_KERNEL_NAMES = ("attn_fwd_wgmma", "attn_bwd_wgmma", "attn_bwd_dq_convert", "attn_bwd_delta")
# the pool kernels of csrc/attn_pool*.cu and pool_common.cuh
POOL_KERNEL_NAMES = ("pool_u", "pool_fwd_rows", "pool_bwd_rows", "pool_mma", "pool_bwd_finish",
                     "column_sums")
POOL_SMEM_WIDTHS = (128, 384, 768, 1024)
# head dims 96, 96, 16, 48, 128: every one attn_pool.cu is built for
# and the DINOv2-large CLI run's seg head pool, E = 1024 (26 dates, 2 rows of the
# 32-wide aerial grid, batch 8)
POOL_CHECK_SHAPES = ((8, 26, 64, 768), (8, 26, 128, 768), (2, 2, 40, 128),
                     (2, 5, 64, 384), (2, 3, 40, 1024), (8, 26, 64, 1024))
POOL_HEADS = 8
# (shape, dx wanted): the finetune and probe pool shapes at batch 8, then head
# dims 16, 48, 128 with 5 or 26 dates and ragged L, then dx skipped (probe)
POOL_BWD_CHECK_CASES = (((8, 26, 128, 768), True), ((8, 26, 64, 768), True),
                        ((2, 5, 40, 128), True), ((2, 26, 33, 384), True),
                        ((2, 5, 40, 1024), True), ((8, 26, 64, 768), False),
                        ((8, 26, 64, 1024), True), ((8, 26, 64, 1024), False))
# two pool backward calls on the same inputs: dx and the four parameter
# gradients bit-identical (every sum in a fixed order, no atomics)
POOL_REPEAT_CASES = (((8, 26, 128, 768), True), ((8, 26, 64, 768), False))
REQUEST_BATCHES = (1, 4, 8)
ATTN_PER_REQUEST = 39  # 4 streams x 9 blocks + 3 trunk blocks
POOL_PER_REQUEST = 16  # ref grid 32 rows / seg_chunk_rows 2
# per pretrain step: 4 x 9 encoder + 3 trunk + 4 x 3 decoder blocks; 5 modalities,
# whose loss forward is one grouped launch and whose backward is one launch each
ATTN_PER_STEP = 51
LOSS_FWD_PER_STEP, LOSS_BWD_PER_STEP = 1, 5
CHECK_BATCH, TRAIN_BATCH = 8, 48  # the JAX bench's pretrain batch
WARMUP_STEPS, TIMED_STEPS = 2, 10
# per supervised step: 39 attention launches (4 x 9 encoder + 3 trunk blocks,
# full-length streams); the seg head's pool once per chunk of ref rows
SUP_CHUNK = {"finetune": 4, "probe": 2}  # the JAX bench's seg_chunk_rows
SUP_BATCH = {"finetune": 32, "probe": 48}  # the JAX bench's batches
SUP_LAUNCHES = {"finetune": (39, 39, 8, 8), "probe": (39, 0, 16, 16)}
SUP_COUNTERS = ("attention_fwd", "attention_bwd", "pool_fwd", "pool_bwd")
FLAIR_TOKENS = 1880


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device time of one call of ``fn``: a CUDA event pair around each
    of ``iters`` calls.  The device first spins for a few milliseconds, so the
    host has queued every call before the first runs and its launch rate
    stays out of the times of short kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(HEAD_START_CYCLES)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                tol: float) -> tuple[float, float]:
    """Raise unless ``|got - want| <= tol * (|want| + rms(want))`` everywhere;
    returns the largest absolute error and the largest error over its limit."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        msg = f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}"
        raise AssertionError(msg)
    if not torch.isfinite(got).all():
        msg = f"{name}: kernel output is not finite"
        raise AssertionError(msg)
    diff = (got - want).abs()
    max_abs = diff.max().item()
    rms = want.square().mean().sqrt()
    over = (diff / (tol * (want.abs() + rms))).max().item()
    if not over <= 1.0:
        msg = (f"{name}: error is {over:.2f} x its limit of {tol} * (|want| + rms), "
               f"max abs err {max_abs:.3e}, rms(want) {rms.item():.3e}")
        raise AssertionError(msg)
    return max_abs, over


def ptxas_kernels(log: str, names) -> list[dict]:
    """Registers, static shared memory, stack and spills that ``ptxas -v``
    reports for each compiled kernel whose (mangled) name holds one of
    ``names``."""
    rows, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            fn = ln.split("Compiling entry function '")[1].split("'")[0]
            cur = next(({"kernel": fn, "name": n} for n in names if n in fn), None)
            if cur is not None and "ILi" in fn:  # the head dim a template is built for
                cur["head_dim"] = int(fn.split("ILi")[1].split("E")[0])
            if cur is not None:
                rows.append(cur)
        elif cur is not None and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            cur.update(stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur is not None and "Used " in ln and " registers" in ln:
            cur["registers"] = int(ln.split("Used ")[1].split(" registers")[0])
            cur["static_smem_bytes"] = (int(ln.split(" bytes smem")[0].split()[-1])
                                        if " bytes smem" in ln else 0)
    return rows


def ptxas_spills(log: str) -> list[str]:
    """``kernel: spill line`` for each kernel ``ptxas -v`` reports spilling."""
    spills, kernel = [], None
    for ln in log.splitlines():
        if "Function properties for " in ln:
            kernel = ln.split("Function properties for ")[1].strip()
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln:
            spills.append(f"{kernel}: {ln.strip()}")
    return sorted(set(spills))


def profile_device(run_once, latency_ms: float, calls: int = 3) -> dict:
    """Device time by kernel name over a few calls of ``run_once``
    (torch.profiler / CUPTI).

    ``busy_ms_per_call`` is the sum of all kernels' device time; the idle
    share is taken against ``latency_ms``, the call's latency measured with
    the profiler off (profiling itself slows the host).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # device-side events only: the CPU-side operator rows repeat their kernels'
    # time, and so do the device spans of user annotations (Optimizer.step#...)
    rows = [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        return {"device_time": "not measured (the profiler saw no device activity)"}
    return {
        "busy_ms_per_call": busy, "latency_ms_profiler_off": latency_ms,
        "device_idle_share": 1.0 - busy / latency_ms, "wall_ms_per_call_profiled": wall_ms,
        "device_events_per_call": sum(r[2] for r in rows),
        "top": [{"name": r[0][:90], "ms_per_call": r[1], "calls_per_call": r[2]}
                for r in rows[:14]],
    }


def qkv_views(b: int, l: int, h: int, d: int, dtype, gen) -> tuple[torch.Tensor, ...]:
    """q, k, v as strided views of one fused [B, L, 3*H*D] projection output."""
    return qkv_fused(b, l, h, d, dtype, gen).unbind(dim=2)


def qkv_fused(b: int, l: int, h: int, d: int, dtype, gen) -> torch.Tensor:
    """One fused projection output viewed as [B, L, 3, H, D]."""
    qkv = torch.randn((b, l, 3 * h * d), generator=gen, device="cuda", dtype=torch.float32)
    return qkv.to(dtype).view(b, l, 3, h, d)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """Least time (ms) for the work, and which of bytes and operations sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def attention_bound(b: int, l: int, h: int, d: int, dtype) -> tuple[float, str]:
    size = 2 if dtype == torch.bfloat16 else 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return bound(4 * b * l * h * d * size, 4 * b * h * l * l * d, peak)


def attention_bwd_bound(b: int, l: int, h: int, d: int, dtype) -> tuple[float, str]:
    # reads q, k, v, o, dO and the fp32 lse; writes dq, dk, dv: five products
    size = 2 if dtype == torch.bfloat16 else 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return bound(8 * b * l * h * d * size + 4 * b * h * l, 10 * b * h * l * l * d, peak)


def loss_bound(n: int, f: int, size: int, backward: bool) -> tuple[float, str]:
    # reads t, r and the fp32 row mask once; the forward writes two floats, the
    # backward d_rec.  About 10 fp32 operations per element (three passes).
    nbytes = 2 * n * f * size + 4 * n + (n * f * size if backward else 8)
    return bound(nbytes, 10 * n * f, PEAK_FP32_FLOPS)


def bound_mixed(nbytes: float, fp32_ops: float, tc_ops: float) -> tuple[float, str]:
    """Least time (ms) of work with fp32 operations on the CUDA cores and bf16
    products on the tensor cores: the bytes at the memory rate against the two
    kinds of operations, each at its own peak, one after the other."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = fp32_ops / PEAK_FP32_FLOPS + tc_ops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def pool_bound(b: int, d: int, l: int, e: int, heads: int) -> tuple[float, str]:
    """The pool's least work (bf16): x read once, out, m and den written, the
    parameters read; per (batch, date, position) row 4EH + 8E fp32 operations
    (the logits, the pooled sum, LayerNorm), per position the 2E^2 product with
    W_v on the tensor cores, and u's 2E^2 once."""
    rows, pos = b * d * l, b * l
    nbytes = rows * e * 2 + pos * e * 2 + 2 * pos * heads * 4 + 2 * e * e * 2 + 3 * e * 4
    return bound_mixed(nbytes, rows * (4 * e * heads + 8 * e) + 2 * e * e, pos * 2 * e * e)


def pool_bwd_bound(b: int, d: int, l: int, e: int, heads: int,
                   need_dx: bool = True) -> tuple[float, str]:
    """The pool backward's least work (bf16): reads x, out, g, m, den and the
    parameters, writes dx (when wanted) and the four fp32 parameter gradients;
    per row 12EH fp32 operations (logits, da, dy, du, the pooled sum) and
    11E for LayerNorm, d_ln_scale and d_ln_bias, 10E more for the LayerNorm
    backward into dx; per position the 4E^2 of dybar and dW_v on the tensor
    cores; u, dW_k and d_query 6E^2 once."""
    rows, pos = b * d * l, b * l
    nbytes = (rows * e * 2 * (2 if need_dx else 1) + 2 * pos * e * 2 + 2 * pos * heads * 4
              + 2 * e * e * (2 + 4) + 3 * e * 4 * 2)
    fp32_ops = rows * (12 * e * heads + (21 if need_dx else 11) * e) + 6 * e * e
    return bound_mixed(nbytes, fp32_ops, pos * 4 * e * e)


def pool_bound_jax_count(b: int, d: int, l: int, e: int, heads: int) -> tuple[float, str]:
    """The bound by the JAX kernel's count (a kv projection of every row),
    beside the least-work bound so that earlier readings stay comparable."""
    nbytes = b * d * l * e * 2 + b * l * e * 2 + 2 * b * l * heads * 4 + 2 * e * e * 2 + 3 * e * 4
    return bound(nbytes, 4 * b * d * l * e * e, PEAK_BF16_FLOPS)


def pool_bwd_bound_jax_count(b: int, d: int, l: int, e: int, heads: int) -> tuple[float, str]:
    # reads x, out, g (bf16), m, den (fp32) and the parameters; writes dx (bf16)
    # and the four fp32 parameter gradients; B*D*L*(12E^2 + 8EH + 25E)
    # operations (the JAX package's _bwd_cost)
    nbytes = (2 * b * d * l * e * 2 + 2 * b * l * e * 2 + 2 * b * l * heads * 4
              + 2 * e * e * (2 + 4) + 3 * e * 4 * 2)
    return bound(nbytes, b * d * l * (12 * e * e + 8 * e * heads + 25 * e), PEAK_BF16_FLOPS)


def plain_pool(attn_pool):
    """The plain pool with the signature ``models.vit`` calls (differentiable
    through autograd)."""
    def pool(x, ln_scale, ln_bias, w_kv, query, heads, eps=1e-5, w_kv_bf16=None):
        del w_kv_bf16
        return attn_pool.attentive_pool_plain(x, ln_scale, ln_bias, w_kv, query, heads, eps)
    return pool


def pool_inputs(shape, dtype, gen):
    b, d, l, e = shape
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda", dtype=torch.float32)
    x = (rnd(b, d, l, e) * 1.5 + 0.3 * rnd(b, d, l, 1)).to(dtype)
    return x, 1.0 + 0.1 * rnd(e), 0.1 * rnd(e), rnd(2 * e, e) * e**-0.5, rnd(e)


def loss_inputs(n: int, f: int, dtype, gen):
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda", dtype=torch.float32)
    t = (rnd(n, f) * 3.0 + 1.0).to(dtype)
    r = rnd(n, f).to(dtype)
    m = (torch.rand((n, 1), generator=gen, device="cuda") < 0.75).float()
    return t, r, m


def flair_loss_rows(plan, batch: int) -> dict[str, tuple[int, int, tuple]]:
    """[N, F] and norm-group slices of each FLAIR modality's loss rows."""
    rows = {}
    for name, spec in plan.mod_specs.items():
        p = spec.patch_size
        slices, off = [], 0
        for chans in spec.norm_groups:
            slices.append((off * p * p, chans * p * p))
            off += chans
        rows[name] = (batch * spec.num_dates * spec.tokens_per_date,
                      spec.num_channels * p * p, tuple(slices))
    return rows


def attention_fwd_checks(attention, gen) -> float:
    """Forward kernel (and its logsumexp) vs plain; returns the bf16 max abs err."""
    attn_err = 0.0
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for l in ATTN_CHECK_LENGTHS:
            worst = (0.0, 0.0, None)  # by error over its limit
            lse_err = 0.0
            for h, d in ATTN_CHECK_HEADS:
                b = ATTN_CHECK_BATCH.get((h, d), 2)
                q, k, v = qkv_views(b, l, h, d, dtype, gen)
                got = attention.mha_blhd(q, k, v, d**-0.5)
                _, lse = attention._fwd(q, k, v, d**-0.5, with_lse=True)
                torch.cuda.synchronize()
                want = attention.mha_blhd_plain(q, k, v, d**-0.5)
                max_abs, over = check_close(
                    f"attention L={l} H={h} D={d} {dtype}", got, want, ATTN_TOL[dtype])
                lse_err = max(lse_err, (lse - attention.logsumexp_plain(q, k, d**-0.5))
                              .abs().max().item())
                del got, want, lse
                cases += 1
                if over > worst[1]:
                    worst = (max_abs, over, [b, l, h, d])
                if dtype == torch.bfloat16:
                    attn_err = max(attn_err, max_abs)
            if not lse_err <= LSE_ABS_TOL:
                raise AssertionError(f"attention L={l} {dtype}: logsumexp off by {lse_err}")
            emit({"check": "flash_attention_fwd", "dtype": str(dtype), "L": l,
                  "layout": "strided qkv view", "tolerance_x_abs_plus_rms": ATTN_TOL[dtype],
                  "max_err_over_tolerance": worst[1], "max_abs_err": worst[0],
                  "worst_shape": worst[2], "lse_max_abs_err": lse_err,
                  "lse_abs_tolerance": LSE_ABS_TOL})
    for dtype in (torch.bfloat16, torch.float32):
        for l in ADAPTER_FWD_LENGTHS:
            for h, d in ADAPTER_FWD_HEADS:
                q, k, v = qkv_views(8, l, h, d, dtype, gen)
                got = attention.mha_blhd(q, k, v, d**-0.5)
                _, lse = attention._fwd(q, k, v, d**-0.5, with_lse=True)
                torch.cuda.synchronize()
                max_abs, over = check_close(
                    f"attention [8, {l}, {h}, {d}] {dtype}", got,
                    attention.mha_blhd_plain(q, k, v, d**-0.5), ATTN_TOL[dtype])
                lse_err = (lse - attention.logsumexp_plain(q, k, d**-0.5)).abs().max().item()
                if not lse_err <= LSE_ABS_TOL:
                    raise AssertionError(
                        f"attention [8, {l}, {h}, {d}] {dtype}: logsumexp off by {lse_err}")
                emit({"check": "flash_attention_fwd", "dtype": str(dtype),
                      "shape": [8, l, h, d], "layout": "strided qkv view",
                      "use": "baseline adapters", "tolerance_x_abs_plus_rms": ATTN_TOL[dtype],
                      "max_abs_err": max_abs, "max_err_over_tolerance": over,
                      "lse_max_abs_err": lse_err, "lse_abs_tolerance": LSE_ABS_TOL})
                del got, lse
                cases += 1
                if dtype == torch.bfloat16:
                    attn_err = max(attn_err, max_abs)
    rel_gen = torch.Generator(device="cuda").manual_seed(RELEASED_SEED)
    for dtype in (torch.bfloat16, torch.float32):
        for b, l, h, d in RELEASED_ATTN_SHAPES:
            q, k, v = qkv_views(b, l, h, d, dtype, rel_gen)
            got = attention.mha_blhd(q, k, v, d**-0.5)
            _, lse = attention._fwd(q, k, v, d**-0.5, with_lse=True)
            torch.cuda.synchronize()
            max_abs, over = check_close(
                f"attention {[b, l, h, d]} {dtype}", got,
                attention.mha_blhd_plain(q, k, v, d**-0.5), ATTN_TOL[dtype])
            lse_err = (lse - attention.logsumexp_plain(q, k, d**-0.5)).abs().max().item()
            if not lse_err <= LSE_ABS_TOL:
                raise AssertionError(f"attention {[b, l, h, d]} {dtype}: logsumexp off by {lse_err}")
            emit({"check": "flash_attention_fwd", "dtype": str(dtype), "shape": [b, l, h, d],
                  "layout": "strided qkv view", "use": "released weights, reference splits",
                  "tolerance_x_abs_plus_rms": ATTN_TOL[dtype], "max_abs_err": max_abs,
                  "max_err_over_tolerance": over, "lse_max_abs_err": lse_err,
                  "lse_abs_tolerance": LSE_ABS_TOL})
            del got, lse
            cases += 1
            if dtype == torch.bfloat16:
                attn_err = max(attn_err, max_abs)
    # contiguous q, k, v too
    q, k, v = (t.contiguous() for t in qkv_views(2, 400, 6, 128, torch.bfloat16, gen))
    check_close("attention contiguous", attention.mha_blhd(q, k, v, 128**-0.5),
                attention.mha_blhd_plain(q, k, v, 128**-0.5), ATTN_TOL[torch.bfloat16])
    # the full-length trunk at batch 1: 15 query tiles, the last one 88 rows short
    q, k, v = qkv_views(1, FLAIR_TOKENS, 6, 128, torch.bfloat16, gen)
    out, lse = attention._fwd(q, k, v, 128**-0.5, with_lse=True)
    max_abs, over = check_close("attention [1, 1880, 6, 128]", out,
                                attention.mha_blhd_plain(q, k, v, 128**-0.5),
                                ATTN_TOL[torch.bfloat16])
    lse_err = (lse - attention.logsumexp_plain(q, k, 128**-0.5)).abs().max().item()
    if not lse_err <= LSE_ABS_TOL:
        raise AssertionError(f"attention [1, 1880, 6, 128]: logsumexp off by {lse_err}")
    emit({"check": "flash_attention_fwd", "dtype": str(torch.bfloat16),
          "shape": [1, FLAIR_TOKENS, 6, 128], "max_abs_err": max_abs,
          "max_err_over_tolerance": over, "lse_max_abs_err": lse_err})
    emit({"check": "flash_attention_fwd", "cases": cases + 2, "ok": True})
    return attn_err


def attention_bwd_checks(attention, gen) -> float:
    """Backward kernel vs autograd through the plain version in fp32, on the
    same inputs; returns the bf16 max abs err over dq, dk, dv."""
    bwd_err = 0.0
    rel_gen = torch.Generator(device="cuda").manual_seed(RELEASED_SEED + 1)
    cases = [(shape, gen) for shape in BWD_CHECK_SHAPES]
    cases += [(shape, rel_gen) for shape in RELEASED_ATTN_SHAPES]
    for dtype in (torch.bfloat16, torch.float32):
        for (b, l, h, d), draw in cases:
            qkv = qkv_fused(b, l, h, d, dtype, draw).requires_grad_(True)
            out = attention.mha_qkv(qkv, d**-0.5)
            dout = torch.randn(out.shape, generator=draw, device="cuda").to(dtype)
            (got,) = torch.autograd.grad(out, qkv, dout)
            torch.cuda.synchronize()
            ref_in = qkv.detach().float().requires_grad_(True)
            ref = attention.mha_qkv_plain(ref_in, d**-0.5)
            (want,) = torch.autograd.grad(ref, ref_in, dout.float())
            row = {"check": "flash_attention_bwd", "dtype": str(dtype), "shape": [b, l, h, d],
                   "layout": "strided qkv view, one [B, L, 3, H, D] gradient",
                   "tolerance_x_abs_plus_rms": ATTN_BWD_TOL[dtype]}
            for i, name in enumerate(("dq", "dk", "dv")):
                max_abs, over = check_close(f"attention bwd {name} {[b, l, h, d]} {dtype}",
                                            got[:, :, i], want[:, :, i], ATTN_BWD_TOL[dtype])
                row[name] = {"max_abs_err": max_abs, "max_err_over_tolerance": over}
                if dtype == torch.bfloat16:
                    bwd_err = max(bwd_err, max_abs)
            emit(row)
            del qkv, out, dout, got, ref_in, ref, want
    # separate q, k, v through mha_blhd: three gradients, views of one buffer
    qkv = [t.contiguous().requires_grad_(True)
           for t in qkv_views(2, 400, 6, 128, torch.bfloat16, gen)]
    out = attention.mha_blhd(*qkv, 128**-0.5)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    got = torch.autograd.grad(out, qkv, dout)
    ref_in = [t.detach().float().requires_grad_(True) for t in qkv]
    want = torch.autograd.grad(attention.mha_blhd_plain(*ref_in, 128**-0.5), ref_in,
                               dout.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check_close(f"attention bwd {name} separate q, k, v", g, w, ATTN_BWD_TOL[torch.bfloat16])
    emit({"check": "flash_attention_bwd", "cases": 2 * len(cases) + 1, "ok": True})
    return bwd_err


def attention_repeat_checks(attention, gen) -> None:
    """Two backward calls on the same inputs: dk and dv bit-identical (each
    written once by one thread), dq within 1 bf16 ulp (its fp32 sums arrive
    from many blocks in an order that varies)."""
    for b, l, h, d in REPEAT_CHECK_SHAPES:
        qkv = qkv_fused(b, l, h, d, torch.bfloat16, gen)
        q, k, v = qkv.unbind(dim=2)
        out, lse = attention._fwd(q, k, v, d**-0.5, with_lse=True)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
        first = attention._bwd(q, k, v, out, lse, dout, d**-0.5)
        second = attention._bwd(q, k, v, out, lse, dout, d**-0.5)
        torch.cuda.synchronize()
        dkdv_equal = torch.equal(first[:, :, 1:], second[:, :, 1:])
        a, c = first[:, :, 0].float(), second[:, :, 0].float()
        mag = torch.maximum(a.abs(), c.abs())

        def ulp_diff(scale):  # |a - c| in bf16 ulps of `scale` (frexp: m in [0.5, 1))
            return ((a - c).abs() / torch.ldexp(torch.ones_like(a), torch.frexp(scale)[1] - 8)
                    ).max().item()

        ulps = ulp_diff(torch.clamp(mag, min=a.square().mean().sqrt().item()))
        emit({"check": "flash_attention_bwd_repeat", "shape": [b, l, h, d],
              "dk_dv_bit_identical": dkdv_equal, "dq_max_diff_bf16_ulp_at_max_abs_rms": ulps,
              "dq_max_diff_own_bf16_ulp": ulp_diff(mag),
              "dq_elements_differ": int((first[:, :, 0] != second[:, :, 0]).sum()),
              "dq_elements": a.numel()})
        if not dkdv_equal or not ulps <= 1.0:
            raise AssertionError(f"attention bwd repeat {[b, l, h, d]}: dk/dv equal "
                                 f"{dkdv_equal}, dq {ulps} ulp apart")
        del qkv, q, k, v, out, lse, dout, first, second


def loss_checks(fused_loss, plan, gen) -> tuple[float, float]:
    """Fused loss forward and backward vs plain at the FLAIR modality rows of
    batch 8; returns the bf16 max abs errors of the sum and of d_rec."""
    sum_err = grad_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for square in (False, True):
            for name, (n, f, slices) in flair_loss_rows(plan, CHECK_BATCH).items():
                t, r, m = loss_inputs(n, f, dtype, gen)
                r.requires_grad_(True)
                s, c = fused_loss.masked_patchnorm_sums(t, r, m, slices, square)
                g = torch.tensor(0.37, device="cuda")
                (got_dr,) = torch.autograd.grad(s, r, g)
                torch.cuda.synchronize()
                s_p, c_p = fused_loss.masked_patchnorm_sums_plain_fwd(t, r.detach(), m, slices, square)
                want_dr = fused_loss.masked_patchnorm_sums_plain_bwd(
                    t, r.detach(), m, g, slices, square)
                label = f"loss {name} {'l2' if square else 'l1'} {dtype}"
                s_rel = abs(s.item() - s_p.item()) / abs(s_p.item())
                if not s_rel <= LOSS_SUM_RTOL or c.item() != c_p.item():
                    raise AssertionError(f"{label}: sums {s.item()}, {c.item()} vs plain "
                                         f"{s_p.item()}, {c_p.item()}")
                diff = (got_dr.float() - want_dr.float()).abs()
                limit = LOSS_GRAD_TOL[dtype] * (want_dr.float().abs()
                                                + want_dr.float().square().mean().sqrt())
                flips = int((diff > limit).sum())
                if not torch.isfinite(got_dr).all() or flips > LOSS_SIGN_FLIP_SHARE * diff.numel() \
                        or (square and flips):
                    raise AssertionError(f"{label}: d_rec off at {flips} of {diff.numel()}")
                emit({"check": "masked_patchnorm_sums", "modality": name, "rows": [n, f],
                      "slices": slices, "loss": "l2" if square else "l1", "dtype": str(dtype),
                      "sum_rel_err": s_rel, "sum_rtol": LOSS_SUM_RTOL,
                      # sums by their rtol; d_rec (l2) per element by its limit, (l1)
                      # by the sign flips against the share allowed
                      "max_err_over_tolerance": max(
                          s_rel / LOSS_SUM_RTOL, (diff / limit).max().item() if square
                          else flips / (LOSS_SIGN_FLIP_SHARE * diff.numel())),
                      "d_rec_max_abs_err": diff.max().item(),
                      "d_rec_elements_over_tolerance": flips,
                      "d_rec_tolerance_x_abs_plus_rms": LOSS_GRAD_TOL[dtype]})
                if dtype == torch.bfloat16:
                    sum_err = max(sum_err, abs(s.item() - s_p.item()))
                    grad_err = max(grad_err, diff.max().item())
    # the grouped forward over the five modalities at once (as a train step
    # calls it), at batch 8 and the timed steps' batch: against the plain
    # version, and twice for the same bits
    for batch in (CHECK_BATCH, TRAIN_BATCH):
        for dtype in (torch.bfloat16, torch.float32):
            for square in (False, True):
                items = [(*loss_inputs(n, f, dtype, gen), slices)
                         for n, f, slices in flair_loss_rows(plan, batch).values()]
                got = fused_loss.masked_patchnorm_sums_multi(items, square)
                again = fused_loss.masked_patchnorm_sums_multi(items, square)
                torch.cuda.synchronize()
                want = fused_loss.masked_patchnorm_sums_multi_plain(items, square)
                rel = ((got[:, 0] - want[:, 0]).abs() / want[:, 0].abs()).max().item()
                same = torch.equal(got, again)
                emit({"check": "masked_patchnorm_sums_multi", "batch": batch,
                      "modalities": list(flair_loss_rows(plan, batch)),
                      "loss": "l2" if square else "l1", "dtype": str(dtype),
                      "sum_rel_err": rel, "sum_rtol": LOSS_SUM_RTOL,
                      "max_err_over_tolerance": rel / LOSS_SUM_RTOL,
                      "counts_equal": torch.equal(got[:, 1], want[:, 1]),
                      "two_calls_bit_identical": same})
                if not (rel <= LOSS_SUM_RTOL and torch.equal(got[:, 1], want[:, 1]) and same):
                    raise AssertionError(f"grouped loss batch {batch} {dtype}: rel {rel}, "
                                         f"bit-identical {same}")
                if dtype == torch.bfloat16 and batch == CHECK_BATCH:
                    sum_err = max(sum_err, (got[:, 0] - want[:, 0]).abs().max().item())
                del items, got, again, want
    return sum_err, grad_err


def pool_bwd_checks(attn_pool, gen) -> float:
    """Pool backward (through the autograd Function, kernels both ways) vs
    fp32 autograd of the plain version on the same inputs; returns the bf16
    max abs err of dx at the finetune shape."""
    dx_err = 0.0
    names = ("d_ln_scale", "d_ln_bias", "d_w_kv", "d_query")
    for dtype in (torch.bfloat16, torch.float32):
        for shape, need_dx in POOL_BWD_CHECK_CASES:
            x, *params = pool_inputs(shape, dtype, gen)
            x.requires_grad_(need_dx)
            params = [p.requires_grad_(True) for p in params]
            out, _, _ = attn_pool.attentive_pool(x, *params, POOL_HEADS)
            g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
            got = torch.autograd.grad(out, ([x] if need_dx else []) + params, g)
            torch.cuda.synchronize()
            ref_x = x.detach().float().requires_grad_(need_dx)
            ref_p = [p.detach().clone().requires_grad_(True) for p in params]
            ref, _, _ = attn_pool.attentive_pool_plain(ref_x, *ref_p, POOL_HEADS)
            want = torch.autograd.grad(ref, ([ref_x] if need_dx else []) + ref_p, g.float())
            label = f"pool bwd {shape} {dtype} dx={need_dx}"
            row = {"check": "attentive_pool_bwd", "dtype": str(dtype), "shape": list(shape),
                   "heads": POOL_HEADS, "dx_wanted": need_dx,
                   "dx_tolerance_x_abs_plus_rms": POOL_BWD_DX_TOL,
                   "param_grad_rel_norm_tolerance": POOL_BWD_PARAM_RTOL}
            if need_dx:
                max_abs, over = check_close(label + " dx", got[0], want[0], POOL_BWD_DX_TOL)
                row["dx"] = {"max_abs_err": max_abs, "max_err_over_tolerance": over}
                if dtype == torch.bfloat16 and shape == POOL_BWD_CHECK_CASES[0][0]:
                    dx_err = max_abs
            for name, gk, gw in zip(names, got[-4:], want[-4:]):
                rel = ((gk.float() - gw).norm() / gw.norm()).item()
                if not (torch.isfinite(gk).all() and rel <= POOL_BWD_PARAM_RTOL):
                    raise AssertionError(f"{label} {name}: relative norm error {rel}")
                row[name] = {"rel_norm_err": rel,
                             "max_err_over_tolerance": rel / POOL_BWD_PARAM_RTOL,
                             "max_abs_err": (gk.float() - gw).abs().max().item()}
            emit(row)
            del x, params, out, g, got, ref_x, ref_p, ref, want
    emit({"check": "attentive_pool_bwd", "cases": 2 * len(POOL_BWD_CHECK_CASES), "ok": True})
    return dx_err


def pool_repeat_checks(attn_pool, gen) -> None:
    """Two pool backward calls on the same inputs: dx and the four parameter
    gradients bit-identical (their sums run in a fixed order, no atomics)."""
    names = ("dx", "d_ln_scale", "d_ln_bias", "d_w_kv", "d_query")
    for shape, need_dx in POOL_REPEAT_CASES:
        x, sc, bi, w, q = pool_inputs(shape, torch.bfloat16, gen)
        w16 = w.to(torch.bfloat16)
        out, m, den = attn_pool.attentive_pool(x, sc, bi, w, q, POOL_HEADS, w_kv_bf16=w16)
        g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
        first, second = (attn_pool.attentive_pool_bwd(x, sc, bi, w16, q, out, m, den, g,
                                                      POOL_HEADS, need_dx=need_dx)
                         for _ in range(2))
        torch.cuda.synchronize()
        equal = {n: torch.equal(a, c) for n, a, c in zip(names, first, second) if a is not None}
        emit({"check": "attentive_pool_bwd_repeat", "shape": list(shape), "dx_wanted": need_dx,
              "bit_identical": equal})
        if not all(equal.values()):
            raise AssertionError(f"pool bwd repeat {list(shape)}: bit-identical {equal}")
        del x, sc, bi, w, q, w16, out, m, den, g, first, second


def serving_phase(model, batches, predict, attention, attn_pool, vit, want_profile) -> dict:
    """Requests through the kernels (counts from 0), latency, plain-path agreement."""
    attention.launch_count = 0
    attn_pool.launch_count = 0
    logits_kernel = {}
    for b in REQUEST_BATCHES:
        before = (attention.launch_count, attn_pool.launch_count)
        logits = predict(batches[b])["cosia"]
        torch.cuda.synchronize()
        made = (attention.launch_count - before[0], attn_pool.launch_count - before[1])
        if made != (ATTN_PER_REQUEST, POOL_PER_REQUEST):
            msg = f"batch {b}: launches {made}, expected {(ATTN_PER_REQUEST, POOL_PER_REQUEST)}"
            raise AssertionError(msg)
        if tuple(logits.shape) != (b, 1, 15, 512, 512) or not torch.isfinite(logits).all():
            msg = f"batch {b}: bad logits {tuple(logits.shape)}"
            raise AssertionError(msg)
        logits_kernel[b] = logits
    launches = {"attention": attention.launch_count, "pool": attn_pool.launch_count}
    if 0 in launches.values():
        raise AssertionError("the serving path did not launch both kernels")

    # latency (host clock around whole requests, numpy batch in, synchronize at the end)
    latency = {}
    for b in REQUEST_BATCHES:
        for _ in range(2):
            predict(batches[b])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(11):
            t0 = time.perf_counter()
            predict(batches[b])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        emit({"request": {"batch": b, "logits_shape": list(logits_kernel[b].shape),
                          "attention_launches": ATTN_PER_REQUEST,
                          "pool_launches": POOL_PER_REQUEST,
                          "latency_ms_median": statistics.median(times),
                          "latency_ms_all": times,
                          "peak_memory_bytes": torch.cuda.max_memory_allocated()}})
        latency[b] = statistics.median(times)
    if want_profile:
        for b in (1, 8):
            emit({"profile": {"path": "serve", "batch": b,
                              **profile_device(lambda b=b: predict(batches[b]), latency[b])}})

    # the same model through the plain versions, on the card
    kernel_fns = (vit.mha_qkv, vit.attentive_pool)
    vit.mha_qkv = attention.mha_qkv_plain
    vit.attentive_pool = plain_pool(attn_pool)
    try:
        count_before = (attention.launch_count, attn_pool.launch_count)
        for b in REQUEST_BATCHES:
            ref = predict(batches[b])["cosia"].float()
            torch.cuda.synchronize()
            got = logits_kernel[b].float()
            scale = ref.abs().max().item()
            max_abs = (got - ref).abs().max().item()
            agree = (got.argmax(dim=2) == ref.argmax(dim=2)).float().mean().item()
            emit({"agreement": {"batch": b, "max_abs_err": max_abs, "max_abs_logit": scale,
                                "rel_tolerance": LOGITS_REL_TOL, "argmax_agree": agree,
                                "argmax_agree_min": ARGMAX_AGREE_MIN}})
            if max_abs > LOGITS_REL_TOL * scale or agree < ARGMAX_AGREE_MIN:
                msg = (f"batch {b}: kernel path and plain path disagree "
                       f"({max_abs=}, {scale=}, {agree=})")
                raise AssertionError(msg)
        if (attention.launch_count, attn_pool.launch_count) != count_before:
            raise AssertionError("the plain path launched a kernel")
        t0 = time.perf_counter()
        predict(batches[8])
        torch.cuda.synchronize()
        emit({"plain_path_request": {"batch": 8, "latency_ms": (time.perf_counter() - t0) * 1e3}})
    finally:
        vit.mha_qkv, vit.attentive_pool = kernel_fns
    return launches


EXPORT_SAMPLE_BATCH = 4  # the batch an artifact is traced at (its batch is symbolic)
INT8_COS_MIN = 0.995  # int8 logits against fp by cosine (the JAX package's bf16 bar)
# each value of each int8 product of a request against its fp64
# recomputation: within the output's rounding (half a ulp: 2^-8 of |y| in
# bf16) plus this share of the product's max |y| (the fp32 rescale)
INT8_PRODUCT_ABS_TOL = 1e-5
INT8_CHECK_BATCHES = (1, 8)  # 1: every product padded to 17 rows; 8: none of the trunk's
EXPORT_RUNS = ("eager", "artifact", "int8_eager", "int8_artifact")
LATENCY_ROUNDS = 5  # requests of each path and batch, in turns


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm() + 1e-12)).item()


def request_profile(run_once, latency_ms: float) -> dict:
    """One request under torch.profiler: device busy time and idle share
    (against the request's latency with the profiler off), host-side aten
    calls (nested ones included), ``aten::_int_mm`` calls, and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = sorted(((e.key, e.self_device_time_total / 1e3) for e in events
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                    key=lambda r: -r[1])
    busy = sum(ms for _, ms in device)
    host = [e for e in events if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
    return {"busy_ms": busy, "latency_ms": latency_ms,
            "device_idle_share": 1.0 - busy / latency_ms if busy else None,
            "host_aten_calls": sum(e.count for e in host),
            "int_mm_calls": sum(e.count for e in host if e.key == "aten::_int_mm"),
            "top": [[name[:60], ms] for name, ms in device[:6]]}


@contextlib.contextmanager
def int8_products_checked(quant, vit, report: dict):
    """Every int8 product made inside (``quant.quant_linear``: the per-token
    quantization, the zero rows padded under 17 rows, ``torch._int_mm`` and
    the fp32 rescale) held against an fp64 recomputation on the same
    operands, which multiplies with ``torch.matmul`` in fp64 and pads
    nothing.  Each value must lie within half a ulp of the output dtype of
    its fp64 value plus ``INT8_PRODUCT_ABS_TOL`` of the product's max |y|,
    or it raises; ``report`` gains the number of products, the largest
    error over that bound, the largest error over max |y|, and the shape of
    the worst product."""
    route = quant.quant_linear

    def checked(x, w_q, s_w, bias, dtype):
        y = route(x, w_q, s_w, bias, dtype)
        xf = x.float()
        s_x = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
        x_q = torch.clamp(torch.round(xf / s_x), -127, 127)
        want = (x_q.double() @ w_q.double().t()) * s_x.double() * s_w.double()
        if bias is not None:
            want = want + bias.double()
        scale = max(want.abs().max().item(), 1e-30)
        diff = (y.double() - want).abs()
        half_ulp = torch.finfo(y.dtype).eps / 2
        over = (diff / (half_ulp * want.abs() + INT8_PRODUCT_ABS_TOL * scale)).max().item()
        report["products"] += 1
        report["max_err_of_max_abs"] = max(report["max_err_of_max_abs"],
                                           diff.max().item() / scale)
        if over > report["max_err_over_bound"]:
            report["max_err_over_bound"] = over
            report["worst_shape"] = [*x.shape[:-1], w_q.shape[0]]
        if not over <= 1.0:
            msg = (f"int8 product {list(x.shape)} x {list(w_q.shape)}: {over:.3f} times its "
                   f"bound against fp64")
            raise AssertionError(msg)
        return y

    quant.quant_linear = vit.quant_linear = checked
    try:
        yield
    finally:
        quant.quant_linear = vit.quant_linear = route


def op_dispatch_us(attention, attn_pool, calls: int = 200) -> dict:
    """Host microseconds a call, enqueue only (no synchronize in the loop),
    of each forward through its registered op and through its launch
    function directly, at small shapes of the serving path (the trunk's
    heads at 50 rows; a pool of 64 positions over 4 dates): what the op's
    dispatch adds to an eager call."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = qkv_views(1, 50, 6, 128, torch.bfloat16, gen)
    x, sc, bi, w, qry = pool_inputs((1, 4, 64, 768), torch.bfloat16, gen)
    w16 = w.to(torch.bfloat16)
    pairs = {
        "attention": (lambda: attention.flash_attention_fwd(q, k, v, 0.088, False),
                      lambda: attention._fwd(q, k, v, 0.088, False)),
        "pool": (lambda: attn_pool.attentive_pool_fwd(x, sc, bi, w16, qry, POOL_HEADS, 1e-5),
                 lambda: attn_pool._fwd_kernel(x, sc, bi, w16, qry, POOL_HEADS, 1e-5)),
    }
    out = {}
    for name, fns in pairs.items():
        for label, fn in zip(("op", "direct"), fns):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[f"{name}_{label}"] = (time.perf_counter() - t0) * 1e6 / calls
            torch.cuda.synchronize()
    return out


def export_phase(model, batches, attention, attn_pool, vit, want_profile: bool) -> dict:
    """Serving artifacts and int8 serving on the card (``serve.export_predict``,
    ``quant.quantize_params``): the finetune predict exported with a symbolic
    batch, saved, loaded; the same for the int8 model; then requests of
    batch 1, 4 and 8 through eager, the artifact, int8 eager and the int8
    artifact (counts from 0): each launches the attention and pool kernels
    as eager does, no plain version runs, the artifacts agree with their
    eager paths within the serving check's tolerance and the int8 logits
    with the fp ones by cosine; every int8 product of int8 eager's requests
    of batch 1 and 8 agrees with its fp64 recomputation; then median latency
    of each, and one request of each at batch 8 under the profiler (its
    ``_int_mm`` calls).  ``want_profile`` adds the host cost of the ops'
    dispatch."""
    from maestro_tpu_torch import quant
    from maestro_tpu_torch.quant import make_quant_predict_fn, quantize_params
    from maestro_tpu_torch.serve import export_predict, load_exported, make_predict_fn, save_exported

    work = Path(tempfile.mkdtemp(prefix="maestro_export_"))
    t_phase = time.perf_counter()
    try:
        seconds = {}
        qmodel = quantize_params(model)
        params = {"": dict(model.named_parameters()), "int8_": dict(qmodel.named_parameters())}
        runs = {"eager": make_predict_fn(model, "finetune"),
                "int8_eager": make_quant_predict_fn(qmodel, "finetune")}
        for prefix, m in (("", model), ("int8_", qmodel)):
            t0 = time.perf_counter()
            ep = export_predict(m, batches[EXPORT_SAMPLE_BATCH], "finetune")
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            path = save_exported(work / f"{prefix}predict.pt2", ep)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fn = load_exported(path, device="cuda")
            load_s = time.perf_counter() - t0
            nodes = [str(n.target) for n in fn.program.graph.nodes if n.op == "call_function"]
            emit({"export": {
                "model": "int8" if prefix else "fp", "symbolic_batch": True,
                "sample_batch": EXPORT_SAMPLE_BATCH, "export_s": export_s, "save_s": save_s,
                "load_s": load_s, "bytes": path.stat().st_size,
                "param_input_bytes": sum(t.numel() * t.element_size()
                                         for t in params[prefix].values()),
                "graph_nodes": len(nodes),
                "attention_op_nodes": nodes.count("maestro.flash_attention_fwd.default"),
                "pool_op_nodes": nodes.count("maestro.attentive_pool_fwd.default"),
                "int_mm_nodes": nodes.count("aten._int_mm.default"),
                # export_predict drops the assert torch.export puts before each .to(dtype)
                "to_dtype_nodes": nodes.count("aten.to.dtype"),
                "assert_tensor_metadata_nodes":
                    nodes.count("aten._assert_tensor_metadata.default")}})
            runs[prefix + "artifact"] = (lambda batch, fn=fn, p=params[prefix]: fn(p, batch))
            del ep
        seconds["quantize_export_save_load"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()

        plain_before = (attention.plain_count, attn_pool.plain_count)
        attention.launch_count = 0
        attn_pool.launch_count = 0
        for b in REQUEST_BATCHES:
            logits = {}
            for name in EXPORT_RUNS:
                before = (attention.launch_count, attn_pool.launch_count)
                if name == "int8_eager" and b in INT8_CHECK_BATCHES:
                    products = {"products": 0, "max_err_over_bound": 0.0,
                                "max_err_of_max_abs": 0.0, "worst_shape": None}
                    with int8_products_checked(quant, vit, products):
                        logits[name] = runs[name](batches[b])["cosia"]
                    if not products["products"]:
                        raise AssertionError(f"batch {b}: int8 eager made no int8 product")
                else:
                    logits[name] = runs[name](batches[b])["cosia"]
                torch.cuda.synchronize()
                made = (attention.launch_count - before[0], attn_pool.launch_count - before[1])
                if made != (ATTN_PER_REQUEST, POOL_PER_REQUEST):
                    msg = (f"export {name} batch {b}: launches {made}, expected "
                           f"{(ATTN_PER_REQUEST, POOL_PER_REQUEST)}")
                    raise AssertionError(msg)
                if (tuple(logits[name].shape) != (b, 1, 15, 512, 512)
                        or not torch.isfinite(logits[name]).all()):
                    raise AssertionError(f"export {name} batch {b}: bad logits")
            row = {"batch": b, "rel_tolerance": LOGITS_REL_TOL, "int8_cos_min": INT8_COS_MIN}
            if b in INT8_CHECK_BATCHES:
                row["int8_products_vs_fp64"] = {**products, "abs_tol_of_max": INT8_PRODUCT_ABS_TOL}
            for got, want in (("artifact", "eager"), ("int8_artifact", "int8_eager")):
                ref = logits[want].float()
                scale = ref.abs().max().item()
                max_abs = (logits[got].float() - ref).abs().max().item()
                row[f"{got}_max_abs_err"], row[f"{want}_max_abs_logit"] = max_abs, scale
                if max_abs > LOGITS_REL_TOL * scale:
                    raise AssertionError(f"batch {b}: {got} and {want} disagree ({max_abs=}, "
                                         f"{scale=})")
            for name in ("int8_eager", "int8_artifact"):
                row[f"{name}_cos_vs_fp"] = cos = _cosine(logits[name], logits["eager"])
                if cos < INT8_COS_MIN:
                    raise AssertionError(f"batch {b}: {name} cosine {cos} against fp")
            emit({"export_agreement": row})
        launches = {"attention": attention.launch_count, "pool": attn_pool.launch_count}
        if (attention.plain_count, attn_pool.plain_count) != plain_before:
            raise AssertionError("a plain version ran on the export path")
        seconds["requests"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dispatch = op_dispatch_us(attention, attn_pool) if want_profile else None
        # latency: the four paths in turns, request by request, so that the
        # host's drift falls on all of them alike
        latency = {}
        for b in REQUEST_BATCHES:
            for name in EXPORT_RUNS:
                for _ in range(2):
                    runs[name](batches[b])
            torch.cuda.synchronize()
            times = {name: [] for name in EXPORT_RUNS}
            for _ in range(LATENCY_ROUNDS):
                for name in EXPORT_RUNS:
                    t_req = time.perf_counter()
                    runs[name](batches[b])
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t_req) * 1e3)
            for name in EXPORT_RUNS:
                latency.setdefault(name, {})[b] = statistics.median(times[name])
        seconds["latency"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b, int_mm = REQUEST_BATCHES[-1], {}
        for name in EXPORT_RUNS:
            prof = request_profile(lambda name=name: runs[name](batches[b]), latency[name][b])
            int_mm[name] = prof["int_mm_calls"]
            emit({"export_profile": {"path": name, "batch": b, **prof}})
        if (int_mm["int8_eager"] != int_mm["int8_artifact"] or not int_mm["int8_eager"]
                or int_mm["eager"] or int_mm["artifact"]):
            raise AssertionError(f"batch {b}: _int_mm calls a request {int_mm}")
        seconds["profiles"] = time.perf_counter() - t0
        emit({"export_requests": {
            "launches_per_request": {"attention": ATTN_PER_REQUEST, "pool": POOL_PER_REQUEST},
            "launches": launches, "plain_calls": 0, "int_mm_calls_per_request": int_mm,
            "op_dispatch_us": dispatch, "seconds": seconds,
            "latency_ms_median": latency, "phase_s": time.perf_counter() - t_phase}})
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def warm_start(model, path) -> None:
    """Load a ported checkpoint strict=False (as ``run.load_ckpt_path`` does)
    and require every parameter but the heads to come from it."""
    from maestro_tpu_torch.train import checkpoint as ckpt

    unmatched: list = []
    ckpt.load_weights(path, model, unmatched)
    if [n for n in unmatched if not n.startswith("heads.")]:
        raise AssertionError(f"{path} does not cover {unmatched[:5]}")


def train_phase(datasets, card: str, want_profile: bool, splits=None, warm=None) -> dict:
    """Pretrain steps: kernel path vs plain path at batch 8 (counts from 0),
    then timed steps at the JAX bench's batch, TRAIN_BATCH.  ``splits``: head
    split overrides of the model config; ``warm``: a checkpoint the weights
    start from (else seeded random)."""
    from maestro_tpu_torch.conf import MaskConfig, ModelConfig, OptPretrainConfig
    from maestro_tpu_torch.models import vit
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.ops import attention, fused_loss
    from maestro_tpu_torch.train.optim import make_optimizer
    from maestro_tpu_torch.train.state import TrainState
    from maestro_tpu_torch.train.steps import make_pretrain_step
    from maestro_tpu_torch.utils.flops import decoder_mlp_undercount, mae_model_flops
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    splits = splits or {}

    def fresh(batch_size: int):
        model, plan = build_model(
            datasets, MaskConfig(),
            ModelConfig(model_size="medium", fusion_mode="group", inter_depth=3, **splits),
            dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(0),
        )
        if warm:
            warm_start(model, warm)
        tx = make_optimizer(OptPretrainConfig(batch_size=batch_size), "pretrain", 1000, model)
        return model, plan, TrainState.create(model, tx), make_pretrain_step(model, plan, tx)

    def counts():
        return (attention.launch_count, attention.bwd_launch_count,
                fused_loss.fwd_launch_count, fused_loss.bwd_launch_count)

    def run(steps: int, state, step, batch):
        """Losses and launches per step; the update of step 1, the norm of the
        trained parameters before it and the step-1 gradients (fp32, flat)."""
        trained = [p for g in state.tx.adamw.param_groups for p in g["params"]]
        p0 = torch.cat([p.detach().flatten() for p in trained])
        losses, per_step, update, grads = [], [], None, None
        for i in range(steps):
            before = counts()
            state, logs = step(state, batch, 0)
            losses.append(logs["loss_rec"].item())
            per_step.append([a - b for a, b in zip(counts(), before)])
            if i == 0:
                update = torch.cat([p.detach().flatten() for p in trained]) - p0
                grads = torch.cat([torch.zeros(p.numel(), device=p.device) if p.grad is None
                                   else p.grad.detach().float().flatten() for p in trained])
        return losses, update, per_step, p0.norm().item(), grads

    # ---- (a) kernel path vs plain path, same weights and masks, batch 8
    batch = make_synthetic_batch(datasets.dataset, CHECK_BATCH, seed=0)
    model, plan, state, step = fresh(CHECK_BATCH)
    label = {"head_splits": f"{model.arch.heads} x {model.arch.dim_head}, decoder "
                            f"{model.arch.decoder_heads} x {model.arch.decoder_dim_head}",
             "weights": f"ported ({warm})" if warm else "seeded random"}
    for name in ("launch_count", "bwd_launch_count"):
        setattr(attention, name, 0)
    fused_loss.fwd_launch_count = fused_loss.bwd_launch_count = 0
    losses_k, update_k, per_step, norm0, grads_k = run(3, state, step, batch)
    launches = dict(zip(("attention_fwd", "attention_bwd", "loss_fwd", "loss_bwd"), counts()))
    want = [ATTN_PER_STEP, ATTN_PER_STEP, LOSS_FWD_PER_STEP, LOSS_BWD_PER_STEP]
    if any(n != want for n in per_step) or 0 in launches.values():
        raise AssertionError(f"train step launches {per_step}, expected {want} per step")
    del model, state, step
    model, _, state, step = fresh(CHECK_BATCH)
    kernel_fns = (vit.mha_qkv, fused_loss.masked_patchnorm_sums_multi)
    vit.mha_qkv = attention.mha_qkv_plain
    fused_loss.masked_patchnorm_sums_multi = fused_loss.masked_patchnorm_sums_multi_plain
    try:
        losses_p, update_p, per_step_p, _, grads_p = run(3, state, step, batch)
    finally:
        vit.mha_qkv, fused_loss.masked_patchnorm_sums_multi = kernel_fns
    if any(any(n) for n in per_step_p):
        raise AssertionError("the plain path launched a kernel")
    rel_k = update_k.norm().item() / norm0
    rel_p = update_p.norm().item() / norm0
    cos = torch.nn.functional.cosine_similarity(update_k, update_p, dim=0).item()
    grad_cos = torch.nn.functional.cosine_similarity(grads_k, grads_p, dim=0).item()
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
    emit({"train_agreement": {
        **label, "batch": CHECK_BATCH, "loss_kernel_path": losses_k, "loss_plain_path": losses_p,
        "loss_rel_err": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
        "step1_update_rel_norm_kernel": rel_k, "step1_update_rel_norm_plain": rel_p,
        "update_rel_norm_rtol": STEP_UPDATE_RTOL, "step1_update_cosine": cos,
        "step1_grad_cosine": grad_cos, "step1_grad_norm_kernel": grads_k.norm().item(),
        "step1_grad_cosine_min": GRAD_COS_MIN,
        "launches_per_step": dict(zip(("attention_fwd", "attention_bwd", "loss_fwd",
                                       "loss_bwd"), per_step[0]))}})
    if not all(e <= STEP_LOSS_RTOL for e in loss_rel) or not all(map(math.isfinite, losses_k)):
        raise AssertionError(f"train losses disagree: {losses_k} vs {losses_p}")
    if not abs(rel_k - rel_p) <= STEP_UPDATE_RTOL * rel_p:
        raise AssertionError(f"step-1 updates disagree: {rel_k} vs {rel_p}")
    if not (grads_k.norm().item() > 0 and grad_cos >= GRAD_COS_MIN):
        raise AssertionError(f"step-1 gradient cosine {grad_cos} (kernel vs plain path)")
    del model, state, step, update_k, update_p, grads_k, grads_p
    torch.cuda.empty_cache()

    # ---- (b) timed steps at the bench's batch (48); an OOM fails the script.
    # The batch is staged on the card once, as a prefetching loader (and the
    # JAX package's bench) has it; steps run back to back, the host syncs
    # once at the end, and each step's period is read between CUDA events
    # recorded as it starts (the device timeline, host stalls included).
    bsz = TRAIN_BATCH
    model, plan, state, step = fresh(bsz)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_synthetic_batch(datasets.dataset, bsz, seed=1).items()}
    for _ in range(WARMUP_STEPS):
        state, logs = step(state, batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    losses = []
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        marks[i].record()
        state, logs = step(state, batch, 0)
        losses.append(logs["loss_rec"])
    marks[-1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [x.item() for x in losses]
    peak_mem = torch.cuda.max_memory_allocated()
    # the same steps as a plain loop has them: the numpy batch copied
    # in every step, the loss read after every step (host clock)
    host_batch = make_synthetic_batch(datasets.dataset, bsz, seed=1)
    synced = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, logs = step(state, host_batch, 0)
        logs["loss_rec"].item()
        synced.append((time.perf_counter() - t0) * 1e3)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite train losses {losses}")
    step_ms = statistics.median(times)
    tokens = sum(s.seq_len * s.batch_factor for s in plan.streams.values())
    flops = mae_model_flops(plan, model.arch, model.inter_depth, "pretrain", bsz)
    flops_real = flops + decoder_mlp_undercount(plan, model.arch, bsz)
    peak = next((v for k, v in BF16_PEAK_BY_NAME.items() if k in card), None)
    timed = {
        **label, "batch": bsz, "remat": False, "step_ms_median": step_ms, "step_ms_all": times,
        "host_clock_ms_per_step": wall_ms,
        "step_ms_numpy_batch_and_loss_read_every_step": synced,
        "tokens_per_sample": tokens, "tokens_per_s": tokens * bsz / (step_ms / 1e3),
        "model_flops_per_step": flops, "model_flops_per_step_real_decoder_mlp": flops_real,
        "peak_bf16_flops": peak, "peak_from": card,
        "mfu": None if peak is None else flops / (step_ms / 1e3) / peak,
        "mfu_real_decoder_mlp": None if peak is None else flops_real / (step_ms / 1e3) / peak,
        "peak_memory_bytes": peak_mem, "losses": losses}
    emit({"train_step": timed})
    if want_profile:
        emit({"profile": {"path": "train", "batch": bsz,
                          **profile_device(lambda: step(state, batch, 0), step_ms)}})
    del model, state, step
    torch.cuda.empty_cache()
    return {"launches": launches, "batch": bsz, "plan": plan, "timed": timed}


def supervised_phase(datasets, card: str, want_profile: bool, splits=None, warm=None,
                     phases=("finetune", "probe")) -> dict:
    """Finetune and probe steps: kernel path vs plain path at batch 8 (counts
    from 0 for each path), then timed steps at the JAX bench's batch, the EMA
    update and the EMA eval step.  ``splits``, ``warm``: as ``train_phase``'s."""
    from maestro_tpu_torch.conf import MaskConfig, ModelConfig, OptFinetuneConfig, OptProbeConfig
    from maestro_tpu_torch.models import heads, vit
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.ops import attention, attn_pool
    from maestro_tpu_torch.train.optim import make_optimizer
    from maestro_tpu_torch.train.state import TrainState, ema_update
    from maestro_tpu_torch.train.steps import (
        init_metric_states,
        make_supervised_eval_step,
        make_supervised_step,
    )
    from maestro_tpu_torch.utils.flops import mae_model_flops
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    opt_cls = {"finetune": OptFinetuneConfig, "probe": OptProbeConfig}
    splits = splits or {}

    def fresh(phase: str, batch_size: int, use_ema: bool = False):
        model, plan = build_model(
            datasets, MaskConfig(),
            ModelConfig(model_size="medium", fusion_mode="group", inter_depth=3,
                        seg_chunk_rows=SUP_CHUNK[phase], **splits),
            dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(0),
        )
        if warm:
            warm_start(model, warm)
        tx = make_optimizer(opt_cls[phase](batch_size=batch_size), phase, 1000, model)
        return (model, plan, TrainState.create(model, tx, use_ema=use_ema),
                make_supervised_step(model, phase, tx))

    def counts():
        return kernel_counts()[:len(SUP_COUNTERS)]

    def run(model, state, step, batch):
        """Losses and launches per step; the update of step 1, the norm of the
        trained parameters before it, the step-1 gradients of every trained
        parameter (fp32, flat, by name; zeros where none came) and the
        parameters of the frozen roles before and after."""
        names = {id(p): n for n, p in model.named_parameters()}
        trained = [p for g in state.tx.adamw.param_groups for p in g["params"]]
        frozen = {n: p for n, p in model.named_parameters()
                  if not any(p is q for q in trained)}
        frozen0 = {n: p.detach().clone() for n, p in frozen.items()}
        p0 = torch.cat([p.detach().flatten() for p in trained])
        metrics = init_metric_states(model.head_specs)
        losses, per_step = [], []
        for i in range(3):
            before = counts()
            state, metrics, logs = step(state, batch, metrics)
            losses.append(logs["loss_pred"].item())
            per_step.append([a - b for a, b in zip(counts(), before)])
            if i == 0:
                update = torch.cat([p.detach().flatten() for p in trained]) - p0
                grads = {names[id(p)]: torch.zeros(p.numel(), device=p.device) if p.grad is None
                         else p.grad.detach().float().flatten() for p in trained}
        unchanged = all(torch.equal(p, frozen0[n]) for n, p in frozen.items())
        cm = int(metrics["cosia"]["cm"].sum())
        return losses, update, per_step, p0.norm().item(), grads, unchanged, cm

    # the gradients the cosines are taken over: every trained parameter, the
    # seg head's pool (fault 1 cut these), and in finetune the encoders alone
    # (the pool's dx is their only way to the loss)
    grad_sets = {
        "all": lambda n: True,
        "pool": lambda n: n.startswith("heads.cosia.reduce.")
        and not n.startswith("heads.cosia.reduce.norm_fc"),
        "backbone": lambda n: not n.startswith("heads."),
    }

    def flat(grads, keep):
        return torch.cat([g for n, g in sorted(grads.items()) if keep(n)])

    out = {"launches": {}, "timed": {}}
    kernel_fns = (vit.mha_qkv, vit.attentive_pool)
    head_pool_fns = (heads.pool_forward, heads.pool_backward)
    for phase in phases:
        # ---- (a) kernel path vs plain path, same weights, batch 8
        batch = make_synthetic_batch(datasets.dataset, CHECK_BATCH, seed=0)
        model, _, state, step = fresh(phase, CHECK_BATCH)
        label = {"head_splits": f"{model.arch.heads} x {model.arch.dim_head}, decoder "
                                f"{model.arch.decoder_heads} x {model.arch.decoder_dim_head}",
                 "weights": f"ported ({warm})" if warm else "seeded random"}
        zero_counts()
        losses_k, update_k, per_step, norm0, grads_k, unchanged_k, cm = run(
            model, state, step, batch)
        launches = dict(zip(SUP_COUNTERS, counts()))
        want = list(SUP_LAUNCHES[phase])
        if any(n != want for n in per_step) or any(
                launches[k] == 0 for k, w in zip(SUP_COUNTERS, want) if w):
            raise AssertionError(f"{phase} step launches {per_step}, expected {want} per step")
        out["launches"][phase] = launches
        del model, state, step
        model, _, state, step = fresh(phase, CHECK_BATCH)
        # the seg head's recomputed chunks call the pool's forward and
        # backward through models.heads, the rest through models.vit
        vit.mha_qkv, vit.attentive_pool = attention.mha_qkv_plain, plain_pool(attn_pool)
        heads.pool_forward = plain_pool(attn_pool)
        heads.pool_backward = attn_pool.attentive_pool_bwd_plain
        try:
            losses_p, update_p, per_step_p, _, grads_p, unchanged_p, cm_p = run(
                model, state, step, batch)
        finally:
            vit.mha_qkv, vit.attentive_pool = kernel_fns
            heads.pool_forward, heads.pool_backward = head_pool_fns
        if any(any(n) for n in per_step_p):
            raise AssertionError("the plain path launched a kernel")
        rel_k, rel_p = update_k.norm().item() / norm0, update_p.norm().item() / norm0
        cos = torch.nn.functional.cosine_similarity(update_k, update_p, dim=0).item()
        grad_check = {}
        for key, keep in grad_sets.items():
            if key == "backbone" and phase == "probe":
                continue  # probe trains the heads only
            gk, gp = flat(grads_k, keep), flat(grads_p, keep)
            grad_check[key] = {
                "norm_kernel": gk.norm().item(), "norm_plain": gp.norm().item(),
                "cosine": torch.nn.functional.cosine_similarity(gk, gp, dim=0).item()}
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
        emit({"supervised_agreement": {
            **label, "phase": phase, "batch": CHECK_BATCH, "seg_chunk_rows": SUP_CHUNK[phase],
            "loss_kernel_path": losses_k, "loss_plain_path": losses_p,
            "loss_rel_err": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
            "step1_update_rel_norm_kernel": rel_k, "step1_update_rel_norm_plain": rel_p,
            "update_rel_norm_rtol": STEP_UPDATE_RTOL, "step1_update_cosine": cos,
            "step1_grads": grad_check, "step1_grad_cosine_min": GRAD_COS_MIN,
            "frozen_roles_unchanged": unchanged_k, "metric_pixels_counted": cm,
            "launches_per_step": dict(zip(SUP_COUNTERS, per_step[0]))}})
        if not all(e <= STEP_LOSS_RTOL for e in loss_rel) or not all(map(math.isfinite, losses_k)):
            raise AssertionError(f"{phase} losses disagree: {losses_k} vs {losses_p}")
        if not abs(rel_k - rel_p) <= STEP_UPDATE_RTOL * rel_p:
            raise AssertionError(f"{phase} step-1 updates disagree: {rel_k} vs {rel_p}")
        for key, got in grad_check.items():
            if not (got["norm_kernel"] > 0 and got["cosine"] >= GRAD_COS_MIN):
                raise AssertionError(f"{phase}: the step-1 gradients ({key}) are off: {got}")
        if not (unchanged_k and unchanged_p):
            raise AssertionError(f"{phase}: a frozen parameter changed")
        if cm != cm_p or cm != 3 * CHECK_BATCH * 512 * 512:
            raise AssertionError(f"{phase}: metric states counted {cm} and {cm_p} pixels")
        del model, state, step, update_k, update_p, grads_k, grads_p, gk, gp
        torch.cuda.empty_cache()

        # ---- (b) timed steps at the JAX bench's batch (staged on the card
        # once, as in the pretrain phase); an OOM fails the script
        bsz = SUP_BATCH[phase]
        model, plan, state, step = fresh(phase, bsz, use_ema=phase == "finetune")
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in make_synthetic_batch(datasets.dataset, bsz, seed=1).items()}
        metrics = init_metric_states(model.head_specs)
        for _ in range(WARMUP_STEPS):
            state, metrics, logs = step(state, batch, metrics)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
        losses = []
        for i in range(TIMED_STEPS):
            marks[i].record()
            state, metrics, logs = step(state, batch, metrics)
            losses.append(logs["loss_pred"])
        marks[-1].record()
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        losses = [x.item() for x in losses]
        peak_mem = torch.cuda.max_memory_allocated()
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"non-finite {phase} losses {losses}")
        step_ms = statistics.median(times)
        flops = mae_model_flops(plan, model.arch, model.inter_depth, phase, bsz,
                                model.head_specs, datasets.dataset.ref_input)
        peak = next((v for k, v in BF16_PEAK_BY_NAME.items() if k in card), None)
        row = {**label, "phase": phase, "batch": bsz, "seg_chunk_rows": SUP_CHUNK[phase],
               "remat": False, "seg_head_chunks_recomputed_in_backward": True,
               "step_ms_median": step_ms, "step_ms_all": times,
               "tokens_per_sample": FLAIR_TOKENS, "tokens_per_s": FLAIR_TOKENS * bsz / (step_ms / 1e3),
               "model_flops_per_step": flops, "peak_bf16_flops": peak, "peak_from": card,
               "mfu": None if peak is None else flops / (step_ms / 1e3) / peak,
               "peak_memory_bytes": peak_mem, "losses": losses}
        if phase == "finetune":
            ema_ms = time_ms(lambda: ema_update(state, 0.9), 10)
            evaluate = make_supervised_eval_step(model, "finetune", use_ema=True)
            eval_metrics = init_metric_states(model.head_specs)
            for _ in range(2):
                evaluate(state, batch, eval_metrics)
            torch.cuda.synchronize()
            eval_ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                evaluate(state, batch, eval_metrics)
                torch.cuda.synchronize()
                eval_ms.append((time.perf_counter() - t0) * 1e3)
            row.update({"ema_update_ms": ema_ms, "ema_params": sum(t.numel() for t in state.ema.values()),
                        "ema_eval_step_ms_median": statistics.median(eval_ms),
                        "ema_eval_step_ms_all": eval_ms})
        emit({"supervised_step": row})
        out["timed"][phase] = row
        if want_profile:
            emit({"profile": {"path": phase, "batch": bsz, **profile_device(
                lambda: step(state, batch, metrics), step_ms)}})
        del model, state, step, batch, metrics
        torch.cuda.empty_cache()
    return out


def pretrain_eval_phase(datasets) -> dict:
    """The pretrain eval step (pixel-space loss, no update) at the timed
    batch: the kernel path (counts from 0) against the plain path on the same
    weights, batch and masks, then timed."""
    from maestro_tpu_torch.conf import MaskConfig, ModelConfig
    from maestro_tpu_torch.models import vit
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.ops import attention
    from maestro_tpu_torch.train.state import TrainState
    from maestro_tpu_torch.train.steps import make_pretrain_eval_step
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    model, plan = build_model(
        datasets, MaskConfig(), ModelConfig(model_size="medium", fusion_mode="group",
                                            inter_depth=3),
        dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, None)
    evaluate = make_pretrain_eval_step(model, plan)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_synthetic_batch(datasets.dataset, TRAIN_BATCH, seed=2).items()}
    attention.launch_count = attention.bwd_launch_count = 0
    loss_k = evaluate(state, batch, 0, 3)["loss_rec"].item()
    launches = {"attention_fwd": attention.launch_count, "attention_bwd": attention.bwd_launch_count}
    if launches != {"attention_fwd": ATTN_PER_STEP, "attention_bwd": 0}:
        raise AssertionError(f"pretrain eval step launches {launches}")
    kernel_fn = vit.mha_qkv
    vit.mha_qkv = attention.mha_qkv_plain
    try:
        loss_p = evaluate(state, batch, 0, 3)["loss_rec"].item()
    finally:
        vit.mha_qkv = kernel_fn
    rel = abs(loss_k - loss_p) / abs(loss_p)
    for _ in range(2):
        evaluate(state, batch, 0, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        evaluate(state, batch, 0, i)["loss_rec"].item()
        times.append((time.perf_counter() - t0) * 1e3)
    emit({"pretrain_eval_step": {
        "batch": TRAIN_BATCH, "loss_kernel_path": loss_k, "loss_plain_path": loss_p,
        "loss_rel_err": rel, "loss_rtol": STEP_LOSS_RTOL,
        "max_err_over_tolerance": rel / STEP_LOSS_RTOL, "launches": launches,
        "step_ms_median_host_clock_synchronised": statistics.median(times), "step_ms_all": times,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}})
    if not (math.isfinite(loss_k) and rel <= STEP_LOSS_RTOL):
        raise AssertionError(f"pretrain eval losses disagree: {loss_k} vs {loss_p}")
    del model, state, evaluate, batch
    torch.cuda.empty_cache()
    return launches


def _finetune(datasets, batch_size: int, remat=False, skip_nonfinite: bool = False):
    """A medium FLAIR finetune model (seed 0), its optimizer, state and step."""
    from maestro_tpu_torch.conf import MaskConfig, ModelConfig, OptFinetuneConfig
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.train.optim import make_optimizer
    from maestro_tpu_torch.train.state import TrainState
    from maestro_tpu_torch.train.steps import make_supervised_step

    model, plan = build_model(
        datasets, MaskConfig(),
        ModelConfig(model_size="medium", fusion_mode="group", inter_depth=3,
                    seg_chunk_rows=SUP_CHUNK["finetune"]),
        dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(0),
        remat=remat)
    tx = make_optimizer(OptFinetuneConfig(batch_size=batch_size), "finetune", 1000, model,
                        skip_nonfinite=skip_nonfinite)
    return model, plan, tx, TrainState.create(model, tx), make_supervised_step(model, "finetune", tx)


def _count_syncs(fn) -> int:
    """Host syncs that ``fn`` makes on this thread, by torch's sync debug
    mode (``_count_main_thread_syncs``: its one-time notice is not a sync)."""
    torch.cuda.synchronize()
    return _count_main_thread_syncs(fn)[1]


def skip_nonfinite_phase(datasets) -> dict:
    """Finetune steps at batch 8 with ``skip_nonfinite``: a good step, a step
    on a batch with a NaN in one raster (dropped: parameters, moments and the
    schedule's count bit-identical), a good step (applied); and the host
    syncs of one step with the option and without it."""
    from maestro_tpu_torch.train.optim import make_optimizer
    from maestro_tpu_torch.conf import OptFinetuneConfig
    from maestro_tpu_torch.train.state import TrainState
    from maestro_tpu_torch.train.steps import init_metric_states, make_supervised_step
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    model, _, tx, state, step = _finetune(datasets, CHECK_BATCH, skip_nonfinite=True)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_synthetic_batch(datasets.dataset, CHECK_BATCH, seed=4).items()}
    bad = dict(batch)
    bad["aerial"] = batch["aerial"].clone()
    bad["aerial"][0, 0, 0, 0, 0] = float("nan")
    metrics = init_metric_states(model.head_specs)
    trained = [p for g in tx.adamw.param_groups for p in g["params"]]

    def snapshot():
        torch.cuda.synchronize()
        return ([p.detach().clone() for p in trained]
                + [tx.adamw.state[p][k].clone() for p in trained
                   for k in ("exp_avg", "exp_avg_sq")]
                + [tx.guard.updates.clone(), tx.guard.bias_step.clone()])

    zero_counts()
    state, metrics, logs = step(state, batch, metrics)
    before = snapshot()
    state, metrics, logs_bad = step(state, bad, metrics)
    after_bad = snapshot()
    dropped_identical = all(torch.equal(a, b) for a, b in zip(before, after_bad))
    notfinite = (int(tx.guard.notfinite_count), int(tx.guard.total_notfinite))
    state, metrics, logs = step(state, batch, metrics)
    after_good = snapshot()
    launches = dict(zip(SUP_COUNTERS, kernel_counts()))
    applied = any(not torch.equal(a, b) for a, b in zip(after_bad[:len(trained)],
                                                        after_good[:len(trained)]))
    updates = int(tx.guard.updates)
    # the host syncs of one step, with the option and without (another
    # optimizer over the same model; each warmed up by a step first)
    tx_off = make_optimizer(OptFinetuneConfig(batch_size=CHECK_BATCH), "finetune", 1000, model)
    state_off = TrainState.create(model, tx_off)
    step_off = make_supervised_step(model, "finetune", tx_off)
    step_off(state_off, batch, metrics)
    syncs_off = _count_syncs(lambda: step_off(state_off, batch, metrics))
    syncs_on = _count_syncs(lambda: step(state, batch, metrics))
    emit({"skip_nonfinite_step": {
        "batch": CHECK_BATCH, "nan_loss_on_bad_batch": not math.isfinite(logs_bad["loss_pred"].item()),
        "dropped_step_bit_identical": dropped_identical,
        "notfinite_count_and_total_after_bad": notfinite, "good_step_after_applied": applied,
        "schedule_count_after_three_steps": updates, "host_syncs_per_step_with_option": syncs_on,
        "host_syncs_per_step_without": syncs_off, "launches": launches}})
    if not (dropped_identical and notfinite == (1, 1) and applied and updates == 2):
        raise AssertionError(f"skip_nonfinite: dropped bit-identical {dropped_identical}, "
                             f"counts {notfinite}, applied {applied}, updates {updates}")
    if syncs_on > syncs_off:
        raise AssertionError(f"skip_nonfinite adds host syncs: {syncs_on} vs {syncs_off}")
    if 0 in launches.values():
        raise AssertionError(f"skip_nonfinite steps launched {launches}")
    del model, tx, state, step, tx_off, state_off, step_off, batch, bad, before, after_bad, after_good
    torch.cuda.empty_cache()
    return launches


def remat_phase(datasets) -> dict:
    """Finetune steps at the bench's batch with ``remat="dots"`` and with
    none (counts from 0 for each): step time, peak memory, launches a step,
    and the first two steps' losses of the two held together."""
    from maestro_tpu_torch.train.steps import init_metric_states
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    bsz = SUP_BATCH["finetune"]
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_synthetic_batch(datasets.dataset, bsz, seed=1).items()}
    rows = {}
    for remat in ("dots", False):
        model, _, _, state, step = _finetune(datasets, bsz, remat=remat)
        metrics = init_metric_states(model.head_specs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses = []
        for _ in range(WARMUP_STEPS):
            state, metrics, logs = step(state, batch, metrics)
            losses.append(logs["loss_pred"].item())
        totals = kernel_counts()[:len(SUP_COUNTERS)]
        launches = [n // WARMUP_STEPS for n in totals]
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        for i in range(5):
            marks[i].record()
            state, metrics, logs = step(state, batch, metrics)
        marks[-1].record()
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        rows[str(remat)] = {"remat": remat, "batch": bsz, "step_ms_median": statistics.median(times),
                            "step_ms_all": times, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                            "first_losses": losses,
                            "launches_per_step": dict(zip(SUP_COUNTERS, launches)),
                            "launches": dict(zip(SUP_COUNTERS, totals))}
        emit({"remat_step": rows[str(remat)]})
        del model, state, step, metrics
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(rows["dots"]["first_losses"],
                                               rows["False"]["first_losses"])]
    emit({"remat_agreement": {"loss_rel_err": rel, "loss_rtol": STEP_LOSS_RTOL,
                              "max_err_over_tolerance": max(rel) / STEP_LOSS_RTOL}})
    if not all(e <= STEP_LOSS_RTOL for e in rel):
        raise AssertionError(f"remat dots and none disagree: {rel}")
    return rows["dots"]["launches"]


# the baseline adapters at their release sizes on PASTIS-HD (the reference's
# Table-2 dataset): (name, model, size, fusion, extra BaselineConfig fields)
BASELINE_RUNS = (
    ("dinov2", "dinov2", "large", "shared", {"weight_source": "imagenat"}),
    ("dofa", "dofa", "base", "shared", {}),
    ("croma-late", "croma", "base", "late-croma", {}),
    ("croma-inter", "croma", "base", "inter-croma", {}),
    ("satmae", "satmae", "large", "mod", {}),
    ("prithvi", "prithvi", "large", "mod", {"version": "v2"}),
)
BASELINE_BATCH = 32  # the timed steps'


# attention launches a step (the forward's; a finetune step's backward makes as
# many again, a probe step's none) on PASTIS-HD, from the published depths and the
# streams each adapter runs: DINOv2-L 24 blocks over each of the 4 streams (spot,
# s2, s1_asc, s1_des) = 96; DOFA-B 12 blocks x 4 streams = 48; CROMA none (its
# biased attention is plain PyTorch); SatMAE-L and Prithvi-L 24 blocks over the one
# S2 series = 24.  No pool launch: the seg head's chunks hold 1-4 positions (ref
# grid 1-2 tokens wide at patch 14-16), under the fused pool's 32
BASELINE_ATTN_PER_STEP = {"dinov2": 96, "dofa": 48, "croma-late": 0, "croma-inter": 0,
                          "satmae": 24, "prithvi": 24}
BASELINE_POOL_PER_STEP = 0
# DINOv2's LayerScale starts at 1e-5 and would scale every attention output (and the
# attention weights' gradients) by it, hiding a wrong kernel from the loss and
# gradient checks: the agreement runs draw it from N(1, LAYERSCALE_STD), as the CPU
# tests' synthetic trees do
LAYERSCALE_STD = 0.1


def baseline_launches_per_step(name: str, phase: str) -> list[int]:
    """The (attention fwd, attention bwd, pool fwd, pool bwd) launches of one
    supervised step of the adapter ``name`` on PASTIS-HD."""
    attn = BASELINE_ATTN_PER_STEP[name]
    pool = BASELINE_POOL_PER_STEP
    return [attn, attn if phase == "finetune" else 0, pool, pool]  # heads train in both


def baselines_phase(card: str, runs=BASELINE_RUNS, warm=None, steps: int = 3,
                    timed: bool = True) -> dict:
    """Each baseline adapter at its release size (seeded random weights, bf16
    compute, fp32 parameters) on PASTIS-HD synthetic batches: ``steps``
    finetune and probe steps at batch 8 through the kernels and through the
    plain versions from the same weights (losses, step-1 gradients of every
    trained parameter and, in finetune, of the attention weights alone, frozen
    roles, launches a step against ``baseline_launches_per_step``; DINOv2's
    LayerScale drawn from N(1, ``LAYERSCALE_STD``)), then (``timed``) timed
    steps at batch 32 and their peak memory.  ``warm``: adapter name -> a
    ``port_fm`` checkpoint the backbone starts from instead (LayerScale as
    ported)."""
    from maestro_tpu_torch.baselines import backbone, build_baseline
    from maestro_tpu_torch.conf import (BaselineConfig, DatasetsConfig, OptFinetuneConfig,
                                        OptProbeConfig)
    from maestro_tpu_torch.models import heads, vit
    from maestro_tpu_torch.ops import attention, attn_pool
    from maestro_tpu_torch.train.optim import make_optimizer
    from maestro_tpu_torch.train.state import TrainState
    from maestro_tpu_torch.train.steps import init_metric_states, make_supervised_step
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    opt_cls = {"finetune": OptFinetuneConfig, "probe": OptProbeConfig}
    kernel_fns = (backbone.mha_qkv, vit.attentive_pool, heads.pool_forward, heads.pool_backward)
    plain_fns = (attention.mha_qkv_plain, plain_pool(attn_pool), plain_pool(attn_pool),
                 attn_pool.attentive_pool_bwd_plain)

    def use(fns):
        backbone.mha_qkv, vit.attentive_pool, heads.pool_forward, heads.pool_backward = fns

    def counts():
        return list(kernel_counts()[:len(SUP_COUNTERS)])

    out = {"launches": dict.fromkeys(SUP_COUNTERS, 0), "rows": []}
    for name, model_name, size, fusion, extra in runs:
        datasets = DatasetsConfig(name_dataset="pastis_hd")
        if model_name in ("satmae", "prithvi"):
            datasets.pastis_hd.filter_inputs = ["s2"]
            datasets.pastis_hd.__post_init__()
        cfg = BaselineConfig(model=model_name, model_size=size, fusion_mode=fusion, **extra)
        t0 = time.perf_counter()
        model = build_baseline(datasets, cfg, torch.bfloat16, device="cuda",
                               generator=torch.Generator().manual_seed(0))
        build_s = time.perf_counter() - t0
        if warm:
            warm_start(model, warm[name])
        ls_gen = torch.Generator(device="cuda").manual_seed(1)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.rsplit(".", 1)[-1] in ("ls1", "ls2") and not warm:
                    p.normal_(1.0, LAYERSCALE_STD, generator=ls_gen)
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        # the attention weights of every kernel-run block (qkv, proj), for a
        # gradient cosine of their own
        attn_names = {f"{m}.{lin}.{w}" for m, mod in model.named_modules()
                      if isinstance(mod, backbone.EncoderBlock)
                      for lin in ("qkv", "proj") for w in ("weight", "bias")}

        def fresh(phase: str, batch_size: int):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(init[n])
            tx = make_optimizer(opt_cls[phase](batch_size=batch_size), phase, 1000, model)
            return TrainState.create(model, tx), make_supervised_step(model, phase, tx), tx

        def run(phase, batch):
            state, step, tx = fresh(phase, CHECK_BATCH)
            trained = [p for g in tx.adamw.param_groups for p in g["params"]]
            names = {id(p): n for n, p in model.named_parameters()}
            frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
                       if not any(p is q for q in trained)}
            metrics = init_metric_states(model.head_specs)
            losses, per_step = [], []
            for i in range(steps):
                before = counts()
                state, metrics, logs = step(state, batch, metrics)
                losses.append(logs["loss_pred"].item())
                per_step.append([a - b for a, b in zip(counts(), before)])
                if i == 0:
                    flat = [(names[id(p)], torch.zeros(p.numel(), device=p.device)
                             if p.grad is None else p.grad.detach().float().flatten())
                            for p in sorted(trained, key=lambda q: names[id(q)])]
                    grads = torch.cat([g for _, g in flat])
                    attn = [g for n, g in flat if n in attn_names]
                    attn_grads = torch.cat(attn) if attn else None
            unchanged = all(torch.equal(p, frozen0[n]) for n, p in model.named_parameters()
                            if n in frozen0)
            return losses, per_step, grads, attn_grads, unchanged, len(frozen0)

        for phase in ("finetune", "probe"):
            batch = make_synthetic_batch(datasets.dataset, CHECK_BATCH, seed=0)
            want = baseline_launches_per_step(name, phase)
            use(kernel_fns)
            before = counts()
            losses_k, steps_k, grads_k, attn_k, unchanged_k, n_frozen = run(phase, batch)
            for key, a, b in zip(SUP_COUNTERS, counts(), before):
                out["launches"][key] += a - b
            use(plain_fns)
            try:
                losses_p, steps_p, grads_p, attn_p, unchanged_p, _ = run(phase, batch)
            finally:
                use(kernel_fns)
            rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
            cos = torch.nn.functional.cosine_similarity(grads_k, grads_p, dim=0).item()
            # finetune of an adapter with kernel-run blocks: their attention weights alone
            attn_cos = (None if attn_k is None else
                        torch.nn.functional.cosine_similarity(attn_k, attn_p, dim=0).item())
            row = {"adapter": name, "model": model_name, "size": size, "fusion": fusion,
                   "phase": phase, "batch": CHECK_BATCH, "dataset": "pastis_hd",
                   "params": sum(p.numel() for p in model.parameters()), "build_s": build_s,
                   "loss_kernel_path": losses_k, "loss_plain_path": losses_p,
                   "loss_rel_err": rel, "loss_rtol": STEP_LOSS_RTOL,
                   "step1_grad_cosine": cos, "step1_grad_cosine_min": GRAD_COS_MIN,
                   "step1_grad_norm_kernel": grads_k.norm().item(),
                   "step1_attention_grad_cosine": attn_cos,
                   "attention_grad_params": 0 if attn_k is None else attn_k.numel(),
                   "weights": f"ported ({warm[name]})" if warm else "seeded random",
                   "layerscale": (f"N(1, {LAYERSCALE_STD})" if model_name == "dinov2" and not warm
                                  else None),
                   "frozen_params": n_frozen, "frozen_roles_unchanged": unchanged_k and unchanged_p,
                   "launches_per_step": dict(zip(SUP_COUNTERS, steps_k[0])),
                   "launches_per_step_expected": dict(zip(SUP_COUNTERS, want))}
            emit({"baseline_agreement": row})
            problems = []
            if not (all(e <= STEP_LOSS_RTOL for e in rel) and all(map(math.isfinite, losses_k))):
                problems.append(f"losses {losses_k} vs {losses_p}")
            if not (grads_k.norm().item() > 0 and cos >= GRAD_COS_MIN):
                problems.append(f"step-1 gradient cosine {cos}")
            if phase == "finetune" and BASELINE_ATTN_PER_STEP[name] and not (
                    attn_cos is not None and attn_k.norm().item() > 0
                    and attn_cos >= GRAD_COS_MIN):
                problems.append(f"step-1 attention-weight gradient cosine {attn_cos}")
            if not (unchanged_k and unchanged_p):
                problems.append("a frozen parameter changed")
            if any(s != want for s in steps_k) or any(any(s) for s in steps_p):
                problems.append(f"launches a step {steps_k} (plain path {steps_p}), "
                                f"expected {want}")
            if problems:
                raise AssertionError(f"baseline {name} {phase}: " + "; ".join(problems))
            del grads_k, grads_p, attn_k, attn_p

        # timed steps at batch 32, staged on the card once
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 make_synthetic_batch(datasets.dataset, BASELINE_BATCH, seed=1).items()}
        for phase in ("finetune", "probe") if timed else ():
            state, step, _ = fresh(phase, BASELINE_BATCH)
            metrics = init_metric_states(model.head_specs)
            for _ in range(WARMUP_STEPS):
                state, metrics, logs = step(state, batch, metrics)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
            losses = []
            for i in range(TIMED_STEPS):
                marks[i].record()
                state, metrics, logs = step(state, batch, metrics)
                losses.append(logs["loss_pred"])
            marks[-1].record()
            torch.cuda.synchronize()
            times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            losses = [x.item() for x in losses]
            if not all(map(math.isfinite, losses)):
                raise AssertionError(f"baseline {name} {phase}: non-finite losses {losses}")
            row = {"adapter": name, "phase": phase, "batch": BASELINE_BATCH,
                   "step_ms_median": statistics.median(times), "step_ms_all": times,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(), "card": card}
            emit({"baseline_step": row})
            out["rows"].append(row)
            del state, step, metrics
        del model, init, batch
        torch.cuda.empty_cache()
    return out


# ---- the experiment path: maestro_tpu_torch.main -> run_experiment over tiles on disk
EXP_TILES = 32  # FLAIR-HUB tiles, listed in the train, val and test CSVs
EXP_BATCH = 16
EXP_WORKERS = 8  # data.num_workers; "auto" takes processes on a host with < 16 cores
LOADER_EPOCHS = 3  # epochs of the loader-alone measurement
STAGING_REPEATS = 6  # the host cast and pinned copy, timed (the first not counted)
EXP_EPOCHS = {"pretrain": 1, "probe": 3, "finetune": 2}
EXP_LOG_EVERY = 2  # trainer.log_every_steps: a loss read back every 2 steps
EXP_POOL = 32 // 2  # pool calls per pass over a batch: ref grid rows / seg_chunk_rows (2)
KERNEL_COUNTERS = ("attention_fwd", "attention_bwd", "pool_fwd", "pool_bwd", "loss_fwd",
                   "loss_bwd")
# kernel launches per batch of each pass of the run, by (pass, phase)
EXP_PER_BATCH = {
    ("train", "pretrain"): (ATTN_PER_STEP, ATTN_PER_STEP, 0, 0, LOSS_FWD_PER_STEP,
                            LOSS_BWD_PER_STEP),
    ("train", "probe"): (39, 0, EXP_POOL, EXP_POOL, 0, 0),
    ("train", "finetune"): (39, 39, EXP_POOL, EXP_POOL, 0, 0),
    # the pretrain eval step takes the pixel-space loss, as the JAX package's does
    ("eval", "pretrain"): (ATTN_PER_STEP, 0, 0, 0, 0, 0),
    ("eval", "probe"): (39, 0, EXP_POOL, 0, 0, 0),
    ("eval", "finetune"): (39, 0, EXP_POOL, 0, 0, 0),
    ("replay", "probe"): (0, 0, EXP_POOL, 0, 0, 0),  # heads only, off cached features
    ("verify", "probe"): (39, 0, 0, 0, 0, 0),  # the first replay's batch-0 feature pass
    ("viz", "pretrain"): (ATTN_PER_STEP, 0, 0, 0, 0, 0),
    ("viz", "probe"): (39, 0, EXP_POOL, 0, 0, 0),
    ("viz", "finetune"): (39, 0, EXP_POOL, 0, 0, 0),
}
# host syncs a train epoch makes besides the every-log_every_steps loss read:
# the epoch's mean loss (and the confusion matrix of the cosia head)
EXP_EPOCH_SYNCS = {"pretrain": 1, "probe": 2, "finetune": 2}
REPLAY_RTOL, REPLAY_ATOL = 1e-3, 1e-4  # train/eval_cache.py verify_replay's


def kernel_counts() -> tuple[int, ...]:
    from maestro_tpu_torch.ops import attention, attn_pool, fused_loss
    return (attention.launch_count, attention.bwd_launch_count, attn_pool.launch_count,
            attn_pool.bwd_launch_count, fused_loss.fwd_launch_count, fused_loss.bwd_launch_count)


def plain_counts() -> dict[str, int]:
    from maestro_tpu_torch.ops import attention, attn_pool, fused_loss
    return {"attention": attention.plain_count, "pool": attn_pool.plain_count,
            "loss": fused_loss.plain_count}


def zero_counts() -> None:
    from maestro_tpu_torch.ops import attention, attn_pool, fused_loss
    attention.launch_count = attention.bwd_launch_count = attention.plain_count = 0
    attn_pool.launch_count = attn_pool.bwd_launch_count = attn_pool.plain_count = 0
    fused_loss.fwd_launch_count = fused_loss.bwd_launch_count = fused_loss.plain_count = 0


def write_flair_tiles(root, n: int, seed: int = 0) -> int:
    """FLAIR-HUB tiles at full size in the layout of
    tests/fixtures.py::write_flair_fixture (``.npy`` tiles, the CSV date
    tables, train / val / test CSVs each listing every tile), written with
    numpy and the csv module only; returns the bytes written."""
    import csv
    import numpy as np

    rng = np.random.default_rng(seed)
    mods = {
        "AERIAL_RGBI": ((1, 4, 512, 512), np.uint8),
        "DEM_ELEV": ((1, 2, 512, 512), np.float32),
        "SENTINEL2_TS": ((20, 10, 10, 10), np.int16),
        "SENTINEL2_MSK-SC": ((20, 1, 10, 10), np.uint8),
        "SENTINEL1-ASC_TS": ((12, 2, 10, 10), np.float32),
        "SENTINEL1-DESC_TS": ((12, 2, 10, 10), np.float32),
        "AERIAL_LABEL-COSIA": ((1, 1, 512, 512), np.uint8),
    }
    patch_ids = [f"D01_Z{z}_p1" for z in range(n)]
    nbytes = 0
    for pid in patch_ids:
        domain, area, pos = pid.split("_")
        for flair, (shape, dtype) in mods.items():
            d = root / f"{domain}_{flair}" / area
            d.mkdir(parents=True, exist_ok=True)
            if dtype == np.uint8:
                arr = rng.integers(0, 20, shape).astype(dtype)
            elif dtype == np.int16:
                arr = rng.integers(0, 10000, shape).astype(dtype)
            else:
                arr = np.abs(rng.normal(1, 0.5, shape)).astype(dtype)
            np.save(d / f"{domain}_{flair}_{area}_{pos}.npy", arr)
            nbytes += arr.nbytes

    def table(path, header, rows):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(rows)

    def dates(k):
        return json.dumps({str(i): int(f"2021{m:02d}{d:02d}") for i, (m, d) in enumerate(
            zip(rng.integers(1, 13, k), rng.integers(1, 28, k)), start=1)})

    mtd = root / "GLOBAL_ALL_MTD"
    mtd.mkdir(parents=True, exist_ok=True)
    for name in ("AERIAL", "SPOT"):
        table(mtd / f"GLOBAL_{name}_MTD_DATES.csv", ["patch_id", "date"],
              [[pid, "20210615"] for pid in patch_ids])
    for name, k in (("SENTINEL2", 20), ("SENTINEL1-ASC", 12), ("SENTINEL1-DESC", 12)):
        table(mtd / f"GLOBAL_{name}_MTD_DATES.csv", ["patch_id", "acquisition_dates"],
              [["_".join(pid.split("_")[:2]) + "_x", dates(k)] for pid in patch_ids])
    for split in ("train", "val", "test"):
        table(root / f"{split}.csv", ["patch_id"], [[pid] for pid in patch_ids])
    return nbytes


class _Patches:
    """Attribute replacements that are undone together."""

    def __init__(self):
        self._undo = []

    def set(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


class _PassCounter:
    """Counts the passes of a CLI run: the ``Experiment`` it makes (``exp``),
    the batches it stages (``Experiment._device_batch``), and for each pass
    run through ``counted`` its seconds, batches and kernel launches."""

    def __init__(self, patches: _Patches):
        from maestro_tpu_torch.train import runtime as TR

        self.passes, self.batches, self.exp = [], 0, None
        orig_init, orig_batch = TR.Experiment.__init__, TR.Experiment._device_batch

        def init(exp, *a, **k):
            orig_init(exp, *a, **k)
            self.exp = exp

        def device_batch(exp, np_batch):
            self.batches += 1
            return orig_batch(exp, np_batch)

        patches.set(TR.Experiment, "__init__", init)
        patches.set(TR.Experiment, "_device_batch", device_batch)

    def counted(self, kind: str, phase: str, fn):
        before, batches = kernel_counts(), self.batches
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        row = {"pass": kind, "phase": phase, "seconds": time.perf_counter() - t,
               "batches": self.batches - batches,
               "launches": [a - b for a, b in zip(kernel_counts(), before)]}
        self.passes.append(row)
        return out, row


def _count_main_thread_syncs(fn):
    """(result of fn(), host syncs the calling thread made in it), by torch's
    sync debug mode; its one-time 'prototype' notice is not a sync."""
    import threading
    import warnings

    main, seen = threading.current_thread(), []
    old = warnings.showwarning

    def hook(message, category, filename, lineno, file=None, line=None):
        text = str(message)
        if (threading.current_thread() is main and "synchroniz" in text
                and "prototype" not in text):
            seen.append(text)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = old
    return out, len(seen)


def _payload_equal(got, want, where="") -> list[str]:
    """Names of the tensors and counters that differ between two payloads."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            return [f"{where} keys"]
        return [d for k in want for d in _payload_equal(got[k], want[k], f"{where}/{k}")]
    if torch.is_tensor(want):
        ok = (torch.is_tensor(got) and got.dtype == want.dtype and got.shape == want.shape
              and torch.equal(got.to(want.device), want))
        return [] if ok else [where]
    return [] if got == want else [where]


def experiment_phase(root, smi: str) -> dict:
    """``maestro_tpu_torch.main.main`` over the 32 FLAIR-HUB tiles under
    ``root`` (``write_flair_tiles``): MAE medium, group fusion, 3 trunk blocks, bf16,
    EMA, pretrain 1 epoch, probe 3 (its val epochs 2 and 3 replayed from the
    feature cache), finetune 2 (cosia monitor, test on the best checkpoint),
    batch 16.  Checks every phase's results and files, the launches of each
    kernel per pass against the launches a batch, no plain version run, the
    cache's replay against an uncached probe run, a bit-identical restore of
    the newest finetune checkpoint, and the host syncs of each train epoch.
    Also the loader alone (threads and worker processes), the host's cast
    and pinned copy alone, and the loader ``data.loader=auto`` resolved to.
    Returns the launches of the run by kernel."""
    import os

    import numpy as np

    from maestro_tpu_torch import main as cli
    from maestro_tpu_torch.conf import DataConfig
    from maestro_tpu_torch.conf import OptFinetuneConfig, OptPretrainConfig, OptProbeConfig
    from maestro_tpu_torch.data.loader import make_loader
    from maestro_tpu_torch.train import checkpoint as ckpt
    from maestro_tpu_torch.train import runtime as TR
    from maestro_tpu_torch.train.eval_cache import ProbeEvalCache
    from maestro_tpu_torch.train.optim import make_optimizer
    from maestro_tpu_torch.train.state import TrainState
    from maestro_tpu_torch.train.steps import (init_metric_states, make_pretrain_step,
                                               make_supervised_step)
    from maestro_tpu_torch.utils.profiling import StepTimer, device_busy_ms, trace
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    tmp = Path(tempfile.mkdtemp(prefix="maestro_experiment_"))
    try:
        argv = [f"datasets.root_dir={root}", "datasets.name_dataset=flair",
                "datasets.flair.rel_dir=", "model.model_size=medium", "model.fusion_mode=group",
                "model.inter_depth=3", "model.use_ema=true", "trainer.compute_dtype=bfloat16",
                "trainer.input_dtype=auto", f"trainer.log_every_steps={EXP_LOG_EVERY}",
                "data.loader=auto", f"data.num_workers={EXP_WORKERS}",
                "opt_finetune.monitor=cosia/average_iou_val",
                "run.logged_images_per_epoch=2", f"run.exp_dir={tmp / 'runs'}",
                "run.exp_name=experiment"]
        argv += [f"opt_{p}.{k}={v}" for p, n in EXP_EPOCHS.items()
                 for k, v in (("epochs", n), ("batch_size", EXP_BATCH))]

        # the loader alone: the pretrain train split over LOADER_EPOCHS epochs,
        # no device work: one thread, the run's workers as threads, the run's
        # workers as processes (the first epoch starts them)
        cfg0, datasets0 = cli.parse_cli(argv)
        cpu_max = Path("/sys/fs/cgroup/cpu.max")
        host = {"host_cores": os.cpu_count(), "cpu_affinity": len(os.sched_getaffinity(0)),
                "cgroup_cpu_max": cpu_max.read_text().strip() if cpu_max.exists() else None}
        for kind, workers in (("threads", 1), ("threads", EXP_WORKERS), ("grain", EXP_WORKERS // 2),
                              ("grain", EXP_WORKERS)):
            _, loader = make_loader(datasets0, DataConfig(num_workers=workers, loader=kind),
                                    "train", "pretrain", EXP_BATCH, seed=cfg0.run.seed)
            epoch_s, n_samples = [], 0
            for epoch in range(LOADER_EPOCHS):
                loader.set_epoch(epoch)
                t0 = time.perf_counter()
                n_samples += sum(b["aerial"].shape[0] for b in loader)
                epoch_s.append(time.perf_counter() - t0)
            if hasattr(loader, "close"):
                loader.close()
            per_epoch = n_samples // LOADER_EPOCHS
            emit({"experiment_loader_alone": {
                "loader": kind, "workers": workers, "batch": EXP_BATCH, "samples": n_samples,
                "epoch_s": epoch_s, "samples_per_s": n_samples / sum(epoch_s),
                "samples_per_s_after_first_epoch": per_epoch * (LOADER_EPOCHS - 1)
                / sum(epoch_s[1:]), **host, "card": smi}})

        # ---- instrumentation: launches by pass, step starts, syncs, saves
        phase_rows, saver_rows, holder = {}, [], {}
        state = {"epoch": {}}
        patches = _Patches()
        counter = _PassCounter(patches)
        passes, counted = counter.passes, counter.counted
        orig_fit = TR.Experiment.fit_phase

        def fit_phase(self, phase, opt, *a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state["epoch"][phase] = 0
            t = time.perf_counter()
            result = orig_fit(self, phase, opt, *a, **k)
            torch.cuda.synchronize()
            phase_rows[phase] = {"seconds": time.perf_counter() - t,
                                 "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                                 "eval_cache": self._last_eval_cache}
            return result

        orig_train = TR.Experiment._run_train_epoch

        def run_train_epoch(self, phase, st, train_step, loader, seed):
            starts = []

            def timed_step(*args):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                starts.append(ev)
                return train_step(*args)

            epoch = state["epoch"][phase]
            state["epoch"][phase] += 1
            profiled = epoch == EXP_EPOCHS[phase] - 1  # the phase's last train epoch
            with trace() if profiled else contextlib.nullcontext() as prof:
                (out, syncs), row = counted("train", phase, lambda: _count_main_thread_syncs(
                    lambda: orig_train(self, phase, st, timed_step, loader, seed)))
            gaps = [a.elapsed_time(b) for a, b in zip(starts, starts[1:])]
            row.update(epoch=epoch, host_syncs=syncs, step_ms_starts=gaps,
                       step_ms_median=statistics.median(gaps) if gaps else None,
                       sync_limit=math.ceil(len(starts) / EXP_LOG_EVERY) + EXP_EPOCH_SYNCS[phase])
            if prof is not None:
                busy = device_busy_ms(prof)
                row.update(profiled=True, device_busy_ms=busy,
                           device_idle_share=1.0 - busy / (row["seconds"] * 1e3))
            return out

        orig_eval = TR.Experiment._run_eval_epoch

        def run_eval_epoch(self, phase, st, eval_step, loader, seed, cache=None):
            replay = cache is not None and cache.ready
            out, row = counted("replay" if replay else "eval", phase,
                               lambda: orig_eval(self, phase, st, eval_step, loader, seed,
                                                 cache=cache))
            row.update(cached=cache is not None, replayed=bool(replay and cache.ready))
            return out

        orig_verify = ProbeEvalCache.verify_replay

        def verify_replay(self, loader, device_batch_fn):
            out, row = counted("verify", "probe",
                               lambda: orig_verify(self, loader, device_batch_fn))
            row["agreed"] = out
            return out

        orig_viz = TR.Experiment._log_images

        def log_images(self, phase, epoch, st, np_batch):
            counted("viz", phase, lambda: orig_viz(self, phase, epoch, st, np_batch))

        orig_save, orig_close = ckpt.AsyncSaver.save, ckpt.AsyncSaver.close

        def save(self, ckpt_dir, phase, epoch, st, extra=None):
            if phase == "finetune" and epoch == EXP_EPOCHS["finetune"] - 1:
                torch.cuda.synchronize()  # the state as handed over, copied on the card
                holder["reference"] = ckpt._map_tensors(
                    ckpt._payload(st), lambda _, t: t.detach().clone())
            return orig_save(self, ckpt_dir, phase, epoch, st, extra)

        def close(self):
            orig_close(self)
            saver_rows.append({"blocked_s": list(self.blocked_s),
                               "waited_s": list(self.waited_s),
                               "background_s": list(self.background_s),
                               "end_wait_s": list(self.end_wait_s)})

        for obj, name, fn in ((TR.Experiment, "fit_phase", fit_phase),
                              (TR.Experiment, "_run_train_epoch", run_train_epoch),
                              (TR.Experiment, "_run_eval_epoch", run_eval_epoch),
                              (ProbeEvalCache, "verify_replay", verify_replay),
                              (TR.Experiment, "_log_images", log_images),
                              (ckpt.AsyncSaver, "save", save),
                              (ckpt.AsyncSaver, "close", close)):
            patches.set(obj, name, fn)

        # ---- the main path: counts from 0 just before, read just after
        try:
            zero_counts()
            t0 = time.perf_counter()
            results = cli.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            totals = dict(zip(KERNEL_COUNTERS, kernel_counts()))
            plain = plain_counts()
        finally:
            patches.undo()
        exp = counter.exp
        want_loader = "grain" if (os.cpu_count() or 1) < 2 * EXP_WORKERS else "threads"
        emit({"experiment_run": {"seconds": run_s, "launches": totals, "plain_calls": plain,
                                 "passes": len(passes), "loader": exp.cfg.data.loader,
                                 "loader_expected": want_loader,
                                 "host_cores": os.cpu_count()}})

        # check 1: the loader "auto" resolved to; three phases, finite losses
        # every epoch, checkpoints and files
        problems = []
        if exp.cfg.data.loader != want_loader:
            problems.append(f"data.loader=auto resolved to {exp.cfg.data.loader}")
        if list(results) != list(EXP_EPOCHS):
            problems.append(f"phases {list(results)}")
        for phase, res in results.items():
            key = "train/loss_rec" if phase == "pretrain" else "train/loss_pred"
            vals = [e.get(key) for e in res.history]
            if len(vals) != EXP_EPOCHS[phase] or not all(
                    v is not None and math.isfinite(v) for v in vals):
                problems.append(f"{phase} losses {vals}")
            if ckpt.find_latest_checkpoint(exp.workdir / "checkpoints", phase) is None:
                problems.append(f"no {phase} checkpoint")
        records = (exp.workdir / "metrics.jsonl").read_text().splitlines()
        cms = sorted(p.name for p in (exp.workdir / "cm").glob("*.npy"))
        n_cm = EXP_EPOCHS["probe"] + EXP_EPOCHS["finetune"] + 2  # val every epoch, test once
        if len(records) != sum(EXP_EPOCHS.values()) or len(cms) != n_cm:
            problems.append(f"{len(records)} metrics.jsonl records, {len(cms)} cm dumps")

        # check 2: launches by pass = batches x launches a batch; no plain version.
        # A replay pass holds the verify pass it runs first: take that out of it
        for i, row in enumerate(passes):
            if row["pass"] == "verify":
                outer = next(r for r in passes[i + 1:] if r["pass"] == "replay")
                outer["launches"] = [a - b for a, b in zip(outer["launches"], row["launches"])]
                outer["batches"] -= row["batches"]
        by_kernel = dict.fromkeys(KERNEL_COUNTERS, 0)
        for row in passes:
            row["expected"] = [row["batches"] * k
                               for k in EXP_PER_BATCH[(row["pass"], row["phase"])]]
            for name, got in zip(KERNEL_COUNTERS, row["launches"]):
                by_kernel[name] += got
        emit({"experiment_passes": [
            {k: v for k, v in r.items() if k != "step_ms_starts"} for r in passes]})
        wrong = [(r["pass"], r["phase"], r["launches"], r["expected"]) for r in passes
                 if r["launches"] != r["expected"]]
        if wrong:
            problems.append(f"launches by pass differ: {wrong}")
        if by_kernel != totals:
            problems.append(f"passes add to {by_kernel}, the counters read {totals}")
        if 0 in totals.values():
            problems.append(f"a kernel was never launched: {totals}")
        n_viz = sum(1 for r in passes if r["pass"] == "viz")
        if n_viz != sum(EXP_EPOCHS.values()):  # images every epoch, none failed
            problems.append(f"{n_viz} image-logging passes completed")
        if any(plain.values()):
            problems.append(f"plain versions ran on the card: {plain}")

        # check 3: the probe cache sealed and replayed; an uncached probe run
        # from the same pretrain checkpoint gives the same val metrics
        cache = phase_rows["probe"]["eval_cache"]
        if cache is None or not cache.ready or cache.disabled or cache.hit_epochs < 1:
            problems.append(f"eval cache not replayed: {cache and (cache.ready, cache.disabled, cache.hit_epochs)}")
        pre_ckpt = ckpt.find_latest_checkpoint(exp.workdir / "checkpoints", "pretrain")
        uncached = cli.main([a for a in argv if not a.startswith(("opt_pretrain.epochs",
                                                                  "opt_finetune.epochs"))]
                            + ["opt_pretrain.epochs=0", "opt_finetune.epochs=0",
                               f"run.load_ckpt_path={pre_ckpt}",
                               "trainer.probe_eval_cache=false", "run.exp_name=uncached"])
        worst = 0.0
        for ec, eu in zip(results["probe"].history, uncached["probe"].history):
            for k, v in eu.items():
                if k.startswith("val/"):
                    a, b = ec[k], v
                    if not np.allclose(a, b, rtol=REPLAY_RTOL, atol=REPLAY_ATOL):
                        problems.append(f"probe epoch {eu['epoch']} {k}: cached {a} uncached {b}")
                    worst = max(worst, abs(a - b) / (REPLAY_ATOL + REPLAY_RTOL * abs(b)))
        if len(uncached["probe"].history) != EXP_EPOCHS["probe"]:
            problems.append("the uncached probe run did not finish")
        evals = [r for r in passes if r["phase"] == "probe" and r["pass"] in ("eval", "replay")]
        emit({"experiment_eval_cache": {
            "hit_epochs": cache and cache.hit_epochs, "entries": cache and len(cache.entries),
            "device_bytes": cache and cache.device_nbytes, "disabled": cache and cache.disabled,
            "val_seconds_by_epoch": [r["seconds"] for r in evals[:EXP_EPOCHS["probe"]]],
            "first_val_vs_replay": (evals[0]["seconds"] / evals[-2]["seconds"]
                                    if len(evals) > 2 else None),
            "uncached_max_err_over_tolerance": worst}})

        # check 4: the newest finetune checkpoint restores bit-identically
        newest = ckpt.find_latest_checkpoint(exp.workdir / "checkpoints", "finetune")
        model = exp.model
        tx = make_optimizer(OptFinetuneConfig(batch_size=EXP_BATCH), "finetune", 1000, model)
        fresh = TrainState.create(model, tx, use_ema=True)
        ckpt.restore_state(newest, fresh)
        diff = _payload_equal(ckpt._payload(fresh), holder["reference"])
        if diff:
            problems.append(f"restored checkpoint differs at {diff[:6]}")
        compared = []
        ckpt._map_tensors(holder["reference"], lambda key, _: compared.append(key))
        emit({"experiment_restore": {"checkpoint": newest.name, "differs": diff[:6],
                                     "tensors": len(compared)}})
        del holder["reference"], fresh, tx

        # the host's cast and pinned copy alone (Experiment._device_batch): a
        # loader batch of the pretrain phase (fp32 kept) and of the probe
        # phase (bf16 cast), host time and time until the batch is on the card
        np_batch = make_synthetic_batch(exp.datasets.dataset, EXP_BATCH, seed=3)
        for phase in ("pretrain", "probe"):
            exp._staging_phase = phase
            host_ms, device_ms = [], []
            for _ in range(STAGING_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                staged = exp._device_batch(np_batch)
                host_ms.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                device_ms.append((time.perf_counter() - t0) * 1e3)
            emit({"experiment_staging_alone": {
                "phase": phase, "batch": EXP_BATCH,
                "host_bytes": sum(v.nbytes for v in np_batch.values()),
                "staged_bytes": sum(t.numel() * t.element_size() for t in staged.values()),
                "host_ms_median": statistics.median(host_ms[1:]),
                "until_on_card_ms_median": statistics.median(device_ms[1:]),
                "host_ms_all": host_ms, "until_on_card_ms_all": device_ms, "card": smi}})
            del staged

        # check 5 and the per-phase times: train step inside an epoch against
        # one staged-once batch at the same batch size
        opts = {"pretrain": OptPretrainConfig, "probe": OptProbeConfig,
                "finetune": OptFinetuneConfig}
        staged = {}
        for phase in EXP_EPOCHS:
            exp._staging_phase = phase
            batch = exp._device_batch(make_synthetic_batch(exp.datasets.dataset, EXP_BATCH,
                                                           seed=3))
            tx = make_optimizer(opts[phase](batch_size=EXP_BATCH), phase, 1000, model)
            st = TrainState.create(model, tx)
            if phase == "pretrain":
                step = make_pretrain_step(model, exp.plan, tx)
                run = lambda: step(st, batch, 0)  # noqa: E731
            else:
                metrics = init_metric_states(model.head_specs)
                step = make_supervised_step(model, phase, tx)
                run = lambda: step(st, batch, metrics)  # noqa: E731
            timer = StepTimer(warmup=WARMUP_STEPS)
            for _ in range(WARMUP_STEPS + 5):
                timer.start()
                run()
                timer.stop()
            staged[phase] = timer.mean_step_s * 1e3
            del batch, tx, st, step, run
        for phase in EXP_EPOCHS:
            trains = [r for r in passes if r["pass"] == "train" and r["phase"] == phase]
            gaps = [g for r in trains for g in r["step_ms_starts"]]
            prof = next(r for r in trains if r.get("profiled"))
            row = {"phase": phase, "batch": EXP_BATCH, "epochs": EXP_EPOCHS[phase],
                   "epoch_s": [e["time_s"] for e in results[phase].history],
                   "train_epoch_s": [r["seconds"] for r in trains],
                   "train_step_ms_in_epoch_median": statistics.median(gaps) if gaps else None,
                   "train_step_ms_in_epoch_all": gaps,
                   "train_step_ms_staged_once": staged[phase],
                   "device_busy_ms_profiled_epoch": prof["device_busy_ms"],
                   "device_idle_share_profiled_epoch": prof["device_idle_share"],
                   "profiled_epoch": prof["epoch"],
                   "peak_memory_bytes": phase_rows[phase]["peak_memory_bytes"],
                   "phase_s": phase_rows[phase]["seconds"],
                   "host_syncs_by_epoch": [r["host_syncs"] for r in trains],
                   "host_sync_limit_by_epoch": [r["sync_limit"] for r in trains]}
            emit({"experiment_phase": row, "card": smi})
            over = [(r["epoch"], r["host_syncs"], r["sync_limit"]) for r in trains
                    if r["host_syncs"] > r["sync_limit"]]
            if over:
                problems.append(f"{phase} train epochs sync too often: {over}")
        for phase, row in zip(EXP_EPOCHS, saver_rows):
            emit({"experiment_checkpoint_saves": {"phase": phase, **row}})
        emit({"experiment_results": {
            phase: {"best_epoch": r.best_epoch, "best_monitor": r.best_monitor,
                    "test": r.test_metrics} for phase, r in results.items()}})
        if problems:
            raise AssertionError("experiment phase: " + "; ".join(problems))
        del exp, model
        holder.clear()
        counter.exp = None
        torch.cuda.empty_cache()
        return totals
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the DINOv2-large CLI run over the experiment's FLAIR-HUB tiles, at the
# image sizes of tests/test_baseline_segmentation.py (aerial 448 px: a
# 32-wide grid at patch 14; DEM 512 px: 36; S2 and S1 28 px: 2)
BCLI_BATCH = 8
BCLI_EPOCHS = {"probe": 1, "finetune": 1}
BCLI_ATTN = 24 * 5  # 24 blocks over each of the 5 modality streams
BCLI_POOL = 32 // 2  # seg-head chunks: the aerial grid's 32 rows, 2 a chunk
# the CLI run's data and model overrides (also those its warm start is ported with)
BCLI_ARGV = ["datasets.name_dataset=flair", "datasets.flair.rel_dir=",
             "datasets.flair.aerial.image_size=448", "datasets.flair.spot.image_size=56",
             "datasets.flair.s2.image_size=28", "datasets.flair.s1_asc.image_size=28",
             "datasets.flair.s1_des.image_size=28", "model.model=dinov2",
             "model.model_size=large", "model.fusion_mode=shared"]
BCLI_PER_BATCH = {
    ("train", "probe"): (BCLI_ATTN, 0, BCLI_POOL, BCLI_POOL, 0, 0),
    ("train", "finetune"): (BCLI_ATTN, BCLI_ATTN, BCLI_POOL, BCLI_POOL, 0, 0),
    ("eval", "probe"): (BCLI_ATTN, 0, BCLI_POOL, 0, 0, 0),
    ("eval", "finetune"): (BCLI_ATTN, 0, BCLI_POOL, 0, 0, 0),
}


def cli_run(argv, per_batch: dict, epochs: dict) -> dict:
    """``maestro_tpu_torch.main.main(argv)`` with its passes counted.  Fails
    unless the run's phases are ``epochs``' with that many finite train losses
    each, each kernel's launches per pass are the pass's batches x launches a
    batch (``per_batch`` by (pass, phase)), the passes add up to the counters,
    every attention and pool kernel ran, and no plain version ran.  Returns
    the results, the launches by kernel, the passes, the ``Experiment`` and
    the run's seconds."""
    from maestro_tpu_torch import main as cli
    from maestro_tpu_torch.train import runtime as TR

    patches = _Patches()
    counter = _PassCounter(patches)

    def counted(kind, orig):
        def run(exp, phase, *a, **k):
            return counter.counted(kind, phase, lambda: orig(exp, phase, *a, **k))[0]
        return run

    for name, kind in (("_run_train_epoch", "train"), ("_run_eval_epoch", "eval")):
        patches.set(TR.Experiment, name, counted(kind, getattr(TR.Experiment, name)))
    try:
        zero_counts()
        t0 = time.perf_counter()
        results = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        totals = dict(zip(KERNEL_COUNTERS, kernel_counts()))
        plain = plain_counts()
    finally:
        patches.undo()
    passes = counter.passes
    problems = []
    if list(results) != list(epochs):
        problems.append(f"phases {list(results)}, expected {list(epochs)}")
    for phase, res in results.items():
        vals = [e.get("train/loss_pred", e.get("train/loss_rec")) for e in res.history]
        if len(vals) != epochs.get(phase) or not all(
                v is not None and math.isfinite(v) for v in vals):
            problems.append(f"{phase} losses {vals}")
    by_kernel = dict.fromkeys(KERNEL_COUNTERS, 0)
    for row in passes:
        row["expected"] = [row["batches"] * k for k in per_batch[(row["pass"], row["phase"])]]
        row["seconds_per_batch"] = row["seconds"] / max(row["batches"], 1)
        for name, got in zip(KERNEL_COUNTERS, row["launches"]):
            by_kernel[name] += got
    wrong = [(r["pass"], r["phase"], r["launches"], r["expected"]) for r in passes
             if r["launches"] != r["expected"]]
    if wrong:
        problems.append(f"launches by pass differ: {wrong}")
    if by_kernel != totals:
        problems.append(f"passes add to {by_kernel}, the counters read {totals}")
    if 0 in [totals[k] for k in SUP_COUNTERS]:
        problems.append(f"an attention or pool kernel was never launched: {totals}")
    if any(plain.values()):
        problems.append(f"plain versions ran on the card: {plain}")
    if problems:
        raise AssertionError("CLI run: " + "; ".join(problems))
    return {"results": results, "launches": totals, "plain_calls": plain, "passes": passes,
            "exp": counter.exp, "seconds": run_s}


def baseline_cli_phase(root, smi: str, pretrained=None) -> dict:
    """``maestro_tpu_torch.main.main`` with ``model.model=dinov2
    model.model_size=large model.fusion_mode=shared`` over the FLAIR-HUB tiles
    under ``root``: no pretrain, probe 1 epoch, finetune 1 epoch (test on the
    best checkpoint), batch 8, ``data.loader=auto``, the backbone warm-started
    from ``pretrained`` (``model.pretrained_path``) when given, through
    ``cli_run``'s checks.  Returns the launches of the run by kernel."""
    tmp = Path(tempfile.mkdtemp(prefix="maestro_baseline_"))
    argv = BCLI_ARGV + [f"datasets.root_dir={root}", "trainer.compute_dtype=bfloat16",
                        "data.loader=auto", f"data.num_workers={EXP_WORKERS}",
                        "opt_finetune.monitor=cosia/average_iou_val",
                        "run.logged_images_per_epoch=0", f"run.exp_dir={tmp}",
                        "run.exp_name=dinov2"]
    argv += [f"opt_{p}.{k}={v}" for p, n in BCLI_EPOCHS.items()
             for k, v in (("epochs", n), ("batch_size", BCLI_BATCH))]
    if pretrained:
        argv.append(f"model.pretrained_path={pretrained}")
    try:
        run = cli_run(argv, BCLI_PER_BATCH, BCLI_EPOCHS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    exp = run.pop("exp")
    emit({"baseline_cli_run": {
        "model": "dinov2 large imagenat", "fusion": "shared", "dataset": "flair",
        "pretrained_path": str(pretrained) if pretrained else None,
        "batch": BCLI_BATCH, "seconds": run["seconds"], "loader": exp.cfg.data.loader,
        "stream_tokens": {m: s.grid**2 + 1 for m, s in exp.plan.mod_specs.items()},
        "launches": run["launches"], "plain_calls": run["plain_calls"],
        "passes": run["passes"],
        "results": {p: {"val": r.val_metrics, "test": r.test_metrics}
                    for p, r in run["results"].items()}, "card": smi}})
    del exp
    torch.cuda.empty_cache()
    return run["launches"]


# ---- the released-weights path (phase ``released``): a MAESTRO release and the five
# foundation-model releases, synthesized from seeds in their release layouts, ported
# by the port's CLIs into warm starts and run on the card
REF_SPLITS = {"encoder_heads": 12, "encoder_dim_head": 64, "decoder_heads": 16,
              "decoder_dim_head": 32}  # the releases' (reference ssl/mae.py:345-360)
# what a release's user pays a step: the pretrain decoder's aerial stream at the
# pretrain batch, the finetune trunk at the finetune batch
RELEASED_TIMED_SHAPES = ((TRAIN_BATCH, 1024, 16, 32), (32, 1880, 12, 64))
REL_EPOCHS = {"pretrain": 1, "finetune": 1}
REL_PER_BATCH = {k: v for k, v in EXP_PER_BATCH.items()
                 if k[0] in ("train", "eval") and k[1] in REL_EPOCHS}
PREDICT_PER_BATCH = EXP_PER_BATCH[("eval", "finetune")]  # a finetune forward a batch
# each adapter's default release (port/manifests.py DEFAULT_FOR) at the size the
# baselines phase runs it
FM_RELEASES = {"dinov2": "dinov2_large", "dofa": "dofa_base", "croma-inter": "croma_base",
               "satmae": "satmae_large", "prithvi": "prithvi_v2_300_tl"}
RELEASE_STD = 0.02  # synthesize_state_dict's N(0, 0.02)


def release_state_dict(manifest: dict, seed: int) -> dict:
    """A release with the manifest's keys and shapes, N(0, RELEASE_STD) drawn on
    the card from ``seed`` (an unpinned shape at ``synthesize_state_dict``'s
    placeholder), as CPU tensors; CROMA's nested by sub-dict, as it ships."""
    from maestro_tpu_torch.port import manifests as mf

    gen = torch.Generator(device="cuda").manual_seed(seed)
    flat = {}
    for key, shape in manifest["keys"].items():
        if shape is None:
            shape = mf.synthesize_state_dict(
                {"name": manifest["name"], "keys": {key: None}})[key].shape
        flat[key] = (torch.randn(tuple(shape), generator=gen, device="cuda")
                     * RELEASE_STD).cpu()
    if manifest["adapter"] != "croma":
        return flat
    tree: dict = {}
    for key, value in flat.items():
        top, rest = key.split(".", 1)
        tree.setdefault(top, {})[rest] = value
    return tree


def _printed(fn, *args):
    """(fn(*args), what it printed)."""
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = fn(*args)
    return out, text.getvalue()


def attention_times(b: int, l: int, h: int, d: int, gen) -> dict:
    """The attention forward and backward at one shape, bf16: kernel, plain
    version, SDPA (timed only) and the bound of each."""
    from maestro_tpu_torch.ops import attention

    scale = d**-0.5
    qkv = qkv_fused(b, l, h, d, torch.bfloat16, gen)
    q, k, v = qkv.unbind(dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd_bound, fwd_by = attention_bound(b, l, h, d, torch.bfloat16)
    fwd = {"ms": time_ms(lambda: attention.mha_blhd(q, k, v, scale), 10),
           "plain_ms": time_ms(lambda: attention.mha_blhd_plain(q, k, v, scale), 2, warmup=1),
           "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
               qt, kt, vt, scale=scale), 10),
           "bound_ms": fwd_bound, "bound_by": fwd_by}
    out, lse = attention._fwd(q, k, v, scale, with_lse=True)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    plain_in = qkv.detach().requires_grad_(True)
    plain_out = attention.mha_qkv_plain(plain_in, scale)
    lib_in = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    lib_out = torch.nn.functional.scaled_dot_product_attention(*lib_in, scale=scale)
    dout_t = dout.transpose(1, 2)
    bwd_bound, bwd_by = attention_bwd_bound(b, l, h, d, torch.bfloat16)
    bwd = {"ms": time_ms(lambda: attention._bwd(q, k, v, out, lse, dout, scale), 10),
           "plain_ms": time_ms(lambda: torch.autograd.grad(plain_out, plain_in, dout,
                                                           retain_graph=True), 2, warmup=1),
           "library_ms": time_ms(lambda: torch.autograd.grad(lib_out, lib_in, dout_t,
                                                             retain_graph=True), 10),
           "bound_ms": bwd_bound, "bound_by": bwd_by}
    del qkv, q, k, v, out, lse, dout, plain_in, plain_out, lib_in, lib_out
    torch.cuda.empty_cache()
    for row in (fwd, bwd):
        row["bound_share"] = row["bound_ms"] / row["ms"]
    return {"shape": [b, l, h, d], "fwd": fwd, "bwd": bwd}


def released_phase(root, smi: str, card: str, datasets, work: Path) -> dict:
    """Day one with released weights, at full width (MAE medium, FLAIR-HUB,
    group fusion, 3 trunk blocks, bf16), files under ``work``:

    (a) a seeded MAE release in the reference's lightning layout
        (``port.torch_port.reference_state_dict``, heads left out) through the
        ``port_checkpoint`` CLI: the printed split overrides and the meta are
        the reference's, every ported tensor equals its source bit for bit in
        fp32, and only the heads stay fresh;
    (b, e) pretrain and finetune steps from the ported weights at the
        reference splits (``train_phase``, ``supervised_phase``): kernel path
        against plain path at batch 8, then timed at 48 and 32; and the
        attention forward and backward timed at the shapes they add;
    (c) ``maestro_tpu_torch.main`` with ``run.load_ckpt_path`` and the printed
        overrides over the experiment's tiles, pretrain 1 epoch and finetune 1
        (``cli_run``'s checks);
    (d) ``scripts/predict`` over the test split from that run's finetune
        checkpoint: files, shapes, dtypes, EMA weights, launches, tiles/s;
    (f) each adapter's default release synthesized from a seed, saved as it
        ships, ported by the ``port_fm`` CLI (manifest clean, no backbone
        parameter fresh), one probe and one finetune step from it at batch 8,
        kernel path against plain path; DINOv2-L's also ported for the
        baseline CLI run (returned as ``dinov2_flair``).
    """
    import numpy as np

    from maestro_tpu_torch.conf import MaskConfig, ModelConfig
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.port import manifests as mf
    from maestro_tpu_torch.port.torch_port import reference_state_dict
    from maestro_tpu_torch.scripts import port_checkpoint, port_fm, predict
    from maestro_tpu_torch.train import checkpoint as ckpt

    launches = dict.fromkeys(KERNEL_COUNTERS, 0)

    def add(counts: dict) -> None:
        for key, n in counts.items():
            launches[key] += n

    # ---- (a) the MAESTRO release, ported
    if port_checkpoint.reference_splits("medium") != REF_SPLITS:
        raise AssertionError(f"port_checkpoint's splits {port_checkpoint.reference_splits('medium')}")
    t0 = time.perf_counter()
    source, _ = build_model(datasets, MaskConfig(),
                            ModelConfig(model_size="medium", fusion_mode="group", inter_depth=3),
                            dtype=torch.float32, device="cpu",
                            generator=torch.Generator().manual_seed(7))
    release = work / "MAESTRO_FLAIR-HUB_base.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               reference_state_dict(source, heads=False).items()},
                "epoch": 0}, release)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ported, printed = _printed(port_checkpoint.main, [
        "--ckpt", str(release), "--dataset", "flair", "--fusion-mode", "group",
        "--model-size", "medium", "--inter-depth", "3", "--out", str(work / "ported")])
    port_s = time.perf_counter() - t0
    lines = printed.splitlines()
    split_args = next(ln for ln in lines if ln.startswith("run with the reference head splits"))
    split_args = split_args.split(":", 1)[1].split()
    n_fresh = int(next(ln for ln in lines if ln.startswith("ported ")).split("; ")[1].split()[0])
    saved = torch.load(ported / "state" / ckpt.PAYLOAD, weights_only=True)["params"]
    params = dict(source.named_parameters())
    heads = [n for n in params if n.startswith("heads.")]
    problems = []
    if split_args != [f"model.{k}={v}" for k, v in REF_SPLITS.items()]:
        problems.append(f"printed overrides {split_args}")
    if {k: ckpt.load_meta(ported).get(k) for k in REF_SPLITS} != REF_SPLITS:
        problems.append(f"meta {ckpt.load_meta(ported)}")
    if sorted(saved) != sorted(n for n in params if n not in heads) or n_fresh != len(heads):
        problems.append(f"{n_fresh} fresh, {len(saved)} of {len(params)} parameters ported")
    differ = [n for n, v in saved.items()
              if v.dtype != torch.float32 or not torch.equal(v, params[n].detach())]
    if differ:
        problems.append(f"ported tensors differ from their source: {differ[:5]}")
    emit({"released_port": {
        "release": "MAE medium, FLAIR-HUB, group, inter_depth 3 (reference layout, seeded)",
        "release_bytes": release.stat().st_size, "synthesize_s": synth_s, "port_s": port_s,
        "ported_parameters": len(saved), "fresh_parameters": n_fresh,
        "fresh_are_heads": n_fresh == len(heads), "bit_identical": not differ,
        "printed_overrides": split_args, "card": smi}})
    if problems:
        raise AssertionError("released port: " + "; ".join(problems))
    del source, params, saved
    release.unlink()

    # ---- (b, e) steps from the ported weights at the reference splits
    train = train_phase(datasets, card, False, splits=REF_SPLITS, warm=ported)
    sup = supervised_phase(datasets, card, False, splits=REF_SPLITS, warm=ported,
                           phases=("finetune",))
    add(train["launches"])
    add(sup["launches"]["finetune"])
    gen = torch.Generator(device="cuda").manual_seed(RELEASED_SEED + 2)
    timed_attention = [attention_times(*shape, gen) for shape in RELEASED_TIMED_SHAPES]
    for row in timed_attention:
        emit({"released_attention_times": {**row, "card": smi}})

    # ---- (c) the CLI from the ported weights
    common = [f"datasets.root_dir={root}", "datasets.name_dataset=flair",
              "datasets.flair.rel_dir=", "model.model_size=medium", "model.fusion_mode=group",
              "model.inter_depth=3", *split_args, "trainer.compute_dtype=bfloat16",
              "data.loader=auto", f"data.num_workers={EXP_WORKERS}"]
    argv = common + ["model.use_ema=true", "opt_finetune.monitor=cosia/average_iou_val",
                     "run.logged_images_per_epoch=0", f"run.exp_dir={work / 'runs'}",
                     "run.exp_name=released", f"run.load_ckpt_path={ported}",
                     "opt_probe.epochs=0"]
    argv += [f"opt_{p}.{k}={v}" for p, n in REL_EPOCHS.items()
             for k, v in (("epochs", n), ("batch_size", EXP_BATCH))]
    run = cli_run(argv, REL_PER_BATCH, REL_EPOCHS)
    exp = run.pop("exp")
    add(run["launches"])
    emit({"released_cli_run": {
        "seconds": run["seconds"], "loader": exp.cfg.data.loader, "batch": EXP_BATCH,
        "launches": run["launches"], "plain_calls": run["plain_calls"], "passes": run["passes"],
        "results": {p: {"val": r.val_metrics, "test": r.test_metrics}
                    for p, r in run["results"].items()}, "card": smi}})
    del exp
    torch.cuda.empty_cache()

    # ---- (d) predict from the run's finetune checkpoint
    finetuned = ckpt.find_latest_checkpoint(work / "runs" / "released", "finetune")
    if finetuned is None:
        raise AssertionError("the released CLI run wrote no finetune checkpoint")
    preds_dir = work / "preds"
    zero_counts()
    pred = predict.main([str(preds_dir), *common, f"run.load_ckpt_path={finetuned}",
                             "--split=test", f"--batch-size={EXP_BATCH}"])
    torch.cuda.synchronize()
    got = dict(zip(KERNEL_COUNTERS, kernel_counts()))
    plain = plain_counts()
    add(got)
    batches = -(-EXP_TILES // EXP_BATCH)
    want = dict(zip(KERNEL_COUNTERS, (batches * n for n in PREDICT_PER_BATCH)))
    files = sorted((preds_dir / "cosia").glob("preds_*.npy"))
    arrays = [np.load(f) for f in files]
    problems = []
    if not pred["ema"]:
        problems.append("predict did not use the EMA weights")
    if pred["tiles"] != {"cosia": EXP_TILES} or len(files) != EXP_TILES:
        problems.append(f"tiles {pred['tiles']}, {len(files)} files")
    if any(a.dtype != np.int16 or a.ndim != 3 or a.shape[-2:] != (512, 512)
           or a.min() < 0 or a.max() >= 15 for a in arrays):
        problems.append(f"prediction arrays {[(a.dtype, a.shape) for a in arrays[:3]]}")
    if got != want or any(plain.values()):
        problems.append(f"launches {got} (expected {want}), plain calls {plain}")
    emit({"released_predict": {
        "tiles": EXP_TILES, "batch": EXP_BATCH, "batches": batches,
        "seconds": pred["seconds"], "tiles_per_s": EXP_TILES / pred["seconds"],
        "ema": pred["ema"], "file_shape": list(arrays[0].shape) if arrays else None,
        "launches": got, "launches_expected": want, "plain_calls": plain, "card": smi}})
    if problems:
        raise AssertionError("released predict: " + "; ".join(problems))
    shutil.rmtree(preds_dir, ignore_errors=True)

    # ---- (f) the five foundation-model releases
    warm, cli_pretrained, fm_rows = {}, None, []
    runs = [r for r in BASELINE_RUNS if r[0] in FM_RELEASES]
    for seed, (name, model_name, size, fusion, extra) in enumerate(runs):
        mname = FM_RELEASES[name]
        if mf.DEFAULT_FOR[(model_name, size)] != mname:
            raise AssertionError(f"{name}: the default release is {mf.DEFAULT_FOR[(model_name, size)]}")
        manifest = mf.ALL_MANIFESTS[mname]()
        t0 = time.perf_counter()
        path = work / f"{mname}.pth"
        torch.save(release_state_dict(manifest, seed), path)
        synth_s = time.perf_counter() - t0
        overrides = ["datasets.name_dataset=pastis_hd", f"model.model={model_name}",
                     f"model.model_size={size}", f"model.fusion_mode={fusion}",
                     *[f"model.{k}={v}" for k, v in extra.items()]]
        if model_name in ("satmae", "prithvi"):
            overrides.append('datasets.pastis_hd.filter_inputs=["s2"]')
        t0 = time.perf_counter()
        warm[name], printed = _printed(port_fm.main, [
            "--ckpt", str(path), "--out", str(work / f"fm_{name}"), *overrides])
        port_s = time.perf_counter() - t0
        manifest_ok = f"manifest {mname}: all {len(manifest['keys'])} release keys" in printed
        backbone_ok = "; 0 backbone leaves fresh" in printed
        row = {"adapter": name, "release": mname, "release_bytes": path.stat().st_size,
               "synthesize_s": synth_s, "port_s": port_s, "manifest_clean": manifest_ok,
               "backbone_fresh_0": backbone_ok,
               "printed": [ln for ln in printed.splitlines() if ln.startswith(("manifest", "ported"))]}
        if model_name == "dinov2":  # the baseline CLI run's warm start, its own config
            cli_pretrained, _ = _printed(port_fm.main, [
                "--ckpt", str(path), "--out", str(work / "fm_dinov2_flair"), *BCLI_ARGV,
                f"datasets.root_dir={root}"])
        path.unlink()
        emit({"released_fm_port": {**row, "card": smi}})
        fm_rows.append(row)
        if not (manifest_ok and backbone_ok):
            raise AssertionError(f"port_fm {name}: {row['printed']}")
    bl = baselines_phase(card, runs=runs, warm=warm, steps=1, timed=False)
    add(bl["launches"])
    return {"launches": launches, "train": train["timed"], "finetune": sup["timed"]["finetune"],
            "attention": timed_attention, "cli_seconds": run["seconds"],
            "predict_tiles_per_s": EXP_TILES / pred["seconds"],
            "fm": fm_rows, "dinov2_flair": cli_pretrained}


# ---- the experiment path at tens of batches a pass, thread loader against worker
# processes (``python3 chip_smoke.py --loader-e2e [threads,grain,...]``; not part of
# the default run): each CLI run in a fresh interpreter, as a user starts one
E2E_TILES = 320  # FLAIR-HUB tiles a split: 20 batches of EXP_BATCH a pass
E2E_EPOCHS = {"pretrain": 1, "probe": 2, "finetune": 1}  # probe 2: the cache's replay check
E2E_ORDER = ("threads", "grain", "grain", "threads")


def loader_e2e_run(root, loader: str, smi: str) -> dict:
    """``maestro_tpu_torch.main.main`` over the tiles under ``root`` with
    ``data.loader=loader``: the experiment phase's model and options at
    ``E2E_EPOCHS``; the run's and each phase's seconds."""
    from maestro_tpu_torch import main as cli
    from maestro_tpu_torch.train import runtime as TR

    tmp = Path(tempfile.mkdtemp(prefix="maestro_e2e_"))
    argv = [f"datasets.root_dir={root}", "datasets.name_dataset=flair",
            "datasets.flair.rel_dir=", "model.model_size=medium", "model.fusion_mode=group",
            "model.inter_depth=3", "model.use_ema=true", "trainer.compute_dtype=bfloat16",
            "trainer.input_dtype=auto", f"trainer.log_every_steps={EXP_LOG_EVERY}",
            f"data.loader={loader}", f"data.num_workers={EXP_WORKERS}",
            "opt_finetune.monitor=cosia/average_iou_val",
            "run.logged_images_per_epoch=2", f"run.exp_dir={tmp}", "run.exp_name=e2e"]
    argv += [f"opt_{p}.{k}={v}" for p, n in E2E_EPOCHS.items()
             for k, v in (("epochs", n), ("batch_size", EXP_BATCH))]
    phases, resolved = {}, {}
    orig = TR.Experiment.fit_phase

    def fit_phase(self, phase, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        resolved["loader"] = self.cfg.data.loader
        try:
            return orig(self, phase, *a, **k)
        finally:
            torch.cuda.synchronize()
            phases[phase] = time.perf_counter() - t

    TR.Experiment.fit_phase = fit_phase
    try:
        t0 = time.perf_counter()
        results = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        TR.Experiment.fit_phase = orig
        shutil.rmtree(tmp, ignore_errors=True)
    losses = {p: [e.get("train/loss_rec", e.get("train/loss_pred")) for e in r.history]
              for p, r in results.items()}
    if list(results) != list(E2E_EPOCHS) or not all(
            len(v) == E2E_EPOCHS[p] and all(x is not None and math.isfinite(x) for x in v)
            for p, v in losses.items()):
        raise AssertionError(f"loader e2e run ({loader}): phases or losses {losses}")
    return {"loader": loader, "resolved": resolved.get("loader"), "seconds": seconds,
            "phase_seconds": phases, "batches_per_pass": E2E_TILES // EXP_BATCH,
            "batch": EXP_BATCH, "workers": EXP_WORKERS, "epochs": E2E_EPOCHS,
            "train_losses": losses, "card": smi}


def loader_e2e(order, smi: str) -> None:
    """Write ``E2E_TILES`` tiles, build the kernels, then one CLI run a
    loader of ``order``, each in its own interpreter."""
    from maestro_tpu_torch.ops import attention, attn_pool, fused_loss

    attention._kernel()
    attn_pool._kernel()
    attn_pool._bwd_kernel()
    fused_loss._kernel()
    tiles = Path(tempfile.mkdtemp(prefix="maestro_e2e_tiles_"))
    try:
        t0 = time.perf_counter()
        data_bytes = write_flair_tiles(tiles, E2E_TILES)
        emit({"loader_e2e_data": {"tiles": E2E_TILES, "bytes": data_bytes,
                                  "write_s": time.perf_counter() - t0}})
        for loader in order:
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, __file__, "--loader-e2e-run", loader,
                                  str(tiles)], capture_output=True, text=True, check=False)
            rows = [ln for ln in out.stdout.splitlines() if ln.startswith('{"loader_e2e_run"')]
            if out.returncode != 0 or not rows:
                sys.stderr.write(out.stderr[-8000:])
                raise AssertionError(f"loader e2e run ({loader}) failed: {out.returncode}")
            row = json.loads(rows[-1])["loader_e2e_run"]
            row["process_s"] = time.perf_counter() - t0
            emit({"loader_e2e_run": row})
    finally:
        shutil.rmtree(tiles, ignore_errors=True)


PAR_BATCH = 8  # a rank's batch in (a) and (b): (b) holds two ranks against one process at 16
PAR_STEPS = 2  # checked steps a run (trap: step 2 must see the weights step 1 left)
PAR_TIMED = 3  # timed steps a run, after the checked ones
PAR_EPOCHS = {"pretrain": 1, "probe": 1, "finetune": 1}  # the CLI under the launcher
PAR_KV_SCALE = 1.5  # the pools' to_kv weights are scaled by this between steps 1 and 2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _par_run(datasets, phase: str, batch: dict, steps: int, mesh=None, fsdp=False,
             timed: int = 0) -> dict:
    """``steps`` train steps of MAE medium (FLAIR-HUB, group, 3 trunk blocks,
    bf16, seeded) on ``batch`` (this rank's rows), wrapped on ``mesh`` when
    given (DDP, or FSDP2 with ``fsdp``), then ``timed`` steps.  Between the
    checked steps 1 and 2 every date pool's ``to_kv`` weight is scaled by
    ``PAR_KV_SCALE`` in place, and in the checked steps every bf16 weight a
    pool kernel gets is compared with the fp32 weight handed to it beside it,
    so that a copy left from step 1 shows.  Returns the losses, the
    kernel launches a step, the whole trained parameters (fp32, flat) before
    and after each checked step, the bf16 copies handed out and how many were
    stale, the timed steps' ms and the peak memory."""
    from maestro_tpu_torch.conf import (MaskConfig, ModelConfig, OptFinetuneConfig,
                                        OptPretrainConfig)
    from maestro_tpu_torch.models import heads, vit
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.parallel.mesh import Parallel, local
    from maestro_tpu_torch.train.optim import make_optimizer, trainable_roles
    from maestro_tpu_torch.train.state import TrainState
    from maestro_tpu_torch.train.steps import (init_metric_states, make_pretrain_step,
                                               make_supervised_step)

    model, plan = build_model(
        datasets, MaskConfig(), ModelConfig(model_size="medium", fusion_mode="group",
                                            inter_depth=3, seg_chunk_rows=SUP_CHUNK["finetune"]),
        dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(0))
    par = None
    if mesh is not None:
        par = Parallel(model, mesh, fsdp=fsdp)
        par.for_phase(trainable_roles(phase))
    opt = (OptPretrainConfig if phase == "pretrain" else OptFinetuneConfig)(
        batch_size=len(batch["ref_date"]))
    tx = make_optimizer(opt, phase, 1000, model, 1 if par is None else par.dp_size)
    state = TrainState.create(model, tx, parallel=par)
    names = {id(p): n for n, p in model.named_parameters()}
    trained = [(names[id(p)], p) for g in tx.adamw.param_groups for p in g["params"]]
    kv = [p for n, p in model.named_parameters() if n.endswith("to_kv.weight")]

    def whole():  # kept on the host, a parameter at a time: not in the runs' peak memory
        with torch.no_grad():
            return torch.cat([(p if par is None else par.full_tensor(n, p)).detach()
                              .float().flatten().cpu() for n, p in trained])

    if phase == "pretrain":
        step = make_pretrain_step(model, plan, tx, parallel=par)
        one = lambda s: step(s, batch, 0)[1]["loss_rec"]  # noqa: E731
    else:
        step = make_supervised_step(model, phase, tx, parallel=par)
        metrics = init_metric_states(model.head_specs)
        one = lambda s: step(s, batch, metrics)[2]["loss_pred"]  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "launches": [], "before": [], "after": []}
    pools, stale = (vit.attentive_pool, heads.pool_forward), []

    def checked(pool):  # each bf16 weight a pool kernel gets, against the weight given
        def call(*args, **kwargs):
            w16 = kwargs.get("w_kv_bf16")
            if w16 is not None:
                stale.append(not torch.equal(w16, args[3].detach().to(torch.bfloat16)))
            return pool(*args, **kwargs)
        return call

    vit.attentive_pool, heads.pool_forward = (checked(f) for f in pools)
    try:
        for i in range(steps):
            if i == 1 and kv:
                with torch.no_grad():
                    for p in kv:
                        local(p).mul_(PAR_KV_SCALE)
            out["before"].append(whole())
            counts0 = kernel_counts()
            out["losses"].append(float(one(state)))
            out["launches"].append([a - b for a, b in zip(kernel_counts(), counts0)])
            out["after"].append(whole())
    finally:
        vit.attentive_pool, heads.pool_forward = pools
    out["kv_bf16_calls"], out["kv_bf16_stale"] = len(stale), sum(stale)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    for i in range(timed):
        marks[i].record()
        one(state)
    marks[-1].record()
    torch.cuda.synchronize()
    out["step_ms"] = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["pool_weights"] = len(kv)
    del model, state, step, tx, par
    torch.cuda.empty_cache()
    return out


def _par_compare(name: str, got: dict, want: dict) -> dict:
    """A wrapped run against the unwrapped one: each checked step's loss
    (``STEP_LOSS_RTOL``), its update's cosine (``GRAD_COS_MIN``) and the
    distance of the parameters after it relative to the update's norm
    (``STEP_UPDATE_RTOL``), the kernel launches a step equal."""
    rows = []
    for i in range(len(want["losses"])):
        w_after, g_after = want["after"][i].cuda(), got["after"][i].cuda()
        upd_w = w_after - want["before"][i].cuda()
        upd_g = g_after - got["before"][i].cuda()
        rows.append({
            "step": i + 1, "loss": got["losses"][i], "loss_unwrapped": want["losses"][i],
            "loss_rel_err": abs(got["losses"][i] - want["losses"][i]) / abs(want["losses"][i]),
            "update_cosine": torch.nn.functional.cosine_similarity(upd_g, upd_w, dim=0).item(),
            "params_dist_over_update": ((g_after - w_after).norm()
                                        / upd_w.norm()).item(),
            "launches": got["launches"][i], "launches_unwrapped": want["launches"][i]})
    bad = [r for r in rows if not (
        math.isfinite(r["loss"]) and r["loss_rel_err"] <= STEP_LOSS_RTOL
        and r["update_cosine"] >= GRAD_COS_MIN
        and r["params_dist_over_update"] <= STEP_UPDATE_RTOL
        and r["launches"] == r["launches_unwrapped"] and any(r["launches"]))]
    if bad:
        raise AssertionError(f"parallel {name}: wrapped steps disagree with unwrapped: {bad}")
    if got["kv_bf16_stale"] or want["kv_bf16_stale"] or (
            got["kv_bf16_calls"] != want["kv_bf16_calls"]):
        raise AssertionError(f"parallel {name}: {got['kv_bf16_stale']} of "
                             f"{got['kv_bf16_calls']} bf16 pool weights were stale "
                             f"(unwrapped: {want['kv_bf16_calls']} handed out)")
    return {"steps": rows, "kv_bf16_calls": got["kv_bf16_calls"],
            "kv_bf16_stale": got["kv_bf16_stale"],
            "step_ms": got["step_ms"], "step_ms_unwrapped": want["step_ms"],
            "peak_memory_bytes": got["peak_memory_bytes"],
            "peak_memory_bytes_unwrapped": want["peak_memory_bytes"]}


def _par_rank(rank: int, store: str, out: str) -> None:
    """Part (b): one of two DDP ranks sharing the card over gloo (a group
    this script makes), this rank's 8 rows of the global batch 16, held
    against one process at batch 16 (``out/reference.pt``)."""
    from maestro_tpu_torch.conf import DatasetsConfig
    from maestro_tpu_torch.parallel.distributed import initialize_distributed
    from maestro_tpu_torch.parallel.mesh import make_mesh
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed("cuda", init_method=f"file://{store}", world_size=2, rank=rank,
                           backend="gloo")
    import torch.distributed as dist

    datasets = DatasetsConfig(name_dataset="flair")
    mesh = make_mesh(2, 1, 1, "cuda")
    want = torch.load(Path(out) / "reference.pt", weights_only=False)
    result = {}
    try:
        for phase in ("pretrain", "finetune"):
            batch = make_synthetic_batch(datasets.dataset, 2 * PAR_BATCH, seed=5)
            rows = {k: v[rank * PAR_BATCH : (rank + 1) * PAR_BATCH] for k, v in batch.items()}
            zero_counts()
            got = _par_run(datasets, phase, rows, PAR_STEPS, mesh=mesh, timed=PAR_TIMED)
            got["plain"] = plain_counts()
            result[phase] = _par_compare(f"(b) rank {rank} {phase}", got, want[phase])
            result[phase]["plain_calls"] = got["plain"]
            if any(got["plain"].values()):
                raise AssertionError(f"(b) rank {rank}: plain versions ran: {got['plain']}")
        result["ok"] = True
    except Exception as exc:  # reported to the parent, which fails the script
        result = {"ok": False, "error": repr(exc)}
    torch.save(result, Path(out) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def parallel_phase(root, smi: str) -> dict:
    """Multi-process training on torch.distributed (``parallel/``), at full
    width: MAE medium, group fusion, the FLAIR-HUB plan.

    (a) one rank over NCCL in this process (a group of one on a free local
    port, a mesh of 1): pretrain and finetune steps at batch 8 under DDP and
    under ``fsdp=true``, each held against the unwrapped step on the same
    batch and masks, step 2 included, with every pool weight scaled between
    the steps (a stale bf16 copy of the weight would show), and the same
    kernel launches a step, no plain version; the group is destroyed after.
    (b) two DDP ranks sharing the card over gloo (spawned; the group made
    here, no knob): global batch 16, 8 a rank, held against one process at
    batch 16 on the card, each rank's launches counted.  (c) the CLI under
    the launcher (``torch.distributed.run --standalone --nproc_per_node=1``,
    ``trainer.fsdp=true``) over the experiment's FLAIR-HUB tiles, pretrain,
    probe and finetune 1 epoch each; its finetune checkpoint then loaded in
    this (plain) process, eval-only, must give the same test metrics.
    Returns the launches of the wrapped runs by kernel."""
    import ast
    import os

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from maestro_tpu_torch import main as cli
    from maestro_tpu_torch.conf import DatasetsConfig
    from maestro_tpu_torch.parallel.distributed import initialize_distributed
    from maestro_tpu_torch.parallel.mesh import make_mesh
    from maestro_tpu_torch.train import checkpoint as ckpt
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    t_phase = time.perf_counter()
    datasets = DatasetsConfig(name_dataset="flair")
    launches = dict.fromkeys(KERNEL_COUNTERS, 0)
    report = {"card": smi, "batch_per_rank": PAR_BATCH, "steps_checked": PAR_STEPS,
              "pool_weight_scale_between_steps": PAR_KV_SCALE}

    def add(runs):
        for run in runs:
            for counts in run["launches"]:
                for key, n in zip(KERNEL_COUNTERS, counts):
                    launches[key] += n

    # ---- (a) one rank over NCCL
    t0 = time.perf_counter()
    initialize_distributed("cuda", init_method=f"tcp://localhost:{_free_port()}",
                           world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, 1, "cuda")
        part_a = {"backend": dist.get_backend()}
        for phase in ("pretrain", "finetune"):
            batch = make_synthetic_batch(datasets.dataset, PAR_BATCH, seed=4)
            zero_counts()
            want = _par_run(datasets, phase, batch, PAR_STEPS, timed=PAR_TIMED)
            for mode in ("ddp", "fsdp"):
                zero_counts()
                got = _par_run(datasets, phase, batch, PAR_STEPS, mesh=mesh,
                               fsdp=mode == "fsdp", timed=PAR_TIMED)
                plain = plain_counts()
                if any(plain.values()):
                    raise AssertionError(f"parallel (a) {mode} {phase}: plain versions ran: {plain}")
                add([got])
                part_a[f"{phase}_{mode}"] = {**_par_compare(f"(a) {mode} {phase}", got, want),
                                             "plain_calls": plain}
                del got
            del want
    finally:
        dist.destroy_process_group()
    part_a["seconds"] = time.perf_counter() - t0
    report["a_one_rank_nccl"] = part_a
    emit({"parallel_a": part_a})

    # ---- (b) two DDP ranks sharing the card over gloo, against one process at 16
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="maestro_parallel_"))
    try:
        ref = {}
        for phase in ("pretrain", "finetune"):
            batch = make_synthetic_batch(datasets.dataset, 2 * PAR_BATCH, seed=5)
            ref[phase] = _par_run(datasets, phase, batch, PAR_STEPS, timed=PAR_TIMED)
        torch.save(ref, tmp / "reference.pt")
        del ref
        torch.cuda.empty_cache()
        mp.spawn(_par_rank, args=(str(tmp / "store"), str(tmp)), nprocs=2, join=True)
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [r["error"] for r in ranks if not r["ok"]]
    if failed:
        raise AssertionError(f"parallel (b): {failed}")
    part_b = {"backend": "gloo", "ranks": 2, "global_batch": 2 * PAR_BATCH,
              "per_rank": [{k: v for k, v in r.items() if k != "ok"} for r in ranks],
              "seconds": time.perf_counter() - t0}
    for r in ranks:
        for phase in ("pretrain", "finetune"):
            for row in r[phase]["steps"]:
                for key, n in zip(KERNEL_COUNTERS, row["launches"]):
                    launches[key] += n
    report["b_two_ranks_gloo"] = part_b
    emit({"parallel_b": part_b})

    # ---- (c) the CLI under the launcher, then eval-only in this process
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="maestro_parallel_cli_"))
    try:
        base = [f"datasets.root_dir={root}", "datasets.name_dataset=flair",
                "datasets.flair.rel_dir=", "model.model_size=medium", "model.fusion_mode=group",
                "model.inter_depth=3", "model.use_ema=true", "trainer.compute_dtype=bfloat16",
                "data.loader=threads", f"data.num_workers={EXP_WORKERS}",
                "opt_finetune.monitor=cosia/average_iou_val", "run.logged_images_per_epoch=1",
                f"run.exp_dir={tmp / 'runs'}"]
        base += [f"opt_{p}.batch_size={EXP_BATCH}" for p in PAR_EPOCHS]
        argv = base + ["run.exp_name=launcher", "trainer.fsdp=true"]
        argv += [f"opt_{p}.epochs={n}" for p, n in PAR_EPOCHS.items()]
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        repo = Path(__file__).resolve().parent
        env["PYTHONPATH"] = os.pathsep.join(p for p in (str(repo), env.get("PYTHONPATH")) if p)
        t_run = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node=1", "-m", "maestro_tpu_torch.main", *argv],
            cwd=str(repo), env=env, capture_output=True, text=True, timeout=900)
        run_s = time.perf_counter() - t_run
        if proc.returncode != 0:
            raise AssertionError(f"parallel (c): the launcher run failed (rc "
                                 f"{proc.returncode}):\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-6000:]}")
        printed = {line.split(" ", 1)[0]: ast.literal_eval(line.split(" ", 1)[1])
                   for line in proc.stdout.splitlines()
                   if line.split(" ", 1)[0] in PAR_EPOCHS and " {" in line}
        run_dir = next((tmp / "runs" / "launcher").iterdir())
        path = ckpt.find_latest_checkpoint(run_dir / "checkpoints", "finetune")
        if path is None or set(printed) != set(PAR_EPOCHS):
            raise AssertionError(f"parallel (c): phases printed {sorted(printed)}, "
                                 f"finetune checkpoint {path}")
        # the run joined a group of one, built the mesh and sharded the model
        # under FSDP2 (a unit per block and head), as its checkpoint records
        placed = ckpt.load_meta(path).get("parallel")
        if not placed or placed["mesh"] != {"data": 1, "model": 1} or not placed["fsdp"] or (
                placed["processes"] != 1 or placed["fsdp_units"] < 2
                or placed["sharded_parameters"] != placed["parameters"]):
            raise AssertionError(f"parallel (c): the launcher run was not placed on a mesh "
                                 f"under FSDP2: meta.json has {placed}")
        zero_counts()
        t_eval = time.perf_counter()
        evald = cli.main(base + ["run.exp_name=eval_only", "run.eval_only=true",
                                 f"run.load_ckpt_path={path}", "opt_pretrain.epochs=0",
                                 "opt_probe.epochs=0", "opt_finetune.epochs=1"])
        eval_s = time.perf_counter() - t_eval
        plain = plain_counts()
        got, want = evald["finetune"].test_metrics, printed["finetune"]
        diff = {k: abs(got.get(k, float("nan")) - v) for k, v in want.items()}
        if set(got) != set(want) or not all(d <= 1e-5 for d in diff.values()) or any(
                plain.values()):
            raise AssertionError(f"parallel (c): eval-only test metrics {got} vs the launcher "
                                 f"run's {want} (plain calls {plain})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    part_c = {"command": "python -m torch.distributed.run --standalone --nproc_per_node=1 -m "
                         "maestro_tpu_torch.main ... trainer.fsdp=true",
              "epochs": PAR_EPOCHS, "batch": EXP_BATCH, "run_seconds": run_s,
              "eval_only_seconds": eval_s, "test_metrics": want,
              "eval_only_max_abs_diff": max(diff.values()), "placement": placed,
              "launcher_stderr_tail": proc.stderr[-600:], "seconds": time.perf_counter() - t0}
    report["c_cli_launcher"] = part_c
    emit({"parallel_c": part_c})
    report["seconds"] = time.perf_counter() - t_phase
    emit({"parallel": {k: report[k] for k in ("card", "seconds")}})
    return launches


def main() -> None:
    want_profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the GPU only.",
              file=sys.stderr)
        sys.exit(1)
    if "--loader-e2e-run" in sys.argv[1:]:
        loader, root = sys.argv[sys.argv.index("--loader-e2e-run") + 1:][:2]
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
        emit({"loader_e2e_run": loader_e2e_run(root, loader, smi)})
        return

    from maestro_tpu_torch.conf import DatasetsConfig, MaskConfig, ModelConfig
    from maestro_tpu_torch.models import vit
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.ops import attention, attn_pool, cuda_build, fused_loss
    from maestro_tpu_torch.serve import make_predict_fn
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    if "--loader-e2e" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--loader-e2e") + 1:]
        order = rest[0].split(",") if rest and not rest[0].startswith("--") else E2E_ORDER
        loader_e2e(order, smi)
        return

    # ---- 2. the build (every source compiled in parallel at first use)
    attention._kernel()
    attn_pool._kernel()
    attn_pool._bwd_kernel()
    fused_loss._kernel()
    log = str(cuda_build.build_info.get("log", ""))
    emit({"build": {
        "seconds": round(float(cuda_build.build_info["seconds"]), 2),
        "directory": cuda_build.build_info["directory"],
        "sources": sorted(p.name for p in cuda_build.CSRC.glob("*.cu")),
        "ptxas_spill_lines": ptxas_spills(log),
        "attention_kernels": ptxas_kernels(log, ATTN_KERNEL_NAMES),
        "attention_dynamic_smem_bytes": {
            f"D={d}": {"fwd": attention.smem_bytes(d, backward=False),
                       "bwd": attention.smem_bytes(d, backward=True)}
            for d in attention.SUPPORTED_HEAD_DIMS},
        "pool_kernels": ptxas_kernels(log, POOL_KERNEL_NAMES),
        "loss_kernels": ptxas_kernels(log, ("patchnorm_fwd_multi", "patchnorm_bwd")),
        "pool_rows_dynamic_smem_bytes": {
            f"E={e}": {"fwd": attn_pool.smem_bytes(e, backward=False),
                       "bwd": attn_pool.smem_bytes(e, backward=True)}
            for e in POOL_SMEM_WIDTHS},
        "max_registers": max((int(ln.split("Used ")[1].split(" registers")[0])
                              for ln in log.splitlines() if "Used " in ln and " registers" in ln),
                             default=None),
    }})

    gen = torch.Generator(device="cuda").manual_seed(0)
    datasets = DatasetsConfig(name_dataset="flair")
    if "--serve-only" in sys.argv[1:]:  # the serving path alone (step 4 below)
        model, _ = build_model(
            datasets, MaskConfig(), ModelConfig(model_size="medium", fusion_mode="group",
                                                inter_depth=3),
            dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(0))
        batches = {b: make_synthetic_batch(datasets.dataset, b, seed=b) for b in REQUEST_BATCHES}
        serving_phase(model, batches, make_predict_fn(model, "finetune"), attention, attn_pool,
                      vit, want_profile)
        export_phase(model, batches, attention, attn_pool, vit, want_profile)
        return

    # ---- 3. every kernel vs its plain version
    attn_err = attention_fwd_checks(attention, gen)
    bwd_err = attention_bwd_checks(attention, gen)
    attention_repeat_checks(attention, gen)
    pool_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in POOL_CHECK_SHAPES:
            args = pool_inputs(shape, dtype, gen)
            out, m, den = attn_pool.attentive_pool(*args, POOL_HEADS)
            torch.cuda.synchronize()
            out_p, m_p, den_p = attn_pool.attentive_pool_plain(*args, POOL_HEADS)
            name = f"pool {shape} {dtype}"
            max_abs, over = check_close(name + " out", out, out_p, POOL_TOL[dtype])
            m_err, m_over = check_close(name + " m", m, m_p, POOL_STATS_TOL[dtype])
            den_err, den_over = check_close(name + " den", den, den_p, POOL_STATS_TOL[dtype])
            emit({"check": "attentive_pool_fwd", "dtype": str(dtype), "shape": list(shape),
                  "heads": POOL_HEADS, "tolerance_x_abs_plus_rms": POOL_TOL[dtype],
                  "max_abs_err": max_abs, "max_err_over_tolerance": over,
                  "stats_tolerance": POOL_STATS_TOL[dtype], "m_max_abs_err": m_err,
                  "m_max_err_over_tolerance": m_over, "den_max_abs_err": den_err,
                  "den_max_err_over_tolerance": den_over})
            if dtype == torch.bfloat16 and shape == POOL_CHECK_SHAPES[0]:
                pool_err = max_abs
    pool_bwd_err = pool_bwd_checks(attn_pool, gen)
    pool_repeat_checks(attn_pool, gen)
    model_cfg = ModelConfig(model_size="medium", fusion_mode="group", inter_depth=3)
    model, plan = build_model(
        datasets, MaskConfig(), model_cfg, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(0),
    )
    loss_sum_err, loss_grad_err = loss_checks(fused_loss, plan, gen)

    # ---- 4. the serving path
    predict = make_predict_fn(model, "finetune")
    stream_lengths = {name: s.seq_len for name, s in plan.streams.items()}
    emit({"model": {"size": "medium", "dataset": "flair", "fusion": "group", "inter_depth": 3,
                    "dtype": "bfloat16", "params": sum(p.numel() for p in model.parameters()),
                    "stream_lengths": stream_lengths,
                    "kept_lengths": {n: s.seq_len - s.num_masked for n, s in plan.streams.items()},
                    "trunk_length": sum(stream_lengths.values())}})
    batches = {b: make_synthetic_batch(datasets.dataset, b, seed=b) for b in REQUEST_BATCHES}
    serve_launches = serving_phase(model, batches, predict, attention, attn_pool, vit,
                                   want_profile)
    # ---- 4b. serving artifacts and int8 serving (serve.export_*, quant.py)
    export_launches = export_phase(model, batches, attention, attn_pool, vit, want_profile)
    heads, dim_head = model.arch.heads, model.arch.dim_head
    dec_heads, dec_dim_head = model.arch.decoder_heads, model.arch.decoder_dim_head
    depth, inter_depth = model.arch.depth - model.inter_depth, model.inter_depth
    dec_depth = model.arch.decoder_depth
    del model, predict, batches
    torch.cuda.empty_cache()

    # ---- 5. the pretrain path
    card = smi.split(",")[0].strip()
    train = train_phase(datasets, card, want_profile)
    train_batch = train["batch"]

    # ---- 5c. the finetune and probe paths
    sup = supervised_phase(datasets, card, want_profile)
    sl = sup["launches"]

    # ---- 5d. the pretrain eval step, skip_nonfinite and remat
    pe = pretrain_eval_phase(datasets)
    sk = skip_nonfinite_phase(datasets)
    rd = remat_phase(datasets)

    # ---- 5e. the baseline adapters at their release sizes (PASTIS-HD)
    bl = baselines_phase(card)

    # ---- 5f. the experiment path, the released weights (phase ``released``), then a
    # baseline through the CLI from its ported release, over tiles on disk
    tiles = Path(tempfile.mkdtemp(prefix="maestro_tiles_"))
    work = Path(tempfile.mkdtemp(prefix="maestro_released_"))  # 1.2-1.4 GB files
    try:
        t0 = time.perf_counter()
        data_bytes = write_flair_tiles(tiles, EXP_TILES)
        emit({"experiment_data": {"tiles": EXP_TILES, "bytes": data_bytes,
                                  "write_s": time.perf_counter() - t0}})
        ex = experiment_phase(tiles, smi)
        t0 = time.perf_counter()
        rel = released_phase(tiles, smi, card, datasets, work)
        bc = baseline_cli_phase(tiles, smi, pretrained=rel["dinov2_flair"])
        emit({"released_seconds": time.perf_counter() - t0})
        # ---- 5g. multi-process training (parallel/): DDP and FSDP2 on one
        # rank over NCCL, two DDP ranks over gloo, the CLI under the launcher
        pl = parallel_phase(tiles, smi)
    finally:
        shutil.rmtree(tiles, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)

    # ---- 6. kernel times at the main paths' shapes, back to back
    # (inputs stay warm in L2, as they are right after the qkv projection)
    shapes = [(length, depth) for length in stream_lengths.values()]
    shapes.append((sum(stream_lengths.values()), inter_depth))
    attn_rows, totals = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_kinds = {}
    for length, count in shapes:
        q, k, v = qkv_views(8, length, heads, dim_head, torch.bfloat16, gen)
        scale = dim_head**-0.5
        ms = time_ms(lambda: attention.mha_blhd(q, k, v, scale), 20)
        plain_ms = time_ms(lambda: attention.mha_blhd_plain(q, k, v, scale), 3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=scale), 20)
        bound_ms, bound_by = attention_bound(8, length, heads, dim_head, torch.bfloat16)
        attn_rows.append({"shape": [8, length, heads, dim_head], "calls_per_request": count,
                          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by})
        bound_kinds[bound_by] = bound_kinds.get(bound_by, 0.0) + count * bound_ms
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bound_ms)):
            totals[key] += count * val
    pool_shape = (8, 26, 2 * 32, 768)  # all dates x (seg_chunk_rows x ref grid) positions
    pargs = pool_inputs(pool_shape, torch.bfloat16, gen)
    pool_ms = time_ms(lambda: attn_pool.attentive_pool(*pargs, POOL_HEADS), 20)
    pool_plain_ms = time_ms(lambda: attn_pool.attentive_pool_plain(*pargs, POOL_HEADS), 5)
    pool_bound_ms, pool_bound_by = pool_bound(*pool_shape, POOL_HEADS)
    del pargs
    # the pool at the supervised steps' shapes: forward at the finetune and
    # probe shapes, backward at both (ref rows per chunk x grid 32)
    ft_shape = (sup["timed"]["finetune"]["batch"], 26, SUP_CHUNK["finetune"] * 32, 768)
    pr_shape = (sup["timed"]["probe"]["batch"], 26, SUP_CHUNK["probe"] * 32, 768)
    pool_fwd_rows = {}
    for shape, phase in ((ft_shape, "finetune"), (pr_shape, "probe")):
        pargs = pool_inputs(shape, torch.bfloat16, gen)
        w16 = pargs[3].to(torch.bfloat16)
        bound_ms, bound_by = pool_bound(*shape, POOL_HEADS)
        pool_fwd_rows[phase] = {
            "shape": list(shape), "launches_per_step": SUP_LAUNCHES[phase][2],
            "ms": time_ms(lambda: attn_pool.attentive_pool(*pargs, POOL_HEADS, w_kv_bf16=w16), 10),
            "plain_ms": time_ms(lambda: attn_pool.attentive_pool_plain(*pargs, POOL_HEADS), 3,
                                warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_jax_count": pool_bound_jax_count(*shape, POOL_HEADS)[0]}
        del pargs, w16
    pool_bwd_rows = []
    for shape, phase in ((ft_shape, "finetune"), (pr_shape, "probe")):
        x, sc, bi, w, q = pool_inputs(shape, torch.bfloat16, gen)
        w16 = w.to(torch.bfloat16)
        out, m, den = attn_pool.attentive_pool(x, sc, bi, w, q, POOL_HEADS, w_kv_bf16=w16)
        g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
        need_dx = phase == "finetune"  # the probe phase's pool input needs no gradient
        ms = time_ms(lambda: attn_pool.attentive_pool_bwd(
            x, sc, bi, w16, q, out, m, den, g, POOL_HEADS, need_dx=need_dx), 10)
        plain_ms = time_ms(lambda: attn_pool.attentive_pool_bwd_plain(
            x, sc, bi, w, q, out, m, den, g, POOL_HEADS, need_dx=need_dx), 3, warmup=1)
        bound_ms, bound_by = pool_bwd_bound(*shape, POOL_HEADS, need_dx)
        pool_bwd_rows.append({"shape": list(shape), "phase": phase, "dx": need_dx,
                              "launches_per_step": SUP_LAUNCHES[phase][3], "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                              "bound_ms_jax_count":
                                  pool_bwd_bound_jax_count(*shape, POOL_HEADS)[0]})
        del x, sc, bi, w, q, w16, out, m, den, g
    torch.cuda.empty_cache()
    # the finetune step's attention backward at full length: the trunk and the
    # aerial stream, SDPA's backward beside it
    ft_bwd_rows = []
    ft_batch = sup["timed"]["finetune"]["batch"]
    for length, count in ((sum(stream_lengths.values()), inter_depth),
                          (max(stream_lengths.values()), depth)):
        scale = dim_head**-0.5
        qkv = qkv_fused(ft_batch, length, heads, dim_head, torch.bfloat16, gen)
        q, k, v = qkv.unbind(dim=2)
        out, lse = attention._fwd(q, k, v, scale, with_lse=True)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
        ms = time_ms(lambda: attention._bwd(q, k, v, out, lse, dout, scale), 5)
        plain_in = qkv.detach().requires_grad_(True)
        plain_out = attention.mha_qkv_plain(plain_in, scale)
        plain_ms = time_ms(lambda: torch.autograd.grad(plain_out, plain_in, dout,
                                                       retain_graph=True), 2, warmup=1)
        del plain_in, plain_out
        lib_in = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*lib_in, scale=scale)
        dout_t = dout.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_in, dout_t, retain_graph=True), 5)
        bound_ms, bound_by = attention_bwd_bound(ft_batch, length, heads, dim_head, torch.bfloat16)
        ft_bwd_rows.append({"shape": [ft_batch, length, heads, dim_head], "calls_per_step": count,
                            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by})
        del qkv, q, k, v, out, lse, dout, lib_in, lib_out
        torch.cuda.empty_cache()

    # the pretrain step's attention shapes: (length, heads, dim, launches per step)
    kept = [s.seq_len - s.num_masked for s in train["plan"].streams.values()]
    train_shapes = ([(l, heads, dim_head, depth) for l in kept]
                    + [(sum(kept), heads, dim_head, inter_depth)]
                    + [(l, dec_heads, dec_dim_head, dec_depth) for l in stream_lengths.values()])
    bwd_rows = []
    bwd_totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "fwd_ms": 0.0}
    bwd_kinds = {}
    for length, h, d, count in train_shapes:
        scale = d**-0.5
        qkv = qkv_fused(train_batch, length, h, d, torch.bfloat16, gen)
        q, k, v = qkv.unbind(dim=2)
        out, lse = attention._fwd(q, k, v, scale, with_lse=True)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
        fwd_ms = time_ms(lambda: attention._fwd(q, k, v, scale, with_lse=True), 10)
        ms = time_ms(lambda: attention._bwd(q, k, v, out, lse, dout, scale), 10)
        plain_in = qkv.detach().requires_grad_(True)
        plain_out = attention.mha_qkv_plain(plain_in, scale)
        plain_ms = time_ms(lambda: torch.autograd.grad(plain_out, plain_in, dout,
                                                       retain_graph=True), 3, warmup=1)
        del plain_in, plain_out
        lib_in = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*lib_in, scale=scale)
        dout_t = dout.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_in, dout_t, retain_graph=True), 10)
        del lib_in, lib_out
        bound_ms, bound_by = attention_bwd_bound(train_batch, length, h, d, torch.bfloat16)
        bwd_rows.append({"shape": [train_batch, length, h, d], "calls_per_step": count,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "fwd_with_lse_ms": fwd_ms})
        bwd_kinds[bound_by] = bwd_kinds.get(bound_by, 0.0) + count * bound_ms
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bound_ms), ("fwd_ms", fwd_ms)):
            bwd_totals[key] += count * val
        del qkv, q, k, v, out, lse, dout
    # the loss: the forward as a step calls it (one grouped launch over the
    # five modalities) and per modality alone; the backward per modality
    loss_rows = {"fwd": [], "bwd": []}
    loss_totals = {d: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0} for d in loss_rows}
    loss_kinds = {d: {} for d in loss_rows}
    items = []
    for name, (n, f, slices) in flair_loss_rows(train["plan"], train_batch).items():
        t, r, m = loss_inputs(n, f, torch.bfloat16, gen)
        items.append((t, r, m, slices))
        g = torch.tensor(0.37, device="cuda")
        runs = {
            "fwd": (lambda: fused_loss._fwd_multi_kernel([(t, r, m, slices)], False),
                    lambda: fused_loss.masked_patchnorm_sums_plain_fwd(t, r, m, slices, False)),
            "bwd": (lambda: fused_loss._bwd_kernel(t, r, m, g, slices, False),
                    lambda: fused_loss.masked_patchnorm_sums_plain_bwd(t, r, m, g, slices, False)),
        }
        for direction, (kernel_fn, plain_fn) in runs.items():
            ms = time_ms(kernel_fn, 10)
            plain_ms = time_ms(plain_fn, 3, warmup=1)
            bound_ms, bound_by = loss_bound(n, f, 2, direction == "bwd")
            loss_rows[direction].append({"modality": name, "rows": [n, f], "ms": ms,
                                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                                         "bound_by": bound_by, "bound_share": bound_ms / ms})
            loss_kinds[direction][bound_by] = loss_kinds[direction].get(bound_by, 0.0) + bound_ms
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                loss_totals[direction][key] += val
        del t, r, m
    loss_totals["fwd"]["ms_sum_alone"] = loss_totals["fwd"]["ms"]
    loss_totals["fwd"]["ms"] = time_ms(lambda: fused_loss._fwd_multi_kernel(items, False), 20)
    loss_totals["fwd"]["plain_ms"] = time_ms(
        lambda: fused_loss.masked_patchnorm_sums_multi_plain(items, False), 3, warmup=1)
    del items

    emit({"seconds_total": round(time.perf_counter() - t_start, 1)})
    tl = train["launches"]
    # the launches of the paths this slice added, by counter
    export_counts = {"attention_fwd": export_launches["attention"],
                     "pool_fwd": export_launches["pool"]}
    extra = lambda key: {"export": export_counts.get(key, 0),  # noqa: E731
                         "pretrain_eval": pe.get(key, 0), "skip_nonfinite": sk.get(key, 0),
                         "finetune_remat_dots": rd.get(key, 0), "experiment": ex[key],
                         "baselines": bl["launches"].get(key, 0), "released": rel["launches"][key],
                         "baseline_cli": bc[key], "parallel": pl[key]}
    loss_entry = lambda direction, fn_name, line, key, err, per_step, times: {  # noqa: E731
        "name": fn_name, "route": "cuda", "source": "maestro_tpu_torch/csrc/fused_loss.cu",
        "replaces": f"maestro_tpu/ops/fused_loss.py:{line}",
        "launches": tl[key] + ex[key] + rel["launches"][key] + pl[key],
        "launches_per_step": per_step,
        "launches_by_path": {"serve": 0, "train": tl[key], "finetune": 0, "probe": 0,
                             "experiment": ex[key], "released": rel["launches"][key],
                             "parallel": pl[key]},
        "max_abs_err": err, **loss_totals[direction],
        "bound_by": max(loss_kinds[direction], key=loss_kinds[direction].get),
        "bound_share": loss_totals[direction]["bound_ms"] / loss_totals[direction]["ms"],
        "library_ms": None, "times_are": times, "per_shape": loss_rows[direction]}
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "maestro_tpu_torch/csrc/flash_attention.cu",
         "design": "attn_fwd_wgmma: 128 query rows a block, two warpgroups; 128-key K/V "
                   "tiles by TMA through a 2-stage mbarrier ring (refilled by the second "
                   "warpgroup done with a tile); S = QK^T and O += PV as wgmma, online softmax "
                   "in registers (ex2)",
         "replaces": "maestro_tpu/ops/attention.py:270",
         "also_replaces": ["maestro_tpu/ops/attention.py:488", "maestro_tpu/ops/attention.py:124",
                           "maestro_tpu/ops/attention.py:82"],
         "launches": (serve_launches["attention"] + tl["attention_fwd"]
                      + sl["finetune"]["attention_fwd"] + sl["probe"]["attention_fwd"]
                      + sum(extra("attention_fwd").values())),
         "launches_by_path": {"serve": serve_launches["attention"], "train": tl["attention_fwd"],
                              "finetune": sl["finetune"]["attention_fwd"],
                              "probe": sl["probe"]["attention_fwd"], **extra("attention_fwd")},
         "max_abs_err": attn_err,
         "ms": totals["ms"], "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
         "bound_by": max(bound_kinds, key=bound_kinds.get), "library_ms": totals["library_ms"],
         "times_are": "sum over the 39 launches of one batch-8 request, bf16",
         "train_step_fwd_with_lse_ms": bwd_totals["fwd_ms"],
         "per_shape": attn_rows,
         "released_shapes": [{"shape": r["shape"], **r["fwd"]} for r in rel["attention"]]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "maestro_tpu_torch/csrc/flash_attention_bwd.cu",
         "design": "attn_bwd_delta (Delta, lse * log2 e in padded rows; zeroes the fp32 dQ "
                   "scratch), attn_bwd_wgmma: 128 keys a block, two warpgroups, K/V loaded "
                   "once by TMA, 64-query Q/dO tiles through a 2-stage mbarrier ring, five "
                   "wgmma products per tile (S formed once), dQ partials added by bulk "
                   "reduce-add; attn_bwd_dq_convert",
         "replaces": "maestro_tpu/ops/attention.py:289",
         "also_replaces": ["maestro_tpu/ops/attention.py:507", "maestro_tpu/ops/attention.py:141",
                           "maestro_tpu/ops/attention.py:82"],
         "launches": (tl["attention_bwd"] + sl["finetune"]["attention_bwd"]
                      + sl["probe"]["attention_bwd"] + sum(extra("attention_bwd").values())),
         "launches_by_path": {"serve": 0, "train": tl["attention_bwd"],
                              "finetune": sl["finetune"]["attention_bwd"],
                              "probe": sl["probe"]["attention_bwd"], **extra("attention_bwd")},
         "max_abs_err": bwd_err,
         "ms": bwd_totals["ms"], "plain_ms": bwd_totals["plain_ms"],
         "bound_ms": bwd_totals["bound_ms"], "bound_by": max(bwd_kinds, key=bwd_kinds.get),
         "library_ms": bwd_totals["library_ms"],
         "times_are": f"sum over the {ATTN_PER_STEP} calls of one batch-{train_batch} train "
                      "step, bf16; a call is three launches (Delta and scratch zeroing, the wgmma "
                      "kernel, the dq convert); library = "
                      "the backward of scaled_dot_product_attention",
         "per_shape": bwd_rows, "finetune_full_length_shapes": ft_bwd_rows,
         "released_shapes": [{"shape": r["shape"], **r["bwd"]} for r in rel["attention"]]},
        loss_entry("fwd", "masked_patchnorm_sums_fwd_multi", 53, "loss_fwd", loss_sum_err,
                   LOSS_FWD_PER_STEP,
                   f"one grouped launch over the five modalities of a batch-{train_batch} train "
                   "step (ms), bf16 staging, l1; ms_sum_alone and per_shape: each modality "
                   "alone (a grouped launch of one)"),
        loss_entry("bwd", "masked_patchnorm_sums_bwd", 76, "loss_bwd", loss_grad_err,
                   LOSS_BWD_PER_STEP,
                   f"sum over the {LOSS_BWD_PER_STEP} launches of one batch-{train_batch} train "
                   "step (one per modality), bf16 staging, l1"),
        {"name": "attentive_pool_fwd", "route": "cuda",
         "source": "maestro_tpu_torch/csrc/attn_pool.cu",
         "design": "factored form, three launches: pool_u (u = query . W_k per head, fp32), "
                   "pool_fwd_rows (a block per run of positions, 4 columns a thread: x read "
                   "once, LayerNorm, logits y . u_h, online softmax over 4-date steps, ybar_h = "
                   "sum_d a y_d in fp32 registers; block sums by warp butterflies and "
                   "fixed-order finishing), pool_mma (out_h = ybar_h . W_v,h^T, mma.sync "
                   "64 x 64 tiles, cp.async ring)",
         "replaces": "maestro_tpu/ops/attn_pool.py:72",
         "launches": (serve_launches["pool"] + sl["finetune"]["pool_fwd"]
                      + sl["probe"]["pool_fwd"] + sum(extra("pool_fwd").values())),
         "launches_by_path": {"serve": serve_launches["pool"], "train": 0,
                              "finetune": sl["finetune"]["pool_fwd"],
                              "probe": sl["probe"]["pool_fwd"], **extra("pool_fwd")},
         "max_abs_err": pool_err,
         "ms": pool_ms, "plain_ms": pool_plain_ms, "bound_ms": pool_bound_ms,
         "bound_by": pool_bound_by, "library_ms": None,
         "bound_ms_jax_count": pool_bound_jax_count(*pool_shape, POOL_HEADS)[0],
         "times_are": "one call (three launches) at [8, 26, 64, 768] bf16, 8 heads; 16 calls "
                      "per request; bound_ms counts the factored form's least work, "
                      "bound_ms_jax_count the JAX kernel's",
         "finetune_shape": pool_fwd_rows["finetune"], "probe_shape": pool_fwd_rows["probe"]},
        {"name": "attentive_pool_bwd", "route": "cuda",
         "source": "maestro_tpu_torch/csrc/attn_pool_bwd.cu",
         "design": "factored form, six launches: pool_u; pool_mma (dybar_h = W_v,h^T g_h, fp32 "
                   "out); pool_bwd_rows (per position T and dybar, per 4-date step LayerNorm, "
                   "logits and da in one block sum, a from the saved m and den, dlogit, dy, the "
                   "LayerNorm backward into dx; du, ybar, d_ln_scale, d_ln_bias accumulated per "
                   "block); pool_mma (dW_v = G_h^T ybar_h, K split in slices); column_sums and "
                   "pool_bwd_finish (dW_k, d_query rank-1 from du; dW_v slices in order); no "
                   "atomics",
         "replaces": "maestro_tpu/ops/attn_pool.py:123",
         "launches": (sl["finetune"]["pool_bwd"] + sl["probe"]["pool_bwd"]
                      + sum(extra("pool_bwd").values())),
         "launches_by_path": {"serve": 0, "train": 0, "finetune": sl["finetune"]["pool_bwd"],
                              "probe": sl["probe"]["pool_bwd"], **extra("pool_bwd")},
         "max_abs_err": pool_bwd_err,
         "ms": pool_bwd_rows[0]["ms"], "plain_ms": pool_bwd_rows[0]["plain_ms"],
         "bound_ms": pool_bwd_rows[0]["bound_ms"], "bound_by": pool_bwd_rows[0]["bound_by"],
         "library_ms": None, "bound_ms_jax_count": pool_bwd_rows[0]["bound_ms_jax_count"],
         "times_are": f"one call (six launches) at {list(ft_shape)} bf16, 8 heads, with dx: "
                      "the finetune step's; max_abs_err is dx's at [8, 26, 128, 768] against fp32 "
                      "autograd of the plain version",
         "per_shape": pool_bwd_rows},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
