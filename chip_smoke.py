"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py            # what the checks need
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of requests and steps

Builds the hand-written CUDA kernels from ``maestro_tpu_torch/csrc`` (and
reports the attention kernels' registers, shared memory and spills from the
``ptxas`` log), holds each against its plain PyTorch version on the card (the
attention kernels also at one row past a 128-row tile for every head dim, at
the full-length trunk at batch 1, and twice on the same inputs: dk and dv
bit-identical, dq within 1 bf16 ulp of max(|dq|, rms(dq))), then drives the
port's main paths with seeded random weights and inputs (MAE medium,
FLAIR-HUB plan, group fusion, 3 trunk blocks, bf16 compute, fp32 parameters):

* serving — ``serve.make_predict_fn(model, "finetune")`` for requests of batch
  1, 4 and 8: launch counts, shapes, finiteness and agreement with the same
  model run through the plain versions;
* pretraining — ``train.steps.make_pretrain_step`` (token-space l1_norm loss,
  AdamW with the closed-form OneCycle schedule): three steps at batch 8
  through the kernels and through the plain versions from the same weights
  and masks, with launch counts per step; then timed steps at batch 48;
* finetuning and probing — ``train.steps.make_supervised_step`` (the
  ``cosia`` segmentation head, 15 classes, its date pool over 26 dates):
  three steps of each phase at batch 8 through the kernels and through the
  plain versions from the same weights, with launch counts per step and the
  step-1 gradients (all trained parameters, the pool's, the encoders') held
  against the plain path by cosine; then timed steps
  at the JAX bench's batches (finetune 32 with 4 ref rows a head chunk, probe
  48 with 2), the EMA update and the batch-32 EMA eval step.

Output: one JSON object per line.  The second-to-last line is the
``{"kernels": [...]}`` record, the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises: the exit code is then non-zero and no result line is
printed.  Without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

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
ATTN_CHECK_HEADS = ((6, 128), (12, 64), (3, 64), (16, 32), (8, 96))
ATTN_CHECK_BATCH = {(6, 128): 8}  # the serving path's heads at its largest batch; else 2
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
)
# two backward calls on the same inputs: dk, dv bit-identical, dq (summed in an
# order that varies) within 1 bf16 ulp, taken at max(|dq|, rms(dq)) as the other
# checks take their tolerance at |want| + rms (an entry near 0 is a sum that
# cancels, and moves by more of its own ulps)
REPEAT_CHECK_SHAPES = ((8, 470, 6, 128), (2, 1880, 6, 128), (2, 129, 16, 32))
# the attention kernels of csrc/flash_attention*.cu, for the ptxas report
ATTN_KERNEL_NAMES = ("attn_fwd_wgmma", "attn_bwd_wgmma", "attn_bwd_dq_convert", "attn_bwd_delta")
# head dims 96, 96, 16, 48, 128: every one attn_pool.cu is built for
POOL_CHECK_SHAPES = ((8, 26, 64, 768), (8, 26, 128, 768), (2, 2, 40, 128),
                     (2, 5, 64, 384), (2, 3, 40, 1024))
POOL_HEADS = 8
# (shape, dx wanted): the finetune and probe pool shapes at batch 8, then head
# dims 16, 48, 128 with 5 or 26 dates and ragged L, then dx skipped (probe)
POOL_BWD_CHECK_CASES = (((8, 26, 128, 768), True), ((8, 26, 64, 768), True),
                        ((2, 5, 40, 128), True), ((2, 26, 33, 384), True),
                        ((2, 5, 40, 1024), True), ((8, 26, 64, 768), False))
REQUEST_BATCHES = (1, 4, 8)
ATTN_PER_REQUEST = 39  # 4 streams x 9 blocks + 3 trunk blocks
POOL_PER_REQUEST = 16  # ref grid 32 rows / seg_chunk_rows 2
# per pretrain step: 4 x 9 encoder + 3 trunk + 4 x 3 decoder blocks; 5 modalities
ATTN_PER_STEP = 51
LOSS_PER_STEP = 5
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


def pool_bound(b: int, d: int, l: int, e: int, heads: int) -> tuple[float, str]:
    nbytes = b * d * l * e * 2 + b * l * e * 2 + 2 * b * l * heads * 4 + 2 * e * e * 2 + 3 * e * 4
    return bound(nbytes, 4 * b * d * l * e * e, PEAK_BF16_FLOPS)


def pool_bwd_bound(b: int, d: int, l: int, e: int, heads: int) -> tuple[float, str]:
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
    for dtype in (torch.bfloat16, torch.float32):
        for b, l, h, d in BWD_CHECK_SHAPES:
            qkv = qkv_fused(b, l, h, d, dtype, gen).requires_grad_(True)
            out = attention.mha_qkv(qkv, d**-0.5)
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
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
    emit({"check": "flash_attention_bwd", "cases": 2 * len(BWD_CHECK_SHAPES) + 1, "ok": True})
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
                      "d_rec_max_abs_err": diff.max().item(),
                      "d_rec_elements_over_tolerance": flips,
                      "d_rec_tolerance_x_abs_plus_rms": LOSS_GRAD_TOL[dtype]})
                if dtype == torch.bfloat16:
                    sum_err = max(sum_err, abs(s.item() - s_p.item()))
                    grad_err = max(grad_err, diff.max().item())
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
                row[name] = {"rel_norm_err": rel, "max_abs_err": (gk.float() - gw).abs().max().item()}
            emit(row)
            del x, params, out, g, got, ref_x, ref_p, ref, want
    emit({"check": "attentive_pool_bwd", "cases": 2 * len(POOL_BWD_CHECK_CASES), "ok": True})
    return dx_err


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


def train_phase(datasets, card: str, want_profile: bool) -> dict:
    """Pretrain steps: kernel path vs plain path at batch 8 (counts from 0),
    then timed steps at the JAX bench's batch, TRAIN_BATCH."""
    from maestro_tpu_torch.conf import MaskConfig, ModelConfig, OptPretrainConfig
    from maestro_tpu_torch.models import vit
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.ops import attention, fused_loss
    from maestro_tpu_torch.train.optim import make_optimizer
    from maestro_tpu_torch.train.state import TrainState
    from maestro_tpu_torch.train.steps import make_pretrain_step
    from maestro_tpu_torch.utils.flops import decoder_mlp_undercount, mae_model_flops
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    def fresh(batch_size: int):
        model, plan = build_model(
            datasets, MaskConfig(),
            ModelConfig(model_size="medium", fusion_mode="group", inter_depth=3),
            dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(0),
        )
        tx = make_optimizer(OptPretrainConfig(batch_size=batch_size), "pretrain", 1000, model)
        return model, plan, TrainState.create(model, tx), make_pretrain_step(model, plan, tx)

    def counts():
        return (attention.launch_count, attention.bwd_launch_count,
                fused_loss.fwd_launch_count, fused_loss.bwd_launch_count)

    def run(steps: int, state, step, batch):
        """Losses and launches per step; the update of step 1 and the norm of
        the trained parameters before it."""
        trained = [p for g in state.tx.adamw.param_groups for p in g["params"]]
        p0 = torch.cat([p.detach().flatten() for p in trained])
        losses, per_step, update = [], [], None
        for i in range(steps):
            before = counts()
            state, logs = step(state, batch, 0)
            losses.append(logs["loss_rec"].item())
            per_step.append([a - b for a, b in zip(counts(), before)])
            if i == 0:
                update = torch.cat([p.detach().flatten() for p in trained]) - p0
        return losses, update, per_step, p0.norm().item()

    # ---- (a) kernel path vs plain path, same weights and masks, batch 8
    batch = make_synthetic_batch(datasets.dataset, CHECK_BATCH, seed=0)
    model, plan, state, step = fresh(CHECK_BATCH)
    for name in ("launch_count", "bwd_launch_count"):
        setattr(attention, name, 0)
    fused_loss.fwd_launch_count = fused_loss.bwd_launch_count = 0
    losses_k, update_k, per_step, norm0 = run(3, state, step, batch)
    launches = dict(zip(("attention_fwd", "attention_bwd", "loss_fwd", "loss_bwd"), counts()))
    want = [ATTN_PER_STEP, ATTN_PER_STEP, LOSS_PER_STEP, LOSS_PER_STEP]
    if any(n != want for n in per_step) or 0 in launches.values():
        raise AssertionError(f"train step launches {per_step}, expected {want} per step")
    del model, state, step
    model, _, state, step = fresh(CHECK_BATCH)
    kernel_fns = (vit.mha_qkv, fused_loss.masked_patchnorm_sums)
    vit.mha_qkv = attention.mha_qkv_plain
    fused_loss.masked_patchnorm_sums = fused_loss.masked_patchnorm_sums_plain_fwd
    try:
        losses_p, update_p, per_step_p, _ = run(3, state, step, batch)
    finally:
        vit.mha_qkv, fused_loss.masked_patchnorm_sums = kernel_fns
    if any(any(n) for n in per_step_p):
        raise AssertionError("the plain path launched a kernel")
    rel_k = update_k.norm().item() / norm0
    rel_p = update_p.norm().item() / norm0
    cos = torch.nn.functional.cosine_similarity(update_k, update_p, dim=0).item()
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
    emit({"train_agreement": {
        "batch": CHECK_BATCH, "loss_kernel_path": losses_k, "loss_plain_path": losses_p,
        "loss_rel_err": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
        "step1_update_rel_norm_kernel": rel_k, "step1_update_rel_norm_plain": rel_p,
        "update_rel_norm_rtol": STEP_UPDATE_RTOL, "step1_update_cosine": cos,
        "launches_per_step": dict(zip(("attention_fwd", "attention_bwd", "loss_fwd",
                                       "loss_bwd"), per_step[0]))}})
    if not all(e <= STEP_LOSS_RTOL for e in loss_rel) or not all(map(math.isfinite, losses_k)):
        raise AssertionError(f"train losses disagree: {losses_k} vs {losses_p}")
    if not abs(rel_k - rel_p) <= STEP_UPDATE_RTOL * rel_p:
        raise AssertionError(f"step-1 updates disagree: {rel_k} vs {rel_p}")
    del model, state, step, update_k, update_p
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
    emit({"train_step": {
        "batch": bsz, "remat": False, "step_ms_median": step_ms, "step_ms_all": times,
        "host_clock_ms_per_step": wall_ms,
        "step_ms_numpy_batch_and_loss_read_every_step": synced,
        "tokens_per_sample": tokens, "tokens_per_s": tokens * bsz / (step_ms / 1e3),
        "model_flops_per_step": flops, "model_flops_per_step_real_decoder_mlp": flops_real,
        "peak_bf16_flops": peak, "peak_from": card,
        "mfu": None if peak is None else flops / (step_ms / 1e3) / peak,
        "mfu_real_decoder_mlp": None if peak is None else flops_real / (step_ms / 1e3) / peak,
        "peak_memory_bytes": peak_mem, "losses": losses}})
    if want_profile:
        emit({"profile": {"path": "train", "batch": bsz,
                          **profile_device(lambda: step(state, batch, 0), step_ms)}})
    del model, state, step
    torch.cuda.empty_cache()
    return {"launches": launches, "batch": bsz, "plan": plan}


def supervised_phase(datasets, card: str, want_profile: bool) -> dict:
    """Finetune and probe steps: kernel path vs plain path at batch 8 (counts
    from 0 for each path), then timed steps at the JAX bench's batch, the EMA
    update and the EMA eval step."""
    from maestro_tpu_torch.conf import MaskConfig, ModelConfig, OptFinetuneConfig, OptProbeConfig
    from maestro_tpu_torch.models import vit
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

    def fresh(phase: str, batch_size: int, use_ema: bool = False):
        model, plan = build_model(
            datasets, MaskConfig(),
            ModelConfig(model_size="medium", fusion_mode="group", inter_depth=3,
                        seg_chunk_rows=SUP_CHUNK[phase]),
            dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(0),
        )
        tx = make_optimizer(opt_cls[phase](batch_size=batch_size), phase, 1000, model)
        return (model, plan, TrainState.create(model, tx, use_ema=use_ema),
                make_supervised_step(model, phase, tx))

    def counts():
        return (attention.launch_count, attention.bwd_launch_count,
                attn_pool.launch_count, attn_pool.bwd_launch_count)

    def zero_counts():
        attention.launch_count = attention.bwd_launch_count = 0
        attn_pool.launch_count = attn_pool.bwd_launch_count = 0

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
    for phase in ("finetune", "probe"):
        # ---- (a) kernel path vs plain path, same weights, batch 8
        batch = make_synthetic_batch(datasets.dataset, CHECK_BATCH, seed=0)
        model, _, state, step = fresh(phase, CHECK_BATCH)
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
        vit.mha_qkv, vit.attentive_pool = attention.mha_qkv_plain, plain_pool(attn_pool)
        try:
            losses_p, update_p, per_step_p, _, grads_p, unchanged_p, cm_p = run(
                model, state, step, batch)
        finally:
            vit.mha_qkv, vit.attentive_pool = kernel_fns
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
            "phase": phase, "batch": CHECK_BATCH, "seg_chunk_rows": SUP_CHUNK[phase],
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
        row = {"phase": phase, "batch": bsz, "seg_chunk_rows": SUP_CHUNK[phase],
               "remat": False,
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


def main() -> None:
    want_profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the GPU only.",
              file=sys.stderr)
        sys.exit(1)

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

    # ---- 2. the build (every source compiled in parallel at first use)
    attention._kernel()
    attn_pool._kernel()
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
        "max_registers": max((int(ln.split("Used ")[1].split(" registers")[0])
                              for ln in log.splitlines() if "Used " in ln and " registers" in ln),
                             default=None),
    }})

    gen = torch.Generator(device="cuda").manual_seed(0)
    datasets = DatasetsConfig(name_dataset="flair")

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
            m_err, _ = check_close(name + " m", m, m_p, POOL_STATS_TOL[dtype])
            den_err, _ = check_close(name + " den", den, den_p, POOL_STATS_TOL[dtype])
            emit({"check": "attentive_pool_fwd", "dtype": str(dtype), "shape": list(shape),
                  "heads": POOL_HEADS, "tolerance_x_abs_plus_rms": POOL_TOL[dtype],
                  "max_abs_err": max_abs, "max_err_over_tolerance": over,
                  "stats_tolerance": POOL_STATS_TOL[dtype], "m_max_abs_err": m_err,
                  "den_max_abs_err": den_err})
            if dtype == torch.bfloat16 and shape == POOL_CHECK_SHAPES[0]:
                pool_err = max_abs
    pool_bwd_err = pool_bwd_checks(attn_pool, gen)
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
    # the pool at the supervised steps' shapes: forward at the finetune shape,
    # backward at the finetune and probe shapes (ref rows per chunk x grid 32)
    ft_shape = (sup["timed"]["finetune"]["batch"], 26, SUP_CHUNK["finetune"] * 32, 768)
    pr_shape = (sup["timed"]["probe"]["batch"], 26, SUP_CHUNK["probe"] * 32, 768)
    pargs = pool_inputs(ft_shape, torch.bfloat16, gen)
    w16 = pargs[3].to(torch.bfloat16)
    pool_ft_ms = time_ms(lambda: attn_pool.attentive_pool(*pargs, POOL_HEADS, w_kv_bf16=w16), 10)
    pool_ft_plain_ms = time_ms(lambda: attn_pool.attentive_pool_plain(*pargs, POOL_HEADS), 3,
                               warmup=1)
    pool_ft_bound_ms, _ = pool_bound(*ft_shape, POOL_HEADS)
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
        bound_ms, bound_by = pool_bwd_bound(*shape, POOL_HEADS)
        pool_bwd_rows.append({"shape": list(shape), "phase": phase, "dx": need_dx,
                              "launches_per_step": SUP_LAUNCHES[phase][3], "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
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
    loss_rows = {"fwd": [], "bwd": []}
    loss_totals = {d: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0} for d in loss_rows}
    loss_kinds = {d: {} for d in loss_rows}
    for name, (n, f, slices) in flair_loss_rows(train["plan"], train_batch).items():
        t, r, m = loss_inputs(n, f, torch.bfloat16, gen)
        g = torch.tensor(0.37, device="cuda")
        runs = {
            "fwd": (lambda: fused_loss._fwd_kernel(t, r, m, slices, False),
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
                                         "bound_by": bound_by})
            loss_kinds[direction][bound_by] = loss_kinds[direction].get(bound_by, 0.0) + bound_ms
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                loss_totals[direction][key] += val
        del t, r, m

    emit({"seconds_total": round(time.perf_counter() - t_start, 1)})
    tl = train["launches"]
    loss_entry = lambda direction, fn_name, line, launches, err: {  # noqa: E731
        "name": fn_name, "route": "cuda", "source": "maestro_tpu_torch/csrc/fused_loss.cu",
        "replaces": f"maestro_tpu/ops/fused_loss.py:{line}",
        "launches": launches,
        "launches_by_path": {"serve": 0, "train": launches, "finetune": 0, "probe": 0},
        "max_abs_err": err, **loss_totals[direction],
        "bound_by": max(loss_kinds[direction], key=loss_kinds[direction].get),
        "library_ms": None,
        "times_are": f"sum over the {LOSS_PER_STEP} launches of one batch-{train_batch} "
                     "train step (one per modality), bf16 staging, l1",
        "per_shape": loss_rows[direction]}
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
                      + sl["finetune"]["attention_fwd"] + sl["probe"]["attention_fwd"]),
         "launches_by_path": {"serve": serve_launches["attention"], "train": tl["attention_fwd"],
                              "finetune": sl["finetune"]["attention_fwd"],
                              "probe": sl["probe"]["attention_fwd"]},
         "max_abs_err": attn_err,
         "ms": totals["ms"], "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
         "bound_by": max(bound_kinds, key=bound_kinds.get), "library_ms": totals["library_ms"],
         "times_are": "sum over the 39 launches of one batch-8 request, bf16",
         "train_step_fwd_with_lse_ms": bwd_totals["fwd_ms"],
         "per_shape": attn_rows},
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
                      + sl["probe"]["attention_bwd"]),
         "launches_by_path": {"serve": 0, "train": tl["attention_bwd"],
                              "finetune": sl["finetune"]["attention_bwd"],
                              "probe": sl["probe"]["attention_bwd"]},
         "max_abs_err": bwd_err,
         "ms": bwd_totals["ms"], "plain_ms": bwd_totals["plain_ms"],
         "bound_ms": bwd_totals["bound_ms"], "bound_by": max(bwd_kinds, key=bwd_kinds.get),
         "library_ms": bwd_totals["library_ms"],
         "times_are": f"sum over the {ATTN_PER_STEP} calls of one batch-{train_batch} train "
                      "step, bf16; a call is three launches (Delta and scratch zeroing, the wgmma "
                      "kernel, the dq convert); library = "
                      "the backward of scaled_dot_product_attention",
         "per_shape": bwd_rows, "finetune_full_length_shapes": ft_bwd_rows},
        loss_entry("fwd", "masked_patchnorm_sums_fwd", 53, tl["loss_fwd"], loss_sum_err),
        loss_entry("bwd", "masked_patchnorm_sums_bwd", 76, tl["loss_bwd"], loss_grad_err),
        {"name": "attentive_pool_fwd", "route": "cuda",
         "source": "maestro_tpu_torch/csrc/attn_pool.cu",
         "replaces": "maestro_tpu/ops/attn_pool.py:72",
         "launches": (serve_launches["pool"] + sl["finetune"]["pool_fwd"]
                      + sl["probe"]["pool_fwd"]),
         "launches_by_path": {"serve": serve_launches["pool"], "train": 0,
                              "finetune": sl["finetune"]["pool_fwd"],
                              "probe": sl["probe"]["pool_fwd"]},
         "max_abs_err": pool_err,
         "ms": pool_ms, "plain_ms": pool_plain_ms, "bound_ms": pool_bound_ms,
         "bound_by": pool_bound_by, "library_ms": None,
         "times_are": "one launch at [8, 26, 64, 768] bf16, 8 heads; 16 launches per request",
         "finetune_shape": {"shape": list(ft_shape), "ms": pool_ft_ms,
                            "plain_ms": pool_ft_plain_ms, "bound_ms": pool_ft_bound_ms}},
        {"name": "attentive_pool_bwd", "route": "cuda",
         "source": "maestro_tpu_torch/csrc/attn_pool_bwd.cu",
         "replaces": "maestro_tpu/ops/attn_pool.py:123",
         "launches": sl["finetune"]["pool_bwd"] + sl["probe"]["pool_bwd"],
         "launches_by_path": {"serve": 0, "train": 0, "finetune": sl["finetune"]["pool_bwd"],
                              "probe": sl["probe"]["pool_bwd"]},
         "max_abs_err": pool_bwd_err,
         "ms": pool_bwd_rows[0]["ms"], "plain_ms": pool_bwd_rows[0]["plain_ms"],
         "bound_ms": pool_bwd_rows[0]["bound_ms"], "bound_by": pool_bwd_rows[0]["bound_by"],
         "library_ms": None,
         "times_are": f"one call (five launches) at {list(ft_shape)} bf16, 8 heads, with dx: "
                      "the finetune step's; max_abs_err is dx's at [8, 26, 128, 768] against fp32 "
                      "autograd of the plain version",
         "per_shape": pool_bwd_rows},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
