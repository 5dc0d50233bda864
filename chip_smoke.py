"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py            # what the checks need
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of requests

Builds the hand-written CUDA kernels from ``maestro_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, then drives the port's
serving path — ``build_model`` (MAE medium, FLAIR-HUB plan, group fusion,
3 trunk blocks, bf16) and ``serve.make_predict_fn(model, "finetune")`` — for
requests of batch 1, 4 and 8 with seeded random weights and inputs, and checks
launch counts, shapes, finiteness and agreement with the same model run
through the plain versions.

Output: one JSON object per line.  The second-to-last line is the
``{"kernels": [...]}`` record, the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises: the exit code is then non-zero and no result line is
printed.  Without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
HEAD_START_CYCLES = 10_000_000  # device spin before timed launches, 5-6 ms at 1.7-2 GHz

# Kernel vs plain version: |got - want| <= tol * (|want| + rms(want)) per element,
# so the tolerance follows the data (attention outputs shrink as sqrt(1/L)).
BF16_ULP = 2.0**-7
ATTN_TOL = {torch.bfloat16: 4 * BF16_ULP, torch.float32: 1e-4}
POOL_TOL = {torch.bfloat16: 4 * BF16_ULP, torch.float32: 0.1}  # fp32 x: bf16 matmul operands
POOL_STATS_TOL = {torch.bfloat16: 1e-3, torch.float32: 5e-2}
# kernel path vs plain path through 12 bf16 blocks, relative to max |logit|
# (about 3x the 0.0077 this comparison reads on an H100)
LOGITS_REL_TOL = 0.025
ARGMAX_AGREE_MIN = 0.97

ATTN_CHECK_LENGTHS = (50, 200, 256, 400, 1024, 1880)
ATTN_CHECK_HEADS = ((6, 128), (12, 64), (3, 64), (16, 32), (8, 96))
ATTN_CHECK_BATCH = {(6, 128): 8}  # the serving path's heads at its largest batch; else 2
# head dims 96, 96, 16, 48, 128: every one attn_pool.cu is built for
POOL_CHECK_SHAPES = ((8, 26, 64, 768), (8, 26, 128, 768), (2, 2, 40, 128),
                     (2, 5, 64, 384), (2, 3, 40, 1024))
POOL_HEADS = 8
REQUEST_BATCHES = (1, 4, 8)
ATTN_PER_REQUEST = 39  # 4 streams x 9 blocks + 3 trunk blocks
POOL_PER_REQUEST = 16  # ref grid 32 rows / seg_chunk_rows 2


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


def profile_requests(predict, batch, latency_ms: float, requests: int = 3) -> dict:
    """Device time by kernel name over a few requests (torch.profiler / CUPTI).

    ``busy_ms_per_request`` is the sum of all kernels' device time; the idle
    share is taken against ``latency_ms``, the request latency measured with
    the profiler off (profiling itself slows the host).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predict(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            predict(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / requests
    # device-side events only: the CPU-side operator rows repeat their kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / requests, e.count / requests)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        return {"device_time": "not measured (the profiler saw no device activity)"}
    return {
        "busy_ms_per_request": busy, "latency_ms_profiler_off": latency_ms,
        "device_idle_share": 1.0 - busy / latency_ms, "wall_ms_per_request_profiled": wall_ms,
        "device_events_per_request": sum(r[2] for r in rows),
        "top": [{"name": r[0][:90], "ms_per_request": r[1], "calls_per_request": r[2]}
                for r in rows[:14]],
    }


def qkv_views(b: int, l: int, h: int, d: int, dtype, gen) -> tuple[torch.Tensor, ...]:
    """q, k, v as strided views of one fused [B, L, 3*H*D] projection output."""
    qkv = torch.randn((b, l, 3 * h * d), generator=gen, device="cuda", dtype=torch.float32)
    return qkv.to(dtype).view(b, l, 3, h, d).unbind(dim=2)


def attention_bound(b: int, l: int, h: int, d: int, dtype) -> tuple[float, str]:
    nbytes = 4 * b * l * h * d * (2 if dtype == torch.bfloat16 else 4)
    ops = 4 * b * h * l * l * d
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def pool_bound(b: int, d: int, l: int, e: int, heads: int) -> tuple[float, str]:
    nbytes = b * d * l * e * 2 + b * l * e * 2 + 2 * b * l * heads * 4 + 2 * e * e * 2 + 3 * e * 4
    ops = 4 * b * d * l * e * e
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def pool_inputs(shape, dtype, gen):
    b, d, l, e = shape
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda", dtype=torch.float32)
    x = (rnd(b, d, l, e) * 1.5 + 0.3 * rnd(b, d, l, 1)).to(dtype)
    return x, 1.0 + 0.1 * rnd(e), 0.1 * rnd(e), rnd(2 * e, e) * e**-0.5, rnd(e)


def main() -> None:
    want_profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the GPU only.",
              file=sys.stderr)
        sys.exit(1)

    from maestro_tpu_torch.conf import DatasetsConfig, MaskConfig, ModelConfig
    from maestro_tpu_torch.models import vit
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.ops import attention, attn_pool, cuda_build
    from maestro_tpu_torch.serve import make_predict_fn
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32
    t_start = time.perf_counter()

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # ---- 2. the build (both sources compiled in parallel at first use)
    attention._kernel()
    attn_pool._kernel()
    log = str(cuda_build.build_info.get("log", ""))
    emit({"build": {
        "seconds": round(float(cuda_build.build_info["seconds"]), 2),
        "directory": cuda_build.build_info["directory"],
        "ptxas_spill_lines": sorted({
            ln.strip() for ln in log.splitlines()
            if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln}),
        "max_registers": max((int(ln.split("Used ")[1].split(" registers")[0])
                              for ln in log.splitlines() if "Used " in ln and " registers" in ln),
                             default=None),
    }})

    gen = torch.Generator(device="cuda").manual_seed(0)

    # ---- 3a. attention kernel vs plain version
    attn_err = 0.0
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for l in ATTN_CHECK_LENGTHS:
            worst = (0.0, 0.0, None)  # by error over its limit
            for h, d in ATTN_CHECK_HEADS:
                b = ATTN_CHECK_BATCH.get((h, d), 2)
                q, k, v = qkv_views(b, l, h, d, dtype, gen)
                got = attention.mha_blhd(q, k, v, d**-0.5)
                torch.cuda.synchronize()
                want = attention.mha_blhd_plain(q, k, v, d**-0.5)
                max_abs, over = check_close(
                    f"attention L={l} H={h} D={d} {dtype}", got, want, ATTN_TOL[dtype])
                del got, want
                cases += 1
                if over > worst[1]:
                    worst = (max_abs, over, [b, l, h, d])
                if dtype == torch.bfloat16:
                    attn_err = max(attn_err, max_abs)
            emit({"check": "flash_attention_fwd", "dtype": str(dtype), "L": l,
                  "layout": "strided qkv view", "tolerance_x_abs_plus_rms": ATTN_TOL[dtype],
                  "max_err_over_tolerance": worst[1], "max_abs_err": worst[0],
                  "worst_shape": worst[2]})
    # contiguous q, k, v too
    q, k, v = (t.contiguous() for t in qkv_views(2, 400, 6, 128, torch.bfloat16, gen))
    check_close("attention contiguous", attention.mha_blhd(q, k, v, 128**-0.5),
                attention.mha_blhd_plain(q, k, v, 128**-0.5), ATTN_TOL[torch.bfloat16])
    emit({"check": "flash_attention_fwd", "cases": cases + 1, "ok": True})

    # ---- 3b. pool kernel vs plain version
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

    # ---- 4. the main path
    datasets = DatasetsConfig(name_dataset="flair")
    model_cfg = ModelConfig(model_size="medium", fusion_mode="group", inter_depth=3)
    model, plan = build_model(
        datasets, MaskConfig(), model_cfg, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(0),
    )
    predict = make_predict_fn(model, "finetune")
    stream_lengths = {name: s.seq_len for name, s in plan.streams.items()}
    emit({"model": {"size": "medium", "dataset": "flair", "fusion": "group", "inter_depth": 3,
                    "dtype": "bfloat16", "params": sum(p.numel() for p in model.parameters()),
                    "stream_lengths": stream_lengths,
                    "trunk_length": sum(stream_lengths.values())}})
    batches = {b: make_synthetic_batch(datasets.dataset, b, seed=b) for b in REQUEST_BATCHES}

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
    attn_launches, pool_launches = attention.launch_count, attn_pool.launch_count
    if attn_launches == 0 or pool_launches == 0:
        raise AssertionError("the main path did not launch both kernels")

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
            emit({"profile": {"batch": b, **profile_requests(predict, batches[b], latency[b])}})

    # the same model through the plain versions, on the card
    kernel_fns = (vit.mha_blhd, vit.attentive_pool)
    vit.mha_blhd = attention.mha_blhd_plain
    vit.attentive_pool = attn_pool.attentive_pool_plain
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
        vit.mha_blhd, vit.attentive_pool = kernel_fns
    del logits_kernel

    # ---- 5. kernel times at the main path's shapes (batch 8), back to back
    # (inputs stay warm in L2, as they are right after the qkv projection)
    heads, dim_head = model.arch.heads, model.arch.dim_head
    depth = model.arch.depth - model.inter_depth
    shapes = [(length, depth) for length in stream_lengths.values()]
    shapes.append((sum(stream_lengths.values()), model.inter_depth))
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

    emit({"seconds_total": round(time.perf_counter() - t_start, 1)})
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "maestro_tpu_torch/csrc/flash_attention.cu",
         "replaces": "maestro_tpu/ops/attention.py:270",
         "also_replaces": ["maestro_tpu/ops/attention.py:488", "maestro_tpu/ops/attention.py:124",
                           "maestro_tpu/ops/attention.py:82"],
         "launches": attn_launches, "max_abs_err": attn_err,
         "ms": totals["ms"], "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
         "bound_by": max(bound_kinds, key=bound_kinds.get), "library_ms": totals["library_ms"],
         "times_are": "sum over the 39 launches of one batch-8 request, bf16",
         "per_shape": attn_rows},
        {"name": "attentive_pool_fwd", "route": "cuda",
         "source": "maestro_tpu_torch/csrc/attn_pool.cu",
         "replaces": "maestro_tpu/ops/attn_pool.py:72",
         "launches": pool_launches, "max_abs_err": pool_err,
         "ms": pool_ms, "plain_ms": pool_plain_ms, "bound_ms": pool_bound_ms,
         "bound_by": pool_bound_by, "library_ms": None,
         "times_are": "one launch at [8, 26, 64, 768] bf16, 8 heads; 16 launches per request"},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
