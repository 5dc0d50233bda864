"""Batch inference over a dataset split: predictions to disk.

Usage::

    python -m maestro_tpu_torch.scripts.predict OUT_DIR \
        datasets.name_dataset=flair datasets.root_dir=/data \
        model.model_size=medium run.load_ckpt_path=runs/.../finetune-epoch=49 \
        [--split=test] [--batch-size=32] [--probs] [--device=cuda] [--quantize=int8]

Writes, per target head, what the JAX package's ``scripts/predict.py`` writes:

* classification / multilabel heads -> ``{head}/preds.npy`` (argmax int32, or
  thresholded 0-1 int8 for multilabel) and with ``--probs``
  ``{head}/probs.npy`` ([N, C] float32, softmax / sigmoid);
* segmentation heads -> ``{head}/preds_{i:05d}.npy`` per tile (argmax class
  mask, [D, H, W] int16), plus ``probs_{i:05d}.npy`` with ``--probs``;

and ``manifest.json`` (split, dataset, checkpoint, whether EMA weights were
used, tiles per head, and the seconds the prediction loop took).  EMA
weights are used when the checkpoint carries them (the finetune-eval
semantics).  The model runs through ``serve.make_predict_fn`` on ``cuda``
unless ``--device=cpu`` is given.  ``--quantize=int8`` serves the model from
``quant.quantize_params`` (w8a8: int8 transformer weights, activations
quantized per token); the manifest records it.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    out_dir, split, batch_size, want_probs, device = None, "test", 32, False, "cuda"
    quantize = None
    overrides = []
    for arg in argv:
        if arg.startswith("--split="):
            split = arg.split("=", 1)[1]
        elif arg.startswith("--batch-size="):
            batch_size = int(arg.split("=", 1)[1])
        elif arg == "--probs":
            want_probs = True
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        elif arg.startswith("--quantize="):
            quantize = arg.split("=", 1)[1]
            if quantize != "int8":
                msg = f"--quantize supports int8, got {quantize!r}"
                raise SystemExit(msg)
        elif "=" in arg:
            overrides.append(arg)
        elif out_dir is None:
            out_dir = Path(arg)
        else:
            msg = f"unexpected argument {arg!r}"
            raise SystemExit(msg)
    if out_dir is None:
        raise SystemExit(__doc__)

    from maestro_tpu_torch.data.loader import make_loader
    from maestro_tpu_torch.main import parse_cli
    from maestro_tpu_torch.models.factory import build_experiment_model
    from maestro_tpu_torch.models.mae import resolve_device
    from maestro_tpu_torch.serve import make_predict_fn
    from maestro_tpu_torch.train import checkpoint as ckpt

    cfg, datasets = parse_cli(overrides)
    device = resolve_device(device)
    if not datasets.dataset.targets:
        msg = f"dataset {datasets.name_dataset} has no targets to predict"
        raise SystemExit(msg)
    if not cfg.run.load_ckpt_path:
        raise SystemExit("run.load_ckpt_path is required for prediction")
    model, _, _ = build_experiment_model(
        datasets, cfg, device=device, generator=torch.Generator().manual_seed(cfg.run.seed),
    )
    unmatched: list[str] = []
    ema = ckpt.load_ema_weights(cfg.run.load_ckpt_path, model, unmatched_out=unmatched)
    if ema is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(ema[name])
    else:
        ckpt.load_weights(cfg.run.load_ckpt_path, model, unmatched_out=unmatched)
    if unmatched:
        msg = (
            f"checkpoint does not cover {len(unmatched)} model parameters: "
            f"{unmatched[:5]}{'...' if len(unmatched) > 5 else ''}"
        )
        raise SystemExit(msg)

    if quantize == "int8":
        from maestro_tpu_torch.quant import make_quant_predict_fn, quantize_params

        model = quantize_params(model)
        predict = make_quant_predict_fn(model, "finetune")
    else:
        predict = make_predict_fn(model, "finetune")
    head_specs = {hs.name: hs for hs in model.head_specs}
    for hs in head_specs.values():
        (out_dir / hs.name).mkdir(parents=True, exist_ok=True)

    _, loader = make_loader(datasets, cfg.data, split, "finetune", batch_size, seed=cfg.run.seed)
    loader.shuffle = False  # stable tile order for the output files
    loader.drop_last = False
    counts = dict.fromkeys(head_specs, 0)
    flat_probs: dict[str, list[np.ndarray]] = {
        n: [] for n, hs in head_specs.items() if hs.type_target != "segment"
    }
    t0 = time.perf_counter()
    try:
        for np_batch in loader:
            logits = {k: v.float().cpu().numpy() for k, v in predict(np_batch).items()}
            for name, hs in head_specs.items():
                arr = logits[name]
                if hs.type_target == "segment":
                    # [B, D, C, H, W] -> per-tile class masks
                    preds = arr.argmax(axis=-3).astype(np.int16)
                    for b in range(preds.shape[0]):
                        i = counts[name]
                        np.save(out_dir / name / f"preds_{i:05d}.npy", preds[b])
                        if want_probs:
                            np.save(out_dir / name / f"probs_{i:05d}.npy",
                                    _softmax(arr[b], axis=-3))
                        counts[name] += 1
                else:
                    probs = (
                        _sigmoid(arr)
                        if hs.type_target == "multilabel_classif"
                        else _softmax(arr, axis=-1)
                    )
                    flat_probs[name].append(probs)
                    counts[name] += arr.shape[0]
    finally:
        if hasattr(loader, "close"):  # the worker processes, if any
            loader.close()
    seconds = time.perf_counter() - t0

    for name, chunks in flat_probs.items():
        hs = head_specs[name]
        probs = np.concatenate(chunks, axis=0)
        if want_probs:
            np.save(out_dir / name / "probs.npy", probs)
        preds = (
            (probs >= 0.5).astype(np.int8)
            if hs.type_target == "multilabel_classif"
            else probs.argmax(axis=-1).astype(np.int32)
        )
        np.save(out_dir / name / "preds.npy", preds)

    manifest = {
        "split": split, "dataset": datasets.name_dataset,
        "checkpoint": cfg.run.load_ckpt_path,
        "ema": ema is not None,
        "quantize": quantize,
        "tiles": {k: int(v) for k, v in counts.items()},
        "seconds": seconds,
    }
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    print(json.dumps(manifest))
    return manifest


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


if __name__ == "__main__":
    main()
