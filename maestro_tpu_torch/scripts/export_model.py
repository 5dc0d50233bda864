"""Export a trained model as a serving artifact (``torch.export``).

Usage::

    python -m maestro_tpu_torch.scripts.export_model OUT.pt2 \
        datasets.name_dataset=flair model.model_size=medium \
        run.load_ckpt_path=runs/.../finetune-epoch=42 \
        [--phase=finetune|probe|embed] [--device=cuda|cpu] \
        [--fixed-batch=N] [--quantize=int8]

``--quantize=int8`` exports the w8a8 serving path (``maestro_tpu_torch.quant``):
the transformer layers' weights int8 with per-output-channel scales,
activations quantized per token, the products int8 x int8 -> int32.

Positional dotted overrides are the ``group.field=value`` CLI of
``maestro_tpu_torch.main``.  The artifact takes ``(params, batch)``: the
weights are inputs, by parameter name, not stored in it (an int8 artifact
takes the parameters of ``quant.quantize_params(model)``); load it with
``serve.load_exported``.  By default the batch dimension is symbolic, so one
artifact serves every batch size.  The export traces on ``cuda`` (the
artifact then calls the kernels) unless ``--device=cpu``; it needs the ops of
``maestro_tpu_torch.ops`` registered where it is loaded.  EMA weights are
used when the checkpoint has them (the finetune-eval semantics), and a
checkpoint that leaves a parameter unfilled is refused.  Writes ``OUT`` and
``OUT.json`` (the manifest).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    out_path, phase, device, fixed_batch, quantize = None, "finetune", "cuda", None, None
    overrides = []
    for arg in argv:
        if arg.startswith("--phase="):
            phase = arg.split("=", 1)[1]
            if phase not in ("finetune", "probe", "embed"):
                msg = f"--phase must be finetune|probe|embed, got {phase!r}"
                raise SystemExit(msg)
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        elif arg.startswith("--fixed-batch="):
            fixed_batch = int(arg.split("=", 1)[1])
        elif arg.startswith("--quantize="):
            quantize = arg.split("=", 1)[1]
            if quantize != "int8":
                msg = f"--quantize supports int8, got {quantize!r}"
                raise SystemExit(msg)
        elif "=" in arg:
            overrides.append(arg)
        elif out_path is None:
            out_path = Path(arg)
        else:
            msg = f"unexpected argument {arg!r}"
            raise SystemExit(msg)
    if out_path is None:
        raise SystemExit(__doc__)

    from maestro_tpu_torch.main import parse_cli
    from maestro_tpu_torch.models.factory import build_experiment_model
    from maestro_tpu_torch.models.mae import resolve_device
    from maestro_tpu_torch.serve import export_predict, exported_inputs, save_exported
    from maestro_tpu_torch.train import checkpoint as ckpt
    from maestro_tpu_torch.utils.testing import make_synthetic_batch

    cfg, datasets = parse_cli(overrides)
    device = resolve_device(device)
    model, _, _ = build_experiment_model(
        datasets, cfg, device=device, generator=torch.Generator().manual_seed(cfg.run.seed),
    )
    if cfg.run.load_ckpt_path:
        # EMA weights when the checkpoint has them (finetune-eval semantics)
        unmatched: list[str] = []
        ema = ckpt.load_ema_weights(cfg.run.load_ckpt_path, model, unmatched_out=unmatched)
        if ema is not None:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(ema[name])
        else:
            ckpt.load_weights(cfg.run.load_ckpt_path, model, unmatched_out=unmatched)
        if unmatched:
            # a parameter left unfilled would serve the seeded draw: refuse to export
            msg = (
                f"checkpoint {cfg.run.load_ckpt_path} does not cover "
                f"{len(unmatched)} model parameters (config/checkpoint mismatch?): "
                f"{unmatched[:5]}{'...' if len(unmatched) > 5 else ''}"
            )
            raise SystemExit(msg)
    if quantize == "int8":
        from maestro_tpu_torch.quant import quantize_params

        model = quantize_params(model)

    batch = make_synthetic_batch(datasets.dataset, fixed_batch or 2)
    ep = export_predict(model, batch, phase, symbolic_batch=fixed_batch is None)
    save_exported(out_path, ep)
    names, keys = exported_inputs(ep)
    inputs = {k: [list(batch[k].shape), str(batch[k].dtype)] for k in keys}
    manifest = {
        "phase": phase,
        "dataset": datasets.name_dataset,
        "model": cfg.model.model,
        "model_size": cfg.model.model_size,
        # an int8 artifact takes quant.quantize_params(model)'s parameters
        "quantize": quantize,
        "symbolic_batch": fixed_batch is None,
        "device": str(device),
        "inputs": inputs,
        "params": len(names),
        "bytes": out_path.stat().st_size,
    }
    Path(str(out_path) + ".json").write_text(json.dumps(manifest, indent=2))
    print(json.dumps({"written": str(out_path), **manifest}))
    return manifest


if __name__ == "__main__":
    main()
