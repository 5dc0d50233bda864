"""Port a released foundation-model checkpoint into a baseline warm start.

The five adapters (reference Table 2, README.md:120-129) start from their
publicly released torch checkpoints through this CLI: the output is a
weights-only ``fm-epoch=0`` checkpoint whose backbone parameters warm-start a
probe/finetune experiment through ``model.pretrained_path``.

Usage (the overrides of ``maestro_tpu_torch.main``, so that the adapter's
template is built from the very experiment config you will train with)::

    python -m maestro_tpu_torch.scripts.port_fm --ckpt DOFA_ViT_base_e100.pth \
        --out runs/dofa model.model=dofa model.model_size=base \
        model.fusion_mode=shared datasets.name_dataset=pastis_hd

    python -m maestro_tpu_torch.main model.model=dofa ... \
        model.pretrained_path=runs/dofa/fm-epoch=0

Source layouts per adapter (reference surgery semantics):
  dinov2  HF Dinov2Model state dict, or a raw ``backbone.*`` dump
          (utils.py:24-78 rename + qkv split), quantized linears unpacked
          (utils.py:81-98); channel pad by port/dinov2_port.py.
  dofa    torchgeo OFAViT (dofa.py:460-678): weight-generator transformer,
          FCResLayer, timm blocks; the one released patch_embed/pos_embed
          replicated into every modality (dofa.py:202-204).
  croma   a dict of sub-state-dicts s1_encoder / s2_encoder / joint_encoder
          (croma.py:386-436).
  satmae  MaskedAutoencoderViT encoder (satmae.py:252-330).
  prithvi terratorch PrithviViT: Conv3d patch kernel with the HLS->S2
          ORIG_BANDS channel surgery (prithvi.py:154-182), the temporal
          encoder's linear for the v2 "_tl" variant.

The adapter's template is built on the ``meta`` device (shapes only): at
release size (DINOv2-L, 318.5 M parameters) a materialized template beside
the source and the port would hold three fp32 copies.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def _band_indices(datasets) -> tuple[int, ...]:
    bands = datasets.dataset.inputs["s2"].bands
    return (tuple(range(bands)) if isinstance(bands, int)
            else tuple(i for grp in bands for i in grp))


def port_fm_params(model_name: str, src: dict, cfg, plan, datasets) -> dict:
    """Dispatch a released state dict to the adapter's port map (a flax-named
    tree, as the JAX package's maps give it)."""
    from maestro_tpu_torch.port import fm_port

    size = cfg.model.model_size
    if model_name == "dinov2":
        from maestro_tpu_torch.baselines.dinov2 import DINOV2_ARCHS
        from maestro_tpu_torch.port.dinov2_port import port_dinov2

        if any(k.startswith("backbone.") for k in src):
            src = fm_port.rename_dinov2_backbone(src)
        mods = {m: plan.mod_specs[m].num_channels for m in plan.mods}
        return port_dinov2(src, mods, plan.encoder_names, DINOV2_ARCHS[size][1],
                           keep_norm=cfg.model.keep_norm)
    if model_name == "dofa":
        from maestro_tpu_torch.baselines.dofa import DOFA_ARCHS

        return fm_port.port_dofa(src, DOFA_ARCHS[size][1], tuple(plan.mods),
                                 plan.encoder_names)
    if model_name == "croma":
        return fm_port.port_croma(src)
    if model_name == "satmae":
        from maestro_tpu_torch.baselines.satmae import SATMAE_ARCHS

        return fm_port.port_satmae(src, SATMAE_ARCHS[size][1], _band_indices(datasets))
    if model_name == "prithvi":
        from maestro_tpu_torch.baselines.prithvi import PRITHVI_ARCHS

        return fm_port.port_prithvi(src, PRITHVI_ARCHS[size][1], _band_indices(datasets))
    msg = f"No port map for baseline {model_name!r}."
    raise SystemExit(msg)


def load_fm_checkpoint(path: str, model_name: str) -> dict:
    """torch.load a release: CROMA keeps its per-encoder sub-dicts, the others
    flatten to numpy (quantized linears unpacked first).  Releases pickle more
    than tensors, so the file is read with ``weights_only=False``: port only
    files you trust."""
    from maestro_tpu_torch.port.fm_port import dequantize_state_dict

    blob = torch.load(path, map_location="cpu", weights_only=False)
    blob = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    if model_name == "croma":
        return {
            enc: {k: np.asarray(v.detach() if hasattr(v, "detach") else v)
                  for k, v in sub.items()}
            for enc, sub in blob.items()
            if isinstance(sub, dict)
        }
    if any("_packed_params" in k for k in blob):
        return dequantize_state_dict(blob)
    return {
        k: (v.detach().numpy() if hasattr(v, "detach") else np.asarray(v))
        for k, v in blob.items()
    }


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--ckpt", required=True, help="released torch checkpoint")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument(
        "--allow-missing", action="store_true",
        help="tolerate backbone parameters that kept fresh init (default: error)",
    )
    ap.add_argument(
        "--manifest", default="auto",
        help="release key-manifest to verify coverage against: a name from "
             "maestro_tpu_torch.port.manifests.ALL_MANIFESTS, 'auto' (pick by "
             "model+size; skip with a notice if none registered), or "
             "'none' to disable the check",
    )
    ap.add_argument("overrides", nargs="*",
                    help="maestro_tpu_torch.main-style group.field=value overrides")
    args = ap.parse_args(argv)

    from maestro_tpu_torch.main import parse_cli
    from maestro_tpu_torch.models.factory import build_experiment_model
    from maestro_tpu_torch.port import manifests as mf
    from maestro_tpu_torch.port.torch_port import merge_into_template
    from maestro_tpu_torch.train.checkpoint import save_weights

    cfg, datasets = parse_cli(args.overrides)
    model, plan, is_baseline = build_experiment_model(
        datasets, cfg, dtype=torch.float32, device="meta",
    )
    if not is_baseline:
        msg = (
            f"model.model={cfg.model.model!r} is the flagship MAE; use "
            "python -m maestro_tpu_torch.scripts.port_checkpoint for reference "
            "MAE checkpoints."
        )
        raise SystemExit(msg)

    src = load_fm_checkpoint(args.ckpt, cfg.model.model)
    recorder = mf.RecordingDict(src)
    ported = port_fm_params(cfg.model.model, recorder, cfg, plan, datasets)

    # the release's contract: every source key consumed or skip-listed, every
    # key the port reads present, shapes as transcribed
    manifest_name = args.manifest
    if manifest_name == "auto":
        manifest_name = mf.DEFAULT_FOR.get(
            (cfg.model.model, cfg.model.model_size), "none",
        )
        if manifest_name == "none":
            print(f"no release manifest registered for "
                  f"({cfg.model.model}, {cfg.model.model_size}); "
                  "coverage check skipped")
        if cfg.model.model == "dinov2" and any(k.startswith("backbone.") for k in src):
            # the raw backbone.* sat dump was renamed before the map ran; its
            # key space is not the HF manifest's
            manifest_name = "none"
            print("dinov2 'sat' backbone.* dump detected; HF manifest "
                  "does not apply, coverage check skipped")
    if manifest_name != "none":
        manifest = mf.ALL_MANIFESTS[manifest_name]()
        try:
            mf.verify_coverage(manifest, src, recorder.accessed)
        except mf.CoverageError as e:
            raise SystemExit(str(e)) from None
        print(f"manifest {manifest_name}: all {len(manifest['keys'])} "
              "release keys consumed or skip-listed, shapes match")

    params, used, missing = merge_into_template(ported, model)
    heads_fresh = [m for m in missing if m.startswith("heads_")]
    backbone_fresh = [m for m in missing if not m.startswith("heads_")]
    print(f"ported {len(used)} leaves; {len(heads_fresh)} head leaves fresh "
          f"(expected); {len(backbone_fresh)} backbone leaves fresh")
    for m in backbone_fresh[:20]:
        print("  fresh backbone leaf:", m)
    if backbone_fresh and not args.allow_missing:
        msg = (
            f"{len(backbone_fresh)} backbone leaves were not covered by the "
            "released checkpoint — wrong --ckpt / model size / fusion mode? "
            "(--allow-missing to override)"
        )
        raise SystemExit(msg)

    path = save_weights(
        args.out, "fm", 0, params,
        extra={"source": str(args.ckpt), "model": cfg.model.model,
               "model_size": cfg.model.model_size,
               "fusion_mode": cfg.model.fusion_mode},
    )
    print("saved", path)
    print(f"train with: model.pretrained_path={path}")
    return path


if __name__ == "__main__":
    main()
