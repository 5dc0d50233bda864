"""Port a released reference MAESTRO checkpoint to a port checkpoint.

Usage::

    python -m maestro_tpu_torch.scripts.port_checkpoint \
        --ckpt MAESTRO_FLAIR-HUB_base.ckpt \
        --dataset flair --fusion-mode group --model-size medium \
        --inter-depth 3 --out runs/ported

The input is a pytorch-lightning .ckpt of the reference (HuggingFace releases
``IGNF/MAESTRO_FLAIR-HUB_base`` and ``IGNF/MAESTRO_S2-NAIP-urban_base``,
reference README.md:37-39); the output is a weights-only ``pretrain-epoch=0``
checkpoint for ``run.load_ckpt_path``.  The releases were trained with the
reference's attention head splits (encoder 12 x 64 at ``medium``, decoder
16 x 32), which change no parameter shape: run them with the overrides the
script prints, or the attention computes something else without an error.
"""

from __future__ import annotations

import argparse
from pathlib import Path

# reference head splits (vit-pytorch defaults, reference ssl/mae.py:345-360)
REF_ENCODER_HEADS = {"tiny": 3, "small": 6, "medium": 12, "base": 12, "large": 16}
REF_DIM_HEAD, REF_DECODER_HEADS, REF_DECODER_DIM_HEAD = 64, 16, 32


def reference_splits(model_size: str) -> dict[str, int]:
    """The reference's head splits for a model size ({} for the test-only sizes)."""
    heads = REF_ENCODER_HEADS.get(model_size)
    if heads is None:
        return {}
    return {"encoder_heads": heads, "encoder_dim_head": REF_DIM_HEAD,
            "decoder_heads": REF_DECODER_HEADS, "decoder_dim_head": REF_DECODER_DIM_HEAD}


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--ckpt", required=True, help="reference lightning .ckpt")
    ap.add_argument("--dataset", default="flair",
                    choices=["treesatai_ts", "pastis_hd", "flair", "s2_naip"])
    ap.add_argument("--fusion-mode", default="group")
    ap.add_argument("--model-size", default="medium")
    ap.add_argument("--inter-depth", type=int, default=3)
    ap.add_argument("--out", required=True, help="output directory")
    args = ap.parse_args(argv)

    from maestro_tpu_torch.conf import DatasetsConfig, MaskConfig, ModelConfig
    from maestro_tpu_torch.models.mae import build_model
    from maestro_tpu_torch.port.torch_port import (
        load_torch_state_dict,
        merge_into_template,
        port_mae_state_dict,
    )
    from maestro_tpu_torch.train.checkpoint import save_weights

    datasets = DatasetsConfig(name_dataset=args.dataset)
    splits = reference_splits(args.model_size)
    model, plan = build_model(
        datasets, MaskConfig(),
        ModelConfig(model_size=args.model_size, fusion_mode=args.fusion_mode,
                    inter_depth=args.inter_depth, **splits),
        device="meta",
    )
    src = load_torch_state_dict(args.ckpt)
    ported = port_mae_state_dict(src, plan, model.head_specs)
    params, used, missing = merge_into_template(ported, model)
    print(f"ported {len(used)} leaves; {len(missing)} kept fresh init")
    for m in missing[:20]:
        print("  fresh:", m)

    path = save_weights(args.out, "pretrain", 0, params,
                        extra={"source": str(args.ckpt), **splits})
    print("saved", path)
    if splits:
        print("run with the reference head splits, e.g.:",
              " ".join(f"model.{k}={v}" for k, v in splits.items()))
    return path


if __name__ == "__main__":
    main()
