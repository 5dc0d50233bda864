"""Shared shell of the baseline foundation-model adapters.

The port of the JAX package's ``baselines/base.py`` (reference
baselines/base.py:19-217).  The adapters let the probe/finetune harness
evaluate competitor models (DINOv2, DOFA, CROMA, SatMAE, Prithvi-EO) on
MAESTRO's datasets: every modality is resized to its configured image size,
patch-embedded with the model's own patch size (floor grid), run through the
(optionally frozen) backbone, optionally given date encodings, and pooled by
the flagship model's classification and segmentation heads
(``models/heads.py``: the date pool's kernels on the card).

An adapter is called as ``MaestroMAE`` is, in the probe and finetune phases
only: ``model(batch, phase)``, ``model.encode_for_heads(batch)`` (the frozen
trunk's features, which ``train/eval_cache.py`` caches) and
``model(features, phase, from_features=True)`` (the heads alone).
"""

from __future__ import annotations

import torch
from torch import nn

from maestro_tpu_torch.conf.datasets import DatasetsConfig
from maestro_tpu_torch.models.heads import ChunkedSegHead, ClassificationHead
from maestro_tpu_torch.models.mae import HeadSpec, build_head_specs
from maestro_tpu_torch.ops.posenc import encode_dates
from maestro_tpu_torch.ops.resize import resize_spatial
from maestro_tpu_torch.specs.fusion import FusionPlan, build_fusion_plan

PHASES = ("probe", "finetune")


def build_baseline_plan(
    datasets: DatasetsConfig,
    fusion_mode: str,
    model: str,
) -> tuple[FusionPlan, tuple[HeadSpec, ...]]:
    """FusionPlan + head specs for a baseline model (floor-grid patching)."""
    plan_mode = "shared" if fusion_mode in ("late-croma", "inter-croma") else fusion_mode
    plan = build_fusion_plan(datasets.dataset, None, plan_mode, model=model, floor_grid=True)
    for name, spec in plan.mod_specs.items():
        if spec.grid == 0:
            msg = (
                f"Modality {name!r} image_size {spec.image_size} is smaller than "
                f"the {model} patch size {spec.patch_size}; override "
                f"datasets.<ds>.{name}.image_size on the CLI."
            )
            raise ValueError(msg)
    # baseline heads consume grid = image_size // patch (stride 1)
    return plan, build_head_specs(datasets.dataset, plan)


class BaselineShell(nn.Module):
    """Heads, date encodings and logits over a FusionPlan.

    Subclasses build their backbone, then call ``make_heads``, and implement
    ``encode_for_heads(batch) -> dict[stream]`` of per-stream token features
    ``[B', L, C]`` (CLS removed).
    """

    def __init__(self, plan: FusionPlan, head_specs: tuple[HeadSpec, ...], *,
                 embed_dim: int, dtype: torch.dtype, type_head: str = "attentive",
                 interpolate: str = "nearest", ref_input: str | None = None,
                 add_date_enc: bool = True, fac_date_enc: float = 1.0, date_dim: int = 8,
                 seg_chunk_rows: int = 2) -> None:
        super().__init__()
        self.plan, self.head_specs, self.embed_dim, self.dtype = plan, head_specs, embed_dim, dtype
        self.type_head, self.interpolate, self.ref_input = type_head, interpolate, ref_input
        self.add_date_enc, self.fac_date_enc, self.date_dim = add_date_enc, fac_date_enc, date_dim
        self.seg_chunk_rows = seg_chunk_rows

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def make_heads(self, generator: torch.Generator, device,
                   stream_grids: tuple[int, ...] | None = None) -> None:
        """Heads per target.  ``stream_grids`` overrides the native token
        grid per feature stream for the segmentation head when the adapter's
        streams differ from ``plan.mods`` (CROMA: S1/S2 only, plus the joint
        tokens as an extra stream; reference croma.py:116-119)."""
        if stream_grids is None:
            stream_grids = tuple(self.plan.mod_specs[m].grid for m in self.plan.mods)
        self.heads = nn.ModuleDict()
        for hs in self.head_specs:
            if hs.type_target == "segment":
                self.heads[hs.name] = ChunkedSegHead(
                    self.type_head, self.embed_dim, hs.num_classes, hs.pixel_patch,
                    self.plan.mod_specs[self.ref_input].grid, stream_grids, self.dtype,
                    generator, device, chunk_rows=self.seg_chunk_rows,
                )
            else:
                self.heads[hs.name] = ClassificationHead(
                    self.type_head, self.embed_dim, hs.num_classes, self.dtype, generator,
                    device,
                )

    def resize_and_rescale(self, batch: dict) -> dict:
        """Resize to the configured image sizes; DEM -> (DSM - DTM) * 30;
        crop the right/bottom remainder the floor grid drops."""
        out = dict(batch)
        for name, spec in self.plan.mod_specs.items():
            x = resize_spatial(batch[name], spec.image_size, self.interpolate)
            if spec.rescale_elev:
                x = torch.cat([x[:, :, :1], 30.0 * (x[:, :, :1] - x[:, :, 1:])], dim=2)
            crop = spec.grid * spec.patch_size
            out[name] = x[..., :crop, :crop]
        return out

    def add_date_encodings(self, feats: dict, batch: dict) -> dict:
        """Add date encodings per modality (ungrouped layout)."""
        x = self.plan.ungroup(feats)
        for name, spec in self.plan.mod_specs.items():
            x[name] = x[name] + encode_dates(
                batch[f"{name}_dates"], batch["ref_date"], dim=self.embed_dim,
                date_dim=self.date_dim, fac_date_enc=self.fac_date_enc,
                num_tokens=spec.tokens_per_date, len_bands=spec.len_bands,
                dtype=x[name].dtype,
            )
        return self.plan.group(x)

    def head_logits(self, streams: list[torch.Tensor], phase: str) -> dict[str, torch.Tensor]:
        """Each head over the feature streams ``[B, D, L, C]`` (the
        segmentation head resizes each to the ref grid chunk by chunk; the
        classification head takes all tokens at once); in the probe phase
        the features are detached, so only the heads get gradients."""
        if phase == "probe":
            streams = [s.detach() for s in streams]
        logits = {}
        for hs in self.head_specs:
            if hs.type_target == "segment":
                logits[hs.name] = self.heads[hs.name](tuple(streams))
            else:
                x_cat = torch.cat([s.reshape(s.shape[0], -1, s.shape[-1]) for s in streams],
                                  dim=1)
                logits[hs.name] = self.heads[hs.name](x_cat)
        return logits

    def logits_from_features(self, feats: dict, phase: str) -> dict[str, torch.Tensor]:
        """Heads over ``encode_for_heads`` features."""
        x = self.plan.ungroup(feats)
        return self.head_logits([x[m] for m in self.plan.mods], phase)

    def encode_for_heads(self, batch: dict) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def forward(self, batch: dict, phase: str = "finetune", return_pixels: bool = True, *,
                generator: torch.Generator | None = None, from_features: bool = False):
        """Logits per target (``MaestroMAE.forward``'s signature; a baseline
        has no pretrain phase).  The probe phase runs the frozen backbone
        without autograd."""
        del return_pixels, generator
        if phase not in PHASES:
            msg = f"baseline adapters run the probe and finetune phases, got {phase!r}"
            raise ValueError(msg)
        if from_features:
            return self.logits_from_features(batch, phase)
        if phase == "probe":
            with torch.no_grad():
                feats = self.encode_for_heads(batch)
        else:
            feats = self.encode_for_heads(batch)
        return self.logits_from_features(feats, phase)
