"""TreeSatAI-TS dataset config.

Values follow reference maestro/conf/dataset/treesatai_ts.py:15-100:
60 m tiles; 0.2 m aerial RGB+NIR; Sentinel-2 10-band 16-date series;
Sentinel-1 ascending/descending 4-date SAR fused as one "s1" group; 15-class
multilabel tree-species targets (raw fractions > 0 and > 0.07 thresholds).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from maestro_tpu_torch.conf.dataset.base import (
    DatasetConfig,
    InputRasterConfig,
    PatchSizeConfig,
    TargetConfig,
)

# modality table: (image_size, mae patch, bands, norm_bands, num_dates,
#                  norm_fac, log_scale, name_group)
_MODALITIES = {
    "aerial": (300, 20, 4, [1, 3], 1, 255.0, False, None),
    "s2": (6, 2, 10, [4, 4, 2], 16, 5000.0, False, None),
    "s1_asc": (6, 2, 2, [1, 1], 4, 5.0, True, "s1"),
    "s1_des": (6, 2, 2, [1, 1], 4, 5.0, True, "s1"),
}

_RESOLUTIONS = {"aerial": 0.2, "s2": 10.0, "s1_asc": 10.0, "s1_des": 10.0}

_NUM_SPECIES = 15


def _build(entry) -> InputRasterConfig:
    size, patch, bands, norm, dates, fac, log, group = entry
    return InputRasterConfig(
        image_size=size,
        patch_size=PatchSizeConfig(mae=patch),
        bands=bands,
        norm_bands=norm,
        num_dates=dates,
        norm_fac=fac,
        log_scale=log,
        name_group=group,
    )


@dataclass
class TreeSatAITSConfig(DatasetConfig):
    rel_dir: str = "TreeSatAI-TS"
    val_pretrain: bool = True
    filter_percent: int | None = None
    crop_meters: float = 60.0
    total_meters: float = 60.0
    grid_pos_enc: int | None = 96

    ref_input: str | None = None
    log_inputs: list[str] = field(default_factory=lambda: ["aerial"])
    filter_inputs: list[str] = field(default_factory=lambda: list(_MODALITIES))
    filter_targets: list[str] = field(default_factory=lambda: ["treesat_mlc_thresh"])

    def __post_init__(self) -> None:
        for name, entry in _MODALITIES.items():
            # keep existing objects so CLI overrides survive re-finalization
            if name not in self.__dict__:
                setattr(self, name, _build(entry))
        for target in ("treesat_mlc", "treesat_mlc_thresh"):
            if target not in self.__dict__:
                setattr(self, target, TargetConfig(
                    type_target="multilabel_classif",
                    num_classes=_NUM_SPECIES,
                    missing_val=-1,
                ))
        self.finalize(resolutions_meters=_RESOLUTIONS)
