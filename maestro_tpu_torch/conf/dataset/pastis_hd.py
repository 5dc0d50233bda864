"""PASTIS-HD dataset config.

Values follow reference maestro/conf/dataset/pastis_hd.py:16-100:
1280 m tiles with an 8x8 deterministic 160 m crop grid (``repeats``); SPOT6
VHR RGB; Sentinel-2 16-date series; Sentinel-1 asc/des fused as "s1";
19-class crop-type segmentation on the S2 grid (void class 19) plus a derived
18-class multilabel target.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from maestro_tpu_torch.conf.dataset.base import (
    DatasetConfig,
    InputRasterConfig,
    PatchSizeConfig,
    TargetConfig,
    TargetRasterConfig,
)

# (image_size, mae patch, bands, norm_bands, num_dates, norm_fac, name_group)
_MODALITIES = {
    "spot": (160, 16, 3, None, 1, 255.0, None),
    "s2": (16, 2, 10, [4, 4, 2], 16, 10000.0, None),
    "s1_asc": (16, 2, [[0, 1]], [1, 1], 4, 20.0, "s1"),
    "s1_des": (16, 2, [[0, 1]], [1, 1], 4, 20.0, "s1"),
}

_RESOLUTIONS = {
    "pastis_seg": 10.0,
    "spot": 1.0,
    "s2": 10.0,
    "s1_asc": 10.0,
    "s1_des": 10.0,
}


@dataclass
class PASTISHDConfig(DatasetConfig):
    rel_dir: str = "PASTIS-HD"
    val_pretrain: bool = True
    filter_percent: int | None = None
    fold: int | None = None
    repeats: int = 8
    crop_meters: float = 160.0
    total_meters: float = 1280.0
    grid_pos_enc: int | None = 256

    ref_input: str | None = "s2"
    log_inputs: list[str] = field(default_factory=lambda: ["spot"])
    filter_inputs: list[str] = field(default_factory=lambda: list(_MODALITIES))
    filter_targets: list[str] = field(default_factory=lambda: ["pastis_seg"])

    def __post_init__(self) -> None:
        for name, entry in _MODALITIES.items():
            if name in self.__dict__:
                continue  # keep CLI-overridden objects across re-finalization
            size, patch, bands, norm, dates, fac, group = entry
            setattr(self, name, InputRasterConfig(
                image_size=size,
                patch_size=PatchSizeConfig(mae=patch),
                bands=bands,
                norm_bands=norm,
                num_dates=dates,
                norm_fac=fac,
                name_group=group,
            ))
        if "pastis_seg" not in self.__dict__:
            self.pastis_seg = TargetRasterConfig(
                type_target="segment", num_classes=19, missing_val=19, bands=1,
            )
        if "pastis_mlc" not in self.__dict__:
            self.pastis_mlc = TargetConfig(
                type_target="multilabel_classif", num_classes=18,
            )
        self.finalize(resolutions_meters=_RESOLUTIONS)
