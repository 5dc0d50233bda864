"""FLAIR / FLAIR-HUB dataset config.

Values follow reference maestro/conf/dataset/flair.py:15-138:
102.4 m tiles; 0.2 m aerial with NIR-first band reorder; DEM/DSM elevation
pair (rescaled to DSM-DTM in the model); SPOT; Sentinel-2 16-date and
Sentinel-1 asc/des 4-date series; COSIA 15-class (or LPIS 74-class)
segmentation at 0.2 m on the aerial grid.  ``version="flair2"`` widens the
ignore-label set in the data reader.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from maestro_tpu_torch.conf.dataset.base import (
    DatasetConfig,
    InputRasterConfig,
    PatchSizeConfig,
    TargetRasterConfig,
)

# name -> kwargs for InputRasterConfig (patch size under "mae")
_MODALITIES = {
    "aerial": dict(image_size=512, mae=16, bands=[[3, 0, 1, 2]],
                   norm_bands=[1, 3], norm_fac=255.0),
    "dem": dict(image_size=512, mae=32, bands=2, norm_fac=1000.0,
                rescale_elev=True),
    "spot": dict(image_size=64, mae=4, bands=4, norm_fac=2000.0),
    "s2": dict(image_size=10, mae=2, bands=10, norm_bands=[4, 4, 2],
               num_dates=16, norm_fac=5000.0),
    "s1_asc": dict(image_size=10, mae=2, bands=2, norm_bands=[1, 1],
                   num_dates=4, norm_fac=5.0, log_scale=True, name_group="s1"),
    "s1_des": dict(image_size=10, mae=2, bands=2, norm_bands=[1, 1],
                   num_dates=4, norm_fac=5.0, log_scale=True, name_group="s1"),
}

_TARGETS = {"cosia": 15, "lpis": 74}

_RESOLUTIONS = {
    "cosia": 0.2, "lpis": 0.2, "aerial": 0.2, "dem": 0.2,
    "spot": 1.6, "s2": 10.24, "s1_asc": 10.24, "s1_des": 10.24,
}


@dataclass
class FLAIRConfig(DatasetConfig):
    rel_dir: str = "FLAIR-HUB"
    csv_dir: str | None = None
    version: str | None = None
    val_pretrain: bool = True
    filter_percent: int | None = None
    repeats: int = 1
    crop_meters: float = 102.4
    total_meters: float = 102.4
    grid_pos_enc: int | None = 160

    ref_input: str | None = "aerial"
    log_inputs: list[str] = field(default_factory=lambda: ["aerial", "spot"])
    filter_inputs: list[str] = field(
        default_factory=lambda: ["aerial", "dem", "s2", "s1_asc", "s1_des"],
    )
    filter_targets: list[str] = field(default_factory=lambda: ["cosia"])

    def __post_init__(self) -> None:
        for name, kwargs in _MODALITIES.items():
            if name in self.__dict__:
                continue  # keep CLI-overridden objects across re-finalization
            kw = dict(kwargs)
            patch = PatchSizeConfig(mae=kw.pop("mae"))
            setattr(self, name, InputRasterConfig(patch_size=patch, **kw))
        for name, classes in _TARGETS.items():
            if name not in self.__dict__:
                setattr(self, name, TargetRasterConfig(
                    type_target="segment", num_classes=classes,
                    missing_val=-1, bands=1,
                ))
        self.finalize(resolutions_meters=_RESOLUTIONS)
