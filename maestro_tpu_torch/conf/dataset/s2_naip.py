"""S2-NAIP urban dataset config (pretrain-only).

Values follow reference maestro/conf/dataset/s2_naip.py:15-105:
640 m tiles (512 px at 1.25 m) with a 5x5 deterministic 120 m crop grid;
NAIP aerial with NIR-first reorder (the same source imagery also serves the
"spot" stream at 128 px); Landsat/Sentinel-2 16-date stacks; a single
combined Sentinel-1 4-date series.  No downstream targets.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from maestro_tpu_torch.conf.dataset.base import (
    DatasetConfig,
    InputRasterConfig,
    PatchSizeConfig,
    TargetRasterConfig,
)

_MODALITIES = {
    "aerial": dict(image_size=384, mae=16, bands=[[3, 0, 1, 2]],
                   norm_bands=[1, 3], norm_fac=255.0),
    "spot": dict(image_size=128, mae=16, bands=3, norm_fac=255.0),
    "landsat": dict(image_size=12, mae=2, bands=11, num_dates=16,
                    norm_fac=5000.0),
    "s2": dict(image_size=12, mae=2, bands=10, norm_bands=[4, 4, 2],
               num_dates=16, norm_fac=5000.0),
    "s1": dict(image_size=12, mae=2, bands=2, norm_bands=[1, 1], num_dates=4,
               norm_fac=20.0),
}

_RESOLUTIONS = {
    "osm_seg": 1.25, "aerial": 1.25, "spot": 1.25,
    "landsat": 10.0, "s2": 10.0, "s1": 10.0,
}


@dataclass
class S2NAIPConfig(DatasetConfig):
    rel_dir: str = "s2-naip-urban"
    val_pretrain: bool = True
    test_pretrain: bool = True
    repeats: int = 5
    crop_meters: float = 120.0
    total_meters: float = 640.0
    grid_pos_enc: int | None = 192

    ref_input: str | None = None
    log_inputs: list[str] = field(default_factory=lambda: ["aerial", "spot"])
    filter_inputs: list[str] = field(
        default_factory=lambda: ["aerial", "spot", "s2", "s1"],
    )
    filter_targets: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        for name, kwargs in _MODALITIES.items():
            if name in self.__dict__:
                continue  # keep CLI-overridden objects across re-finalization
            kw = dict(kwargs)
            patch = PatchSizeConfig(mae=kw.pop("mae"))
            setattr(self, name, InputRasterConfig(patch_size=patch, **kw))
        if "osm_seg" not in self.__dict__:
            self.osm_seg = TargetRasterConfig(
                type_target="segment", num_classes=6, missing_val=-1, bands=1,
            )
        self.finalize(resolutions_meters=_RESOLUTIONS)
