"""Dataset / modality configuration primitives.

Semantics follow the reference config schema
(reference maestro/conf/dataset/utils.py:15-155): a dataset is a bag of
raster modalities, each with its own resolution, band structure and temporal
depth, plus derived state (pixel sizes per modality, the GCD crop grid used to
take aligned multi-resolution crops, and the modality->fusion-group map).

Every image size, grid size and token count downstream is a static Python
int originating from these configs, so each (dataset, fusion_mode, phase)
has fixed tensor shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from math import gcd
from typing import Any

TARGET_TYPES = ("classif", "multilabel_classif", "segment")


@dataclass
class PatchSizeConfig:
    """Per-model patch sizes (the MAE size plus baseline-adapter sizes)."""

    mae: int = 16
    dinov2_imagenat: int = 14
    dinov2_sat: int = 16
    dofa: int = 16
    croma: int = 8
    satmae: int = 16
    prithvi: int = 16

    def for_model(self, model: str) -> int:
        if not hasattr(self, model):
            msg = f"No patch size defined for model {model!r}."
            raise ValueError(msg)
        return getattr(self, model)


@dataclass
class RasterConfig:
    """A raster source: bands, temporal depth and normalization.

    ``bands`` is either an int (single band group of that many channels) or a
    nested list of band indices defining band *groups* — groups are embedded
    separately and normalized separately in the reconstruction loss.
    """

    bands: int | list[list[int]] = 0
    norm_bands: list[int] | None = None
    mask_threshold: float = 0.0
    num_dates: int = 1
    norm_fac: float | None = None
    log_scale: bool = False
    rescale_elev: bool = False
    name_embed: str | None = None
    # filled by DatasetConfig.finalize()
    resolution_meters: float = field(default=0.0, init=False)

    # ---- derived band-group helpers -------------------------------------
    @property
    def band_groups(self) -> tuple[int, ...]:
        """Channel count of each band group."""
        if isinstance(self.bands, int):
            return (self.bands,)
        return tuple(len(group) for group in self.bands)

    @property
    def band_order(self) -> tuple[int, ...] | None:
        """Flat source-band read order, or None for identity."""
        if isinstance(self.bands, int):
            return None
        return tuple(idx for group in self.bands for idx in group)

    @property
    def num_channels(self) -> int:
        return sum(self.band_groups)

    @property
    def len_bands(self) -> int:
        return len(self.band_groups)

    @property
    def norm_groups(self) -> tuple[int, ...]:
        """Band groups used for patch-wise target normalization."""
        if self.norm_bands is not None:
            return tuple(self.norm_bands)
        return self.band_groups


@dataclass
class InputRasterConfig(RasterConfig):
    """An input modality: raster + model-facing geometry."""

    image_size: int = 0
    patch_size: PatchSizeConfig = field(default_factory=PatchSizeConfig)
    name_group: str | None = None


@dataclass
class TargetConfig:
    """A prediction target (classification or multilabel)."""

    type_target: str = "classif"
    num_classes: int = 0
    missing_val: int = -1

    def __post_init__(self) -> None:
        if self.type_target not in TARGET_TYPES:
            msg = f"Invalid target type {self.type_target!r}; expected {TARGET_TYPES}."
            raise ValueError(msg)


@dataclass
class TargetRasterConfig(RasterConfig, TargetConfig):
    """A dense raster target (semantic segmentation)."""


@dataclass
class DatasetConfig:
    """Base dataset config; concrete datasets subclass and call finalize().

    Subclasses must set, before calling :meth:`finalize`:
      - modality attributes (``InputRasterConfig`` / target configs)
      - ``total_meters`` and ``crop_meters``
      - ``filter_inputs`` / ``filter_targets`` / ``log_inputs``
    """

    rel_dir: str = ""
    val_pretrain: bool = False
    test_pretrain: bool = False
    repeats: int = 1
    crop_meters: float = 0.0
    total_meters: float = 0.0
    grid_pos_enc: int | None = None
    ref_input: str | None = None
    log_inputs: list[str] = field(default_factory=list)
    filter_inputs: list[str] = field(default_factory=list)
    filter_targets: list[str] = field(default_factory=list)

    # derived (finalize)
    sizes: dict[str, int] = field(default_factory=dict, init=False)
    size_gcd: int = field(default=0, init=False)
    crop_gcd: int = field(default=0, init=False)
    inputs: dict[str, InputRasterConfig] = field(default_factory=dict, init=False)
    targets: dict[str, Any] = field(default_factory=dict, init=False)
    rasters: dict[str, RasterConfig] = field(default_factory=dict, init=False)
    groups: list[tuple[str, str]] = field(default_factory=list, init=False)

    def finalize(self, resolutions_meters: dict[str, float]) -> None:
        """Compute derived state: pixel sizes, GCD crop grid, fusion groups."""
        selected = set(self.filter_inputs) | set(self.filter_targets)
        self.sizes = {}
        for name_mod, res in resolutions_meters.items():
            mod = self._get_mod(name_mod)
            mod.resolution_meters = float(res)
            size = self.total_meters / mod.resolution_meters
            if name_mod in selected and abs(size - round(size)) > 1e-9:
                msg = f"Resolution of {name_mod!r} does not divide tile extent."
                raise ValueError(msg)
            self.sizes[name_mod] = round(size)

        size_gcd = gcd(*self.sizes.values())
        crop_gcd = self.crop_meters / self.total_meters * size_gcd
        if abs(crop_gcd - round(crop_gcd)) > 1e-9:
            msg = (
                "crop_meters is not an integer number of GCD-grid pixels; "
                f"use a multiple of {self.total_meters / size_gcd}."
            )
            raise ValueError(msg)
        self.size_gcd = size_gcd
        self.crop_gcd = round(crop_gcd)

        self.log_inputs = [m for m in self.log_inputs if m in self.filter_inputs]
        if not self.log_inputs:
            self.log_inputs = list(self.filter_inputs)

        if self.ref_input and self.ref_input not in self.filter_inputs:
            msg = f"ref_input {self.ref_input!r} not among selected inputs."
            raise ValueError(msg)

        self.inputs = {name: self._get_mod(name) for name in self.filter_inputs}
        self.targets = {name: self._get_mod(name) for name in self.filter_targets}
        self.rasters = {
            name: mod
            for name, mod in {**self.inputs, **self.targets}.items()
            if isinstance(mod, RasterConfig)
        }
        self.groups = [
            (name, mod.name_group if mod.name_group is not None else name)
            for name, mod in self.inputs.items()
        ]

    def _get_mod(self, name_mod: str) -> Any:
        for f in dataclasses.fields(self):
            if f.name == name_mod:
                return getattr(self, name_mod)
        if name_mod in self.__dict__:
            return self.__dict__[name_mod]
        msg = f"Unknown modality {name_mod!r} on {type(self).__name__}."
        raise ValueError(msg)
