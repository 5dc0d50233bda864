"""Synthetic batch generation for tests and benchmarks.

Produces batches with the exact shapes the data pipeline emits
(reference layout: inputs ``[B, D, C, h, w]`` float32 at native crop
resolution, ``{mod}_dates`` ``[B, D, 3]`` int16, ``ref_date`` ``[B, 1, 3]``,
multilabel targets ``[B, num_classes]``, segmentation targets
``[B, 1, 1, H, W]``).
"""

from __future__ import annotations

import numpy as np

from maestro_tpu_torch.conf.dataset.base import DatasetConfig, RasterConfig


def native_crop_size(dataset: DatasetConfig, name_mod: str) -> int:
    """Pixel size of the crop window for a modality at native resolution."""
    return dataset.crop_gcd * (dataset.sizes[name_mod] // dataset.size_gcd)


def make_synthetic_batch(
    dataset: DatasetConfig,
    batch_size: int = 2,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """A random batch matching the dataset's (static) shapes."""
    rng = np.random.default_rng(seed)
    batch: dict[str, np.ndarray] = {}

    def dates(num: int) -> np.ndarray:
        years = rng.integers(2018, 2022, (batch_size, num, 1))
        doys = rng.integers(1, 366, (batch_size, num, 1))
        hours = rng.integers(0, 24, (batch_size, num, 1))
        return np.concatenate([years, doys, hours], axis=-1).astype(np.int16)

    for name, mod in dataset.inputs.items():
        size = native_crop_size(dataset, name)
        batch[name] = rng.normal(
            size=(batch_size, mod.num_dates, mod.num_channels, size, size),
        ).astype(np.float32)
        batch[f"{name}_dates"] = dates(mod.num_dates)

    batch["ref_date"] = dates(1)

    for name, target in dataset.targets.items():
        if isinstance(target, RasterConfig):  # segmentation raster
            size = round(dataset.crop_meters / target.resolution_meters)
            labels = rng.integers(
                0, target.num_classes, (batch_size, 1, 1, size, size),
            )
            batch[name] = labels.astype(np.int32)
        else:  # (multilabel) classification
            if target.type_target == "classif":
                batch[name] = rng.integers(
                    0, target.num_classes, (batch_size,),
                ).astype(np.int32)
            else:
                batch[name] = (
                    rng.random((batch_size, target.num_classes)) > 0.5
                ).astype(np.int32)
        batch[f"{name}_dates"] = dates(1)

    return batch
