"""Host-side raster preprocessing: windows, temporal binning, transforms.

Numpy re-implementation of the reference's per-sample pipeline
(reference maestro/dataset/dataset.py:41-257):

  1. ``sample_crop`` — map a repeat index to a deterministic crop origin on
     the GCD grid (or draw a random origin in train).
  2. ``bin_dates`` — reshape T acquisitions into (num_dates, T // num_dates)
     bins, apply the cloud mask (NaN-fill above ``mask_threshold``), and pick
     one representative date per bin: argmin |x - median| (or random when
     ``random_dates``).
  3. ``log_scale`` (SAR) and ``/ norm_fac`` normalization.
  4. ``apply_transforms`` — synchronized H/V flips and transposition across
     all rasters of a sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from maestro_tpu_torch.conf.dataset.base import DatasetConfig, RasterConfig
from maestro_tpu_torch.data import io


@dataclass
class RasterMeta:
    """Everything needed to read one modality of one sample."""

    path: Path
    dates: np.ndarray  # [T, 3]
    shift: int = 0  # pixel shift (TreeSatAI aerial 304->300 alignment)
    mask_path: Path | None = None
    h5_name: str | None = None
    h5_mask: str | None = None

    def __post_init__(self) -> None:
        self.path = resolve_raster_path(self.path)
        if self.mask_path is not None:
            self.mask_path = resolve_raster_path(self.mask_path)


def resolve_raster_path(path: Path) -> Path:
    """Prefer the configured file; fall back to a sibling .npy mirror.

    Multiband GeoTIFF stacks need rasterio; when a pre-converted ``.npy``
    mirror exists next to the tile (and the original does not, or rasterio is
    unavailable) it is read instead — same [T, C, H, W] layout, faster IO.
    """
    path = Path(path)
    if path.suffix.lower() in (".tif", ".tiff") and not (
        io.HAS_RASTERIO and path.exists()
    ):
        npy = path.with_suffix(".npy")
        if npy.exists():
            return npy
    return path


def sample_crop(
    dataset: DatasetConfig,
    idx: int,
    base_length: int,
    repeats: int,
    rng: np.random.Generator,
    random_crop: bool,
) -> tuple[int, np.ndarray]:
    """(sample index, crop origin on the GCD grid)."""
    if random_crop:
        start_gcd = rng.integers(
            0, dataset.size_gcd - dataset.crop_gcd + 1, size=2,
        )
        return idx % base_length, start_gcd
    idx_repeat = idx // base_length
    iy, ix = idx_repeat // repeats, idx_repeat % repeats
    start_gcd = np.array(
        [iy * dataset.size_gcd // repeats, ix * dataset.size_gcd // repeats],
    )
    return idx % base_length, start_gcd


def read_raster(
    mod: RasterConfig,
    meta: RasterMeta,
    y0: int, y1: int, x0: int, x1: int,
    t0: int, t1: int,
    rng: np.random.Generator,
    random_dates: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Windowed read + band select + temporal binning -> ([D, C, h, w], [D, 3])."""
    suffix = Path(meta.path).suffix.lower()
    num_t = len(meta.dates)
    # the cloud mask is only consumed by temporal binning; when the raster
    # already has exactly num_dates entries the binning (and masking) is
    # skipped entirely, so reading the mask would be pure wasted IO
    use_mask = (mod.mask_threshold / 100.0) < 1.0 and num_t != mod.num_dates
    mask = None

    if suffix in (".tif", ".png", ".jpg", ".jpeg"):
        arr = io.read_image_window(meta.path, y0, y1, x0, x1)
        arr = arr.reshape(num_t, -1, *arr.shape[1:])
        if use_mask and meta.mask_path is not None:
            mask = io.read_image_window(meta.mask_path, y0, y1, x0, x1)
            mask = mask.reshape(num_t, -1, *mask.shape[1:])
    elif suffix == ".npy":
        arr = io.read_npy_window(meta.path, y0, y1, x0, x1)
        if use_mask and meta.mask_path is not None:
            m = np.load(meta.mask_path, mmap_mode="r")
            if m.ndim == 3:  # [T, h, w] -> [T, 1, h, w]
                m = m[:, None]
            mask = np.asarray(m[:, :, y0:y1, x0:x1])
    elif suffix == ".h5":
        arr = io.read_h5_window(meta.path, meta.h5_name, y0, y1, x0, x1)
        if use_mask and meta.h5_mask is not None:
            mask = io.read_h5_window(meta.path, meta.h5_mask, y0, y1, x0, x1)
    else:
        msg = f"Unsupported raster format {suffix!r}."
        raise NotImplementedError(msg)

    order = mod.band_order
    arr = arr[:, : mod.num_channels] if order is None else arr[:, list(order)]

    dates = meta.dates
    if num_t != mod.num_dates:
        arr, dates, mask = arr[t0:t1], dates[t0:t1], (
            mask[t0:t1] if mask is not None else None
        )
        arr, dates = bin_dates(
            arr, dates, mod.num_dates, mod.mask_threshold, mask, rng, random_dates,
        )

    arr = arr.astype(np.float32)
    if mod.log_scale:
        arr = np.log(np.maximum(arr, 1e-10))
    if mod.norm_fac is not None:
        arr = arr / mod.norm_fac
    return arr, dates


def bin_dates(
    arr: np.ndarray,  # [T, C, h, w]
    dates: np.ndarray,  # [T, 3]
    num_dates: int,
    mask_threshold: float,
    mask: np.ndarray | None,
    rng: np.random.Generator,
    random_dates: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Bin T acquisitions into num_dates bins, pick a representative each."""
    t = arr.shape[0]
    per_bin = t // num_dates
    arr = arr.reshape(num_dates, per_bin, *arr.shape[1:]).astype(np.float32)
    dates = dates.reshape(num_dates, per_bin, 3)

    if mask is not None:
        m = mask.reshape(num_dates, per_bin, *mask.shape[1:])
        m = (m > mask_threshold).any(axis=2, keepdims=True)
        # never NaN-out a bin whose every acquisition is cloudy everywhere
        m = m & ~(m.any(axis=(3, 4), keepdims=True).all(axis=1, keepdims=True))
        arr = np.where(m, np.nan, arr)

    diff = np.abs(arr - np.nanmedian(arr, axis=1, keepdims=True))
    if random_dates:
        diff = 0 * diff  # keep NaNs so cloudy dates stay excluded
        diff = diff + rng.random(diff.shape).astype(diff.dtype)
    score = np.mean(diff, axis=(2, 3, 4), keepdims=True)  # [D, per_bin, 1,1,1]
    best = np.nanargmin(score, axis=1)  # [D, 1, 1, 1]

    idx = best.reshape(num_dates, 1, 1, 1, 1)
    arr = np.take_along_axis(arr, idx, axis=1)[:, 0]
    dates = np.take_along_axis(dates, best.reshape(num_dates, 1, 1), axis=1)[:, 0]
    return arr, dates


def apply_transforms(
    sample: dict[str, np.ndarray],
    raster_keys: list[str],
    rng: np.random.Generator,
) -> dict[str, np.ndarray]:
    """Synchronized random H/V flips + transpose over all rasters."""
    if rng.choice([True, False]):
        for k in raster_keys:
            sample[k] = np.flip(sample[k], axis=2)
    if rng.choice([True, False]):
        for k in raster_keys:
            sample[k] = np.flip(sample[k], axis=3)
    if rng.choice([True, False]):
        for k in raster_keys:
            sample[k] = np.swapaxes(sample[k], 2, 3)
    for k in raster_keys:
        sample[k] = np.ascontiguousarray(sample[k])
    return sample
