"""Raster file IO with graceful backend fallbacks.

The reference reads windows via rasterio / numpy memmap / h5py
(reference maestro/dataset/dataset.py:155-186).  rasterio is optional
here: GeoTIFF reads fall back to imageio / PIL (sufficient for <=4-band
images; full multiband GeoTIFF stacks require rasterio to be installed).  h5py is
imported where an HDF5 file is read, so a run over ``.npy`` tiles needs
neither.  Dates are parsed into int16 (year, day-of-year, hour) triplets.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path

import numpy as np

try:
    import rasterio
    from rasterio.windows import Window

    HAS_RASTERIO = True
except ImportError:
    HAS_RASTERIO = False


# --------------------------------------------------------------------------
# windowed reads: all return [T*C, h, w]-style arrays (band-major)
# --------------------------------------------------------------------------
def read_image_window(
    path: Path, y0: int, y1: int, x0: int, x1: int,
) -> np.ndarray:
    """Read [C, y1-y0, x1-x0] from an image file (.tif/.png/.jpg)."""
    path = Path(path)
    if HAS_RASTERIO:
        with rasterio.open(path) as src:
            return src.read(window=Window(x0, y0, x1 - x0, y1 - y0))
    img = _read_full_image(path)
    return img[:, y0:y1, x0:x1]


def _read_full_image(path: Path) -> np.ndarray:
    """[C, H, W] full read via imageio (cached per-process by the OS cache)."""
    import imageio.v3 as iio

    arr = np.asarray(iio.imread(path))
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


def read_npy_window(
    path: Path, y0: int, y1: int, x0: int, x1: int,
) -> np.ndarray:
    """Windowed memmap read of a [T, C, H, W] (or [C, H, W]) stack."""
    stack = np.load(path, mmap_mode="r")
    if stack.ndim < 4:
        stack = stack[None]
    return np.asarray(stack[:, :, y0:y1, x0:x1])


def read_h5_window(
    path: Path, name: str, y0: int, y1: int, x0: int, x1: int,
) -> np.ndarray:
    """Windowed read of an HDF5 dataset shaped [T, C, H, W]."""
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f[name][:, :, y0:y1, x0:x1])


# --------------------------------------------------------------------------
# date parsing (reference dataset/utils.py:12-66)
# --------------------------------------------------------------------------
def dates_to_numpy(dates: list[datetime]) -> np.ndarray:
    """[N, 3] int16 (year, day-of-year, hour)."""
    return np.array(
        [[d.year, d.timetuple().tm_yday, d.hour] for d in dates], dtype=np.int16,
    )


def parse_date_strs(date_strs: list, fmt: str = "%Y-%m-%d") -> np.ndarray:
    date_strs = [str(s) for s in date_strs]
    fixed = [s[:-2] + "01" if s.endswith("00") else s for s in date_strs]
    return dates_to_numpy([datetime.strptime(s, fmt) for s in fixed])


def parse_product_names(products: list, idx: int) -> np.ndarray:
    """Parse acquisition dates out of ESA product names (split on '_')."""
    out = []
    for product in products:
        if isinstance(product, bytes):
            product = product.decode()
        out.append(datetime.strptime(product.split("_")[-idx][:8], "%Y%m%d"))
    return dates_to_numpy(out)


def parse_naip_name(name: str) -> np.ndarray:
    return dates_to_numpy([datetime.strptime(name.split("_")[-1][:8], "%Y%m%d")])


def parse_date_dict(datetime_dict: dict | str, start: int = 0) -> np.ndarray:
    """Parse {index: yyyymmdd} dicts (PASTIS metadata / FLAIR gpkg)."""
    if not isinstance(datetime_dict, dict):
        datetime_dict = json.loads(datetime_dict)
    dates = [
        datetime.strptime(str(datetime_dict[str(i)]), "%Y%m%d")
        for i in range(start, len(datetime_dict) + start)
    ]
    return dates_to_numpy(dates)
