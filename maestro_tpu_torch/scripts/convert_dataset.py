"""Pre-convert GeoTIFF stacks to ``.npy`` mirrors for fast training IO.

Usage::

    python -m maestro_tpu_torch.scripts.convert_dataset \
        datasets.name_dataset=flair datasets.root_dir=/data \
        [--splits=train,val,test] [--check]

Walks every raster the dataset would read and writes a ``[T, C, H, W]``
``.npy`` mirror next to each ``.tif`` stack (T from the acquisition dates,
C from the band count).  The loader prefers an existing mirror
(``data.preprocess.resolve_raster_path``): mirrors read through numpy memmap
windows, which is faster than TIFF decode and the only multiband-stack path
on hosts without rasterio.  ``--check`` re-reads a window through both
backends and requires equality.  It reads through the port's ``data/io.py``
and ``data/datasets.py``, and writes what the JAX package's script writes.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np


def _read_full(path: Path) -> np.ndarray:
    """[bands, H, W] full read: rasterio when present, else imageio."""
    from maestro_tpu_torch.data import io

    if io.HAS_RASTERIO:
        import rasterio

        with rasterio.open(path) as src:
            return src.read()
    return io._read_full_image(path)


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    splits = ("train", "val", "test")
    check = False
    overrides = []
    for arg in argv:
        if arg.startswith("--splits="):
            splits = tuple(arg.split("=", 1)[1].split(","))
        elif arg == "--check":
            check = True
        elif "=" in arg:
            overrides.append(arg)
        else:
            msg = f"unexpected argument {arg!r}"
            raise SystemExit(msg)
    if not overrides:
        raise SystemExit(__doc__)

    from maestro_tpu_torch.data import io
    from maestro_tpu_torch.data.datasets import DATASET_CLASSES
    from maestro_tpu_torch.main import parse_cli

    _cfg, datasets = parse_cli(overrides)
    ds_cls = DATASET_CLASSES[datasets.name_dataset]
    root = (
        f"{datasets.root_dir}/{datasets.dataset.rel_dir}"
        if datasets.dataset.rel_dir
        else datasets.root_dir
    )

    written, skipped, checked = 0, 0, 0
    for split in splits:
        ds = ds_cls(datasets.dataset, root, split)
        for idx in range(ds.base_length):
            for meta in ds.build_meta(idx).values():
                for path in (meta.path, meta.mask_path):
                    if path is None:
                        continue
                    path = Path(path)
                    if path.suffix.lower() not in (".tif", ".tiff"):
                        continue
                    out = path.with_suffix(".npy")
                    if out.exists():
                        skipped += 1
                        continue
                    arr = _read_full(path)
                    # masks accompany the time series with the same T
                    t = max(len(meta.dates), 1)
                    if arr.shape[0] % t:
                        msg = (
                            f"{path}: {arr.shape[0]} bands not divisible by "
                            f"{t} acquisition dates"
                        )
                        raise SystemExit(msg)
                    stack = arr.reshape(t, arr.shape[0] // t, *arr.shape[1:])
                    np.save(out, stack)
                    written += 1
                    if check:
                        h = min(8, stack.shape[2])
                        w = min(8, stack.shape[3])
                        a = io.read_npy_window(out, 0, h, 0, w)
                        b = io.read_image_window(path, 0, h, 0, w)
                        np.testing.assert_array_equal(a.reshape(-1, h, w), np.asarray(b))
                        checked += 1

    report = {"dataset": datasets.name_dataset, "written": written,
              "skipped_existing": skipped, "checked": checked}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
