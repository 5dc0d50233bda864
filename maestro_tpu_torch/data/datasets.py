"""Concrete Earth-observation datasets.

Numpy map-style datasets mirroring the reference's four readers
(reference maestro/dataset/{treesatai_ts,pastis_hd,flair,s2_naip}.py):
each ``__getitem__`` returns a dict of float32 rasters ``[D, C, h, w]``,
``{mod}_dates`` ``[D, 3]`` int16, targets, and ``ref_date`` ``[1, 3]``.
Samples are pure numpy and feed the threaded loader (data/loader.py).

Split and metadata tables are read with the standard library's ``csv`` and
``json`` modules (the JAX package reads them with pandas): the same rows in
the same order, so a run needs neither pandas nor, over ``.npy`` tiles,
h5py or an image library.
"""

from __future__ import annotations

import csv
import json
from datetime import datetime
from pathlib import Path

import numpy as np

from maestro_tpu_torch.conf.dataset.base import DatasetConfig
from maestro_tpu_torch.data import io
from maestro_tpu_torch.data.preprocess import (
    RasterMeta,
    apply_transforms,
    read_raster,
    sample_crop,
)


Table = dict[str, list[str]]  # column name -> values, in file order


def read_csv(path: Path) -> Table:
    """One CSV file as columns of strings, in the file's column order."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return {name: [row[i] for row in rows] for i, name in enumerate(header)}


def read_split_csv(
    csv_dir: Path,
    stage: str,
    ssl_phase: str,
    version: str | None = None,
    filter_percent: int | None = None,
    fold: int | None = None,
    val_pretrain: bool = False,
    test_pretrain: bool = False,
) -> Table:
    """Split CSVs; pretrain folds val (and test) into train when configured."""
    suffix = []
    if version:
        suffix.append(version)
    if filter_percent:
        suffix.append(f"filtered_{filter_percent}")
    if fold:
        suffix.append(f"fold_{fold}")

    stages = [stage]
    if stage == "train" and ssl_phase == "pretrain":
        if val_pretrain:
            stages.append("val")
        if test_pretrain:
            stages.append("test")

    tables = [read_csv(Path(csv_dir) / f"{'_'.join([s, *suffix])}.csv") for s in stages]
    return {name: [v for t in tables for v in t[name]] for name in tables[0]}


class EODataset:
    """Base: GCD-aligned multi-resolution window reading over all rasters."""

    def __init__(
        self,
        dataset: DatasetConfig,
        root_dir: str | Path,
        stage: str,
        use_transform: bool = False,
        random_dates: bool = False,
        random_crop: bool = False,
        ssl_phase: str = "pretrain",
        seed: int = 42,
    ) -> None:
        self.dataset = dataset
        self.root_dir = Path(root_dir)
        self.stage = stage
        self.ssl_phase = ssl_phase
        self.use_transform = use_transform
        self.random_dates = random_dates and stage == "train"
        self.random_crop = random_crop and stage == "train"
        self.seed = seed
        self._epoch = 0
        self.base_length = 0
        self.repeats = getattr(dataset, "repeats", 1)

    def set_epoch(self, epoch: int) -> None:
        """Vary per-sample randomness across epochs (loaders call this)."""
        self._epoch = int(epoch)

    def _rng(self, idx: int) -> np.random.Generator:
        """Per-(seed, epoch, index) rng: identical no matter which worker
        thread/process serves the call or in what order — sample-level
        determinism the reference gets from seed_everything(workers=True)."""
        return np.random.default_rng([self.seed, self._epoch, idx])

    # -- subclass hooks -------------------------------------------------
    def build_meta(self, idx: int) -> dict[str, RasterMeta]:
        raise NotImplementedError

    def finalize_sample(self, idx: int, sample: dict) -> dict:
        return sample

    # -- shared machinery ----------------------------------------------
    def read_sample(self, idx: int) -> dict[str, np.ndarray]:
        ds = self.dataset
        rng = self._rng(idx)
        idx, start_gcd = sample_crop(
            ds, idx, self.base_length, self.repeats, rng, self.random_crop,
        )
        if start_gcd is None:
            start_gcd = rng.integers(0, ds.size_gcd - ds.crop_gcd + 1, 2)
        meta = self.build_meta(idx)

        sample: dict[str, np.ndarray] = {}
        for name_mod, mod in ds.rasters.items():
            m = meta[name_mod]
            fac = ds.sizes[name_mod] // ds.size_gcd
            y0, x0 = (start_gcd * fac) + m.shift
            y1, x1 = ((start_gcd + ds.crop_gcd) * fac) + m.shift
            num_t = len(m.dates)
            t0 = int(rng.integers(0, num_t % mod.num_dates + 1))
            t1 = t0 + mod.num_dates * (num_t // mod.num_dates)
            arr, dates = read_raster(
                mod, m, y0, y1, x0, x1, t0, t1, rng, self.random_dates,
            )
            sample[name_mod] = arr
            sample[f"{name_mod}_dates"] = dates
        return self.finalize_sample(idx, sample)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        sample = self.read_sample(idx)
        if self.use_transform:
            # fold_in vs read_sample's stream: an independent draw sequence
            sample = apply_transforms(
                sample, list(self.dataset.rasters),
                np.random.default_rng([self.seed, self._epoch, idx, 1]),
            )
        return sample

    def __len__(self) -> int:
        return self.base_length * self.repeats**2


class TreeSatAITSDataset(EODataset):
    """TreeSatAI-TS: aerial .tif + one .h5 of Sentinel time series per tile."""

    MLC_THRESH = 0.07

    def __init__(self, dataset, root_dir, stage, **kwargs) -> None:
        super().__init__(dataset, root_dir, stage, **kwargs)
        csv = read_split_csv(
            self.root_dir, stage, self.ssl_phase,
            filter_percent=dataset.filter_percent,
            val_pretrain=dataset.val_pretrain,
        )
        skip = ("aerial_name", "aerial_date", "sen_name")
        target_cols = [c for c in csv if c not in skip]
        self.aerial_names = csv["aerial_name"]
        self.sen_names = csv["sen_name"]
        self.aerial_dates = [
            io.dates_to_numpy([datetime.fromisoformat(d)]) for d in csv["aerial_date"]
        ]
        self.target_fracs = np.array(
            [[float(v) for v in row] for row in zip(*(csv[c] for c in target_cols))],
            dtype=np.float64,
        ).reshape(len(self.aerial_names), len(target_cols))
        self.base_length = len(self.aerial_names)
        self.repeats = 1

    def build_meta(self, idx: int) -> dict[str, RasterMeta]:
        sen = self.root_dir / "sentinel-ts" / self.sen_names[idx]
        import h5py

        with h5py.File(sen, "r") as f:
            s2_dates = io.parse_product_names(f["sen-2-products"][:], 5)
            s1a_dates = io.parse_product_names(f["sen-1-asc-products"][:], 5)
            s1d_dates = io.parse_product_names(f["sen-1-des-products"][:], 5)
        return {
            "aerial": RasterMeta(
                path=self.root_dir / "aerial" / self.aerial_names[idx],
                dates=self.aerial_dates[idx],
                shift=2,  # tiles are 304x304; center-crop to 300x300
            ),
            "s2": RasterMeta(sen, s2_dates, h5_name="sen-2-data",
                             h5_mask="sen-2-masks"),
            "s1_asc": RasterMeta(sen, s1a_dates, h5_name="sen-1-asc-data"),
            "s1_des": RasterMeta(sen, s1d_dates, h5_name="sen-1-des-data"),
        }

    def finalize_sample(self, idx: int, sample: dict) -> dict:
        frac = self.target_fracs[idx]
        date = self.aerial_dates[idx]
        sample["treesat_mlc"] = (frac > 0).astype(np.int32)
        sample["treesat_mlc_dates"] = date
        sample["treesat_mlc_thresh"] = (frac > self.MLC_THRESH).astype(np.int32)
        sample["treesat_mlc_thresh_dates"] = date
        sample["ref_date"] = date
        return sample


class PASTISHDDataset(EODataset):
    """PASTIS-HD: SPOT .tif + S2/S1 .npy stacks + annotation .npy."""

    def __init__(self, dataset, root_dir, stage, **kwargs) -> None:
        super().__init__(dataset, root_dir, stage, **kwargs)
        csv = read_split_csv(
            self.root_dir, stage, self.ssl_phase,
            filter_percent=dataset.filter_percent, fold=dataset.fold,
            val_pretrain=dataset.val_pretrain,
        )
        self.image_ids = csv["image"]
        self.base_length = len(self.image_ids)
        meta_path = self.root_dir / "metadata.json"
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else None
        self.date_dicts = self._load_date_dicts(meta)
        self.spot_date = io.parse_date_strs(["2019-07-01"])

    def _load_date_dicts(self, meta_json) -> dict[str, dict]:
        """Dates from metadata.geojson (geopandas optional) or metadata.json."""
        out: dict[str, dict] = {"s2": {}, "s1_asc": {}, "s1_des": {}}
        keys = {"s2": "dates-S2", "s1_asc": "dates-S1A", "s1_des": "dates-S1D"}
        if meta_json is not None:  # {image id: {column: value}}
            for image_id in self.image_ids:
                row = meta_json[str(image_id)]
                for mod, col in keys.items():
                    out[mod][image_id] = io.parse_date_dict(row[col])
            return out
        try:
            import geopandas as gpd

            gdf = gpd.read_file(self.root_dir / "metadata.geojson").set_index("id")
            for image_id in self.image_ids:
                for mod, col in keys.items():
                    out[mod][image_id] = io.parse_date_dict(
                        gdf.loc[str(image_id), col],
                    )
            return out
        except ImportError:
            with open(self.root_dir / "metadata.geojson") as f:
                geo = json.load(f)
            by_id = {
                str(feat["properties"]["id"]): feat["properties"]
                for feat in geo["features"]
            }
            for image_id in self.image_ids:
                props = by_id[str(image_id)]
                for mod, col in keys.items():
                    out[mod][image_id] = io.parse_date_dict(props[col])
            return out

    def build_meta(self, idx: int) -> dict[str, RasterMeta]:
        iid = self.image_ids[idx]
        spot = (
            self.root_dir / "DATA_SPOT" / "PASTIS_SPOT6_RVB_1M00_2019"
            / f"SPOT6_RVB_1M00_2019_{iid}.tif"
        )
        return {
            "spot": RasterMeta(spot, self.spot_date),
            "s2": RasterMeta(self.root_dir / "DATA_S2" / f"S2_{iid}.npy",
                             self.date_dicts["s2"][iid]),
            "s1_asc": RasterMeta(self.root_dir / "DATA_S1A" / f"S1A_{iid}.npy",
                                 self.date_dicts["s1_asc"][iid]),
            "s1_des": RasterMeta(self.root_dir / "DATA_S1D" / f"S1D_{iid}.npy",
                                 self.date_dicts["s1_des"][iid]),
            "pastis_seg": RasterMeta(
                self.root_dir / "ANNOTATIONS" / f"TARGET_{iid}.npy",
                self.spot_date,
            ),
        }

    def finalize_sample(self, idx: int, sample: dict) -> dict:
        seg = sample["pastis_seg"]
        sample["pastis_mlc"] = np.array(
            [(seg == c).any() for c in range(1, 19)], dtype=np.int32,
        )
        sample["pastis_mlc_dates"] = self.spot_date
        sample["ref_date"] = self.spot_date
        return sample


class FLAIRDataset(EODataset):
    """FLAIR / FLAIR-HUB: per-modality .tif tiles + GPKG date metadata."""

    MOD_MAPPING = {
        "aerial": "aerial_rgbi",
        "dem": "dem_elev",
        "spot": "spot_rgbi",
        "s2": "sentinel2_ts",
        "s2_mask": "sentinel2_msk-sc",
        "s1_asc": "sentinel1-asc_ts",
        "s1_des": "sentinel1-desc_ts",
        "cosia": "aerial_label-cosia",
        "lpis": "all_label-lpis",
    }

    def __init__(self, dataset, root_dir, stage, **kwargs) -> None:
        super().__init__(dataset, root_dir, stage, **kwargs)
        csv_dir = Path(dataset.csv_dir) if dataset.csv_dir else self.root_dir
        csv = read_split_csv(
            csv_dir, stage, self.ssl_phase, version=dataset.version,
            filter_percent=dataset.filter_percent,
            val_pretrain=dataset.val_pretrain,
        )
        self.patch_ids = csv["patch_id"]
        self.base_length = len(self.patch_ids)
        self.dates_str, self.dates_dict = self._load_dates()
        if dataset.version == "flair2":
            self.cosia_ignore = (1, 2, 7, 15, 16, 17, 18)
        else:
            self.cosia_ignore = (15, 16, 17, 18)
        self.lpis_ignore = (0,)

    def _read_mtd(self, name_mod: str) -> Table:
        """GLOBAL_*_MTD_DATES table: .gpkg via geopandas, else a .csv mirror."""
        flair = self.MOD_MAPPING[name_mod].split("_")[0].upper()
        base = self.root_dir / "GLOBAL_ALL_MTD" / f"GLOBAL_{flair}_MTD_DATES"
        gpkg = base.with_suffix(".gpkg")
        if gpkg.exists():
            try:
                import geopandas as gpd

                gdf = gpd.read_file(gpkg, engine="pyogrio", use_arrow=True)
                return {c: [str(v) for v in gdf[c]] for c in gdf.columns}
            except ImportError:
                pass
        return read_csv(base.with_suffix(".csv"))

    def _load_dates(self):
        """Aerial/spot per-patch date strings + S2/S1 per-zone date dicts."""
        dates_str, dates_dict = {}, {}
        for name_mod in ("aerial", "spot"):
            gdf = self._read_mtd(name_mod)
            dates_str[name_mod] = dict(zip(gdf["patch_id"], gdf["date"]))
        for name_mod in ("s2", "s1_asc", "s1_des"):
            gdf = self._read_mtd(name_mod)
            dates_dict[name_mod] = {
                "_".join(pid.split("_")[:2]): d
                for pid, d in zip(gdf["patch_id"], gdf["acquisition_dates"])
            }
        return dates_str, dates_dict

    def _tile_path(self, name_mod: str, patch_id: str) -> Path:
        domain, area, pos = patch_id.split("_")
        flair = self.MOD_MAPPING[name_mod].upper()
        return (
            self.root_dir / f"{domain}_{flair}" / area
            / f"{domain}_{flair}_{area}_{pos}.tif"
        )

    def build_meta(self, idx: int) -> dict[str, RasterMeta]:
        pid = self.patch_ids[idx]
        zone = "_".join(pid.split("_")[:2])
        aerial_date = io.parse_date_strs(
            [self.dates_str["aerial"][pid]], fmt="%Y%m%d",
        )
        meta = {}
        for name_mod in self.dataset.rasters:
            if name_mod in ("aerial", "dem", "cosia", "lpis"):
                dates = aerial_date
            elif name_mod == "spot":
                dates = io.parse_date_strs(
                    [self.dates_str["spot"][pid]], fmt="%Y%m%d",
                )
            else:
                dates = io.parse_date_dict(
                    self.dates_dict[name_mod][zone], start=1,
                )
            meta[name_mod] = RasterMeta(
                self._tile_path(name_mod, pid),
                dates,
                mask_path=(
                    self._tile_path("s2_mask", pid) if name_mod == "s2" else None
                ),
            )
        self._aerial_date = aerial_date
        return meta

    def finalize_sample(self, idx: int, sample: dict) -> dict:
        for name, ignore in (("cosia", self.cosia_ignore), ("lpis", self.lpis_ignore)):
            if name not in sample:
                continue
            missing = getattr(self.dataset, name).missing_val
            arr = sample[name]
            arr[np.isin(arr, ignore)] = missing
            sample[name] = arr
        sample["ref_date"] = self._aerial_date
        return sample


class S2NAIPDataset(EODataset):
    """S2-NAIP urban (pretrain-only): NAIP .png + stacked sentinel .tifs."""

    def __init__(self, dataset, root_dir, stage, **kwargs) -> None:
        super().__init__(dataset, root_dir, stage, **kwargs)
        csv = read_split_csv(
            self.root_dir, stage, self.ssl_phase,
            val_pretrain=dataset.val_pretrain,
            test_pretrain=dataset.test_pretrain,
        )
        self.image_ids = csv["name"]
        self.base_length = len(self.image_ids)

    def _dates_txt(self, sub: str, iid: str) -> np.ndarray:
        return np.loadtxt(self.root_dir / "dates" / sub / f"{iid}.txt", dtype="str")

    def build_meta(self, idx: int) -> dict[str, RasterMeta]:
        iid = self.image_ids[idx]
        ref_date = io.parse_naip_name(str(self._dates_txt("naip", iid)))
        self._ref_date = ref_date
        meta = {
            "aerial": RasterMeta(self.root_dir / "naip" / f"{iid}.png", ref_date),
            "spot": RasterMeta(self.root_dir / "naip" / f"{iid}.png", ref_date),
        }
        if "landsat" in self.dataset.rasters:
            meta["landsat"] = RasterMeta(
                self.root_dir / "landsat" / f"{iid}_stacked.tif",
                io.parse_product_names(list(self._dates_txt("landsat", iid)), 4),
            )
        if "s2" in self.dataset.rasters:
            meta["s2"] = RasterMeta(
                self.root_dir / "sentinel2" / f"{iid}_stacked.tif",
                io.parse_product_names(list(self._dates_txt("s2", iid)), 5),
            )
        if "s1" in self.dataset.rasters:
            meta["s1"] = RasterMeta(
                self.root_dir / "sentinel1" / f"{iid}.tif",
                io.parse_product_names(list(self._dates_txt("s1", iid)), 5),
            )
        return meta

    def finalize_sample(self, idx: int, sample: dict) -> dict:
        sample["ref_date"] = self._ref_date
        return sample


DATASET_CLASSES = {
    "treesatai_ts": TreeSatAITSDataset,
    "pastis_hd": PASTISHDDataset,
    "flair": FLAIRDataset,
    "s2_naip": S2NAIPDataset,
}
