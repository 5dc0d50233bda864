"""Datasets registry: holds all dataset configs, selects the active one.

Mirrors reference maestro/conf/datasets.py:13-41.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from maestro_tpu_torch.conf.dataset.base import DatasetConfig
from maestro_tpu_torch.conf.dataset.flair import FLAIRConfig
from maestro_tpu_torch.conf.dataset.pastis_hd import PASTISHDConfig
from maestro_tpu_torch.conf.dataset.s2_naip import S2NAIPConfig
from maestro_tpu_torch.conf.dataset.treesatai_ts import TreeSatAITSConfig

DATASET_NAMES = ("treesatai_ts", "pastis_hd", "flair", "s2_naip")


@dataclass
class DatasetsConfig:
    """Registry of all dataset configs plus the active selection."""

    root_dir: str = ""
    name_dataset: str = "treesatai_ts"
    treesatai_ts: TreeSatAITSConfig = field(default_factory=TreeSatAITSConfig)
    pastis_hd: PASTISHDConfig = field(default_factory=PASTISHDConfig)
    flair: FLAIRConfig = field(default_factory=FLAIRConfig)
    s2_naip: S2NAIPConfig = field(default_factory=S2NAIPConfig)

    def __post_init__(self) -> None:
        if self.name_dataset not in DATASET_NAMES:
            msg = f"Invalid dataset name {self.name_dataset!r}; expected {DATASET_NAMES}."
            raise ValueError(msg)

    @property
    def dataset(self) -> DatasetConfig:
        """The active dataset config."""
        return getattr(self, self.name_dataset)
