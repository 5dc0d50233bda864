"""Configuration layer: typed dataclasses + derived static shape state."""

from maestro_tpu_torch.conf.core import (
    BaselineConfig,
    DataConfig,
    ExperimentConfig,
    MaskConfig,
    ModelConfig,
    OptConfig,
    OptFinetuneConfig,
    OptPretrainConfig,
    OptProbeConfig,
    RunConfig,
    TrainerConfig,
)
from maestro_tpu_torch.conf.dataset.base import (
    DatasetConfig,
    InputRasterConfig,
    PatchSizeConfig,
    RasterConfig,
    TargetConfig,
    TargetRasterConfig,
)
from maestro_tpu_torch.conf.dataset.flair import FLAIRConfig
from maestro_tpu_torch.conf.dataset.pastis_hd import PASTISHDConfig
from maestro_tpu_torch.conf.dataset.s2_naip import S2NAIPConfig
from maestro_tpu_torch.conf.dataset.treesatai_ts import TreeSatAITSConfig
from maestro_tpu_torch.conf.datasets import DatasetsConfig

__all__ = [
    "BaselineConfig",
    "DataConfig",
    "DatasetConfig",
    "DatasetsConfig",
    "ExperimentConfig",
    "FLAIRConfig",
    "InputRasterConfig",
    "MaskConfig",
    "ModelConfig",
    "OptConfig",
    "OptFinetuneConfig",
    "OptPretrainConfig",
    "OptProbeConfig",
    "PASTISHDConfig",
    "PatchSizeConfig",
    "RasterConfig",
    "RunConfig",
    "S2NAIPConfig",
    "TargetConfig",
    "TargetRasterConfig",
    "TrainerConfig",
    "TreeSatAITSConfig",
]
