"""The port's config tree against the JAX package's, field by field: the same
groups, the same field names in the same order, the same annotations and
the same defaults, so one command line means the same run in both."""

from __future__ import annotations

import dataclasses

import pytest

import maestro_tpu.conf as J
import maestro_tpu_torch.conf as T


def _walk(j, t, path: str) -> int:
    """Compare two dataclass instances recursively; returns the leaves seen."""
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in tf] == [f.name for f in jf], path
    leaves = 0
    for a, b in zip(jf, tf):
        where = f"{path}.{a.name}"
        assert str(b.type) == str(a.type), where
        leaves += _same(getattr(j, a.name), getattr(t, b.name), where)
    return leaves


def _same(va, vb, where: str) -> int:
    if dataclasses.is_dataclass(va):
        assert type(vb).__name__ == type(va).__name__, where
        return _walk(va, vb, where)
    if isinstance(va, dict):
        assert list(vb) == list(va), where
        return sum(_same(va[k], vb[k], f"{where}[{k}]") for k in va)
    assert type(vb) is type(va) and vb == va, where
    return 1


@pytest.mark.parametrize("name", ["ExperimentConfig", "RunConfig", "DataConfig", "ModelConfig",
                                  "TrainerConfig", "OptFinetuneConfig", "MaskConfig"])
def test_config_groups_match_jax(name):
    assert _walk(getattr(J, name)(), getattr(T, name)(), name) > 0


@pytest.mark.parametrize("dataset", ["treesatai_ts", "pastis_hd", "flair", "s2_naip"])
def test_datasets_config_matches_jax(dataset):
    j = J.DatasetsConfig(name_dataset=dataset)
    t = T.DatasetsConfig(name_dataset=dataset)
    assert _walk(j, t, "datasets") > 0
    assert _same(j.dataset, t.dataset, "dataset") > 0  # derived state included
