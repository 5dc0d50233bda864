"""Port of the plain tensor ops (posenc, resize, patch, fusion plan, resize
matrix) against the JAX package, on inputs made with numpy from a seed."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.models import heads as JH
from maestro_tpu.ops import patch as JPatch
from maestro_tpu.ops import posenc as JPos
from maestro_tpu.ops import resize as JResize
from maestro_tpu.specs import fusion as JFusion
from maestro_tpu_torch.conf import DatasetsConfig
from maestro_tpu_torch.models import heads as TH
from maestro_tpu_torch.ops import patch as TPatch
from maestro_tpu_torch.ops import posenc as TPos
from maestro_tpu_torch.ops import resize as TResize
from maestro_tpu_torch.specs import fusion as TFusion

from _torch_port_utils import rng_normal, single_thread_torch, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")


def test_encode_dates():
    rng = np.random.default_rng(0)
    dates = np.stack(
        [rng.integers(2018, 2022, (2, 5)), rng.integers(1, 366, (2, 5)),
         rng.integers(0, 24, (2, 5))], axis=-1,
    ).astype(np.int16)
    ref = dates[:, :1] + np.array([1, -3, 2], np.int16)
    kw = dict(dim=32, date_dim=8, fac_date_enc=1.0, num_tokens=4, len_bands=3)
    want = JPos.encode_dates(jnp.asarray(dates), jnp.asarray(ref), **kw)
    got = TPos.encode_dates(torch.from_numpy(dates), torch.from_numpy(ref), **kw)
    assert got.shape == (2, 15, 4, 32)
    # year differences of a few units in fp32: observed max abs err ~2e-7
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(("grid_pos_enc", "grid"), [(16, 4), (10, 4)])
def test_build_pos_encoding(grid_pos_enc, grid):
    """Pure numpy on both sides: exact, for grids that divide and that do not."""
    want = JPos.build_pos_encoding(grid_pos_enc, grid, 32, 8)
    got = TPos.build_pos_encoding(grid_pos_enc, grid, 32, 8)
    assert got.shape == (grid * grid, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    ("mode", "in_size", "out_size"),
    [("nearest", 6, 16), ("nearest", 20, 8), ("bilinear", 6, 16), ("bilinear", 10, 8)],
)
def test_resize_spatial(mode, in_size, out_size):
    x = rng_normal(3, 2, 3, 2, in_size, in_size)
    want = JResize.resize_spatial(jnp.asarray(x), out_size, mode)
    got = TResize.resize_spatial(torch.from_numpy(x), out_size, mode)
    assert got.shape == (2, 3, 2, out_size, out_size)
    # nearest is a gather (exact); bilinear: observed max abs err ~2e-7
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)


def test_resize_spatial_same_size_is_identity():
    x = torch.from_numpy(rng_normal(4, 1, 1, 2, 8, 8))
    assert TResize.resize_spatial(x, 8, "nearest") is x
    with pytest.raises(ValueError, match="unknown interpolate mode"):
        TResize.resize_spatial(x, 4, "lanczos")


@pytest.mark.parametrize(("in_grid", "out_grid"), [(16, 32), (5, 32), (32, 32), (10, 8)])
def test_resize_matrix(in_grid, out_grid):
    """Up, non-dividing up, identity and the PASTIS 10 -> 8 downsample
    (no antialias prefilter)."""
    want = JH.resize_matrix(in_grid, out_grid)
    got = TH.resize_matrix(in_grid, out_grid)
    assert got.shape == (out_grid, in_grid) and got.dtype == np.float32
    np.testing.assert_allclose(got, to_np(want), rtol=1e-6, atol=1e-6)


def test_patchify_matches_and_round_trips():
    x = rng_normal(5, 2, 3, 4, 12, 12)
    want = JPatch.patchify_pixels(jnp.asarray(x), 4)
    got = TPatch.patchify_pixels(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(to_np(got), to_np(want))
    back = TPatch.unpatchify_pixels(got, 4, 4)
    np.testing.assert_array_equal(to_np(back), x)


def test_unpatchify_matches():
    t = rng_normal(6, 2, 3, 9, 2 * 4 * 4)
    want = JPatch.unpatchify_pixels(jnp.asarray(t), 4, 2)
    got = TPatch.unpatchify_pixels(torch.from_numpy(t), 4, 2)
    np.testing.assert_array_equal(to_np(got), to_np(want))


@pytest.mark.parametrize("fusion_mode", ["shared", "monotemp", "mod", "group"])
def test_fusion_plan_group_ungroup(fusion_mode):
    jplan = JFusion.build_fusion_plan(
        JDatasetsConfig(name_dataset="pastis_hd").dataset, None, fusion_mode,
    )
    tplan = TFusion.build_fusion_plan(
        DatasetsConfig(name_dataset="pastis_hd").dataset, None, fusion_mode,
    )
    assert tplan.mods == jplan.mods
    assert {n: (s.mods, s.encoder, s.batch_factor, s.seq_len, s.seg_offsets,
                s.seg_lens, s.num_masked) for n, s in tplan.streams.items()} == {
        n: (s.mods, s.encoder, s.batch_factor, s.seq_len, s.seg_offsets,
            s.seg_lens, s.num_masked) for n, s in jplan.streams.items()}
    tokens = {
        name: rng_normal(i, 2, spec.date_axis, spec.tokens_per_date, 4)
        for i, (name, spec) in enumerate(tplan.mod_specs.items())
    }
    want = jplan.group({k: jnp.asarray(v) for k, v in tokens.items()})
    got = tplan.group({k: torch.from_numpy(v) for k, v in tokens.items()})
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]))
    back = tplan.ungroup(got)
    for name, value in tokens.items():
        np.testing.assert_array_equal(to_np(back[name]), value)
