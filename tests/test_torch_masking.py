"""Port of the pretrain masking (maestro_tpu_torch/ops/masking.py) against the
JAX package's ops/masking.py.

``shuffle_mask`` and ``unmask`` are deterministic given their inputs: the
same noise (drawn by ``jax.random`` and handed to both) gives exactly the same
result, ties at noise 0 included.  ``structural_mask`` draws from another
generator than ``jax.random``, so it is held to its invariants.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maestro_tpu.ops import masking as JMK
from maestro_tpu_torch.conf import DatasetsConfig, MaskConfig
from maestro_tpu_torch.ops import masking as TMK
from maestro_tpu_torch.specs.fusion import build_fusion_plan

from _torch_port_utils import rng_normal, single_thread_torch  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")


@pytest.mark.parametrize(("b", "l", "k", "p_struct"), [
    (3, 40, 30, 0.0), (3, 40, 30, 0.5), (2, 100, 75, 0.9), (4, 16, 4, 0.3),
])
def test_shuffle_mask_matches_jax_exactly(b, l, k, p_struct):
    """p_struct > 0 puts many tokens at noise 0: which of those ties are
    masked depends on the sort being stable, as jnp.argsort is."""
    key = jax.random.PRNGKey(b * 1000 + l)
    x = rng_normal(l, b, l, 8)
    struct = np.random.default_rng(k).random((b, l)) < p_struct
    noise = np.array(jax.random.uniform(key, (b, l)))  # what JAX's shuffle_mask draws
    want = JMK.shuffle_mask(key, jnp.asarray(x), jnp.asarray(struct), k)
    got = TMK.shuffle_mask(torch.from_numpy(x), torch.from_numpy(struct),
                           torch.from_numpy(noise), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].sum(dim=1) == k).all()


def test_unmask_matches_jax_exactly():
    b, l, keep, c = 3, 30, 12, 6
    rng = np.random.default_rng(4)
    mask = np.ones((b, l), bool)
    for i in range(b):
        mask[i, rng.choice(l, keep, replace=False)] = False
    x_enc = rng_normal(5, b, keep, c)
    tok = rng_normal(6, b, l, c)
    want = JMK.unmask(jnp.asarray(x_enc), jnp.asarray(tok), jnp.asarray(mask))
    got = TMK.unmask(torch.from_numpy(x_enc), torch.from_numpy(tok), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unmask_inverts_shuffle_mask():
    b, l, k, c = 2, 20, 15, 4
    x = torch.from_numpy(rng_normal(7, b, l, c))
    noise = torch.rand((b, l), generator=torch.Generator().manual_seed(0))
    kept, mask_rec, _ = TMK.shuffle_mask(x, torch.zeros(b, l, dtype=torch.bool), noise, k)
    full = TMK.unmask(kept, torch.zeros_like(x), mask_rec)
    assert torch.equal(full, torch.where(mask_rec[..., None], 0.0, x))


@pytest.mark.parametrize("name", ["flair", "treesatai_ts", "pastis_hd"])
def test_structural_mask_invariants(name):
    plan = build_fusion_plan(DatasetsConfig(name_dataset=name).dataset, MaskConfig(), "group")
    gen = torch.Generator().manual_seed(1)
    for _ in range(5):
        struct, noise = TMK.draw_masks(plan, gen, 4)
        for sname, stream in plan.streams.items():
            m = struct[sname]
            assert m.shape == (4, stream.seq_len) and m.dtype == torch.bool
            assert not m.all(dim=1).any()  # no stream fully masked
            assert noise[sname].shape == m.shape and noise[sname].dtype == torch.float32
            x = torch.zeros(4, stream.seq_len, 2)
            kept, mask_rec, _ = TMK.shuffle_mask(x, m, noise[sname], stream.num_masked)
            assert (mask_rec.sum(dim=1) == stream.num_masked).all()
            assert kept.shape == (4, stream.seq_len - stream.num_masked, 2)
            # structurally masked tokens are masked first
            n_struct = m.sum(dim=1)
            assert ((mask_rec & m).sum(dim=1) == n_struct.clamp(max=stream.num_masked)).all()


def test_structural_mask_redraws_fully_masked_streams():
    """At high probabilities most first draws mask some stream entirely; the
    redraw loop leaves none."""
    mask = MaskConfig(mask_mod=0.9, mask_dates=0.9, mask_loc=0.9)
    plan = build_fusion_plan(DatasetsConfig(name_dataset="flair").dataset, mask, "group")
    first = TMK._draw_struct(plan, torch.Generator().manual_seed(2), 16)
    assert any(m.all(dim=1).any() for m in first.values())
    struct = TMK.structural_mask(plan, torch.Generator().manual_seed(2), 16)
    for m in struct.values():
        assert not m.all(dim=1).any()


def test_batch_flattened_plans_have_no_structural_mask():
    plan = build_fusion_plan(DatasetsConfig(name_dataset="treesatai_ts").dataset,
                             MaskConfig(), "shared")
    struct, noise = TMK.draw_masks(plan, torch.Generator().manual_seed(0), 2)
    for name, s in plan.streams.items():
        assert struct[name].shape == (2 * s.batch_factor, s.seq_len)
        assert not struct[name].any()
        assert noise[name].shape == struct[name].shape
