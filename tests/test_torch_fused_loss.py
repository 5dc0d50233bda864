"""Port of the fused patch-group-norm loss (maestro_tpu_torch/ops/fused_loss.py)
and of the reconstruction losses (train/losses.py) against the JAX package.

On the CPU ``masked_patchnorm_sums`` runs its plain forward and backward,
held here against the JAX package's custom-VJP body (ops/fused_loss.py:136-167,
the path it takes off the TPU); the CUDA kernels are held against the plain
versions on the GPU by chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.conf import MaskConfig as JMaskConfig
from maestro_tpu.ops import fused_loss as JFL
from maestro_tpu.ops.patch import expand_token_mask_to_pixels as j_expand_mask
from maestro_tpu.ops.patch import group_norm_tokens as j_group_norm_tokens
from maestro_tpu.ops.patch import unpatchify_pixels as j_unpatchify
from maestro_tpu.specs.fusion import build_fusion_plan as j_build_fusion_plan
from maestro_tpu.train import losses as JL
from maestro_tpu_torch.conf import DatasetsConfig, MaskConfig
from maestro_tpu_torch.ops import fused_loss as TFL
from maestro_tpu_torch.ops import patch as TP
from maestro_tpu_torch.specs.fusion import build_fusion_plan
from maestro_tpu_torch.train import losses as TL

from _torch_port_utils import rng_normal, single_thread_torch, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

RTOL = 1e-5  # fp32; observed rel err ~1e-7

# the FLAIR modalities' norm-group layouts, at fewer rows
LAYOUTS = {
    "aerial": (64, 1024, ((0, 256), (256, 768))),
    "dem": (32, 2048, ((0, 2048),)),
    "s2": (96, 40, ((0, 16), (16, 16), (32, 8))),
    "s1": (80, 8, ((0, 4), (4, 4))),
}


@pytest.mark.parametrize("square", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_masked_patchnorm_sums_matches_jax(layout, square):
    n, f, slices = LAYOUTS[layout]
    t = rng_normal(1, n, f, scale=3.0) + 0.5
    r = rng_normal(2, n, f)
    m = (np.random.default_rng(3).random((n, 1)) < 0.75).astype(np.float32)
    g = 0.37
    (ws, wc), vjp = jax.vjp(
        lambda rr: JFL.masked_patchnorm_sums(jnp.asarray(t), rr, jnp.asarray(m), slices, square),
        jnp.asarray(r),
    )
    (wdr,) = vjp((jnp.float32(g), jnp.float32(0.0)))

    rt = torch.from_numpy(r).requires_grad_(True)
    s, c = TFL.masked_patchnorm_sums(torch.from_numpy(t), rt, torch.from_numpy(m), slices, square)
    (s * g + c * 0.0).backward()
    np.testing.assert_allclose(s.item(), float(ws), rtol=RTOL)
    assert c.item() == float(wc) == m.sum() * f
    np.testing.assert_allclose(to_np(rt.grad), np.asarray(wdr), rtol=RTOL, atol=RTOL * g)


@pytest.mark.parametrize("square", [False, True], ids=["l1", "l2"])
def test_grouped_sums_match_jax(square):
    """The grouped entry (one call for every FLAIR-like layout, as a train
    step makes it; its plain version on the CPU) against the JAX package's
    ``masked_patchnorm_sums`` per layout, sums and each r's gradient; s1's F =
    8 has a slice boundary at column 4, inside one 16-byte bf16 vector."""
    items, want = [], []
    for i, (n, f, slices) in enumerate(LAYOUTS.values()):
        t = rng_normal(20 + i, n, f, scale=3.0) + 0.5
        r = rng_normal(30 + i, n, f)
        m = (np.random.default_rng(40 + i).random((n, 1)) < 0.75).astype(np.float32)
        g = 0.1 * (i + 1)
        (ws, wc), vjp = jax.vjp(
            lambda rr, t=t, m=m, slices=slices: JFL.masked_patchnorm_sums(
                jnp.asarray(t), rr, jnp.asarray(m), slices, square), jnp.asarray(r))
        want.append((float(ws), float(wc), np.asarray(vjp((jnp.float32(g), jnp.float32(0.0)))[0]), g))
        items.append((torch.from_numpy(t), torch.from_numpy(r).requires_grad_(True),
                      torch.from_numpy(m), slices))
    assert LAYOUTS["s1"][2] == ((0, 4), (4, 4))
    before = (TFL.fwd_launch_count, TFL.bwd_launch_count)
    out = TFL.masked_patchnorm_sums_multi(items, square)
    assert out.shape == (len(items), 2) and out.dtype == torch.float32
    (out[:, 0] * torch.tensor([g for *_, g in want])).sum().backward()
    for (ws, wc, wdr, g), (_, r, _, _), (s, c) in zip(want, items, out.detach()):
        np.testing.assert_allclose(s.item(), ws, rtol=RTOL)
        assert c.item() == wc
        np.testing.assert_allclose(to_np(r.grad), wdr, rtol=RTOL, atol=RTOL * g)
    assert (TFL.fwd_launch_count, TFL.bwd_launch_count) == before  # no kernel on the CPU
    # one item is masked_patchnorm_sums; more than 8 are refused
    t, r, m, slices = items[3]
    single = TFL.masked_patchnorm_sums(t, r.detach(), m, slices, square)
    np.testing.assert_array_equal([x.item() for x in single], out[3].detach().numpy())
    with pytest.raises(ValueError, match="1 to 8 items"):
        TFL.masked_patchnorm_sums_multi([items[3]] * 9, square)


def _flair_plans():
    ds = DatasetsConfig(name_dataset="flair").dataset
    jds = JDatasetsConfig(name_dataset="flair").dataset
    return (build_fusion_plan(ds, MaskConfig(), "group"),
            j_build_fusion_plan(jds, JMaskConfig(), "group"))


def _token_inputs(plan, b: int, seed: int):
    """Pixel targets, token-space reconstructions and token masks per modality."""
    rng = np.random.default_rng(seed)
    targets, rec, masks = {}, {}, {}
    for name, spec in plan.mod_specs.items():
        s = spec.image_size
        targets[name] = (rng.normal(size=(b, spec.num_dates, spec.num_channels, s, s)) * 2
                         + 1).astype(np.float32)
        f = spec.num_channels * spec.patch_size**2
        rec[name] = rng.normal(size=(b, spec.num_dates, spec.tokens_per_date, f)).astype(np.float32)
        masks[name] = rng.random((b, spec.num_dates, spec.tokens_per_date)) < 0.75
    return targets, rec, masks


@pytest.mark.parametrize("loss_type", ["l1_norm", "l2_norm"])
def test_token_space_loss_matches_reconstruction_loss(loss_type):
    """The fused token-space loss (and its gradient in the reconstruction)
    against the JAX package's pixel-space ``reconstruction_loss`` on the same
    reconstruction unpatchified."""
    plan, jplan = _flair_plans()
    targets, rec, masks = _token_inputs(plan, 1, seed=8)

    def jax_loss(jrec):
        pix = {n: j_unpatchify(jrec[n], plan.mod_specs[n].patch_size,
                               plan.mod_specs[n].num_channels) for n in jrec}
        pmask = {n: j_expand_mask(jnp.asarray(masks[n]), plan.mod_specs[n].patch_size,
                                  plan.mod_specs[n].num_channels) for n in masks}
        return JL.reconstruction_loss(jplan, {n: jnp.asarray(v) for n, v in targets.items()},
                                      pix, pmask, loss_type)

    want, want_grad = jax.jit(jax.value_and_grad(jax_loss))(
        {n: jnp.asarray(v) for n, v in rec.items()})
    trec = {n: torch.from_numpy(v).requires_grad_(True) for n, v in rec.items()}
    got = TFL.fused_reconstruction_loss(
        plan, {n: torch.from_numpy(v) for n, v in targets.items()}, trec,
        {n: torch.from_numpy(v) for n, v in masks.items()}, loss_type)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for n in rec:
        scale = np.abs(np.asarray(want_grad[n])).max()
        np.testing.assert_allclose(to_np(trec[n].grad), np.asarray(want_grad[n]),
                                   rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("loss_type", ["l1", "l2", "l1_norm", "l2_norm"])
def test_pixel_space_losses_match_jax(loss_type):
    """``reconstruction_loss`` and the fused loss on pixel-space inputs; one
    modality made two-band-group in both plans takes the fused loss's
    pixel-space fallback."""
    plan, jplan = (
        dataclasses.replace(p, mod_specs={**p.mod_specs, "s2": dataclasses.replace(
            p.mod_specs["s2"], len_bands=2, band_groups=(4, 6))})
        for p in _flair_plans())
    targets, rec, masks = _token_inputs(plan, 1, seed=9)
    pix = {n: TP.unpatchify_pixels(torch.from_numpy(v), plan.mod_specs[n].patch_size,
                                   plan.mod_specs[n].num_channels) for n, v in rec.items()}
    pmask = {n: TP.expand_token_mask_to_pixels(torch.from_numpy(v), plan.mod_specs[n].patch_size,
                                               plan.mod_specs[n].num_channels)
             for n, v in masks.items()}
    tt = {n: torch.from_numpy(v) for n, v in targets.items()}
    jt = {n: jnp.asarray(v) for n, v in targets.items()}
    jpix = {n: jnp.asarray(v.numpy()) for n, v in pix.items()}
    jmask = {n: jnp.asarray(v.numpy()) for n, v in pmask.items()}
    want = jax.jit(partial(JL.reconstruction_loss, jplan, loss_type=loss_type))(jt, jpix, jmask)
    got = TL.reconstruction_loss(plan, tt, pix, pmask, loss_type)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    want_f = jax.jit(partial(JFL.fused_reconstruction_loss, jplan, loss_type=loss_type))(
        jt, jpix, jmask)
    got_f = TFL.fused_reconstruction_loss(plan, tt, pix, pmask, loss_type)
    np.testing.assert_allclose(got_f.item(), float(want_f), rtol=RTOL)


def test_patch_group_normalize_matches_jax():
    x = rng_normal(10, 2, 3, 10, 8, 8, scale=2.0)
    want = JL.patch_group_normalize(jnp.asarray(x), 4, (4, 4, 2))
    got = TL.patch_group_normalize(torch.from_numpy(x), 4, (4, 4, 2))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=RTOL)


def test_patch_helpers_match_jax():
    x = rng_normal(11, 2, 3, 16, 5)
    scale, bias = rng_normal(12, 5), rng_normal(13, 5)
    want = j_group_norm_tokens(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = TP.group_norm_tokens(*(torch.from_numpy(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=RTOL)
    m = np.random.default_rng(14).random((2, 3, 16)) < 0.5
    np.testing.assert_array_equal(TP.expand_token_mask_to_pixels(torch.from_numpy(m), 2, 3).numpy(),
                                  np.asarray(j_expand_mask(jnp.asarray(m), 2, 3)))
    np.testing.assert_array_equal(
        TP.expand_token_mask_to_pixels(torch.from_numpy(m[..., None]), 2, 3).numpy(),
        np.asarray(j_expand_mask(jnp.asarray(m), 2, 3)))


def test_bad_inputs_raise_and_cpu_launches_no_kernel():
    t = torch.zeros(4, 8)
    m = torch.ones(4, 1)
    with pytest.raises(ValueError, match="tile"):
        TFL.masked_patchnorm_sums(t, t, m, ((0, 4), (5, 3)), False)
    with pytest.raises(ValueError, match="tile"):
        TFL.masked_patchnorm_sums(t, t, m, ((0, 4),), False)
    with pytest.raises(TypeError, match="bfloat16"):
        TFL.masked_patchnorm_sums(t, t.double(), m, ((0, 8),), False)
    with pytest.raises(ValueError, match=r"\[N, 1\]"):
        TFL.masked_patchnorm_sums(t, t, m[:2], ((0, 8),), False)
    before = (TFL.fwd_launch_count, TFL.bwd_launch_count)
    r = torch.ones(4, 8, requires_grad=True)
    TFL.masked_patchnorm_sums(t, r, m, ((0, 8),), False)[0].backward()
    assert (TFL.fwd_launch_count, TFL.bwd_launch_count) == before
    with pytest.raises(ValueError, match="Invalid loss"):
        TL.loss_elem("huber")
