"""The baseline adapters of the port (``maestro_tpu_torch.baselines``: DINOv2,
DOFA, CROMA, SatMAE, Prithvi) against the JAX package's, on the CPU.

Every adapter at the test-only ``micro`` size, fp32, on a PASTIS-HD synthetic
batch (the reference's Table-2 dataset; SatMAE and Prithvi read its S2 series
alone).  The JAX package's ``init`` gives the parameter tree (traced with
``jax.eval_shape``; the values are drawn with numpy, so that no leaf is zero),
and ``port.from_jax.load_jax_params`` carries it into the port's module,
which checks the two trees against each other leaf by leaf.  Then the finetune and
probe logits, and one ``make_supervised_step`` (finetune for every adapter,
probe for two; the loss and every updated parameter), agree with the JAX
package's.  Also: the bicubic
resize the adapters' position embeddings need, against the JAX package's and
``F.interpolate(mode="bicubic")``; ``resize_token_grid``; the generic
``ViTBackbone``; the refusals; the layer-wise LR decay of a 14-block DINOv2,
multiplier by multiplier against the JAX package's; and DINOv2 ``huge``,
whose head dims neither kernel takes, refused by name by the kernels' shape
checks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import maestro_tpu.baselines.dinov2 as JDINO
from maestro_tpu.baselines import backbone as JBB
from maestro_tpu.baselines import build_baseline as j_build_baseline
from maestro_tpu.conf import BaselineConfig as JBaselineConfig
from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.conf import OptFinetuneConfig as JOptFinetuneConfig
from maestro_tpu.conf import OptProbeConfig as JOptProbeConfig
from maestro_tpu.ops import resize as JR
from maestro_tpu.train import optim as JO
from maestro_tpu.train import state as JS
from maestro_tpu.train import steps as JSteps
from maestro_tpu.utils.testing import make_synthetic_batch
from maestro_tpu_torch.baselines import BASELINE_MODELS, build_baseline
from maestro_tpu_torch.baselines import backbone as TBB
from maestro_tpu_torch.baselines import dinov2 as TDINO
from maestro_tpu_torch.conf import BaselineConfig, DatasetsConfig, OptFinetuneConfig, OptProbeConfig
from maestro_tpu_torch.models.vit import AttentiveReduce
from maestro_tpu_torch.ops import attention, attn_pool
from maestro_tpu_torch.ops import resize as TR
from maestro_tpu_torch.port.from_jax import flax_path, load_jax_params
from maestro_tpu_torch.train import optim as TO
from maestro_tpu_torch.train import steps as TS
from maestro_tpu_torch.train.state import TrainState

from _torch_port_utils import randomized_tree, single_thread_torch, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

BATCH = 2
LOSS_RTOL = 1e-5  # tests/test_torch_supervised.py's
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
LOGIT_RTOL = 1e-5  # of max |logit| (observed 6e-6, DOFA's generated conv)
OPT = {"probe": (OptProbeConfig, JOptProbeConfig),
       "finetune": (OptFinetuneConfig, JOptFinetuneConfig)}
# (id, model, fusion mode); DINOv2 and DOFA take shared / monotemp, CROMA its
# two modes, SatMAE and Prithvi "mod" over S2 alone
CASES = [
    ("dinov2-shared", "dinov2", "shared"),
    ("dinov2-monotemp", "dinov2", "monotemp"),
    ("dofa", "dofa", "shared"),
    ("croma-late", "croma", "late-croma"),
    ("croma-inter", "croma", "inter-croma"),
    ("satmae", "satmae", "mod"),
    ("prithvi", "prithvi", "mod"),
]
# the cases that also take a probe step (the heads alone train; CROMA's
# inter-croma heads read the joint tokens as one more stream); the others
# compare their probe logits
PROBE_STEP = ("dinov2", "shared"), ("croma", "inter-croma")


def _datasets(model: str):
    """PASTIS-HD configs of both packages (S2 alone for SatMAE and Prithvi)."""
    pair = []
    for cls in (JDatasetsConfig, DatasetsConfig):
        ds = cls(name_dataset="pastis_hd")
        if model in ("satmae", "prithvi"):
            ds.pastis_hd.filter_inputs = ["s2"]
            ds.pastis_hd.__post_init__()
        pair.append(ds)
    return pair


def _tree(shapes, seed: int) -> dict:
    """Numpy values for the JAX package's parameter tree ``shapes``: dense
    kernels Normal(0, 1/fan_in), scales 1 + 0.1 N, every other leaf 0.2 N
    (biases, CLS tokens and LayerScales included, so every leaf takes part)."""
    rng = np.random.default_rng(seed)

    def value(path, leaf):
        x = rng.normal(size=leaf.shape)
        name = str(path[-1].key)
        if name == "kernel":
            x = x * leaf.shape[0] ** -0.5
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.2 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(value, shapes)


def _pair(model: str, fusion: str):
    """The JAX adapter, a parameter tree of the shapes its ``init`` makes
    (numpy values), the port's adapter config and a batch (numpy)."""
    jds, tds = _datasets(model)
    kw = {"model": model, "model_size": "micro", "fusion_mode": fusion}
    if model == "prithvi":
        kw["version"] = "v2"
    jmodel = j_build_baseline(jds, JBaselineConfig(**kw), dtype=jnp.float32)
    batch = make_synthetic_batch(jds.dataset, BATCH, seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, "finetune"))
    return jmodel, _tree(shapes, seed=1), batch, (tds, BaselineConfig(**kw))


def _port(tree, config):
    """The port's adapter holding ``tree`` (``load_jax_params`` checks the
    two trees against each other both ways)."""
    model = build_baseline(*config, torch.float32, device="cpu")
    load_jax_params(model, tree)
    return model


def _assert_params_match(model, tree) -> None:
    params = dict(model.named_parameters())
    flat = {tuple(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree["params"])[0]}
    for name, p in params.items():
        path, transpose = flax_path(model, name)
        want = flat.pop(path)
        np.testing.assert_allclose(to_np(p), want.T if transpose else want,
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
    assert not flat


@pytest.mark.parametrize(("model", "fusion"), [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_adapter_matches_jax(model, fusion):
    """Finetune and probe logits, then one finetune step (and for
    ``PROBE_STEP`` one probe step) from the same weights: the loss and every
    parameter after the update (the frozen ones included)."""
    jmodel, tree, batch, config = _pair(model, fusion)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    both = jax.jit(lambda p, b: (jmodel.apply(p, b, "finetune"), jmodel.apply(p, b, "probe")))
    want = dict(zip(("finetune", "probe"), both(jax.tree.map(jnp.asarray, tree), jbatch)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model_t = _port(tree, config)
    with torch.no_grad():
        for phase in ("finetune", "probe"):
            got = model_t(tbatch, phase)
            assert sorted(got) == sorted(want[phase])
            for k, w in want[phase].items():
                w = np.asarray(w)
                np.testing.assert_allclose(to_np(got[k]), w, rtol=0,
                                           atol=LOGIT_RTOL * np.abs(w).max(),
                                           err_msg=f"{phase} {k}")

    for phase in ("finetune", "probe") if (model, fusion) in PROBE_STEP else ("finetune",):
        cfg, jcfg = OPT[phase]
        params = jax.tree.map(jnp.asarray, tree)
        tx = JO.make_optimizer(jcfg(batch_size=BATCH), phase, 4, params)
        jstep = JSteps.make_supervised_step(jmodel, phase, tx, donate=False)
        jstate, _, jlogs = jstep(JS.TrainState.create(params, tx), jbatch,
                                 JSteps.init_metric_states(jmodel.head_specs))
        model_t = _port(tree, config)
        ttx = TO.make_optimizer(cfg(batch_size=BATCH), phase, 4, model_t)
        state = TrainState.create(model_t, ttx)
        state, _, logs = TS.make_supervised_step(model_t, phase, ttx)(
            state, batch, TS.init_metric_states(model_t.head_specs, "cpu"))
        np.testing.assert_allclose(logs["loss_pred"].item(), float(jlogs["loss_pred"]),
                                   rtol=LOSS_RTOL, err_msg=phase)
        _assert_params_match(model_t, jax.tree.map(np.asarray, jstate.params))


@pytest.mark.parametrize(("size_in", "size_out"), [(37, 16), (14, 32), (7, 5), (4, 11)])
def test_bicubic_matrix_and_pos_embed(size_in, size_out):
    """The bicubic matrix is the JAX package's, and ``F.interpolate(mode=
    "bicubic", align_corners=False)``; ``interpolate_pos_embed`` resizes the
    positions without the CLS token, as the JAX package's does."""
    mat = TR.bicubic_matrix_np(size_in, size_out)
    np.testing.assert_array_equal(mat, JR.bicubic_matrix_np(size_in, size_out))
    img = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, size_in, size_in))
                           .astype(np.float32))
    want = F.interpolate(img, size=(size_out, size_out), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(TR.resize_spatial(img, size_out, "bicubic").numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)
    pos = np.random.default_rng(1).normal(size=(1, size_in**2 + 1, 8)).astype(np.float32)
    got = TBB.interpolate_pos_embed(torch.from_numpy(pos), size_out, has_cls=True)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JBB.interpolate_pos_embed(jnp.asarray(pos), size_out, True)),
        rtol=1e-5, atol=1e-6)
    grid = torch.from_numpy(pos[:, 1:]).reshape(1, size_in, size_in, 8).permute(0, 3, 1, 2)
    want = F.interpolate(grid, size=(size_out, size_out), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got[0, 1:].numpy(),
                               want[0].permute(1, 2, 0).reshape(-1, 8).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0, 0].numpy(), pos[0, 0])


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_resize_token_grid_matches_jax(mode):
    x = np.random.default_rng(2).normal(size=(2, 3, 25, 6)).astype(np.float32)
    for grid in (4, 5, 7):
        np.testing.assert_allclose(
            TR.resize_token_grid(torch.from_numpy(x), grid, mode).numpy(),
            np.asarray(JR.resize_token_grid(jnp.asarray(x), grid, mode)),
            rtol=1e-5, atol=1e-6, err_msg=f"{mode} {grid}")


def test_vit_backbone_matches_jax():
    """The generic backbone (patch projection, CLS, resized learned
    positions, LayerScale blocks, final norm) at a grid other than its
    positions'."""
    jmod = JBB.ViTBackbone(dim=64, depth=2, heads=2, in_chans=3, patch_size=4, pos_grid=5,
                           layerscale=True, dtype=jnp.float32)
    x = np.random.default_rng(4).normal(size=(2, 3, 24, 24)).astype(np.float32)
    tree = randomized_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=5)
    want = jmod.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tmod = TBB.ViTBackbone(64, 2, 2, 3, 4, 5, torch.float32, torch.Generator().manual_seed(0),
                           "cpu", layerscale=True)
    load_jax_params(tmod, tree)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(("model", "fusion", "match"), [
    ("satmae", "mod", "S2"), ("prithvi", "mod", "S2"), ("satmae", "shared", "fusion_mode"),
    ("dinov2", "group", "shared/monotemp"), ("croma", "shared", "late-croma"),
    ("clip", "shared", "Unknown baseline"),
])
def test_refusals_match_jax(model, fusion, match):
    """Both packages refuse the same configurations with the same words:
    SatMAE and Prithvi on more than the S2 series, a fusion mode an adapter
    does not take, an unknown model."""
    jds, tds = (cls(name_dataset="pastis_hd") for cls in (JDatasetsConfig, DatasetsConfig))
    kw = {"model": model, "model_size": "micro", "fusion_mode": fusion}
    with pytest.raises(ValueError, match=match):
        j_build_baseline(jds, JBaselineConfig(**kw))
    with pytest.raises(ValueError, match=match):
        build_baseline(tds, BaselineConfig(**kw), device="cpu")
    assert model == "clip" or model in BASELINE_MODELS


def test_lw_decay_of_a_deep_dinov2(monkeypatch):
    """``lw_decay`` of a DINOv2 with 14 blocks (micro widths): every
    parameter's multiplier equals the JAX package's ``scale_by_lw_decay``
    (depth 12, as its runtime builds it), blocks past 12 included, and the
    optimizer groups the parameters by it."""
    monkeypatch.setitem(JDINO.DINOV2_ARCHS, "micro", (64, 14, 2))
    monkeypatch.setitem(TDINO.DINOV2_ARCHS, "micro", (64, 14, 2))
    jds, tds = _datasets("dinov2")
    cfg = {"model": "dinov2", "model_size": "micro", "fusion_mode": "shared"}
    jmodel = j_build_baseline(jds, JBaselineConfig(**cfg), dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in make_synthetic_batch(jds.dataset, 1).items()}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), batch, "finetune"))
    ones = jax.tree.map(lambda s: jnp.ones(s.shape, s.dtype), shapes)
    rate = 0.75
    scaled, _ = JO.scale_by_lw_decay(rate, 12).update(ones, None)
    want = {tuple(str(k.key) for k in path): float(np.asarray(v).flat[0])
            for path, v in jax.tree_util.tree_flatten_with_path(scaled["params"])[0]}
    model = build_baseline(tds, BaselineConfig(**cfg), torch.float32, device="cpu")
    ttx = TO.make_optimizer(OptFinetuneConfig(lw_decay=rate), "finetune", 4, model)
    group_of = {id(p): g["lr_mult"] for g in ttx.adamw.param_groups for p in g["params"]}
    seen = set()
    for name, p in model.named_parameters():
        path, _ = flax_path(model, name)
        mult = TO.lw_decay_multiplier(name, rate)
        assert mult == pytest.approx(want[path], rel=1e-6), name
        assert group_of[id(p)] == mult, name
        seen.add(round(np.log(mult) / np.log(rate)))
    assert {-1, 0, 12, 13} <= seen  # block13, block12, block0, the patch projections


def test_dinov2_huge_is_past_both_kernels():
    """DINOv2 ``huge`` (1280 wide, 16 heads x 80) is refused by name by the
    attention and pool kernels' shape checks (the plain versions run it on
    the CPU); its seg-head pool is routed to the kernel, which refuses, and
    never falls back to the plain version.  ``large`` passes both."""
    dim, _, heads = TDINO.DINOV2_ARCHS["huge"]
    with pytest.raises(ValueError, match="head dim 80 is not supported by the attention kernels"):
        attention.check_kernel_shape(torch.empty((8, 1025, heads, dim // heads), device="meta"))
    with pytest.raises(ValueError, match="attentive_pool_fwd is built for head dims"):
        attn_pool._check_kernel_shape(dim, 8, "attentive_pool_fwd")
    reduce = AttentiveReduce(dim, 8, torch.bfloat16, torch.Generator().manual_seed(0), "meta")
    assert reduce._use_fused_pool(torch.empty((8, 5, 64, dim), device="meta"))
    dim, _, heads = TDINO.DINOV2_ARCHS["large"]
    attention.check_kernel_shape(torch.empty((8, 1025, heads, dim // heads), device="meta"))
    attn_pool._check_kernel_shape(dim, 8, "attentive_pool_fwd")
