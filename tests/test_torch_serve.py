"""The first slice of the port as a whole: finetune-phase predict and the
embedding function of ``maestro_tpu_torch.serve`` against the JAX package's,
with weights carried over by ``port.from_jax.load_jax_params``.

Set-up as tests/test_serve.py: the test-only ``micro`` size, group fusion,
one shared trunk block; TreeSatAI (classification) and PASTIS-HD
(segmentation).  One JAX model per dataset and dtype is built per module.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.conf import MaskConfig as JMaskConfig
from maestro_tpu.conf import ModelConfig as JModelConfig
from maestro_tpu.models.mae import build_model as jax_build_model
from maestro_tpu.serve import make_embed_fn as jax_make_embed_fn
from maestro_tpu.serve import make_predict_fn as jax_make_predict_fn
from maestro_tpu.utils.testing import make_synthetic_batch
from maestro_tpu_torch.conf import (
    DatasetsConfig,
    ExperimentConfig,
    MaskConfig,
    ModelConfig,
)
from maestro_tpu_torch.models.factory import build_experiment_model
from maestro_tpu_torch.models.mae import build_model
from maestro_tpu_torch.port.from_jax import load_jax_params
from maestro_tpu_torch.serve import make_embed_fn, make_predict_fn, serving_params

from _torch_port_utils import randomized_tree, single_thread_torch, synthetic_tree, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

FP32_TOL = dict(rtol=1e-4, atol=1e-4)  # observed max abs err 2.4e-6
# bf16 logits of magnitude ~4: observed max abs err 0.031 (2 bf16 ulps), x10
BF16_TOL = dict(rtol=0.0, atol=0.31)
# a finetune-phase flax init creates no pretrain-only parameters
PRETRAIN_ONLY = ("decoders.", "pixelify.", "enc_to_dec.")
BATCH = 2


# the other fusion modes (and trunk depths) than the group / 1 of every other test
FUSION_MODES = [("shared", 0), ("monotemp", 0), ("mod", 0), ("mod", 1), ("group", 0)]
FUSION_IDS = ["shared", "monotemp", "mod0", "mod1", "group0"]


def _micro_cfg(cls, mode: str = "group", inter_depth: int = 1):
    return cls(model_size="micro", fusion_mode=mode, inter_depth=inter_depth)


def _pair(name: str, dtype: str, mode: str = "group", inter_depth: int = 1):
    """JAX model + perturbed numpy params + the port's model holding them."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jds = JDatasetsConfig(name_dataset=name)
    jmodel, _ = jax_build_model(jds, JMaskConfig(), _micro_cfg(JModelConfig, mode, inter_depth),
                                dtype=jdt)
    batch = make_synthetic_batch(jds.dataset, BATCH)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    params = jax.jit(
        lambda b: jmodel.init({"params": key, "mask": key}, b, "finetune"),
    )(jbatch)
    tree = randomized_tree(params, seed=1)
    model, _ = build_model(
        DatasetsConfig(name_dataset=name), MaskConfig(), _micro_cfg(ModelConfig, mode, inter_depth),
        dtype=tdt, device="cpu",
    )
    load_jax_params(model, tree, missing_ok=PRETRAIN_ONLY)
    return jmodel, tree, jbatch, model, batch


@pytest.fixture(scope="module")
def treesat():
    return _pair("treesatai_ts", "float32")


@pytest.fixture(scope="module")
def pastis():
    return _pair("pastis_hd", "float32")


@pytest.mark.parametrize("fixture_name", ["treesat", "pastis"])
def test_finetune_predict_matches_jax(request, fixture_name):
    jmodel, tree, jbatch, model, batch = request.getfixturevalue(fixture_name)
    want = jax_make_predict_fn(jmodel, "finetune")(tree, jbatch)
    got = make_predict_fn(model, "finetune")(batch)
    assert set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_allclose(to_np(got[name]), to_np(want[name]), **FP32_TOL)


@pytest.mark.parametrize(("mode", "inter_depth"), FUSION_MODES, ids=FUSION_IDS)
@pytest.mark.parametrize("dataset", ["treesatai_ts", "pastis_hd"])
def test_fusion_modes_predict_match_jax(dataset, mode, inter_depth):
    """Finetune-phase predict in the fusion modes other than group with one
    trunk block."""
    jds = JDatasetsConfig(name_dataset=dataset)
    jmodel, _ = jax_build_model(jds, JMaskConfig(), _micro_cfg(JModelConfig, mode, inter_depth),
                                dtype=jnp.float32)
    model, _ = build_model(DatasetsConfig(name_dataset=dataset), MaskConfig(),
                           _micro_cfg(ModelConfig, mode, inter_depth), dtype=torch.float32,
                           device="cpu")
    tree = synthetic_tree(model, seed=2, skip=PRETRAIN_ONLY)  # no JAX init to trace
    load_jax_params(model, tree, missing_ok=PRETRAIN_ONLY)
    batch = make_synthetic_batch(jds.dataset, BATCH)
    want = jax_make_predict_fn(jmodel, "finetune")(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_predict_fn(model, "finetune")(batch)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(to_np(got[name]), to_np(want[name]), **FP32_TOL)


def test_segmentation_logits_shape(pastis):
    *_, model, batch = pastis
    logits = make_predict_fn(model)(batch)["pastis_seg"]
    assert logits.shape == (BATCH, 1, 19, 16, 16)
    assert torch.isfinite(logits).all()
    assert not logits.requires_grad  # inference mode


def test_probe_predict_equals_finetune_predict(treesat):
    """Forward values do not depend on the supervised phase (probe only
    detaches the features)."""
    *_, model, batch = treesat
    a = make_predict_fn(model, "probe")(batch)
    b = make_predict_fn(model, "finetune")(batch)
    for name in a:
        assert torch.equal(a[name], b[name])


def test_predict_accepts_tensors_and_numpy(treesat):
    *_, model, batch = treesat
    fn = make_predict_fn(model)
    as_tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    for name, value in fn(batch).items():
        assert torch.equal(value, fn(as_tensors)[name])


def test_bf16_predict_matches_jax():
    jmodel, tree, jbatch, model, batch = _pair("pastis_hd", "bfloat16")
    want = jax_make_predict_fn(jmodel, "finetune")(tree, jbatch)["pastis_seg"]
    got = make_predict_fn(model, "finetune")(batch)["pastis_seg"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), **BF16_TOL)


def test_embed_fn_matches_jax(treesat):
    jmodel, tree, jbatch, model, batch = treesat
    want = jax_make_embed_fn(jmodel)(tree, jbatch)
    got = make_embed_fn(model)(batch)
    dim = model.arch.embed_dim
    assert set(got) == set(want)
    for name in model.plan.mods:
        assert got[name].shape == (BATCH, dim)
    assert got["joint"].shape == (BATCH, dim * len(model.plan.mods))
    for name in want:
        np.testing.assert_allclose(to_np(got[name]), to_np(want[name]), **FP32_TOL)


def test_predict_rejects_other_phases_and_models(treesat):
    *_, model, batch = treesat
    with pytest.raises(ValueError, match="probe|finetune"):
        make_predict_fn(model, "pretrain")
    with pytest.raises(TypeError, match="MaestroMAE"):
        make_embed_fn(torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="generator"):  # pretrain draws masks
        model({k: torch.from_numpy(v) for k, v in batch.items()}, "pretrain")


def test_bridge_is_strict(treesat):
    _, tree, _, model, _ = treesat
    inner = dict(tree["params"])
    load_jax_params(model, inner, missing_ok=PRETRAIN_ONLY)  # bare inner dict is accepted
    with pytest.raises(KeyError, match="unfilled.*decoders.aerial"):
        load_jax_params(model, tree)  # decoders etc. are not excused
    dropped = {k: v for k, v in inner.items() if k != "encoder_inter"}
    with pytest.raises(KeyError, match="encoder_inter.block0.attn.qkv.weight"):
        load_jax_params(model, dropped, missing_ok=PRETRAIN_ONLY)
    extra = dict(inner, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray/kernel"):
        load_jax_params(model, extra, missing_ok=PRETRAIN_ONLY)
    wrong = dict(inner, encoder_inter={**inner["encoder_inter"],
                                       "norm": {"scale": np.zeros(3, np.float32),
                                                "bias": np.zeros(64, np.float32)}})
    with pytest.raises(KeyError, match="shape mismatches.*encoder_inter/norm/scale"):
        load_jax_params(model, wrong, missing_ok=PRETRAIN_ONLY)


def test_bridge_transposes_dense_kernels(treesat):
    _, tree, _, model, _ = treesat
    kernel = tree["params"]["encoders_s2"]["block0"]["mlp"]["fc1"]["kernel"]
    weight = model.encoders["s2"].block0.mlp.fc1.weight
    assert kernel.shape == (64, 128) and weight.shape == (128, 64)
    np.testing.assert_array_equal(to_np(weight), kernel.T)
    token = tree["params"]["mask_token_s1_asc"]
    np.testing.assert_array_equal(to_np(model.mask_tokens["s1_asc"]), token)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = DatasetsConfig(name_dataset="treesatai_ts")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ds, MaskConfig(), _micro_cfg(ModelConfig))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_experiment_model(ds, ExperimentConfig(model=_micro_cfg(ModelConfig)))


def test_factory_builds_the_mae_and_refuses_baselines():
    """The factory builds the MAE; a baseline adapter is refused the MAE's
    group fusion and builds with a fusion mode of its own."""
    ds = DatasetsConfig(name_dataset="treesatai_ts")
    cfg = ExperimentConfig(model=_micro_cfg(ModelConfig))
    cfg.trainer.compute_dtype = "float32"
    model, plan, is_baseline = build_experiment_model(ds, cfg, device="cpu")
    assert not is_baseline and model.dtype == torch.float32 and plan is model.plan
    # a baseline adapter refuses the MAE's group fusion, and builds with its own
    cfg.model.model = "dinov2"
    with pytest.raises(ValueError, match="DINOv2 supports shared/monotemp"):
        build_experiment_model(ds, cfg, device="cpu")
    cfg.model.fusion_mode = "shared"
    model, plan, is_baseline = build_experiment_model(
        DatasetsConfig(name_dataset="pastis_hd"), cfg, device="cpu")
    assert is_baseline and model.dtype == torch.float32 and plan is model.plan


def test_head_split_override_keeps_parameter_shapes():
    """The reference's 64-dim encoder heads: same parameter shapes, another
    attention split; a split that changes the inner width is refused."""
    ds = DatasetsConfig(name_dataset="treesatai_ts")
    base, _ = build_model(ds, MaskConfig(), _micro_cfg(ModelConfig), device="cpu")
    cfg = _micro_cfg(ModelConfig)
    cfg.encoder_heads, cfg.encoder_dim_head = 1, 64
    split, _ = build_model(ds, MaskConfig(), cfg, device="cpu")
    assert (split.arch.heads, split.arch.dim_head) == (1, 64)
    assert {k: v.shape for k, v in split.state_dict().items()} == {
        k: v.shape for k, v in base.state_dict().items()}
    cfg.encoder_dim_head = 48
    with pytest.raises(ValueError, match="inner width"):
        build_model(ds, MaskConfig(), cfg, device="cpu")


def test_serving_params_prefers_ema():
    p = {"params": {"w": 1}}
    e = {"params": {"w": 2}}
    assert serving_params({"params": p, "ema_params": e}) == e
    assert serving_params({"params": p}) == p
    assert serving_params({"params": {"w": 1}}) == {"params": {"w": 1}}
    with pytest.raises(ValueError):
        serving_params({})


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """In a fresh interpreter, importing every module of the port pulls in
    neither jax/flax/optax/orbax nor maestro_tpu — and needs no GPU."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import maestro_tpu_torch\n"
        "for m in pkgutil.walk_packages(maestro_tpu_torch.__path__, 'maestro_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'maestro_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'maestro_tpu_torch.serve' in sys.modules\n"
    )
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
