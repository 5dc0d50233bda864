"""Slice 3 of the port as a whole: the probe and finetune train steps of
``maestro_tpu_torch`` (prediction losses, AdamW + OneCycle with layer-wise LR
decay and gradient accumulation, metric states, EMA, the eval / feature /
head-eval steps) against the JAX package's ``train/steps.py``.

Both packages hold the same weights (a synthetic flax parameter tree carried
over by ``port.from_jax.load_jax_params``) and read the same batch.  The JAX
side runs jitted.  Set-up as tests/test_torch_train.py: the test-only
``micro`` size, group fusion, one shared trunk block, TreeSatAI (multilabel,
attentive classification head) and PASTIS-HD (segmentation,
``ChunkedSegHead``), batch 2; every test builds what it compares.  ``micro``
(E = 64) misses the fused pool's gate (E % 128 == 0), so one test widens it to
128 in both packages and runs the JAX pool in interpret mode.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import maestro_tpu.models.mae as JM
from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.conf import MaskConfig as JMaskConfig
from maestro_tpu.conf import ModelConfig as JModelConfig
from maestro_tpu.conf import OptFinetuneConfig as JOptFinetuneConfig
from maestro_tpu.conf import OptProbeConfig as JOptProbeConfig
from maestro_tpu.ops import attn_pool as JP
from maestro_tpu.specs.fusion import build_fusion_plan as j_build_fusion_plan
from maestro_tpu.train import metrics as JMetrics
from maestro_tpu.train import optim as JO
from maestro_tpu.train import state as JS
from maestro_tpu.train import steps as JSteps
from maestro_tpu.train.losses import prediction_losses as j_prediction_losses
from maestro_tpu.utils import flops as JF
from maestro_tpu.utils.testing import make_synthetic_batch
from maestro_tpu_torch.conf import (
    DatasetsConfig,
    MaskConfig,
    ModelConfig,
    OptFinetuneConfig,
    OptProbeConfig,
)
from maestro_tpu_torch.models import heads as TH
from maestro_tpu_torch.models import mae as TM
from maestro_tpu_torch.models.mae import HeadSpec, build_model
from maestro_tpu_torch.port.from_jax import flax_names, load_jax_params
from maestro_tpu_torch.specs.fusion import build_fusion_plan
from maestro_tpu_torch.train import optim as TO
from maestro_tpu_torch.train import steps as TS
from maestro_tpu_torch.train.losses import prediction_losses
from maestro_tpu_torch.train.state import TrainState, ema_momentum, ema_update
from maestro_tpu_torch.utils import flops as TF

from _torch_port_utils import randomized_tree, single_thread_torch, synthetic_tree, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

BATCH = 2
LOSS_RTOL = 1e-5  # fp32 prediction loss; observed rel err ~1e-7
GRAD_TOL = 1e-4  # of each leaf's max |grad|; observed ~1e-6
TRAJ_RTOL = 1e-4  # loss trajectory
TOTAL, BASE_LR = 4, 1e-2  # a short schedule and a large rate: the steps move the loss
DATASETS = {"treesat": "treesatai_ts", "pastis": "pastis_hd"}
OPT = {"probe": (OptProbeConfig, JOptProbeConfig),
       "finetune": (OptFinetuneConfig, JOptFinetuneConfig)}


# the other fusion modes (and trunk depths) than the group / 1 of every other test
FUSION_MODES = [("shared", 0), ("monotemp", 0), ("mod", 0), ("mod", 1), ("group", 0)]
FUSION_IDS = ["shared", "monotemp", "mod0", "mod1", "group0"]


def _cfg(cls, size="micro", chunk=2, mode="group", inter_depth=1):
    return cls(model_size=size, fusion_mode=mode, inter_depth=inter_depth, seg_chunk_rows=chunk)


def _pair(name: str, size: str = "micro", chunk: int = 2, mode: str = "group",
          inter_depth: int = 1):
    """JAX model + synthetic numpy params (heads included) + the port's model
    holding them, and one batch (numpy) with its labels."""
    jds = JDatasetsConfig(name_dataset=name)
    jmodel, _ = JM.build_model(jds, JMaskConfig(),
                               _cfg(JModelConfig, size, chunk, mode, inter_depth),
                               dtype=jnp.float32)
    batch = make_synthetic_batch(jds.dataset, BATCH, seed=3)
    model, _ = build_model(DatasetsConfig(name_dataset=name), MaskConfig(),
                           _cfg(ModelConfig, size, chunk, mode, inter_depth),
                           dtype=torch.float32, device="cpu")
    tree = synthetic_tree(model, seed=1)
    load_jax_params(model, tree)
    return jmodel, tree, batch, model


def _jax_grad_fn(jmodel, phase):
    def loss_fn(params, batch):
        return j_prediction_losses(jmodel.head_specs, batch, jmodel.apply(params, batch, phase))

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _assert_grads_match(model, want_grads) -> None:
    """Every gradient leaf within GRAD_TOL of that leaf's max |grad|; a
    parameter autograd left without a gradient must have a zero JAX one."""
    params, names = dict(model.named_parameters()), flax_names(model)
    compared = 0
    for path, g in jax.tree_util.tree_flatten_with_path(want_grads["params"])[0]:
        name, transpose = names[tuple(str(k.key) for k in path)]
        want = np.asarray(g, np.float32)
        want = want.T if transpose else want
        got = params[name].grad
        got = np.zeros_like(want) if got is None else to_np(got)
        limit = GRAD_TOL * np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= limit, f"{name}: max abs err {err:.3e} > {limit:.3e}"
        compared += 1
    assert compared == len(params)


def _assert_metric_states_equal(head_specs, got: dict, want: dict) -> None:
    for hs in head_specs:
        if hs.type_target == "multilabel_classif":
            for key in ("cm", "hist"):
                np.testing.assert_array_equal(got[hs.name][key].numpy(), np.asarray(want[hs.name][key]))
        else:
            np.testing.assert_array_equal(got[hs.name]["cm"].numpy(),
                                          JMetrics.monolabel_cm(want[hs.name]))
    assert int(sum(s.sum() for st in got.values() for s in st.values())) > 0


def _frozen_snapshot(model, phase: str) -> dict[str, torch.Tensor]:
    frozen = {"probe": ("backbone", "decoder"), "finetune": ("decoder",)}[phase]
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if TO.param_role(n) in frozen}


# (phase, dataset, lw_decay, accumulate_grad_batches, micro-steps)
TRAJECTORIES = [
    ("probe", "treesat", None, 1, 3),
    ("probe", "pastis", None, 1, 3),
    ("finetune", "treesat", None, 1, 3),
    ("finetune", "pastis", None, 1, 3),
    ("finetune", "treesat", 0.75, 1, 3),  # layer-wise LR decay
    ("finetune", "pastis", None, 2, 6),  # optax.MultiSteps: 3 updates
]


@pytest.mark.parametrize(("phase", "dataset", "lw_decay", "accumulate", "steps"), TRAJECTORIES)
def test_supervised_steps_match_jax(phase, dataset, lw_decay, accumulate, steps):
    """The loss of every step, every gradient leaf of the first (without
    accumulation), the metric states after the steps, and the frozen roles
    bit-identical: probe leaves the backbone, finetune the decoder side."""
    jmodel, tree, batch, model = _pair(DATASETS[dataset])
    cfg, jcfg = OPT[phase]
    kw = dict(base_lr=BASE_LR, batch_size=BATCH, accumulate_grad_batches=accumulate)
    if lw_decay is not None:
        kw["lw_decay"] = lw_decay
    tx = JO.make_optimizer(jcfg(**kw), phase, TOTAL, tree, lw_decay=lw_decay)
    grad_fn = _jax_grad_fn(jmodel, phase)

    @jax.jit
    def apply_update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics = JSteps.init_metric_states(jmodel.head_specs)
    want = []
    for i in range(steps):
        (loss, aux), grads = grad_fn(params, jbatch)
        jmetrics = {hs.name: JMetrics.metric_update(hs.type_target, jmetrics[hs.name], aux[hs.name])
                    for hs in jmodel.head_specs}
        params, opt_state = apply_update(grads, opt_state, params)
        want.append(float(loss))
        if i == 0:
            first_grads = grads

    ttx = TO.make_optimizer(cfg(**kw), phase, TOTAL, model)
    if lw_decay is not None:
        assert len(ttx.adamw.param_groups) > 2  # blocks, embeds and the rest
    state = TrainState.create(model, ttx)
    step_fn = TS.make_supervised_step(model, phase, ttx)
    metrics = TS.init_metric_states(model.head_specs, "cpu")
    frozen = _frozen_snapshot(model, phase)
    got = []
    for i in range(steps):
        state, metrics, logs = step_fn(state, batch, metrics)
        got.append(logs["loss_pred"].item())
        if i == 0 and accumulate == 1:  # the step leaves its gradients on the parameters
            np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
            _assert_grads_match(model, first_grads)
    assert state.step == steps and ttx.n_updates == steps // accumulate
    assert abs(want[-1] - want[0]) > 10 * TRAJ_RTOL * abs(want[0])  # the steps mattered
    if accumulate > 1:  # no update inside an accumulation window
        assert got[0] == got[1] and want[0] == want[1]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    _assert_metric_states_equal(model.head_specs, metrics, jmetrics)
    params_now = dict(model.named_parameters())
    assert frozen and all(torch.equal(params_now[n], p) for n, p in frozen.items())


@pytest.mark.parametrize(("mode", "inter_depth"), FUSION_MODES, ids=FUSION_IDS)
@pytest.mark.parametrize("dataset", ["treesat", "pastis"])
def test_fusion_modes_finetune_loss_and_grads_match_jax(dataset, mode, inter_depth):
    """The finetune loss and every gradient leaf in the fusion modes other
    than group with one trunk block (the heads read the streams each mode
    regroups)."""
    jmodel, tree, batch, model = _pair(DATASETS[dataset], mode=mode, inter_depth=inter_depth)
    (want_loss, _), want_grads = _jax_grad_fn(jmodel, "finetune")(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    device_batch = TS.batch_to_device(model, batch, torch.device("cpu"), targets=True)
    loss, _ = prediction_losses(model.head_specs, device_batch, model(device_batch, "finetune"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    _assert_grads_match(model, want_grads)


def test_finetune_step_through_the_fused_pool(monkeypatch):
    """One finetune step's loss and every gradient with the seg head's date
    pool on the fused path: ``micro`` widened to E = 128 in both packages,
    PASTIS-HD with 4 ref rows a chunk (32 positions, 25 dates), the JAX pool
    in interpret mode; each of the port's two chunks goes through the pool
    Function that recomputes the chunk in the backward."""
    monkeypatch.setattr(JP, "INTERPRET", True)
    for archs in (JM.MAE_ARCHS, TM.MAE_ARCHS):
        monkeypatch.setitem(archs, "micro128",
                            dataclasses.replace(archs["micro"], embed_dim=128, dim_head=64))
    jmodel, tree, batch, model = _pair("pastis_hd", "micro128", chunk=4)
    reduce = model.heads["pastis_seg"].reduce
    calls = []
    monkeypatch.setattr(TH._RecomputedChunkPool, "apply", staticmethod(
        lambda *a, f=TH._RecomputedChunkPool.apply: calls.append(1) or f(*a)))
    (want_loss, _), want_grads = _jax_grad_fn(jmodel, "finetune")(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    tx = TO.make_optimizer(OptFinetuneConfig(), "finetune", TOTAL, model)
    step_fn = TS.make_supervised_step(model, "finetune", tx)
    _, _, logs = step_fn(TrainState.create(model, tx), batch, TS.init_metric_states(model.head_specs, "cpu"))
    assert len(calls) == 2  # 8 ref rows / 4 a chunk, each through the Function
    assert reduce._use_fused_pool(torch.zeros(BATCH, 25, 32, 128))
    np.testing.assert_allclose(logs["loss_pred"].item(), float(want_loss), rtol=LOSS_RTOL)
    _assert_grads_match(model, want_grads)
    assert reduce.to_kv.weight.grad.abs().max() > 0 and reduce.query.grad.abs().max() > 0


def test_ema_and_eval_steps_match_jax(monkeypatch):
    """``ema_update`` / ``ema_momentum`` against JAX; the finetune eval step
    reads the EMA weights (logits, loss and metric states equal the JAX eval
    step's with the same EMA tree, the trained weights untouched); the
    head-eval step on the feature step's output equals the full eval step."""
    jmodel, tree, batch, model = _pair("treesatai_ts")
    ema_tree = randomized_tree(tree, seed=9)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    assert ema_momentum(20) == pytest.approx(JS.ema_momentum(20), rel=1e-12)

    ema_model, _ = build_model(DatasetsConfig(name_dataset="treesatai_ts"), MaskConfig(),
                               _cfg(ModelConfig), dtype=torch.float32, device="cpu")
    load_jax_params(ema_model, ema_tree)
    state = TrainState(step=0, model=model, tx=None,
                       ema={n: p.detach().clone() for n, p in ema_model.named_parameters()})
    jstate = JS.TrainState(step=jnp.zeros((), jnp.int32), params=tree, opt_state=None,
                           ema_params=ema_tree)
    # the EMA update, through the packages' own functions
    new_j = JS.ema_update(jstate, 0.8).ema_params
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ema_update(state, 0.8)
    names = flax_names(model)
    for path, want in jax.tree_util.tree_flatten_with_path(new_j["params"])[0]:
        name, transpose = names[tuple(str(k.key) for k in path)]
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(state.ema[name]), want.T if transpose else want,
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    jstate = jstate.replace(ema_params=new_j)

    jmetrics, jlogs = JSteps.make_supervised_eval_step(jmodel, "finetune", use_ema=True)(
        jstate, jbatch, JSteps.init_metric_states(jmodel.head_specs))
    seen = []  # the logits the eval step computes
    losses_fn = TS.prediction_losses
    monkeypatch.setattr(TS, "prediction_losses",
                        lambda specs, b, logits, *rest: seen.append(logits)
                        or losses_fn(specs, b, logits, *rest))
    metrics, logs = TS.make_supervised_eval_step(model, "finetune", use_ema=True)(
        state, batch, TS.init_metric_states(model.head_specs, "cpu"))
    want_logits = jax.jit(lambda p, b: jmodel.apply(p, b, "finetune"))(new_j, jbatch)
    for name, want in want_logits.items():
        np.testing.assert_allclose(to_np(seen[0][name]), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logs["loss_pred"].item(), float(jlogs["loss_pred"]), rtol=LOSS_RTOL)
    _assert_metric_states_equal(model.head_specs, metrics, jmetrics)
    want_trained = JSteps.make_supervised_eval_step(jmodel, "finetune")(
        jstate, jbatch, JSteps.init_metric_states(jmodel.head_specs))[1]["loss_pred"]
    assert abs(float(want_trained) - logs["loss_pred"].item()) > 1e-3  # EMA != trained weights
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())

    # features of the trained trunk: the head-eval step serves a frozen trunk
    # (probe), whose EMA would equal its weights
    encoded = TS.make_feature_step(model)(batch)
    labels = {hs.name: batch[hs.name] for hs in model.head_specs}
    for phase in ("probe", "finetune"):
        full = TS.make_supervised_eval_step(model, phase)(
            state, batch, TS.init_metric_states(model.head_specs, "cpu"))
        heads = TS.make_head_eval_step(model, phase)(
            state, encoded, labels, TS.init_metric_states(model.head_specs, "cpu"))
        assert heads[1]["loss_pred"].item() == pytest.approx(full[1]["loss_pred"].item(), rel=1e-6)
        for hs in model.head_specs:
            for key, value in heads[0][hs.name].items():
                assert torch.equal(value, full[0][hs.name][key])
    got_values = TS.compute_metrics(model.head_specs, metrics)
    for name, values in JSteps.compute_metrics(jmodel.head_specs, jmetrics).items():
        assert got_values[name] == pytest.approx(values, rel=1e-6)


def _loss_inputs(seed: int, all_missing: bool = False):
    """Logits and labels of the three target types, with missing rows."""
    rng = np.random.default_rng(seed)
    specs = (("seg", "segment", 5, 255), ("ml", "multilabel_classif", 4, -1),
             ("cls", "classif", 6, -1))
    logits = {"seg": rng.normal(size=(3, 1, 5, 4, 4)), "ml": rng.normal(size=(3, 4)),
              "cls": rng.normal(size=(3, 6))}
    labels = {"seg": rng.integers(0, 5, (3, 1, 1, 4, 4)),
              "ml": (rng.random((3, 4)) > 0.5).astype(np.int64),
              "cls": rng.integers(0, 6, (3,))}
    labels["seg"][0, 0, 0, :2] = 255
    labels["ml"][1, 2] = -1
    labels["cls"][2] = -1
    if all_missing:
        labels = {"seg": np.full_like(labels["seg"], 255), "ml": np.full_like(labels["ml"], -1),
                  "cls": np.full_like(labels["cls"], -1)}
    logits = {k: v.astype(np.float32) for k, v in logits.items()}
    labels = {k: v.astype(np.int32) for k, v in labels.items()}
    return specs, logits, labels


@pytest.mark.parametrize("all_missing", [False, True])
def test_prediction_losses_match_jax(all_missing):
    """Segment CE over the class axis, multilabel BCE and classif CE with
    ``missing_val`` rows masked; an all-missing batch gives a zero loss with
    finite (zero) gradients."""
    specs, logits, labels = _loss_inputs(80, all_missing)
    jspecs = tuple(JM.HeadSpec(*s) for s in specs)
    tspecs = tuple(HeadSpec(*s) for s in specs)
    (want, jaux), want_g = jax.value_and_grad(
        lambda lg: j_prediction_losses(jspecs, {k: jnp.asarray(v) for k, v in labels.items()}, lg),
        has_aux=True)({k: jnp.asarray(v) for k, v in logits.items()})
    tlogits = {k: torch.from_numpy(v).requires_grad_(True) for k, v in logits.items()}
    got, aux = prediction_losses(tspecs, {k: torch.from_numpy(v) for k, v in labels.items()},
                                 tlogits)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    for k in logits:
        g = to_np(tlogits[k].grad)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(want_g[k]), rtol=1e-5, atol=1e-7)
        for key, value in jaux[k].items():
            np.testing.assert_array_equal(aux[k][key].detach().numpy(), np.asarray(value))
    if all_missing:
        assert got.item() == 0.0 and all(not t.grad.any() for t in tlogits.values())


def test_accumulation_and_lw_decay_match_optax():
    """``ScheduledAdamW`` against the JAX package's optimizer on fixed
    gradients, parameter by parameter: ``optax.MultiSteps`` over 2
    micro-steps (mean gradient, an update every 2nd, the schedule counting
    updates) with ``scale_by_lw_decay``, over 6 micro-steps."""
    names = ("encoders.s2.block0.attn.qkv.weight", "encoder_inter.block1.mlp.fc1.bias",
             "patch_embed.s2.proj0.weight", "heads.t.linear.weight", "decoders.s2.norm.bias")
    jnames = (("encoders_s2", "block0", "attn", "qkv", "kernel"),
              ("encoder_inter", "block1", "mlp", "fc1", "bias"),
              ("patch_embed_s2", "proj0", "kernel"), ("heads_t", "linear", "kernel"),
              ("decoders_s2", "norm", "bias"))
    rng = np.random.default_rng(90)
    values = [rng.normal(size=(3, 2)).astype(np.float32) for _ in names]
    grads = [[rng.normal(size=(3, 2)).astype(np.float32) for _ in names] for _ in range(6)]

    def nest(leaves):
        tree: dict = {}
        for path, leaf in zip(jnames, leaves):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = jnp.asarray(leaf)
        return {"params": tree}

    module = torch.nn.Module()
    for name, value in zip(names, values):
        owner = module
        *path, leaf = name.split(".")
        for key in path:
            if not hasattr(owner, key):
                owner.add_module(key, torch.nn.Module())
            owner = getattr(owner, key)
        owner.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(value.copy())))
    kw = dict(base_lr=0.05, batch_size=4, accumulate_grad_batches=2, lw_decay=0.5)
    jtx = JO.make_optimizer(JOptFinetuneConfig(**kw), "finetune", 4, nest(values), lw_decay=0.5)
    jparams = nest(values)
    jstate = jtx.init(jparams)
    tx = TO.make_optimizer(OptFinetuneConfig(**kw), "finetune", 4, module)
    params = dict(module.named_parameters())
    for step_grads in grads:
        updates, jstate = jtx.update(nest(step_grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in zip(names, step_grads):
            params[name].grad = torch.from_numpy(g.copy())
        tx.step()
        for name, path in zip(names, jnames):
            want = jparams["params"]
            for key in path:
                want = want[key]
            np.testing.assert_allclose(to_np(params[name]), np.asarray(want), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    assert tx.n_updates == 3
    assert not np.array_equal(to_np(params[names[0]]), values[0])
    np.testing.assert_array_equal(to_np(params[names[4]]), values[4])  # decoder: frozen
    assert TO.lw_decay_multiplier(names[0], 0.5) == 0.5**12
    assert TO.lw_decay_multiplier(names[1], 0.5) == 0.5**11
    assert TO.lw_decay_multiplier(names[2], 0.5) == 0.5**13
    assert TO.lw_decay_multiplier(names[3], 0.5) == 1.0


def _adam_moments(opt_state) -> dict[tuple[str, ...], tuple]:
    """``(mu, nu)`` of every parameter an optax state's AdamW states hold, by
    path (the frozen roles' masked leaves have none)."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    moments = {}
    for st in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam):
        if is_adam(st):
            for (path, mu), nu in zip(jax.tree_util.tree_flatten_with_path(st.mu)[0],
                                      jax.tree_util.tree_leaves(st.nu)):
                moments[tuple(str(k.key) for k in path)[1:]] = (mu, nu)
    return moments


def test_skip_nonfinite_is_refused():
    """With ``skip_nonfinite`` a micro-step whose gradients hold a NaN is
    refused as ``optax.apply_if_finite`` (outermost, around ``MultiSteps``)
    refuses it: against the JAX package's optimizer so wrapped, at
    ``accumulate_grad_batches`` 1 and 2, every parameter and both AdamW
    moments after every micro-step, and the guard's counts.  The limit of
    consecutive refusals is lowered from 100 to 2 on both sides, so the third
    bad micro-step in a row is applied (NaN and all, as optax applies it).
    The supervised step refuses the pretrain phase."""
    names = ("encoders.s2.block0.attn.qkv.weight", "encoder_inter.block1.mlp.fc1.bias",
             "patch_embed.s2.proj0.weight", "heads.t.linear.weight", "decoders.s2.norm.bias")
    jnames = (("encoders_s2", "block0", "attn", "qkv", "kernel"),
              ("encoder_inter", "block1", "mlp", "fc1", "bias"),
              ("patch_embed_s2", "proj0", "kernel"), ("heads_t", "linear", "kernel"),
              ("decoders_s2", "norm", "bias"))
    limit = 2
    # 1: the micro-step's gradient of the second leaf holds a NaN
    bad = (0, 1, 0, 0, 1, 1, 1, 0, 0)
    rng = np.random.default_rng(91)
    values = [rng.normal(size=(3, 2)).astype(np.float32) for _ in names]
    grads = [[rng.normal(size=(3, 2)).astype(np.float32) for _ in names] for _ in bad]
    for step_grads, b in zip(grads, bad):
        if b:
            step_grads[1][1, 0] = np.nan

    def nest(leaves):
        tree: dict = {}
        for path, leaf in zip(jnames, leaves):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = jnp.asarray(leaf)
        return {"params": tree}

    def close(got, want, what):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=what)  # NaN where both are NaN

    for accumulate in (1, 2):
        module = torch.nn.Module()
        for name, value in zip(names, values):
            owner = module
            *path, leaf = name.split(".")
            for key in path:
                if not hasattr(owner, key):
                    owner.add_module(key, torch.nn.Module())
                owner = getattr(owner, key)
            owner.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(value.copy())))
        kw = dict(base_lr=0.05, batch_size=4, accumulate_grad_batches=accumulate, lw_decay=0.5)
        jtx = optax.apply_if_finite(
            JO.make_optimizer(JOptFinetuneConfig(**kw), "finetune", 4, nest(values), lw_decay=0.5),
            max_consecutive_errors=limit)
        jparams = nest(values)
        jstate = jtx.init(jparams)
        tx = TO.make_optimizer(OptFinetuneConfig(**kw), "finetune", 4, module,
                               skip_nonfinite=True)
        assert tx.skip_nonfinite and tx.max_consecutive_errors == 100
        tx.max_consecutive_errors = limit
        params = dict(module.named_parameters())
        for i, step_grads in enumerate(grads):
            updates, jstate = jtx.update(nest(step_grads), jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
            for name, g in zip(names, step_grads):
                params[name].grad = torch.from_numpy(g.copy())
            tx.step()
            moments = _adam_moments(jstate.inner_state)
            for name, path in zip(names, jnames):
                want = jparams["params"]
                for key in path:
                    want = want[key]
                what = f"accumulate {accumulate}, micro-step {i}: {name}"
                close(params[name], want, what)
                if path in moments:
                    st = tx.adamw.state[params[name]]
                    close(st["exp_avg"], moments[path][0], what + " exp_avg")
                    close(st["exp_avg_sq"], moments[path][1], what + " exp_avg_sq")
            guard = tx.guard
            assert int(guard.notfinite_count) == int(jstate.notfinite_count)
            assert int(guard.total_notfinite) == int(jstate.total_notfinite)
            assert bool(guard.last_finite) == bool(jstate.last_finite)
            assert len(moments) == 4  # the decoder side is frozen
        # the first refusal is dropped whole; the third in a row is applied
        assert int(guard.total_notfinite) == 4
        assert np.isnan(to_np(params[names[1]])).any()
        assert np.isfinite(to_np(params[names[0]])).all()
        np.testing.assert_array_equal(to_np(params[names[4]]), values[4])  # decoder: frozen

    model, _ = build_model(DatasetsConfig(name_dataset="treesatai_ts"), MaskConfig(),
                           _cfg(ModelConfig), device="cpu")
    with pytest.raises(ValueError, match="probe\\|finetune"):
        TS.make_supervised_step(model, "pretrain", TO.make_optimizer(
            OptFinetuneConfig(), "finetune", 10, model))


def test_init_metric_states_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = DatasetsConfig(name_dataset="treesatai_ts").dataset
    specs = TM.build_head_specs(ds, build_fusion_plan(ds, MaskConfig(), "group"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.init_metric_states(specs)
    states = TS.init_metric_states(specs, "cpu")
    assert all(t.device.type == "cpu" for s in states.values() for t in s.values())


def test_supervised_model_flops_match_jax():
    """The analytic count of the probe and finetune phases equals the JAX
    package's, for the FLAIR plan at the bench's batches and a small case."""
    for name, size in (("flair", "medium"), ("pastis_hd", "micro")):
        plan = build_fusion_plan(DatasetsConfig(name_dataset=name).dataset, MaskConfig(), "group")
        jplan = j_build_fusion_plan(JDatasetsConfig(name_dataset=name).dataset, JMaskConfig(),
                                    "group")
        tds, jds = DatasetsConfig(name_dataset=name).dataset, JDatasetsConfig(name_dataset=name).dataset
        specs = TM.build_head_specs(tds, plan)
        jspecs = JM.build_head_specs(jds, jplan)
        for phase, b in (("finetune", 32), ("probe", 48), ("probe", 1)):
            got = TF.mae_model_flops(plan, TM.MAE_ARCHS[size], 3, phase, b, specs, tds.ref_input)
            want = JF.mae_model_flops(jplan, JM.MAE_ARCHS[size], 3, phase, b, jspecs,
                                      jds.ref_input)
            assert got == want and got > 0
