"""Slice 2 of the port as a whole: the MAE pretrain forward, its gradients and
the AdamW + OneCycle train step of ``maestro_tpu_torch`` against the JAX
package's ``pretrain_loss_fn`` and ``make_optimizer``.

Both packages hold the same weights (a synthetic flax parameter tree carried
over by ``port.from_jax.load_jax_params``) and use the same masks: the JAX
package's own ``structural_mask`` / ``shuffle_mask`` (as seen from
``maestro_tpu.models.mae``) are wrapped to record what they draw, and the
port's ``ops.masking.draw_masks`` is replaced to replay it.  The JAX side runs
jitted (its first un-jitted call compiles op by op, about 100 s on the CPU);
the recording goes through ``jax.debug.callback``.  Set-up as
tests/test_torch_serve.py: the test-only ``micro`` size, group fusion, one
shared trunk block, TreeSatAI and PASTIS-HD, batch 2; every test builds what
it compares, so each stays cheap on any worker.
"""

from __future__ import annotations

from functools import partial

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
from maestro_tpu.conf import OptPretrainConfig as JOptPretrainConfig
from maestro_tpu.models.mae import MAE_ARCHS as J_ARCHS
from maestro_tpu.models.mae import build_model as jax_build_model
from maestro_tpu.specs.fusion import build_fusion_plan as j_build_fusion_plan
from maestro_tpu.train import optim as JO
from maestro_tpu.train import steps as JSteps
from maestro_tpu.train.steps import pretrain_loss_fn as jax_pretrain_loss_fn
from maestro_tpu.utils import flops as JF
from maestro_tpu.utils.testing import make_synthetic_batch
from maestro_tpu_torch.conf import (
    DatasetsConfig,
    MaskConfig,
    ModelConfig,
    OptPretrainConfig,
)
from maestro_tpu_torch.models.mae import MAE_ARCHS, build_model
from maestro_tpu_torch.ops import attention as TA
from maestro_tpu_torch.ops import fused_loss as TFL
from maestro_tpu_torch.ops import masking as TMK
from maestro_tpu_torch.port.from_jax import flax_names, load_jax_params
from maestro_tpu_torch.serve import batch_to_device
from maestro_tpu_torch.specs.fusion import build_fusion_plan
from maestro_tpu_torch.train import optim as TO
from maestro_tpu_torch.train.state import TrainState
from maestro_tpu_torch.train.steps import (
    make_pretrain_eval_step,
    make_pretrain_step,
    mask_generator,
    pretrain_loss_fn,
)
from maestro_tpu_torch.utils import flops as TF

from _torch_port_utils import single_thread_torch, synthetic_tree, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

BATCH = 2
LOSS_RTOL = 1e-5  # fp32 pretrain loss; observed rel err ~1e-7
GRAD_TOL = 1e-4  # of each leaf's max |grad|; observed ~1e-6
TRAJ_RTOL = 1e-4  # 3-step loss trajectory
# bf16 compute, fp32 loss: observed rel err ~2e-3 (bf16 rounds at other places
# in the two frameworks), x5
BF16_LOSS_RTOL = 1e-2
DATASETS = {"treesat": "treesatai_ts", "pastis": "pastis_hd"}


# the other fusion modes (and trunk depths) than the group / 1 of every other test:
# shared and monotemp flatten dates or modalities into the batch (no structural
# mask, shuffle batch_factor > 1), mod keeps one stream a modality
FUSION_MODES = [("shared", 0), ("monotemp", 0), ("mod", 0), ("mod", 1), ("group", 0)]
FUSION_IDS = ["shared", "monotemp", "mod0", "mod1", "group0"]


def _micro_cfg(cls, mode: str = "group", inter_depth: int = 1):
    return cls(model_size="micro", fusion_mode=mode, inter_depth=inter_depth)


class MaskRecorder:
    """Wraps the JAX package's mask functions to record their draws: the
    structural masks and, per stream in plan order, the shuffle noise."""

    def __init__(self, monkeypatch):
        self.draws: list[tuple[dict, dict]] = []
        self._struct = None
        self._noise: dict[int, np.ndarray] = {}
        self._traced = 0
        orig_struct, orig_shuffle = JM.structural_mask, JM.shuffle_mask

        def structural_mask(plan, key, batch_size):
            out = orig_struct(plan, key, batch_size)
            self._traced = 0  # stream index of the next shuffle_mask call
            jax.debug.callback(self._on_struct, out)
            return out

        def shuffle_mask(key, x, struct, num_masked):
            noise = jax.random.uniform(key, x.shape[:2])
            jax.debug.callback(partial(self._on_noise, self._traced), noise)
            self._traced += 1
            return orig_shuffle(key, x, struct, num_masked)

        monkeypatch.setattr(JM, "structural_mask", structural_mask)
        monkeypatch.setattr(JM, "shuffle_mask", shuffle_mask)

    def _on_struct(self, masks):
        self._struct = {k: np.asarray(v) for k, v in masks.items()}

    def _on_noise(self, index, noise):
        self._noise[index] = np.asarray(noise)

    def collect(self, plan) -> None:
        """File the draws of one finished JAX forward."""
        jax.effects_barrier()
        names = list(plan.streams)
        assert self._struct is not None and sorted(self._noise) == list(range(len(names)))
        self.draws.append((self._struct, {n: self._noise[i] for i, n in enumerate(names)}))
        self._struct, self._noise = None, {}

    def replay(self, monkeypatch) -> None:
        """The port's draw_masks returns the recorded draws, in order."""
        draws = iter(self.draws)

        def draw_masks(plan, generator, batch_size):
            struct, noise = next(draws)
            return ({k: torch.from_numpy(np.array(v)) for k, v in struct.items()},
                    {k: torch.from_numpy(np.array(v)) for k, v in noise.items()})

        monkeypatch.setattr(TMK, "draw_masks", draw_masks)


def _pair(name: str, dtype: str = "float32", mode: str = "group", inter_depth: int = 1):
    """JAX model + synthetic numpy params + the port's model holding them."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jds = JDatasetsConfig(name_dataset=name)
    jmodel, jplan = jax_build_model(jds, JMaskConfig(),
                                    _micro_cfg(JModelConfig, mode, inter_depth), dtype=jdt)
    batch = make_synthetic_batch(jds.dataset, BATCH)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model, plan = build_model(
        DatasetsConfig(name_dataset=name), MaskConfig(), _micro_cfg(ModelConfig, mode, inter_depth),
        dtype=tdt, device="cpu",
    )
    tree = synthetic_tree(model, seed=1, skip=("heads.",))  # the heads take no part
    load_jax_params(model, tree, missing_ok=("heads.",))
    return jmodel, jplan, tree, jbatch, model, plan, batch


def _port_loss(model, plan, batch, fused: bool) -> torch.Tensor:
    loss_fn = pretrain_loss_fn(model, plan, "l1_norm", fused)
    return loss_fn(batch_to_device(model, batch, torch.device("cpu")), torch.Generator())


def _assert_grads_match(model, want_grads, min_leaves: int = 51) -> None:
    """Every gradient leaf within GRAD_TOL of that leaf's max |grad|; the
    heads (absent from the JAX tree) get none."""
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
    assert compared >= min_leaves
    for name, p in params.items():  # the heads take no part in pretraining
        assert (p.grad is None) == name.startswith("heads."), name


# treesat on the token-space loss is the first step of the trajectory test
@pytest.mark.parametrize(("dataset", "space"),
                         [("pastis", "tokens"), ("pastis", "pixels"), ("treesat", "pixels")])
def test_pretrain_loss_and_grads_match_jax(monkeypatch, dataset, space):
    jmodel, jplan, tree, jbatch, model, plan, batch = _pair(DATASETS[dataset])
    fused = space == "tokens"
    rec = MaskRecorder(monkeypatch)
    grad_fn = jax.jit(jax.value_and_grad(jax_pretrain_loss_fn(jmodel, jplan, "l1_norm", fused)))
    want_loss, want_grads = grad_fn(tree, jbatch, jax.random.PRNGKey(3))
    rec.collect(jplan)
    rec.replay(monkeypatch)

    model.zero_grad(set_to_none=True)
    loss = _port_loss(model, plan, batch, fused)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    _assert_grads_match(model, want_grads)


@pytest.mark.parametrize(("mode", "inter_depth"), FUSION_MODES, ids=FUSION_IDS)
@pytest.mark.parametrize("dataset", ["treesat", "pastis"])
def test_fusion_modes_pretrain_loss_and_grads_match_jax(monkeypatch, dataset, mode, inter_depth):
    """The token-space pretrain loss and every gradient leaf in the fusion
    modes other than group with one trunk block, masks replayed."""
    jmodel, jplan, tree, jbatch, model, plan, batch = _pair(
        DATASETS[dataset], mode=mode, inter_depth=inter_depth)
    rec = MaskRecorder(monkeypatch)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_pretrain_loss_fn(
        jmodel, jplan, "l1_norm")))(tree, jbatch, jax.random.PRNGKey(11))
    rec.collect(jplan)
    rec.replay(monkeypatch)
    model.zero_grad(set_to_none=True)
    loss = _port_loss(model, plan, batch, fused=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    _assert_grads_match(model, want_grads, min_leaves=20)


@pytest.mark.parametrize("dataset", ["treesat", "pastis"])
def test_pretrain_eval_step_matches_jax(monkeypatch, dataset):
    """``make_pretrain_eval_step`` (pixel-space loss, masks from the seed and
    the batch index, no update) against the JAX package's eval step body on
    the same masks; the weights stay as they were."""
    jmodel, jplan, tree, jbatch, model, plan, batch = _pair(DATASETS[dataset])
    rec = MaskRecorder(monkeypatch)
    want = JSteps._build_pretrain_eval_step(jmodel, jplan, "l1_norm")(
        tree, jbatch, jax.random.PRNGKey(13))["loss_rec"]
    rec.collect(jplan)
    rec.replay(monkeypatch)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(model, None)
    logs = make_pretrain_eval_step(model, plan)(state, batch, 0, 5)
    assert set(logs) == {"loss_rec"} and logs["loss_rec"].requires_grad is False
    np.testing.assert_allclose(logs["loss_rec"].item(), float(want), rtol=LOSS_RTOL)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    assert state.step == 0
    draws = []
    monkeypatch.setattr(TMK, "draw_masks", lambda p, g, b: draws.append(g.initial_seed())
                        or (_ for _ in ()).throw(StopIteration))
    for index in (5, 6):
        with pytest.raises(StopIteration):
            make_pretrain_eval_step(model, plan)(state, batch, 0, index)
    assert draws == [mask_generator(0, 5).initial_seed(), mask_generator(0, 6).initial_seed()]


def test_pretrain_trajectory_matches_jax(monkeypatch):
    """Three AdamW + OneCycle steps (10-step schedule, so the learning rate
    climbs and turns) on the token-space loss; the gradients of the first
    step leaf by leaf."""
    jmodel, jplan, tree, jbatch, model, plan, batch = _pair("treesatai_ts")
    total, base_lr = 10, 1e-2  # a large rate so the steps move the loss
    rec = MaskRecorder(monkeypatch)
    tx = JO.make_optimizer(JOptPretrainConfig(base_lr=base_lr, batch_size=BATCH), "pretrain",
                           total, tree)
    # make_pretrain_step's body in two programs (one program of both takes
    # longer to compile on the CPU than the two together)
    grad_fn = jax.jit(jax.value_and_grad(jax_pretrain_loss_fn(jmodel, jplan, "l1_norm")))

    @jax.jit
    def apply_update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    rng = jax.random.PRNGKey(5)
    want = []
    for step in range(3):
        loss, grads = grad_fn(params, jbatch, jax.random.fold_in(rng, step))
        rec.collect(jplan)
        params, opt_state = apply_update(grads, opt_state, params)
        want.append(float(loss))
        if step == 0:
            first_grads = grads

    rec.replay(monkeypatch)
    ttx = TO.make_optimizer(OptPretrainConfig(base_lr=base_lr, batch_size=BATCH), "pretrain",
                            total, model)
    state = TrainState.create(model, ttx)
    step_fn = make_pretrain_step(model, plan, ttx)
    got = []
    for i in range(3):
        state, logs = step_fn(state, batch, 0)
        got.append(logs["loss_rec"].item())
        if i == 0:  # the step leaves its gradients on the parameters
            np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
            _assert_grads_match(model, first_grads)
    assert state.step == 3
    assert abs(want[2] - want[0]) > 100 * TRAJ_RTOL * abs(want[0])  # the steps mattered
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_pretrain_bf16_loss_matches_jax(monkeypatch):
    jmodel, jplan, tree, jbatch, model, plan, batch = _pair("pastis_hd", "bfloat16")
    rec = MaskRecorder(monkeypatch)
    want = jax.jit(jax_pretrain_loss_fn(jmodel, jplan, "l1_norm"))(
        tree, jbatch, jax.random.PRNGKey(7))
    rec.collect(jplan)
    rec.replay(monkeypatch)
    with torch.no_grad():
        got = _port_loss(model, plan, batch, fused=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=BF16_LOSS_RTOL)


def test_pretrain_outputs():
    """Token-space and pixel-space reconstructions, masks and targets: shapes,
    dtypes and the masked count per stream; the forward needs a generator."""
    ds = DatasetsConfig(name_dataset="treesatai_ts")
    model, plan = build_model(ds, MaskConfig(), _micro_cfg(ModelConfig), dtype=torch.float32,
                              device="cpu")
    batch = batch_to_device(model, make_synthetic_batch(ds.dataset, BATCH),
                            torch.device("cpu"))
    with torch.no_grad():
        rec, masks, targets = model(batch, "pretrain", False, generator=torch.Generator())
        pix, pmasks, _ = model(batch, "pretrain", generator=torch.Generator())
    masked = dict.fromkeys(plan.streams, 0)
    for name, spec in plan.mod_specs.items():
        f = spec.num_channels * spec.patch_size**2
        assert rec[name].shape == (BATCH, spec.date_axis, spec.tokens_per_date, f)
        assert masks[name].shape == (BATCH, spec.date_axis, spec.tokens_per_date)
        assert masks[name].dtype == torch.bool
        size = spec.image_size
        assert pix[name].shape == (BATCH, spec.num_dates, spec.num_channels, size, size)
        assert pmasks[name].shape == pix[name].shape
        assert targets[name].shape == pix[name].shape
        masked[spec.group] += masks[name].reshape(BATCH, -1).sum(dim=1)
    for name, stream in plan.streams.items():
        assert (masked[name] == stream.num_masked).all()
    with pytest.raises(ValueError, match="generator"):
        model(batch, "pretrain")


def test_onecycle_schedule_matches_jax():
    for total in (1, 5, 10, 1000):
        want_fn = JO.onecycle_schedule(total, 3e-4, final_div_factor=1e4)
        got_fn = TO.onecycle_schedule(total, 3e-4, final_div_factor=1e4)
        counts = sorted({0, 1, 2, total // 5, total // 2, total - 1, total, total + 3})
        want = [float(want_fn(c)) for c in counts]
        # the JAX schedule runs in fp32: near the ends of the cycle it is
        # off by fp32 rounding of the peak, not of the value
        np.testing.assert_allclose([got_fn(c) for c in counts], want, rtol=1e-5, atol=1e-6 * 3e-4)
    opt, jopt = OptPretrainConfig(batch_size=48), JOptPretrainConfig(batch_size=48)
    assert TO.lr_for(opt, 1) == pytest.approx(JO.lr_for(jopt, 1), rel=1e-12)
    np.testing.assert_allclose(
        [TO.onecycle(opt, 100, 1)(c) for c in (0, 20, 99)],
        [float(JO.onecycle(jopt, 100, 1)(c)) for c in (0, 20, 99)], rtol=1e-5,
        atol=1e-6 * TO.lr_for(opt, 1))


def test_optimizer_trains_only_the_phase_roles():
    ds = DatasetsConfig(name_dataset="pastis_hd")
    model, _ = build_model(ds, MaskConfig(), _micro_cfg(ModelConfig), device="cpu")
    names = {id(p): n for n, p in model.named_parameters()}
    tx = TO.make_optimizer(OptPretrainConfig(), "pretrain", 10, model)
    trained = {names[id(p)] for g in tx.adamw.param_groups for p in g["params"]}
    assert trained == {n for n in names.values() if not n.startswith("heads.")}
    assert any(n.startswith("decoders.") for n in trained)
    labels = TO.param_labels(model)
    assert labels["mask_tokens.s2"] == labels["pixelify.s2.proj0.weight"] == "decoder"
    assert labels["encoders.s2.block0.attn.qkv.weight"] == "backbone"
    assert labels["heads.pastis_seg.proj.weight"] == "head"
    for phase in ("pretrain", "probe", "finetune"):
        assert TO.trainable_roles(phase) == JO.trainable_roles(phase)
    with pytest.raises(ValueError, match="phase"):
        TO.trainable_roles("serve")


def test_mask_generator_is_a_function_of_seed_and_step():
    plan = build_fusion_plan(DatasetsConfig(name_dataset="flair").dataset, MaskConfig(), "group")

    def draw(seed, step):
        struct, noise = TMK.draw_masks(plan, mask_generator(seed, step), 2)
        return torch.cat([noise[n] for n in plan.streams], dim=1)

    assert torch.equal(draw(0, 4), draw(0, 4))
    assert not torch.equal(draw(0, 4), draw(0, 5))
    assert not torch.equal(draw(0, 4), draw(1, 4))


def test_kernel_counts_stay_zero_on_the_cpu():
    ds = DatasetsConfig(name_dataset="treesatai_ts")
    model, plan = build_model(ds, MaskConfig(), _micro_cfg(ModelConfig), device="cpu",
                              dtype=torch.float32)
    before = (TA.launch_count, TA.bwd_launch_count, TFL.fwd_launch_count, TFL.bwd_launch_count)
    tx = TO.make_optimizer(OptPretrainConfig(), "pretrain", 10, model)
    step = make_pretrain_step(model, plan, tx)
    _, logs = step(TrainState.create(model, tx), make_synthetic_batch(ds.dataset, 1), 0)
    assert torch.isfinite(logs["loss_rec"])
    assert (TA.launch_count, TA.bwd_launch_count, TFL.fwd_launch_count,
            TFL.bwd_launch_count) == before


def test_model_flops_match_jax():
    """The analytic count equals the JAX package's for the FLAIR pretrain
    configuration; the decoder-MLP undercount is what the real MLP width adds."""
    for name, size in (("flair", "medium"), ("pastis_hd", "micro")):
        arch, jarch = MAE_ARCHS[size], J_ARCHS[size]
        plan = build_fusion_plan(DatasetsConfig(name_dataset=name).dataset, MaskConfig(), "group")
        jplan = j_build_fusion_plan(JDatasetsConfig(name_dataset=name).dataset, JMaskConfig(),
                                    "group")
        for b in (1, 48):
            assert TF.mae_model_flops(plan, arch, 3, "pretrain", b) == JF.mae_model_flops(
                jplan, jarch, 3, "pretrain", b)
            real = 0.0
            for s in plan.streams.values():
                real += b * arch.decoder_depth * (
                    JF._block_flops(s.seq_len, arch.decoder_dim, arch.decoder_heads
                                    * arch.decoder_dim_head, arch.embed_dim * arch.decoder_mlp_ratio)
                    - JF._block_flops(s.seq_len, arch.decoder_dim, arch.decoder_heads
                                      * arch.decoder_dim_head, arch.decoder_dim * arch.decoder_mlp_ratio))
            assert TF.decoder_mlp_undercount(plan, arch, b) == pytest.approx(3.0 * real, rel=1e-12)
