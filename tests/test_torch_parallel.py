"""The port's mesh, placement rules and parallel train steps
(``maestro_tpu_torch/parallel/mesh.py``) against the JAX package.

Every parallel mode runs in real processes on one gloo group
(``tests/_torch_dist_worker.py``, which imports no JAX) and is held, two
pretrain and two finetune steps, against the JAX package's SINGLE-DEVICE
jitted step on the same global batch (8 rows of the ``micro`` MAE on
TreeSatAI, its aerial stream cut as tests/test_mesh.py cuts it) with the
JAX package's own mask draws replayed, at tests/test_mesh.py's tolerances:
loss rtol 1e-4, parameters rtol 5e-4 / atol 1e-6, metric states exact.
Every mode is held against that step directly and against the one-process
port; off JAX may be only the one element that the JAX step itself moves
most when the batch's rows are summed in another order.  The JAX reference
and all the port's runs (one launch of 4 processes, the modes side by side
in rounds) are computed once for all test workers (a file lock over the
session's temporary root).  The traps of the port each have a test:
global-batch loss ratios and masks, the head split of the fused
projections, whole tensors at the kernels, wrapper names, and a non-finite
gradient seen by one rank.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import maestro_tpu.models.mae as JM
from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.conf import MaskConfig as JMaskConfig
from maestro_tpu.conf import ModelConfig as JModelConfig
from maestro_tpu.conf import OptFinetuneConfig as JOptFinetuneConfig
from maestro_tpu.conf import OptPretrainConfig as JOptPretrainConfig
from maestro_tpu.parallel import mesh as JMesh
from maestro_tpu.train import metrics as JMetrics
from maestro_tpu.train import optim as JO
from maestro_tpu.train import steps as JSteps
from maestro_tpu.train.losses import prediction_losses as j_prediction_losses
from maestro_tpu.train.steps import pretrain_loss_fn as jax_pretrain_loss_fn
from maestro_tpu.utils.testing import make_synthetic_batch
from maestro_tpu_torch.conf import OptFinetuneConfig, OptPretrainConfig
from maestro_tpu_torch.ops import masking as TMK
from maestro_tpu_torch.ops.fused_loss import fused_reconstruction_loss
from maestro_tpu_torch.parallel import mesh as TMesh
from maestro_tpu_torch.port.from_jax import flax_names, match_jax_params
from maestro_tpu_torch.serve import batch_to_device
from maestro_tpu_torch.train import checkpoint as ckpt
from maestro_tpu_torch.train import optim as TO
from maestro_tpu_torch.train.losses import prediction_losses
from maestro_tpu_torch.train.state import TrainState
from maestro_tpu_torch.train.steps import mask_generator

from _torch_dist_worker import build_micro, by_job, job, launch, session_shared
from _torch_port_utils import single_thread_torch, synthetic_tree  # noqa: F401
from test_torch_train import MaskRecorder

pytestmark = pytest.mark.usefixtures("single_thread_torch")

GLOBAL_BATCH = 8
STEPS, TOTAL, BASE_LR = 2, 10, 1e-3  # tests/test_mesh.py's schedule and rate
LOSS_RTOL = 1e-4  # tests/test_mesh.py:85
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-6  # tests/test_mesh.py's _assert_trees_close

# (num_data, num_model, num_replica, fsdp)
MODES = {
    "dp2": (2, 1, 1, False),
    "fsdp2": (2, 1, 1, True),
    "tp2": (1, 2, 1, False),
    "dp2xtp2": (2, 2, 1, False),
    "replica2xdata2-fsdp": (2, 1, 2, True),
}


def _jax_datasets():
    ds = JDatasetsConfig(name_dataset="treesatai_ts")
    ds.treesatai_ts.aerial.image_size = 40
    ds.treesatai_ts.aerial.patch_size.mae = 8
    ds.treesatai_ts.__post_init__()
    return ds


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _compute_reference(after_pretrain=None) -> dict:
    """The JAX package's single-device jitted steps: two pretrain steps
    (masks recorded) and two finetune steps, from one synthetic tree;
    ``after_pretrain(ref)``, when given, is called once the mask draws are
    in ``ref``, before the finetune steps."""
    model, _ = build_micro()
    tree = synthetic_tree(model, seed=1)
    jds = _jax_datasets()
    jmodel, jplan = JM.build_model(
        jds, JMaskConfig(), JModelConfig(model_size="micro", fusion_mode="group", inter_depth=1),
        dtype=jnp.float32)
    batch = make_synthetic_batch(jds.dataset, GLOBAL_BATCH, seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pre_tree = {"params": {k: v for k, v in tree["params"].items()
                           if not k.startswith("heads_")}}
    ref = {"tree": tree, "batch": batch}

    with pytest.MonkeyPatch.context() as mp:
        rec = MaskRecorder(mp)
        tx = JO.make_optimizer(JOptPretrainConfig(base_lr=BASE_LR, batch_size=GLOBAL_BATCH),
                               "pretrain", TOTAL, pre_tree)
        grad_fn = jax.jit(jax.value_and_grad(jax_pretrain_loss_fn(jmodel, jplan, "l1_norm")))

        @jax.jit
        def update(grads, opt_state, params):
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        params = jax.tree.map(jnp.asarray, pre_tree)
        opt_state = tx.init(params)
        losses = []
        for i in range(STEPS):
            loss, grads = grad_fn(params, jbatch, jax.random.fold_in(jax.random.PRNGKey(5), i))
            rec.collect(jplan)
            params, opt_state = update(grads, opt_state, params)
            losses.append(float(loss))
        ref["draws"] = rec.draws
        ref["pretrain"] = (losses, _np_tree(params))
    if after_pretrain is not None:
        after_pretrain(ref)

    tx = JO.make_optimizer(JOptFinetuneConfig(base_lr=BASE_LR, batch_size=GLOBAL_BATCH),
                           "finetune", TOTAL, tree)

    def loss_fn(params, batch):
        return j_prediction_losses(jmodel.head_specs, batch,
                                   jmodel.apply(params, batch, "finetune"))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    @jax.jit
    def update_ft(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    metrics = JSteps.init_metric_states(jmodel.head_specs)
    losses, ref["finetune_grads"] = [], []
    for _ in range(STEPS):
        (loss, aux), grads = grad_fn(params, jbatch)
        metrics = {hs.name: JMetrics.metric_update(hs.type_target, metrics[hs.name], aux[hs.name])
                   for hs in jmodel.head_specs}
        params, opt_state = update_ft(grads, opt_state, params)
        losses.append(float(loss))
        ref["finetune_grads"].append(_np_tree(grads))
    # the same steps on the batch's rows in reverse order: the same sums,
    # added in another order
    reordered = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(reordered)
    rows = {k: v[::-1] for k, v in jbatch.items()}
    for _ in range(STEPS):
        reordered, opt_state = update_ft(grad_fn(reordered, rows)[1], opt_state, reordered)
    ref["order_sensitive"] = _most_moved(_np_tree(reordered), _np_tree(params))
    cms = {}
    for hs in jmodel.head_specs:
        st = metrics[hs.name]
        cms[hs.name] = ({k: np.asarray(st[k]) for k in ("cm", "hist")}
                        if hs.type_target == "multilabel_classif"
                        else {"cm": np.asarray(JMetrics.monolabel_cm(st))})
    ref["finetune"] = (losses, _np_tree(params), cms)
    return ref


def _rounds(ckpt_dir: str) -> list:
    """Every run of this file on 4 processes started once: the modes side
    by side where they fit, the checkpoint saved under fsdp2 and restored
    under tp2, and the one-process port (no group)."""
    return [
        [job("steps", (0, 1), "dp2", mesh=MODES["dp2"]),
         job("steps", (2, 3), "tp2", mesh=MODES["tp2"], skip_nonfinite=True)],
        [job("steps", (0, 1), "fsdp2", mesh=MODES["fsdp2"], skip_nonfinite=True),
         job("save", (2, 3), mesh=MODES["fsdp2"], dir=ckpt_dir)],
        [job("steps", (0, 1, 2, 3), "dp2xtp2", mesh=MODES["dp2xtp2"])],
        [job("steps", (0, 1, 2, 3), "replica2xdata2-fsdp", mesh=MODES["replica2xdata2-fsdp"])],
        [job("restore", (0, 1), mesh=MODES["tp2"], dir=ckpt_dir),
         job("single", (2,), group=False)],
    ]


def _compute_all(root) -> dict:
    """The JAX reference, and the port's runs (``_rounds``) on its batch,
    weights and mask draws, started once the draws are made and run beside
    the JAX finetune steps."""
    ckpt_dir = str(root / f"parallel_ckpt_{os.urandom(4).hex()}")
    started = []

    def start(ref):
        payload = {k: ref[k] for k in ("tree", "batch", "draws")}
        started.append(launch("rounds", 4, root, dict(
            payload, lr=BASE_LR, total=TOTAL, steps=STEPS, rounds=_rounds(ckpt_dir)),
            group=False, wait=False))

    ref = _compute_reference(after_pretrain=start)
    runs = by_job(started[0]())
    ref["single"] = runs.pop("single")[0]
    ref["runs"] = runs
    return ref


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX reference and the port's runs, computed once a session."""
    return session_shared(tmp_path_factory, "torch_parallel_reference", _compute_all)


def _over_tolerance(got: dict, want_tree: dict) -> set[tuple[str, tuple]]:
    """(name, index) of every element of the port's parameters ``got`` off
    the flax tree's at tests/test_mesh.py's tolerances."""
    names = flax_names(build_micro()[0])
    over = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_tree["params"])[0]:
        name, transpose = names[tuple(str(k.key) for k in path)]
        want = np.asarray(leaf).T if transpose else np.asarray(leaf)
        bad = np.abs(got[name] - want) > PARAM_ATOL + PARAM_RTOL * np.abs(want)
        over |= {(name, tuple(int(i) for i in idx)) for idx in np.argwhere(bad)}
    return over


def _most_moved(moved_tree: dict, want_tree: dict) -> tuple[float, tuple[str, tuple]]:
    """(move over its tolerance, (name, index)) of the element that moves
    most, over its tolerance, between two flax trees."""
    names = flax_names(build_micro()[0])
    worst = (-1.0, None)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(moved_tree["params"])[0],
                            jax.tree.leaves(want_tree["params"]), strict=True):
        name, transpose = names[tuple(str(k.key) for k in path)]
        a, b = (np.asarray(a).T, np.asarray(b).T) if transpose else (np.asarray(a), np.asarray(b))
        r = np.abs(a - b) / (PARAM_ATOL + PARAM_RTOL * np.abs(b))
        i = np.unravel_index(np.argmax(r), r.shape)
        if r[i] > worst[0]:
            worst = (float(r[i]), (name, tuple(int(j) for j in i)))
    return worst


def _leaf(tree: dict, name: str) -> np.ndarray:
    """The port-layout array of the parameter ``name`` in a flax tree."""
    for path, (pname, transpose) in flax_names(build_micro()[0]).items():
        if pname == name:
            a = tree["params"]
            for key in path:
                a = a[key]
            return np.asarray(a).T if transpose else np.asarray(a)
    raise KeyError(name)


def _assert_params_close(got: dict, want_tree: dict) -> int:
    """The port's whole parameters against a flax tree, leaf by leaf."""
    names = flax_names(build_micro()[0])
    compared = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_tree["params"])[0]:
        name, transpose = names[tuple(str(k.key) for k in path)]
        want = np.asarray(leaf)
        np.testing.assert_allclose(got[name], want.T if transpose else want,
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
        compared += 1
    return compared


def _assert_same_params(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


# --------------------------------------------------------------------------
# the mesh and the placement rules
# --------------------------------------------------------------------------
@pytest.mark.parametrize(("num_data", "num_model", "num_replica"),
                         [(-1, 1, 1), (4, 2, 1), (-1, 2, 1), (2, 2, 2), (-1, 2, 2), (8, 1, 1)])
def test_mesh_shape_matches_jax(num_data, num_model, num_replica):
    """``mesh_shape`` over 8 processes against the JAX package's
    ``make_mesh`` over its 8 CPU devices."""
    mesh = JMesh.make_mesh(num_data, num_model, num_replica)
    want = (mesh.shape.get("replica", 1), mesh.shape["data"], mesh.shape["model"])
    assert TMesh.mesh_shape(8, num_data, num_model, num_replica) == want


@pytest.mark.parametrize(("args", "match"), [
    ((8, 2, 1), "needs 16 devices"),
    ((-1, 3, 1), "not divisible into 1 replicas x model axis 3"),
    ((-1, 1, 3), "not divisible into 3 replicas"),
])
def test_mesh_errors_match_jax(args, match):
    with pytest.raises(ValueError, match=match):
        JMesh.make_mesh(*args)
    with pytest.raises(ValueError, match=match):
        TMesh.mesh_shape(8, *args)


def test_placement_rules_match_jax():
    """``param_spec`` of every parameter of the MAE and its heads equals the
    JAX package's ``_param_spec`` of the same flax path (through
    ``match_jax_params``' names), transposed to torch's layout; the port
    splits exactly the parameters the rules split, along that dim, the fused
    projections in 3 (q, k, v) and 2 (k, v) segments."""
    model, _ = build_micro()
    tree = synthetic_tree(model, seed=0)
    values = match_jax_params(model, tree)[0]
    names = flax_names(model)
    targets = TMesh.tp_layout(model)
    split = 0
    for path, (name, transpose) in names.items():
        shape = values[name].shape[::-1] if transpose else values[name].shape
        for tp in (False, True):
            want = tuple(JMesh._param_spec(path, np.zeros(shape), tp))
            want = want + (None,) * (len(shape) - len(want))
            assert TMesh.param_spec(model, name, tp) == (want[::-1] if transpose else want), name
        spec = TMesh.param_spec(model, name, True)
        if TMesh.MODEL_AXIS in spec:
            split += 1
            assert targets[name][0] == spec.index(TMesh.MODEL_AXIS), name
            assert targets[name][1] == {"qkv": 3, "to_kv": 2}.get(name.split(".")[-2], 1)
        else:
            assert name not in targets, name
    assert split == len(targets) > 10


def test_head_split_keeps_heads_whole():
    """The fused qkv is split by head within each of q, k and v (a
    contiguous column split would hand rank 0 all of q and half of k), and
    the pieces join back; a head count tp does not divide is refused."""
    h, d, e, n = 4, 3, 5, 2
    w = torch.arange(3 * h * d * e, dtype=torch.float32).reshape(3 * h * d, e)
    pieces = [TMesh.head_piece(w, 0, 3, n, k) for k in range(n)]
    for k, piece in enumerate(pieces):
        view = piece.reshape(3, h // n, d, e)
        full = w.reshape(3, h, d, e)
        for j in range(3):  # q, k, v: this rank's heads of each
            assert torch.equal(view[j], full[j, k * (h // n) : (k + 1) * (h // n)])
    assert torch.equal(TMesh.join_pieces(pieces, 0, 3), w)
    assert not torch.equal(pieces[0], w.chunk(n, 0)[0])
    model, _ = build_micro()  # micro: 2 heads
    with pytest.raises(ValueError, match="heads do not split over trainer.mesh_model=4"):
        TMesh.check_tp_split(model, 4)
    TMesh.check_tp_split(model, 2)


# --------------------------------------------------------------------------
# the global batch
# --------------------------------------------------------------------------
def test_loss_uses_global_counts():
    """Trap 1: with each rank dividing by the global count and the
    gradients averaged over ranks (``loss_scale``), the ranks' losses sum to
    the global batch's ratio; the mean of local ratios does not."""
    model, plan = build_micro()
    ds = _jax_datasets()
    batch = batch_to_device(model, make_synthetic_batch(ds.dataset, 4, seed=2), "cpu")
    with torch.no_grad():
        rec, masks, targets = model(batch, "pretrain", False, generator=mask_generator(0, 0))
    # uneven counts and errors between the halves
    masks = {k: v.clone() for k, v in masks.items()}
    rec = {k: v.clone() for k, v in rec.items()}
    for name, v in masks.items():
        v[:2].view(-1)[: v[:2].numel() // 2] = False
        rec[name][:2] += 2.0
    whole = fused_reconstruction_loss(plan, targets, rec, masks)

    def half(d, i):
        return {k: v[2 * i : 2 * i + 2] for k, v in d.items()}

    def counts_of(i):  # a rank's own counts, in call order
        seen = []
        fused_reconstruction_loss(plan, half(targets, i), half(rec, i), half(masks, i),
                                  count_reduce=lambda c: seen.append(c) or c)
        return seen

    counts = [counts_of(0), counts_of(1)]

    def global_count(i):  # a rank's count -> the two ranks' sum
        other = iter(counts[1 - i])
        return lambda c: c + next(other)

    parts = [fused_reconstruction_loss(plan, half(targets, i), half(rec, i), half(masks, i),
                                       count_reduce=global_count(i)) for i in (0, 1)]
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-6, atol=0)
    local = [fused_reconstruction_loss(plan, half(targets, i), half(rec, i), half(masks, i))
             for i in (0, 1)]
    assert abs(float((local[0] + local[1]) / 2 - whole)) > 1e-2 * float(whole)
    # the same for a supervised loss over valid labels
    head_specs = model.head_specs
    labels = {hs.name: batch_to_device(model, make_synthetic_batch(ds.dataset, 4, seed=2), "cpu",
                                       targets=True)[hs.name] for hs in head_specs}
    hs = head_specs[0]
    labels[hs.name] = labels[hs.name].clone()
    labels[hs.name][:1] = hs.missing_val  # rank 0 holds one valid row, rank 1 two
    logits = {hs.name: torch.randn(4, hs.num_classes, generator=torch.Generator().manual_seed(0))}
    want, _ = prediction_losses((hs,), labels, logits)
    valid = [(labels[hs.name][2 * i : 2 * i + 2] != hs.missing_val).all(dim=1).sum()
             for i in (0, 1)]
    got = sum(prediction_losses((hs,), half(labels, i), half(logits, i),
                                lambda c, i=i: c + valid[1 - i])[0] for i in (0, 1))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_masks_are_drawn_for_the_global_batch():
    """Trap 2: a rank's pretrain forward (``mask_rows``) draws the masks of
    the whole global batch from the step's generator (the redraw loop
    included) and keeps its rows, so data-parallel ranks take the masks one
    process takes."""
    model, plan = build_micro()
    batch = batch_to_device(model, make_synthetic_batch(_jax_datasets().dataset, 4, seed=2),
                            "cpu")
    with torch.no_grad():
        _, want, _ = model(batch, "pretrain", False, generator=mask_generator(3, 1))
        for rank in (0, 1):
            rows = {k: v[2 * rank : 2 * rank + 2] for k, v in batch.items()}
            _, got, _ = model(rows, "pretrain", False, generator=mask_generator(3, 1),
                              mask_rows=(2 * rank, 4))
            for name in want:
                assert torch.equal(got[name], want[name][2 * rank : 2 * rank + 2]), name
    draws = TMK.draw_masks(plan, mask_generator(3, 1), 4)
    noise = TMK.local_rows(plan, draws[1], 2, 2)
    assert all(torch.equal(noise[k], draws[1][k][2:4]) for k in noise)


# --------------------------------------------------------------------------
# the parallel steps against the JAX package's single-device step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(MODES))
def test_parallel_steps_match_jax(reference, mode):
    """Two pretrain and two finetune steps under ``mode`` against the JAX
    package's single-device steps on the same global batch: losses, every
    parameter, the summed metric states; what each rank holds after the
    update; the kernels' inputs (plain tensors, the pool's whole weight)."""
    num_data, num_model, num_replica, fsdp = MODES[mode]
    results = reference["runs"][mode]
    assert len(results) == num_data * num_model * num_replica
    r0, single = results[0], reference["single"]
    for phase in ("pretrain", "finetune"):
        want_loss, want_params = reference[phase][:2]
        np.testing.assert_allclose(r0[f"{phase}_loss"], want_loss, rtol=LOSS_RTOL)
        # the parameters, at tests/test_mesh.py's tolerances: the mode against
        # the JAX package's single-device step, and against the one-process
        # port, which is held against that step too.  Off JAX may be only the
        # one element whose last bits the order of the sums sets: the element
        # that the JAX step itself moves most when the batch's rows come in
        # reverse order (a finetune weight whose gradients cancel to 1e-4 of
        # its neighbours', so AdamW's update divides rounding by rounding)
        over = _over_tolerance(r0[f"{phase}_params"], want_params)
        assert over <= {reference["order_sensitive"][1]}, sorted(over)[:5]
        assert _assert_params_close(single[f"{phase}_params"], want_params) > 50
        _assert_same_params(r0[f"{phase}_params"], single[f"{phase}_params"])
    want_cms = reference["finetune"][2]
    for r in results:
        assert not r["jax_loaded"]
        assert r["kernel_calls"] > 0
        np.testing.assert_allclose(r["finetune_loss"], r0["finetune_loss"], rtol=0)
        for name, st in want_cms.items():
            for key, value in st.items():
                np.testing.assert_array_equal(r["finetune_metrics"][name][key], value)

    model, _ = build_micro()
    whole = {name: tuple(p.shape) for name, p in model.named_parameters()}
    targets = TMesh.tp_layout(model)
    for r in results:
        for name, info in r["finetune_placements"].items():
            shape = list(whole[name])
            if num_model > 1 and name in targets:  # heads whole: 1/tp of the rows or cols
                shape[targets[name][0]] //= num_model
            if fsdp:  # 1/data of dim 0, within a replica only (HSDP)
                assert ("Replicate(), Shard(dim=0)" if num_replica > 1
                        else "Shard(dim=0)") in info["placements"], (name, info)
                shape[0] = -(-shape[0] // num_data)
                assert info["local"][0] <= shape[0] and info["local"][1:] == tuple(shape[1:])
            else:
                assert info["local"] == tuple(shape), (name, info)
            if info["moment"] is not None:  # the moments are sharded with their parameter
                assert info["moment"] == info["local"], (name, info)
    if mode in ("fsdp2", "tp2"):
        # trap 7: one rank's piece of one gradient is NaN; every rank skips
        for r in results:
            assert not r["nonfinite_applied"] and r["nonfinite_unchanged"]
            assert r["nonfinite_total"] == 1


def test_off_jax_element_is_set_by_summation_order(reference):
    """The one element a mode may leave off the JAX step is one whose last
    bits the order of the sums sets, on the JAX side alone: the reversed-row
    JAX step moves it by a quarter of the tolerance or more, and its
    gradients are under 1e-3 of its weight's median, so AdamW's normalised
    update divides one rounding by another."""
    move, (name, index) = reference["order_sensitive"]
    assert move >= 0.25, (name, index, move)
    for grads in reference["finetune_grads"]:
        g = _leaf(grads, name)
        assert abs(g[index]) < 1e-3 * np.median(np.abs(g)), (name, index, g[index])


def test_checkpoint_elastic_across_meshes(reference):
    """A checkpoint saved under fsdp2 (parameters, moments, EMA pieces) loads
    under tp2 and in one process, whole tensors equal; only process 0
    writes it; the restored state trains on under tp2."""
    saved, restored = reference["runs"]["save"], reference["runs"]["restore"]
    path = saved[0]["path"]
    assert saved[0]["wrote"] and saved[1]["path"] == path
    for r in saved:  # EMA copies are this rank's pieces of its parameters
        assert r["ema_local"] == r["param_local"]
        assert r["ema_local"]["encoders.aerial.block0.attn.qkv.weight"][0] == 3 * 64 // 2
    model, _ = build_micro()
    tx = TO.make_optimizer(OptPretrainConfig(batch_size=GLOBAL_BATCH, base_lr=BASE_LR),
                           "pretrain", TOTAL, model)
    state = TrainState.create(model, tx, use_ema=True)
    ckpt.restore_state(path, state)
    one = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for name, value in saved[0]["params"].items():
        np.testing.assert_array_equal(restored[0]["params"][name], value)
        np.testing.assert_array_equal(one[name], value)
    for name, p in model.named_parameters():
        if p in tx.adamw.state:
            np.testing.assert_array_equal(restored[1]["moments"][name],
                                          tx.adamw.state[p]["exp_avg"].numpy())
        np.testing.assert_array_equal(restored[1]["ema"][name], state.ema[name].numpy())
    assert restored[0]["step"] == state.step == 1
    assert np.isfinite(restored[0]["loss"])


def test_names_under_ddp(tmp_path):
    """Trap 6: DDP puts ``module.`` before every name; the optimizer's roles
    and layer-wise decay groups, and the flax pairing, read through it."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        model, _ = build_micro()
        ddp = torch.nn.parallel.DistributedDataParallel(model)
        assert all(n.startswith("module.") for n, _ in ddp.named_parameters())
        for (name, _), (wname, _) in zip(model.named_parameters(), ddp.named_parameters()):
            assert TO.param_role(wname) == TO.param_role(name)
            assert TO.lw_decay_multiplier(wname, 0.75) == TO.lw_decay_multiplier(name, 0.75)
        opt = OptFinetuneConfig(lw_decay=0.75)
        groups = [[id(p) for p in g["params"]]
                  for g in TO.make_optimizer(opt, "finetune", 4, model).adamw.param_groups]
        wgroups = [[id(p) for p in g["params"]]
                   for g in TO.make_optimizer(opt, "finetune", 4, ddp).adamw.param_groups]
        assert groups == wgroups and len(groups) > 2
        tree = synthetic_tree(model, seed=0)
        values, unknown, mismatched, unfilled = match_jax_params(ddp, tree)
        assert not (unknown or mismatched or unfilled)
        assert len(values) == len(list(model.parameters()))
    finally:
        dist.destroy_process_group()
    assert os.environ.get("WORLD_SIZE") in (None, "1")
