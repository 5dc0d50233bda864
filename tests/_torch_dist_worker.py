"""Worker processes of the port's multi-process tests (tests/test_torch_*.py).

``launch(scenario, n, tmp_path, payload)`` starts ``n`` processes of this
file, which join one gloo group through a ``file://`` store under
``tmp_path`` (no TCP port, so parallel test workers cannot collide), run
``scenario`` on the CPU and write each rank's result with ``torch.save``.
The processes import torch and the port only: never JAX or the JAX package.

Scenarios (each ``def scenario_<name>(payload, rank, world) -> dict``):

* ``rounds``: several scenarios in one launch, so that the processes start
  once.  Each round runs jobs side by side on disjoint sets of ranks; a job
  joins a group of its own (a ``file://`` store per job), or none.
* ``steps``: pretrain and finetune steps of the ``micro`` MAE under a mesh
  (data x model x replica, optionally FSDP) from the payload's weights,
  batch and recorded mask draws; the whole parameters after each phase,
  the placements, and a skipped non-finite step; ``single``: the same
  steps unwrapped in one process.
* ``save`` / ``restore``: a checkpoint written under one mesh and read
  under another.
* ``ring``: ``ops.ring_attention.ring_mha`` and ``cp_trunk_forward``,
  forward and gradients, on this rank's chunk of the sequence.
* ``experiment``: the CLI (``maestro_tpu_torch.main``) on a fixture dataset.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT_S = 180


# --------------------------------------------------------------------------
# the parent's side
# --------------------------------------------------------------------------
def launch(scenario: str, n: int, tmp_path: Path, payload: dict,
           group: bool = True, *, wait: bool = True):
    """Run ``scenario`` in ``n`` processes; returns each rank's result.  A
    process that fails or outlives ``JOIN_TIMEOUT_S`` fails the call.
    ``group=False``: the processes join no group (one plain process, or
    ``rounds``, whose jobs join their own).  ``wait=False`` returns at once
    a function that waits for the processes and returns their results, so
    that the caller works beside them."""
    run = Path(tmp_path) / f"{scenario}_{n}_{os.urandom(4).hex()}"
    run.mkdir(parents=True)
    torch.save(payload, run / "payload.pt")
    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "MASTER_", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                                "TORCHELASTIC_"))}
    env["PYTHONPATH"] = os.pathsep.join([str(repo), str(repo / "tests")])
    env["OMP_NUM_THREADS"] = "1"
    logs = [run / f"rank{rank}.log" for rank in range(n)]
    procs = []
    for rank in range(n):
        with open(logs[rank], "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, scenario, str(rank), str(n), str(run),
                 str(int(group))],
                env=env, cwd=str(run), stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + JOIN_TIMEOUT_S

    def join() -> list[dict]:
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, p in enumerate(procs):
            assert p.returncode == 0, (f"rank {rank}/{n} of {scenario} failed:\n"
                                       f"{logs[rank].read_text(errors='replace')[-6000:]}")
        return [torch.load(run / f"rank{rank}.pt", weights_only=False) for rank in range(n)]

    return join() if wait else join


def session_shared(tmp_path_factory, name: str, compute):
    """``compute(root)`` once for the whole test session: the first test
    worker that asks computes it under a file lock in the session's
    temporary root (shared by the xdist workers) and ``torch.save``s it
    there; every worker loads it."""
    from filelock import FileLock

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):  # the session's root, shared by its workers
        root = root.parent
    path = root / f"{name}.pt"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            torch.save(compute(root), path)
    return torch.load(path, weights_only=False)


def job(scenario: str, ranks: tuple[int, ...], name: str | None = None, group: bool = True,
        **payload) -> dict:
    """One job of a ``rounds`` launch: ``scenario`` on ``ranks``, in a group
    of its own (``group``), its payload the launch's with ``payload`` over it;
    its result is filed under ``name`` (the scenario's by default)."""
    return {"scenario": scenario, "ranks": tuple(ranks), "name": name or scenario,
            "group": group, "payload": payload}


def by_job(results: list[dict]) -> dict[str, list[dict]]:
    """A ``rounds`` launch's results by job name, each job's ranks in order
    (each with its process's ``jax_loaded``)."""
    out: dict[str, list] = {}
    for rank_results in results:
        for name, (k, result) in rank_results["jobs"].items():
            out.setdefault(name, []).append((k, {**result,
                                                 "jax_loaded": rank_results["jax_loaded"]}))
    return {name: [r for _, r in sorted(rs, key=lambda kr: kr[0])] for name, rs in out.items()}


# --------------------------------------------------------------------------
# shared set-up of the workers
# --------------------------------------------------------------------------
def small_datasets():
    """TreeSatAI with the aerial stream cut to 40 px / patch 8 (as the JAX
    package's tests/test_mesh.py cuts it), the port's config."""
    from maestro_tpu_torch.conf import DatasetsConfig

    ds = DatasetsConfig(name_dataset="treesatai_ts")
    ds.treesatai_ts.aerial.image_size = 40
    ds.treesatai_ts.aerial.patch_size.mae = 8
    ds.treesatai_ts.__post_init__()
    return ds


def build_micro(device="cpu"):
    from maestro_tpu_torch.conf import MaskConfig, ModelConfig
    from maestro_tpu_torch.models.mae import build_model

    return build_model(small_datasets(), MaskConfig(),
                       ModelConfig(model_size="micro", fusion_mode="group", inter_depth=1),
                       dtype=torch.float32, device=device)


def replay_masks(draws: list) -> None:
    """The port's ``draw_masks`` returns the recorded draws (made for the
    global batch) in order."""
    from maestro_tpu_torch.ops import masking

    it = iter(draws)

    def draw_masks(plan, generator, batch_size):
        struct, noise = next(it)
        assert next(iter(noise.values())).shape[0] == batch_size
        return ({k: torch.from_numpy(np.array(v)) for k, v in struct.items()},
                {k: torch.from_numpy(np.array(v)) for k, v in noise.items()})

    masking.draw_masks = draw_masks


def _whole(par, model) -> dict[str, np.ndarray]:
    """Every parameter whole (a collective), as numpy."""
    return {n: par.full_tensor(n, p.detach()).numpy().copy() for n, p in model.named_parameters()}


def _placements(par, model, tx) -> dict:
    """Per parameter: its local and whole shapes, its FSDP placements, and
    the local shape of its first AdamW moment (if it has one)."""
    from maestro_tpu_torch.parallel.mesh import local

    out = {}
    for name, p in model.named_parameters():
        st = tx.adamw.state.get(p, {})
        m = st.get("exp_avg")
        out[name] = {
            "local": tuple(local(p).shape),
            "placements": str(getattr(p, "placements", "")),
            "moment": None if m is None else tuple(local(m).shape),
            "moment_dtensor": m is not None and hasattr(m, "placements"),
        }
    return out


_SEEN: list = []


def _check_kernel_inputs() -> list:
    """Wrap the attention wrapper and the pool weight (once a process): every
    call must see plain tensors (no DTensor) and the pool's whole ``to_kv``
    weight.  Returns the list of calls seen, emptied."""
    from maestro_tpu_torch.models import vit

    seen = _SEEN
    seen.clear()
    if getattr(vit.mha_qkv, "checked", False):
        return seen
    mha = vit.mha_qkv

    def mha_qkv(qkv, sm_scale):
        assert not hasattr(qkv, "placements"), type(qkv)
        seen.append(("attention", tuple(qkv.shape)))
        return mha(qkv, sm_scale)

    kv = vit.AttentiveReduce.kv_weight

    def kv_weight(self):
        w = kv(self)
        assert not hasattr(w, "placements") and tuple(w.shape) == (2 * self.dim, self.dim)
        seen.append(("pool", tuple(w.shape)))
        return w

    mha_qkv.checked = True
    vit.mha_qkv = mha_qkv
    vit.AttentiveReduce.kv_weight = kv_weight
    return seen



# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------
def scenario_rounds(payload: dict, rank: int, world: int) -> dict:
    """``payload["rounds"]``: a list of rounds, each a list of jobs (``job``)
    on disjoint ranks.  This rank runs its job of each round, in the job's
    group (made and destroyed here) or none; the results go under
    ``"jobs"``: name -> (rank in the job, result)."""
    import torch.distributed as dist

    from maestro_tpu_torch.parallel.distributed import initialize_distributed

    base = {k: v for k, v in payload.items() if k != "rounds"}
    out = {}
    for i, jobs in enumerate(payload["rounds"]):
        for j, spec in enumerate(jobs):
            if rank not in spec["ranks"]:
                continue
            k, n = spec["ranks"].index(rank), len(spec["ranks"])
            if spec["group"]:
                initialize_distributed("cpu", init_method=f"file://{payload['run']}/store_{i}_{j}",
                                       world_size=n, rank=k)
            try:
                result = globals()[f"scenario_{spec['scenario']}"](
                    {**base, **spec["payload"]}, k, n)
            finally:
                if spec["group"]:
                    dist.barrier()
                    dist.destroy_process_group()
            out[spec["name"]] = (k, result)
    return {"jobs": out}


def scenario_steps(payload: dict, rank: int, world: int) -> dict:
    """``run_steps`` under the payload's mesh."""
    from maestro_tpu_torch.parallel.mesh import Parallel, make_mesh
    from maestro_tpu_torch.port.from_jax import load_jax_params

    num_data, num_model, num_replica, fsdp = payload["mesh"]
    model, plan = build_micro()
    load_jax_params(model, payload["tree"])
    par = Parallel(model, make_mesh(num_data, num_model, num_replica, "cpu"), fsdp=fsdp)
    return run_steps(payload, model, plan, par)


def scenario_single(payload: dict, rank: int, world: int) -> dict:
    """``run_steps`` in one process, unwrapped (no mesh)."""
    from maestro_tpu_torch.port.from_jax import load_jax_params

    model, plan = build_micro()
    load_jax_params(model, payload["tree"])
    return run_steps(payload, model, plan)


def run_steps(payload: dict, model, plan, par=None) -> dict:
    """Pretrain, then finetune from the payload's weights again,
    ``payload["steps"]`` steps each on this rank's rows of the global batch
    (the whole batch without ``par``: one process); with
    ``payload["skip_nonfinite"]`` one more finetune step under the guard
    with a NaN in one rank's piece of one gradient."""
    from maestro_tpu_torch.conf import OptFinetuneConfig, OptPretrainConfig
    from maestro_tpu_torch.parallel.mesh import local
    from maestro_tpu_torch.port.from_jax import match_jax_params
    from maestro_tpu_torch.train import optim as TO
    from maestro_tpu_torch.train import steps as TS
    from maestro_tpu_torch.train.losses import prediction_losses
    from maestro_tpu_torch.train.state import TrainState

    seen = _check_kernel_inputs()
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
    local_batch = batch if par is None else par.shard_batch(batch)
    b = len(next(iter(local_batch.values())))
    dp = 1 if par is None else par.dp_size
    out: dict = {}

    def whole():
        if par is None:
            return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        return _whole(par, model)

    def phase(name):
        if par is not None:
            par.for_phase(TO.trainable_roles(name))

    replay_masks(payload["draws"])
    phase("pretrain")
    tx = TO.make_optimizer(OptPretrainConfig(batch_size=b, base_lr=payload["lr"]), "pretrain",
                           payload["total"], model, dp)
    state = TrainState.create(model, tx, parallel=par)
    step = TS.make_pretrain_step(model, plan, tx, parallel=par)
    out["pretrain_loss"] = [float(step(state, local_batch, 0)[1]["loss_rec"])
                            for _ in range(payload["steps"])]
    out["pretrain_params"] = whole()
    if par is not None:
        out["pretrain_placements"] = _placements(par, model, tx)

    values = match_jax_params(build_micro()[0], payload["tree"])[0]  # whole shapes
    with torch.no_grad():  # the payload's weights again, this rank's pieces
        for name, p in model.named_parameters():
            full = torch.from_numpy(values[name])
            local(p).copy_(full if par is None else par.local_piece(name, full))
    phase("finetune")
    opt = OptFinetuneConfig(batch_size=b, base_lr=payload["lr"])
    tx = TO.make_optimizer(opt, "finetune", payload["total"], model, dp)
    state = TrainState.create(model, tx, parallel=par)
    step = TS.make_supervised_step(model, "finetune", tx, parallel=par)
    metrics = TS.init_metric_states(model.head_specs, "cpu")
    losses = []
    for _ in range(payload["steps"]):
        state, metrics, logs = step(state, local_batch, metrics)
        losses.append(float(logs["loss_pred"]))
    out["finetune_loss"] = losses
    out["finetune_params"] = whole()
    if par is not None:
        metrics = par.sum_states(metrics)
        out["finetune_placements"] = _placements(par, model, tx)
    out["finetune_metrics"] = {k: {kk: vv.numpy().copy() for kk, vv in v.items()}
                               for k, v in metrics.items()}
    out["kernel_calls"] = len(seen)

    if payload.get("skip_nonfinite"):
        # a non-finite gradient on ONE rank's piece: every rank skips the step
        tx = TO.make_optimizer(opt, "finetune", payload["total"], model, dp,
                               skip_nonfinite=True)
        model.train()
        tx.zero_grad()
        cpu = torch.device("cpu")
        loss, _ = prediction_losses(
            model.head_specs, TS.batch_to_device(model, local_batch, cpu, targets=True),
            par.module(TS.batch_to_device(model, local_batch, cpu), "finetune"),
            par.count_reduce)
        (loss * par.loss_scale).backward()
        if par.tp_rank == par.tp_size - 1 and par.dp_rank == par.dp_size - 1:
            p = next(p for p in model.parameters() if p.grad is not None)
            local(p.grad).view(-1)[0] = float("nan")
        before = {n: local(p).detach().clone() for n, p in model.named_parameters()}
        applied = tx.step()
        out["nonfinite_applied"] = bool(applied)
        out["nonfinite_unchanged"] = all(
            torch.equal(local(p).detach(), before[n]) for n, p in model.named_parameters())
        out["nonfinite_total"] = int(tx.guard.total_notfinite)
    return out


def scenario_save(payload: dict, rank: int, world: int) -> dict:
    """One pretrain step (EMA kept) under a mesh, then a checkpoint."""
    from maestro_tpu_torch.conf import OptPretrainConfig
    from maestro_tpu_torch.parallel.mesh import Parallel, local, make_mesh
    from maestro_tpu_torch.port.from_jax import load_jax_params
    from maestro_tpu_torch.train import checkpoint as ckpt
    from maestro_tpu_torch.train import optim as TO
    from maestro_tpu_torch.train import steps as TS
    from maestro_tpu_torch.train.state import TrainState, ema_update

    num_data, num_model, num_replica, fsdp = payload["mesh"]
    model, plan = build_micro()
    load_jax_params(model, payload["tree"])
    par = Parallel(model, make_mesh(num_data, num_model, num_replica, "cpu"), fsdp=fsdp)
    replay_masks(payload["draws"])
    par.for_phase(TO.trainable_roles("pretrain"))
    batch = par.shard_batch({k: torch.from_numpy(v) for k, v in payload["batch"].items()})
    b = len(next(iter(batch.values())))
    tx = TO.make_optimizer(OptPretrainConfig(batch_size=b, base_lr=payload["lr"]), "pretrain",
                           payload["total"], model, par.dp_size)
    state = TrainState.create(model, tx, use_ema=True, parallel=par)
    step = TS.make_pretrain_step(model, plan, tx, parallel=par)
    step(state, batch, 0)
    ema_update(state, 0.5)
    ema_local = {n: tuple(t.shape) for n, t in state.ema.items()}
    path = ckpt.save_checkpoint(payload["dir"], "pretrain", 0, state, extra={"epoch": 0})
    return {"path": str(path), "params": _whole(par, model), "ema_local": ema_local,
            "param_local": {n: tuple(local(p).shape) for n, p in model.named_parameters()},
            "wrote": (Path(path) / "state").exists()}


def scenario_restore(payload: dict, rank: int, world: int) -> dict:
    """Restore a checkpoint (parameters, moments, EMA) under a mesh; the
    whole tensors as this mesh holds them, and one more step."""
    from maestro_tpu_torch.conf import OptPretrainConfig
    from maestro_tpu_torch.parallel.mesh import Parallel, make_mesh
    from maestro_tpu_torch.train import checkpoint as ckpt
    from maestro_tpu_torch.train import optim as TO
    from maestro_tpu_torch.train import steps as TS
    from maestro_tpu_torch.train.state import TrainState

    num_data, num_model, num_replica, fsdp = payload["mesh"]
    model, plan = build_micro()
    par = Parallel(model, make_mesh(num_data, num_model, num_replica, "cpu"), fsdp=fsdp)
    par.for_phase(TO.trainable_roles("pretrain"))
    batch = par.shard_batch({k: torch.from_numpy(v) for k, v in payload["batch"].items()})
    b = len(next(iter(batch.values())))
    tx = TO.make_optimizer(OptPretrainConfig(batch_size=b, base_lr=payload["lr"]), "pretrain",
                           payload["total"], model, par.dp_size)
    state = TrainState.create(model, tx, use_ema=True, parallel=par)
    ckpt.restore_state(ckpt.find_latest_checkpoint(payload["dir"], "pretrain"), state)
    names = dict(model.named_parameters())
    out = {
        "step": state.step,
        "params": _whole(par, model),
        "moments": {n: par.full_tensor(n, tx.adamw.state[p]["exp_avg"]).numpy().copy()
                    for n, p in names.items() if p in tx.adamw.state},
        "ema": {n: par.full_tensor(n, t).numpy().copy() for n, t in state.ema.items()},
    }
    replay_masks(payload["draws"])
    out["loss"] = float(TS.make_pretrain_step(model, plan, tx, parallel=par)(
        state, batch, 0)[1]["loss_rec"])
    return out


def scenario_ring(payload: dict, rank: int, world: int) -> dict:
    """``ring_mha`` and the CP trunk on this rank's sequence chunk; the
    gradients of ``sum(out * w)``, parameter gradients summed over ranks."""
    import torch.distributed as dist

    from maestro_tpu_torch.ops.ring_attention import cp_trunk_forward, ring_mha
    from maestro_tpu_torch.port.from_jax import load_jax_params

    def chunk(a):
        t = torch.from_numpy(np.asarray(a))
        c = t.shape[1] // world
        return t[:, rank * c : (rank + 1) * c].contiguous()

    out = {}
    q, k, v = (chunk(payload[x]) for x in ("q", "k", "v"))
    out["ring"] = ring_mha(q, k, v, None, q.shape[-1] ** -0.5).numpy()
    qg, kg, vg = (chunk(payload[x]).requires_grad_() for x in ("gq", "gk", "gv"))
    (ring_mha(qg, kg, vg, None, qg.shape[-1] ** -0.5) * chunk(payload["gw"])).sum().backward()
    out["grads"] = [t.grad.numpy() for t in (qg, kg, vg)]

    model, _ = build_micro()
    load_jax_params(model, payload["tree"], missing_ok=("heads.", "decoders.", "encoders.",
                                                        "enc_to_dec.", "pixelify.",
                                                        "mask_tokens.", "patch_embed."))
    trunk = model.encoder_inter
    x = chunk(payload["x"])
    y = cp_trunk_forward(trunk, x)
    out["cp"] = y.detach().numpy()
    trunk.zero_grad()
    (y * chunk(payload["w"])).sum().backward()
    grads = {}
    for name, p in trunk.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)
        grads[name] = g.numpy()
    out["cp_grads"] = grads
    return out


def scenario_experiment(payload: dict, rank: int, world: int) -> dict:
    """The CLI over a fixture (with ``payload["env"]`` set, as a launcher
    sets it): each phase's history and metrics, the run directories this
    rank sees."""
    import torch.distributed as dist

    from maestro_tpu_torch.main import main
    from maestro_tpu_torch.parallel.distributed import process_count

    os.environ.update(payload.get("env", {}))
    try:
        results = main(payload["argv"], device="cpu")
    finally:
        for key in payload.get("env", {}):
            del os.environ[key]
        if payload.get("env") and dist.is_initialized():  # the group the CLI joined
            dist.destroy_process_group()
    return {"phases": {phase: {"history": res.history, "val": res.val_metrics,
                               "test": res.test_metrics} for phase, res in results.items()},
            "processes": process_count(),
            "run_dirs": sorted(p.name for p in Path(payload["exp_dir"]).iterdir())}


def _main() -> None:
    scenario, rank, world, run = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    group = sys.argv[5] == "1"
    torch.set_num_threads(1)
    from maestro_tpu_torch.parallel.distributed import initialize_distributed

    if group:
        initialize_distributed("cpu", init_method=f"file://{run / 'store'}", world_size=world,
                               rank=rank)
    payload = torch.load(run / "payload.pt", weights_only=False)
    payload["run"] = str(run)
    result = globals()[f"scenario_{scenario}"](payload, rank, world)
    result["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "maestro_tpu."))
                               for m in sys.modules)
    torch.save(result, run / f"rank{rank}.pt")
    if group:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
