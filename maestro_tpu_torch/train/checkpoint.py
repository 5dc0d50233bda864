"""Checkpointing with the reference's dual restore semantics.

Reference (maestro/hydra_utils.py:17-48 + run_experiment.py:66-121):
``load_*`` = warm-start weights only (strict=False: missing or extra
parameters are tolerated — this is how cross-dataset transfer re-binds a
pretrained trunk onto a new dataset's patch embeds via ``name_embed``
aliasing) vs ``fit_*`` = full train-state resume (parameters, optimizer
state, step).

A checkpoint is a directory ``{phase}-epoch={N}`` holding ``state/`` (one
``torch.save`` payload, ``state/payload.pt``) and ``meta.json``; the latest
epoch is found by sort, as the reference's glob convention has it.  The
payload holds the parameters by name, the AdamW moments by parameter name,
the step, the optimizer's update and accumulation counts (and its MultiSteps
accumulator), the ``skip_nonfinite`` guard's counters, and the EMA weights.
It is read back with ``torch.load(weights_only=True)``.  Every save is
staged next to the old state and committed by one rename, so
``find_latest_checkpoint`` never sees a partial save.

Under FSDP or tensor parallelism (``state.parallel``) every tensor is saved
whole, in the same layout as one process saves it: every rank enters the
gather (a collective), then process 0 alone writes the payload and
``meta.json``.  A restore reads the whole tensors and keeps this rank's
pieces, so a checkpoint written under one mesh loads under any other and
in one process.
"""

from __future__ import annotations

import json
import re
import shutil
import threading
import time
from dataclasses import fields
from pathlib import Path
from typing import Any

import torch

from maestro_tpu_torch.parallel.mesh import local, resharded

PAYLOAD = "payload.pt"


# --------------------------------------------------------------------------
# the payload: everything a resume needs, by name
# --------------------------------------------------------------------------
def _payload(state) -> dict[str, Any]:
    """The state's tensors and counters as nested dicts (tensors are the live
    ones: copy before the next step changes them).  With ``state.parallel``
    each tensor is gathered whole: a collective, entered by every rank."""
    model, tx, par = state.model, state.tx, state.parallel
    named = list(resharded(model).named_parameters())

    def whole(name: str, t: torch.Tensor) -> torch.Tensor:
        return t if par is None or t.ndim == 0 else par.full_tensor(name, t)

    payload: dict[str, Any] = {
        "params": {name: whole(name, p.detach()) for name, p in named},
        "step": int(state.step),
    }
    if tx is not None:
        name_of = {id(p): name for name, p in named}
        moments = {
            name_of[id(p)]: {k: whole(name_of[id(p)], v) for k, v in st.items()
                             if torch.is_tensor(v)}
            for p, st in tx.adamw.state.items()
        }
        trained = [name_of[id(p)] for p in tx._params()]
        payload["opt_state"] = {
            "moments": moments,
            "n_updates": int(tx.n_updates),
            "mini_step": int(tx.mini_step),
            "acc": None if tx._acc is None else {
                n: whole(n, a) for n, a in zip(trained, tx._acc)},
            "guard": None if tx.guard is None else {
                f.name: getattr(tx.guard, f.name) for f in fields(tx.guard)},
        }
    if state.ema is not None:
        payload["ema_params"] = {n: whole(n, t) for n, t in state.ema.items()}
    return payload


def _writes(state) -> bool:
    """Whether this process writes the checkpoint (process 0 of a parallel
    run; any process of an unparallel one)."""
    if state.parallel is None:
        return True
    from maestro_tpu_torch.parallel.distributed import is_primary

    return is_primary()


def _map_tensors(tree, fn, key=()):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn, key + (k,)) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return fn(key, tree)
    return tree


def _write(path: Path, payload: dict[str, Any]) -> None:
    """Stage the payload in ``path/state.new``, then replace ``path/state``
    by one rename (an old state is removed only once the new one is whole)."""
    staging = path / "state.new"
    if staging.exists():
        shutil.rmtree(staging)
    staging.mkdir(parents=True)
    torch.save(payload, staging / PAYLOAD)
    _staged_overwrite(path, staging)


def _staged_overwrite(path: Path, staging: Path) -> None:
    """Swap a fully written ``staging`` directory in as ``path/state``,
    leaving at most a rename-length gap without a state."""
    old = path / "state"
    if old.exists():
        shutil.rmtree(old)
    staging.rename(old)


def _write_meta(path: Path, extra: dict[str, Any] | None) -> None:
    """meta.json next to the state dir."""
    if extra:
        path.mkdir(parents=True, exist_ok=True)
        (path / "meta.json").write_text(json.dumps(extra, default=str))


def save_checkpoint(
    ckpt_dir: str | Path,
    phase: str,
    epoch: int,
    state,
    extra: dict[str, Any] | None = None,
) -> Path:
    """Write a checkpoint synchronously (the loop waits for the disk)."""
    path = Path(ckpt_dir).absolute() / f"{phase}-epoch={epoch}"
    payload = _map_tensors(_payload(state), lambda _, t: t.detach().to("cpu", copy=True))
    if not _writes(state):
        return path
    _write(path, payload)
    _write_meta(path, extra)
    return path


def save_weights(
    ckpt_dir: str | Path,
    phase: str,
    epoch: int,
    params: dict[str, torch.Tensor],
    extra: dict[str, Any] | None = None,
) -> Path:
    """Write a weights-only checkpoint: ``params`` by parameter name at step 0,
    no optimizer state (the ported releases of ``scripts/port_checkpoint`` and
    ``scripts/port_fm``).  ``load_weights`` warm-starts from it."""
    path = Path(ckpt_dir).absolute() / f"{phase}-epoch={epoch}"
    payload = {"params": {n: t.detach().to("cpu", copy=True) for n, t in params.items()},
               "step": 0}
    _write(path, payload)
    _write_meta(path, extra)
    return path


class AsyncSaver:
    """Non-blocking epoch checkpoints.

    ``save`` takes its copy of the state before it returns, because the
    port's optimizer updates parameters and moments in place: for CUDA
    tensors, copies into pinned host buffers are queued on a side stream
    after the work already queued on the current stream, and the current
    stream then waits on their event, so the next step cannot change a
    tensor before it is copied; CPU tensors are cloned.  A background thread
    waits for the copies and writes the payload (staged, then one rename)
    and meta.json.  The pinned buffers are kept and reused by the next save,
    which first waits for the previous write to end.  Call ``wait`` before
    restoring a just-saved path (test-on-best, preemption) and at phase
    end.  Per save, ``blocked_s`` records how long the caller was held, of
    which ``waited_s`` went to waiting for the previous write, and
    ``background_s`` how long the write took; ``end_wait_s`` records each
    ``wait`` that found a write still running."""

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._buffers: dict[tuple, torch.Tensor] = {}
        self._stream = None
        self.blocked_s: list[float] = []
        self.waited_s: list[float] = []
        self.background_s: list[float] = []
        self.end_wait_s: list[float] = []

    def _copy(self, key: tuple, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t.detach().clone()
        buf = self._buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buffers[key] = buf
        buf.copy_(t.detach(), non_blocking=True)
        return buf

    def save(
        self,
        ckpt_dir: str | Path,
        phase: str,
        epoch: int,
        state,
        extra: dict[str, Any] | None = None,
    ) -> Path:
        path = Path(ckpt_dir).absolute() / f"{phase}-epoch={epoch}"
        t0 = time.perf_counter()
        self._join()  # the previous write still reads the pinned buffers
        self.waited_s.append(time.perf_counter() - t0)
        live = _payload(state)
        if not _writes(state):
            self.blocked_s.append(time.perf_counter() - t0)
            return path
        event = None
        device = next((p.device for p in state.model.parameters()), torch.device("cpu"))
        if device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            current = torch.cuda.current_stream(device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                payload = _map_tensors(live, self._copy)
                event = self._stream.record_event()
            current.wait_event(event)
        else:
            payload = _map_tensors(live, self._copy)
        self._thread = threading.Thread(
            target=self._persist, args=(path, payload, event, extra), daemon=True,
        )
        self._thread.start()
        self.blocked_s.append(time.perf_counter() - t0)
        return path

    def _persist(self, path: Path, payload, event, extra) -> None:
        t0 = time.perf_counter()
        try:
            if event is not None:
                event.synchronize()
            _write(path, payload)
            _write_meta(path, extra)
        except BaseException as exc:  # noqa: BLE001 - re-raised by wait()
            self._error = exc
        self.background_s.append(time.perf_counter() - t0)

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self) -> None:
        """Block until the last write is on disk (raises its error)."""
        running = self._thread is not None and self._thread.is_alive()
        t0 = time.perf_counter()
        self._join()
        if running:
            self.end_wait_s.append(time.perf_counter() - t0)

    def close(self) -> None:
        self.wait()
        self._buffers.clear()


# --------------------------------------------------------------------------
# discovery
# --------------------------------------------------------------------------
def find_latest_checkpoint(ckpt_dir: str | Path, phase: str) -> Path | None:
    """Latest ``{phase}-epoch=N`` checkpoint under a directory tree."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    pattern = re.compile(rf"{re.escape(phase)}-epoch=(\d+)$")
    candidates = []
    for p in ckpt_dir.rglob(f"{phase}-epoch=*"):
        m = pattern.search(p.name)
        if m and (p / "state").exists():
            candidates.append((int(m.group(1)), p))
    if not candidates:
        return None
    return max(candidates)[1]


def load_meta(path: str | Path) -> dict[str, Any]:
    """The ``extra`` dict saved next to a checkpoint (empty if absent)."""
    meta = Path(path) / "meta.json"
    if not meta.exists():
        return {}
    return json.loads(meta.read_text())


def checkpoint_epoch(path: str | Path) -> int | None:
    """Epoch of a ``{phase}-epoch=N`` checkpoint directory.

    Prefers meta.json, falling back to the directory name: meta is written
    after the state commit, so a crash in that window must not make a resume
    silently restart at epoch 0 on top of restored optimizer state.
    """
    meta = load_meta(path)
    if "epoch" in meta:
        return int(meta["epoch"])
    m = re.search(r"-epoch=(\d+)$", Path(path).name)
    return int(m.group(1)) if m else None


# --------------------------------------------------------------------------
# restore
# --------------------------------------------------------------------------
def _load(path: str | Path) -> dict[str, Any]:
    return torch.load(Path(path).absolute() / "state" / PAYLOAD, map_location="cpu",
                      weights_only=True)


@torch.no_grad()
def restore_state(path: str | Path, state):
    """Full restore into an existing TrainState (fit_* resume, test-on-best):
    parameters, moments, step, the optimizer's counts and accumulator, the
    non-finite guard and the EMA weights, each onto its tensor's device.
    Strict: a parameter the checkpoint lacks, or one of another shape,
    raises."""
    saved = _load(path)
    params = dict(resharded(state.model).named_parameters())
    par = state.parallel

    def piece(name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole saved tensor, on its parameter's device."""
        t = t if par is None or t.ndim == 0 else par.local_piece(name, t)
        return t.to(params[name].device, copy=True)

    def like(name: str, t: torch.Tensor) -> torch.Tensor:
        """``piece`` in the form the optimizer keeps: FSDP's AdamW holds
        DTensors, the guarded update this rank's pieces."""
        t = piece(name, t)
        p = params[name]
        if t.ndim == 0 or not hasattr(p, "device_mesh") or tx.skip_nonfinite:
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, p.device_mesh, p.placements, shape=p.shape,
                                  stride=p.stride())

    missing = sorted(set(params) - set(saved["params"]))
    wrong = [n for n, p in params.items()
             if n in saved["params"] and piece(n, saved["params"][n]).shape != local(p).shape]
    if missing or wrong:
        msg = (f"restore_state: {path} does not match the model (missing {missing[:5]}, "
               f"shape mismatches {wrong[:5]})")
        raise KeyError(msg)
    for name, p in params.items():
        local(p).copy_(piece(name, saved["params"][name]))
    state.step = int(saved["step"])
    tx = state.tx
    if tx is not None:
        opt = saved["opt_state"]
        tx.adamw.state.clear()
        for name, moments in opt["moments"].items():
            tx.adamw.state[params[name]] = {
                # AdamW's own step count stays where torch keeps it (the CPU)
                k: v.clone() if k == "step" else like(name, v)
                for k, v in moments.items()
            }
        tx.n_updates, tx.mini_step = int(opt["n_updates"]), int(opt["mini_step"])
        name_of = {id(p): n for n, p in params.items()}
        tx._acc = None if opt["acc"] is None else [
            like(name_of[id(p)], opt["acc"][name_of[id(p)]]) for p in tx._params()]
        if opt["guard"] is None:
            tx.guard = None
        else:
            from maestro_tpu_torch.train.optim import NonFiniteGuard

            device = next(iter(params.values())).device
            tx.guard = NonFiniteGuard(**{k: v.to(device, copy=True)
                                         for k, v in opt["guard"].items()})
    if state.ema is not None and "ema_params" in saved:
        state.ema = {n: piece(n, v) for n, v in saved["ema_params"].items()}
    return state


def load_weights(path: str | Path, params, unmatched_out: list | None = None):
    """strict=False weight warm start of ``params`` (a module, or a dict of
    its parameters by name): copy the parameters whose name and shape match,
    keep the rest at their current (fresh) values — the reference's
    load_from_checkpoint strict=False behaviour (run_experiment.py:66-74).
    ``unmatched_out`` collects the names of the parameters that kept their
    fresh values."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    _merge_matching(_load(path)["params"], params, unmatched_out)
    return params


def load_ema_weights(path: str | Path, model,
                     unmatched_out: list | None = None) -> dict[str, torch.Tensor] | None:
    """EMA weights from a checkpoint, by parameter name, merged onto copies
    of the model's current parameters (strict=False).  None when the
    checkpoint stores no EMA weights (pretrain / use_ema=false runs)."""
    ema = _load(path).get("ema_params")
    if ema is None:
        return None
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    _merge_matching(ema, out, unmatched_out)
    return out


@torch.no_grad()
def _merge_matching(saved: dict, params: dict, unmatched_out: list | None) -> None:
    """Copy saved tensors onto ``params`` in place where name AND shape
    agree (cast to each parameter's dtype); the others keep their values."""
    for name, p in params.items():
        sv = saved.get(name)
        if sv is not None and sv.shape == p.shape:
            p.copy_(sv)
        elif unmatched_out is not None:
            unmatched_out.append(name)
