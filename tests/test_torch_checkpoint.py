"""The port's checkpoints (``maestro_tpu_torch.train.checkpoint``), the cases
of tests/test_checkpoint.py: save and restore bit-identically (parameters,
AdamW moments, step, the optimizer's counts and MultiSteps accumulator, the
``skip_nonfinite`` guard, EMA), async equal to sync, the staged overwrite,
``find_latest_checkpoint``, ``load_weights`` strict=False with its unmatched
list, and ``checkpoint_epoch``'s fallback to the directory name."""

from __future__ import annotations

import time

import pytest
import torch
from torch import nn

from maestro_tpu_torch.conf import OptFinetuneConfig
from maestro_tpu_torch.train import checkpoint as ckpt
from maestro_tpu_torch.train.optim import make_optimizer
from maestro_tpu_torch.train.state import TrainState, ema_update


class Tiny(nn.Module):
    def __init__(self, seed: int, extra_head: bool = False):
        super().__init__()
        torch.manual_seed(seed)
        self.dense = nn.Linear(4, 8)
        heads = {"t": nn.Linear(8, 2)}
        if extra_head:
            heads["u"] = nn.Linear(8, 3)
        self.heads = nn.ModuleDict(heads)

    def forward(self, x):
        return self.heads["t"](self.dense(x)).square().sum()


def _state(seed=0, steps=3, skip_nonfinite=False, accumulate=1, extra_head=False):
    model = Tiny(seed, extra_head)
    tx = make_optimizer(OptFinetuneConfig(accumulate_grad_batches=accumulate), "finetune", 10,
                        model, skip_nonfinite=skip_nonfinite)
    state = TrainState.create(model, tx, use_ema=True)
    gen = torch.Generator().manual_seed(seed + 100)
    for _ in range(steps):
        tx.zero_grad()
        model(torch.randn(5, 4, generator=gen)).backward()
        tx.step()
        state.step += 1
    ema_update(state, 0.5)
    return state


def _tensors(state) -> dict:
    """Every tensor and counter a resume needs, flattened by name."""
    out = {f"param/{n}": p.detach().clone() for n, p in state.model.named_parameters()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, st in state.tx.adamw.state.items():
        for k, v in st.items():
            out[f"moment/{names[id(p)]}/{k}"] = torch.as_tensor(v).clone()
    out.update({f"ema/{n}": v.clone() for n, v in state.ema.items()})
    out["step"] = torch.tensor(state.step)
    out["n_updates"] = torch.tensor(state.tx.n_updates)
    out["mini_step"] = torch.tensor(state.tx.mini_step)
    for i, a in enumerate(state.tx._acc or []):
        out[f"acc/{i}"] = a.clone()
    if state.tx.guard is not None:
        for k, v in vars(state.tx.guard).items():
            out[f"guard/{k}"] = v.clone()
    return out


def _assert_identical(got, want) -> None:
    a, b = _tensors(got), _tensors(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize(("skip_nonfinite", "accumulate", "steps"),
                         [(False, 1, 3), (True, 1, 3), (False, 2, 3), (True, 2, 3)])
def test_save_restore_bit_identical(tmp_path, skip_nonfinite, accumulate, steps):
    state = _state(0, steps, skip_nonfinite, accumulate)
    path = ckpt.save_checkpoint(tmp_path, "finetune", 3, state)
    assert path.name == "finetune-epoch=3" and (path / "state" / ckpt.PAYLOAD).exists()
    fresh = _state(1, 0, skip_nonfinite, accumulate)
    restored = ckpt.restore_state(path, fresh)
    _assert_identical(restored, state)
    # the restored optimizer steps on exactly as the original does
    for s in (state, restored):
        s.tx.zero_grad()
        s.model(torch.ones(2, 4)).backward()
        s.tx.step()
    _assert_identical(restored, state)


def test_find_latest_checkpoint(tmp_path):
    state = _state()
    for epoch in (0, 2, 10):
        ckpt.save_checkpoint(tmp_path / "checkpoints", "finetune", epoch, state)
    found = ckpt.find_latest_checkpoint(tmp_path, "finetune")
    assert found is not None and found.name == "finetune-epoch=10"
    assert ckpt.find_latest_checkpoint(tmp_path, "probe") is None
    assert ckpt.find_latest_checkpoint(tmp_path / "absent", "finetune") is None


def test_load_weights_strict_false_reports_unmatched(tmp_path):
    """Warm start: matching parameters copied, the others keep their values
    and are listed (a name missing from the checkpoint, a shape that
    differs)."""
    state = _state(0)
    path = ckpt.save_checkpoint(tmp_path, "pretrain", 0, state)
    fresh = Tiny(1, extra_head=True)
    fresh.dense.bias.data = torch.zeros(8)
    with torch.no_grad():  # a shape the checkpoint does not have
        fresh.heads["t"] = nn.Linear(8, 5)
    before = {n: p.detach().clone() for n, p in fresh.named_parameters()}
    unmatched = []
    ckpt.load_weights(path, fresh, unmatched_out=unmatched)
    assert sorted(unmatched) == ["heads.t.bias", "heads.t.weight", "heads.u.bias",
                                 "heads.u.weight"]
    for n, p in fresh.named_parameters():
        want = dict(state.model.named_parameters())[n] if n.startswith("dense.") else before[n]
        assert torch.equal(p, want), n
    # a dict of some parameters loads only those
    other = Tiny(2)
    ckpt.load_weights(path, {"dense.weight": other.dense.weight})
    assert torch.equal(other.dense.weight, state.model.dense.weight)
    assert not torch.equal(other.dense.bias, state.model.dense.bias)


def test_load_ema_weights(tmp_path):
    state = _state(0)
    path = ckpt.save_checkpoint(tmp_path, "finetune", 0, state)
    ema = ckpt.load_ema_weights(path, Tiny(3))
    assert all(torch.equal(ema[n], state.ema[n]) for n in state.ema)
    state.ema = None
    path = ckpt.save_checkpoint(tmp_path, "pretrain", 0, state)
    assert ckpt.load_ema_weights(path, Tiny(3)) is None


def test_async_saver_matches_sync_and_copies_before_the_next_step(tmp_path):
    """AsyncSaver.save + wait writes what the sync path writes, with
    meta.json; the copy is taken when save returns, so a step right after it
    does not reach the checkpoint."""
    state = _state(0, 2, skip_nonfinite=True)
    want = _state(0, 2, skip_nonfinite=True)
    saver = ckpt.AsyncSaver()
    try:
        path = saver.save(tmp_path / "checkpoints", "pretrain", 2, state,
                          extra={"phase": "pretrain", "epoch": 2})
        state.tx.zero_grad()  # an in-place step while the write may be running
        state.model(torch.ones(2, 4)).backward()
        state.tx.step()
        saver.wait()
    finally:
        saver.close()
    assert len(saver.blocked_s) == len(saver.background_s) == 1
    assert ckpt.load_meta(path) == {"phase": "pretrain", "epoch": 2}
    assert ckpt.find_latest_checkpoint(tmp_path, "pretrain") == path
    sync = ckpt.save_checkpoint(tmp_path / "sync", "pretrain", 2, want)
    _assert_identical(ckpt.restore_state(path, _state(5, 0, skip_nonfinite=True)),
                      ckpt.restore_state(sync, _state(6, 0, skip_nonfinite=True)))
    _assert_identical(ckpt.restore_state(path, _state(5, 0, skip_nonfinite=True)), want)


def test_async_saver_sequential_epochs(tmp_path):
    state = _state()
    saver = ckpt.AsyncSaver()
    try:
        for epoch in range(3):
            saver.save(tmp_path / "checkpoints", "probe", epoch, state)
        saver.wait()
    finally:
        saver.close()
    found = ckpt.find_latest_checkpoint(tmp_path, "probe")
    assert found is not None and found.name == "probe-epoch=2"


def test_async_saver_blocked_time_counts_the_wait(tmp_path, monkeypatch):
    """A save made while the previous write runs holds the caller until that
    write ends: ``blocked_s`` counts the wait (``waited_s`` is its part), and
    a ``wait`` that finds a write running is recorded in ``end_wait_s``."""
    write = ckpt._write

    def slow_write(*args):
        time.sleep(0.4)
        write(*args)

    monkeypatch.setattr(ckpt, "_write", slow_write)
    state = _state()
    saver = ckpt.AsyncSaver()
    try:
        for epoch in range(2):
            saver.save(tmp_path, "probe", epoch, state)
        saver.wait()
        saver.wait()  # nothing running: not recorded
    finally:
        saver.close()
    assert saver.waited_s[0] < 0.2 <= saver.waited_s[1] <= saver.blocked_s[1]
    assert len(saver.end_wait_s) == 1 and saver.end_wait_s[0] >= 0.2
    assert len(saver.background_s) == 2 and min(saver.background_s) >= 0.4


def test_overwrite_save_is_staged(tmp_path):
    """Saving onto an existing checkpoint path replaces the state whole and
    leaves no staging directory (sync and async)."""
    path = ckpt.save_checkpoint(tmp_path, "finetune", 0, _state(0))
    state2 = _state(9)
    assert ckpt.save_checkpoint(tmp_path, "finetune", 0, state2) == path
    assert not (path / "state.new").exists()
    _assert_identical(ckpt.restore_state(path, _state(1, 0)), state2)
    state3 = _state(11)
    saver = ckpt.AsyncSaver()
    try:
        saver.save(tmp_path, "finetune", 0, state3)
        saver.wait()
    finally:
        saver.close()
    assert not (path / "state.new").exists()
    _assert_identical(ckpt.restore_state(path, _state(1, 0)), state3)


def test_restore_is_strict(tmp_path):
    path = ckpt.save_checkpoint(tmp_path, "finetune", 0, _state(0))
    bigger = _state(0, 0, extra_head=True)
    with pytest.raises(KeyError, match="heads.u"):
        ckpt.restore_state(path, bigger)


def test_checkpoint_epoch_falls_back_to_dirname(tmp_path):
    path = ckpt.save_checkpoint(tmp_path, "pretrain", 5, _state(),
                                extra={"epoch": 5, "phase": "pretrain"})
    assert ckpt.checkpoint_epoch(path) == 5  # meta present
    (path / "meta.json").unlink()
    assert ckpt.load_meta(path) == {}
    assert ckpt.checkpoint_epoch(path) == 5  # dir-name fallback
    assert ckpt.checkpoint_epoch(tmp_path / "not-a-checkpoint") is None
