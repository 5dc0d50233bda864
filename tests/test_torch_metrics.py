"""The port's metric states (``maestro_tpu_torch/train/metrics.py``: int64
confusion matrices and score histograms, scatter-added) against the JAX
package's ``train/metrics.py`` (two int32 limbs, one-hot matmuls): the states
after the same updates, and the OA / F1 / mIoU / AP computed from them."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maestro_tpu.train import metrics as JM
from maestro_tpu_torch.train import metrics as TM

from _torch_port_utils import single_thread_torch  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

VALUE_RTOL = 1e-6  # the JAX package computes in fp32 (no x64), the port in fp64


def _values_match(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(float(value), rel=VALUE_RTOL, abs=1e-7), key


def _mono_batches(num_classes: int):
    """(logits, labels, valid) updates: random rows with invalid ones, then
    one update that puts more than 2**20 counts into cell (0, 0)."""
    rng = np.random.default_rng(0)
    out = []
    for n in (37, 200):
        logits = rng.normal(size=(n, num_classes)).astype(np.float32)
        labels = rng.integers(0, num_classes, n).astype(np.int32)
        valid = rng.random(n) > 0.2
        labels[~valid] = -1  # missing_val; the update clips it, the mask drops it
        out.append((logits, labels, valid))
    n = (1 << 20) + 1234
    logits = np.zeros((n, num_classes), np.float32)
    logits[:, 0] = 1.0
    out.append((logits, np.zeros(n, np.int32), np.ones(n, bool)))
    return out


def test_monolabel_states_and_values_match_jax():
    c = 4
    state, jstate = TM.monolabel_init(c), JM.monolabel_init(c)
    for logits, labels, valid in _mono_batches(c):
        TM.monolabel_update(state, torch.from_numpy(logits), torch.from_numpy(labels),
                            torch.from_numpy(valid))
        jstate = JM.monolabel_update(jstate, jnp.asarray(logits), jnp.asarray(labels),
                                     jnp.asarray(valid))
    assert state["cm"].dtype == torch.int64
    assert state["cm"][0, 0] > 1 << 20
    np.testing.assert_array_equal(state["cm"].numpy(), JM.monolabel_cm(jstate))
    _values_match(TM.monolabel_compute(state), JM.monolabel_compute(jstate))


def test_segment_preds_path_and_dispatch_match_jax():
    """The segment path passes argmax predictions instead of logits; the
    dispatch by target type picks the same update and compute."""
    rng = np.random.default_rng(1)
    c, n = 5, 300
    preds = rng.integers(0, c, n).astype(np.int64)
    labels = rng.integers(0, c, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    aux = {"preds": preds, "labels": labels, "valid": valid}
    state = TM.metric_init("segment", c)
    TM.metric_update("segment", state, {k: torch.from_numpy(v) for k, v in aux.items()})
    jstate = JM.metric_update("segment", JM.metric_init("segment", c),
                              {k: jnp.asarray(v) for k, v in aux.items()})
    np.testing.assert_array_equal(state["cm"].numpy(), JM.monolabel_cm(jstate))
    _values_match(TM.metric_compute("segment", state), JM.metric_compute("segment", jstate))


def test_multilabel_states_and_values_match_jax():
    """Per-label 2 x 2 matrices and score histograms; rows with a missing
    label are invalid and add nothing."""
    rng = np.random.default_rng(2)
    k = 6
    state, jstate = TM.metric_init("multilabel_classif", k), JM.metric_init("multilabel_classif", k)
    for n in (33, 120):
        logits = (rng.normal(size=(n, k)) * 3).astype(np.float32)
        labels = (rng.random((n, k)) > 0.6).astype(np.int32)
        labels[:, 5] = 0  # a label without support
        valid = rng.random(n) > 0.15
        labels[~valid, 0] = -1
        aux = {"logits": logits, "labels": labels, "valid": valid}
        TM.metric_update("multilabel_classif", state, {k_: torch.from_numpy(v) for k_, v in aux.items()})
        jstate = JM.metric_update("multilabel_classif", jstate,
                                  {k_: jnp.asarray(v) for k_, v in aux.items()})
    for key in ("cm", "hist"):
        assert state[key].dtype == torch.int64
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(jstate[key]))
    assert state["hist"].sum() == state["cm"].sum()  # one bin per counted (row, label)
    _values_match(TM.metric_compute("multilabel_classif", state),
                  JM.metric_compute("multilabel_classif", jstate))
