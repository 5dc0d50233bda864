"""Activation recompute in the port: the ``trainer.remat`` modes of the
transformer blocks (models/vit.py, the JAX package's ``Transformer.remat``)
and the seg head's per-chunk recompute (models/heads.py, the JAX package's
remat-scan over chunks) give the gradients that the same model gives without
them, and keep less for the backward.

Both sides are the port's, on the CPU, at the test-only ``micro`` size: the
same weights (one seed), batch and masks, with and without the recompute.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from maestro_tpu_torch.conf import DatasetsConfig, MaskConfig, ModelConfig
from maestro_tpu_torch.models import heads as TH
from maestro_tpu_torch.models import mae as TM
from maestro_tpu_torch.models.mae import build_model
from maestro_tpu_torch.serve import batch_to_device
from maestro_tpu_torch.train.losses import prediction_losses
from maestro_tpu_torch.train.steps import pretrain_loss_fn
from maestro_tpu_torch.utils.testing import make_synthetic_batch

from _torch_port_utils import single_thread_torch, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

BATCH = 2
GRAD_TOL = 1e-4  # of each leaf's max |grad|, as the parity tests take it
CPU = torch.device("cpu")


def _saved_bytes(fn, held=()) -> tuple[torch.Tensor, int]:
    """``fn()`` and the bytes of the distinct storages autograd saved for the
    backward outside any recomputed region (a recomputed region keeps its
    inputs only), those of the tensors ``held`` (alive anyway) left out."""
    storages = {}
    skip = {t.untyped_storage().data_ptr() for t in held}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            storages[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(storages.values())


def _grads(model, fn) -> tuple[float, dict[str, np.ndarray], int]:
    model.zero_grad(set_to_none=True)
    loss, saved = _saved_bytes(fn)
    loss.backward()
    return loss.item(), {n: to_np(p.grad) for n, p in model.named_parameters()
                         if p.grad is not None}, saved


def _assert_same_grads(got: dict, want: dict) -> None:
    assert got.keys() == want.keys() and len(want) > 20
    for name, w in want.items():
        err = np.abs(got[name] - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), f"{name}: max abs err {err:.3e}"


def _pretrain(remat):
    ds = DatasetsConfig(name_dataset="treesatai_ts")
    model, plan = build_model(
        ds, MaskConfig(), ModelConfig(model_size="micro", fusion_mode="group", inter_depth=1),
        dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(4),
        remat=remat)
    batch = batch_to_device(model, make_synthetic_batch(ds.dataset, BATCH, seed=5), CPU)
    loss_fn = pretrain_loss_fn(model, plan, "l1_norm")
    return model, lambda: loss_fn(batch, torch.Generator().manual_seed(6))


@pytest.mark.parametrize("remat", [True, "full", "dots", "gelu", "mlp", "other"])
def test_remat_modes_keep_the_gradients(remat):
    """The pretrain loss and every gradient leaf with each mode as without
    one (encoders, trunk and decoders all recompute); each mode saves less
    for the backward, and a value the reference does not know saves the
    same (its ``else``: no recompute)."""
    model, fn = _pretrain(False)
    want_loss, want, want_saved = _grads(model, fn)
    model, fn = _pretrain(remat)
    got_loss, got, saved = _grads(model, fn)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    _assert_same_grads(got, want)
    trunk = model.encoder_inter
    if remat == "other":
        assert trunk.remat_blocks is None and trunk.block0.remat_mlp is False
        assert saved == want_saved
    else:
        assert trunk.remat_blocks in ("full", "dots", None)
        assert saved < want_saved


def _finetune(monkeypatch, fused: bool):
    """A PASTIS-HD finetune model (several chunks of ref rows) and its loss;
    ``fused`` widens ``micro`` to E = 128 so the head's pool takes the fused
    pool's path."""
    size = "micro"
    if fused:
        size = "micro128"
        monkeypatch.setitem(TM.MAE_ARCHS, size,
                            dataclasses.replace(TM.MAE_ARCHS["micro"], embed_dim=128, dim_head=64))
    ds = DatasetsConfig(name_dataset="pastis_hd")
    model, _ = build_model(
        ds, MaskConfig(), ModelConfig(model_size=size, fusion_mode="group", inter_depth=1,
                                      seg_chunk_rows=4),
        dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(7))
    batch = batch_to_device(model, make_synthetic_batch(ds.dataset, BATCH, seed=8), CPU,
                            targets=True)
    head = model.heads["pastis_seg"]
    assert head.ref_grid // head.chunk_rows > 1

    def fn():
        model.train()
        return prediction_losses(model.head_specs, batch, model(batch, "finetune"))[0]

    return model, head, fn


@pytest.mark.parametrize("fused", [False, True], ids=["einsum_pool", "fused_pool"])
def test_seg_head_chunk_recompute_keeps_the_gradients(monkeypatch, fused):
    """The finetune loss and every gradient leaf with the seg head's chunks
    recomputed in the backward (as it always runs under autograd with more
    than one chunk) as with the chunks kept; the fused pool's chunks go
    through the pool Function that saves only out, m and den and never
    reruns the pool's forward, the others are recomputed whole.  Besides
    its inputs (the trunk's grids, alive anyway), the head saves less for
    the backward: no chunk's date-stacked grid."""
    model, head, fn = _finetune(monkeypatch, fused)
    chunks = head.ref_grid // head.chunk_rows
    pool_calls, fwd_calls, checkpoints = [], [], []
    apply, forward, ckpt = (TH._RecomputedChunkPool.apply, TH.pool_forward, TH.checkpoint)
    monkeypatch.setattr(TH._RecomputedChunkPool, "apply",
                        staticmethod(lambda *a: pool_calls.append(1) or apply(*a)))
    monkeypatch.setattr(TH, "pool_forward", lambda *a, **k: fwd_calls.append(1) or forward(*a, **k))
    monkeypatch.setattr(TH, "checkpoint", lambda *a, **k: checkpoints.append(1) or ckpt(*a, **k))
    got_loss, got, _ = _grads(model, fn)
    if fused:
        assert len(pool_calls) == len(fwd_calls) == chunks and not checkpoints
    else:
        assert len(checkpoints) == chunks and not pool_calls
    e = head.proj.weight.shape[1]
    xs = tuple(torch.randn(BATCH, d, g * g, e, requires_grad=True)
               for d, g in zip((1, 16, 4, 4), head.mod_grids))
    _, saved = _saved_bytes(lambda: head(xs), held=xs)
    monkeypatch.setattr(TH.ChunkedSegHead, "_chunk_recomputed",
                        lambda self, row0, xs, w_kv, w16: self._chunk(row0, w_kv, w16, *xs))
    want_loss, want, _ = _grads(model, fn)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    _assert_same_grads(got, want)
    _, want_saved = _saved_bytes(lambda: head(xs), held=xs)
    assert saved < want_saved / 2
    assert model.heads["pastis_seg"].reduce.query.grad.abs().max() > 0
