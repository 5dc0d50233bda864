"""Confusion-matrix metrics of the probe and finetune phases.

Reference: maestro/train/metric.py, as the JAX package's ``train/metrics.py``
has it.  MonoLabel (classif / segment): one C x C confusion matrix; overall
accuracy, macro F1 and mIoU averaged over the classes with support.
MultiLabel: a 2 x 2 confusion matrix per label for (weighted) F1 — the
TreeSatAI headline metric is ``weighted_f1`` — and per-label histograms of
the sigmoid scores over 4096 fixed bins, from which average precision is
taken on that threshold grid.

States are int64 tensors on the model's device, updated in place by
scatter-adds (``index_add_``), so a train step never waits on the host:
``torch.bincount`` reads its input's maximum on the host to size its output.
Invalid rows land in a bin that is dropped, or add zero.  Adding two states
is the cross-device reduction.  ``*_compute`` runs on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_AP_BINS = 4096


def monolabel_init(num_classes: int, device=None) -> dict[str, torch.Tensor]:
    return {"cm": torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)}


def monolabel_update(
    state: dict[str, torch.Tensor],
    logits: torch.Tensor | None,  # [N, C] (or None with preds)
    labels: torch.Tensor,  # [N] int
    valid: torch.Tensor,  # [N] bool
    preds: torch.Tensor | None = None,  # [N] argmax, skips the logits
) -> dict[str, torch.Tensor]:
    cm = state["cm"]
    c = cm.shape[0]
    if preds is None:
        preds = logits.argmax(dim=-1)
    cell = labels.long().clamp(0, c - 1) * c + preds.long()
    cell = torch.where(valid, cell, c * c)  # invalid rows -> a bin that is dropped
    counts = torch.zeros(c * c + 1, dtype=torch.int64, device=cm.device)
    counts.index_add_(0, cell.reshape(-1), torch.ones_like(cell.reshape(-1)))
    cm += counts[: c * c].view(c, c)
    return state


def monolabel_compute(state: dict[str, torch.Tensor]) -> dict[str, float]:
    cm = state["cm"].cpu().numpy().astype(np.float64)
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-12)
    iou = tp / np.maximum(tp + fp + fn, 1e-12)
    support = (tp + fn) > 0
    n_sup = max(int(support.sum()), 1)
    return {
        "overall_accuracy": float(np.trace(cm) / max(cm.sum(), 1e-12)),
        "average_f1": float((f1 * support).sum() / n_sup),
        "average_iou": float((iou * support).sum() / n_sup),
    }


def multilabel_init(num_labels: int, device=None) -> dict[str, torch.Tensor]:
    return {
        "cm": torch.zeros((num_labels, 2, 2), dtype=torch.int64, device=device),
        # score histograms per (label, class in {neg, pos})
        "hist": torch.zeros((num_labels, 2, NUM_AP_BINS), dtype=torch.int64, device=device),
    }


def multilabel_update(
    state: dict[str, torch.Tensor],
    logits: torch.Tensor,  # [N, K]
    labels: torch.Tensor,  # [N, K] 0/1
    valid: torch.Tensor,  # [N] bool
    threshold: float = 0.5,
) -> dict[str, torch.Tensor]:
    k = logits.shape[1]
    # 1 / (1 + exp(-x)) as the JAX package writes it (bins follow its roundings)
    scores = torch.where(valid[:, None], 1.0 / (1.0 + torch.exp(-logits.float())), -1.0)
    y = labels.long().clamp(0, 1)  # an invalid row's label may be missing_val; it adds 0
    w = valid.long()[:, None].expand(-1, k)
    pred = (scores > threshold).long()
    cm_cell = torch.arange(k, device=y.device) * 4 + y * 2 + pred  # [N, K] into [K, 2, 2]
    state["cm"].view(-1).index_add_(0, cm_cell.reshape(-1), w.reshape(-1))
    bins = (scores * NUM_AP_BINS).long().clamp(0, NUM_AP_BINS - 1)
    hist_cell = (torch.arange(k, device=y.device) * 2 + y) * NUM_AP_BINS + bins
    state["hist"].view(-1).index_add_(0, hist_cell.reshape(-1), w.reshape(-1))
    return state


def multilabel_compute(state: dict[str, torch.Tensor]) -> dict[str, float]:
    cm = state["cm"].cpu().numpy().astype(np.float64)
    tp, fp, fn = cm[:, 1, 1], cm[:, 0, 1], cm[:, 1, 0]
    weights = (tp + fn) / max((tp + fn).sum(), 1e-12)
    f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-12)
    # AP from the binned PR curve: descending-threshold cumulative counts
    hist = state["hist"].cpu().numpy().astype(np.float64)
    pos = np.cumsum(hist[:, 1, ::-1], axis=1)
    neg = np.cumsum(hist[:, 0, ::-1], axis=1)
    precision = pos / np.maximum(pos + neg, 1e-12)
    recall = pos / np.maximum(hist[:, 1].sum(axis=1), 1e-12)[:, None]
    ap = (np.diff(recall, axis=1, prepend=0.0) * precision).sum(axis=1)
    has_support = (tp + fn) > 0
    n_sup = max(int(has_support.sum()), 1)
    return {
        "average_f1": float(np.where(has_support, f1, 0.0).sum() / n_sup),
        "average_ap": float(np.where(has_support, ap, 0.0).sum() / n_sup),
        "weighted_f1": float(np.where(has_support, f1 * weights, 0.0).sum()),
        "weighted_ap": float(np.where(has_support, ap * weights, 0.0).sum()),
    }


def metric_init(type_target: str, num_classes: int, device=None) -> dict[str, torch.Tensor]:
    if type_target == "multilabel_classif":
        return multilabel_init(num_classes, device)
    return monolabel_init(num_classes, device)


def metric_update(type_target: str, state: dict[str, torch.Tensor],
                  aux: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    if type_target == "multilabel_classif":
        return multilabel_update(state, aux["logits"], aux["labels"], aux["valid"])
    return monolabel_update(state, aux.get("logits"), aux["labels"], aux["valid"],
                            preds=aux.get("preds"))


def metric_compute(type_target: str, state: dict[str, torch.Tensor]) -> dict[str, float]:
    if type_target == "multilabel_classif":
        return multilabel_compute(state)
    return monolabel_compute(state)
