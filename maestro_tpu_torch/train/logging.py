"""Image and confusion-matrix logging.

Reference: maestro/train/logger.py (ImageLogger: N
input/reconstruction/target triplets per epoch; MetricsLogger: confusion-matrix
heatmaps + .npy dumps) and layers/overlay.py (segmentation overlays).
In a multi-process run the runtime gathers the rows to process 0, which
alone draws and writes (``parallel.distributed.is_primary``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

RGB_BANDS = 3


def to_display_image(x: np.ndarray) -> np.ndarray:
    """[C, H, W] float -> [3, H, W] uint8-ish float in [0, 1] for TB."""
    x = np.asarray(x, dtype=np.float32)
    if x.shape[0] >= RGB_BANDS:
        x = x[:RGB_BANDS]
    else:
        x = np.broadcast_to(x[:1], (RGB_BANDS,) + x.shape[1:])
    lo, hi = np.nanpercentile(x, 2), np.nanpercentile(x, 98)
    return np.clip((x - lo) / max(hi - lo, 1e-6), 0.0, 1.0)


def reconstruction_triplet(
    target: np.ndarray,  # [C, H, W] first sample/date of one modality
    rec: np.ndarray,
    mask: np.ndarray,  # bool same shape
) -> dict[str, np.ndarray]:
    """(input-with-holes, reconstruction-in-holes, target) images.

    Matches the reference's visualization semantics (train/model.py:160-193):
    masked pixels are zeroed in the input view; the prediction view shows the
    reconstruction only where masked.
    """
    inputs = np.where(mask, 0.0, target)
    fully_masked = mask.all(axis=0, keepdims=True)
    inputs = np.where(fully_masked, 1.0, inputs)
    preds = np.where(mask, rec, target)
    return {
        "input": to_display_image(inputs),
        "rec": to_display_image(preds),
        "target": to_display_image(target),
    }


def seg_overlay(
    image: np.ndarray,  # [C, H, W] input image
    labels: np.ndarray,  # [h, w] int class map
    num_classes: int,
    alpha: float = 0.5,
    missing_val: int = -1,
) -> np.ndarray:
    """Blend a categorical color map over the input image -> [3, H, W]."""
    base = to_display_image(image)
    h, w = base.shape[1:]
    # loader label rasters arrive as float32 (data/preprocess.py casts every
    # raster): class indices must be integers to pick colors
    lab = np.asarray(labels).astype(np.int64)
    if lab.shape != (h, w):  # nearest-resize label grid to image
        yi = (np.arange(h) * lab.shape[0] // h).clip(0, lab.shape[0] - 1)
        xi = (np.arange(w) * lab.shape[1] // w).clip(0, lab.shape[1] - 1)
        lab = lab[np.ix_(yi, xi)]
    colors = _categorical_colors(num_classes)
    overlay = colors[np.clip(lab, 0, num_classes - 1)].transpose(2, 0, 1)
    valid = (lab != missing_val)[None]
    return np.where(valid, (1 - alpha) * base + alpha * overlay, base).astype(
        np.float32,
    )


def _categorical_colors(n: int) -> np.ndarray:
    """[n, 3] distinct colors (tab20-style HSV wheel, no matplotlib needed)."""
    hues = (np.arange(n) * 0.61803398875) % 1.0
    sat = np.where(np.arange(n) % 2 == 0, 0.85, 0.55)
    val = np.where(np.arange(n) % 3 == 0, 0.95, 0.75)
    c = val * sat
    x = c * (1 - np.abs((hues * 6) % 2 - 1))
    m = val - c
    zeros = np.zeros_like(c)
    idx = (hues * 6).astype(int) % 6
    # one condition per color row, [n, 1] against the [n, 3] choices (the JAX
    # package's [n] conditions do not broadcast, so its call raises)
    rgb = np.select(
        [(idx == k)[:, None] for k in range(6)],
        [
            np.stack([c, x, zeros], -1), np.stack([x, c, zeros], -1),
            np.stack([zeros, c, x], -1), np.stack([zeros, x, c], -1),
            np.stack([x, zeros, c], -1), np.stack([c, zeros, x], -1),
        ],
    )
    return (rgb + m[:, None]).astype(np.float32)


def confusion_matrix_image(cm: np.ndarray) -> np.ndarray:
    """Row-normalized CM -> [3, C, C] heatmap image for TensorBoard."""
    cm = np.asarray(cm, dtype=np.float64)
    norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    heat = np.stack([norm, 0.2 * norm, 1.0 - norm]).astype(np.float32)
    return heat


def dump_confusion_matrix(cm: np.ndarray, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.asarray(cm))


class EpochImageLogger:
    """Log N reconstruction triplets / seg overlays per epoch to TensorBoard."""

    def __init__(self, writer, log_inputs: list[str], images_per_epoch: int = 5):
        self.writer = writer
        self.log_inputs = log_inputs
        self.images_per_epoch = images_per_epoch
        self._logged = 0

    def reset(self) -> None:
        self._logged = 0

    def log_reconstruction(
        self, phase: str, stage: str, epoch: int,
        targets: dict, pixels_rec: dict, mask_pixels: dict,
        sample: int = 0,
    ) -> None:
        if self._logged >= self.images_per_epoch:
            return
        for name in self.log_inputs:
            if name not in pixels_rec:
                continue
            triplet = reconstruction_triplet(
                np.asarray(targets[name][sample, 0]),
                np.asarray(pixels_rec[name][sample, 0]),
                np.asarray(mask_pixels[name][sample, 0]),
            )
            for kind, img in triplet.items():
                self.writer.add_image(
                    f"{phase}_{stage}/{name}_{kind}_{sample}", img, epoch,
                )
        self._logged += 1

    def log_segmentation(
        self, phase: str, stage: str, epoch: int, name_target: str,
        image: np.ndarray, logits: np.ndarray, labels: np.ndarray,
        num_classes: int, missing_val: int, sample: int = 0,
    ) -> None:
        if self._logged >= self.images_per_epoch:
            return
        pred = np.argmax(np.asarray(logits), axis=0)
        self.writer.add_image(
            f"{phase}_{name_target}_{stage}/pred_{sample}",
            seg_overlay(image, pred, num_classes), epoch,
        )
        self.writer.add_image(
            f"{phase}_{name_target}_{stage}/target_{sample}",
            seg_overlay(image, np.asarray(labels), num_classes,
                        missing_val=missing_val), epoch,
        )
        self._logged += 1
