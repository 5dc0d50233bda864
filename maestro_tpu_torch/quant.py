"""Post-training int8 quantization for serving (beyond the reference).

The counterpart of the JAX package's ``quant.py``: standard w8a8 PTQ.

* :func:`quantize_params` — symmetric per-output-channel quantization of the
  transformer ``nn.Linear`` weights, chosen by their flax paths
  (``port.from_jax.flax_path``) exactly as the JAX package chooses its
  ``nn.Dense`` kernels: ``DENSE_NAMES`` and auto-named ``Dense_*``, both
  dimensions at least ``min_dim``, nothing under ``skip_prefixes`` (the task
  heads).  It returns a copy of the model in which each chosen layer is a
  :class:`QuantLinear` holding an int8 ``weight`` ``[out, in]`` and an fp32
  ``weight_scale`` ``[out]`` (flax: ``kernel`` and ``kernel_scale``), both
  parameters without gradient.  Biases, norms, patch / positional
  embeddings and the heads stay in full precision.
* :func:`quant_linear` — the int8 product that ``models/vit.py::dense``
  takes for every layer carrying a ``weight_scale`` (the MAE's blocks and
  the baseline adapters' alike), and that a :class:`QuantLinear` called
  directly takes too (DOFA's weight generator calls its layers so), as the
  JAX package's interceptor catches every call of a quantized
  ``nn.Dense``: per-token activation scales ``max|x|/127``
  (floored at 1e-8), round half to even, clip to ±127, int8 x int8 with
  int32 accumulation (``torch._int_mm``, a library GEMM: this module
  replaces no Pallas kernel), then ``y * s_x * s_w`` in fp32, the fp32 bias,
  and a cast to the compute dtype.  On the card ``_int_mm`` takes more than
  16 rows and K and N that are multiples of 8: a product of fewer rows (a
  short stream, a request of batch 1) is padded with zero rows and cut
  back; in an artifact with a symbolic batch, so is every product whose
  rows a sample number 16 or fewer.
* :func:`make_quant_predict_fn` / :func:`make_quant_embed_fn` — the
  serving functions for a quantized model: ``serve.make_predict_fn`` and
  ``serve.make_embed_fn``, nothing added.  The int8 route keys on the
  layers' scales, so an unquantized model runs unchanged through them; they
  compose with ``serve.export_predict`` (the artifact keeps the int8
  products).

Tensor-parallel layers (``row_dense`` under a group) are not quantized:
serving runs on one device.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import torch
from torch import nn

# the flax module names that are nn.Dense everywhere in the JAX package (exact
# matches, so the patch projections proj0 / proj1 ... stay in full precision)
DENSE_NAMES = frozenset(
    {"qkv", "out", "fc1", "fc2", "to_kv", "to_q", "to_k", "to_v", "proj"},
)
_EPS = 1e-8
MIN_ROWS = 16  # torch._int_mm on the card needs more rows than this


def _quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[out, in]`` weight -> (int8 ``[out, in]``, fp32 scale ``[out]``),
    symmetric, in the JAX package's fp32 arithmetic."""
    w = w.detach().float()
    scale = torch.clamp_min(w.abs().amax(dim=1) / 127.0, _EPS)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_params(
    model: nn.Module,
    min_dim: int = 32,
    skip_prefixes: tuple[str, ...] = ("heads_",),
) -> nn.Module:
    """A copy of ``model`` with its transformer ``nn.Linear`` weights in int8
    (``model`` itself is left as it is).  ``min_dim`` skips small projections
    where quantization saves nothing; ``skip_prefixes`` excludes layers any
    component of whose flax path starts with one of them."""
    from maestro_tpu_torch.port.from_jax import flax_path

    qmodel = copy.deepcopy(model)
    for name, layer in list(qmodel.named_modules()):
        if not isinstance(layer, nn.Linear) or not name:
            continue
        path, _ = flax_path(qmodel, f"{name}.weight")
        owner = path[-2]
        if any(p.startswith(skip_prefixes) for p in path[:-1]):
            continue
        if not (owner in DENSE_NAMES or owner.startswith("Dense_")):
            continue
        if min(layer.weight.shape) < min_dim:
            continue
        q, scale = _quantize_weight(layer.weight)
        layer.weight = nn.Parameter(q, requires_grad=False)
        layer.weight_scale = nn.Parameter(scale, requires_grad=False)
        layer.__class__ = QuantLinear
    return qmodel


class QuantLinear(nn.Linear):
    """An ``nn.Linear`` that :func:`quantize_params` made int8: called
    directly, it takes :func:`quant_linear` in the input's dtype."""

    weight_scale: nn.Parameter

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_linear(x, self.weight, self.weight_scale, self.bias, x.dtype)


def quant_linear(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                 bias: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W.T + b`` through int8: ``w_q [out, in]`` int8 with its scale
    ``s_w [out]``; the result in ``dtype``."""
    xf = x.float()
    s_x = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, _EPS)
    x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    rows = x_q.reshape(-1, x_q.shape[-1])
    m = rows.shape[0]
    # a symbolic (batch) row count is at least the rows of one sample
    least = m if isinstance(m, int) else math.prod(x_q.shape[1:-1])
    if not isinstance(least, int) or least <= MIN_ROWS:
        rows = torch.cat([rows, rows.new_zeros((MIN_ROWS + 1, rows.shape[1]))])
    y = torch._int_mm(rows, w_q.t())[:m].reshape(*x_q.shape[:-1], w_q.shape[0])
    y = y.float() * s_x * s_w
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def make_quant_predict_fn(model, phase: str = "finetune") -> Callable:
    """``serve.make_predict_fn`` itself: the int8 route keys on the layers'
    scales (``models/vit.py::dense``, :class:`QuantLinear`), so a model from
    :func:`quantize_params` serves int8 and any other its fp path."""
    from maestro_tpu_torch.serve import make_predict_fn

    return make_predict_fn(model, phase)


def make_quant_embed_fn(model) -> Callable:
    """``serve.make_embed_fn`` itself (the retrieval path), as
    :func:`make_quant_predict_fn` is ``make_predict_fn``."""
    from maestro_tpu_torch.serve import make_embed_fn

    return make_embed_fn(model)
