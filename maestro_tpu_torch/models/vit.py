"""Transformer encoder/decoder blocks (pre-LN ViT).

Block structure mirrors the reference's encoder stack (vit_pytorch Transformer
used at reference maestro/ssl/mae.py:133-176): pre-LayerNorm attention (qkv
bias-free, output projection with bias) and pre-LayerNorm MLP with exact GELU,
residual connections, and a final LayerNorm after the last block.

Precision policy, written out cast by cast so it rounds where the JAX package
rounds (``torch.autocast`` rounds elsewhere): parameters are fp32; a dense
layer casts input, weight and bias to the compute ``dtype``; a LayerNorm takes
its statistics and affine in fp32 and casts the result; attention keeps fp32
scores and softmax (ops/attention.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from maestro_tpu_torch.ops.attention import mha_qkv
from maestro_tpu_torch.ops.attn_pool import attentive_pool
from maestro_tpu_torch.parallel.mesh import copy_to_group, gather_pieces, reduce_from_group
from maestro_tpu_torch.quant import quant_linear

LN_EPS = 1e-5


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias cast to ``dtype``; through
    int8 (``quant.quant_linear``) where ``quant.quantize_params`` gave the
    layer a ``weight_scale``."""
    scale = getattr(layer, "weight_scale", None)
    if scale is not None:
        return quant_linear(x, layer.weight, scale, layer.bias, dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def row_dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, group) -> torch.Tensor:
    """``dense`` of a layer split by input feature over the tensor-parallel
    ``group``: the partial products are summed over the group before the
    bias (``dense`` itself without a group; an int8 layer takes no group)."""
    if group is None:
        return dense(x, layer, dtype)
    if getattr(layer, "weight_scale", None) is not None:
        msg = "int8 layers (quant.quantize_params) do not run under tensor parallelism"
        raise NotImplementedError(msg)
    y = reduce_from_group(F.linear(x.to(dtype), layer.weight.to(dtype)), group)
    return y if layer.bias is None else y + layer.bias.to(dtype)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with fp32 statistics and affine, result cast to ``dtype``."""
    y = F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps)
    return y.to(dtype)


def init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """Normal(0, 1/fan_in) weight, zero bias, drawn on the CPU from
    ``generator`` so a seed gives the same weights on every device (nothing is
    drawn for a ``meta`` template, which holds shapes only)."""
    if layer.weight.is_meta:
        return
    out_f, in_f = layer.weight.shape
    w = torch.randn((out_f, in_f), generator=generator) * in_f**-0.5
    with torch.no_grad():
        layer.weight.copy_(w)
        if layer.bias is not None:
            layer.bias.zero_()


def normal_parameter(shape, generator: torch.Generator, device, std: float = 1.0) -> nn.Parameter:
    """fp32 Normal(0, std) parameter drawn on the CPU from ``generator``
    (undrawn on ``meta``)."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, device="meta"))
    return nn.Parameter((torch.randn(shape, generator=generator) * std).to(device))


class Attention(nn.Module):
    """Multi-head self-attention; inner width = heads * dim_head.  Under
    tensor parallelism (``tp``, set by ``parallel.mesh.Parallel``) the module
    holds ``heads`` of the heads: its rows of q, k and v and its columns of
    ``out``."""

    def __init__(self, dim: int, heads: int, dim_head: int, dtype: torch.dtype,
                 generator: torch.Generator, device) -> None:
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.qkv = nn.Linear(dim, inner * 3, bias=False, device=device)
        self.out = nn.Linear(inner, dim, device=device)
        init_linear(self.qkv, generator)
        init_linear(self.out, generator)
        self.tp = None  # the tensor-parallel group, if any

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        y = layer_norm(x, self.norm, self.dtype)
        if self.tp is not None:
            y = copy_to_group(y, self.tp)
        qkv = dense(y, self.qkv, self.dtype)
        # q, k, v are strided views of the fused projection (no copies), and
        # on the card its gradient arrives as one contiguous tensor
        out = mha_qkv(qkv.view(b, l, 3, self.heads, self.dim_head), self.dim_head**-0.5)
        return row_dense(out.reshape(b, l, -1), self.out, self.dtype, self.tp)


def _recompute(fn, *args, context_fn=None):
    """``fn(*args)``, its activations recomputed in the backward (saved as
    ``context_fn`` selects, where given); a plain call without autograd."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


# the 2-D products (F.linear dispatches to these): what the "dots" remat keeps,
# as the JAX package's dots_with_no_batch_dims_saveable keeps its dense layers'
# outputs; LayerNorm, GELU, the attention kernel and the rest are recomputed
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


class FeedForward(nn.Module):
    """Pre-LN MLP with exact GELU.  ``remat="gelu"`` recomputes the GELU
    and ``fc2``'s input in the backward, keeping the LayerNorm's and ``fc1``'s
    outputs (the JAX package's ``save_only_these_names("mlp_ln", "mlp_fc1")``)."""

    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype,
                 generator: torch.Generator, device, remat: bool | str = False) -> None:
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, dim, device=device)
        init_linear(self.fc1, generator)
        init_linear(self.fc2, generator)
        self.tp = None  # the tensor-parallel group: fc1 split by output, fc2 by input

    def _tail(self, h: torch.Tensor) -> torch.Tensor:
        return row_dense(F.gelu(h, approximate="none"), self.fc2, self.dtype, self.tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = layer_norm(x, self.norm, self.dtype)
        if self.tp is not None:
            y = copy_to_group(y, self.tp)
        h = dense(y, self.fc1, self.dtype)
        return _recompute(self._tail, h) if self.remat == "gelu" else self._tail(h)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(ln(x)); x + mlp(ln(x)).  With
    ``remat_mlp`` True the MLP is recomputed whole in the backward, with
    "gelu" as ``FeedForward`` says."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 dtype: torch.dtype, generator: torch.Generator, device,
                 remat_mlp: bool | str = False) -> None:
        super().__init__()
        self.remat_mlp = remat_mlp
        self.attn = Attention(dim, heads, dim_head, dtype, generator, device)
        self.mlp = FeedForward(dim, mlp_dim, dtype, generator, device,
                               remat="gelu" if remat_mlp == "gelu" else False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        if self.remat_mlp is True:
            return x + _recompute(self.mlp, x)
        return x + self.mlp(x)


class Transformer(nn.Module):
    """Stack of blocks (``block0`` .. ``block{depth-1}``) + final LayerNorm.

    ``remat`` trades activation memory for recompute in the backward, as the
    JAX package's ``Transformer.remat``:
      False        — save everything
      True/"full"  — recompute whole blocks
      "dots"       — recompute blocks but save the 2-D products' outputs
                     (LayerNorm, GELU and attention are recomputed)
      "gelu"       — in the MLPs only, recompute the GELU (save the
                     LayerNorm's and fc1's outputs)
      "mlp"        — recompute only the MLPs
    Any other value saves everything, as the reference's ``else`` does.
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dtype: torch.dtype, generator: torch.Generator,
                 device, remat: bool | str = False) -> None:
        super().__init__()
        self.depth, self.dtype = depth, dtype
        self.remat_blocks = "full" if remat in (True, "full") else "dots" if remat == "dots" else None
        remat_mlp = "gelu" if remat == "gelu" else remat == "mlp"
        for i in range(depth):
            self.add_module(
                f"block{i}",
                Block(dim, heads, dim_head, mlp_dim, dtype, generator, device,
                      remat_mlp=remat_mlp),
            )
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        context = _dots_context if self.remat_blocks == "dots" else None
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            x = block(x) if self.remat_blocks is None else _recompute(
                block, x, context_fn=context)
        return layer_norm(x, self.norm, self.dtype)


class AttentiveReduce(nn.Module):
    """Single-learned-query multi-head attention pooling.

    Reference: maestro/layers/head.py:28-63.
    [B, L, C] -> [B, C], or [B, D, L, C] -> [B, L, C] (reduce axis 1).

    The rank-4 form is layout-native for the segmentation head: the caller's
    [B, dates, positions, C] tensor is pooled over the date axis in place.
    Where the shape allows (``_use_fused_pool``) it goes through the fused
    pool of ops/attn_pool.py, forward and backward; the rank-3 classification
    pool (one position) and narrow widths take the einsum body.
    """

    def __init__(self, dim: int, heads: int, dtype: torch.dtype,
                 generator: torch.Generator, device) -> None:
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.to_kv = nn.Linear(dim, dim * 2, bias=False, device=device)
        init_linear(self.to_kv, generator)
        self.query = normal_parameter((dim,), generator, device)
        self.norm_fc = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.tp = None  # the tensor-parallel group: to_kv split by head in k and v

    def kv_weight(self) -> torch.Tensor:
        """The whole ``to_kv`` weight: under tensor parallelism gathered from
        the ranks' head pieces (the pool's kernel takes it whole), its
        gradient sliced back to this rank's piece."""
        w = self.to_kv.weight
        return w if self.tp is None else gather_pieces(w, self.tp, 0, 2)

    @staticmethod
    def kv_weight_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor | None:
        """On the card, where the fused pool multiplies the weight ``w`` in
        bf16, its bf16 copy (None on the CPU).  A caller that pools several
        chunks takes it once and hands it to each; it is not differentiable,
        and the pool sends its gradient to the fp32 weight itself."""
        return w.detach().to(torch.bfloat16) if x.is_cuda else None

    def _use_fused_pool(self, x: torch.Tensor) -> bool:
        """The fused pool serves the many-position date reduction; its tiling
        needs 128-aligned widths, >= 32 positions and >= 2 dates (the JAX
        package's gate, models/vit.py:204-224)."""
        _, d, l, e = x.shape
        return (
            l >= 32 and d >= 2 and e == self.dim and e % 128 == 0
            and e % self.heads == 0
        )

    def forward(self, x: torch.Tensor, w_kv: torch.Tensor | None = None,
                w_kv_bf16: torch.Tensor | None = None) -> torch.Tensor:
        """``w_kv`` / ``w_kv_bf16``: ``kv_weight()`` and its ``kv_weight_bf16``
        when the caller already has them."""
        squeeze = x.ndim == 3
        if squeeze:  # [B, D, C] == [B, D, 1, C] pooled over D
            x = x[:, :, None, :]
        b, d, l, _ = x.shape
        dh = self.dim // self.heads
        if w_kv is None:
            w_kv = self.kv_weight()

        if self._use_fused_pool(x):
            if w_kv_bf16 is None:
                w_kv_bf16 = self.kv_weight_bf16(x, w_kv)
            out, _, _ = attentive_pool(
                x.to(self.dtype), self.norm.weight, self.norm.bias, w_kv,
                self.query, self.heads, LN_EPS, w_kv_bf16=w_kv_bf16,
            )
            return layer_norm(out, self.norm_fc, self.dtype)

        y = layer_norm(x, self.norm, self.dtype)
        kv = F.linear(y.to(self.dtype), w_kv.to(self.dtype))
        k, v = kv.split(self.dim, dim=-1)
        k = k.reshape(b, d, l, self.heads, dh)
        v = v.reshape(b, d, l, self.heads, dh)
        q = self.query.reshape(self.heads, dh).to(self.dtype)
        logits = torch.einsum("he,bdlhe->bdlh", q.float(), k.float()) * dh**-0.5
        attn = torch.softmax(logits, dim=1).to(self.dtype)
        out = torch.einsum("bdlh,bdlhe->blhe", attn, v)
        out = out.reshape(b, l, self.dim)
        out = layer_norm(out, self.norm_fc, self.dtype)
        return out[:, 0] if squeeze else out
