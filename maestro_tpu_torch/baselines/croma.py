"""CROMA baseline adapter (SAR and optical encoders + cross-attention).

The port of the JAX package's ``baselines/croma.py`` (reference
baselines/croma.py:19-775).  Patch-8 ViTs with a 2-D ALiBi attention bias
(distance-based, per-head slopes): the S2 encoder at full depth over 12
optical channels (the dataset's 10 S2 bands are expanded by duplicating band
9 twice, croma.py:289), the S1 encoder at half depth over 2 SAR channels with
the ascending and descending stacks concatenated on the date axis
(croma.py:284), and a half-depth cross-attention joint encoder.  Fusion
modes: "late-croma" (per-modality features) and "inter-croma" (joint tokens
appended as a pseudo-modality, under the features' ``"joint"`` key).

The attention adds a bias, which no Pallas tier of the JAX package takes
(it is XLA einsums there), so it stays plain PyTorch math here: fp32 scores
of the compute-dtype q and k, softmax of scores + bias, probabilities
rounded to the compute dtype before P·V.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maestro_tpu_torch.baselines.backbone import layer_norm_module, linear, patchify
from maestro_tpu_torch.baselines.base import BaselineShell, build_baseline_plan
from maestro_tpu_torch.conf.core import BaselineConfig
from maestro_tpu_torch.conf.datasets import DatasetsConfig
from maestro_tpu_torch.models.vit import LN_EPS, dense, layer_norm
from maestro_tpu_torch.ops.posenc import encode_dates

CROMA_ARCHS = {
    # "micro" is a test-only size for fast CPU tests; not a CROMA release
    "micro": (64, 2, 2),
    "base": (768, 12, 16),
    "large": (1024, 24, 16),
}
OPTICAL_CHANNELS = 12
JOINT = "joint"  # the features' key of the inter-croma joint tokens


def alibi_slopes(num_heads: int) -> list[float]:
    def power_of_2(n: int) -> list[float]:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * start**i for i in range(n)]

    if math.log2(num_heads).is_integer():
        return power_of_2(num_heads)
    closest = 2 ** math.floor(math.log2(num_heads))
    return power_of_2(closest) + alibi_slopes(2 * closest)[0::2][: num_heads - closest]


def get_2d_alibi(num_heads: int, grid: int) -> np.ndarray:
    """[1, H, L, L] negative-distance bias (reference croma.py:480-511)."""
    ys, xs = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    pts = np.stack([ys.ravel(), xs.ravel()], axis=1).astype(np.float64)
    dist = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1))
    slopes = np.asarray(alibi_slopes(num_heads))[:, None, None]
    return (-dist[None] * slopes)[None].astype(np.float32)


def biased_attention(q, k, v, bias, dtype):
    """``[B, H, L, dh]`` q, k, v -> ``[B, L, H*dh]``: softmax(q·kᵀ·dh^-0.5 +
    bias)·v with fp32 scores and softmax, P in ``dtype``."""
    b, h, l, dh = q.shape
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * dh**-0.5
    attn = torch.softmax(logits + bias, dim=-1).to(dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(b, l, h * dh)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, c = x.shape
    return x.reshape(b, l, heads, c // heads).transpose(1, 2)


class BiasedSelfAttention(nn.Module):
    """Pre-LN self-attention with an additive attention bias, qkv bias-free."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.norm = layer_norm_module(dim, device, LN_EPS)
        self.qkv = linear(dim, dim * 3, generator, device, bias=False)
        self.out = linear(dim, dim, generator, device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        y = layer_norm(x, self.norm, self.dtype)
        q, k, v = (_heads(t, self.heads) for t in dense(y, self.qkv, self.dtype).chunk(3, -1))
        return dense(biased_attention(q, k, v, bias, self.dtype), self.out, self.dtype)


class BiasedCrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.norm = layer_norm_module(dim, device, LN_EPS)
        self.to_q = linear(dim, dim, generator, device, bias=False)
        self.to_k = linear(dim, dim, generator, device, bias=False)
        self.to_v = linear(dim, dim, generator, device, bias=False)
        self.out = linear(dim, dim, generator, device)

    def forward(self, x, context, bias):
        xq, ctx = layer_norm(x, self.norm, self.dtype), layer_norm(context, self.norm, self.dtype)
        q = _heads(dense(xq, self.to_q, self.dtype), self.heads)
        k = _heads(dense(ctx, self.to_k, self.dtype), self.heads)
        v = _heads(dense(ctx, self.to_v, self.dtype), self.heads)
        return dense(biased_attention(q, k, v, bias, self.dtype), self.out, self.dtype)


class CromaFFN(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        self.dtype = dtype
        self.norm = layer_norm_module(dim, device, LN_EPS)
        self.fc1 = linear(dim, dim * 4, generator, device)
        self.fc2 = linear(dim * 4, dim, generator, device)

    def forward(self, x):
        y = dense(layer_norm(x, self.norm, self.dtype), self.fc1, self.dtype)
        return dense(F.gelu(y, approximate="none"), self.fc2, self.dtype)


class CromaViT(nn.Module):
    """Patch-8 linear embed + ALiBi transformer (no CLS, no pos embed)."""

    def __init__(self, dim: int, depth: int, heads: int, in_chans: int, dtype: torch.dtype,
                 generator: torch.Generator, device, patch_size: int = 8) -> None:
        super().__init__()
        self.depth, self.patch_size, self.dtype = depth, patch_size, dtype
        self.embed = linear(in_chans * patch_size**2, dim, generator, device)
        for i in range(depth):
            self.add_module(f"attn{i}", BiasedSelfAttention(dim, heads, dtype, generator, device))
            self.add_module(f"ffn{i}", CromaFFN(dim, dtype, generator, device))
        self.norm = layer_norm_module(dim, device, LN_EPS)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        tokens = dense(patchify(x, self.patch_size), self.embed, self.dtype)
        for i in range(self.depth):
            tokens = tokens + getattr(self, f"attn{i}")(tokens, bias)
            tokens = tokens + getattr(self, f"ffn{i}")(tokens)
        return layer_norm(tokens, self.norm, self.dtype)


class CromaBaseline(BaselineShell):
    """CROMA adapter with late / inter fusion."""

    def __init__(self, plan, head_specs, *, backbone_size: str = "base",
                 fusion_mode_croma: str = "inter-croma", generator: torch.Generator, device,
                 **shell) -> None:
        dim, depth, heads = CROMA_ARCHS[backbone_size]
        super().__init__(plan, head_specs, embed_dim=dim, **shell)
        self.heads_n = heads
        specs = plan.mod_specs
        self.s1_mods = tuple(m for m in plan.mods if m.startswith("s1"))
        has_s1, has_s2 = bool(self.s1_mods), "s2" in plan.mods
        if has_s1:
            sar_chans = specs[self.s1_mods[0]].num_channels
            self.s1_encoder = CromaViT(dim, depth // 2, heads, sar_chans, self.dtype, generator,
                                       device)
        if has_s2:
            self.s2_encoder = CromaViT(dim, depth, heads, OPTICAL_CHANNELS, self.dtype, generator,
                                       device)
        # joint encoder layers: self-attn -> cross-attn -> ffn (reference
        # croma.py BaseTransformerCrossAttn); built where they run, as flax
        # makes parameters only for the modules a call reaches
        self.has_joint = has_s1 and has_s2 and fusion_mode_croma == "inter-croma"
        if self.has_joint:
            self.joint_self_attns = nn.ModuleList(
                [BiasedSelfAttention(dim, heads, self.dtype, generator, device)
                 for _ in range(depth // 2)])
            self.cross_attns = nn.ModuleList(
                [BiasedCrossAttention(dim, heads, self.dtype, generator, device)
                 for _ in range(depth // 2)])
            self.cross_ffns = nn.ModuleList(
                [CromaFFN(dim, self.dtype, generator, device) for _ in range(depth // 2)])
            self.cross_norm = layer_norm_module(dim, device, LN_EPS)
        # CROMA encodes only S1/S2 (other plan modalities are ignored, like
        # the reference, croma.py:121-131); the joint tokens live on the
        # shared encoder grid (the grid the 2-D ALiBi bias is built for) and
        # the segmentation head takes them as one more stream after the
        # encoded modalities
        self.streams = tuple(m for m in plan.mods if m == "s2" or m.startswith("s1"))
        self.grid = (specs.get("s2") or specs[self.s1_mods[0]]).grid
        grids = tuple(specs[m].grid for m in self.streams)
        if self.has_joint:
            grids = grids + (self.grid,)
        self.register_buffer("alibi", torch.from_numpy(get_2d_alibi(heads, self.grid)).to(device),
                             persistent=False)
        self.make_heads(generator, device, stream_grids=grids)

    def encode_for_heads(self, batch: dict) -> dict[str, torch.Tensor]:
        """Per-modality features ``[B, D, L, C]``, and with inter-croma the
        joint tokens under ``"joint"``."""
        batch = self.resize_and_rescale(batch)
        plan, dim, bias = self.plan, self.embed_dim, self.alibi
        feats = {}
        if self.s1_mods:  # SAR: ascending + descending on the date axis
            s1 = torch.cat([batch[m] for m in self.s1_mods], dim=1)
            bs, ds = s1.shape[:2]
            sar = self.s1_encoder(s1.reshape(bs * ds, *s1.shape[2:]).to(self.dtype), bias)
            sar4 = sar.reshape(bs, ds, -1, dim)
            off = 0
            for m in self.s1_mods:
                feats[m] = sar4[:, off : off + plan.mod_specs[m].num_dates]
                off += plan.mod_specs[m].num_dates
        if "s2" in plan.mods:
            s2 = batch["s2"]
            # 10 -> 12 channels: duplicate band 9 twice (croma.py:289)
            s2 = torch.cat([s2, s2[:, :, 9:10], s2[:, :, 9:10]], dim=2)
            bo, do = s2.shape[:2]
            opt = self.s2_encoder(s2.reshape(bo * do, *s2.shape[2:]).to(self.dtype), bias)
            feats["s2"] = opt.reshape(bo, do, -1, dim)
        joint = None
        if self.has_joint:
            # the joint encoder pairs SAR/optical of matching date counts; the
            # adapter uses the first min(ds, do) date slices of each
            dj = min(ds, do)
            x = sar4[:, :dj].reshape(bs * dj, -1, dim)
            ctx = feats["s2"][:, :dj].reshape(bo * dj, -1, dim)
            for sattn, xattn, ffn in zip(self.joint_self_attns, self.cross_attns,
                                         self.cross_ffns):
                x = x + sattn(x, bias)
                x = x + xattn(x, ctx, bias)
                x = x + ffn(x)
            joint = layer_norm(x, self.cross_norm, self.dtype).reshape(bs, dj, -1, dim)
        if self.add_date_enc:
            for name in feats:
                feats[name] = feats[name] + encode_dates(
                    batch[f"{name}_dates"], batch["ref_date"], dim=dim, date_dim=self.date_dim,
                    fac_date_enc=self.fac_date_enc, num_tokens=feats[name].shape[2],
                    len_bands=1, dtype=feats[name].dtype,
                )
        if joint is not None:
            feats[JOINT] = joint
        return feats

    def logits_from_features(self, feats: dict, phase: str) -> dict[str, torch.Tensor]:
        # stream order as make_heads' grids: S1/S2 in plan order, joint last
        streams = [feats[m] for m in self.streams]
        if JOINT in feats:
            streams.append(feats[JOINT])
        return self.head_logits(streams, phase)


def build_croma(datasets: DatasetsConfig, cfg: BaselineConfig, dtype: torch.dtype, *,
                generator: torch.Generator, device) -> CromaBaseline:
    if cfg.fusion_mode not in ("late-croma", "inter-croma"):
        msg = f"CROMA supports late-croma/inter-croma, got {cfg.fusion_mode!r}."
        raise ValueError(msg)
    plan, head_specs = build_baseline_plan(datasets, cfg.fusion_mode, "croma")
    return CromaBaseline(
        plan, head_specs, backbone_size=cfg.model_size, fusion_mode_croma=cfg.fusion_mode,
        generator=generator, device=device, type_head=cfg.type_head,
        interpolate=cfg.interpolate, seg_chunk_rows=cfg.seg_chunk_rows,
        ref_input=datasets.dataset.ref_input, add_date_enc=cfg.add_date_enc, dtype=dtype,
    )
