"""MAESTRO multimodal masked autoencoder.

Functional re-design of the reference model stack (maestro/ssl/mim.py:26-505
+ ssl/mae.py:15-307): the dynamic dict-of-modules wiring becomes a static
:class:`FusionPlan` held by one module, so each (dataset, fusion_mode, phase)
has fixed tensor shapes.  Dates/band-groups are compiled into token layouts;
masking is the biased shuffle of ops/masking.py; encoders/decoders are
per-stream ViTs with an optional shared inter-modality trunk.

Size variants (reference mae.py:309-378): tiny d192x12L, small d384x12L,
medium/base d768x12L mlp*4, large d1024x24L; decoder d512, depth 1/2/3/4.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
from torch import nn

from maestro_tpu_torch.conf.core import MaskConfig, ModelConfig
from maestro_tpu_torch.conf.dataset.base import DatasetConfig, RasterConfig
from maestro_tpu_torch.conf.datasets import DatasetsConfig
from maestro_tpu_torch.models.embed import PatchEmbed, Pixelify
from maestro_tpu_torch.models.heads import ChunkedSegHead, ClassificationHead
from maestro_tpu_torch.models.vit import Transformer, dense, init_linear, normal_parameter
from maestro_tpu_torch.ops import masking
from maestro_tpu_torch.ops.posenc import build_pos_encoding, encode_dates
from maestro_tpu_torch.ops.resize import resize_spatial
from maestro_tpu_torch.specs.fusion import FusionPlan, build_fusion_plan

PHASES = ("pretrain", "probe", "finetune")


@dataclass(frozen=True)
class MAEArch:
    """Architecture hyper-parameters for one size variant."""

    embed_dim: int
    depth: int
    heads: int
    dim_head: int
    mlp_ratio: int
    decoder_dim: int
    decoder_depth: int
    decoder_heads: int
    decoder_dim_head: int
    decoder_mlp_ratio: int


MAE_ARCHS: dict[str, MAEArch] = {
    # Default head splits are 128-dim (same inner width, parameter shapes and
    # FLOPs as the reference's 64/32-dim splits, maestro/ssl/mae.py:345-360),
    # kept identical to the JAX package so weights carry over unchanged.
    # Reference checkpoints ported with the original splits set
    # ModelConfig.{encoder,decoder}_heads/_dim_head — reference values:
    # encoder 3/6/12/16 x 64 (tiny/small/medium/large), decoder 16 x 32.
    # "micro" is a test-only size for fast CPU tests; not a reference variant.
    "micro": MAEArch(64, 2, 2, 32, 2, 48, 1, 2, 24, 2),
    "tiny": MAEArch(192, 12, 3, 64, 2, 512, 1, 4, 128, 4),
    "small": MAEArch(384, 12, 3, 128, 2, 512, 2, 4, 128, 4),
    "medium": MAEArch(768, 12, 6, 128, 4, 512, 3, 4, 128, 4),
    "base": MAEArch(768, 12, 6, 128, 4, 512, 3, 4, 128, 4),
    "large": MAEArch(1024, 24, 8, 128, 4, 512, 4, 4, 128, 4),
}


@dataclass(frozen=True)
class HeadSpec:
    """Static description of one downstream target head."""

    name: str
    type_target: str
    num_classes: int
    missing_val: int
    pixel_patch: int = 1  # segment: target pixels per ref-grid token


def build_head_specs(dataset: DatasetConfig, plan: FusionPlan) -> tuple[HeadSpec, ...]:
    specs = []
    for name, target in dataset.targets.items():
        if isinstance(target, RasterConfig):
            if dataset.ref_input is None:
                msg = f"ref_input must be set for raster target {name!r}."
                raise ValueError(msg)
            target_size = round(dataset.crop_meters / target.resolution_meters)
            ref_grid = plan.mod_specs[dataset.ref_input].grid
            if target_size % ref_grid:
                msg = (
                    f"Target size {target_size} of {name!r} is not a multiple "
                    f"of the ref-input grid {ref_grid}."
                )
                raise ValueError(msg)
            specs.append(
                HeadSpec(name, target.type_target, target.num_classes,
                         target.missing_val, target_size // ref_grid),
            )
        else:
            specs.append(
                HeadSpec(name, target.type_target, target.num_classes,
                         target.missing_val),
            )
    return tuple(specs)


class MaestroMAE(nn.Module):
    """Multimodal MAE over a static FusionPlan.

    Parameters are fp32 on ``device``; activations run in ``dtype``.  Initial
    weights are drawn from ``generator`` (a CPU ``torch.Generator``).
    """

    def __init__(
        self,
        plan: FusionPlan,
        arch: MAEArch,
        head_specs: tuple[HeadSpec, ...],
        *,
        generator: torch.Generator,
        device,
        inter_depth: int = 0,
        interpolate: str = "nearest",
        type_head: str = "attentive",
        ref_input: str | None = None,
        fac_abs_enc: float = 1.0,
        fac_date_enc: float = 1.0,
        date_dim: int = 8,
        seg_chunk_rows: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        remat: bool | str = False,
    ) -> None:
        super().__init__()
        self.plan, self.arch, self.head_specs = plan, arch, head_specs
        self.inter_depth, self.interpolate = inter_depth, interpolate
        self.fac_date_enc, self.date_dim, self.dtype = fac_date_enc, date_dim, dtype

        # --- patch embed / pixelify, shared across mods by name_embed
        embed_specs = {}
        for spec in plan.mod_specs.values():
            prev = embed_specs.get(spec.name_embed)
            if prev is not None:
                if (prev.band_groups, prev.patch_size) != (
                    spec.band_groups, spec.patch_size,
                ):
                    msg = (
                        f"Modalities sharing name_embed {spec.name_embed!r} "
                        "must agree on band groups and patch size."
                    )
                    raise ValueError(msg)
                continue
            embed_specs[spec.name_embed] = spec
        self.patch_embed = nn.ModuleDict({
            name: PatchEmbed(spec.band_groups, spec.patch_size, arch.embed_dim,
                             dtype, generator, device)
            for name, spec in embed_specs.items()
        })
        self.pixelify = nn.ModuleDict({
            name: Pixelify(spec.band_groups, spec.patch_size, arch.decoder_dim,
                           dtype, generator, device)
            for name, spec in embed_specs.items()
        })

        # --- learnable mask token per modality: [1, G, 1, 1, dec_dim]
        self.mask_tokens = nn.ParameterDict({
            name: normal_parameter(
                (1, spec.len_bands, 1, 1, arch.decoder_dim), generator, device,
            )
            for name, spec in plan.mod_specs.items()
        })

        # --- static positional encodings per modality (encoder and decoder
        # widths), in the compute dtype
        for name, spec in plan.mod_specs.items():
            pos = build_pos_encoding(
                plan.grid_pos_enc, spec.grid, arch.embed_dim, date_dim,
                fac=fac_abs_enc,
            )
            pos_dec = build_pos_encoding(
                plan.grid_pos_enc, spec.grid, arch.decoder_dim, date_dim,
            )
            for prefix, value in (("pos_enc", pos), ("pos_dec", pos_dec)):
                self.register_buffer(
                    f"{prefix}_{name}",
                    torch.from_numpy(value).to(device=device, dtype=dtype),
                    persistent=False,
                )

        # --- per-stream encoders / decoders (+ optional shared trunk)
        def encoder(depth: int) -> Transformer:
            return Transformer(
                arch.embed_dim, depth, arch.heads, arch.dim_head,
                arch.embed_dim * arch.mlp_ratio, dtype, generator, device, remat=remat,
            )

        self.encoders = nn.ModuleDict({
            name: encoder(arch.depth - inter_depth) for name in plan.encoder_names
        })
        self.enc_to_dec = nn.ModuleDict()
        for name in plan.encoder_names:
            layer = nn.Linear(arch.embed_dim, arch.decoder_dim, device=device)
            init_linear(layer, generator)
            self.enc_to_dec[name] = layer
        self.decoders = nn.ModuleDict({
            name: Transformer(
                arch.decoder_dim, arch.decoder_depth, arch.decoder_heads,
                arch.decoder_dim_head,
                # quirk kept from reference mae.py:162: decoder MLP width is
                # embed_dim * decoder_mlp_ratio, not decoder_dim * ratio
                arch.embed_dim * arch.decoder_mlp_ratio, dtype, generator, device,
                remat=remat,
            )
            for name in plan.encoder_names
        })
        if inter_depth:
            self.encoder_inter = encoder(inter_depth)

        # --- downstream heads
        self.heads = nn.ModuleDict()
        for hs in head_specs:
            if hs.type_target == "segment":
                self.heads[hs.name] = ChunkedSegHead(
                    type_head, arch.embed_dim, hs.num_classes, hs.pixel_patch,
                    plan.mod_specs[ref_input].grid,
                    tuple(plan.mod_specs[m].grid for m in plan.mods),
                    dtype, generator, device, chunk_rows=seg_chunk_rows,
                )
            else:
                self.heads[hs.name] = ClassificationHead(
                    type_head, arch.embed_dim, hs.num_classes, dtype,
                    generator, device,
                )

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ------------------------------------------------------------------
    def resize_and_rescale(self, batch: dict) -> dict:
        """Resize inputs to configured image sizes; DEM -> (DSM - DTM) * 30."""
        out = dict(batch)
        for name, spec in self.plan.mod_specs.items():
            x = resize_spatial(batch[name], spec.image_size, self.interpolate)
            if spec.rescale_elev:
                x = torch.cat(
                    [x[:, :, :1], 30.0 * (x[:, :, :1] - x[:, :, 1:])], dim=2,
                )
            out[name] = x
        return out

    def embed_tokens(self, batch: dict) -> dict[str, torch.Tensor]:
        """Patch-embed each modality and add positional + date encodings."""
        tokens = {}
        for name, spec in self.plan.mod_specs.items():
            t = self.patch_embed[spec.name_embed](batch[name])
            pos = getattr(self, f"pos_enc_{name}")
            date = encode_dates(
                batch[f"{name}_dates"], batch["ref_date"],
                dim=self.arch.embed_dim, date_dim=self.date_dim,
                fac_date_enc=self.fac_date_enc,
                num_tokens=spec.tokens_per_date, len_bands=spec.len_bands,
                dtype=self.dtype,
            )
            tokens[name] = t + pos + date
        return tokens

    def mask_token_full(self, batch_size: int) -> dict[str, torch.Tensor]:
        """Broadcast per-mod mask tokens to the full token layout."""
        out = {}
        for name, spec in self.plan.mod_specs.items():
            tok = self.mask_tokens[name].to(self.dtype).expand(
                batch_size, spec.len_bands, spec.num_dates, spec.tokens_per_date,
                self.arch.decoder_dim,
            )
            out[name] = tok.reshape(
                batch_size, spec.date_axis, spec.tokens_per_date, self.arch.decoder_dim,
            )
        return out

    def encode_streams(self, streams: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Per-stream encoders, then the shared inter-modality trunk."""
        x = {
            name: self.encoders[self.plan.streams[name].encoder](xs)
            for name, xs in streams.items()
        }
        if self.inter_depth:
            sizes = {name: xs.shape[1] for name, xs in x.items()}
            trunk_in = torch.cat([x[n] for n in self.plan.streams], dim=1)
            trunk_out = self.encoder_inter(trunk_in)
            x = self.plan.split_streams_sizes(trunk_out, sizes)
        return x

    def add_dec_encodings(self, streams: dict, batch: dict) -> dict:
        """Decoder-width positional + date encodings (post-unmask)."""
        x = self.plan.ungroup(streams)
        for name, spec in self.plan.mod_specs.items():
            date = encode_dates(
                batch[f"{name}_dates"], batch["ref_date"],
                dim=self.arch.decoder_dim, date_dim=self.date_dim,
                fac_date_enc=self.fac_date_enc,
                num_tokens=spec.tokens_per_date, len_bands=spec.len_bands,
                dtype=self.dtype,
            )
            x[name] = x[name] + getattr(self, f"pos_dec_{name}") + date
        return self.plan.group(x)

    def encode_for_heads(self, batch: dict) -> dict[str, torch.Tensor]:
        """Trunk features for the downstream heads (grouped streams): the
        downstream forward up to and including ``encode_streams``."""
        batch = self.resize_and_rescale(batch)
        tokens = self.embed_tokens(batch)
        streams = self.plan.group(tokens)
        return self.encode_streams(streams)

    def compute_logits(self, encoded: dict, phase: str) -> dict[str, torch.Tensor]:
        """Downstream logits: per-target heads over (resized) token grids.

        In the probe phase the features are detached, so only the heads
        receive gradients.
        """
        x = self.plan.ungroup(encoded)
        if phase == "probe":
            x = {name: v.detach() for name, v in x.items()}
        logits = {}
        for hs in self.head_specs:
            if hs.type_target == "segment":
                logits[hs.name] = self.heads[hs.name](
                    tuple(x[m] for m in self.plan.mods),
                )
            else:
                x_cat = torch.cat(
                    [x[m].reshape(x[m].shape[0], -1, x[m].shape[-1])
                     for m in self.plan.mods],
                    dim=1,
                )
                logits[hs.name] = self.heads[hs.name](x_cat)
        return logits

    # ------------------------------------------------------------------
    def forward(self, batch: dict, phase: str = "finetune", return_pixels: bool = True,
                *, generator: torch.Generator | None = None, from_features: bool = False,
                mask_rows: tuple[int, int] | None = None):
        """Forward pass.

        probe/finetune -> logits dict per target.  pretrain -> (rec, mask,
        targets) dicts per modality, where ``targets`` are the resized /
        rescaled inputs the reconstruction loss compares against; the masks
        are drawn from ``generator`` (required; a CPU generator draws them on
        the host and they are copied to the model's device) by
        ``ops.masking.draw_masks``.  ``from_features=True`` (probe / finetune)
        takes ``encode_for_heads`` features for ``batch`` and runs the heads
        only: the form ``torch.func.functional_call`` can reach.

        ``return_pixels=False`` (pretrain only) keeps the reconstruction in
        token space — rec[name] is [B, D, L, C*p*p] in (C, ph, pw) feature
        order with a [B, D, L] token mask — for single-band-group modalities,
        skipping the pixel shuffle the loss would immediately undo.

        ``mask_rows=(offset, global_batch)`` (a data-parallel rank's pretrain
        forward): the masks are drawn for the global batch, as one process
        draws them, and the rank keeps the rows of its samples.
        """
        if phase not in PHASES:
            msg = f"Invalid phase {phase!r}; expected {PHASES}."
            raise ValueError(msg)
        if from_features:  # batch holds encode_for_heads features
            return self.compute_logits(batch, phase)
        if phase == "probe":
            # the trunk is frozen (stop_gradient in the JAX package): autograd
            # keeps none of its activations
            with torch.no_grad():
                encoded = self.encode_for_heads(batch)
            return self.compute_logits(encoded, phase)
        if phase == "finetune":
            return self.compute_logits(self.encode_for_heads(batch), phase)
        if generator is None:
            msg = "the pretrain forward draws its masks from a generator: pass generator="
            raise ValueError(msg)
        return self.pretrain_forward(batch, generator, return_pixels, mask_rows)

    def pretrain_forward(self, batch: dict, generator: torch.Generator,
                         return_pixels: bool = True,
                         mask_rows: tuple[int, int] | None = None):
        """Masking, encoders on the kept tokens, decoders, reconstruction."""
        plan = self.plan
        batch = self.resize_and_rescale(batch)
        tokens = self.embed_tokens(batch)
        batch_size = next(iter(tokens.values())).shape[0]
        streams = plan.group(tokens)

        # --- structural + random masking, encode kept tokens
        offset, total = mask_rows or (0, batch_size)
        struct, noise = (
            masking.to_device(masking.local_rows(plan, d, offset, batch_size)
                              if total != batch_size else d, self.device)
            for d in masking.draw_masks(plan, generator, total)
        )
        kept, mask_rec = {}, {}
        for name, stream in plan.streams.items():
            kept[name], mask_rec[name], _ = masking.shuffle_mask(
                streams[name], struct[name], noise[name], stream.num_masked,
            )
        encoded = self.encode_streams(kept)

        # --- decode: project, re-expand with mask tokens, add dec encodings
        dec_in = {
            name: dense(xs, self.enc_to_dec[plan.streams[name].encoder], self.dtype)
            for name, xs in encoded.items()
        }
        mask_tok = plan.group(self.mask_token_full(batch_size))
        full = {
            name: masking.unmask(dec_in[name], mask_tok[name], mask_rec[name])
            for name in plan.streams
        }
        full = self.add_dec_encodings(full, batch)
        decoded = {
            name: self.decoders[plan.streams[name].encoder](xs)
            for name, xs in full.items()
        }

        # --- reconstruct per modality (token space or pixels)
        x_mod = plan.ungroup(decoded)
        mask_mod = plan.ungroup(mask_rec)
        rec, rec_mask = {}, {}
        for name, spec in plan.mod_specs.items():
            tokens_only = not return_pixels and spec.len_bands == 1
            rec[name], rec_mask[name] = self.pixelify[spec.name_embed](
                x_mod[name], mask_mod[name], tokens_only=tokens_only,
            )
        targets = {name: batch[name] for name in plan.mod_specs}
        return rec, rec_mask, targets


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; ``cuda`` must really be there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        msg = (
            "no CUDA device is available: the port runs on the GPU unless the "
            "caller passes device='cpu'."
        )
        raise RuntimeError(msg)
    return device


def build_model(
    datasets: DatasetsConfig,
    mask: MaskConfig,
    model_cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    *,
    device="cuda",
    generator: torch.Generator | None = None,
    remat: bool | str = False,
) -> tuple[MaestroMAE, FusionPlan]:
    """Build the flagship MAE for a dataset + model config.

    ``generator`` seeds the initial weights (default: a fresh generator with
    seed 0); ``remat`` is ``trainer.remat``, the activation recompute of
    every encoder, decoder and trunk ``Transformer`` (models/vit.py).
    """
    device = resolve_device(device)
    if model_cfg.model != "mae":
        msg = f"Unknown model {model_cfg.model!r}."
        raise ValueError(msg)
    if model_cfg.model_size not in MAE_ARCHS:
        msg = (
            f"Invalid model size {model_cfg.model_size!r}; "
            f"expected one of {tuple(MAE_ARCHS)}."
        )
        raise ValueError(msg)
    if model_cfg.inter_depth and model_cfg.fusion_mode not in ("mod", "group"):
        msg = (
            "inter_depth (shared trunk) requires fusion_mode 'mod' or 'group', "
            f"got {model_cfg.fusion_mode!r}."
        )
        raise ValueError(msg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    dataset = datasets.dataset
    plan = build_fusion_plan(dataset, mask, model_cfg.fusion_mode, model="mae")
    head_specs = build_head_specs(dataset, plan)
    arch = MAE_ARCHS[model_cfg.model_size]
    for part in ("encoder", "decoder"):
        pfx = "" if part == "encoder" else "decoder_"
        cfg_heads = getattr(model_cfg, f"{part}_heads")
        cfg_dim = getattr(model_cfg, f"{part}_dim_head")
        if not (cfg_heads or cfg_dim):
            continue
        heads = cfg_heads or getattr(arch, f"{pfx}heads")
        dim_head = cfg_dim or getattr(arch, f"{pfx}dim_head")
        inner = getattr(arch, f"{pfx}heads") * getattr(arch, f"{pfx}dim_head")
        if heads * dim_head != inner:
            msg = (
                f"{part}_heads*{part}_dim_head ({heads}*{dim_head}) must keep "
                f"the {inner} inner width so parameter shapes stay "
                "port-compatible."
            )
            raise ValueError(msg)
        arch = replace(
            arch, **{f"{pfx}heads": heads, f"{pfx}dim_head": dim_head},
        )
    module = MaestroMAE(
        plan, arch, head_specs,
        generator=generator, device=device,
        inter_depth=model_cfg.inter_depth,
        interpolate=model_cfg.interpolate,
        type_head=model_cfg.type_head,
        ref_input=dataset.ref_input,
        fac_abs_enc=1.0,
        fac_date_enc=1.0 if model_cfg.use_date_enc else 0.0,
        seg_chunk_rows=model_cfg.seg_chunk_rows,
        dtype=dtype,
        remat=remat,
    )
    return module.eval(), plan
