"""FusionPlan: static token-layout compiler for multimodal fusion.

The reference wires modalities dynamically through dicts of tensors at runtime
(reference maestro/layers/utils.py:12-100 ``group_mods``/``ungroup_mods``
and maestro/ssl/mae.py:60-131 mask-ratio derivation).  Here all of that is
resolved *once* at construction time into a ``FusionPlan``: a frozen
description of every token stream the encoders see — batch expansion factors,
sequence lengths, per-modality segment offsets, masking ratios and structural
masking probabilities.  Grouping and ungrouping are static reshapes, slices
and concatenations of ``torch.Tensor``s.

Token layout convention (canonical "ungrouped" form) per modality:
    ``[B, DG, L, C]``  where ``DG = num_dates * len_bands`` with the band-group
    axis *major* (index = g * D + d) and ``L = grid**2`` row-major patches.

Fusion modes (reference semantics):
  - ``shared``:   every (date, band-group) slice is an independent sample on
                  the batch axis; one weight-shared encoder.
  - ``monotemp``: same batch-axis flattening; per-modality encoders.
  - ``mod``:      dates/band-groups concatenated on the sequence axis;
                  per-modality encoders.
  - ``group``:    like ``mod`` but modalities sharing ``name_group`` are
                  concatenated into one sequence; per-group encoders.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from math import gcd

import torch

from maestro_tpu_torch.conf.dataset.base import DatasetConfig
from maestro_tpu_torch.conf.core import MaskConfig

FUSION_MODES = ("shared", "monotemp", "mod", "group")


@dataclass(frozen=True)
class ModalityTokenSpec:
    """Static token geometry for one input modality."""

    name: str
    name_embed: str
    group: str
    image_size: int
    patch_size: int
    grid: int
    num_dates: int  # D: true temporal depth
    len_bands: int  # G: number of band groups
    band_groups: tuple[int, ...]
    norm_groups: tuple[int, ...]
    rescale_elev: bool

    @property
    def tokens_per_date(self) -> int:
        return self.grid * self.grid

    @property
    def date_axis(self) -> int:
        """DG: length of the flattened (band-group, date) axis."""
        return self.num_dates * self.len_bands

    @property
    def num_tokens(self) -> int:
        return self.date_axis * self.tokens_per_date

    @property
    def num_channels(self) -> int:
        return sum(self.band_groups)


@dataclass(frozen=True)
class StructMaskSpec:
    """Structural masking probabilities for one modality (None = disabled)."""

    p_mod: float | None
    p_bands: float | None
    p_dates: float | None
    p_loc: float | None

    @property
    def enabled(self) -> bool:
        return any(
            p is not None for p in (self.p_mod, self.p_bands, self.p_dates, self.p_loc)
        )


@dataclass(frozen=True)
class StreamSpec:
    """One encoder input stream: a fixed concatenation of modality segments."""

    name: str
    mods: tuple[str, ...]  # modalities in concatenation order
    encoder: str  # encoder name ("shared" or stream name)
    batch_factor: int  # >1 when dates are flattened into the batch axis
    seq_len: int  # tokens per (expanded) sample
    seg_offsets: tuple[int, ...]  # start offset of each modality segment
    seg_lens: tuple[int, ...]  # token count of each modality segment
    mask_ratio: float
    num_masked: int  # static count of masked tokens under mask_ratio


@dataclass(frozen=True)
class FusionPlan:
    """Full static fusion layout for a (dataset, fusion_mode) pair."""

    fusion_mode: str
    mods: tuple[str, ...]
    mod_specs: dict[str, ModalityTokenSpec]
    streams: dict[str, StreamSpec]
    struct_masks: dict[str, StructMaskSpec]  # keyed by modality
    grid_pos_enc: int
    batch_flattened: bool  # True for shared/monotemp (dates on batch axis)

    # ------------------------------------------------------------------
    # grouping / ungrouping: pure static reshapes over the plan layout
    # ------------------------------------------------------------------
    def group(self, x: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """dict[mod] -> [B, DG, L, ...]  ==>  dict[stream] -> [B', L', ...]."""
        out = {}
        for name, stream in self.streams.items():
            parts = []
            for mod in stream.mods:
                xm = x[mod]
                b = xm.shape[0]
                if self.batch_flattened:
                    parts.append(xm.reshape((b * xm.shape[1],) + tuple(xm.shape[2:])))
                else:
                    parts.append(
                        xm.reshape((b, xm.shape[1] * xm.shape[2]) + tuple(xm.shape[3:])),
                    )
            out[name] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return out

    def ungroup(self, x: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """dict[stream] -> [B', L', ...]  ==>  dict[mod] -> [B, DG, L, ...]."""
        out = {}
        for name, stream in self.streams.items():
            xs = x[name]
            for mod, off, length in zip(stream.mods, stream.seg_offsets, stream.seg_lens):
                spec = self.mod_specs[mod]
                if self.batch_flattened:
                    bdg = xs.shape[0]
                    out[mod] = xs.reshape(
                        (bdg // spec.date_axis, spec.date_axis) + tuple(xs.shape[1:]),
                    )
                else:
                    seg = xs[:, off : off + length]
                    out[mod] = seg.reshape(
                        (seg.shape[0], spec.date_axis, spec.tokens_per_date)
                        + tuple(seg.shape[2:]),
                    )
        return out

    def concat_streams(self, x: dict[str, torch.Tensor]) -> torch.Tensor:
        """Concatenate all streams on the sequence axis (shared trunk input)."""
        return torch.cat([x[name] for name in self.streams], dim=1)

    def split_streams(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """Inverse of :meth:`concat_streams` (pretrain keeps full streams)."""
        out, off = {}, 0
        for name, stream in self.streams.items():
            out[name] = x[:, off : off + stream.seq_len]
            off += stream.seq_len
        return out

    def split_streams_sizes(self, x: torch.Tensor, sizes: dict[str, int]):
        """Split a trunk sequence by explicit per-stream lengths (masked seqs)."""
        out, off = {}, 0
        for name in self.streams:
            out[name] = x[:, off : off + sizes[name]]
            off += sizes[name]
        return out

    @property
    def encoder_names(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys(s.encoder for s in self.streams.values()))


def build_fusion_plan(
    dataset: DatasetConfig,
    mask: MaskConfig | None = None,
    fusion_mode: str = "group",
    model: str = "mae",
    floor_grid: bool = False,
) -> FusionPlan:
    """Compile a dataset config + fusion mode into a static FusionPlan.

    ``floor_grid=True`` (baseline FM adapters) takes ``image_size // patch``
    even when the patch does not divide — matching a strided conv patch embed
    that drops the right/bottom remainder.
    """
    if fusion_mode not in FUSION_MODES:
        msg = f"Invalid fusion mode {fusion_mode!r}; expected {FUSION_MODES}."
        raise ValueError(msg)
    if mask is None:
        mask = MaskConfig()

    mod_specs: dict[str, ModalityTokenSpec] = {}
    group_of: dict[str, str] = dict(dataset.groups)
    for name, mod in dataset.inputs.items():
        patch = mod.patch_size.for_model(model)
        if mod.image_size % patch and not floor_grid:
            msg = f"Patch size {patch} does not divide image size of {name!r}."
            raise ValueError(msg)
        mod_specs[name] = ModalityTokenSpec(
            name=name,
            name_embed=mod.name_embed or name,
            group=group_of[name],
            image_size=mod.image_size,
            patch_size=patch,
            grid=mod.image_size // patch,
            num_dates=mod.num_dates,
            len_bands=mod.len_bands,
            band_groups=mod.band_groups,
            norm_groups=mod.norm_groups,
            rescale_elev=mod.rescale_elev,
        )

    # date-axis totals used for mask-ratio scaling (reference mae.py:60-69)
    dates_mod = {name: spec.date_axis for name, spec in mod_specs.items()}
    dates_group: dict[str, int] = {}
    for name, spec in mod_specs.items():
        dates_group[spec.group] = dates_group.get(spec.group, 0) + spec.date_axis

    batch_flattened = fusion_mode in ("shared", "monotemp")
    streams: dict[str, StreamSpec] = {}
    struct_masks: dict[str, StructMaskSpec] = {}

    if batch_flattened:
        # one stream per modality; dates expand the batch axis
        for name, spec in mod_specs.items():
            encoder = "shared" if fusion_mode == "shared" else name
            ratio = mask.mask_ratio
            seq = spec.tokens_per_date
            streams[name] = StreamSpec(
                name=name,
                mods=(name,),
                encoder=encoder,
                batch_factor=spec.date_axis,
                seq_len=seq,
                seg_offsets=(0,),
                seg_lens=(seq,),
                mask_ratio=ratio,
                num_masked=round(ratio * seq),
            )
            struct_masks[name] = StructMaskSpec(None, None, None, None)
    else:
        # sequence-axis fusion: streams keyed by modality (mod) or group (group)
        stream_mods: dict[str, list[str]] = {}
        for name, spec in mod_specs.items():
            key = spec.group if fusion_mode == "group" else name
            stream_mods.setdefault(key, []).append(name)

        for key, mods in stream_mods.items():
            scale_base = dates_group[key] if fusion_mode == "group" else dates_mod[key]
            ratio = 1.0 - (1.0 - mask.mask_ratio) / scale_base**mask.mask_scale
            lens = tuple(mod_specs[m].num_tokens for m in mods)
            offsets = tuple(sum(lens[:i]) for i in range(len(lens)))
            seq = sum(lens)
            streams[key] = StreamSpec(
                name=key,
                mods=tuple(mods),
                encoder=key,
                batch_factor=1,
                seq_len=seq,
                seg_offsets=offsets,
                seg_lens=lens,
                mask_ratio=ratio,
                num_masked=round(ratio * seq),
            )

        for name, spec in mod_specs.items():
            if fusion_mode == "group" and dates_mod[name] != dates_group[spec.group]:
                p_mod = mask.mask_mod
            else:
                p_mod = None
            struct_masks[name] = StructMaskSpec(
                p_mod=p_mod,
                p_bands=mask.mask_bands if spec.len_bands > 1 else None,
                p_dates=mask.mask_dates if spec.num_dates > 1 else None,
                p_loc=mask.mask_loc,
            )

    if dataset.grid_pos_enc is not None:
        grid_pos_enc = dataset.grid_pos_enc
    else:
        grid_pos_enc = reduce(
            lambda a, b: a * b // gcd(a, b),
            (spec.grid for spec in mod_specs.values()),
        )

    return FusionPlan(
        fusion_mode=fusion_mode,
        mods=tuple(mod_specs),
        mod_specs=mod_specs,
        streams=streams,
        struct_masks=struct_masks,
        grid_pos_enc=grid_pos_enc,
        batch_flattened=batch_flattened,
    )
