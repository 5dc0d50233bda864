"""Released-checkpoint key manifests and the port's coverage check.

The port's copy of the JAX package's ``port/manifests.py`` (numpy only; the
maps and the JSON they produce are the same).  Each foundation-model release
the adapters start from has a key manifest: every key name and shape,
transcribed from the reference's own loading code, committed as a JSON
fixture (``tests/manifests/``, written by
``python -m maestro_tpu_torch.scripts.gen_manifests``).  The port CLI
(``maestro_tpu_torch.scripts.port_fm``) checks a run's COVERAGE against it:

- every source key is either consumed by the port map or matches an
  explicitly documented skip pattern (reason strings below);
- every key the port map reads exists in the manifest (a port depending on
  a key the release does not ship fails on the synthesized fixture, not on
  the real file);
- the shapes of manifest-listed keys match the file.

Transcription sources (reference ``maestro/baselines/``):

- SatMAE  satmae.py:129-177 strict load into the vendored
  ``MaskedAutoencoderViT`` (satmae.py:252-330: timm PatchEmbed/Block, 384
  reserved timestamp dims in pos_embed, the full MAE decoder in the file).
- DOFA    dofa.py:83-96 torchgeo ``DOFA{Base,Large}16_Weights.DOFA_MAE``;
  consumed via filter_dict prefixes patch_embed/blocks/norm +
  pos_embed/cls_token (dofa.py:180-266); DOFAEmbedding /
  TransformerWeightGenerator layouts at dofa.py:463-678.
- CROMA   croma.py:386-436: top-level sub-dicts s1_encoder / s1_GAP_FFN /
  s2_encoder / s2_GAP_FFN / joint_encoder, strict loads into the vendored
  ViT / BaseTransformer / BaseTransformerCrossAttn (croma.py:515-775).
- Prithvi prithvi.py:138-155 builds the terratorch PrithviViT with
  pretrained weights; the encoder key layout per the reference's surgery
  (prithvi.py:156-182: Conv3d patch kernel [E, 6, 1, p, p]).
- DINOv2  dinov2.py:240-278 (HF ``facebook/dinov2-*`` pytorch_model.bin via
  utils.py:121-138) and the quantized sat blob (utils.py:81-118 rename +
  dequantize).
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# Manifest generators: {key: shape-list or None (shape not pinned)}


def _timm_block(e: int, mlp: int | None = None) -> dict[str, list[int]]:
    mlp = mlp if mlp is not None else 4 * e
    return {
        "norm1.weight": [e], "norm1.bias": [e],
        "attn.qkv.weight": [3 * e, e], "attn.qkv.bias": [3 * e],
        "attn.proj.weight": [e, e], "attn.proj.bias": [e],
        "norm2.weight": [e], "norm2.bias": [e],
        "mlp.fc1.weight": [mlp, e], "mlp.fc1.bias": [mlp],
        "mlp.fc2.weight": [e, mlp], "mlp.fc2.bias": [e],
    }


def _blocks(prefix: str, depth: int, e: int,
            mlp: int | None = None) -> dict[str, list[int]]:
    out: dict[str, list[int]] = {}
    for i in range(depth):
        for k, s in _timm_block(e, mlp).items():
            out[f"{prefix}{i}.{k}"] = s
    return out


def satmae_manifest(size: str) -> dict[str, Any]:
    """fmow-sentinel release: the 'model' dict strict-loads into the
    vendored MaskedAutoencoderViT (satmae.py:158: strict=True), so the file
    holds exactly that module's parameter set.  in_chans=3 (ORIG_BANDS),
    img 224/patch 16 -> 197 tokens, pos_embed reserves 3x128 timestamp dims,
    decoder dim 512 depth 8 with 192 reserved dims."""
    e = {"base": 768, "large": 1024}[size]
    depth = {"base": 12, "large": 24}[size]
    dec = 512
    keys: dict[str, Any] = {
        "patch_embed.proj.weight": [e, 3, 16, 16],
        "patch_embed.proj.bias": [e],
        "cls_token": [1, 1, e],
        "pos_embed": [1, 197, e - 384],
        **_blocks("blocks.", depth, e),
        "norm.weight": [e], "norm.bias": [e],
        "mask_token": [1, 1, dec],
        "decoder_embed.weight": [dec, e], "decoder_embed.bias": [dec],
        "decoder_pos_embed": [1, 197, dec - 192],
        **_blocks("decoder_blocks.", 8, dec),
        "decoder_norm.weight": [dec], "decoder_norm.bias": [dec],
        "decoder_pred.weight": [16 * 16 * 3, dec],
        "decoder_pred.bias": [16 * 16 * 3],
    }
    return {
        "name": f"satmae_{size}_fmow_sentinel",
        "adapter": "satmae", "size": size,
        "keys": keys,
        "skip": {
            "pos_embed": "fixed 2-D sincos grid regenerated on device "
                         "(baselines/satmae.py sincos_2d_grid); the "
                         "timestamp dims are computed per batch",
            "mask_token": "MAE pretraining token; adapters run "
                          "forward_encoder only (satmae.py:371-420)",
            "decoder_*": "MAE decoder; adapters run forward_encoder only",
        },
    }


def _dofa_embedding(e: int) -> dict[str, list[int]]:
    d = 128  # dynamic_embed_dim (dofa.py:190)
    nk = 16 * 16 * e  # _num_kernel (dofa.py:602)
    te = "patch_embed.weight_generator.transformer_encoder.layers.0."
    return {
        f"{te}self_attn.in_proj_weight": [3 * d, d],
        f"{te}self_attn.in_proj_bias": [3 * d],
        f"{te}self_attn.out_proj.weight": [d, d],
        f"{te}self_attn.out_proj.bias": [d],
        f"{te}linear1.weight": [2048, d], f"{te}linear1.bias": [2048],
        f"{te}linear2.weight": [d, 2048], f"{te}linear2.bias": [d],
        f"{te}norm1.weight": [d], f"{te}norm1.bias": [d],
        f"{te}norm2.weight": [d], f"{te}norm2.bias": [d],
        "patch_embed.weight_generator.fc_weight.weight": [nk, d],
        "patch_embed.weight_generator.fc_weight.bias": [nk],
        "patch_embed.weight_generator.fc_bias.weight": [e, d],
        "patch_embed.weight_generator.fc_bias.bias": [e],
        "patch_embed.weight_generator.weight_tokens": [128, d],
        "patch_embed.weight_generator.bias_token": [1, d],
        "patch_embed.fclayer.w1.weight": [d, d],
        "patch_embed.fclayer.w1.bias": [d],
        "patch_embed.fclayer.w2.weight": [d, d],
        "patch_embed.fclayer.w2.bias": [d],
    }


def dofa_manifest(size: str) -> dict[str, Any]:
    """torchgeo DOFA_MAE release (encoder weights): wavelength
    weight-generator embedding + timm blocks + norm (dofa.py:180-266
    consumes exactly these prefixes; extras in the file are ignored by
    filter_dict, mirrored here as skip patterns)."""
    e = {"base": 768, "large": 1024}[size]
    depth = {"base": 12, "large": 24}[size]
    keys: dict[str, Any] = {
        **_dofa_embedding(e),
        "cls_token": [1, 1, e],
        "pos_embed": [1, 197, e],
        **_blocks("blocks.", depth, e),
        "norm.weight": [e], "norm.bias": [e],
    }
    return {
        "name": f"dofa_{size}_torchgeo_mae",
        "adapter": "dofa", "size": size,
        "keys": keys,
        "skip": {
            "mask_token": "MAE pretraining token, not consumed by the "
                          "reference either (filter_dict prefixes)",
            "decoder_*": "MAE decoder, not consumed by the reference",
            "projector*": "pretraining projector head, not consumed",
        },
    }


def _croma_base_transformer(prefix: str, depth: int, e: int,
                            cross: bool = False) -> dict[str, list[int]]:
    out: dict[str, list[int]] = {}
    for i in range(depth):
        a = f"{prefix}layers.{i}.0."
        out[f"{a}input_norm.weight"] = [e]
        out[f"{a}input_norm.bias"] = [e]
        out[f"{a}to_qkv.weight"] = [3 * e, e]  # bias=False (croma.py:557)
        out[f"{a}to_out.weight"] = [e, e]
        out[f"{a}to_out.bias"] = [e]
        ffn_idx = 2 if cross else 1
        if cross:
            x = f"{prefix}layers.{i}.1."
            out[f"{x}input_norm.weight"] = [e]
            out[f"{x}input_norm.bias"] = [e]
            out[f"{x}to_q.weight"] = [e, e]  # bias=False (croma.py:611)
            out[f"{x}to_k.weight"] = [e, e]
            out[f"{x}to_v.weight"] = [e, e]
            out[f"{x}to_out.weight"] = [e, e]
            out[f"{x}to_out.bias"] = [e]
        f = f"{prefix}layers.{i}.{ffn_idx}."
        out[f"{f}input_norm.weight"] = [e]
        out[f"{f}input_norm.bias"] = [e]
        out[f"{f}net.0.weight"] = [4 * e, e]
        out[f"{f}net.0.bias"] = [4 * e]
        out[f"{f}net.3.weight"] = [e, 4 * e]
        out[f"{f}net.3.bias"] = [e]
    out[f"{prefix}norm_out.weight"] = [e]
    out[f"{prefix}norm_out.bias"] = [e]
    return out


def _gap_ffn(e: int) -> dict[str, list[int]]:
    """nn.Sequential(LayerNorm, Linear, GELU, Linear) (croma.py:374-382)."""
    return {
        "0.weight": [e], "0.bias": [e],
        "1.weight": [4 * e, e], "1.bias": [4 * e],
        "3.weight": [e, 4 * e], "3.bias": [e],
    }


def croma_manifest(size: str) -> dict[str, Any]:
    """CROMA_{base,large}.pt: top-level sub-dicts (croma.py:386-436).
    Manifest keys are '<subdict>.<key>' over the nested release layout.
    patch 8: s1 = 2 ch -> 128 px/patch, s2 = 12 ch -> 768 px/patch;
    s1/joint depth = encoder_depth // 2 (croma.py:368-426)."""
    e = {"base": 768, "large": 1024}[size]
    depth = {"base": 12, "large": 24}[size]
    keys: dict[str, Any] = {
        "s1_encoder.linear_input.weight": [e, 2 * 64],
        "s1_encoder.linear_input.bias": [e],
        **{f"s1_encoder.transformer.{k}": s for k, s in
           _croma_base_transformer("", depth // 2, e).items()},
        "s2_encoder.linear_input.weight": [e, 12 * 64],
        "s2_encoder.linear_input.bias": [e],
        **{f"s2_encoder.transformer.{k}": s for k, s in
           _croma_base_transformer("", depth, e).items()},
        **{f"joint_encoder.{k}": s for k, s in
           _croma_base_transformer("", depth // 2, e, cross=True).items()},
        **{f"s1_GAP_FFN.{k}": s for k, s in _gap_ffn(e).items()},
        **{f"s2_GAP_FFN.{k}": s for k, s in _gap_ffn(e).items()},
    }
    return {
        "name": f"croma_{size}",
        "adapter": "croma", "size": size,
        "keys": keys,
        "skip": {
            "s1_GAP_FFN.*": "contrastive GAP projection from CROMA "
                            "pretraining; the adapter consumes patch "
                            "encodings, not the GAP vector (reference "
                            "croma.py forward uses *_encodings)",
            "s2_GAP_FFN.*": "same as s1_GAP_FFN",
        },
    }


def prithvi_manifest(version: str) -> dict[str, Any]:
    """terratorch prithvi_eo_{v1_100,v2_300,v2_300_tl} encoder layout:
    Conv3d patch kernel [E, 6, 1, 16, 16] over the six HLS bands
    (prithvi.py:156-182), timm blocks, 3-D sincos pos_embed (shape depends
    on num_frames -> not pinned), plus the v2 'TL' temporal/location
    encoder linears."""
    e = {"v1_100": 768, "v2_300": 1024, "v2_300_tl": 1024}[version]
    depth = {"v1_100": 12, "v2_300": 24, "v2_300_tl": 24}[version]
    keys: dict[str, Any] = {
        "patch_embed.proj.weight": [e, 6, 1, 16, 16],
        "patch_embed.proj.bias": [e],
        "cls_token": [1, 1, e],
        "pos_embed": None,  # [1, T*196+1, E]; T varies per release
        **_blocks("blocks.", depth, e),
        "norm.weight": [e], "norm.bias": [e],
    }
    skip = {
        "pos_embed": "fixed 3-D sincos regenerated on device for the "
                     "experiment's own (num_dates, grid) "
                     "(baselines/prithvi.py sincos_3d)",
        "mask_token": "MAE pretraining token (encoder-only adapter)",
        "decoder_*": "MAE decoder (encoder-only adapter)",
    }
    if version == "v2_300_tl":
        # terratorch TemporalEncoder/LocationEncoder: sincos features at
        # embed_dim width -> Linear(E, E) (mirrored by
        # baselines/prithvi.py temp_proj)
        keys["temporal_embed_enc.weight"] = [e, e]
        keys["temporal_embed_enc.bias"] = [e]
        keys["location_embed_enc.weight"] = [e, e]
        keys["location_embed_enc.bias"] = [e]
        skip["location_embed_enc.*"] = (
            "MAESTRO never feeds coordinates; the reference formats dates "
            "only (prithvi.py:198-202 format_dates)"
        )
    return {
        "name": f"prithvi_eo_{version}",
        "adapter": "prithvi",
        "size": {"v1_100": "base", "v2_300": "large",
                 "v2_300_tl": "large"}[version],
        "keys": keys,
        "skip": skip,
    }


def dinov2_hf_manifest(size: str) -> dict[str, Any]:
    """HF facebook/dinov2-{size} pytorch_model.bin (Dinov2Model): img 518 /
    patch 14 -> 1370 positions, layer-scale blocks, final layernorm."""
    e = {"small": 384, "base": 768, "large": 1024}[size]
    depth = {"small": 12, "base": 12, "large": 24}[size]
    emb = "embeddings."
    keys: dict[str, Any] = {
        f"{emb}cls_token": [1, 1, e],
        f"{emb}mask_token": [1, e],
        f"{emb}position_embeddings": [1, 1370, e],
        f"{emb}patch_embeddings.projection.weight": [e, 3, 14, 14],
        f"{emb}patch_embeddings.projection.bias": [e],
        "layernorm.weight": [e], "layernorm.bias": [e],
    }
    for i in range(depth):
        p = f"encoder.layer.{i}."
        att = f"{p}attention.attention."
        for n in ("query", "key", "value"):
            keys[f"{att}{n}.weight"] = [e, e]
            keys[f"{att}{n}.bias"] = [e]
        keys[f"{p}attention.output.dense.weight"] = [e, e]
        keys[f"{p}attention.output.dense.bias"] = [e]
        keys[f"{p}layer_scale1.lambda1"] = [e]
        keys[f"{p}layer_scale2.lambda1"] = [e]
        for n in ("norm1", "norm2"):
            keys[f"{p}{n}.weight"] = [e]
            keys[f"{p}{n}.bias"] = [e]
        keys[f"{p}mlp.fc1.weight"] = [4 * e, e]
        keys[f"{p}mlp.fc1.bias"] = [4 * e]
        keys[f"{p}mlp.fc2.weight"] = [e, 4 * e]
        keys[f"{p}mlp.fc2.bias"] = [e]
    return {
        "name": f"dinov2_{size}_hf",
        "adapter": "dinov2", "size": size,
        "keys": keys,
        "skip": {
            "embeddings.mask_token": "iBOT masking token; the adapter "
                                     "never masks (reference dinov2.py "
                                     "loads the full dict but the forward "
                                     "uses bool_masked_pos=None)",
        },
    }


ALL_MANIFESTS = {
    "satmae_base": lambda: satmae_manifest("base"),
    "satmae_large": lambda: satmae_manifest("large"),
    "dofa_base": lambda: dofa_manifest("base"),
    "dofa_large": lambda: dofa_manifest("large"),
    "croma_base": lambda: croma_manifest("base"),
    "croma_large": lambda: croma_manifest("large"),
    "prithvi_v1_100": lambda: prithvi_manifest("v1_100"),
    "prithvi_v2_300": lambda: prithvi_manifest("v2_300"),
    "prithvi_v2_300_tl": lambda: prithvi_manifest("v2_300_tl"),
    "dinov2_small": lambda: dinov2_hf_manifest("small"),
    "dinov2_base": lambda: dinov2_hf_manifest("base"),
    "dinov2_large": lambda: dinov2_hf_manifest("large"),
}

# (adapter, size) -> default manifest name used by the port CLI
DEFAULT_FOR = {
    ("satmae", "base"): "satmae_base",
    ("satmae", "large"): "satmae_large",
    ("dofa", "base"): "dofa_base",
    ("dofa", "large"): "dofa_large",
    ("croma", "base"): "croma_base",
    ("croma", "large"): "croma_large",
    ("prithvi", "base"): "prithvi_v1_100",
    ("prithvi", "large"): "prithvi_v2_300_tl",
    ("dinov2", "small"): "dinov2_small",
    ("dinov2", "base"): "dinov2_base",
    ("dinov2", "large"): "dinov2_large",
}


# ---------------------------------------------------------------------------
# Source-access recording + coverage verification


class RecordingDict(dict):
    """State-dict wrapper that records which keys the port map CONSUMES.

    ``__getitem__``/``get`` count as consumption; ``in`` checks are probes
    and do not.  Nested sub-dicts (the CROMA release) are wrapped on access
    so their reads record under a dotted prefix.
    """

    def __init__(self, data: dict, prefix: str = "",
                 accessed: set[str] | None = None) -> None:
        super().__init__(data)
        self.prefix = prefix
        self.accessed: set[str] = accessed if accessed is not None else set()

    def _wrap(self, key: str, value):
        if isinstance(value, dict) and not isinstance(value, RecordingDict):
            return RecordingDict(value, f"{self.prefix}{key}.", self.accessed)
        if not isinstance(value, dict):
            self.accessed.add(f"{self.prefix}{key}")
        return value

    def __getitem__(self, key):
        return self._wrap(key, super().__getitem__(key))

    def get(self, key, default=None):
        if key in set(super().keys()):
            return self._wrap(key, super().__getitem__(key))
        return default


@dataclass
class CoverageError(Exception):
    """Raised when a port run violates its release manifest."""

    manifest: str
    unconsumed: list[str] = field(default_factory=list)
    unknown_reads: list[str] = field(default_factory=list)
    missing: list[str] = field(default_factory=list)
    bad_shapes: list[str] = field(default_factory=list)

    def __str__(self) -> str:
        parts = [f"port coverage check failed against manifest "
                 f"{self.manifest!r}:"]
        if self.unconsumed:
            parts.append(
                f"  {len(self.unconsumed)} source keys neither consumed nor "
                f"skip-listed (release holds weights the port silently "
                f"drops): {self.unconsumed[:10]}")
        if self.unknown_reads:
            parts.append(
                f"  {len(self.unknown_reads)} keys read by the port but "
                f"absent from the manifest (the release will not have "
                f"them): {self.unknown_reads[:10]}")
        if self.missing:
            parts.append(
                f"  {len(self.missing)} manifest keys absent from the "
                f"checkpoint (wrong file / size / variant?): "
                f"{self.missing[:10]}")
        if self.bad_shapes:
            parts.append(
                f"  {len(self.bad_shapes)} keys with unexpected shapes: "
                f"{self.bad_shapes[:10]}")
        return "\n".join(parts)


def _skipped(key: str, skip: dict[str, str]) -> bool:
    return any(fnmatch.fnmatchcase(key, pat) for pat in skip)


def flatten_source(src: dict, prefix: str = "") -> dict[str, Any]:
    """Flatten a (possibly nested, e.g. CROMA) release dict to dotted keys."""
    out: dict[str, Any] = {}
    for k, v in src.items():
        if isinstance(v, dict):
            out.update(flatten_source(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def verify_coverage(manifest: dict, src: dict,
                    accessed: set[str]) -> None:
    """Check a completed port run against the release manifest.

    ``src`` is the actual loaded checkpoint (flat or nested), ``accessed``
    the keys the port map consumed (RecordingDict.accessed).  Raises
    CoverageError listing every violation; returns None when clean.
    """
    keys: dict[str, Any] = manifest["keys"]
    skip: dict[str, str] = manifest.get("skip", {})
    flat = flatten_source(src)

    unconsumed = [
        k for k in flat
        if k not in accessed and not _skipped(k, skip)
    ]
    unknown = [k for k in accessed if k not in keys]
    missing = [k for k in keys if k not in flat and not _skipped(k, skip)]
    bad = []
    for k, shape in keys.items():
        if shape is None or k not in flat:
            continue
        actual = list(np.shape(flat[k]))
        if actual != list(shape):
            bad.append(f"{k}: manifest {list(shape)} vs file {actual}")
    if unconsumed or unknown or missing or bad:
        raise CoverageError(manifest["name"], sorted(unconsumed),
                            sorted(unknown), sorted(missing), sorted(bad))


def synthesize_state_dict(manifest: dict, nested: bool = False,
                          seed: int = 0) -> dict:
    """Random state dict with exactly the manifest's keys and shapes (CI
    stand-in for the real release).  Unpinned shapes (None) get a
    documented placeholder.  ``nested=True`` rebuilds the CROMA-style
    sub-dict layout from the dotted keys."""
    rng = np.random.default_rng(seed)
    placeholder = {
        "pos_embed": (1, 3 * 196 + 1,
                      1024 if "v2" in manifest["name"] else 768),
    }
    flat = {}
    for k, shape in manifest["keys"].items():
        s = tuple(shape) if shape is not None else placeholder[k]
        flat[k] = rng.normal(0.0, 0.02, s).astype(np.float32)
    if not nested:
        return flat
    tree: dict = {}
    for k, v in flat.items():
        top, rest = k.split(".", 1)
        tree.setdefault(top, {})[rest] = v
    return tree
