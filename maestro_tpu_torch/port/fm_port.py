"""Foundation-model checkpoint maps: timm-style ViTs (SatMAE, DOFA,
Prithvi) and CROMA, plus the DINOv2-sat surgery utilities.

The port's copy of the JAX package's ``port/fm_port.py``: numpy arrays in, a
nested dict under the adapters' flax names out, leaf for leaf the same
(``port/from_jax.py`` turns those names into the port's parameters).
Reference surgery semantics: reference maestro/baselines/utils.py (backbone
key renaming with fused-qkv splitting, quantized-linear dequantization) and
the vendored module layouts in baselines/{satmae,dofa,croma}.py.  Unmatched
leaves are reported by ``port.torch_port.merge_into_template``.
"""

from __future__ import annotations

import numpy as np
import torch

from maestro_tpu_torch.baselines.prithvi import ORIG_BANDS


def _linear(w: np.ndarray) -> np.ndarray:
    return w.T


def map_timm_block(src: dict, prefix: str) -> dict:
    """One timm ``Block`` (norm1/attn.qkv/attn.proj/norm2/mlp.fc1/fc2) ->
    baselines.backbone.EncoderBlock params (fused qkv kept fused)."""
    out = {
        "norm1": {"scale": src[f"{prefix}norm1.weight"],
                  "bias": src[f"{prefix}norm1.bias"]},
        "qkv": {"kernel": _linear(src[f"{prefix}attn.qkv.weight"])},
        "proj": {"kernel": _linear(src[f"{prefix}attn.proj.weight"]),
                 "bias": src[f"{prefix}attn.proj.bias"]},
        "norm2": {"scale": src[f"{prefix}norm2.weight"],
                  "bias": src[f"{prefix}norm2.bias"]},
        "fc1": {"kernel": _linear(src[f"{prefix}mlp.fc1.weight"]),
                "bias": src[f"{prefix}mlp.fc1.bias"]},
        "fc2": {"kernel": _linear(src[f"{prefix}mlp.fc2.weight"]),
                "bias": src[f"{prefix}mlp.fc2.bias"]},
    }
    if f"{prefix}attn.qkv.bias" in src:
        out["qkv"]["bias"] = src[f"{prefix}attn.qkv.bias"]
    if f"{prefix}ls1.gamma" in src:
        out["ls1"] = src[f"{prefix}ls1.gamma"]
        out["ls2"] = src[f"{prefix}ls2.gamma"]
    return out


def map_timm_blocks(src: dict, depth: int, prefix: str = "blocks.") -> dict:
    return {
        f"block{i}": map_timm_block(src, f"{prefix}{i}.") for i in range(depth)
    }


SATMAE_ORIG_BANDS = (0, 1, 2)  # S2 bands in the release (satmae.py:23)


def port_satmae(src: dict[str, np.ndarray], depth: int,
                bands: tuple[int, ...] | None = None, std: float = 0.01,
                seed: int = 0) -> dict:
    """SatMAE MaskedAutoencoderViT encoder -> SatMAEBaseline params.

    Reference layout: baselines/satmae.py:252-330 (patch_embed.proj conv,
    cls_token, timm blocks, final norm).  The release patchifies 3 channels
    (ORIG_BANDS); when the dataset uses more S2 bands, the reference pads
    the kernel with N(0, 0.01) and keeps the pretrained slices at the
    bands' dataset positions (satmae.py:172-189) — replicated here when the
    channel counts differ (a same-width source is used as-is, which equals
    the surgery when bands == ORIG_BANDS).
    """
    conv = src["patch_embed.proj.weight"]  # [E, C_src, p, p]
    e, c_src, p, _ = conv.shape
    if bands is not None and len(bands) != c_src:
        rng = np.random.default_rng(seed)
        full = rng.normal(0.0, std, (e, len(bands), p, p)).astype(conv.dtype)
        orig_idx = [i for i, b in enumerate(SATMAE_ORIG_BANDS) if b in bands]
        new_idx = [list(bands).index(SATMAE_ORIG_BANDS[i]) for i in orig_idx]
        full[:, new_idx] = conv[:, orig_idx]
        conv = full
    params = {
        "patch_proj": {
            # SatMAE patchifies as flattened (C, ph, pw) like ours
            "kernel": conv.reshape(e, -1).T,
            "bias": src["patch_embed.proj.bias"],
        },
        "cls_token": src["cls_token"],
        **{f"blocks_{i}": b for i, b in enumerate(
            map_timm_blocks(src, depth).values())},
    }
    if "norm.weight" in src:
        params["final_norm"] = {"scale": src["norm.weight"],
                                "bias": src["norm.bias"]}
    return {"params": params}


def port_dofa(
    src: dict[str, np.ndarray],
    depth: int,
    mods: tuple[str, ...],
    encoders: tuple[str, ...] = ("shared",),
) -> dict:
    """DOFA released checkpoint (torchgeo OFAViT layout) -> DOFABaseline.

    Source keys (reference baselines/dofa.py:460-678: Dynamic_MLP_OFA's
    ``weight_generator`` TransformerWeightGenerator + ``fclayer`` FCResLayer,
    timm blocks, pos_embed/cls_token/norm).  The reference transfers the ONE
    released patch_embed + pos_embed into EVERY modality's embedder
    (dofa.py:202-204); we replicate the same tree per modality.
    """
    wg = "patch_embed.weight_generator."
    te = f"{wg}transformer_encoder.layers.0."
    embed = {
        "weight_tokens": src[f"{wg}weight_tokens"],
        "bias_token": src[f"{wg}bias_token"],
        "fc_weight": {"kernel": _linear(src[f"{wg}fc_weight.weight"]),
                      "bias": src[f"{wg}fc_weight.bias"]},
        "fc_bias": {"kernel": _linear(src[f"{wg}fc_bias.weight"]),
                    "bias": src[f"{wg}fc_bias.bias"]},
        "fcres_w1": {"kernel": _linear(src["patch_embed.fclayer.w1.weight"]),
                     "bias": src["patch_embed.fclayer.w1.bias"]},
        "fcres_w2": {"kernel": _linear(src["patch_embed.fclayer.w2.weight"]),
                     "bias": src["patch_embed.fclayer.w2.bias"]},
        "weight_gen": {
            # torch TransformerEncoderLayer (norm_first=False): fused
            # in_proj -> qkv, out_proj -> proj, linear1/2 -> fc1/fc2
            "qkv": {"kernel": _linear(src[f"{te}self_attn.in_proj_weight"]),
                    "bias": src[f"{te}self_attn.in_proj_bias"]},
            "proj": {"kernel": _linear(src[f"{te}self_attn.out_proj.weight"]),
                     "bias": src[f"{te}self_attn.out_proj.bias"]},
            "norm1": {"scale": src[f"{te}norm1.weight"],
                      "bias": src[f"{te}norm1.bias"]},
            "norm2": {"scale": src[f"{te}norm2.weight"],
                      "bias": src[f"{te}norm2.bias"]},
            "fc1": {"kernel": _linear(src[f"{te}linear1.weight"]),
                    "bias": src[f"{te}linear1.bias"]},
            "fc2": {"kernel": _linear(src[f"{te}linear2.weight"]),
                    "bias": src[f"{te}linear2.bias"]},
        },
    }
    params: dict = {"cls_token": src["cls_token"]}
    for m in mods:
        params[f"embedders_{m}"] = embed
        params[f"pos_{m}"] = src["pos_embed"]
    blocks = map_timm_blocks(src, depth)
    for enc in encoders:
        for i, b in enumerate(blocks.values()):
            params[f"blocks_{enc}_{i}"] = b
    if "norm.weight" in src:
        params["final_norm"] = {"scale": src["norm.weight"],
                                "bias": src["norm.bias"]}
    return {"params": params}


def port_prithvi(
    src: dict[str, np.ndarray],
    depth: int,
    bands: tuple[int, ...],
    std: float = 0.01,
    seed: int = 0,
) -> dict:
    """Prithvi-EO released checkpoint (terratorch PrithviViT layout) ->
    PrithviBaseline params, with the reference's HLS->S2 channel surgery.

    The released Conv3d patch kernel [E, 6, 1, p, p] covers the six HLS
    bands ORIG_BANDS = (0, 1, 2, 6, 8, 9) as S2 band indices; dataset bands
    present in ORIG_BANDS take the pretrained kernel slices, the rest get
    N(0, 0.01) init (reference prithvi.py:154-182).  Tubelet size is 1, so
    the Conv3d is exactly a per-date dense over (C, ph, pw) features.
    ``temporal_embed_enc`` (the v2 "_tl" temporal encoder linear) maps to
    ``temp_proj`` when present.
    """
    conv = src["patch_embed.proj.weight"]  # [E, 6, 1, p, p]
    e, _, _, p, _ = conv.shape
    rng = np.random.default_rng(seed)
    full = rng.normal(0.0, std, (e, len(bands), p, p)).astype(conv.dtype)
    orig_idx = [i for i, b in enumerate(ORIG_BANDS) if b in bands]
    new_idx = [list(bands).index(ORIG_BANDS[i]) for i in orig_idx]
    full[:, new_idx] = conv[:, orig_idx, 0]

    params: dict = {
        "patch_proj": {
            "kernel": full.reshape(e, -1).T,  # (C, ph, pw) feature order
            "bias": src["patch_embed.proj.bias"],
        },
        "cls_token": src["cls_token"],
        **{f"blocks_{i}": b
           for i, b in enumerate(map_timm_blocks(src, depth).values())},
    }
    if "temporal_embed_enc.weight" in src:
        params["temp_proj"] = {
            "kernel": _linear(src["temporal_embed_enc.weight"]),
            "bias": src["temporal_embed_enc.bias"],
        }
    if "norm.weight" in src:
        params["final_norm"] = {"scale": src["norm.weight"],
                                "bias": src["norm.bias"]}
    return {"params": params}


def port_croma(src: dict[str, np.ndarray]) -> dict:
    """CROMA released checkpoint dict -> CromaBaseline params.

    The release stores separate sub-dicts: s1_encoder / s2_encoder /
    joint_encoder (reference croma.py:386-436).  The ViT layout is
    ``BaseTransformer``: per layer ``attn.{input_norm,to_qkv,to_out}`` and
    ``ffn.{input_norm,net.0,net.2}`` wrapped in ``transformer.layers.N``.
    """
    params: dict = {}
    for enc_name, dst in (("s1_encoder", "s1_encoder"),
                          ("s2_encoder", "s2_encoder")):
        sub = src.get(enc_name)
        if sub is None:
            continue
        tree: dict = {}
        if "linear_input.weight" in sub:
            tree["embed"] = {"kernel": _linear(sub["linear_input.weight"]),
                             "bias": sub["linear_input.bias"]}
        i = 0
        while f"transformer.layers.{i}.0.input_norm.weight" in sub:
            attn = f"transformer.layers.{i}.0."
            ffn = f"transformer.layers.{i}.1."
            tree[f"attn{i}"] = {
                "norm": {"scale": sub[f"{attn}input_norm.weight"],
                         "bias": sub[f"{attn}input_norm.bias"]},
                "qkv": {"kernel": _linear(sub[f"{attn}to_qkv.weight"])},
                "out": {"kernel": _linear(sub[f"{attn}to_out.weight"]),
                        "bias": sub[f"{attn}to_out.bias"]},
            }
            tree[f"ffn{i}"] = _croma_ffn(sub, ffn)
            i += 1
        if "transformer.norm_out.weight" in sub:
            tree["norm"] = {"scale": sub["transformer.norm_out.weight"],
                            "bias": sub["transformer.norm_out.bias"]}
        params[dst] = tree

    joint = src.get("joint_encoder")
    if joint is not None:
        i = 0
        while f"layers.{i}.0.input_norm.weight" in joint:
            sa, xa, ffn = (f"layers.{i}.{j}." for j in range(3))
            params[f"joint_self_attns_{i}"] = {
                "norm": {"scale": joint[f"{sa}input_norm.weight"],
                         "bias": joint[f"{sa}input_norm.bias"]},
                "qkv": {"kernel": _linear(joint[f"{sa}to_qkv.weight"])},
                "out": {"kernel": _linear(joint[f"{sa}to_out.weight"]),
                        "bias": joint[f"{sa}to_out.bias"]},
            }
            params[f"cross_attns_{i}"] = {
                "norm": {"scale": joint[f"{xa}input_norm.weight"],
                         "bias": joint[f"{xa}input_norm.bias"]},
                "to_q": {"kernel": _linear(joint[f"{xa}to_q.weight"])},
                "to_k": {"kernel": _linear(joint[f"{xa}to_k.weight"])},
                "to_v": {"kernel": _linear(joint[f"{xa}to_v.weight"])},
                "out": {"kernel": _linear(joint[f"{xa}to_out.weight"]),
                        "bias": joint[f"{xa}to_out.bias"]},
            }
            params[f"cross_ffns_{i}"] = _croma_ffn(joint, ffn)
            i += 1
        if "norm_out.weight" in joint:
            params["cross_norm"] = {"scale": joint["norm_out.weight"],
                                    "bias": joint["norm_out.bias"]}
    return {"params": params}


def _croma_ffn(sub: dict, prefix: str) -> dict:
    """CROMA FFN Sequential: net.0 Linear, net.1 GELU, net.2 Dropout, net.3."""
    return {
        "norm": {"scale": sub[f"{prefix}input_norm.weight"],
                 "bias": sub[f"{prefix}input_norm.bias"]},
        "fc1": {"kernel": _linear(sub[f"{prefix}net.0.weight"]),
                "bias": sub[f"{prefix}net.0.bias"]},
        "fc2": {"kernel": _linear(sub[f"{prefix}net.3.weight"]),
                "bias": sub[f"{prefix}net.3.bias"]},
    }


def dequantize_state_dict(state_dict: dict) -> dict[str, np.ndarray]:
    """Unpack torch-quantized linear params (reference utils.py:81-98)."""
    out = {}
    for key, value in state_dict.items():
        if "_packed_params._packed_params" in key:
            layer = ".".join(key.split(".")[:-2])
            out[f"{layer}.weight"] = torch.dequantize(value[0]).numpy()
            out[f"{layer}.bias"] = torch.dequantize(value[1]).numpy()
        elif "_packed_params" not in key:
            out[key] = (
                value.numpy() if hasattr(value, "numpy") else np.asarray(value)
            )
    return out


def rename_dinov2_backbone(src: dict) -> dict:
    """Rename a raw DINOv2 'backbone.*' dump to HF layout for dinov2_port.

    Mirrors reference utils.py:24-78: strips the ``backbone.`` prefix, maps
    timm-ish names onto HF names, splits fused qkv into query/key/value.
    """
    assoc = {
        "cls_token": "cls_token",
        "mask_token": "mask_token",
        "pos_embed": "position_embeddings",
        "patch_embed": "patch_embeddings",
        "proj": "projection",
        "blocks": "layer",
        "ls1": "layer_scale1",
        "ls2": "layer_scale2",
        "attn": "attention.attention",
        "gamma": "lambda1",
    }
    out = {}
    for k, v in src.items():
        if not k.startswith("backbone."):
            continue
        parts = [assoc.get(p, p) for p in k.split(".")[1:]]
        nk = ".".join(parts)
        nk = nk.replace("attention.attention.projection", "attention.output.dense")
        if parts[0] in ("cls_token", "mask_token", "position_embeddings",
                        "patch_embeddings"):
            nk = "embeddings." + nk
        elif parts[0] == "layer":
            nk = "encoder." + nk
        elif parts[0] == "norm":
            nk = nk.replace("norm", "layernorm", 1)
        if ".scale" in nk or ".zero_point" in nk:
            continue
        if "qkv.weight" in nk:
            n = v.shape[0] // 3
            for i, name in enumerate(("query", "key", "value")):
                out[nk.replace("qkv", name)] = v[i * n : (i + 1) * n]
        elif "qkv.bias" in nk:
            n = v.shape[0] // 3
            for i, name in enumerate(("query", "key", "value")):
                out[nk.replace("qkv", name)] = v[i * n : (i + 1) * n]
        else:
            out[nk] = v
    return out
