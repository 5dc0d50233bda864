"""Port HF DINOv2 weights to the DINOv2 adapter's flax-named tree.

The port's copy of the JAX package's ``port/dinov2_port.py``.  Reference
weight-surgery semantics: reference maestro/baselines/dinov2.py:148-278 +
baselines/utils.py — per-modality patch embeds take the RGB conv kernel
channel-padded with N(0, 0.01^2) beyond the first 3 source channels; the
encoder/layernorm load as-is; 'sat' checkpoints are dequantized torch dumps
(``fm_port.dequantize_state_dict``).
"""

from __future__ import annotations

import numpy as np


def _linear(w: np.ndarray) -> np.ndarray:
    return w.T


def map_hf_dinov2_encoder(src: dict, depth: int, prefix: str = "encoder.") -> dict:
    """HF Dinov2Encoder state dict -> baselines.backbone.EncoderBlock params."""
    out = {}
    for i in range(depth):
        p = f"{prefix}layer.{i}."
        att = f"{p}attention.attention."
        q_w, k_w, v_w = (src[f"{att}{n}.weight"] for n in ("query", "key", "value"))
        q_b, k_b, v_b = (src[f"{att}{n}.bias"] for n in ("query", "key", "value"))
        out[f"block{i}"] = {
            "norm1": {"scale": src[f"{p}norm1.weight"],
                      "bias": src[f"{p}norm1.bias"]},
            "qkv": {
                "kernel": np.concatenate(
                    [_linear(q_w), _linear(k_w), _linear(v_w)], axis=1,
                ),
                "bias": np.concatenate([q_b, k_b, v_b]),
            },
            "proj": {
                "kernel": _linear(src[f"{p}attention.output.dense.weight"]),
                "bias": src[f"{p}attention.output.dense.bias"],
            },
            "ls1": src[f"{p}layer_scale1.lambda1"],
            "norm2": {"scale": src[f"{p}norm2.weight"],
                      "bias": src[f"{p}norm2.bias"]},
            "fc1": {"kernel": _linear(src[f"{p}mlp.fc1.weight"]),
                    "bias": src[f"{p}mlp.fc1.bias"]},
            "fc2": {"kernel": _linear(src[f"{p}mlp.fc2.weight"]),
                    "bias": src[f"{p}mlp.fc2.bias"]},
            "ls2": src[f"{p}layer_scale2.lambda1"],
        }
    return out


def pad_patch_kernel(
    conv_weight: np.ndarray,  # [E, 3, p, p] RGB kernel
    num_channels: int,
    std: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Channel-pad the RGB patch kernel with N(0, std^2) for >3-band inputs."""
    e, c_in, ph, pw = conv_weight.shape
    if num_channels <= c_in:
        return conv_weight[:, :num_channels]
    rng = np.random.default_rng(seed)
    pad = rng.normal(0.0, std, (e, num_channels - c_in, ph, pw)).astype(
        conv_weight.dtype,
    )
    return np.concatenate([conv_weight, pad], axis=1)


def conv_to_patch_dense(conv_weight: np.ndarray) -> np.ndarray:
    """[E, C, p, p] conv kernel -> [C*p*p, E] dense kernel (C, ph, pw order)."""
    e = conv_weight.shape[0]
    return conv_weight.reshape(e, -1).T


def port_dinov2(
    src: dict[str, np.ndarray],
    mods: dict[str, int],  # modality -> num input channels
    encoder_names: tuple[str, ...],
    depth: int,
    keep_norm: bool = True,
    emb_prefix: str = "embeddings.",
    enc_prefix: str = "encoder.",
) -> dict:
    """HF Dinov2Model-style state dict -> Dinov2Baseline params tree."""
    params: dict = {}
    conv_w = src[f"{emb_prefix}patch_embeddings.projection.weight"]
    conv_b = src[f"{emb_prefix}patch_embeddings.projection.bias"]
    for name, chans in mods.items():
        padded = pad_patch_kernel(conv_w, chans)
        params[f"patch_projs_{name}"] = {
            "kernel": conv_to_patch_dense(padded),
            "bias": conv_b,
        }
        params[f"cls_{name}"] = src[f"{emb_prefix}cls_token"]
        params[f"pos_{name}"] = src[f"{emb_prefix}position_embeddings"]

    encoder_params = map_hf_dinov2_encoder(src, depth, enc_prefix)
    for enc in encoder_names:
        params[f"encoders_{enc}"] = encoder_params

    if keep_norm and "layernorm.weight" in src:
        params["final_norm"] = {"scale": src["layernorm.weight"],
                                "bias": src["layernorm.bias"]}
    return {"params": params}
