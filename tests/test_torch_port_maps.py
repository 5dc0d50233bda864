"""The port's release maps (``maestro_tpu_torch.port``) against the JAX
package's, on the CPU.

For each of the 12 committed release manifests (``tests/manifests/``), a
state dict with exactly the manifest's keys and shapes, at the real release
size, goes through the port's map (``scripts/port_fm.port_fm_params``) and
through the JAX package's (its ``scripts/port_fm.py``); both maps are numpy
only, so nothing is traced, and every flax-named leaf must be bit-identical.
The port's coverage check must pass on it, and the adapter's template (built
on the ``meta`` device) must have every backbone parameter covered.  The
sources are windows of one pool of normals (``_release_source``) because the
manifests' own ``synthesize_state_dict`` draws every value and takes about
60 s over the twelve; that function is held to the JAX package's on small
manifests.  Also: the manifests and ``gen_manifests``' JSON against the
committed fixtures; the three negative coverage tests of
``tests/test_port_manifests.py``; and fp32 forward parity of the ported
weights against the timm-style block, the CROMA ViT and a random-config
``transformers`` DINOv2 (``tests/test_fm_port.py``,
``tests/test_dinov2_port.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.conf import ExperimentConfig as JExperimentConfig
from maestro_tpu.conf import ModelConfig as JModelConfig
from maestro_tpu.models.factory import build_experiment_model as j_build_experiment_model
from maestro_tpu.port import manifests as jmf
from maestro_tpu.port.fm_port import rename_dinov2_backbone as j_rename_dinov2_backbone
from maestro_tpu_torch.baselines.backbone import EncoderBlock, EncoderStack
from maestro_tpu_torch.baselines.croma import CromaViT, get_2d_alibi
from maestro_tpu_torch.main import parse_cli
from maestro_tpu_torch.models.factory import build_experiment_model
from maestro_tpu_torch.port import manifests as mf
from maestro_tpu_torch.port.dinov2_port import conv_to_patch_dense, map_hf_dinov2_encoder
from maestro_tpu_torch.port.fm_port import map_timm_block, port_croma, rename_dinov2_backbone
from maestro_tpu_torch.port.from_jax import load_jax_params, match_jax_params
from maestro_tpu_torch.scripts import gen_manifests
from maestro_tpu_torch.scripts.port_fm import port_fm_params

from _torch_port_utils import single_thread_torch  # noqa: F401
from fixtures import load_script

pytestmark = pytest.mark.usefixtures("single_thread_torch")

MANIFEST_DIR = Path(__file__).resolve().parent / "manifests"

# manifest -> (adapter, model_size, fusion, extra overrides): the experiment
# config whose template the release warm-starts
S2_ONLY = 'datasets.pastis_hd.filter_inputs=["s2"]'
RELEASES = {
    "satmae_base": ("satmae", "base", "mod", [S2_ONLY]),
    "satmae_large": ("satmae", "large", "mod", [S2_ONLY]),
    "dofa_base": ("dofa", "base", "shared", []),
    "dofa_large": ("dofa", "large", "shared", []),
    "croma_base": ("croma", "base", "inter-croma", []),
    "croma_large": ("croma", "large", "inter-croma", []),
    "prithvi_v1_100": ("prithvi", "base", "mod", [S2_ONLY, "model.add_date_enc=false"]),
    "prithvi_v2_300": ("prithvi", "large", "mod", [S2_ONLY, "model.add_date_enc=false"]),
    "prithvi_v2_300_tl": ("prithvi", "large", "mod", [S2_ONLY, "model.version=v2"]),
    "dinov2_small": ("dinov2", "small", "shared", []),
    "dinov2_base": ("dinov2", "base", "shared", []),
    "dinov2_large": ("dinov2", "large", "shared", []),
}


def load_manifest(name: str) -> dict:
    return json.loads((MANIFEST_DIR / f"{name}.json").read_text())


def _release_source(manifest: dict, seed: int = 0) -> dict:
    """A flat state dict with the manifest's keys and shapes: each tensor is a
    window of one pool of 2^22 float32 normals, tiled, at its own offset, so
    that tensors of one shape differ (a map that swaps two fails) and a
    release of 300 M values costs copies, not draws."""
    pool = np.random.default_rng(seed).standard_normal(1 << 22, dtype=np.float32)
    out = {}
    for i, (k, shape) in enumerate(manifest["keys"].items()):
        if shape is None:  # unpinned: synthesize_state_dict's placeholder
            one = {"name": manifest["name"], "keys": {k: None}}
            shape = mf.synthesize_state_dict(one)[k].shape
        off = (i * 104_729) % (pool.size - 1)
        out[k] = np.resize(pool[off:], int(np.prod(shape))).reshape(shape)
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        top, rest = k.split(".", 1)
        tree.setdefault(top, {})[rest] = v
    return tree


def _overrides(manifest_name: str) -> list[str]:
    model, size, fusion, extra = RELEASES[manifest_name]
    return [f"model.model={model}", f"model.model_size={size}", f"model.fusion_mode={fusion}",
            "datasets.name_dataset=pastis_hd", *extra]


def _jax_map(manifest_name: str, src: dict) -> dict:
    """The JAX package's own dispatch (its scripts/port_fm.py) on ``src``."""
    cli = load_script("port_fm")
    model, size, fusion, extra = RELEASES[manifest_name]
    datasets = JDatasetsConfig(name_dataset="pastis_hd")
    if S2_ONLY in extra:
        datasets.pastis_hd.filter_inputs = ["s2"]
        datasets.pastis_hd.__post_init__()
    jmodel_cfg = JModelConfig(
        model=model, model_size=size, fusion_mode=fusion,
        add_date_enc="model.add_date_enc=false" not in extra,
        version="v2" if "model.version=v2" in extra else None,
    )
    jmodel, _, _ = j_build_experiment_model(datasets, JExperimentConfig(model=jmodel_cfg))
    return cli.port_fm_params(model, src, jmodel, datasets)


def _flat_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_manifests_match_jax_and_fixtures():
    """The port's manifests are the JAX package's, and the committed JSON."""
    assert set(mf.ALL_MANIFESTS) == set(jmf.ALL_MANIFESTS) == set(RELEASES)
    assert mf.DEFAULT_FOR == jmf.DEFAULT_FOR
    for name, gen in mf.ALL_MANIFESTS.items():
        assert gen() == jmf.ALL_MANIFESTS[name]() == load_manifest(name), name


def test_gen_manifests_writes_the_committed_fixtures(tmp_path):
    gen_manifests.main(["--out", str(tmp_path)])
    written = sorted(p.name for p in tmp_path.iterdir())
    assert written == sorted(p.name for p in MANIFEST_DIR.glob("*.json"))
    for name in written:
        assert (tmp_path / name).read_bytes() == (MANIFEST_DIR / name).read_bytes(), name


@pytest.mark.parametrize("manifest_name, nested", [("prithvi_v2_300_tl", False),
                                                  ("croma_base", True)])
def test_synthesize_state_dict_matches_jax(manifest_name, nested):
    """The port's copy draws what the JAX package's draws: Prithvi's unpinned
    pos_embed at its placeholder, CROMA's nested layout."""
    manifest = load_manifest(manifest_name)
    keys = dict(list(manifest["keys"].items())[:6])
    small = {"name": manifest["name"], "keys": keys}
    got = mf.synthesize_state_dict(small, nested=nested, seed=3)
    want = jmf.synthesize_state_dict(small, nested=nested, seed=3)
    assert got.keys() == want.keys()
    got_flat, want_flat = mf.flatten_source(got), jmf.flatten_source(want)
    assert list(got_flat) == list(keys) == list(want_flat)
    for k, a in got_flat.items():
        assert a.dtype == want_flat[k].dtype and np.array_equal(a, want_flat[k]), k
    if not nested:
        assert got_flat["pos_embed"].shape == (1, 3 * 196 + 1, 1024)


@pytest.mark.parametrize("manifest_name", list(RELEASES))
def test_release_map_matches_jax(manifest_name):
    """Release size: the port's map gives the JAX package's leaves bit for
    bit, its coverage check passes, and the adapter's template has every
    backbone parameter covered (only the heads keep their fresh values)."""
    manifest = load_manifest(manifest_name)
    flat = _release_source(manifest)
    nested = RELEASES[manifest_name][0] == "croma"
    src = _nest(flat) if nested else flat

    cfg, datasets = parse_cli(_overrides(manifest_name))
    template, plan, _ = build_experiment_model(datasets, cfg, dtype=torch.float32, device="meta")
    recorder = mf.RecordingDict(src)
    ported = port_fm_params(cfg.model.model, recorder, cfg, plan, datasets)
    mf.verify_coverage(manifest, src, recorder.accessed)

    want = dict(_flat_leaves(_jax_map(manifest_name, src)))
    got = dict(_flat_leaves(ported))
    assert got.keys() == want.keys()
    for path, a in got.items():
        b = want[path]
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), path

    values, unknown, mismatched, unfilled = match_jax_params(template, ported)
    assert values and not mismatched, mismatched[:5]
    assert [n for n in unfilled if not n.startswith("heads.")] == []
    # the ported leaves a template lacks are the map's extras, never a backbone loss
    assert all(not u.startswith(("blocks", "encoders", "s1_encoder", "s2_encoder"))
               for u in unknown), unknown[:5]


def _satmae_base():
    cfg, datasets = parse_cli(_overrides("satmae_base"))
    _, plan, _ = build_experiment_model(datasets, cfg, dtype=torch.float32, device="meta")
    return cfg, plan, datasets


def test_unknown_source_key_fails_loudly():
    """A release shipping a key the port silently drops is surfaced."""
    manifest = load_manifest("satmae_base")
    src = _release_source(manifest)
    src["channel_embed.weight"] = np.zeros((4, 256), np.float32)
    recorder = mf.RecordingDict(src)
    port_fm_params("satmae", recorder, *_satmae_base())
    with pytest.raises(mf.CoverageError, match="channel_embed.weight"):
        mf.verify_coverage(manifest, src, recorder.accessed)


def test_missing_manifest_key_fails_loudly():
    """A release missing keys the manifest pins is surfaced, even where the
    map tolerates the absence (optional-key branches)."""
    manifest = load_manifest("satmae_base")
    src = _release_source(manifest)
    del src["norm.weight"], src["norm.bias"]  # the map's `if` branch skips it
    recorder = mf.RecordingDict(src)
    port_fm_params("satmae", recorder, *_satmae_base())
    with pytest.raises(mf.CoverageError, match="norm.weight"):
        mf.verify_coverage(manifest, src, recorder.accessed)


def test_shape_drift_fails_loudly():
    manifest = load_manifest("dofa_base")
    src = _release_source(manifest)
    src["cls_token"] = np.zeros((1, 1, 512), np.float32)  # wrong width
    recorder = mf.RecordingDict(src)
    cfg, datasets = parse_cli(_overrides("dofa_base"))
    _, plan, _ = build_experiment_model(datasets, cfg, dtype=torch.float32, device="meta")
    port_fm_params("dofa", recorder, cfg, plan, datasets)
    with pytest.raises(mf.CoverageError, match="cls_token"):
        mf.verify_coverage(manifest, src, recorder.accessed)


# --------------------------------------------------------------------------
# forward parity of ported weights, fp32
# --------------------------------------------------------------------------
DIM, HEADS = 32, 4
FWD_ATOL = 1e-5


class TimmStyleBlock(nn.Module):
    """norm1 -> attn(qkv fused, bias) -> proj; norm2 -> mlp(fc1, fc2)."""

    def __init__(self):
        super().__init__()
        self.norm1 = nn.LayerNorm(DIM, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(DIM, DIM * 3, bias=True)
        self.attn.proj = nn.Linear(DIM, DIM)
        self.norm2 = nn.LayerNorm(DIM, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(DIM, DIM * 4)
        self.mlp.fc2 = nn.Linear(DIM * 4, DIM)

    def forward(self, x):
        y = self.norm1(x)
        qkv = self.attn.qkv(y).chunk(3, dim=-1)
        b, l, _ = x.shape
        dh = DIM // HEADS
        q, k, v = (t.reshape(b, l, HEADS, dh).transpose(1, 2) for t in qkv)
        attn = ((q @ k.transpose(-1, -2)) * dh**-0.5).softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, l, DIM)
        x = x + self.attn.proj(out)
        y = self.norm2(x)
        return x + self.mlp.fc2(torch.nn.functional.gelu(self.mlp.fc1(y)))


def test_timm_block_parity():
    torch.manual_seed(0)
    tblock = TimmStyleBlock().eval()
    x = torch.randn(2, 9, DIM)
    with torch.no_grad():
        want = tblock(x)
    src = {k: v.numpy() for k, v in tblock.state_dict().items()}
    block = EncoderBlock(DIM, HEADS, torch.float32, torch.Generator().manual_seed(0), "cpu")
    load_jax_params(block, {"params": map_timm_block(src, "")})
    with torch.no_grad():
        got = block(x)
    torch.testing.assert_close(got, want, atol=FWD_ATOL, rtol=0)


class CromaTorchViT(nn.Module):
    """The reference's croma.py ViT/BaseTransformer layout."""

    def __init__(self, depth=2, in_channels=2):
        super().__init__()
        p = 8
        self.linear_input = nn.Linear(p * p * in_channels, DIM)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList()
        for _ in range(depth):
            attn = nn.Module()
            attn.input_norm = nn.LayerNorm(DIM)
            attn.to_qkv = nn.Linear(DIM, DIM * 3, bias=False)
            attn.to_out = nn.Linear(DIM, DIM)
            ffn = nn.Module()
            ffn.input_norm = nn.LayerNorm(DIM)
            ffn.net = nn.Sequential(
                nn.Linear(DIM, DIM * 4), nn.GELU(), nn.Dropout(0.0), nn.Linear(DIM * 4, DIM),
            )
            self.transformer.layers.append(nn.ModuleList([attn, ffn]))
        self.transformer.norm_out = nn.LayerNorm(DIM)

    def forward(self, imgs, bias):
        p = 8
        b, c, hh, _ = imgs.shape
        g = hh // p
        x = imgs.reshape(b, c, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, c * p * p)
        x = self.linear_input(x)
        for attn, ffn in self.transformer.layers:
            y = attn.input_norm(x)
            qkv = attn.to_qkv(y).chunk(3, dim=-1)
            bsz, l, _ = x.shape
            dh = DIM // HEADS
            q, k, v = (t.reshape(bsz, l, HEADS, dh).transpose(1, 2) for t in qkv)
            logits = (q @ k.transpose(-1, -2)) * dh**-0.5 + bias
            out = (logits.softmax(dim=-1) @ v).transpose(1, 2).reshape(bsz, l, DIM)
            x = x + attn.to_out(out)
            x = x + ffn.net(ffn.input_norm(x))
        return self.transformer.norm_out(x)


def test_croma_vit_parity():
    torch.manual_seed(1)
    tvit = CromaTorchViT().eval()
    imgs = torch.randn(2, 2, 24, 24)
    bias = torch.from_numpy(get_2d_alibi(HEADS, 3))
    with torch.no_grad():
        want = tvit(imgs, bias)
    src = {"s1_encoder": {k: v.numpy() for k, v in tvit.state_dict().items()}}
    vit = CromaViT(DIM, 2, HEADS, 2, torch.float32, torch.Generator().manual_seed(0), "cpu")
    load_jax_params(vit, port_croma(src)["params"]["s1_encoder"])
    with torch.no_grad():
        got = vit(imgs, bias)
    torch.testing.assert_close(got, want, atol=FWD_ATOL, rtol=0)


def test_dinov2_hf_encoder_parity():
    """A random-config ``transformers`` DINOv2 encoder against the adapter's
    encoder stack carrying its weights; and the patch embedding's conv as the
    adapter's dense kernel."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.dinov2.modeling_dinov2 import Dinov2Embeddings, Dinov2Encoder

    cfg = transformers.Dinov2Config(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=256, patch_size=14, image_size=56, num_channels=3,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    enc = Dinov2Encoder(cfg).eval()
    for name, p in enc.named_parameters():  # LayerScale away from its 1.0 init
        if "lambda1" in name:
            p.data.normal_(1.0, 0.1)
    x = torch.randn(2, 17, 64)
    with torch.no_grad():
        want = enc(x)["last_hidden_state"]
    src = {k: v.numpy() for k, v in enc.state_dict().items()}
    stack = EncoderStack(64, 2, 2, torch.float32, torch.Generator().manual_seed(0), "cpu",
                         layerscale=True)
    load_jax_params(stack, map_hf_dinov2_encoder(src, 2, prefix=""))
    with torch.no_grad():
        got = stack(x)
    torch.testing.assert_close(got, want, atol=FWD_ATOL, rtol=0)

    emb = Dinov2Embeddings(cfg).eval()
    img = torch.randn(2, 3, 56, 56)
    with torch.no_grad():
        ref = emb(img)
    esrc = {k: v.numpy() for k, v in emb.state_dict().items()}
    kernel = torch.from_numpy(conv_to_patch_dense(esrc["patch_embeddings.projection.weight"]))
    xp = img.reshape(2, 3, 4, 14, 4, 14).permute(0, 2, 4, 1, 3, 5).reshape(2, 16, 3 * 14 * 14)
    tokens = xp @ kernel + torch.from_numpy(esrc["patch_embeddings.projection.bias"])
    tokens = torch.cat([torch.from_numpy(esrc["cls_token"]).expand(2, 1, 64), tokens], dim=1)
    tokens = tokens + torch.from_numpy(esrc["position_embeddings"])
    torch.testing.assert_close(tokens, ref, atol=FWD_ATOL, rtol=0)


def test_rename_dinov2_backbone_keys():
    src = {
        "backbone.cls_token": np.zeros((1, 1, 8)),
        "backbone.pos_embed": np.zeros((1, 5, 8)),
        "backbone.patch_embed.proj.weight": np.zeros((8, 3, 2, 2)),
        "backbone.blocks.0.attn.qkv.weight": np.arange(24 * 8).reshape(24, 8),
        "backbone.blocks.0.ls1.gamma": np.ones(8),
        "backbone.norm.weight": np.ones(8),
        "unrelated.key": np.zeros(1),
    }
    out = rename_dinov2_backbone(src)
    ref = j_rename_dinov2_backbone(src)
    assert out.keys() == ref.keys()
    for k in out:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert out["encoder.layer.0.attention.attention.query.weight"].shape == (8, 8)
    assert "embeddings.position_embeddings" in out and "layernorm.weight" in out
    assert not any(k.startswith("unrelated") for k in out)
