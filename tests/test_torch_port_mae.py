"""The port's MAE checkpoint map (``maestro_tpu_torch.port.torch_port``) and
``scripts/port_checkpoint``, on the CPU.

* ``reference_state_dict`` (the port's parameters under the reference's
  lightning keys) is the JAX package's own inverse
  (``tests/test_mae_port_roundtrip.py::_to_torch_layout``) and
  ``port_mae_state_dict`` undoes it bit for bit; the port's map gives the
  JAX package's leaves bit for bit.
* A reference-layout MAE (``tests/test_full_forward_parity.TorchMAE``) at
  ``micro`` with head splits of its own (encoder 4 x 16, decoder 4 x 12, as a
  release's 12 x 64 / 16 x 32 differ from the port's 128-dim defaults),
  saved as a lightning ``.ckpt`` and ported by the CLI, gives TorchMAE's
  pretrain reconstruction, probe logits and segmentation logits within 1e-5
  in fp32 once the port runs the same splits; at the default splits, which
  load without an error, it does not.
* The same ported tree in the JAX package's MAE and in the port's gives the
  same forward within 1e-5.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.conf import MaskConfig as JMaskConfig
from maestro_tpu.conf import ModelConfig as JModelConfig
from maestro_tpu.models.mae import MAE_ARCHS as J_MAE_ARCHS
from maestro_tpu.models.mae import build_model as j_build_model
from maestro_tpu.port.torch_port import merge_into_template as j_merge_into_template
from maestro_tpu.port.torch_port import port_mae_state_dict as j_port_mae_state_dict
from maestro_tpu_torch.conf import DatasetsConfig, MaskConfig, ModelConfig
from maestro_tpu_torch.models.mae import build_model
from maestro_tpu_torch.port.from_jax import jax_tree
from maestro_tpu_torch.port.torch_port import (
    merge_into_template,
    port_mae_state_dict,
    reference_state_dict,
)
from maestro_tpu_torch.scripts import port_checkpoint
from maestro_tpu_torch.train import checkpoint as ckpt
from maestro_tpu_torch.utils.testing import make_synthetic_batch

from _torch_port_utils import single_thread_torch  # noqa: F401
from test_full_forward_parity import TorchMAE
from test_mae_port_roundtrip import _to_torch_layout

pytestmark = pytest.mark.usefixtures("single_thread_torch")

FWD_ATOL = 1e-5
# micro's own splits are encoder 2 x 32, decoder 2 x 24; the "release" here
# was trained with others, as the MAESTRO releases were
SPLITS = {"encoder_heads": 4, "encoder_dim_head": 16, "decoder_heads": 4, "decoder_dim_head": 12}
NO_MASK = {"mask_ratio": 0.0, "mask_scale": 0.0, "mask_mod": None}


def _port_model(dataset: str, device="cpu", seed: int = 0, **splits):
    cfg = ModelConfig(model_size="micro", fusion_mode="group", inter_depth=1, **splits)
    return build_model(DatasetsConfig(name_dataset=dataset), MaskConfig(**NO_MASK), cfg,
                       dtype=torch.float32, device=device,
                       generator=torch.Generator().manual_seed(seed))


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("dataset", ["treesatai_ts", "pastis_hd"])
def test_reference_state_dict_roundtrip(dataset):
    model, plan = _port_model(dataset, seed=3)
    sd = reference_state_dict(model)
    if dataset == "treesatai_ts":  # classification heads: the JAX test's inverse covers them
        want = _to_torch_layout(jax_tree(model), plan)
        assert sd.keys() == want.keys()
        for k, v in sd.items():
            assert np.array_equal(v, want[k]), k

    ported = port_mae_state_dict(sd, plan, model.head_specs)
    jmodel, jplan = j_build_model(JDatasetsConfig(name_dataset=dataset), JMaskConfig(),
                                  JModelConfig(model_size="micro", fusion_mode="group",
                                               inter_depth=1))
    j_ported = j_port_mae_state_dict(sd, jplan, jmodel.head_specs)
    got, want = dict(_leaves(ported)), dict(_leaves(j_ported))
    assert got.keys() == want.keys()
    for path, v in got.items():
        assert v.dtype == want[path].dtype and np.array_equal(v, want[path]), path

    template, _ = _port_model(dataset, device="meta")
    params, used, missing = merge_into_template(ported, template)
    assert not missing and len(used) == len(params)
    for name, p in model.named_parameters():
        assert torch.equal(params[name], p.detach()), name
    assert reference_state_dict(model, heads=False).keys() == {
        k for k in sd if not k.startswith("model.heads.")}


def _torch_mae(dataset: str, seed: int):
    jds = JDatasetsConfig(name_dataset=dataset)
    jmodel, jplan = j_build_model(jds, JMaskConfig(), JModelConfig(
        model_size="micro", fusion_mode="group", inter_depth=1))
    arch = dataclasses.replace(
        J_MAE_ARCHS["micro"], heads=SPLITS["encoder_heads"], dim_head=SPLITS["encoder_dim_head"],
        decoder_heads=SPLITS["decoder_heads"], decoder_dim_head=SPLITS["decoder_dim_head"])
    torch.manual_seed(seed)
    ref_input = jds.dataset.ref_input if dataset == "pastis_hd" else None
    return TorchMAE(jplan, arch, 1, jmodel.head_specs, ref_input=ref_input).eval(), jds


def _port_release(tmp_path, dataset: str, seed: int):
    tmae, jds = _torch_mae(dataset, seed)
    sd = {f"model.{k}": v for k, v in tmae.state_dict().items()}
    ckpt_file = tmp_path / "MAESTRO_release.ckpt"
    torch.save({"state_dict": sd, "epoch": 99}, ckpt_file)
    path = port_checkpoint.main(["--ckpt", str(ckpt_file), "--dataset", dataset,
                                 "--fusion-mode", "group", "--model-size", "micro",
                                 "--inter-depth", "1", "--out", str(tmp_path / "ported")])
    return tmae, jds, path


def test_ported_release_matches_torch_mae_at_its_splits(tmp_path):
    tmae, jds, path = _port_release(tmp_path, "treesatai_ts", seed=11)
    assert path.name == "pretrain-epoch=0" and ckpt.find_latest_checkpoint(
        tmp_path / "ported", "pretrain") == path
    batch = make_synthetic_batch(jds.dataset, 2, seed=5)
    with torch.no_grad():
        want_rec = tmae(batch, "pretrain")
        want_logits = tmae(batch, "probe")

    gaps = {}
    for splits in (SPLITS, {}):
        model, _ = _port_model("treesatai_ts", **splits)
        unmatched: list = []
        ckpt.load_weights(path, model, unmatched)
        assert unmatched == []  # a TorchMAE release carries its heads
        with torch.no_grad():
            rec, _, _ = model(_tensors(batch), "pretrain",
                              generator=torch.Generator().manual_seed(0))
            logits = model(_tensors(batch), "probe")
        pairs = [(rec[n], want_rec[n]) for n in want_rec]
        pairs += [(logits[n], want_logits[n]) for n in want_logits]
        gaps[bool(splits)] = max(float((a - b).abs().max()) for a, b in pairs)
        if splits:
            for a, b in pairs:
                torch.testing.assert_close(a, b, atol=FWD_ATOL, rtol=0)
    # the splits change no parameter shape: a wrong split loads silently and
    # only the forward shows it
    assert gaps[False] > 1e3 * FWD_ATOL, gaps


def test_ported_segmentation_release_matches_torch_mae(tmp_path):
    tmae, jds, path = _port_release(tmp_path, "pastis_hd", seed=7)
    batch = make_synthetic_batch(jds.dataset, 2, seed=5)
    model, _ = _port_model("pastis_hd", **SPLITS)
    ckpt.load_weights(path, model)
    with torch.no_grad():
        want = tmae(batch, "finetune")
        got = model(_tensors(batch), "finetune")
    for hs in model.head_specs:
        torch.testing.assert_close(got[hs.name], want[hs.name], atol=FWD_ATOL, rtol=0)


def test_ported_tree_gives_the_jax_forward():
    """One ported tree in both packages' MAEs (the reference splits set in
    both): the same probe logits and pretrain reconstruction."""
    tmae, jds = _torch_mae("treesatai_ts", seed=13)
    sd = {f"model.{k}": v.numpy() for k, v in tmae.state_dict().items()}
    jmodel, jplan = j_build_model(
        jds, JMaskConfig(**NO_MASK),
        JModelConfig(model_size="micro", fusion_mode="group", inter_depth=1, **SPLITS),
        dtype=jnp.float32)
    tree = port_mae_state_dict(sd, jplan, jmodel.head_specs)
    batch = make_synthetic_batch(jds.dataset, 2, seed=9)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    pre = jax.eval_shape(lambda: jmodel.init({"params": key, "mask": key}, jbatch, "pretrain"))
    probe = jax.eval_shape(lambda: jmodel.init({"params": key, "mask": key}, jbatch, "probe"))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            {"params": {**probe["params"], **pre["params"]}})
    jparams, _, missing = j_merge_into_template(tree, template)
    assert not missing
    j_logits = jax.jit(lambda p, b: jmodel.apply(p, b, "probe", rngs={"mask": key}))(
        jparams, jbatch)
    j_rec, _, _ = jax.jit(lambda p, b: jmodel.apply(p, b, "pretrain", rngs={"mask": key}))(
        jparams, jbatch)

    model, _ = _port_model("treesatai_ts", **SPLITS)
    merge_into_template(tree, model)
    with torch.no_grad():
        logits = model(_tensors(batch), "probe")
        rec, _, _ = model(_tensors(batch), "pretrain", generator=torch.Generator().manual_seed(0))
    for name, v in j_logits.items():
        np.testing.assert_allclose(logits[name].numpy(), np.asarray(v), atol=FWD_ATOL, rtol=0)
    for name, v in j_rec.items():
        np.testing.assert_allclose(rec[name].numpy(), np.asarray(v), atol=FWD_ATOL, rtol=0)


def test_port_checkpoint_records_the_reference_splits(tmp_path, capsys):
    """At a reference size the port writes the release's head splits into the
    checkpoint's meta and prints them as overrides."""
    model, _ = build_model(DatasetsConfig(name_dataset="treesatai_ts"), MaskConfig(),
                           ModelConfig(model_size="tiny", fusion_mode="group", inter_depth=1),
                           dtype=torch.float32, device="cpu")
    ckpt_file = tmp_path / "tiny.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               reference_state_dict(model, heads=False).items()}}, ckpt_file)
    path = port_checkpoint.main(["--ckpt", str(ckpt_file), "--dataset", "treesatai_ts",
                                 "--model-size", "tiny", "--inter-depth", "1",
                                 "--out", str(tmp_path / "out")])
    out = capsys.readouterr().out
    want = {"encoder_heads": 3, "encoder_dim_head": 64, "decoder_heads": 16,
            "decoder_dim_head": 32}
    assert {k: ckpt.load_meta(path)[k] for k in want} == want
    assert ("model.encoder_heads=3 model.encoder_dim_head=64 model.decoder_heads=16 "
            "model.decoder_dim_head=32") in out
    fresh = [ln.split()[-1] for ln in out.splitlines() if ln.strip().startswith("fresh:")]
    assert fresh and all(f.startswith("heads_") for f in fresh)
    assert port_checkpoint.reference_splits("medium") == {**want, "encoder_heads": 12}
