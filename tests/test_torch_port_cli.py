"""The port's day-one scripts (``maestro_tpu_torch.scripts``) and
``model.pretrained_path``, on the CPU.

* ``port_fm`` on a synthetic release of each adapter at ``micro`` (the JAX
  package's ``tests/test_port_fm_cli.py`` sources and leaf checks), then a
  probe experiment warm-started through ``model.pretrained_path``: every
  ported parameter equals the checkpoint's, and the checked leaves equal
  their source under the documented surgery.
* The four refusals of ``model.pretrained_path`` (a raw torch file, the
  flagship MAE, a path with no ``state/``, both warm-start sources set).
* The day-one runbook (``tests/test_day_one_runbook.py``) through the port on
  the TreeSatAI fixture: ``convert_dataset --check`` -> ``port_checkpoint`` ->
  ``run.eval_only`` -> probe + finetune -> ``predict``, whose files equal
  ``serve.make_predict_fn`` on the same batches with the EMA weights;
  ``predict --quantize=int8`` against the int8 model on the same batches
  (another scheme refused).
* ``convert_dataset``'s mirrors bit-equal to the JAX package's script's on a
  FLAIR-HUB GeoTIFF fixture.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from maestro_tpu_torch import main as tmain
from maestro_tpu_torch.data.loader import make_loader
from maestro_tpu_torch.port.from_jax import flax_names
from maestro_tpu_torch.scripts import convert_dataset, port_checkpoint, port_fm, predict
from maestro_tpu_torch.serve import make_predict_fn
from maestro_tpu_torch.train import checkpoint as ckpt
from maestro_tpu_torch.train import runtime as TR

from _torch_port_utils import single_thread_torch  # noqa: F401
from fixtures import load_script, write_flair_fixture, write_treesat_fixture
from test_port_fm_cli import CASES as FM_CASES
from test_torch_port_mae import SPLITS, _torch_mae

pytestmark = pytest.mark.usefixtures("single_thread_torch")


@pytest.mark.parametrize("model", list(FM_CASES))
def test_port_fm_warm_starts_a_probe(model, tmp_path):
    build_src, extra, checks = FM_CASES[model]
    src = build_src()
    ckpt_file = tmp_path / f"{model}.pth"
    torch.save(src, ckpt_file)
    overrides = [f"model.model={model}", "model.model_size=micro",
                 "datasets.name_dataset=pastis_hd", *extra]
    path = port_fm.main(["--ckpt", str(ckpt_file), "--out", str(tmp_path / "ported"),
                         *overrides])
    assert path == tmp_path / "ported" / "fm-epoch=0" and (path / "state").exists()
    assert ckpt.load_meta(path)["model"] == model

    cfg, datasets = tmain.parse_cli([
        *overrides, f"model.pretrained_path={path}", "model.use_ema=false",
        "trainer.compute_dtype=float32", f"run.exp_dir={tmp_path}",
    ])
    exp = TR.Experiment(cfg, datasets, tmp_path / "work", device="cpu")
    exp.init_params("probe")
    params = dict(exp.model.named_parameters())
    saved = torch.load(path / "state" / ckpt.PAYLOAD, weights_only=True)["params"]
    assert saved and all(not n.startswith("heads.") for n in saved)
    assert {n for n in params if not n.startswith("heads.")} <= set(saved)
    for name, value in saved.items():
        assert torch.equal(params[name].detach(), value), name
    names = flax_names(exp.model)
    for flax, want_fn in checks:
        name, transpose = names[flax[1:]]  # the checks' paths start at "params"
        got = params[name].detach().numpy()
        np.testing.assert_array_equal(got.T if transpose else got, np.asarray(want_fn(src)),
                                      err_msg=f"{model} {'/'.join(flax)}")


def _experiment(tmp_path, *overrides):
    cfg, datasets = tmain.parse_cli(["model.model_size=micro", *overrides,
                                     f"run.exp_dir={tmp_path}"])
    return cfg, datasets


def test_pretrained_path_rejects_torch_file(tmp_path):
    f = tmp_path / "weights.pth"
    f.write_bytes(b"x")
    cfg, datasets = _experiment(tmp_path, "model.model=dofa", "model.fusion_mode=shared",
                                "datasets.name_dataset=pastis_hd", f"model.pretrained_path={f}")
    with pytest.raises(ValueError, match="maestro_tpu_torch.scripts.port_fm"):
        TR.Experiment(cfg, datasets, tmp_path / "w", device="cpu")


def test_pretrained_path_rejects_the_mae(tmp_path):
    cfg, datasets = _experiment(tmp_path, "model.fusion_mode=group", "model.inter_depth=1",
                                f"model.pretrained_path={tmp_path}")
    with pytest.raises(ValueError, match="baseline.*maestro_tpu_torch.scripts.port_checkpoint"):
        TR.Experiment(cfg, datasets, tmp_path / "w", device="cpu")


def test_pretrained_path_needs_a_state_dir(tmp_path):
    cfg, datasets = _experiment(tmp_path, "model.model=dofa", "model.fusion_mode=shared",
                                "datasets.name_dataset=pastis_hd",
                                f"model.pretrained_path={tmp_path / 'nope'}")
    with pytest.raises(FileNotFoundError, match="state.*maestro_tpu_torch.scripts.port_fm"):
        TR.Experiment(cfg, datasets, tmp_path / "w", device="cpu")


def test_pretrained_path_and_load_ckpt_path_refused_together(tmp_path):
    fm = tmp_path / "fm-epoch=0"
    (fm / "state").mkdir(parents=True)
    cfg, datasets = _experiment(tmp_path, "model.model=dofa", "model.fusion_mode=shared",
                                "datasets.name_dataset=pastis_hd", f"model.pretrained_path={fm}",
                                f"run.load_ckpt_path={fm}")
    with pytest.raises(ValueError, match="pick one warm-start source"):
        TR.run_experiment(cfg, datasets, tmp_path / "w", device="cpu")


def test_day_one_runbook(tmp_path):
    root = tmp_path / "treesat"
    write_treesat_fixture(root, num_tiles=2)
    runs = tmp_path / "runs"
    data = ["datasets.name_dataset=treesatai_ts", f"datasets.root_dir={root}",
            "datasets.treesatai_ts.rel_dir="]

    # 1. the dataset's mirrors, checked against the TIFF reads
    report = convert_dataset.main([*data, "--check"])
    assert report["written"] > 0 and report["checked"] == report["written"]

    # 2. a reference-layout lightning .ckpt (micro stand-in for the release)
    tmae, _ = _torch_mae("treesatai_ts", seed=3)
    release = tmp_path / "MAESTRO_FLAIR-HUB_base.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in tmae.state_dict().items()},
                "epoch": 99}, release)
    ported = port_checkpoint.main(["--ckpt", str(release), "--dataset", "treesatai_ts",
                                   "--fusion-mode", "group", "--model-size", "micro",
                                   "--inter-depth", "1", "--out", str(runs / "ported")])
    splits = [f"model.{k}={v}" for k, v in SPLITS.items()]  # the release's own
    common = [*data, "model.model_size=micro", "model.fusion_mode=group", "model.inter_depth=1",
              *splits, "data.loader=threads", "data.num_workers=2",
              "trainer.compute_dtype=float32", f"run.exp_dir={runs}"]

    # 3. the ported weights scored without training
    results = tmain.main([*common, "run.eval_only=true", f"run.load_ckpt_path={ported}",
                          "opt_pretrain.epochs=1", "opt_probe.epochs=0",
                          "opt_finetune.epochs=0", "opt_pretrain.batch_size=2",
                          "run.exp_name=parity_eval"], device="cpu")
    assert np.isfinite(results["pretrain"].val_metrics["loss_rec"])
    eval_dir = next((runs / "parity_eval").iterdir())
    records = [json.loads(line) for line in (eval_dir / "metrics.jsonl").read_text().splitlines()]
    assert any(r.get("eval_only") and np.isfinite(r.get("val/loss_rec", np.nan))
               for r in records), records

    # 4. probe and finetune from the port, the reference's monitor spelling
    results = tmain.main([*common, f"run.load_ckpt_path={ported}", "opt_pretrain.epochs=0",
                          "opt_probe.epochs=1", "opt_finetune.epochs=1",
                          "opt_probe.batch_size=2", "opt_finetune.batch_size=2",
                          "opt_finetune.monitor=treesat_mlc_thresh/weighted_f1_val",
                          "run.exp_name=day1_treesat"], device="cpu")
    assert set(results) == {"probe", "finetune"}
    assert 0.0 <= results["finetune"].test_metrics["treesat_mlc_thresh/weighted_f1"] <= 1.0
    assert results["finetune"].best_monitor is not None
    finetuned = ckpt.find_latest_checkpoint(next((runs / "day1_treesat").iterdir()), "finetune")
    assert finetuned is not None

    # 5. predictions of the test split, with the EMA weights
    out = tmp_path / "preds"
    head = "treesat_mlc_thresh"
    manifest = predict.main([str(out), *common, f"run.load_ckpt_path={finetuned}",
                             "--split=test", "--batch-size=1", "--probs", "--device=cpu"])
    assert manifest["ema"] is True and manifest["tiles"] == {head: 2}
    assert json.loads((out / "manifest.json").read_text()) == manifest
    probs = np.load(out / head / "probs.npy")
    preds = np.load(out / head / "preds.npy")
    assert probs.shape == preds.shape == (2, 15)
    assert probs.dtype == np.float32 and preds.dtype == np.int8
    np.testing.assert_array_equal(preds, (probs >= 0.5).astype(np.int8))

    cfg, datasets = tmain.parse_cli([*common, f"run.load_ckpt_path={finetuned}"])
    from maestro_tpu_torch.models.factory import build_experiment_model

    model, _, _ = build_experiment_model(datasets, cfg, device="cpu")
    ema = ckpt.load_ema_weights(finetuned, model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(ema[name])
    fn = make_predict_fn(model, "finetune")
    _, loader = make_loader(datasets, cfg.data, "test", "finetune", 1, seed=cfg.run.seed)
    loader.shuffle, loader.drop_last = False, False
    want = np.concatenate([torch.sigmoid(fn(b)[head].float()).numpy() for b in loader])
    np.testing.assert_allclose(probs, want, rtol=1e-6, atol=1e-7)


def test_predict_refuses_quantize(tmp_path):
    """``--quantize=int8`` writes the int8 model's predictions (those of
    ``quant.quantize_params`` through ``make_quant_predict_fn`` on the same
    batches), another scheme is refused, and the card is the default."""
    root = tmp_path / "treesat"
    write_treesat_fixture(root, num_tiles=2)
    common = ["datasets.name_dataset=treesatai_ts", f"datasets.root_dir={root}",
              "datasets.treesatai_ts.rel_dir=", "model.model_size=micro",
              "model.fusion_mode=group", "model.inter_depth=1", "data.loader=threads",
              "data.num_workers=2", "trainer.compute_dtype=float32"]
    cfg, datasets = tmain.parse_cli(common)
    from maestro_tpu_torch.models.factory import build_experiment_model
    from maestro_tpu_torch.quant import make_quant_predict_fn, quantize_params

    model, _, _ = build_experiment_model(datasets, cfg, device="cpu")
    weights = ckpt.save_weights(tmp_path / "ckpt", "finetune", 1, dict(model.named_parameters()))
    out, head = tmp_path / "preds", "treesat_mlc_thresh"
    manifest = predict.main([str(out), *common, f"run.load_ckpt_path={weights}",
                             "--split=test", "--batch-size=1", "--probs", "--quantize=int8",
                             "--device=cpu"])
    assert manifest["quantize"] == "int8" and manifest["tiles"] == {head: 2}
    probs = np.load(out / head / "probs.npy")
    _, loader = make_loader(datasets, cfg.data, "test", "finetune", 1, seed=cfg.run.seed)
    loader.shuffle, loader.drop_last = False, False
    batches = list(loader)
    fns = {"int8": make_quant_predict_fn(quantize_params(model)), "fp": make_predict_fn(model)}
    want = {k: np.concatenate([torch.sigmoid(fn(b)[head].float()).numpy() for b in batches])
            for k, fn in fns.items()}
    np.testing.assert_allclose(probs, want["int8"], rtol=1e-6, atol=1e-7)
    assert not np.array_equal(probs, want["fp"])

    with pytest.raises(SystemExit, match="int8"):
        predict.main([str(tmp_path), "--quantize=fp8"])
    with pytest.raises(RuntimeError, match="device='cpu'"):  # the card unless asked
        predict.main([str(tmp_path), "model.model_size=micro", "run.load_ckpt_path=x"])


def test_convert_dataset_matches_the_jax_script(tmp_path):
    for name in ("jax", "port"):
        write_flair_fixture(tmp_path / name, num_tiles=1, seed=0, use_tif=True)
    args = ["datasets.name_dataset=flair", "datasets.flair.rel_dir=", "--splits=train", "--check"]
    load_script("convert_dataset").main([f"datasets.root_dir={tmp_path / 'jax'}", *args])
    report = convert_dataset.main([f"datasets.root_dir={tmp_path / 'port'}", *args])
    want = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npy")
                  if p.with_suffix(".tif").exists())
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.npy")
                 if p.with_suffix(".tif").exists())
    assert got == want and len(got) == report["written"] > 0
    for rel in got:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
