"""Serving artifacts of the port (``serve.export_predict`` / ``save_exported`` /
``load_exported``, ``scripts/export_model``) on the CPU, against the JAX
package's ``make_predict_fn`` / ``make_embed_fn``.

* Both registered ops (``torch.ops.maestro.flash_attention_fwd``,
  ``attentive_pool_fwd``) pass ``torch.library.opcheck``.
* One artifact per dataset (TreeSatAI classification; PASTIS-HD segmentation
  with the seg head's fused date pool), exported once a session with a
  symbolic batch at batch 2, saved, loaded and run at batch 1 and 3: the
  logits equal the JAX package's on the same weights at fp32 tolerance, the
  graph calls the registered ops, running it raises the plain versions'
  counts by what an eager request does, and the program holds no parameter
  (every one is an input, by name).
* The embed artifact; ``export_model.main`` in process with
  ``--fixed-batch``, and its refusals.

Set-up and the JAX references (computed once a session): ``_torch_serving.py``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from maestro_tpu_torch.ops import attention as TA
from maestro_tpu_torch.ops import attn_pool as TP
from maestro_tpu_torch.scripts import export_model
from maestro_tpu_torch.serve import (
    export_predict,
    exported_inputs,
    load_exported,
    make_embed_fn,
    make_predict_fn,
)
from maestro_tpu_torch.train import checkpoint as ckpt

from _torch_port_utils import rng_normal, single_thread_torch, to_np  # noqa: F401
from _torch_serving import artifact, batch_of, jax_refs, port_model

pytestmark = pytest.mark.usefixtures("single_thread_torch")

FP32_TOL = dict(rtol=1e-4, atol=1e-4)  # observed max abs err 7.2e-7 (TreeSatAI)


def _plain_counts() -> tuple[int, int]:
    return TA.plain_count, TP.plain_count


def _op_nodes(fn) -> list[str]:
    return [str(n.target) for n in fn.program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("maestro.")]


def test_attention_op_passes_opcheck():
    qkv = torch.from_numpy(rng_normal(0, 2, 9, 3, 2, 32))
    q, k, v = qkv.unbind(dim=2)  # strided views, as the model hands them over
    for with_lse in (False, True):
        torch.library.opcheck(TA.flash_attention_fwd, (q, k, v, 32**-0.5, with_lse))
    out, lse = TA.flash_attention_fwd(q, k, v, 32**-0.5, True)
    assert out.is_contiguous() and tuple(lse.shape) == (2, 2, 9) and lse.dtype == torch.float32
    torch.testing.assert_close(out, TA.mha_blhd_plain(q, k, v, 32**-0.5), rtol=0, atol=0)
    assert TA.flash_attention_fwd(q, k, v, 1.0, False)[1].numel() == 0


def test_pool_op_passes_opcheck():
    x = torch.from_numpy(rng_normal(1, 2, 3, 5, 128))
    scale, bias, query = (torch.from_numpy(rng_normal(s, 128)) for s in (2, 3, 4))
    w_kv = torch.from_numpy(rng_normal(5, 256, 128, scale=128**-0.5))
    args = (x, scale, bias, w_kv, query, 8, 1e-5)
    torch.library.opcheck(TP.attentive_pool_fwd, args)
    out, m, den = TP.attentive_pool_fwd(*args)
    assert [tuple(t.shape) for t in (out, m, den)] == [(2, 5, 128), (2, 5, 8), (2, 5, 8)]
    for got, want in zip((out, m, den), TP.attentive_pool_plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["treesat", "pastis"])
def test_artifact_matches_jax(tmp_path_factory, case):
    """Loaded artifact at batch 1 and 3 against the JAX package's predict;
    the plain versions run as often as in an eager request."""
    refs = jax_refs(tmp_path_factory, case)["predict"]
    fn = load_exported(artifact(tmp_path_factory, case), device="cpu")
    model, _ = port_model(case)
    params = dict(model.named_parameters())
    eager = make_predict_fn(model, "finetune")
    for rows in (1, 3):
        batch = batch_of(case, rows)
        before = _plain_counts()
        got = fn(params, batch)
        mid = _plain_counts()
        eager(batch)
        after = _plain_counts()
        assert [m - b for m, b in zip(mid, before)] == [a - m for a, m in zip(after, mid)]
        assert mid[0] > before[0]
        assert set(got) == set(refs)
        for name, want in refs.items():
            assert tuple(got[name].shape) == (rows, *want.shape[1:])
            np.testing.assert_allclose(to_np(got[name]), want[:rows], **FP32_TOL,
                                       err_msg=f"{case} batch {rows} {name}")


@pytest.mark.parametrize("case", ["treesat", "pastis"])
def test_artifact_calls_the_ops_and_holds_no_parameter(tmp_path_factory, case):
    """The graph's op nodes: the attention of every block, and on PASTIS-HD
    the seg head's fused pool (4 ref rows of 8 a chunk: 2 calls); no
    parameter in the program, each one an input by its name."""
    fn = load_exported(artifact(tmp_path_factory, case), device="cpu")
    model, _ = port_model(case)
    before = _plain_counts()
    make_predict_fn(model)(batch_of(case, 2))
    n_attention, n_pool = (a - b for a, b in zip(_plain_counts(), before))
    nodes = _op_nodes(fn)
    assert nodes.count("maestro.flash_attention_fwd.default") == n_attention > 0
    assert nodes.count("maestro.attentive_pool_fwd.default") == n_pool == (2 if case == "pastis"
                                                                            else 0)
    ep = fn.program
    names = [n for n, _ in model.named_parameters()]
    assert not ep.graph_signature.parameters and not ep.graph_signature.buffers
    assert ep.example_inputs is None  # they would hold every parameter
    assert not set(ep.state_dict) & set(names)
    inputs, keys = exported_inputs(ep)
    assert inputs == names
    assert set(keys) == {"ref_date", *(k for m in model.plan.mods for k in (m, f"{m}_dates"))}
    # the constants are what the configuration fixes (position tables, resize
    # matrices), none of them a weight
    params = list(model.parameters())
    assert not any(c.shape == p.shape and torch.equal(c, p.detach())
                   for c in ep.constants.values() for p in params)


def test_loaded_artifact_checks_input_dtypes(tmp_path_factory):
    """The program keeps no ``aten._assert_tensor_metadata`` node (one guarded
    every ``.to(dtype)``); the loaded function checks the inputs' dtypes on
    entry instead, and names the inputs it misses."""
    fn = load_exported(artifact(tmp_path_factory, "treesat"), device="cpu")
    assert not any("_assert_tensor_metadata" in str(n.target) for n in fn.program.graph.nodes)
    model, _ = port_model("treesat")
    params, batch = dict(model.named_parameters()), batch_of("treesat", 2)
    with pytest.raises(TypeError, match="s2: torch.float64, not torch.float32"):
        fn(params, {**batch, "s2": batch["s2"].astype(np.float64)})
    name = next(iter(params))
    with pytest.raises(TypeError, match=name):
        fn({**params, name: params[name].double()}, batch)
    with pytest.raises(KeyError, match="ref_date"):
        fn(params, {k: v for k, v in batch.items() if k != "ref_date"})


def test_embed_artifact_matches_jax(tmp_path_factory):
    refs = jax_refs(tmp_path_factory, "treesat")["embed"]
    fn = load_exported(artifact(tmp_path_factory, "treesat", "embed"), device="cpu")
    model, _ = port_model("treesat")
    got = fn(dict(model.named_parameters()), batch_of("treesat"))
    eager = make_embed_fn(model)(batch_of("treesat"))
    assert set(got) == set(refs) == set(eager)
    for name, want in refs.items():
        np.testing.assert_allclose(to_np(got[name]), want, **FP32_TOL, err_msg=name)
        torch.testing.assert_close(got[name], eager[name], rtol=0, atol=0)


def test_symbolic_batch_needs_two_rows():
    model, _ = port_model("treesat")
    with pytest.raises(ValueError, match="at least 2"):
        export_predict(model, batch_of("treesat", 1))


def test_export_model_cli(tmp_path):
    """``--phase=probe --fixed-batch=2 --device=cpu`` from a weights-only
    checkpoint: the manifest, and the loaded artifact against eager predict
    on the checkpoint's weights; a checkpoint that leaves parameters unfilled
    is refused, and so is another scheme than int8."""
    common = ["model.model_size=micro", "model.inter_depth=1", "model.fusion_mode=group",
              "trainer.compute_dtype=float32"]
    model, _ = port_model("treesat")
    weights = ckpt.save_weights(tmp_path / "ckpt", "finetune", 3, dict(model.named_parameters()))
    out = tmp_path / "probe.pt2"
    manifest = export_model.main([str(out), *common, f"run.load_ckpt_path={weights}",
                                  "--phase=probe", "--fixed-batch=2", "--device=cpu"])
    assert json.loads((tmp_path / "probe.pt2.json").read_text()) == manifest
    assert manifest["symbolic_batch"] is False and manifest["quantize"] is None
    assert manifest["bytes"] == out.stat().st_size and manifest["phase"] == "probe"
    assert manifest["inputs"]["ref_date"] == [[2, 1, 3], "int16"]
    fn = load_exported(out, device="cpu")
    batch = batch_of("treesat", 2)
    got = fn(dict(model.named_parameters()), batch)
    want = make_predict_fn(model, "probe")(batch)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)

    partial = ckpt.save_weights(tmp_path / "ckpt", "finetune", 4,
                                {n: p for n, p in model.named_parameters()
                                 if not n.startswith("encoder_inter.")})
    with pytest.raises(SystemExit, match="does not cover"):
        export_model.main([str(tmp_path / "x.pt2"), *common, f"run.load_ckpt_path={partial}",
                           "--device=cpu"])
    with pytest.raises(SystemExit, match="int8"):
        export_model.main([str(tmp_path / "x.pt2"), "--quantize=fp8"])
    assert not (tmp_path / "x.pt2").exists()
