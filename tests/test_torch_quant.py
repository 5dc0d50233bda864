"""w8a8 int8 serving of the port (``maestro_tpu_torch.quant``) against the
JAX package's ``maestro_tpu.quant``, on the CPU.

* ``quantize_params`` picks the same layers as the JAX package's and gives
  bit-identical int8 weights and fp32 scales, for the MAE and the DINOv2
  and DOFA adapters (every leaf compared by flax path; DOFA's weight
  generator calls its quantized layers directly).
* int8 logits against ``make_quant_predict_fn`` on the same weights: the MAE
  at fp32 and bf16 compute, and each of the five baseline adapters; the
  int8 embeddings
  against ``make_quant_embed_fn``.  The tolerances are stated beside what
  was observed: an activation within an ulp of a rounding boundary takes the
  other int8 value in one package, so the two paths differ by whole
  quantization steps there, well inside the int8-vs-fp distance.
* ``make_predict_fn`` serves a baseline adapter (the DINOv2 one, fp32,
  against the JAX package's).
* An unquantized model runs unchanged through the quant functions; an int8
  artifact (symbolic batch) gives eager int8's logits.

Set-up and the JAX references (computed once a session): ``_torch_serving.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from maestro_tpu_torch.models.vit import dense, row_dense
from maestro_tpu_torch.port.from_jax import flax_names
from maestro_tpu_torch.quant import (
    make_quant_embed_fn,
    make_quant_predict_fn,
    quant_linear,
    quantize_params,
)
from maestro_tpu_torch.serve import load_exported, make_embed_fn, make_predict_fn

from _torch_port_utils import rng_normal, single_thread_torch, to_np  # noqa: F401
from _torch_serving import ADAPTER_CASES, artifact, batch_of, jax_refs, port_model

pytestmark = pytest.mark.usefixtures("single_thread_torch")

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# int8 port vs int8 JAX, of max |logit|, 4-10x what was observed: MAE fp32
# 4.0e-4 (embeddings 5.7e-4), bf16 compute 3.1e-3 (where the two packages'
# fp bf16 logits already differ by 3.5e-3), DINOv2 8.9e-5, DOFA 5.6e-4,
# CROMA 3.1e-4, SatMAE 1.2e-3, Prithvi 6.3e-4; the int8 path lies 1.1e-2
# (MAE), 2.2e-3 (DINOv2), 1.1e-2 (DOFA), 7.4e-3 (CROMA), 1.4e-2 (SatMAE)
# and 8.4e-3 (Prithvi) from the fp path
INT8_REL_TOL = {"treesat": 4e-3, "treesat_bf16": 3e-2, "dinov2": 1e-3, "dofa": 4e-3,
                "croma": 3e-3, "satmae": 5e-3, "prithvi": 5e-3}
# int8 vs fp logits (the JAX package's own test bars)
COS_MIN = {"treesat": 0.999, "treesat_bf16": 0.995, **dict.fromkeys(ADAPTER_CASES, 0.995)}


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("case", ["treesat", "dinov2", "dofa"])
def test_quantize_params_matches_jax(tmp_path_factory, case):
    """The same leaves in int8, bit for bit, and the same scales; every other
    leaf untouched; the input model left in fp32."""
    want = jax_refs(tmp_path_factory, case)["qtree"]
    model, _ = port_model(case)
    qmodel = quantize_params(model)
    params = dict(qmodel.named_parameters())
    names = flax_names(qmodel)
    assert set(names) == set(want)
    n_int8 = 0
    for path, value in want.items():
        name, transpose = names[path]
        got = params[name].detach().numpy()
        got = got.T if transpose else got
        assert got.dtype == value.dtype and np.array_equal(got, value), "/".join(path)
        n_int8 += value.dtype == np.int8
    assert n_int8 == sum(1 for p in want if p[-1] == "kernel_scale")
    assert n_int8 >= (10 if case == "treesat" else 4)
    assert not any(p[0].startswith("heads_") and p[-1] == "kernel_scale" for p in want)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("case", ["treesat", "treesat_bf16", *ADAPTER_CASES])
def test_quant_logits_match_jax(tmp_path_factory, case):
    refs = jax_refs(tmp_path_factory, case)
    model, _ = port_model(case)
    batch = batch_of(case)
    fp = make_predict_fn(model)(batch)
    got = make_quant_predict_fn(quantize_params(model))(batch)
    assert set(got) == set(refs["quant"])
    for name, want in refs["quant"].items():
        scale = np.abs(want).max()
        err = np.abs(to_np(got[name]) - want).max()
        assert err <= INT8_REL_TOL[case] * scale, f"{case} {name}: {err:.3e} of {scale:.3e}"
        assert got[name].dtype == fp[name].dtype
        assert not torch.equal(got[name], fp[name])  # the int8 route was taken
        assert _cos(to_np(got[name]), to_np(fp[name])) > COS_MIN[case]


def test_make_predict_fn_serves_a_baseline_adapter(tmp_path_factory):
    """The DINOv2 adapter through ``serve.make_predict_fn``, against the JAX
    package's on the same weights (fp32)."""
    refs = jax_refs(tmp_path_factory, "dinov2")["predict"]
    model, _ = port_model("dinov2")
    got = make_predict_fn(model, "finetune")(batch_of("dinov2"))
    assert set(got) == set(refs)
    for name, want in refs.items():
        np.testing.assert_allclose(to_np(got[name]), want, **FP32_TOL, err_msg=name)
    with pytest.raises(TypeError, match="encode_streams"):
        make_embed_fn(model)


def test_quant_embeddings_match_jax(tmp_path_factory):
    refs = jax_refs(tmp_path_factory, "treesat")
    model, _ = port_model("treesat")
    got = make_quant_embed_fn(quantize_params(model))(batch_of("treesat"))
    assert set(got) == set(refs["quant_embed"])
    for name, want in refs["quant_embed"].items():
        scale = np.abs(want).max()
        assert np.abs(to_np(got[name]) - want).max() <= INT8_REL_TOL["treesat"] * scale, name
        assert _cos(to_np(got[name]), refs["embed"][name]) > COS_MIN["treesat"]


def test_unquantized_model_runs_unchanged_through_quant_fns():
    model, _ = port_model("treesat")
    batch = batch_of("treesat")
    for quant_fn, fn in ((make_quant_predict_fn, make_predict_fn),
                         (make_quant_embed_fn, make_embed_fn)):
        got, want = quant_fn(model)(batch), fn(model)(batch)
        for name in want:
            assert torch.equal(got[name], want[name]), name


def test_int8_artifact_roundtrip(tmp_path_factory):
    """An int8 artifact with a symbolic batch (its products padded to more
    than 16 rows at every size) gives eager int8's logits at batch 1 and 3."""
    model, _ = port_model("treesat")
    qmodel = quantize_params(model)
    fn = load_exported(artifact(tmp_path_factory, "treesat", quantize=True), device="cpu")
    assert any("_int_mm" in str(n.target) for n in fn.program.graph.nodes)
    params = dict(qmodel.named_parameters())
    for rows in (1, 3):
        batch = batch_of("treesat", rows)
        got, want = fn(params, batch), make_quant_predict_fn(qmodel)(batch)
        for name in want:
            torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


def test_quant_linear_pads_short_products_and_refuses_tensor_parallelism():
    """Fewer than 17 rows are padded and cut back: the result equals the
    unpadded product of the same int8 operands, through ``dense`` and through
    the layer's own call; a quantized layer under a
    tensor-parallel group is refused."""
    layer = torch.nn.Linear(64, 32)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(rng_normal(2, 32, 64)))
    q = quantize_params(torch.nn.ModuleDict({"qkv": layer}))["qkv"]
    x = torch.from_numpy(rng_normal(3, 5, 64))
    got = dense(x, q, torch.float32)
    s_x = torch.clamp_min(x.abs().amax(-1, keepdim=True) / 127.0, 1e-8)
    x_q = torch.clamp(torch.round(x / s_x), -127, 127)
    want = (x_q.double() @ q.weight.double().T).float() * s_x * q.weight_scale + q.bias
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(q(x), got, rtol=0, atol=0)  # called directly, as DOFA does
    torch.testing.assert_close(quant_linear(x[None], q.weight, q.weight_scale, q.bias,
                                            torch.bfloat16), got[None].bfloat16(), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        row_dense(x, q, torch.float32, group=object())
