"""Shared set-up of the serving tests (``test_torch_export.py``,
``test_torch_quant.py``): the port's models holding a synthetic flax tree,
their batches, and the JAX package's outputs on the same tree and batch,
computed once a session (jitted, behind ``_torch_dist_worker.session_shared``'s
file lock) and shared by the test workers as numpy arrays.

Cases (``micro`` with one trunk block, group fusion):
* ``treesat``: TreeSatAI classification (the attentive pool is rank 3, the
  einsum body), fp32;
* ``treesat_bf16``: the same weights with bf16 compute;
* ``pastis``: PASTIS-HD segmentation with ``micro`` widened to E = 128 and 4
  ref rows a head chunk, so that the seg head's date pool takes the fused
  pool (the JAX pool in interpret mode, as ``test_torch_supervised.py``
  runs it);
* the five baseline adapters at ``micro`` on PASTIS-HD (``ADAPTER_CASES``):
  ``dinov2`` and ``dofa`` with shared fusion, ``croma`` late-croma,
  ``satmae`` and ``prithvi`` (v2) over S2 alone.

The reference batch has ``REF_BATCH`` rows; a batch of 1 is its first row,
so that one JAX trace serves both sizes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import torch

import maestro_tpu.models.mae as JM
from maestro_tpu.baselines import build_baseline as j_build_baseline
from maestro_tpu.conf import BaselineConfig as JBaselineConfig
from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.conf import MaskConfig as JMaskConfig
from maestro_tpu.conf import ModelConfig as JModelConfig
from maestro_tpu.ops import attn_pool as JP
from maestro_tpu.quant import make_quant_embed_fn as j_quant_embed_fn
from maestro_tpu.quant import make_quant_predict_fn as j_quant_predict_fn
from maestro_tpu.quant import quantize_params as j_quantize_params
from maestro_tpu.serve import make_embed_fn as j_embed_fn
from maestro_tpu.serve import make_predict_fn as j_predict_fn
from maestro_tpu.utils.testing import make_synthetic_batch
from maestro_tpu_torch.baselines import build_baseline
from maestro_tpu_torch.conf import BaselineConfig, DatasetsConfig, MaskConfig, ModelConfig
from maestro_tpu_torch.models import mae as TM
from maestro_tpu_torch.models.mae import build_model
from maestro_tpu_torch.port.from_jax import load_jax_params
from maestro_tpu_torch.serve import export_predict

from _torch_dist_worker import session_shared
from _torch_port_utils import synthetic_tree

REF_BATCH = 3
# (dataset, arch, seg chunk rows, compute dtype) of each MAE case
MAE_CASES = {
    "treesat": ("treesatai_ts", "micro", 2, "float32"),
    "treesat_bf16": ("treesatai_ts", "micro", 2, "bfloat16"),
    "pastis": ("pastis_hd", "micro128", 4, "float32"),
}
# (adapter, fusion mode) of each adapter case
ADAPTER_CASES = {
    "dinov2": ("dinov2", "shared"),
    "dofa": ("dofa", "shared"),
    "croma": ("croma", "late-croma"),
    "satmae": ("satmae", "mod"),
    "prithvi": ("prithvi", "mod"),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@contextlib.contextmanager
def wide_micro():
    """``micro128`` (``micro`` at E = 128, 64-dim heads) in both packages'
    ``MAE_ARCHS`` for the duration."""
    for archs in (JM.MAE_ARCHS, TM.MAE_ARCHS):
        archs["micro128"] = dataclasses.replace(archs["micro"], embed_dim=128, dim_head=64)
    try:
        yield
    finally:
        for archs in (JM.MAE_ARCHS, TM.MAE_ARCHS):
            archs.pop("micro128", None)


def _mae_cfg(cls, arch: str, chunk: int):
    return cls(model_size=arch, fusion_mode="group", inter_depth=1, seg_chunk_rows=chunk)


def _datasets(cls, case: str):
    """``case``'s datasets config of one package (``cls``): PASTIS-HD for
    the adapters, S2 alone for SatMAE and Prithvi."""
    ds = cls(name_dataset=dataset_of(case))
    if ADAPTER_CASES.get(case, ("",))[0] in ("satmae", "prithvi"):
        ds.pastis_hd.filter_inputs = ["s2"]
        ds.pastis_hd.__post_init__()
    return ds


def _adapter_kw(case: str) -> dict:
    model, fusion = ADAPTER_CASES[case]
    return {"model": model, "model_size": "micro", "fusion_mode": fusion,
            **({"version": "v2"} if model == "prithvi" else {})}


def port_model(case: str):
    """The port's model of ``case`` holding the synthetic tree (seed 1, made
    from the fp32 model's names) and that tree."""
    if case in ADAPTER_CASES:
        model = build_baseline(_datasets(DatasetsConfig, case),
                               BaselineConfig(**_adapter_kw(case)), torch.float32, device="cpu")
        tree = synthetic_tree(model, seed=1)
        load_jax_params(model, tree)
        return model, tree
    name, arch, chunk, dtype = MAE_CASES[case]
    with wide_micro():
        model, _ = build_model(DatasetsConfig(name_dataset=name), MaskConfig(),
                               _mae_cfg(ModelConfig, arch, chunk), dtype=DTYPES[dtype][1],
                               device="cpu")
    tree = synthetic_tree(model, seed=1)
    load_jax_params(model, tree)
    return model, tree


def dataset_of(case: str) -> str:
    return "pastis_hd" if case in ADAPTER_CASES else MAE_CASES[case][0]


def batch_of(case: str, rows: int = REF_BATCH) -> dict[str, np.ndarray]:
    """The case's reference batch (numpy), its first ``rows`` rows."""
    batch = make_synthetic_batch(_datasets(JDatasetsConfig, case).dataset, REF_BATCH, seed=5)
    return {k: v[:rows] for k, v in batch.items()}


def _jax_refs(case: str) -> dict:
    """The JAX package's outputs of ``case`` on the reference batch: predict
    and its int8 counterpart (``quant``), for the fp32 TreeSatAI case also
    the embeddings and their int8 counterpart; and the flattened
    ``quantize_params`` tree, by flax path."""
    model, tree = port_model(case)
    del model
    jbatch = {k: jnp.asarray(v) for k, v in batch_of(case).items()}
    if case in ADAPTER_CASES:
        jmodel = j_build_baseline(_datasets(JDatasetsConfig, case),
                                  JBaselineConfig(**_adapter_kw(case)), dtype=jnp.float32)
    else:
        name, arch, chunk, dtype = MAE_CASES[case]
        with wide_micro():
            jmodel, _ = JM.build_model(JDatasetsConfig(name_dataset=name), JMaskConfig(),
                                       _mae_cfg(JModelConfig, arch, chunk),
                                       dtype=DTYPES[dtype][0])
    qtree = j_quantize_params(tree)
    fns = {"predict": (j_predict_fn(jmodel, "finetune"), False)}
    if case != "pastis":
        fns["quant"] = (j_quant_predict_fn(jmodel, "finetune"), True)
    if case == "treesat":
        fns["embed"] = (j_embed_fn(jmodel), False)
        fns["quant_embed"] = (j_quant_embed_fn(jmodel), True)
    interpret = JP.INTERPRET
    JP.INTERPRET = True  # the fused pool of the pastis case, on the CPU
    try:
        outs = jax.jit(lambda p, q, b: {k: fn(q if quant else p, b)
                                        for k, (fn, quant) in fns.items()})(tree, qtree, jbatch)
    finally:
        JP.INTERPRET = interpret
    refs = {k: {h: np.asarray(v, np.float32) for h, v in out.items()} for k, out in outs.items()}
    refs["qtree"] = {tuple(str(k.key) for k in path): np.asarray(v)
                     for path, v in jax.tree_util.tree_flatten_with_path(qtree["params"])[0]}
    return refs


def jax_refs(tmp_path_factory, case: str) -> dict:
    """``_jax_refs(case)``, computed once a session."""
    return session_shared(tmp_path_factory, f"serving_jax_{case}", lambda root: _jax_refs(case))


def artifact(tmp_path_factory, case: str, phase: str = "finetune", quantize: bool = False) -> bytes:
    """The bytes of ``case``'s artifact of ``phase`` (symbolic batch, traced
    on the CPU at batch 2), exported once a session."""
    def export(root):
        del root
        from maestro_tpu_torch.quant import quantize_params

        model, _ = port_model(case)
        if quantize:
            model = quantize_params(model)
        buf = io.BytesIO()
        torch.export.save(export_predict(model, batch_of(case, 2), phase, device="cpu"), buf)
        return buf.getvalue()

    name = f"serving_artifact_{case}_{phase}{'_int8' if quantize else ''}"
    return session_shared(tmp_path_factory, name, export)
