"""Command-line tools of the port, run as ``python -m maestro_tpu_torch.scripts.<name>``.

The day-one runbook (docs/OPERATIONS.md): ``convert_dataset`` (``.npy``
mirrors of GeoTIFF stacks), ``port_checkpoint`` (a reference MAESTRO .ckpt ->
a ``pretrain-epoch=0`` checkpoint for ``run.load_ckpt_path``), ``port_fm`` (a
foundation-model release -> an ``fm-epoch=0`` checkpoint for
``model.pretrained_path``), ``gen_manifests`` (the releases' key manifests)
and ``predict`` (a split's predictions to disk, ``--quantize=int8`` for the
int8 model); ``export_model`` (a ``torch.export`` serving artifact of a
checkpoint, fp or int8, for ``serve.load_exported``).
"""
