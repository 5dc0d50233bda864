"""CLI entry of the port:
``python -m maestro_tpu_torch.main datasets.name_dataset=flair model.model_size=medium``.

Dotted-path overrides over the typed dataclass config tree mirror the
reference's hydra-zen CLI (reference main.py:22-25) without the Hydra
dependency: ``group.field=value`` assigns into ExperimentConfig /
DatasetsConfig with type coercion from the dataclass annotations — the same
overrides as the JAX package's root ``main.py``.  The run goes to a CUDA
device; ``main(argv, device="cpu")`` runs it on the CPU.  Under a launcher
(``torchrun --nproc_per_node=N -m maestro_tpu_torch.main ...``) each process
joins the group (NCCL on the card, gloo on the CPU) and the processes share
process 0's run uuid.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import uuid
from pathlib import Path
from typing import Any


def coerce(value: str, current: Any) -> Any:
    if value.lower() in ("none", "null"):
        return None
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    if isinstance(current, bool):
        # bool-or-string fields (e.g. trainer.remat="dots") pass through
        return value
    for cast in (int, float):
        try:
            if isinstance(current, cast) or current is None:
                return cast(value)
        except ValueError:
            continue
    if value.startswith("[") or value.startswith("{"):
        return json.loads(value)
    return value


def apply_override(root: Any, dotted: str, value: str) -> None:
    *parts, last = dotted.split(".")
    obj = root
    for p in parts:
        if not hasattr(obj, p):
            msg = f"Unknown config path {dotted!r} (no attribute {p!r})."
            raise SystemExit(msg)
        obj = getattr(obj, p)
    current = getattr(obj, last, None)
    if not hasattr(obj, last):
        msg = f"Unknown config field {dotted!r}."
        raise SystemExit(msg)
    setattr(obj, last, coerce(value, current))


def parse_cli(argv: list[str]):
    from maestro_tpu_torch.conf import DatasetsConfig, ExperimentConfig

    cfg = ExperimentConfig()
    dataset_overrides = []
    for arg in argv:
        if "=" not in arg:
            msg = f"Expected group.field=value overrides, got {arg!r}."
            raise SystemExit(msg)
        key, value = arg.split("=", 1)
        if key.startswith("datasets."):
            dataset_overrides.append((key.removeprefix("datasets."), value))
        else:
            apply_override(cfg, key, value)

    # datasets config needs name/root first so __post_init__ validates
    simple = dict(dataset_overrides)
    datasets = DatasetsConfig(
        root_dir=simple.pop("root_dir", ""),
        name_dataset=simple.pop("name_dataset", "treesatai_ts"),
    )
    for key, value in dataset_overrides:
        if key in ("root_dir", "name_dataset"):
            continue
        apply_override(datasets, key, value)
    # re-run derived-state computation if modality fields changed
    for name in ("treesatai_ts", "pastis_hd", "flair", "s2_naip"):
        getattr(datasets, name).__post_init__()
    return cfg, datasets


def main(argv: list[str] | None = None, *, device="cuda"):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    cfg, datasets = parse_cli(argv if argv is not None else sys.argv[1:])

    from maestro_tpu_torch.models.mae import resolve_device

    resolve_device(device)
    from maestro_tpu_torch.parallel.distributed import (
        broadcast_object,
        initialize_distributed,
        is_primary,
    )

    initialize_distributed(device)

    if cfg.run.reproducible:
        import numpy as np

        np.random.seed(cfg.run.seed)
    # one run directory for all processes: process 0 draws, the others adopt
    cfg.run.exp_uuid = cfg.run.exp_uuid or broadcast_object(uuid.uuid4().hex[:8])

    # pin data.loader="auto" to one concrete choice for the whole run BEFORE
    # dumping the resolved config, so the record shows what actually ran
    from maestro_tpu_torch.data.loader import pin_loader

    pin_loader(cfg.data)

    workdir = Path(cfg.run.exp_dir) / cfg.run.exp_name / cfg.run.exp_uuid
    workdir.mkdir(parents=True, exist_ok=True)
    if is_primary():
        (workdir / "config_resolved.json").write_text(
            json.dumps(
                {
                    "experiment": dataclasses.asdict(cfg),
                    "datasets": {
                        "root_dir": datasets.root_dir,
                        "name_dataset": datasets.name_dataset,
                    },
                },
                indent=2,
                default=str,
            ),
        )

    from maestro_tpu_torch.train.runtime import run_experiment

    results = run_experiment(cfg, datasets, workdir, device=device)
    for phase, res in results.items():
        print(phase, res.test_metrics or res.val_metrics)
    return results


if __name__ == "__main__":
    main()
