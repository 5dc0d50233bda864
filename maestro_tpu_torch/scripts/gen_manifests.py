"""Write the released-checkpoint key manifests as JSON.

Usage::

    python -m maestro_tpu_torch.scripts.gen_manifests [--out DIR]

Writes ``<name>.json`` for every manifest in
``maestro_tpu_torch.port.manifests.ALL_MANIFESTS`` into ``DIR`` (default: the
repository's ``tests/manifests``, where the committed fixtures live).  The
fixtures are committed so that the contract is diffable; the script needs
re-running only when a transcription is corrected.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from maestro_tpu_torch.port.manifests import ALL_MANIFESTS

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "tests" / "manifests"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    out = ap.parse_args(argv).out
    out.mkdir(parents=True, exist_ok=True)
    for name, gen in ALL_MANIFESTS.items():
        m = gen()
        path = out / f"{name}.json"
        path.write_text(json.dumps(m, indent=1) + "\n")
        print(f"{path.name}: {len(m['keys'])} keys, {len(m.get('skip', {}))} skip patterns")


if __name__ == "__main__":
    main()
