"""The ``sequence_parallel`` hint's worth by the dry-run's reckoning: one
device's bytes and collectives of a cell's step on the production mesh,
the hint off against on.

    python3 scripts/sp_reckoning.py [--out FILE] [ARCH:SHAPE ...]

Defaults: ``phi3-medium-14b`` and ``llama3-8b`` at ``train_4k`` and
``prefill_32k``.  Each cell is reckoned twice by
``launch.dryrun.account_mesh`` for rank 0 of the fake ``(16, 16)`` group
(``launch.mesh.fake_production_mesh``: meta tensors, nothing computed),
on the config as published and with ``sequence_parallel=True`` set by
``dataclasses.replace`` (the dry-run has no flag for it, as JAX's has
none).  One JSON line a cell: per-device argument, temporary and total
bytes and the collectives by kind, hint off and on, and the differences;
``--out`` writes the lines to a file too.  Runs on any machine (no
card): ~10 s a cell on one core.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

CELLS = ("phi3-medium-14b:train_4k", "llama3-8b:train_4k",
         "phi3-medium-14b:prefill_32k", "llama3-8b:prefill_32k")


def reckon(arch: str, shape: str) -> dict:
    from repro_torch.configs import SHAPE_CELLS, get_config
    from repro_torch.launch.dryrun import account_mesh
    from repro_torch.launch.mesh import fake_production_mesh
    cfg, cell = get_config(arch), SHAPE_CELLS[shape]
    out = {"arch": arch, "shape": shape, "mesh_shape": [16, 16]}
    for hint in (False, True):
        t0 = time.monotonic()
        with fake_production_mesh() as mesh:
            rec = account_mesh(dataclasses.replace(
                cfg, sequence_parallel=hint), cell, mesh)
        mem = rec["memory"]
        out["hint_on" if hint else "hint_off"] = {
            "argument_bytes": mem["argument_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "device_bytes": mem["argument_bytes"] + mem["temp_bytes"],
            "collectives": {k: v["count"]
                            for k, v in rec["collectives"].items()},
            "collective_bytes": {k: v["bytes"]
                                 for k, v in rec["collectives"].items()},
            "seconds": time.monotonic() - t0}
    off, on = out["hint_off"], out["hint_on"]
    out["device_bytes_saved"] = off["device_bytes"] - on["device_bytes"]
    out["collectives_change"] = {k: on["collectives"][k]
                                 - off["collectives"][k]
                                 for k in off["collectives"]}
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="*", default=list(CELLS),
                    help="ARCH:SHAPE pairs")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    lines = []
    for pair in args.cells:
        arch, shape = pair.split(":")
        lines.append(json.dumps(reckon(arch, shape)))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
