"""Time the fleet tick unmeshed (``mesh=None``) against ``fleet_mesh([card])``
on one card, in rounds that alternate the two.

    python3 scripts/fleet_tick_ab.py [--src OTHER_CHECKOUT/src] [--rounds N]

Each round is ``chip_smoke.mesh_fleet_run``: tests/test_fleet_sharded.py's
13 cameras through its 36-tick swap and retarget sequence, every decision
held against a host ``LatencyController``, each tick timed on the host
clock ending in a synchronise.  ``--src`` drives another checkout's
``repro_torch`` with this script's rounds, so two checkouts are compared
on one card by running it for each in one call (parent, change, change,
parent).  Prints the card's ``name, power.limit``, one JSON line with each
layout's per-round tick p50s (ms) and their median, and the card's line
again.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--rounds", type=int, default=30)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("fleet_tick_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.sharding.partition import fleet_mesh
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    p50 = {"none": [], "one": []}
    for _ in range(args.rounds):
        for label in p50:
            mesh = None if label == "none" else fleet_mesh([dev])
            p50[label].append(chip_smoke.mesh_fleet_run(dev, mesh)
                              ["tick_p50_ms"])
    print(json.dumps({
        "src": str(args.src), "rounds": args.rounds,
        "ticks_a_round": chip_smoke.MESH_STEPS,
        **{label: {"median_p50_ms": statistics.median(v), "p50_ms": v}
           for label, v in p50.items()}}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
