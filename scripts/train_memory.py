"""The card's memory through one family's training step, stage by stage.

    python3 scripts/train_memory.py [ARCH] [LAYERS] [BATCH] [SEQ] [STEPS]

Defaults: ``qwen2-vl-72b 2 1 2048 3``, the largest of ``chip_smoke.py``'s
train_families cases.  Builds the config as that phase does
(``chip_smoke.tf_config``: the published widths, the depth cut to
LAYERS), its parameters, AdamW moments and one training batch, then runs
STEPS steps as ``launch.steps.build_train_step`` composes them: the
gradients (``compute_grads``, the config's microbatch rule), the 8-bit
hook (``make_grad_compressor``, through the quantize kernels), AdamW.
After each stage it prints one JSON line: the bytes allocated and
reserved, their peaks so far, and the card's free bytes
(``torch.cuda.mem_get_info``), all in GB.  Prints the card's ``name,
power.limit`` first and last.  Exits 2 without a CUDA device."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_memory.py needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.core.approx_comm import make_grad_compressor
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch.steps import compute_grads, microbatch_count
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         init_opt_state)
    defaults = ["qwen2-vl-72b", "2", "1", "2048", "3"]
    args = argv + defaults[len(argv):]
    arch = args[0]
    layers, batch, seq, steps = (int(a) for a in args[1:5])
    print(card(), flush=True)
    C.build_only("quantize_blocks", Q._load_lib)
    dev = torch.device("cuda")
    cfg = C.tf_config(arch, layers)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = model.init_params(g, device=dev)
    data = make_batch(cfg, batch, seq, generator=g, device=dev, train=True)
    hook = make_grad_compressor(C.TRAIN_BITS, min_size=C.GRAD_MIN_SIZE)
    m = microbatch_count(cfg, batch)

    def stage(tag: str) -> None:
        torch.cuda.synchronize()
        gb = 1e9
        print(json.dumps(dict(
            arch=arch, layers=layers, batch=batch, seq=seq, stage=tag,
            allocated_gb=torch.cuda.memory_allocated() / gb,
            reserved_gb=torch.cuda.memory_reserved() / gb,
            max_allocated_gb=torch.cuda.max_memory_allocated() / gb,
            max_reserved_gb=torch.cuda.max_memory_reserved() / gb,
            free_gb=torch.cuda.mem_get_info()[0] / gb)), flush=True)

    stage("params")
    state = init_opt_state(params, device=dev)
    stage("moments")
    for i in range(steps):
        _, grads = compute_grads(model, params, data, m)
        stage(f"grads{i}")
        grads = hook(grads)
        stage(f"hook{i}")
        params, state = adamw_update(AdamWConfig(), params, grads, state)
        del grads
        stage(f"adamw{i}")
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
