"""End-to-end training driver on the PyTorch port: the JAX example's
"~100M" qwen3-family model (54.1M parameters by ``param_count()``, its
32k-row embedding tied to the head) trained on the synthetic token
stream, with checkpointing, failure injection and recovery, and
(optionally) the approximate collective's compressed gradients.

The counterpart of ``examples/train_100m.py``, built from
``repro_torch.configs`` and run by ``repro_torch.launch.train.train``.  It
runs on the card unless ``--device cpu`` is given; with ``--grad-bits 8``
the gradients take the hand-written quantize and dequantize kernels'
round trip there.

Run:  PYTHONPATH=src python examples/torch_train_100m.py [--steps 200]
      PYTHONPATH=src python examples/torch_train_100m.py --device cpu \\
          --steps 4 --batch 1 --seq 32
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config


def build_100m_config():
    """qwen3 wiring at 12L x 512d x 8H, 32k vocab: the JAX example's
    config, field for field."""
    base = get_config("qwen3-1.7b")
    return dataclasses.replace(
        base, name="qwen3-100m", num_layers=12, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=1536, vocab_size=32000,
        qk_norm=True, tie_embeddings=True, param_dtype="float32",
        compute_dtype="float32", remat="none", train_microbatches=1,
        attention_chunk=128)


def main(argv: "list[str] | None" = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt_100m"))
    ap.add_argument("--grad-bits", type=int, default=16)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import repro_torch.configs as C
    from repro_torch.launch.train import train
    cfg = build_100m_config()
    C.ARCHS[cfg.name] = cfg    # register for the launcher
    print(f"model: {cfg.name}  ~{cfg.param_count() / 1e6:.0f}M params  "
          f"device: {args.device}")

    out = train(cfg.name, steps=args.steps, batch=args.batch, seq=args.seq,
                reduced=False, checkpoint_dir=args.ckpt, checkpoint_every=20,
                grad_bits=args.grad_bits,
                inject_failure_at=args.inject_failure_at, log_every=10,
                device=args.device)
    print(f"loss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} over "
          f"{out['steps']} steps ({out['wall_s']:.0f}s, "
          f"{out['wall_s'] / max(out['steps'], 1):.2f}s/step)")
    assert out["final_loss"] < out["first_loss"], "loss must decrease"
    return out


if __name__ == "__main__":
    main()
