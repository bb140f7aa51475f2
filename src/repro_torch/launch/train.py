"""Training launcher of the port (the flags of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-next-gdn \
        --steps 200 --global-batch 8 --seq-len 256 --ckpt-dir /tmp/ckpt

Runs on the card (``--device cuda``, the default) or, with
``--device cpu``, on the CPU through the kernels' plain versions; without
a card and without ``--device cpu`` it raises.  ``--kernels`` sets
``use_flash_kernel``: the attention layers then train through the
hand-written flash-attention kernels.  The default is the reduced config;
``--full`` trains the full-width one.  Fault tolerance, checkpoint/resume,
WSD/cosine schedules and straggler logging come from
``repro_torch.runtime.trainer``.
"""
from __future__ import annotations

import argparse
import logging

from repro_torch import configs
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--kernels", action="store_true", default=False,
                    help="use_flash_kernel: train the attention layers "
                         "through the hand-written flash kernels")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = configs.get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kernels:
        cfg = cfg.replace(use_flash_kernel=True)
    tc = TrainerConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatches=args.microbatches,
        peak_lr=args.lr, schedule=args.schedule, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every)
    trainer = Trainer(cfg, tc, device=args.device)
    history = trainer.run()
    for step, loss in history:
        print(f"step {step:6d} loss {loss:.4f}")
    return history


if __name__ == "__main__":
    main()
