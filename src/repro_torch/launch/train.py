"""Training launcher of the port (the flags of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-next-gdn \
        --steps 200 --global-batch 8 --seq-len 256 --ckpt-dir /tmp/ckpt

Runs on the card (``--device cuda``, the default) or, with
``--device cpu``, on the CPU through the kernels' plain versions; without
a card and without ``--device cpu`` it raises.  ``--kernels`` sets
``use_flash_kernel``: the attention layers then train through the
hand-written flash-attention kernels.  The default is the reduced config;
``--full`` trains the full-width one.  minicpm-2b trains on the WSD
schedule whatever ``--schedule`` says, as the reference's CLI (its
paper's schedule).  Fault tolerance, checkpoint/resume, WSD/cosine
schedules and straggler logging come from ``repro_torch.runtime.trainer``.

Started under ``torchrun`` (or with ``RANK`` and ``WORLD_SIZE`` set, and
``MASTER_PORT``), each process joins the ranks (gloo on the CPU, NCCL on
the card: one card per rank) and the trainer trains on the data mesh over
all of them, as the reference's CLI trains on every device; only rank 0
prints::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen3-next-gdn --steps 4 --global-batch 4 --seq-len 64 \
        --device cpu
"""
from __future__ import annotations

import argparse
import logging
import os

import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def join_ranks(device: str) -> bool:
    """Join the ranks ``torchrun`` (or ``RANK`` / ``WORLD_SIZE``) started,
    unless a process group already runs; True when this call started
    one."""
    if dist.is_initialized() or "RANK" not in os.environ \
            or "WORLD_SIZE" not in os.environ:
        return False
    mesh_mod.init_ranks(int(os.environ["RANK"]),
                        int(os.environ["WORLD_SIZE"]),
                        int(os.environ.get("MASTER_PORT", "29500")),
                        "gloo" if device == "cpu" else "nccl")
    return True


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
    # minicpm trains with WSD per its paper (the reference's CLI)
    schedule = "wsd" if cfg.name == "minicpm-2b" else args.schedule
    tc = TrainerConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatches=args.microbatches,
        peak_lr=args.lr, schedule=schedule, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every)
    started = join_ranks(args.device)
    trainer = Trainer(cfg, tc, device=args.device)
    history = trainer.run()
    if not dist.is_initialized() or dist.get_rank() == 0:
        if trainer.axes is not None:
            print(f"mesh: data={trainer.axes.data.size} x "
                  f"model={trainer.axes.model.size}, fsdp={trainer.fsdp}")
        for step, loss in history:
            print(f"step {step:6d} loss {loss:.4f}")
    if started:
        dist.destroy_process_group()
    return history


if __name__ == "__main__":
    main()
