"""SR3 Stage-1 training CLI of the port (train_sr3.py).

LRHR triplet data (<data_root>/hr_{r}/, sr_{l}_{r}/, lr_{l}/, as
data/prepare.py or the reference prepare_data.py write them), Adam and the
EMA every step, worker-thread decoding and batches staged on the device
ahead of the step, checkpoints I{step}_gen.pth / I{step}_opt.pth in
--save_dir, resume with --resume_iter:

  python -m rsvldm_tpu_torch.train_sr3 --data_root data --steps 1000
  python -m rsvldm_tpu_torch.train_sr3 --data_root data --steps 2000 \\
      --resume_iter 1000

The UNet is the pipeline's SR3 (64 channels, x(1, 2, 4, 8, 8)) at
--r_res; --debug_tiny takes the JAX pipeline's tiny geometry instead. As
in the JAX CLI, the loss draws come from a generator seeded --seed + 1 at
the start of each run and the loader restarts at its first epoch. It runs
on CUDA unless given --device cpu, and raises without a card.

On N ranks (one process per card; RSVLDM_COORDINATOR=host:port
RSVLDM_NUM_PROCESSES=N RSVLDM_PROCESS_ID=i, parallel/distributed.py) the
step is data-parallel over a mesh of them all: --batch_size is the global
batch, each rank loads only its rows of it, and the first rank saves.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import torch

from .device import resolve_device
from .models.sr3.unet import SR3UNetConfig
from .training.sr3_trainer import SR3TrainConfig, SR3Trainer

# the JAX pipeline's _tiny_overrides SR3 geometry (image_size set from r_res)
TINY_SR3 = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                attn_res=(8,), res_blocks=1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", type=str, required=True)
    ap.add_argument("--l_res", type=int, default=28)
    ap.add_argument("--r_res", type=int, default=224)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=1_000_000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--save_dir", type=str, default="./checkpoints/sr3")
    ap.add_argument("--resume_iter", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=200)
    ap.add_argument("--num_workers", type=int, default=4,
                    help="threaded item-decode workers (0 = inline)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches staged on the device ahead of the step")
    ap.add_argument("--debug_tiny", action="store_true",
                    help="the JAX pipeline's tiny SR3 geometry")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def model_config(args) -> SR3UNetConfig:
    cfg = SR3UNetConfig(image_size=args.r_res)
    return dataclasses.replace(cfg, **TINY_SR3) if args.debug_tiny else cfg


def build_trainer(args, state_dict=None, mesh=None) -> SR3Trainer:
    """The trainer of `args`, resumed from --resume_iter when set.
    `state_dict` gives the starting UNet (a test feeds JAX's init); `mesh`
    makes the step data-parallel."""
    device = resolve_device(args.device)
    trainer = SR3Trainer(model_config(args),
                         SR3TrainConfig(lr=args.lr),
                         device=device, state_dict=state_dict,
                         generator=torch.Generator(device).manual_seed(args.seed),
                         mesh=mesh)
    if args.resume_iter:
        trainer.load(args.save_dir, args.resume_iter)
    return trainer


def run(args, trainer: SR3Trainer, draws=None, on_step=None) -> SR3Trainer:
    """Train to --steps and save. `draws(i) -> (t, u, noise)` replaces the
    generator's draws of step i (a test feeds JAX's)."""
    from .data.datasets import LRHRDataset
    from .data.prefetch import make_loader
    from .parallel.distributed import local_batch_range
    ds = LRHRDataset(args.data_root, args.l_res, args.r_res, split="train")
    rows = (local_batch_range(args.batch_size) if trainer.mesh is not None
            else None)
    it = make_loader(ds, args.batch_size, num_workers=args.num_workers,
                     prefetch=args.prefetch, device=trainer.device,
                     seed=args.seed, rows=rows)
    try:
        gen = torch.Generator(trainer.device).manual_seed(args.seed + 1)
        trainer.fit(it, args.steps - trainer.step, gen,
                    log_every=args.log_every, save_dir=args.save_dir,
                    draws=draws, on_step=on_step)
    finally:
        it.close()
    trainer.save(args.save_dir)
    return trainer


def main(argv=None):
    from .parallel.distributed import init_distributed, world
    from .parallel.mesh import make_mesh
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    init_distributed()
    mesh = make_mesh(tile=1) if world()[1] > 1 else None
    run(args, build_trainer(args, mesh=mesh))


if __name__ == "__main__":
    main()
