"""Folder super-resolution CLI of the port (the root infer_dir.py's).

    python -m rsvldm_tpu_torch.infer_dir --image_dir LR_DIR --save_dir OUT

Every image of --image_dir (png, jpg, tif, bmp) goes through batched
Stage 1 (one loop per conditioning shape), batched captions (8 images a
decode) and batched refinement (4 images a loop), and lands in
OUT/sr3_output/sr3_<stem>.png and OUT/output/<stem>_final_0.png
(pipeline.ImageBatchProcessor). Weights come from --ckpt_dir as for
`python -m rsvldm_tpu_torch.infer`. It runs on CUDA unless given --device
cpu, and raises without a card. --num_steps is the refinement's EDM steps;
--quant and --stage1_sampler / --stage1_steps as in infer.py.
--debug_tiny runs the tiny geometries (infer.tiny_model_cfgs) with Stage
2b at a 64-pixel minimum size and a 64-pixel bucket, and captions nothing.

--mesh N runs on a mesh of N ranks (one process per card, started with
RSVLDM_COORDINATOR=host:port RSVLDM_NUM_PROCESSES=N RSVLDM_PROCESS_ID=i;
parallel/distributed.py): batched Stage 1 split over the ranks, the
captioner tensor-parallel over them, the first rank writing the files. As
in JAX, without --mesh a world of more than one rank takes every rank.

`build_processor(args)` is the construction the CLI runs; `main(argv)`
adds the run and prints "processed k/n images".
"""

from __future__ import annotations

import argparse
import logging

from .config import LlavaConfig, PipelineConfig
from .infer import tiny_model_cfgs
from .pipeline import ImageBatchProcessor


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_dir", type=str, required=True)
    ap.add_argument("--save_dir", type=str, default="./results")
    ap.add_argument("--upscale", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--num_steps", type=int, default=50,
                    help="EDM steps of the refinement")
    ap.add_argument("--img_threshold", type=float, default=0.3)
    ap.add_argument("--ckpt_dir", type=str, default="./CKPT_PTH")
    ap.add_argument("--no_llava", action="store_true")
    ap.add_argument("--stage1_only", action="store_true")
    ap.add_argument("--stage1_sampler", type=str, default="ddpm",
                    choices=["ddpm", "ddim"],
                    help="ddpm: the 500-step ancestral loop; ddim: DDIM in "
                         "--stage1_steps steps")
    ap.add_argument("--stage1_steps", type=int, default=50,
                    help="DDIM steps of Stage 1 (with --stage1_sampler ddim)")
    ap.add_argument("--debug_tiny", action="store_true",
                    help="the tiny geometries (smoke testing)")
    ap.add_argument("--quant", type=str, default="int8",
                    choices=["int8", "int4", ""],
                    help="caption decoder weights ('' = dense)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard folder batches + tensor-shard the captioner "
                         "over this many ranks (0 = all when >1 rank)")
    return ap.parse_args(argv)


def build_mesh(args):
    """The mesh of --mesh (JAX infer_dir.py:44-50): None unless more than
    one rank is asked for or running."""
    from .parallel.distributed import world
    n = world()[1]
    want = args.mesh or (n if n > 1 else 0)
    if want <= 1:
        return None
    from .parallel.mesh import make_mesh
    return make_mesh(min(want, n), tile=1)


def build_processor(args, mesh=None) -> ImageBatchProcessor:
    """The folder processor the CLI runs, from its parsed arguments."""
    cfg = PipelineConfig(image_dir=args.image_dir, output_dir=args.save_dir,
                         upscale=args.upscale, seed=args.seed,
                         ckpt_dir=args.ckpt_dir,
                         no_llava=args.no_llava or args.debug_tiny,
                         stage1_only=args.stage1_only,
                         llava=LlavaConfig(quant=args.quant))
    cfg.stage1.sampler = args.stage1_sampler
    cfg.stage1.ddim_steps = args.stage1_steps
    cfg.refine.img_threshold = args.img_threshold
    cfg.refine.edm_steps = args.num_steps
    model_cfgs = None
    if args.debug_tiny:
        model_cfgs = tiny_model_cfgs()
        cfg.refine.min_size = 64
        cfg.refine.size_bucket = 64
    return ImageBatchProcessor(cfg, device=args.device, model_cfgs=model_cfgs,
                               mesh=mesh)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from .device import resolve_device
    from .parallel.distributed import init_distributed
    args = parse_args(argv)
    resolve_device(args.device)  # raises without the card it names
    init_distributed()  # joins the RSVLDM_* rendezvous when it is set
    proc = build_processor(args, build_mesh(args))
    results = proc.run()
    ok = sum(1 for _, s in results if s in ("ok", "stage1"))
    print(f"processed {ok}/{len(results)} images", flush=True)
    return proc


if __name__ == "__main__":
    main()
