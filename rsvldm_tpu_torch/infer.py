"""Single-image super-resolution CLI of the port (the root infer.py's).

    python -m rsvldm_tpu_torch.infer --input_img lr.png --ckpt_dir CKPT_PTH

All three stages read their weights from --ckpt_dir (the layout in
pipeline.CHECKPOINTS, <ckpt_dir>/llava, Llava-next and clip_vocab); a
family without files is seeded with a warning. It runs on CUDA unless given
--device cpu, and raises without a card. --quant picks the caption
decoder's weights (int8, int4 or "" for dense). --stage1_sampler ddim runs
Stage 1 as DDIM in --stage1_steps steps (default 50, eta 0) instead of the
500-step ancestral loop. --draft_dir D decodes the caption with
speculative rounds proposed by the Llama checkpoint in D (by default
<ckpt_dir>/llava_draft when it exists), --self_draft N by the caption
decoder's own first N layers. --debug_tiny runs the JAX
pipeline's tiny geometries (its `_tiny_overrides`) with Stage 2b at a
64-pixel minimum size; unlike the JAX flag it still reads the files of
--ckpt_dir that exist (a directory written at those geometries) and does
not resize the input, and it captions nothing, as the JAX flag.

`build_pipeline(args)` is the construction the CLI runs; `main(argv)` adds
the run.
"""

from __future__ import annotations

import argparse
import logging

from .config import LlavaConfig, PipelineConfig
from .models.sdxl.unet import SDXLUNetConfig
from .models.sr3.unet import SR3UNetConfig
from .models.text.clip import CLIPTextConfig
from .models.vae.model import VAEConfig
from .pipeline import SuperResolutionPipeline

def tiny_model_cfgs() -> dict:
    """rsvldm_tpu/pipeline.py::_tiny_overrides in the port's classes."""
    return dict(
        sr3=SR3UNetConfig(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                          attn_res=(8,), res_blocks=1, image_size=16),
        # context = clip_l.width + big_g.width; adm = big_g.width + 3*512
        sdxl=SDXLUNetConfig(model_channels=32, num_res_blocks=1,
                            attention_resolutions=(2,), channel_mult=(1, 2),
                            num_head_channels=16, transformer_depth=(1, 1),
                            context_dim=64, adm_in_channels=32 + 3 * 512),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        clip_l=CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2),
        big_g=CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2,
                             quick_gelu=False, use_text_projection=True,
                             openclip=True))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input_img", type=str, required=True)
    ap.add_argument("--output_dir", type=str, default="./results")
    ap.add_argument("--upscale_factor", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--img_threshold", type=float, default=0.3)
    ap.add_argument("--edm_steps", type=int, default=50)
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
    ap.add_argument("--draft_dir", type=str, default="",
                    help="Llama-family draft checkpoint for speculative "
                         "caption decoding (default: <ckpt_dir>/llava_draft "
                         "when it exists)")
    ap.add_argument("--self_draft", type=int, default=0, metavar="N",
                    help="speculative caption decoding with the caption "
                         "decoder's first N layers as the draft")
    ap.add_argument("--lora_npz", type=str, default="",
                    help="adapter archive from train_vlm, folded into the "
                         "captioner (dense decoder) or served as the runtime "
                         "QLoRA branch (int8/int4 decoder)")
    ap.add_argument("--projector_npz", type=str, default="",
                    help="projector archive (replaces the checkpoint's "
                         "mm_projector)")
    ap.add_argument("--quant", type=str, default="int8",
                    choices=["int8", "int4", ""],
                    help="caption decoder weights ('' = dense)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def build_pipeline(args) -> SuperResolutionPipeline:
    """The pipeline the CLI runs, from its parsed arguments."""
    cfg = PipelineConfig(input_img=args.input_img, output_dir=args.output_dir,
                         upscale=args.upscale_factor, seed=args.seed,
                         ckpt_dir=args.ckpt_dir,
                         no_llava=args.no_llava or args.debug_tiny,
                         stage1_only=args.stage1_only,
                         llava=LlavaConfig(quant=args.quant,
                                           lora_npz=args.lora_npz,
                                           projector_npz=args.projector_npz,
                                           draft_dir=args.draft_dir,
                                           self_draft_layers=args.self_draft))
    cfg.stage1.sampler = args.stage1_sampler
    cfg.stage1.ddim_steps = args.stage1_steps
    cfg.refine.img_threshold = args.img_threshold
    cfg.refine.edm_steps = args.edm_steps
    model_cfgs = None
    if args.debug_tiny:
        model_cfgs = tiny_model_cfgs()
        cfg.refine.min_size = 64
    return SuperResolutionPipeline(cfg, device=args.device,
                                   model_cfgs=model_cfgs)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from .parallel.distributed import init_distributed
    args = parse_args(argv)
    init_distributed()  # joins the RSVLDM_* rendezvous when it is set
    pipe = build_pipeline(args)
    pipe.process()
    return pipe


if __name__ == "__main__":
    main()
