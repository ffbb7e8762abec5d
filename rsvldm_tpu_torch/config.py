"""Pipeline configuration: the port's own copy of rsvldm_tpu/config.py.

Same dataclasses and defaults as the JAX package's Stage1Config,
RefinementConfig and PipelineConfig. LlavaConfig only carries what this
slice needs: the caption stage is not ported yet, so process() requires
no_llava.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass
class Stage1Config:
    """SR3 DDPM (configs/sr_sr3.json:38-92)."""
    steps: int = 500               # val schedule n_timestep
    schedule: str = "linear"
    linear_start: float = 1e-6
    linear_end: float = 1e-2
    image_size: int = 224
    inner_channel: int = 64
    channel_mults: tuple = (1, 2, 4, 8, 8)
    attn_res: tuple = (28,)
    res_blocks: int = 1
    # only the 500-step ancestral loop ("ddpm") is ported; "ddim" waits
    sampler: str = "ddpm"
    ddim_steps: int = 50
    ddim_eta: float = 0.0


@dataclasses.dataclass
class LlavaConfig:
    """Stage-2a captioning: a stub until the caption slice is ported; the
    pipeline requires PipelineConfig.no_llava."""


@dataclasses.dataclass
class RefinementConfig:
    """Stage-2b SDXL+ControlNet (infer.py:44-60 defaults)."""
    min_size: int = 1024
    edm_steps: int = 50
    s_churn: float = 5.0
    s_noise: float = 1.003
    s_cfg: float = 7.5
    s_stage1: float = -1.0         # restoration_scale
    s_stage2: float = 1.0          # control_scale
    img_threshold: float = 0.3
    num_samples: int = 1
    color_fix_type: str = "Wavelet"
    linear_cfg: bool = True
    linear_s_stage2: bool = False
    spt_linear_cfg: float = 4.0
    spt_linear_s_stage2: float = 0.0
    use_tile_vae: bool = False
    encoder_tile_size: int = 512
    decoder_tile_size: int = 64
    # folder-mode padding bucket; single-image process() never pads
    size_bucket: int = 512
    a_prompt: str = (
        "Cinematic, High Contrast, highly detailed aerial photo taken using a "
        "high-resolution drone or satellite, hyper detailed photo-realistic "
        "maximum detail, 32k, Color Grading, ultra HD, extreme meticulous "
        "detailing of terrain textures and structures, hyper sharpness, no "
        "deformations.")
    n_prompt: str = (
        "painting, oil painting, illustration, drawing, art, sketch, oil "
        "painting, cartoon, CG Style, 3D render, unreal engine, blurring, "
        "dirty, messy, worst quality, low quality, frames, watermark, "
        "signature, jpeg artifacts, deformed, lowres, over-smooth, cloud "
        "cover, heavy fog, motion blur, lens flare")


@dataclasses.dataclass
class PipelineConfig:
    input_img: str = ""
    image_dir: str = ""
    output_dir: str = "./results"
    ckpt_dir: str = "./CKPT_PTH"
    upscale: int = 8
    seed: int = 42
    no_llava: bool = False
    stage1_only: bool = False
    # weights and compute dtype on CUDA; CPU always runs fp32
    params_dtype: str = "bf16"
    stage1: Stage1Config = dataclasses.field(default_factory=Stage1Config)
    llava: LlavaConfig = dataclasses.field(default_factory=LlavaConfig)
    refine: RefinementConfig = dataclasses.field(default_factory=RefinementConfig)

    def __post_init__(self):
        self.output_dir = Path(self.output_dir)
