"""Quality-evaluation CLI of the port (the root eval_dir.py's): score a
folder of SR outputs, and the HR folder they pair with by stem, with
CLIP-IQA / SMS / PSNR / SSIM / LPIPS, and print one JSON line.

    python -m rsvldm_tpu_torch.eval_dir --sr_dir OUT --hr_dir HR --ckpt_dir C

It runs on CUDA unless given --device cpu, and raises without a card.
--out F also writes the per-image records to F. The assets it reads from
--ckpt_dir are listed in eval/quality.py.
"""

from .eval.quality import main

if __name__ == "__main__":
    main()
