"""Device and dtype policy of the port.

Entry points run on CUDA unless the caller passes device="cpu"; asking for
CUDA on a machine without a card raises instead of moving to the CPU.

On CUDA, weights and compute are bf16; GroupNorm, LayerNorm and softmax
statistics are fp32 inside the modules. The few fp32 operations left (the
plain attention's logits, the colour fix) run in full fp32: TF32 is switched
off for both cuBLAS and cuDNN, the latter's default being on. On the CPU
everything is fp32.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rsvldm_tpu_torch: CUDA requested but no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"rsvldm_tpu_torch: unsupported device {dev}")
    return dev


def compute_dtype(device: torch.device, params_dtype: str = "bf16") -> torch.dtype:
    """bf16 on CUDA (the only dtype the K1 kernel takes), fp32 on CPU."""
    if device.type == "cpu":
        return torch.float32
    if params_dtype != "bf16":
        raise ValueError("rsvldm_tpu_torch: the CUDA path runs bf16 weights "
                         f"and compute, got params_dtype={params_dtype!r}")
    return torch.bfloat16
