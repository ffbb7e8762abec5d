"""Checkpoint reading (rsvldm_tpu/utils/checkpoint.py, without its orbax
cache: the port reads the torch formats directly, and never reads or writes
<ckpt_dir>/jax/).

`load_torch_state_dict` maps a file rather than reading it: safetensors
through utils/safetensors.py, .pth / .ckpt / .bin through
torch.load(mmap=True). Its tensors are views of the file, so overlaying two
checkpoints and stripping a family's prefix only decide which file each
name comes from; bytes are read when `load_checked` copies a tensor into
its module, one tensor at a time, cast there to the module's dtype on the
module's device.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

import torch
from torch import nn

from .safetensors import load_file

log = logging.getLogger("rsvldm_torch")


def load_torch_state_dict(path: str | Path) -> Dict[str, torch.Tensor]:
    """A .safetensors or .pth / .ckpt / .bin state dict, its tensors mapped
    from the file; a Lightning-style {"state_dict": ...} is unwrapped. The
    pickle formats are loaded with weights_only=False, as the reference
    loads them: a checkpoint file is trusted like code."""
    path = str(path)
    if path.endswith(".safetensors"):
        return load_file(path)
    sd = torch.load(path, map_location="cpu", mmap=True, weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def strip_prefix(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries under `prefix.`, with the prefix removed
    (rsvldm_tpu/utils/convert.py::strip_prefix)."""
    pl = prefix + "."
    return {k[len(pl):]: v for k, v in sd.items() if k.startswith(pl)}


def overlay(base: Dict[str, torch.Tensor],
            *overrides: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Non-strict overlay of checkpoints (juggernaut, then SR-v0Q): later
    dicts win name by name."""
    out = dict(base)
    for o in overrides:
        out.update(o)
    return out


@torch.no_grad()
def load_checked(module: nn.Module, sd: Dict[str, torch.Tensor], what: str) -> None:
    """Fills every parameter and buffer of `module` from `sd`: a name the
    module has and `sd` lacks raises KeyError, a shape that differs raises
    ValueError; names `sd` has beyond the module's (HF's position_ids,
    open_clip's logit_scale, the tower's unused post_layernorm) are logged
    and skipped. Each tensor is copied, and cast, into the module's own
    storage, so only one converted tensor exists at a time."""
    own = module.state_dict(keep_vars=True)
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{what}: checkpoint lacks {len(missing)} of the "
                       f"module's {len(own)} names, e.g. {missing[:5]}")
    bad = [(k, tuple(sd[k].shape), tuple(t.shape)) for k, t in own.items()
           if tuple(sd[k].shape) != tuple(t.shape)]
    if bad:
        raise ValueError(f"{what}: {len(bad)} shapes differ from the "
                         f"module's, e.g. (name, checkpoint, module) {bad[:3]}")
    extra = sorted(set(sd) - set(own))
    if extra:
        log.info("%s: %d checkpoint names the module does not have, "
                 "skipped: %s", what, len(extra), extra[:5])
    module.load_state_dict({k: sd[k] for k in own}, strict=True)
