"""File utilities (rsvldm_tpu/utils/file.py): a sorted file listing, the
download-if-missing checkpoint cache, and LLaVA's delta / merge tools
(apply_delta, make_delta, consolidate) on torch state dicts, without
building a model."""

from __future__ import annotations

import os
import shutil
import urllib.request
from pathlib import Path
from typing import Dict, Iterable
from urllib.parse import urlparse

import torch

_EXTRA_OK = ("model.mm_projector.weight", "model.mm_projector.bias")
_VOCAB_EXTENDED = ("model.embed_tokens.weight", "lm_head.weight")


def list_files(root: str, suffixes: Iterable[str] = (".png", ".jpg"),
               recursive: bool = True) -> list:
    """Files under `root` with one of `suffixes` (any case), sorted."""
    root_p = Path(root)
    it = root_p.rglob("*") if recursive else root_p.iterdir()
    return sorted(str(p) for p in it
                  if p.is_file() and p.suffix.lower() in set(suffixes))


def load_file_from_url(url: str, model_dir: str | None = None,
                       progress: bool = True,
                       file_name: str | None = None) -> str:
    """The cached path of `url` under `model_dir` (default
    $XDG_CACHE_HOME/rsvldm_tpu/checkpoints), fetched once through a
    `.part` file; an existing file is returned without any request."""
    if model_dir is None:
        model_dir = os.path.join(
            os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
            "rsvldm_tpu", "checkpoints")
    os.makedirs(model_dir, exist_ok=True)
    filename = file_name or os.path.basename(urlparse(url).path)
    cached = os.path.abspath(os.path.join(model_dir, filename))
    if not os.path.exists(cached):
        tmp = cached + ".part"
        with urllib.request.urlopen(url) as r, open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        os.replace(tmp, cached)
    return cached


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _extra(name: str, extra_ok) -> None:
    if not any(name.endswith(e) for e in extra_ok):
        raise KeyError(f"{name} is not in the base state dict and not a "
                       "known extra (the projector)")


def apply_delta(base_sd: Dict, delta_sd: Dict,
                extra_ok: Iterable[str] = _EXTRA_OK) -> Dict[str, torch.Tensor]:
    """target = delta + base, fp32 (LLaVA apply_delta.py): a name absent
    from base must be a known extra (the projector); where the shapes
    differ (the vocabulary-extended embedding and lm_head) base adds into
    the leading slice."""
    out: Dict[str, torch.Tensor] = {}
    for name, dparam in delta_sd.items():
        d = _f32(dparam)
        if name not in base_sd:
            _extra(name, extra_ok)
            out[name] = d.clone()
            continue
        b = _f32(base_sd[name])
        if d.shape == b.shape:
            out[name] = d + b
        else:
            if name not in _VOCAB_EXTENDED:
                raise ValueError(f"{name} dimension mismatch: "
                                 f"{tuple(d.shape)} vs {tuple(b.shape)}")
            t = d.clone()
            t[: b.shape[0], : b.shape[1]] += b
            out[name] = t
    return out


def make_delta(base_sd: Dict, target_sd: Dict,
               extra_ok: Iterable[str] = _EXTRA_OK) -> Dict[str, torch.Tensor]:
    """delta = target - base, fp32 (LLaVA make_delta.py), the inverse of
    apply_delta with the same vocabulary-extension slice rule."""
    out: Dict[str, torch.Tensor] = {}
    for name, tparam in target_sd.items():
        t = _f32(tparam)
        if name not in base_sd:
            _extra(name, extra_ok)
            out[name] = t.clone()
            continue
        b = _f32(base_sd[name])
        if t.shape == b.shape:
            out[name] = t - b
        else:
            if name not in _VOCAB_EXTENDED:
                raise ValueError(f"{name} dimension mismatch: "
                                 f"{tuple(t.shape)} vs {tuple(b.shape)}")
            d = t.clone()
            d[: b.shape[0], : b.shape[1]] -= b
            out[name] = d
    return out


def consolidate(sd: Dict, drop_prefixes: Iterable[str] = ("base_model.model.",)
                ) -> Dict:
    """The state dict with a training wrapper's prefix stripped from each
    name (the first of `drop_prefixes` that matches), so a finetuned
    checkpoint loads as a plain model."""
    out: Dict = {}
    for k, v in sd.items():
        for p in drop_prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out
