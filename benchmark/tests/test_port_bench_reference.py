"""benchmark/reference/ held to the port at tiny widths on the CPU, module
by module on the same seeded weights and inputs, for each configuration's
decoder knobs: the decoder's logits (int4, a causal forward against the
port's prefill), the SR3 UNet, the VAE, the text towers and one
CFG-doubled denoiser call. (The whole stages, with the samplers and the
key chain, are held in test_port_bench_rehearsal.py.)"""

import json

import pytest
import torch

from harness import manifest, weights
from reference import pipeline as ref
from reference.llama import Decoder

from harness.check import decoder_config
from test_port_bench_rehearsal import KNOBS, TINY

DEV = torch.device("cpu")
port = manifest.builder("pipeline")


def _spec(knobs):
    spec = json.loads(json.dumps(TINY))
    spec["text_config"].update(KNOBS[knobs])
    return spec


def _close(a, b, tol=1e-5):
    a, b = a.detach().float(), b.detach().float()
    scale = max(float(b.abs().max()), 1e-6)
    assert float((a - b).abs().max()) <= tol * scale


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_decoder_logits(knobs):
    from rsvldm_tpu_torch.models.vlm.llama import LlamaModel, quantize_llama_
    spec = _spec(knobs)
    tc = spec["text_config"]
    plan = [p for p in weights.family_plan(spec, "llava")
            if p[0].startswith(("model.embed", "model.layers", "model.norm",
                                "lm_head"))]
    sd = weights.make(plan, 3, "llava", DEV)
    sd = {k: v.float() for k, v in sd.items()}
    with torch.device("meta"):
        model = LlamaModel(port.llama_config(tc))
    model = model.to_empty(device=DEV).float()
    model.load_state_dict(sd)
    quantize_llama_(model, "int4")
    model.model.embed_tokens.weight.data = sd["model.embed_tokens.weight"]
    ids = torch.randint(0, tc["vocab_size"], (40,),
                        generator=torch.Generator().manual_seed(0))
    want, _ = model(model.embed(ids[None]))
    dec = Decoder(decoder_config(tc), sd, DEV)
    got = dec.logits(dec.embed_tokens(ids), torch.arange(40))
    _close(got, want[0], 1e-4)


def _pair(spec, family, seed=5):
    from rsvldm_tpu_torch.utils.checkpoint import load_checked
    cls, cfg = ref.family_configs(spec)[family]
    sd = weights.make(weights.family_plan(spec, family), seed, family, DEV)
    mcfg = port.model_configs(spec)["sdxl" if family in ("unet", "control")
                                    else family]
    import importlib
    mod = {"sr3": "rsvldm_tpu_torch.models.sr3.unet",
           "vae": "rsvldm_tpu_torch.models.vae.model",
           "clip_l": "rsvldm_tpu_torch.models.text.clip",
           "big_g": "rsvldm_tpu_torch.models.text.clip",
           "unet": "rsvldm_tpu_torch.models.sdxl.control",
           "control": "rsvldm_tpu_torch.models.sdxl.control"}[family]
    pcls = getattr(importlib.import_module(mod), cls.__name__)
    with torch.device("meta"):
        pm = pcls(mcfg)
    pm = pm.to_empty(device=DEV).float()
    load_checked(pm, sd, family)
    return pm.eval(), ref.build(cls, cfg, sd, DEV)


def test_sr3_vae_text_modules():
    spec = _spec("rsvldm-mistral-7b")
    g = torch.Generator().manual_seed(1)
    p, r = _pair(spec, "sr3")
    x = torch.randn(1, 6, 16, 16, generator=g)
    lvl = torch.rand(1, 1, generator=g)
    _close(r(x, lvl), p(x, lvl))
    p, r = _pair(spec, "vae")
    img = torch.rand(1, 3, 32, 32, generator=g) * 2 - 1
    _close(r.encode_with_denoise(img), p.encode_with_denoise(img))
    z = torch.randn(1, 4, 16, 16, generator=g)
    _close(r.decode(z), p.decode(z))
    for fam in ("clip_l", "big_g"):
        p, r = _pair(spec, fam)
        tok = torch.randint(0, 1000, (1, 77), generator=g)
        for k in ("penultimate", "pooled"):
            _close(r(tok)[k], p(tok)[k])


def test_denoiser_call():
    from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser as PD
    from reference.denoiser import ControlDenoiser as RD
    spec = _spec("rsvldm-mistral-7b")
    pu, ru = _pair(spec, "unet")
    pc, rc = _pair(spec, "control")
    g = torch.Generator().manual_seed(2)
    sd = spec["sdxl"]
    cond = {"crossattn": torch.randn(2, 77, sd["context_dim"], generator=g),
            "vector": torch.randn(2, sd["adm_in_channels"], generator=g),
            "control": torch.randn(2, 4, 8, 8, generator=g)}
    x = torch.randn(2, 4, 8, 8, generator=g)
    sigma = torch.tensor([3.0, 3.0])
    with torch.no_grad():
        want = PD(unet=pu, control_net=pc)(x, sigma, cond)
        got = RD(unet=ru, control_net=rc)(x, sigma, cond)
    _close(got, want)
