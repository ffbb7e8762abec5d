"""Weights: JAX parameter trees to the port's state dicts, and seeded random
init for missing checkpoints.

The port's parameter names are the reference torch checkpoints' names, the
ones rsvldm_tpu/utils/convert.py (SR3, VAE, GLVControl, SDXL UNet) and
rsvldm_tpu/utils/convert_hf.py (CLIP-L in HF layout, bigG in open_clip
layout, the Llama-family decoders with MoE in Mixtral's or Qwen2-MoE's
names, MPT, the CLIP-336 / MLCD / open_clip / EVA vision towers, the
projectors, T5, the Q-Former and perceiver resamplers) and
rsvldm_tpu/models/vlm/siglip.py (SigLIP) read. `params_from_jax` is the inverse of those converters: a Flax
tree (numpy leaves) becomes a state dict that the port's module loads with
strict=True. Layouts: Flax conv [kh, kw, in, out] -> torch [out, in, kh, kw];
dense [in, out] -> [out, in]; norm scale -> weight.
"""

from __future__ import annotations

import logging
import zlib
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..models.sdxl.unet import _build_specs
from ..models.vlm.llama import RMSNorm
from ..ops.norm import GroupNorm32

log = logging.getLogger("rsvldm_torch")
FAMILIES = ("sr3", "vae", "control", "unet", "clip_l", "big_g", "llama",
            "clip_vision", "projector", "mpt", "mlcd", "openclip_vision",
            "siglip", "eva", "t5", "qformer", "perceiver", "pooler_projector")


def _arr(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


class _SD(dict):
    """State dict under construction, with the Flax -> torch layout rules."""

    def conv(self, prefix, p):
        self[f"{prefix}.weight"] = _arr(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            self[f"{prefix}.bias"] = _arr(p["bias"])

    def dense(self, prefix, p):
        self[f"{prefix}.weight"] = _arr(np.asarray(p["kernel"]).T)
        if "bias" in p:
            self[f"{prefix}.bias"] = _arr(p["bias"])

    def norm(self, prefix, p):
        self[f"{prefix}.weight"] = _arr(p["scale"])
        if "bias" in p:  # bias-free LayerNorms (MPT) have none
            self[f"{prefix}.bias"] = _arr(p["bias"])


# ------------------------------------------------------------------ SR3
def _sr3(p, cfg) -> _SD:
    sd = _SD()
    sd.dense("noise_level_mlp.1", p["noise_level_mlp"]["fc1"])
    sd.dense("noise_level_mlp.3", p["noise_level_mlp"]["fc2"])

    def block(prefix, b):
        sd.norm(f"{prefix}.block.0", b["norm"])
        sd.conv(f"{prefix}.block.3", b["conv"])

    def res_with_attn(prefix, q):
        rb = q["res_block"]
        block(f"{prefix}.res_block.block1", rb["block1"])
        sd.dense(f"{prefix}.res_block.noise_func.noise_func.0", rb["noise_func"])
        block(f"{prefix}.res_block.block2", rb["block2"])
        if "res_conv" in rb:
            sd.conv(f"{prefix}.res_block.res_conv", rb["res_conv"])
        if "attn" in q:
            sd.norm(f"{prefix}.attn.norm", q["attn"]["norm"])
            sd.conv(f"{prefix}.attn.qkv", q["attn"]["qkv"])
            sd.conv(f"{prefix}.attn.out", q["attn"]["out"])

    num_mults = len(cfg.channel_mults)
    sd.conv("downs.0", p["conv_in"])
    ti = 1
    for ind in range(num_mults):
        for blk in range(cfg.res_blocks):
            res_with_attn(f"downs.{ti}", p[f"down_{ind}_{blk}"])
            ti += 1
        if ind != num_mults - 1:
            sd.conv(f"downs.{ti}.conv", p[f"downsample_{ind}"])
            ti += 1
    res_with_attn("mid.0", p["mid_0"])
    res_with_attn("mid.1", p["mid_1"])
    ti = 0
    for ind in reversed(range(num_mults)):
        for blk in range(cfg.res_blocks + 1):
            res_with_attn(f"ups.{ti}", p[f"up_{ind}_{blk}"])
            ti += 1
        if ind > 0:
            sd.conv(f"ups.{ti}.conv", p[f"upsample_{ind}"])
            ti += 1
    block("final_conv", p["final_conv"])
    return sd


# ------------------------------------------------------------------ VAE
def _vae_resblock(sd, prefix, p):
    for n in ("norm1", "norm2"):
        sd.norm(f"{prefix}.{n}", p[n])
    for n in ("conv1", "conv2", "nin_shortcut"):
        if n in p:
            sd.conv(f"{prefix}.{n}", p[n])


def _vae_mid(sd, prefix, p):
    _vae_resblock(sd, f"{prefix}.mid.block_1", p["mid_block_1"])
    a = p["mid_attn_1"]
    sd.norm(f"{prefix}.mid.attn_1.norm", a["norm"])
    for n in ("q", "k", "v", "proj_out"):
        sd.conv(f"{prefix}.mid.attn_1.{n}", a[n])
    _vae_resblock(sd, f"{prefix}.mid.block_2", p["mid_block_2"])


def _vae(p, cfg) -> _SD:
    sd = _SD()
    for enc in ("encoder", "denoise_encoder"):
        e = p[enc]
        sd.conv(f"{enc}.conv_in", e["conv_in"])
        for i in range(len(cfg.ch_mult)):
            for j in range(cfg.num_res_blocks):
                _vae_resblock(sd, f"{enc}.down.{i}.block.{j}", e[f"down_{i}_block_{j}"])
            if i != len(cfg.ch_mult) - 1:
                sd.conv(f"{enc}.down.{i}.downsample.conv",
                        e[f"down_{i}_downsample"]["conv"])
        _vae_mid(sd, enc, e)
        sd.norm(f"{enc}.norm_out", e["norm_out"])
        sd.conv(f"{enc}.conv_out", e["conv_out"])
    d = p["decoder"]
    sd.conv("decoder.conv_in", d["conv_in"])
    _vae_mid(sd, "decoder", d)
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks + 1):
            _vae_resblock(sd, f"decoder.up.{i}.block.{j}", d[f"up_{i}_block_{j}"])
        if i != 0:
            sd.conv(f"decoder.up.{i}.upsample.conv", d[f"up_{i}_upsample"]["conv"])
    sd.norm("decoder.norm_out", d["norm_out"])
    sd.conv("decoder.conv_out", d["conv_out"])
    sd.conv("quant_conv", p["quant_conv"])
    sd.conv("post_quant_conv", p["post_quant_conv"])
    return sd


# ----------------------------------------------------------- SDXL UNet
def _res(sd, prefix, p):
    sd.norm(f"{prefix}.in_layers.0", p["in_norm"])
    sd.conv(f"{prefix}.in_layers.2", p["in_conv"])
    sd.dense(f"{prefix}.emb_layers.1", p["emb_proj"])
    sd.norm(f"{prefix}.out_layers.0", p["out_norm"])
    sd.conv(f"{prefix}.out_layers.3", p["out_conv"])
    if "skip" in p:
        sd.conv(f"{prefix}.skip_connection", p["skip"])


def _xattn(sd, prefix, p):
    for n in ("to_q", "to_k", "to_v"):
        sd.dense(f"{prefix}.{n}", p[n])
    sd.dense(f"{prefix}.to_out.0", p["to_out"])


def _spatial_transformer(sd, prefix, p, depth):
    sd.norm(f"{prefix}.norm", p["norm"])
    sd.dense(f"{prefix}.proj_in", p["proj_in"])
    sd.dense(f"{prefix}.proj_out", p["proj_out"])
    for d in range(depth):
        bp, b = f"{prefix}.transformer_blocks.{d}", p[f"block_{d}"]
        _xattn(sd, f"{bp}.attn1", b["attn1"])
        _xattn(sd, f"{bp}.attn2", b["attn2"])
        sd.dense(f"{bp}.ff.net.0.proj", b["ff"]["proj"])
        sd.dense(f"{bp}.ff.net.2", b["ff"]["out"])
        for n in ("norm1", "norm2", "norm3"):
            sd.norm(f"{bp}.{n}", b[n])


def _unet_common(sd, p, cfg):
    in_specs, out_specs, _ = _build_specs(cfg)
    sd.dense("time_embed.0", p["time_dense1"])
    sd.dense("time_embed.2", p["time_dense2"])
    sd.dense("label_emb.0.0", p["label_dense1"])
    sd.dense("label_emb.0.2", p["label_dense2"])
    sd.conv("input_blocks.0.0", p["conv_in"])
    for i, s in enumerate(in_specs):
        cell, prefix = p[f"input_{i}"], f"input_blocks.{i + 1}"
        if s["kind"] == "down":
            sd.conv(f"{prefix}.0.op", cell["down_conv"])
            continue
        _res(sd, f"{prefix}.0", cell["resblock"])
        if s["st_depth"] > 0:
            _spatial_transformer(sd, f"{prefix}.1", cell["transformer"], s["st_depth"])
    _res(sd, "middle_block.0", p["mid_res1"])
    _spatial_transformer(sd, "middle_block.1", p["mid_transformer"],
                         cfg.transformer_depth[-1])
    _res(sd, "middle_block.2", p["mid_res2"])
    return out_specs


def _unet(p, cfg) -> _SD:
    """ControlledUNet: the UNet plus project_modules."""
    sd = _SD()
    u = p["unet"]
    out_specs = _unet_common(sd, u, cfg)
    for i, s in enumerate(out_specs):
        cell, prefix = u[f"output_{i}"], f"output_blocks.{i}"
        _res(sd, f"{prefix}.0", cell["resblock"])
        up_idx = 1
        if s["st_depth"] > 0:
            _spatial_transformer(sd, f"{prefix}.1", cell["transformer"], s["st_depth"])
            up_idx = 2
        if s["has_up"]:
            sd.conv(f"{prefix}.{up_idx}.conv", cell["up_conv"])
    sd.norm("out.0", u["out_norm"])
    sd.conv("out.2", u["out_conv"])
    for name, m in p.items():
        if not name.startswith("project_"):
            continue
        tp = f"project_modules.{name.split('_', 1)[1]}"
        if "param_free_norm" in m:
            sd.norm(f"{tp}.param_free_norm", m["param_free_norm"])
            sd.conv(f"{tp}.mlp_shared.0", m["mlp_shared"])
            for n in ("zero_mul", "zero_add", "zero_conv"):
                sd.conv(f"{tp}.{n}", m[n])
        else:
            sd.norm(f"{tp}.norm1", m["norm1"])
            sd.norm(f"{tp}.norm2", m["norm2"])
            _xattn(sd, f"{tp}.attn", m["attn"])
    return sd


def _control(p, cfg) -> _SD:
    sd = _SD()
    _unet_common(sd, p, cfg)
    sd.conv("input_hint_block.0", p["input_hint"])
    return sd


# ------------------------------------------------------------------ CLIP
def _clip_l(p, cfg) -> _SD:
    sd, pre = _SD(), "text_model"
    sd[f"{pre}.embeddings.token_embedding.weight"] = _arr(p["token_embedding"])
    sd[f"{pre}.embeddings.position_embedding.weight"] = _arr(p["positional_embedding"])
    sd.norm(f"{pre}.final_layer_norm", p["ln_final"])
    for i in range(cfg.layers):
        lp, b = f"{pre}.encoder.layers.{i}", p[f"block_{i}"]
        sd.norm(f"{lp}.layer_norm1", b["ln_1"])
        sd.norm(f"{lp}.layer_norm2", b["ln_2"])
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.dense(f"{lp}.self_attn.{n}", b["attn"][n])
        sd.dense(f"{lp}.mlp.fc1", b["mlp_fc"])
        sd.dense(f"{lp}.mlp.fc2", b["mlp_proj"])
    if cfg.use_text_projection:
        sd["text_projection.weight"] = _arr(np.asarray(p["text_projection"]).T)
    return sd


def _big_g(p, cfg) -> _SD:
    sd = _SD()
    sd["token_embedding.weight"] = _arr(p["token_embedding"])
    sd["positional_embedding"] = _arr(p["positional_embedding"])
    sd.norm("ln_final", p["ln_final"])
    if cfg.use_text_projection:
        sd["text_projection"] = _arr(p["text_projection"])
    for i in range(cfg.layers):
        lp, b = f"transformer.resblocks.{i}", p[f"block_{i}"]
        a = b["attn"]
        sd[f"{lp}.attn.in_proj_weight"] = _arr(np.concatenate(
            [np.asarray(a[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")]))
        sd[f"{lp}.attn.in_proj_bias"] = _arr(np.concatenate(
            [np.asarray(a[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]))
        sd.dense(f"{lp}.attn.out_proj", a["out_proj"])
        sd.norm(f"{lp}.ln_1", b["ln_1"])
        sd.norm(f"{lp}.ln_2", b["ln_2"])
        sd.dense(f"{lp}.mlp.c_fc", b["mlp_fc"])
        sd.dense(f"{lp}.mlp.c_proj", b["mlp_proj"])
    return sd


# ------------------------------------------------------------ LLaVA
def _llama(p, cfg) -> _SD:
    """HF LlamaForCausalLM names (convert_llama): q/k/v biases where the
    tree has them (Qwen2), no lm_head when tied (Gemma), MoE layers in
    Mixtral's or Qwen2-MoE's names (`_moe`)."""
    sd = _SD()
    sd["model.embed_tokens.weight"] = _arr(p["embed_tokens"]["embedding"])
    sd["model.norm.weight"] = _arr(p["norm"]["weight"])
    if "lm_head" in p:  # absent when tied to the embedding
        sd.dense("lm_head", p["lm_head"])
    for i in range(cfg.layers):
        lp, b = f"model.layers.{i}", p[f"layer_{i}"]
        sd[f"{lp}.input_layernorm.weight"] = _arr(b["attn_norm"]["weight"])
        sd[f"{lp}.post_attention_layernorm.weight"] = _arr(b["mlp_norm"]["weight"])
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd.dense(f"{lp}.self_attn.{n}", b[n])
        if "moe" in b:
            _moe(sd, lp, b["moe"], cfg)
            continue
        for n in ("gate_proj", "up_proj", "down_proj"):
            sd.dense(f"{lp}.mlp.{n}", b[n])
    return sd


def _moe(sd, lp, m, cfg):
    """One MoEFFN (the inverse of convert_hf._convert_moe_layer): Mixtral's
    `block_sparse_moe.{gate, experts.{e}.{w1, w3, w2}}` without a shared
    expert, Qwen2-MoE's `mlp.{gate, experts.{e}.{gate,up,down}_proj,
    shared_expert.*, shared_expert_gate}` with one."""
    if cfg.moe_layout == "mixtral":
        mp, names = f"{lp}.block_sparse_moe", ("w1", "w3", "w2")
    else:
        mp, names = f"{lp}.mlp", ("gate_proj", "up_proj", "down_proj")
    sd.dense(f"{mp}.gate", m["router"])
    for stack, name in zip(("experts_gate", "experts_up", "experts_down"), names):
        w = np.asarray(m[stack])
        for e in range(w.shape[0]):
            sd[f"{mp}.experts.{e}.{name}.weight"] = _arr(w[e].T)
    if "shared_gate_proj" in m:
        for n in ("gate_proj", "up_proj", "down_proj"):
            sd.dense(f"{mp}.shared_expert.{n}", m[f"shared_{n}"])
        sd.dense(f"{mp}.shared_expert_gate", m["shared_expert_gate"])


def _mpt(p, cfg) -> _SD:
    """HF MptForCausalLM names (convert_mpt); the lm_head is tied to wte."""
    sd = _SD()
    sd["transformer.wte.weight"] = _arr(p["wte"]["embedding"])
    sd.norm("transformer.norm_f", p["norm_f"])
    for i in range(cfg.layers):
        lp, b = f"transformer.blocks.{i}", p[f"block_{i}"]
        sd.norm(f"{lp}.norm_1", b["norm_1"])
        sd.norm(f"{lp}.norm_2", b["norm_2"])
        sd.dense(f"{lp}.attn.Wqkv", b["wqkv"])
        sd.dense(f"{lp}.attn.out_proj", b["out_proj"])
        sd.dense(f"{lp}.ffn.up_proj", b["up_proj"])
        sd.dense(f"{lp}.ffn.down_proj", b["down_proj"])
    return sd


def _clip_vision(p, cfg) -> _SD:
    """HF CLIPVisionModel names (convert_hf_clip_vision)."""
    sd, pre = _SD(), "vision_model"
    sd[f"{pre}.embeddings.class_embedding"] = _arr(p["class_embedding"])
    sd[f"{pre}.embeddings.position_embedding.weight"] = _arr(p["positional_embedding"])
    sd.conv(f"{pre}.embeddings.patch_embedding", p["patch_embed"])
    sd.norm(f"{pre}.pre_layrnorm", p["ln_pre"])
    _clip_blocks(sd, pre, p, cfg.layers)
    return sd


def _projector(p, cfg) -> _SD:
    """mlpNx_gelu as nn.Sequential (convert_mm_projector for N = 2):
    fc{i} -> 2i; one layer (`linear`) is a bare nn.Linear."""
    sd = _SD()
    n = len([k for k in p if k.startswith("fc")])
    if n == 1:
        sd["weight"] = _arr(np.asarray(p["fc0"]["kernel"]).T)
        sd["bias"] = _arr(p["fc0"]["bias"])
        return sd
    for i in range(n):
        sd.dense(str(2 * i), p[f"fc{i}"])
    return sd


def _pooler_projector(p, cfg) -> _SD:
    """PoolerProjector (convert_pooler_projector): conv_pool, proj.1."""
    sd = _SD()
    sd.conv("conv_pool", p["conv_pool"])
    sd.dense("proj.1", p["proj"])
    return sd


def _clip_blocks(sd, pre, p, layers):
    for i in range(layers):
        lp, b = f"{pre}.encoder.layers.{i}", p[f"block_{i}"]
        sd.norm(f"{lp}.layer_norm1", b["ln_1"])
        sd.norm(f"{lp}.layer_norm2", b["ln_2"])
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.dense(f"{lp}.self_attn.{n}", b[n])
        sd.dense(f"{lp}.mlp.fc1", b["mlp_fc"])
        sd.dense(f"{lp}.mlp.fc2", b["mlp_proj"])


def _mlcd(p, cfg) -> _SD:
    """HF MLCDVisionModel names (convert_mlcd_vision): CLIP's without the
    position table, with `vision_model.class_pos_emb`."""
    sd, pre = _SD(), "vision_model"
    sd[f"{pre}.embeddings.class_embedding"] = _arr(p["class_embedding"])
    sd[f"{pre}.class_pos_emb"] = _arr(p["class_pos_emb"])
    sd.conv(f"{pre}.embeddings.patch_embedding", p["patch_embed"])
    sd.norm(f"{pre}.pre_layrnorm", p["ln_pre"])
    _clip_blocks(sd, pre, p, cfg.layers)
    return sd


def _openclip_vision(p, cfg) -> _SD:
    """open_clip VisionTransformer names (convert_openclip_vision): conv1,
    the fused in_proj of q, k, v."""
    sd = _SD()
    sd.conv("conv1", p["patch_embed"])
    sd["class_embedding"] = _arr(p["class_embedding"])
    sd["positional_embedding"] = _arr(p["positional_embedding"])
    sd.norm("ln_pre", p["ln_pre"])
    for i in range(cfg.layers):
        lp, b = f"transformer.resblocks.{i}", p[f"block_{i}"]
        qkv = [b[n] for n in ("q_proj", "k_proj", "v_proj")]
        sd[f"{lp}.attn.in_proj_weight"] = _arr(np.concatenate(
            [np.asarray(x["kernel"]).T for x in qkv]))
        sd[f"{lp}.attn.in_proj_bias"] = _arr(np.concatenate(
            [np.asarray(x["bias"]) for x in qkv]))
        sd.dense(f"{lp}.attn.out_proj", b["out_proj"])
        sd.norm(f"{lp}.ln_1", b["ln_1"])
        sd.norm(f"{lp}.ln_2", b["ln_2"])
        sd.dense(f"{lp}.mlp.c_fc", b["mlp_fc"])
        sd.dense(f"{lp}.mlp.c_proj", b["mlp_proj"])
    return sd


def _siglip(p, cfg) -> _SD:
    """HF SiglipVisionModel names (convert_hf_siglip_vision)."""
    sd, pre = _SD(), "vision_model"
    sd.conv(f"{pre}.embeddings.patch_embedding", p["patch_embed"])
    sd[f"{pre}.embeddings.position_embedding.weight"] = _arr(p["positional_embedding"])
    _clip_blocks(sd, pre, p, cfg.layers)
    return sd


def _eva(p, cfg) -> _SD:
    """The vendored EVA tree's names (convert_eva_vision), its last block
    absent as in the tower."""
    sd = _SD()
    sd["cls_token"] = _arr(np.asarray(p["cls_token"]).reshape(1, 1, -1))
    sd["pos_embed"] = _arr(np.asarray(p["pos_embed"])[None])
    sd.conv("patch_embed.proj", p["patch_embed"])
    for i in range(cfg.layers - 1):
        lp, b = f"blocks.{i}", p[f"block_{i}"]
        sd.norm(f"{lp}.norm1", b["norm1"])
        sd.norm(f"{lp}.norm2", b["norm2"])
        sd.dense(f"{lp}.attn.proj", b["proj"])
        if cfg.subln:
            for n in ("q_proj", "k_proj", "v_proj"):
                sd[f"{lp}.attn.{n}.weight"] = _arr(np.asarray(b[n]["kernel"]).T)
            if cfg.qkv_bias:
                sd[f"{lp}.attn.q_bias"] = _arr(b["q_proj"]["bias"])
                sd[f"{lp}.attn.v_bias"] = _arr(b["v_proj"]["bias"])
            sd.norm(f"{lp}.attn.inner_attn_ln", b["inner_attn_ln"])
        else:
            sd[f"{lp}.attn.qkv.weight"] = _arr(np.asarray(b["qkv"]["kernel"]).T)
            if cfg.qkv_bias:
                sd[f"{lp}.attn.q_bias"] = _arr(b["q_bias"])
                sd[f"{lp}.attn.v_bias"] = _arr(b["v_bias"])
        for n in (("w1", "w2", "w3") if cfg.naiveswiglu else ("fc1", "fc2")):
            sd.dense(f"{lp}.mlp.{n}", b[n])
        if cfg.subln:
            sd.norm(f"{lp}.mlp.ffn_ln", b["ffn_ln"])
        if cfg.ls_init_value is not None:
            sd[f"{lp}.gamma_1"] = _arr(b["gamma_1"])
            sd[f"{lp}.gamma_2"] = _arr(b["gamma_2"])
    return sd


def _t5(p, cfg) -> _SD:
    """HF T5EncoderModel names (convert_t5_encoder)."""
    sd = _SD()
    sd["shared.weight"] = _arr(p["shared"]["embedding"])
    sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = \
        _arr(p["relative_attention_bias"])
    sd["encoder.final_layer_norm.weight"] = _arr(p["ln_final"]["weight"])
    for i in range(cfg.layers):
        bp, b = f"encoder.block.{i}", p[f"block_{i}"]
        sd[f"{bp}.layer.0.layer_norm.weight"] = _arr(b["ln_attn"]["weight"])
        sd[f"{bp}.layer.1.layer_norm.weight"] = _arr(b["ln_ff"]["weight"])
        for n in ("q", "k", "v", "o"):
            sd.dense(f"{bp}.layer.0.SelfAttention.{n}", b[n])
        for n in ("wi_0", "wi_1", "wi", "wo"):
            if n in b:
                sd.dense(f"{bp}.layer.1.DenseReluDense.{n}", b[n])
    return sd


def _qformer(p, cfg) -> _SD:
    """The BLIP-2 Q-Former resampler's names (convert_qformer)."""
    sd = _SD()
    sd["query_tokens"] = _arr(np.asarray(p["query_tokens"])[None])
    sd.norm("ln_vision", p["ln_vision"])
    sd.norm("Qformer.bert.embeddings.LayerNorm", p["emb_ln"])
    for i in range(cfg.layers):
        lp, b = f"Qformer.bert.encoder.layer.{i}", p[f"layer_{i}"]
        for kind, attn in (("self", "attention"), ("cross", "crossattention")):
            if f"{kind}_query" not in b:
                continue
            for n in ("query", "key", "value"):
                sd.dense(f"{lp}.{attn}.self.{n}", b[f"{kind}_{n}"])
            sd.dense(f"{lp}.{attn}.output.dense", b[f"{kind}_out"])
            sd.norm(f"{lp}.{attn}.output.LayerNorm", b[f"{kind}_ln"])
        sd.dense(f"{lp}.intermediate_query.dense", b["ffn_fc"])
        sd.dense(f"{lp}.output_query.dense", b["ffn_out"])
        sd.norm(f"{lp}.output_query.LayerNorm", b["ffn_ln"])
    return sd


def _perceiver(p, cfg) -> _SD:
    """The Flamingo perceiver resampler's names (convert_perceiver)."""
    sd = _SD()
    sd["perceiver.latents"] = _arr(p["latents"])
    sd.norm("perceiver.norm", p["norm"])
    for i in range(cfg.depth):
        ap, a = f"perceiver.layers.{i}.0", p[f"attn_{i}"]
        sd.norm(f"{ap}.norm_media", a["norm_media"])
        sd.norm(f"{ap}.norm_latents", a["norm_latents"])
        for n in ("to_q", "to_kv", "to_out"):
            sd.dense(f"{ap}.{n}", a[n])
        if f"ff_{i}_norm" in p:
            fp = f"perceiver.layers.{i}.1"
            sd.norm(f"{fp}.0", p[f"ff_{i}_norm"])
            sd.dense(f"{fp}.1", p[f"ff_{i}_fc"])
            sd.dense(f"{fp}.3", p[f"ff_{i}_out"])
    return sd


_FROM_JAX = {"sr3": _sr3, "vae": _vae, "control": _control, "unet": _unet,
             "clip_l": _clip_l, "big_g": _big_g, "llama": _llama,
             "clip_vision": _clip_vision, "projector": _projector,
             "mpt": _mpt, "mlcd": _mlcd, "openclip_vision": _openclip_vision,
             "siglip": _siglip, "eva": _eva, "t5": _t5, "qformer": _qformer,
             "perceiver": _perceiver, "pooler_projector": _pooler_projector}


def params_from_jax(family: str, tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax tree of `family` (numpy leaves, with or
    without the top-level "params") -> the port's state dict (fp32 CPU)."""
    if family not in _FROM_JAX:
        raise ValueError(f"unknown family {family!r}, expected one of {FAMILIES}")
    p = tree.get("params", tree)
    return dict(_FROM_JAX[family](p, cfg))


def llava_from_jax(llama_tree, vision_tree, projector_tree, image_newline,
                   llama_cfg, vision_cfg) -> Dict[str, torch.Tensor]:
    """The JAX captioner's trees -> one state dict with the reference LLaVA
    checkpoint's names (what LlavaCaptioner.from_state_dict reads)."""
    sd = params_from_jax("llama", llama_tree, llama_cfg)
    for k, v in params_from_jax("clip_vision", vision_tree, vision_cfg).items():
        sd[f"model.vision_tower.vision_tower.{k}"] = v
    for k, v in params_from_jax("projector", projector_tree, None).items():
        sd[f"model.mm_projector.{k}"] = v
    sd["model.image_newline"] = _arr(image_newline)
    return sd


# ---------------------------------------------------------- random init
@torch.no_grad()
def seeded_init_(module: nn.Module, family: str, device: torch.device) -> nn.Module:
    """Seeded random init for a missing checkpoint, in place, on `device`,
    with the magnitudes of the JAX pipeline's smoke init: biases 0, norm
    weights (GroupNorm, LayerNorm, RMSNorm) 1, conv/linear weights
    N(0, 1/fan_in), embeddings N(0, 0.02^2).
    The seed is crc32 of the family name."""
    return init_params_(module, seeded_generator(family, device))


def seeded_generator(family: str, device: torch.device) -> torch.Generator:
    """seeded_init_'s generator for `family` (logs the smoke-mode warning)."""
    log.warning("checkpoint for %s not found: using seeded random init "
                "(smoke mode, outputs are not meaningful)", family)
    return torch.Generator(device=device).manual_seed(
        zlib.crc32(family.encode()) % (2 ** 31))


@torch.no_grad()
def init_params_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """seeded_init_'s rule with draws from `gen` (on the module's device):
    a fresh model to train."""
    for name, prm in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        if leaf == "bias" or prm.dim() == 0:
            prm.zero_()
        elif isinstance(owner, (GroupNorm32, nn.LayerNorm, RMSNorm)):
            # a (1 + w) RMSNorm (Gemma) starts at w = 0
            prm.fill_(0.0 if getattr(owner, "plus_one", False) else 1.0)
        elif (isinstance(owner, (nn.Conv2d, nn.Linear)) and leaf == "weight"
              or leaf == "in_proj_weight"):
            fan_in = prm[0].numel()
            prm.normal_(0.0, (1.0 / fan_in) ** 0.5, generator=gen)
        else:
            prm.normal_(0.0, 0.02, generator=gen)
    return module


# ---------------------------------------------------------- LoRA adapters
_ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj")


def lora_module_path(layer: int, proj: str) -> str:
    """The port's module path of decoder layer `layer`'s projection."""
    sub = "self_attn" if proj in _ATTN_PROJ else "mlp"
    return f"model.layers.{layer}.{sub}.{proj}"


def lora_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX adapter tree {"layer_i": {proj: {"a", "b"}}} -> the port's
    {"model.layers.i.<self_attn|mlp>.proj": {"a", "b"}} (fp32)."""
    out = {}
    for layer_key, projs in tree.items():
        layer = int(layer_key.split("_")[1])
        for proj, ab in projs.items():
            out[lora_module_path(layer, proj)] = {
                n: _arr(ab[n]).to(device) for n in ("a", "b")}
    return out


def lora_to_jax(lora: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    """Inverse of lora_from_jax, numpy fp32 leaves."""
    tree: Dict[str, Any] = {}
    for path, ab in lora.items():
        parts = path.split(".")  # model.layers.{i}.{sub}.{proj}
        tree.setdefault(f"layer_{int(parts[2])}", {})[parts[4]] = {
            n: ab[n].detach().float().cpu().numpy() for n in ("a", "b")}
    return tree
