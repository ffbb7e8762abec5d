#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rsvldm_tpu_torch).

    python3 chip_smoke.py            # every phase, one NVIDIA GPU (sm_90a)

Phases, each printed on its own line:
  1. device    the card's name and power limit (nvidia-smi), torch and CUDA
  2. build     K1 (csrc/flash_fwd.cu), the fused backward and its prologue
               (csrc/flash_bwd.cu) and K2 (csrc/int4_decode.cu) with nvcc
               for sm_90a, one nvcc per source, started together
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the main paths' shapes and a few edge cases (K2 also on
               rounding ties, zero rows, and one device kernel per call
               under torch.profiler); kernel, plain and library times (K1,
               the backward, K2 and their yardsticks by CUDA-graph replay:
               device time), the least time the card could take, and K2's
               sum per decode step; folder mode's shapes too: K1 at the
               batched prefill (B=8 S=1408 H=32 D=128 causal) and the
               batched refinement (B=8 S=4096 H=10, B=8 S=1024 H=20, D=64),
               K2 at 8 rows on the five decode shapes and its sum per
               decode step at 8 rows; and the speculative verify forward's:
               K2 at 5 rows (spec_k + 1) on the five shapes, its sum per
               verify step; the other families': K1 at Gemma-7B's caption
               prefill (causal, [1, 1280, 16, 256]) and MLCD-bigG-448's
               attention ([5, 1025, 16, 104], padded to 128 by the
               wrapper), each also at 1.1x its softmax scale, which must
               fail the limits; K1 at the Gemma-7B QLoRA step's
               forward ([4, 1536, 16, 256] causal, with lse; the same
               fault); D=256 at its tiles' edges and with zero
               rows, padded D=72; K2 at the int4 Gemma-7B and Qwen2-7B
               decode shapes and their sums per step (196 / 197 launches);
               the tensor-parallel caption's (phase parallel): K1 at one
               rank's heads at TP=4 ([1, 1280, 8, 128] causal; TP=2's is
               the Qwen2-MoE case), K2 at one rank's six shard shapes of
               the TP=2 decode step (q, k / v, gate / up, the lm_head's
               vocab shard; o and down with fp32 partials) and their sum;
               the D=256 backward (flash_bwd_d256_kernel): Gemma-7B's
               training shape ([4, 1536, 16, 256] causal) and
               [2, 1024, 8, 256], timed beside cuDNN's SDPA backward and
               each at 1.1x its softmax scale, which must fail the
               limits, the edges of its 64-key tiles, zero rows; D=192,
               padded to 256, forward and backward
  4. reference process() at a small width on the card (bf16, K1 in use)
               against the same run in fp32 on the CPU: same weights, same
               noise, PNGs within a stated uint8 tolerance; then a
               small-width caption, int4 and int8, card against CPU: same
               quantized weights and prompt, prefill + 8 decode steps
               teacher-forced with the CPU's tokens, logit cosine and top-1
               agreement per step (K1 and K2 in use), and the activation
               quantizers' codes and scales card against CPU, bit for bit;
               then the three training losses at a small width with
               128-wide heads and 1024 tokens, int8 and int4, card (bf16,
               remat: K1 and the backward) against CPU (fp32): the QLoRA
               loss and its adapter gradients, mm_loss with the projector
               inside the graph (adapter and projector gradients), and
               dpo_loss (its four sequence log-prob sums, each row's
               policy-minus-reference delta, the loss against the DPO
               formula on the card's own sums, planted faults that must
               fail, and the adapter gradients); loss and per-leaf
               gradient cosine; and the QLoRA loss of a small Gemma
               (GEMMA_SMALL: heads of 256, so the D=256 backward runs).
               In this phase too, the loops' step functions
               (utils/graphs.StepRunner) replayed as CUDA graphs against
               direct calls on the same inputs: SR3 and DDIM (8 steps),
               RestoreEDM on a 64^2 latent (a mixed run, all misses, all
               hits: the same DFB trace), the caption decode (40 tokens:
               the same ids and K2 launches); and the batched caption
               (three images of different shapes, ragged prompts, one
               batched prefill with the lm_head on each row's last
               position, 8 decode steps of all rows teacher-forced) card
               against CPU, per row; speculative decoding on the card
               (int4, a one-layer self-draft, k = 4, 40 greedy tokens): the
               ids of greedy `generate`, every round after the first
               replayed, K2 launches as the formula; and process() with
               the tiled VAE (three downsamples, 48-pixel encoder and
               10-latent decoder tiles, overlapping) card against CPU;
               then the serving engine at this width (serve_reference: int4,
               card bf16 with its CUDA graphs against the CPU engine in
               fp32): 6 requests on 4 slots in two waves (an image prompt,
               texts, two on a registered prefix) with the decode horizon,
               a chunked admission beside a decoding co-tenant, an int8 KV
               pool, speculative rounds with a one-layer self-draft: each of
               the first 16 greedy ids the best of the CPU teacher-forced on
               the card's ids (up to a near-tie), first-token
               logit cosines, K1 / K2 launches as the admissions and steps
               imply; a sampled request alone and among co-tenants in
               another slot, the same ids; then the tiled sgm samplers
               (samplers_reference: tiled RestoreEDM with restore_cfg and
               tiled RestoreDPMPP2M, 3 steps each on a 96^2 latent in 2 x 2
               windows of 64, over the controlled denoiser with CFG, the
               CPU's weights rounded to bf16, conditioning, noise and
               Brownian draws on both): the card in fp32 (plain attention)
               within SAMPLER_FP32_TOL of the CPU's latents; K1 against the
               plain attention in bf16 (SAMPLER_K1_TOL) and in the fp32
               modules on bf16-rounded q, k, v (SAMPLER_K1_FP32_TOL, which a
               planted 10% softmax-scale fault must exceed); K1 launches
               equal to the calls times one call's; the single-window tiled
               DPM++(2M) within SINGLE_TILE_FP32_TOL of the untiled in fp32;
               then the other families at a small width (families_reference,
               bf16-rounded weights on both sides): Qwen2 and Gemma on int4
               bases, Mistral with a 512 window, Mixtral, Qwen2-MoE and
               MPT, a 1100-token prefill and 8 decode steps fed the CPU's
               greedy tokens (logit cosine >= FAM_COS_MIN; K1 once a layer
               except Mistral and MPT, K2 7 a layer and step); MLCD at 448
               pixels (heads of 104: K1 padded), open_clip indexing, EVA02,
               EVA01, SigLIP, T5, the Q-Former, the perceiver and the
               pooler projector (features within TOWER_REL_TOL)
  5. path      the full-width modules (SR3 64-ch; SDXL XL-base + GLVControl,
               the SDXL VAE with its twin encoder, CLIP-L, bigG; LLaVA-NeXT-8B:
               CLIP-L/336 + mlp2x_gelu + Llama-3-8B, dense) with seeded bf16
               weights, written as the reference checkpoint directory (SR3's
               .pth, the juggernaut safetensors, SR-v0Q.ckpt, four LLaVA
               safetensors shards with a Llama-3-style tokenizer.json, a
               Llava-next PEFT adapter, clip_vocab) in a temporary directory
               with room for it; the pipeline built from that directory
               alone by the CLI's construction (infer.build_pipeline,
               --quant int4), every family's weights checked against the
               written bytes and the adapted projections against the fp32
               merge, the prompt's token ids against the assets' own; then
               SuperResolutionPipeline.process() (256 new tokens sampled at
               T=0.2, a seeded 28x28 input: 224^2 Stage 1, 1024^2 (128^2
               latent) Stage 2b) with every loop replaying CUDA graphs
               (each graph's capture seconds, peak memory); graph replay
               against direct calls at full width (16 decode steps, 10 SR3
               steps, denoiser miss steps and hit steps); Stage 1 as DDIM
               in 50 steps, timed; the kernel launches of one decode step
               without and with a train_vlm LoRA archive attached; write,
               load (per family, the LLaVA's split into read, PEFT merge and
               quantize) and read-rate figures;
     spec      on the path's int4 captioner and Stage-1 image: the
               256-token caption at T=0.2 vanilla, with the self-draft of
               4 layers (k = 4) and with a seeded 2-layer draft checkpoint
               (hidden 4096, vocab 128256) written to <dir>/llava_draft and
               read through infer.build_pipeline --draft_dir: seconds,
               decode tok/s, rounds, accept_rate, ms a round by graph
               replay, capture seconds, K2 launches a round (must be
               k (7n + 1) + 7n + 225 for a draft of n layers, every round
               after the first replayed); then the same greedy: the prefix
               on which speculative and vanilla ids agree, and the target's
               top-2 logit gap where they part (reported)
     tiled     on the path's pipeline: the 1024^2 refinement with and
               without use_tile_vae (512 / 64 tiles: 4 encoder tiles of
               576^2, 4 decoder tiles of 86^2 latent): vae_prep and decode
               seconds, peak memory, the VAE alone each way, the uint8
               difference between the images (reported); the tiled VAE
               alone at 2048^2 (16 tiles each), and the reckoned bytes of
               the whole VAE's 65536^2 mid-attention scores there;
               the directory is deleted after phase folder;
               then the train_vlm loop at full width on one seeded
               captioner (int8 decoder, built once): LoRA r=16 on the
               seven projections, AdamW, gradient checkpointing, 16 anyres
               224^2 records, 4 steps of batch 4 padded to 1536 tokens
               (train); video records of 8 frames from frame folders
               (train_video); DPO on preference pairs padded to 1024
               (train_dpo: K1 192, backward 64 a step); the projector
               alone, then with the adapters at --mm_projector_lr 2e-5, on
               pad-recipe image records padded to 1024 (train_mm_*); each
               step's K1 / backward launches as the recipe implies, the
               base's bytes unchanged, the projector moved exactly when it
               trains; then train_gemma: 3 QLoRA steps of the full-width,
               full-depth Gemma-7B decoder (int8, seeded, LoRA r=16 on the
               seven projections, remat) through VLMTrainer on 4 x 1536
               text records: K1 56 and the D=256 backward 28 a step,
               step seconds, tokens/s, peak; then train_sr3: SR3 training (the path's UNet, batch
               8 at 224^2, fp32) through the CLI's construction, saved and
               resumed, the resumed step equal to the uninterrupted one.
               Each path's kernel launch counts are reset just before it
               and read just after.
     folder    (before the directory is deleted, and after the path's
               pipeline is freed) folder mode as a user runs it: the
               processor built by infer_dir.build_processor (--quant int4)
               from that directory, ImageBatchProcessor.run() over 8 seeded
               LR tiles (seven 28^2, one 32^2: Stage-1 groups of 7 and 1;
               one batched int4 caption of 8, 256 tokens at T=0.2; two
               batched 1024^2 refinements of 4, the second replaying the
               kept graphs of the first): every status ok, no fallback, 16
               PNGs, K1 / K2 launches as the batches ran (reported under
               `folder`), seconds per stage and per image, prefill and
               decode rates, DFB hits and capture seconds per chunk, peak
               memory with the loops kept; then graph replay against direct
               calls at this width (16 decode steps at B=8: ids and K2
               launches; 10 SR3 steps at batch 7)
     serve     (after folder, before the directory is deleted) the LLM
               worker as a user launches it: serving.llm_worker.main on
               that directory (--load-4bit --slots 8 --max-len 4096), 16
               concurrent HTTP requests (4 with a base64 224^2 tile, 12
               texts of 40-900 tokens, one streamed): wall seconds, tokens,
               tok/s, time to first token, the replayed 8-slot decode step
               (device time, the cache casts' and K2's shares), K1 = 32 an
               admission padded to >= 1024, K2 = 225 a step + 1 an
               admission; then on the same captioner one engine each for
               --prefix-file, --prefill-chunk 512, --decode-horizon 8,
               --kv-8bit and --self-draft 4 --spec-k 4 (4 slots), each
               with its launches against the reckoning
     samplers  (after tiled, on the path's pipeline) the sgm sampler family
               over the controlled XL-base denoiser with CFG and the path
               tile's conditioning: EDM (churn), Heun, Euler-ancestral,
               DPM++(2S)-ancestral, DPM++(2M), linear multistep, the substep
               sigmas and RestoreDPMPP2M (Brownian tree of counter-hash
               draws), 10 steps on the 128^2 latent; both tiled samplers 20
               steps on a 192^2 latent (4 windows of 128 at stride 64, one
               denoiser call a step): denoiser calls and K1 launches (106 a
               call) as the sigma table implies, seconds a step, finite,
               peak; the single-window tiled DPM++(2M) against the untiled
               (SINGLE_TILE_TOL), beside the untiled run from noise one
               fp32 ulp away (reported)
     families  (after train_sr3) the other decoder families at their
               published widths, seeded bf16 weights, one at a time: Gemma-7B
               and Qwen2-7B int4 captions of one 224^2 tile through
               LlavaCaptioner.seeded(..., device="cuda") (64 tokens; K1 28
               in the prefill, K2 196 / 197 a step + Qwen2's prefill
               lm_head), Qwen2-MoE-A2.7B, Mistral-7B (window cut to 512 for
               this run), Mixtral-8x7B at MIXTRAL_LAYERS = 8 of its 32
               layers (93 GB in bf16 whole) and MPT-7B: a 1200-token prefill
               (padded to 1280) and 32 greedy decode steps; prefill ms,
               decode tok/s, peak GiB, K1 / K2 launches against the
               reckoning
     towers    every build_vision_tower family at its published size, one
               batch of 5 each (CLIP-L-336, SigLIP-so400m-384, EVA02-L-336,
               EVA01-g-14, open_clip ViT-H-14-378, MLCD-bigG-336 and -448:
               K1 47 launches padded to 128), S2 (336, 672), T5-XXL on 77
               tokens, a Q-Former, a perceiver and a pooler projector: ms,
               feature shape, K1 against the reckoning
     eval      (after folder) the quality harness over folder's 8 outputs:
               seeded full-width CLIP ViT-L/14 (HF CLIPModel names) and
               LPIPS-VGG assets, HR images from data.prepare_triplets,
               `python -m rsvldm_tpu_torch.eval_dir` on the card (JAX's
               JSON keys), the tower's and LPIPS's ms an image, peak; the
               same CLI with --device cpu on two images, card within
               EVAL_TOL of CPU per image and metric; TF32 on must move a
               metric beyond EVAL_TOL
     parallel  (last) the parallel layer: this process runs the int4
               Llama-3-8B caption of one 224^2 tile (1280-token prefill, 64
               greedy tokens), folder Stage 1 of four 28^2 tiles (500
               steps), the tiled VAE at 2048^2 (bf16 and widened to fp32)
               and 4 SR3 training steps at global batch 8 without a mesh,
               then the same caption with its decoder sharded over a world
               of one on NCCL (the ids must be the same); two ranks of this
               script (--parallel-worker) on the same card over gloo run
               the caption at TP=2 (each rank building its shard; logits
               teacher-forced on the unsharded ids, cosine >=
               PAR_COS_MIN; K1 / K2 as reckoned), Stage 1 at data=2, the
               tiled VAE at tile=2 and DP SR3 training, each against the
               unsharded run (limits at PAR_*), Stage 1 also against its
               one-process witness at the ranks' batch of 2 (bit for bit),
               the TP=2 caption again with a seeded LoRA archive (32
               tokens, against one process with it) and 3 VLMTrainer
               steps at data=2 on the int8 Llama-3-8B (2 x 1536 tokens a
               rank, against one process on all 4 rows); prefill ms,
               tok/s, peak GiB per rank. --parallel-only runs the build and this
               phase alone; --parallel-ranks 4 --parallel-backend nccl one
               NCCL rank a card on a 4-card machine
  6. profile   (--profile) one int4 decode step, one SR3 step, one
               cache-miss and one cache-hit denoising step, each replayed
               from a CUDA graph, a decode step at 8 rows (folder), and the
               last training step, under torch.profiler: device time by
               kernel, the bf16 -> fp32 copies' share, idle share
Before the kernel report, a `timing` line gives each phase's seconds.
The line before the last is the kernel report as one JSON object; the last
line is {"ok": true, "device": {...}}, printed only when every phase passed.
Exits non-zero, with no result, when there is no CUDA card or the port's
package is not beside this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak, H100 SXM data sheet

REPO = Path(__file__).resolve().parent
SEED = 0  # weights, input image and noise are all made from it
# bf16 on the card against fp32 on the CPU, through 8 SR3 and 4 EDM steps
# of random-weight networks: an H100 gave 0.62 mean / 3 max uint8 levels on
# the final PNG (0.08 / 1 after Stage 1); the limits leave 2.4x / 4x margin
REF_MEAN_TOL, REF_MAX_TOL = 1.5, 12
# K1 against its plain version, both in bf16 on the card. Per element
# |err| <= ATOL + RTOL*|ref|, and over the whole output
# rms(err) <= RMS_TOL*rms(ref). At sdxl_s4096 the outputs are small (rms about
# 0.026), so ATOL is a few bf16 ulps of the largest of them; a kernel that
# skipped one of the 64 K/V tiles there would be off by about 0.1*rms(ref).
K1_ATOL, K1_RTOL, K1_RMS_TOL = 4e-3, 2e-2, 1e-2
K1_LSE_TOL = 1e-4  # lse is fp32 on both sides
# The backward (bf16 inputs, p and ds rounded to bf16 before their
# products, fp32 sums; dq summed by reduce-adds in a changing order) against
# its plain version in fp32 on the same inputs, per gradient: per element
# |err| <= K34_ATOL*rms(ref) + K34_RTOL*|ref|, and rms(err) <=
# K34_RMS_TOL*rms(ref). An H100 gave rms(err)/rms(ref) 0.0023-0.0024 for
# dq, dk and dv at every shape with the two-kernel version (K3, K4), and
# per element at most 0.57 of the limit; RMS_TOL leaves 2.5x margin.
K34_ATOL, K34_RTOL, K34_RMS_TOL = 0.1, 0.05, 0.006
# K1 sites per denoising step of the full-width XL-base UNet + GLVControl:
# 34 in GLVControl, 24 in the UNet input blocks, 48 in `rest`. A cache hit
# runs GLVControl and the input blocks only. The Llama-3-8B prefill (about
# 1280 tokens) adds one per layer.
K1_PER_MISS, K1_PER_HIT, K1_PER_CAPTION = 106, 58, 32
# K2's decode-step shapes (R = 1: name, in, out) and launches a step: q, o;
# k, v; gate, up; down in each of 32 layers; the lm_head once (225 in all)
K2_STEP = (("q_o_proj", 4096, 4096, 64), ("k_v_proj", 4096, 1024, 64),
           ("gate_up_proj", 4096, 14336, 64), ("down_proj", 14336, 4096, 32),
           ("lm_head", 4096, 128256, 1))
K2_PER_STEP = sum(n for *_, n in K2_STEP)
# K2's shapes on one rank of the Llama-3-8B decode step at TP=2 (phase
# parallel): column-parallel q (4096 -> 2048), k / v (-> 512), gate / up
# (-> 7168) and the vocab shard of the lm_head (-> 64128); row-parallel o
# (2048 -> 4096) and down (7168 -> 4096) write fp32 partials (summed over
# the ranks in fp32): still 225 launches a step
K2_TP2_STEP = (("tp2_q_proj", 4096, 2048, 32), ("tp2_k_v_proj", 4096, 512, 64),
               ("tp2_gate_up_proj", 4096, 7168, 64),
               ("tp2_lm_head", 4096, 64128, 1),
               ("tp2_o_proj_f32", 2048, 4096, 32),
               ("tp2_down_proj_f32", 7168, 4096, 32))
# the int4 decode steps of the other families (phase families): Gemma-7B's
# 28 layers (q, k, v 3072 -> 16 x 256; o; gate, up; down; the tied head is
# the bf16 embedding, no K2: 196 launches) and Qwen2-7B's (28 layers, 4 KV
# heads of 128, its own lm_head: 197)
K2_FAMILY_STEP = {
    "gemma": (("gemma_q_k_v_proj", 3072, 4096, 84),
              ("gemma_o_proj", 4096, 3072, 28),
              ("gemma_gate_up_proj", 3072, 24576, 56),
              ("gemma_down_proj", 24576, 3072, 28)),
    "qwen2": (("qwen2_q_o_proj", 3584, 3584, 56),
              ("qwen2_k_v_proj", 3584, 512, 56),
              ("qwen2_gate_up_proj", 3584, 18944, 56),
              ("qwen2_down_proj", 18944, 3584, 28),
              ("qwen2_lm_head", 3584, 152064, 1))}
# speculative caption decoding (phase spec): proposals a round, the
# self-draft's depth, the draft checkpoint's depth; K2 launches a round
# with a draft of n int4 layers: k draft steps (7n projections and the
# lm_head each), the catch-up feed (7n, no lm_head), the verify forward
# (225 at k + 1 rows)
SPEC_K, SELF_DRAFT_LAYERS, DRAFT_LAYERS = 4, 4, 2


def k2_per_round(n: int, k: int = SPEC_K, layers: int = 32) -> int:
    return k * (7 * n + 1) + 7 * n + 7 * layers + 1
# K2 against its plain version, both fp32 sums of exact int32 group sums
# that differ only in order: per element |err| <= K2_RTOL * sum_g |term_g|
# + K2_ATOL, where term_g = xs*ws*acc of group g (the fp32 rounding bound of
# up to 112 terms summed in two orders is about 1.3e-5 of that sum). An
# H100 gave |err| <= 1.6e-6, at most 0.03 of this limit, at the decode
# shapes; a K2 that drops one contraction split exceeds it 11000-93000
# times, one that rounds half away from zero 850 times on the ties case.
K2_RTOL, K2_ATOL = 1e-5, 1e-6
# Caption reference, bf16 on the card against fp32 on the CPU, teacher-
# forced: per step, the cosine of the two logit vectors and whether their
# argmaxes agree. With the same quantized bytes on both sides an H100 gave
# cosines 0.99974-0.99981 (int4) and 0.99965-0.99971 (int8), argmaxes equal
# at 9/9 and 7/9 positions (random weights leave near-ties among 128256
# logits); a K2 that drops one contraction split gives 0.35. The limits
# leave about 6x margin on 1 - cos and allow four flips in nine.
CAP_COS_MIN, CAP_TOP1_MIN = 0.998, 0.5
# Train reference, bf16 on the card (remat, K1 and the backward) against
# fp32 on the CPU: the loss's relative error and the cosine of each adapter
# leaf's gradient. An H100 gave 1.4e-4 / 1.0e-4 (int8 / int4) and a smallest
# cosine of 0.99925 / 0.99938 over the 28 leaves; the limits leave about
# 14x and 6x margin (on 1 - cos).
TRAIN_LOSS_RTOL, TRAIN_COS_MIN = 2e-3, 0.995
# DPO's loss is -log sigmoid(beta * margin), the margin per pair
# (pi_c - ref_c) - (pi_r - ref_r): four sums of 512 token log-probabilities
# (about -3800 each). bf16 moves each sum by about 2e-4 of it (0.3-0.9
# nats), and the policy's and the reference's moves do not cancel, so the
# loss itself is not held against the fp32 one (an H100 gave 1.9e-2 /
# 6.7e-2 relative, int8 / int4). Held instead, on the quantities the loss
# is made of: each sum to TRAIN_LOSS_RTOL relative; each row's
# policy-minus-reference delta against the CPU's to DPO_DELTA_ATOL nats (an
# H100 gave at most 0.45 / 1.66); and the card's dpo_loss against the DPO
# formula on the card's own sums to DPO_LOSS_SELF_ATOL (1.3e-8 / 8.4e-9:
# the graph and no-graph forwards agree). Planted faults (the reference
# run with the adapters on, or with its chosen and rejected rows swapped)
# must fail these checks; the first moves a row's delta by 3.1-3.5 nats.
DPO_DELTA_ATOL, DPO_LOSS_SELF_ATOL = 2.5, 1e-5
DPO_BETA = 0.1
# Graph replay against direct calls of the same step functions on the card
# (utils/graphs.StepRunner): the same kernels on the same inputs, so the
# latents are expected bit-equal; the limit, max |graph - direct| <=
# GRAPH_TOL * max(1, max |direct|), leaves room only for a library picking
# another algorithm under capture. Caption ids and DFB traces must be equal.
GRAPH_TOL = 1e-3
LLAMA3_SPECIAL = {"<|begin_of_text|>": 128000, "<|start_header_id|>": 128006,
                  "<|end_header_id|>": 128007, "<|eot_id|>": 128009}


class StandInTokenizer:
    """Llama-3 special-token strings to their ids, every other
    whitespace-separated word to a crc32 bucket below them, so a prompt has
    about its BPE length. decode writes bucket ids as words."""

    _split = re.compile("(" + "|".join(map(re.escape, LLAMA3_SPECIAL)) + ")")

    def encode(self, text, add_special_tokens=False):
        ids = []
        for part in self._split.split(text):
            if part in LLAMA3_SPECIAL:
                ids.append(LLAMA3_SPECIAL[part])
            else:
                ids += [zlib.crc32(w.encode()) % 128000 for w in part.split()]
        return ids

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids if i < 128000)


# ------------------------------------------------- the checkpoint directory
# The tokenizer assets and the safetensors writer below make the reference
# checkpoint layout that phase `path` reads; the tests use the same helpers
# with the `tokenizers` and `transformers` packages as oracles.

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# the same split in the stdlib `re` for text without "_" and without letters
# or digits outside \w (the texts the assets are learnt from)
_HELPER_SPLIT = re.compile(r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\w]?[^\W\d_]+|"
                           r"\d{1,3}| ?[^\s\w]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
_CLIP_SPLIT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|"
                         r"'ll|'d|[^\W\d_]+|\d|[^\s\w]+", re.IGNORECASE)


def _byte_chars():
    """GPT-2's byte -> printable char map."""
    bs = (list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _learn_bpe(words: dict, n_merges: int):
    """Byte-pair merges learnt from {symbol tuple: count}: the most frequent
    adjacent pair first (ties: the smallest pair), never a pair whose join is
    already a token. Returns (merges, {word: its final symbols})."""
    import heapq
    seqs = [list(w) for w in words]
    freq = list(words.values())
    count, where = {}, {}
    for i, sq in enumerate(seqs):
        for p in zip(sq, sq[1:]):
            count[p] = count.get(p, 0) + freq[i]
            where.setdefault(p, set()).add(i)
    tokens = {c for sq in seqs for c in sq}
    heap = [(-c, p) for p, c in count.items()]
    heapq.heapify(heap)
    merges = []
    while heap and len(merges) < n_merges:
        c, p = heapq.heappop(heap)
        if count.get(p, 0) != -c or c == 0:
            continue
        joined = p[0] + p[1]
        if joined in tokens:
            count[p] = 0
            continue
        merges.append(p)
        tokens.add(joined)
        changed = set()
        for i in where.pop(p, ()):
            sq = seqs[i]
            for q in zip(sq, sq[1:]):
                count[q] -= freq[i]
                changed.add(q)
            out, j = [], 0
            while j < len(sq):
                if j + 1 < len(sq) and (sq[j], sq[j + 1]) == p:
                    out.append(joined)
                    j += 2
                else:
                    out.append(sq[j])
                    j += 1
            seqs[i] = out
            for q in zip(out, out[1:]):
                count[q] = count.get(q, 0) + freq[i]
                where.setdefault(q, set()).add(i)
                changed.add(q)
        for q in changed:
            if count[q] > 0:
                heapq.heappush(heap, (-count[q], q))
    return merges, {w: tuple(sq) for w, sq in zip(words, seqs)}


def _seeded_words(seed: int, n: int):
    """n seeded lower-case words, letters drawn by English frequency."""
    import random
    rnd = random.Random(seed)
    letters = "etaoinshrdlcumwfgypbvkjxqz"
    weights = [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8,
               2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15,
               0.1, 0.07]
    return ["".join(rnd.choices(letters, weights, k=rnd.randint(2, 9)))
            for _ in range(n)]


class Llama3Assets:
    """A Llama-3-style tokenizer.json (tokenizers' format): the Split
    pre-tokenizer with Llama-3's pattern, ByteLevel, a BPE of the 256 byte
    tokens and merges learnt from a seeded word list and `texts`, with
    ignore_merges, filler tokens up to `special_start`, `n_special` special
    tokens from there (<|begin_of_text|>, <|start_header_id|>,
    <|end_header_id|> and <|eot_id|> at Llama-3's offsets 0, 6, 7, 9), and
    the BOS template. `encode` is the assets' own encoding of the texts
    they were learnt from (the whole piece when it is a token, else its
    learnt segmentation); it refuses other text."""

    NAMED = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
             6: "<|start_header_id|>", 7: "<|end_header_id|>", 9: "<|eot_id|>"}

    def __init__(self, texts, n_merges: int = 3000, seed: int = SEED,
                 special_start: int = 128000, n_special: int = 256):
        bc = _byte_chars()
        self.specials, k = {}, 0
        for i in range(n_special):
            name = self.NAMED.get(i)
            if name is None:
                name, k = f"<|reserved_special_token_{k}|>", k + 1
            self.specials[name] = special_start + i
        self._special_re = re.compile("|".join(map(re.escape, self.specials)))
        corpus = " ".join(_seeded_words(seed, 4000))
        words: dict = {}
        for text in [corpus, *texts]:
            for chunk in self._special_re.split(text):
                for piece in _HELPER_SPLIT.findall(chunk):
                    w = tuple(bc[b] for b in piece.encode())
                    words[w] = words.get(w, 0) + 1
        merges, self._learnt = _learn_bpe(words, n_merges)
        vocab = {bc[b]: i for i, b in enumerate(sorted(bc))}
        for a, b in merges:
            vocab[a + b] = len(vocab)
        if len(vocab) > special_start:
            raise ValueError(f"{len(vocab)} tokens do not fit below {special_start}")
        i = 0
        while len(vocab) < special_start:  # never a whole piece: " w" + digits
            vocab[f"Ġw{i}"] = len(vocab)
            i += 1
        self.vocab, self.merges = vocab, merges
        self._bc = bc
        bos = self.NAMED[0]
        self.spec = {
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": t, "single_word": False,
                              "lstrip": False, "rstrip": False,
                              "normalized": False, "special": True}
                             for t, i in self.specials.items()],
            "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
                 "behavior": "Isolated", "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False,
                 "trim_offsets": True, "use_regex": False}]},
            "post_processor": {"type": "Sequence", "processors": [
                {"type": "ByteLevel", "add_prefix_space": True,
                 "trim_offsets": False, "use_regex": True},
                {"type": "TemplateProcessing",
                 "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                            {"Sequence": {"id": "A", "type_id": 0}}],
                 "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                          {"Sequence": {"id": "A", "type_id": 0}},
                          {"SpecialToken": {"id": bos, "type_id": 1}},
                          {"Sequence": {"id": "B", "type_id": 1}}],
                 "special_tokens": {bos: {"id": bos, "ids": [self.specials[bos]],
                                          "tokens": [bos]}}}]},
            "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                        "trim_offsets": True, "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": True,
                      "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]}}

    def write(self, d: Path):
        d.mkdir(parents=True, exist_ok=True)
        (d / "tokenizer.json").write_text(json.dumps(self.spec, ensure_ascii=False))
        (d / "tokenizer_config.json").write_text(json.dumps({
            "tokenizer_class": "PreTrainedTokenizerFast",
            "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
            "clean_up_tokenization_spaces": True,
            "model_max_length": 1000000}))

    def encode(self, text: str):
        ids, pos = [], 0
        for m in [*self._special_re.finditer(text), None]:
            chunk = text[pos:m.start() if m else len(text)]
            for piece in _HELPER_SPLIT.findall(chunk):
                w = tuple(self._bc[b] for b in piece.encode())
                if "".join(w) in self.vocab:
                    ids.append(self.vocab["".join(w)])
                else:
                    ids += [self.vocab[t] for t in self._learnt[w]]
            if m:
                ids.append(self.specials[m.group()])
                pos = m.end()
        return ids


class ClipAssets:
    """CLIP BPE assets in HF's format (vocab.json, merges.txt): the 256 byte
    tokens and their word-final forms, merges learnt from a seeded word
    list and `texts` (lower-cased, split as CLIP splits), and
    <|startoftext|> / <|endoftext|> at `sot` / `sot + 1`. `encode` is the
    assets' own encoding of the texts they were learnt from."""

    def __init__(self, texts, n_merges: int = 3000, seed: int = SEED,
                 sot: int = 49406):
        bc = _byte_chars()
        words: dict = {}
        for text in [" ".join(_seeded_words(seed + 1, 4000)), *texts]:
            for w in self._words(text, bc):
                words[w] = words.get(w, 0) + 1
        base = [bc[b] for b in sorted(bc)]
        vocab = {t: i for i, t in enumerate(base + [t + "</w>" for t in base])}
        merges, self._learnt = _learn_bpe(words, min(n_merges, sot - len(vocab)))
        for a, b in merges:
            vocab[a + b] = len(vocab)
        vocab["<|startoftext|>"], vocab["<|endoftext|>"] = sot, sot + 1
        self.vocab, self.merges, self._bc = vocab, merges, bc

    @staticmethod
    def _words(text, bc):
        text = re.sub(r"\s+", " ", text).strip().lower()
        for piece in _CLIP_SPLIT.findall(text):
            w = [bc[b] for b in piece.encode()]
            yield tuple(w[:-1]) + (w[-1] + "</w>",)

    def write(self, d: Path):
        d.mkdir(parents=True, exist_ok=True)
        (d / "vocab.json").write_text(json.dumps(self.vocab, ensure_ascii=False))
        (d / "merges.txt").write_text(
            "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in self.merges))

    def encode(self, text: str):
        """[SOT] + the text's ids + [EOT]."""
        ids = [self.vocab[t] for w in self._words(text, self._bc)
               for t in self._learnt[w]]
        return [self.vocab["<|startoftext|>"], *ids, self.vocab["<|endoftext|>"]]


SAFETENSORS_DTYPES = {"float64": "F64", "float32": "F32", "float16": "F16",
                      "bfloat16": "BF16", "int64": "I64", "int32": "I32",
                      "int16": "I16", "int8": "I8", "uint8": "U8", "bool": "BOOL"}


def write_safetensors(path: Path, tensors, metadata=None) -> int:
    """Writes {name: tensor} (on any device) in the safetensors format, one
    tensor at a time through the host; returns the bytes written."""
    import torch
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(t.dtype).split(".")[1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = metadata
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().cpu().contiguous().reshape(-1)
                        .view(torch.uint8).numpy().tobytes())
    return 8 + len(head) + offset


def _say(phase: str, **kw):
    print(f"[{phase}] " + json.dumps(kw, sort_keys=True), flush=True)


def _graph_ms(fn, iters: int = 20, stream=None) -> float:
    """Device time of one call of `fn`: `iters` calls captured in a CUDA
    graph (on `stream`, when given) and replayed, so host-side launch costs
    drop out."""
    import torch
    with torch.cuda.stream(stream):  # a None stream leaves the current one
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 1
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(line, flush=True)
    _say("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)))
    return line


# --------------------------------------------------------------- phase 2
def phase_build():
    from rsvldm_tpu_torch.ops import flash_attention, quant
    from rsvldm_tpu_torch.utils import cuda_build

    def build(source):
        t0 = time.perf_counter()
        log = cuda_build.build(source)
        return source, log, time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = (flash_attention.SOURCE, flash_attention.BWD_SOURCE,
               flash_attention.WIDE_SOURCE, quant.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        done = list(pool.map(build, sources))
    for source, log, seconds in done:
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        PTXAS[source] = _ptxas_by_kernel(log)
        # C7515: ptxas serialised a kernel's wgmma instructions
        serialised = [ln.strip() for ln in log.splitlines() if "C7515" in ln]
        _say("build", source=source, ptxas=ptxas,
             by_kernel=PTXAS[source], serialised_wgmma=serialised,
             seconds=round(seconds, 3))
    _say("build", all_seconds=round(time.perf_counter() - t0, 3))


# ptxas's report of each kernel, by source, from phase_build (for the
# kernel report's records)
PTXAS: dict = {}


def _unmangled(name: str) -> str:
    """The innermost name of an Itanium-mangled function name (the length-
    prefixed parts after _Z / _ZN), e.g. flash_wide_fwd_kernel."""
    if not name.startswith("_Z"):
        return name
    i, parts = 3 if name.startswith("_ZN") else 2, []
    while i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        parts.append(name[j:j + int(name[i:j])])
        i = j + int(name[i:j])
    return parts[-1] if parts else name


def _ptxas_by_kernel(log: str) -> dict:
    """{kernel name: {registers, spill_stores, spill_loads}} from the
    `-Xptxas -v` lines of one build (mangled names shortened to the
    `..._kernel` they hold)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = _unmangled(m.group(1))
            if name in out:  # a template's instantiations share a name
                name = f"{name}#{sum(k.split('#')[0] == name for k in out)}"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


# --------------------------------------------------------------- phase 3
def _valid_pairs(sq, sk, kv_len, causal):
    if not causal:
        return sq * kv_len
    off = kv_len - sq
    return sum(min(max(r + off + 1, 0), kv_len) for r in range(sq))


def _flash_case(name, b, sq, sk, h, d, *, causal=False, kv_len=None,
                lse=False, timed=False, main_path=False, scale_fault=False):
    import torch
    import torch.nn.functional as F
    from rsvldm_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(
        sum(map(ord, name)) + sq * 7 + sk)
    mk = lambda s: torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
    q, k, v = mk(sq), mk(sk), mk(sk)
    kvl = sk if kv_len is None else kv_len
    kw = dict(causal=causal, kv_len=kvl, return_lse=lse)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, **kw)
    o, r = (out[0].float(), ref[0].float()) if lse else (out.float(),
                                                          ref.float())
    err = (o - r).abs()
    tol = K1_ATOL + K1_RTOL * r.abs()
    rms = lambda x: float(x.square().mean().sqrt())
    rel_rms = rms(err) / max(rms(r), 1e-30)
    ok = (bool((err <= tol).all()) and rel_rms <= K1_RMS_TOL
          and bool(torch.isfinite(o).all()))
    rec = dict(case=name, shape=[b, sq, sk, h, d], causal=causal,
               kv_len=kvl, max_abs_err=float(err.max()),
               max_err_over_tol=float((err / tol).max()),
               rms_ref=rms(r), mean_abs_ref=float(r.abs().mean()),
               rel_rms_err=rel_rms,
               tol=f"|err| <= {K1_ATOL} + {K1_RTOL}*|ref|, "
                   f"rms(err) <= {K1_RMS_TOL}*rms(ref)")
    if lse:
        lse_err = float((out[1] - ref[1]).abs().max())
        rec["lse_max_abs_err"] = lse_err
        ok = ok and lse_err <= K1_LSE_TOL
    if causal and sq > kvl:
        rec["zero_rows_exact"] = bool((o[:, :sq - kvl] == 0).all())
        ok = ok and rec["zero_rows_exact"]
    if scale_fault:
        # a planted fault: K1 at 1.1x the softmax scale must fail the limits
        n_launch = flash_attention.launches
        bad = flash_attention(q, k, v, causal=causal, kv_len=kvl,
                              scale=1.1 / math.sqrt(d))
        flash_attention.launches = n_launch
        e = (bad.float() - r).abs()
        rec["fault_rel_rms_err"] = rms(e) / max(rms(r), 1e-30)
        rec["fault_rejected"] = not (bool((e <= tol).all())
                                     and rec["fault_rel_rms_err"] <= K1_RMS_TOL)
        ok = ok and rec["fault_rejected"]
    pairs = _valid_pairs(sq, sk, kvl, causal)
    flops = 4.0 * b * h * d * pairs
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * h * d)
    if lse:
        nbytes += 4 * b * h * sq
    rec["bound_ms"] = max(flops / H100_BF16_FLOPS,
                          nbytes / H100_HBM_BYTES) * 1e3
    rec["bound_by"] = ("operations" if flops / H100_BF16_FLOPS
                       >= nbytes / H100_HBM_BYTES else "bytes")
    if timed:
        # device time by graph replay, without the wrapper's host cost
        # (checks, allocation, stream lookup); the wrapper with it by events
        n_launch = flash_attention.launches
        call = lambda: flash_attention(q, k, v, **kw)
        rec["ms"] = _graph_ms(call)
        rec["wrapper_ms"] = _time_ms(call, 20)
        flash_attention.launches = n_launch  # comparison launches not counted
        rec["plain_ms"] = _time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                   3, warmup=1)
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
        # the yardstick: one PyTorch call computing the same function, where
        # one exists (SDPA gives NaN, not zeros, for rows with no valid key)
        if not (causal and sq > kvl):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            mask = None
            if kvl != sk or (causal and sq != sk):
                key = torch.arange(sk, device="cuda")
                mask = (key < kvl)[None, :].expand(sq, sk)
                if causal:
                    row = torch.arange(sq, device="cuda")[:, None]
                    mask = mask & (key[None, :] <= row + (kvl - sq))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None)
            rec["library_ms"] = _graph_ms(sdpa)
            # the backend SDPA picked, by the autograd node it records
            # (its flash and cuDNN backends stop at D = 256)
            leaf = qt.detach().requires_grad_()
            rec["library_op"] = F.scaled_dot_product_attention(
                leaf, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None).grad_fn.name()
        else:
            rec["library_ms"] = None
    rec["ok"] = ok
    rec["main_path"] = main_path
    _say("kernels", **rec)
    return rec


def _sdpa_args(q, k, v, causal):
    """[B, H, S, D] copies and the suffix-aligned causal mask for SDPA
    (its is_causal is top-left aligned, the same only when Sq == Sk)."""
    import torch
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = None
    if causal and sq != sk:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
    return qt, kt, vt, dict(attn_mask=mask, is_causal=causal and mask is None)


def _flash_bwd_case(name, b, sq, sk, h, d, *, causal=False, timed=False,
                    main_path=False, scale_fault=False):
    """The fused backward (through flash_attention_bwd) against
    flash_attention_bwd_ref in fp32 on the same bf16 inputs, with a real
    K1 forward's out and lse. scale_fault: the kernel run at 1.1x the
    softmax scale must fail the same limits."""
    import torch
    from rsvldm_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
    mk = lambda s: torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
    q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    bw = fa.flash_attention_bwd
    counts = lambda: (bw.launches, bw.launches_d256, bw.launches_wide)
    n_launch, n_d256, n_wide = counts()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    # one launch, of the D=256 kernel where the wrapper pads D to 256, of
    # the wide kernels past 256
    dp = fa.padded_head_dim(d)
    launched = counts() == (n_launch + 1, n_d256 + (dp == 256),
                            n_wide + fa.is_wide(dp))
    after = counts()

    def restore():
        # comparison launches not counted
        bw.launches, bw.launches_d256, bw.launches_wide = after
    ref = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                     out.float(), lse, do.float(),
                                     causal=causal)
    rms = lambda x: float(x.square().mean().sqrt())
    rec = dict(case=name, shape=[b, sq, sk, h, d], causal=causal,
               tol=f"|err| <= {K34_ATOL}*rms(ref) + {K34_RTOL}*|ref|, "
                   f"rms(err) <= {K34_RMS_TOL}*rms(ref)")
    ok = launched
    for gname, x, r in zip(("dq", "dk", "dv"), got, ref):
        err = (x.float() - r).abs()
        tol = K34_ATOL * rms(r) + K34_RTOL * r.abs()
        rel_rms = rms(err) / max(rms(r), 1e-30)
        rec[gname] = dict(max_abs_err=float(err.max()), rms_ref=rms(r),
                          max_err_over_tol=float((err / tol).max()),
                          rel_rms_err=rel_rms)
        ok = (ok and bool((err <= tol).all()) and rel_rms <= K34_RMS_TOL
              and bool(torch.isfinite(x).all()))
    if causal and sq > sk:
        rec["zero_rows_exact"] = bool((got[0][:, :sq - sk] == 0).all())
        ok = ok and rec["zero_rows_exact"]
    if scale_fault:
        bad = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                     scale=1.1 / math.sqrt(d))
        restore()
        passed = True
        for x, r in zip(bad, ref):
            e = (x.float() - r).abs()
            passed = (passed and bool((e <= K34_ATOL * rms(r)
                                       + K34_RTOL * r.abs()).all())
                      and rms(e) <= K34_RMS_TOL * max(rms(r), 1e-30))
        rec["fault_rel_rms_err"] = max(
            rms(x.float() - r) / max(rms(r), 1e-30) for x, r in zip(bad, ref))
        rec["fault_rejected"] = not passed
        ok = ok and rec["fault_rejected"]
    rec["max_abs_err"] = max(rec[g]["max_abs_err"] for g in ("dq", "dk", "dv"))
    # the kernel's work: five products (S, dP, dV, dK, dQ) over the valid
    # pairs; q, do, k, v read and dk, dv written once in bf16, lse*log2e
    # and delta read, dq added once in fp32
    flops = 5 * 2.0 * b * h * d * _valid_pairs(sq, sk, sk, causal)
    nbytes = (2 * b * h * d * (2 * sq + 4 * sk) + 4 * b * h * d * sq
              + 2 * 4 * b * h * sq)
    rec["bound_ms"] = max(flops / H100_BF16_FLOPS,
                          nbytes / H100_HBM_BYTES) * 1e3
    rec["bound_by"] = ("operations" if flops / H100_BF16_FLOPS
                       >= nbytes / H100_HBM_BYTES else "bytes")
    rec["gflop"] = flops / 1e9
    if timed:
        # device time by graph replay: the kernel alone on the prologue's
        # outputs (its dq adds pile up across replays, which costs the same),
        # and the whole backward (prologue, kernel, cast to bf16); the
        # wrapper with its host cost by events
        # (a padded D: the kernel on the wrapper's zero-padded inputs)
        scale = 1.0 / d ** 0.5
        dp = fa.padded_head_dim(d)
        pad = ((lambda x: x) if dp == d else
               (lambda x: torch.nn.functional.pad(x, (0, dp - d))))
        qp, kp, vp, dop, outp = (pad(x) for x in (q, k, v, do, out))
        if fa.is_wide(dp):
            # the wide route's kernels are one C call (prologue, kernel),
            # timed with the workspace's cast
            rec["ms"] = _graph_ms(lambda: fa._bwd_wide(
                qp, kp, vp, outp, lse, dop, causal, scale))
        else:
            aux, dq_acc = fa._bwd_prep(outp, dop, lse)
            dk, dv = torch.empty_like(kp), torch.empty_like(vp)
            rec["ms"] = _graph_ms(lambda: fa._bwd_kernel(
                qp, kp, vp, dop, aux, dq_acc, dk, dv, causal, scale))
        call = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                              causal=causal)
        rec["whole_ms"] = _graph_ms(call)
        rec["wrapper_ms"] = _time_ms(call, 10)
        restore()
        rec["plain_ms"] = _time_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, out, lse, do, causal=causal), 3, warmup=1)
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
        # the yardstick: SDPA's backward (dq, dk and dv in one call), timed
        # only; SDPA gives NaN, not zeros, for rows with no valid key
        if not (causal and sq > sk):
            rec.update(_sdpa_bwd_times(q, k, v, do, causal))
        else:
            rec["library_ms"] = None
    rec["ok"] = bool(ok)
    rec["main_path"] = main_path
    _say("kernels", **rec)
    return rec


def _sdpa_bwd_times(q, k, v, do, causal):
    """SDPA's backward: `library_ms` by graph replay of autograd.grad alone
    (the forward runs once on a side stream before the capture; autograd
    runs each backward op on its forward's stream, which is the capturing
    one), `library_wrapper_ms` by events over host launches after a forward
    on the current stream, and the backward op autograd recorded. Each run
    takes fresh leaves, so that no autograd node is bound to the other's
    stream."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt, kw = _sdpa_args(q, k, v, causal)
    dot = do.transpose(1, 2).contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    rec = {}
    for stream in (side, None):
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        with torch.cuda.stream(stream):
            o = F.scaled_dot_product_attention(*leaves, **kw)
        grad = lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True)
        if stream is None:
            rec["library_wrapper_ms"] = _time_ms(grad, 10)
        else:
            rec["library_ms"] = _graph_ms(grad, stream=stream)
        rec["library_op"] = o.grad_fn.name()
    return rec


def _k2_inputs(name, r, inf, out):
    """Seeded int4 weights [inf, out] and a bf16 x [r, inf] on the card."""
    import torch
    from rsvldm_tpu_torch.ops import quant
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
    w = torch.randn((inf, out), generator=gen, device="cuda") * inf ** -0.5
    ql = quant.quantize_weight_int4(w)
    del w
    x = torch.randn((r, inf), generator=gen, device="cuda").to(torch.bfloat16)
    return x, ql


def _k2_bytes(r, inf, out, out_bytes: int = 2):
    """What K2 must move: bf16 x in, packed weights and fp32 scales, y out
    (bf16, or fp32 for a row-parallel shard's partials)."""
    return (r * inf * 2 + inf // 2 * out + inf // 128 * out * 4
            + r * out * out_bytes)


def _k2_case(name, r, inf, out, *, main_path=False, x=None, out_dtype=None):
    """K2 (through int4_matmul, the wrapper that launches it) against
    int4_matmul_ref on the same bf16 input and int4 weights: y in fp32
    within the tolerance, y in bf16 equal to the fp32 y rounded. Timed
    with y in `out_dtype` (bf16 by default, as in decode)."""
    import torch
    from rsvldm_tpu_torch.ops import quant
    x0, ql = _k2_inputs(name, r, inf, out)
    x = x0 if x is None else x
    out_dtype = out_dtype or torch.bfloat16
    n_launch = quant.int4_matmul.launches
    y = quant.int4_matmul(x, ql, torch.float32)
    y16 = quant.int4_matmul(x, ql, torch.bfloat16)
    torch.cuda.synchronize()
    launched = quant.int4_matmul.launches == n_launch + 2
    ref = quant.int4_matmul_ref(x, ql)
    # sum over groups of |xs * ws * acc|: the scale of the fp32 sums
    xq, xs = quant.quantize_acts_grouped(x, quant.K2_GROUP)
    q = quant.unpack_int4(ql.packed).reshape(inf // quant.K2_GROUP,
                                             quant.K2_GROUP, out)
    mag = torch.zeros_like(ref)
    for g in range(q.shape[0]):
        mag += (xq[:, g].float() @ q[g].float()).abs() * xs[:, g] * ql.scale[g]
    err = (y - ref).abs()
    tol = K2_RTOL * mag + K2_ATOL
    cast_exact = bool(torch.equal(y16, y.to(torch.bfloat16)))
    ok = bool(launched and (err <= tol).all() and torch.isfinite(y).all()
              and cast_exact)
    plan = quant.k2_plan(r, inf, out,
                         quant._sm_count(torch.cuda.current_device()))
    rec = dict(case=name, shape=[r, inf, out], plan=list(plan),
               max_abs_err=float(err.max()),
               max_err_over_tol=float((err / tol).max()),
               max_abs_ref=float(ref.abs().max()), bf16_out_is_cast=cast_exact,
               tol=f"|err| <= {K2_RTOL}*sum|terms| + {K2_ATOL}")
    nbytes = _k2_bytes(r, inf, out, out_dtype.itemsize)
    ops = 2.0 * r * inf * out
    rec["bound_ms"] = max(nbytes / H100_HBM_BYTES, ops / H100_INT8_OPS) * 1e3
    rec["bound_by"] = ("bytes" if nbytes / H100_HBM_BYTES
                       >= ops / H100_INT8_OPS else "operations")
    # the whole projection is the one launch, bf16 in and y as in decode:
    # device time by graph replay, the wrapper with its host cost by events
    call = lambda: quant.int4_matmul(x, ql, out_dtype)
    rec["out_dtype"] = str(out_dtype).replace("torch.", "")
    rec["ms"] = _graph_ms(call)
    rec["wrapper_ms"] = _time_ms(call, 20)
    quant.int4_matmul.launches = n_launch  # comparison launches not counted
    rec["plain_ms"] = _time_ms(lambda: quant.int4_matmul_ref(x, ql), 3,
                               warmup=1)
    rec["gbps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec.update(_k2_library(x, ql, ref))
    rec["ok"] = ok
    rec["main_path"] = main_path
    _say("kernels", **rec)
    return rec


def _k2_ties():
    """bf16 x of half-integers with every group's amax 127, so the scale is
    exactly 1 and every x / s is a tie: K2's codes must round half to even
    as the plain version's do (half away from zero moves half the codes)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    r, inf = 4, 4096
    x = torch.randint(-127, 127, (r, inf), generator=gen, device="cuda") + 0.5
    x[:, ::128] = 127.0  # one 127 in each group
    x[:, 1::256] = -127.0
    return _k2_case("ties_half_even", r, inf, 4096,
                    x=x.to(torch.bfloat16))


def _k2_zero_rows():
    """A row of zeros (scale clamped to 1e-12, codes 0: y exactly 0), a row
    with one zero group, and a call with no rows (no launch)."""
    import torch
    from rsvldm_tpu_torch.ops import quant
    x, ql = _k2_inputs("zero_rows", 4, 4096, 4096)
    x[1] = 0
    x[3, 256:384] = 0
    rec = _k2_case("zero_rows", 4, 4096, 4096, x=x)
    n_launch = quant.int4_matmul.launches
    y = quant.int4_matmul(x, ql, torch.float32)
    empty = quant.int4_matmul(x[:0], ql)
    torch.cuda.synchronize()
    rec["zero_row_exact"] = bool((y[1] == 0).all())
    rec["no_rows"] = dict(shape=list(empty.shape),
                          launched=quant.int4_matmul.launches - n_launch - 1)
    quant.int4_matmul.launches = n_launch
    rec["ok"] = bool(rec["ok"] and rec["zero_row_exact"]
                     and rec["no_rows"] == dict(shape=[0, 4096], launched=0))
    _say("kernels", case="zero_rows", zero_row_exact=rec["zero_row_exact"],
         no_rows=rec["no_rows"], ok=rec["ok"])
    return rec


def _k2_one_launch():
    """Under torch.profiler, one int4_matmul call on the card runs exactly
    one device kernel, K2's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from rsvldm_tpu_torch.ops import quant
    x, ql = _k2_inputs("one_launch", 1, 4096, 14336)
    n_launch = quant.int4_matmul.launches
    quant.int4_matmul(x, ql)  # first use: library, counters
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        quant.int4_matmul(x, ql)
        torch.cuda.synchronize()
    quant.int4_matmul.launches = n_launch
    rows, _ = _device_kernels(prof)
    rec = dict(case="one_launch_per_call", shape=[1, 4096, 14336],
               device_kernels=[[k[:60], c] for k, _, c in rows])
    rec["ok"] = bool(sum(c for _, _, c in rows) == 1
                     and "int4_decode_kernel" in rows[0][0])
    _say("kernels", **rec)
    return rec


def _k2_library(x, ql, ref):
    """Yardstick, never called by the port: PyTorch's int4 weight-only
    product (tinygemm) on the same int4 weights repacked, bf16 activations
    (no activation quantization, so its error vs ref is reported, not
    held); torch.matmul against the bf16-dequantized weight where that op
    is missing or refuses the shape. Device time by graph replay
    (`library_ms`), and by events over host launches beside it."""
    import torch
    from rsvldm_tpu_torch.ops import quant
    inf, out = 2 * ql.packed.shape[0], ql.packed.shape[1]
    gb = ql.scale.shape[0]
    q = quant.unpack_int4(ql.packed)                       # [in, out]
    try:
        u = (q.t().to(torch.int32) + 8)                    # [out, in] 1..15
        packed = (u[:, 0::2] << 4 | u[:, 1::2]).to(torch.uint8).contiguous()
        w4 = torch._convert_weight_to_int4pack(packed, 8)
        sz = torch.stack([ql.scale, torch.zeros_like(ql.scale)], -1)
        sz = sz.to(torch.bfloat16).contiguous()            # [Gb, out, 2]
        call = lambda: torch._weight_int4pack_mm(x, w4, inf // gb, sz)
        which = "torch._weight_int4pack_mm"
        y = call()
    except (RuntimeError, AttributeError, TypeError) as e:
        wd = (q.float() * ql.scale.repeat_interleave(inf // gb, 0)).to(x.dtype)
        call = lambda: torch.matmul(x, wd)
        which = f"torch.matmul on the bf16-dequantized weight ({e!r:.80})"
        y = call()
    torch.cuda.synchronize()
    return dict(library=which, library_ms=_graph_ms(call),
                library_wrapper_ms=_time_ms(call, 20),
                library_max_abs_err_vs_ref=float((y.float() - ref).abs().max()))


def _k2_step(k2, rows: int = 1, suffix: str = "", steps=K2_STEP,
             label: str = "llama3"):
    """K2's device time per decode step of `rows` rows: sum of launches x
    time at the step's shapes (cases named <shape><suffix>), beside its
    bound and tinygemm's sum."""
    by = {c["case"]: c for c in k2}
    at = lambda c, key: by[c + suffix][key]
    rec = dict(step="decode", model=label, rows=rows,
               launches=sum(n for *_, n in steps),
               ms=sum(n * at(c, "ms") for c, *_, n in steps),
               bound_ms=sum(n * at(c, "bound_ms") for c, *_, n in steps),
               library_ms=sum(n * at(c, "library_ms") for c, *_, n in steps))
    key = "k2_per_decode_step" + (suffix if label == "llama3" else f"_{label}")
    _say("kernels", **{key: rec})
    return rec


def phase_kernels():
    from rsvldm_tpu_torch.device import resolve_device
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    resolve_device("cuda")  # full-fp32 matmuls: the plain versions are exact
    flash_attention.launches = 0
    cases = [
        # the slice's shapes: SDXL self-attention at 64^2 and 32^2 latents
        _flash_case("sdxl_s4096", 2, 4096, 4096, 10, 64, timed=True,
                    main_path=True),
        _flash_case("sdxl_s1024", 2, 1024, 1024, 20, 64, timed=True,
                    main_path=True),
        # the Llama-3-8B prefill of a 224^2 caption (1176 image tokens + the
        # chat prompt, padded to 1280), causal, GQA repeated to 32 heads
        _flash_case("llama_prefill_s1280", 1, 1280, 1280, 32, 128,
                    causal=True, timed=True, main_path=True),
        # the training step: 4 records padded to 1536 tokens, with lse
        _flash_case("llama_train_s1536", 4, 1536, 1536, 32, 128, causal=True,
                    lse=True, timed=True, main_path=True),
        # folder mode: the batched prefill of 8 captions, and the batched
        # refinement of 4 images (CFG batch 8) at the 64^2 and 32^2 levels
        _flash_case("folder_prefill_b8_s1408", 8, 1408, 1408, 32, 128,
                    causal=True, timed=True, main_path=True),
        _flash_case("folder_sdxl_b8_s4096", 8, 4096, 4096, 10, 64, timed=True,
                    main_path=True),
        _flash_case("folder_sdxl_b8_s1024", 8, 1024, 1024, 20, 64, timed=True,
                    main_path=True),
        _flash_case("causal_sq_lt_sk", 1, 300, 700, 4, 64, causal=True),
        _flash_case("causal_sq_gt_sk", 1, 700, 300, 4, 64, causal=True,
                    lse=True),
        _flash_case("ragged_kv_len_lse", 2, 1000, 1024, 8, 128,
                    kv_len=777, lse=True),
        _flash_case("ragged_causal_lse", 1, 513, 1100, 2, 64, causal=True,
                    kv_len=1000, lse=True),
        # the edges of K1's 128-row q and 128-key K/V tiles
        _flash_case("d128_ragged_tiles", 1, 1153, 1217, 3, 128, lse=True),
        _flash_case("d128_causal_sq_gt_sk", 1, 700, 300, 4, 128, causal=True,
                    lse=True),
        _flash_case("d64_sq_lt_tile", 2, 77, 1024, 4, 64, lse=True),
        # the other families (phases families / towers): Gemma-7B's caption
        # prefill (causal, 16 heads of 256) and MLCD-bigG-448's attention
        # (non-causal, 5 tiles of 32^2 + 1 tokens, 1664 / 16 = 104 padded
        # to 128 by the wrapper), each with a planted 10% scale fault
        _flash_case("gemma_prefill_s1280_d256", 1, 1280, 1280, 16, 256,
                    causal=True, timed=True, main_path=True, scale_fault=True),
        _flash_case("mlcd448_b5_s1025_d104", 5, 1025, 1025, 16, 104,
                    timed=True, main_path=True, scale_fault=True),
        # the families' other K1 prefills: Qwen2-7B (28 heads of 128 after
        # the GQA repeat) and Qwen2-MoE-A2.7B (16); their head counts change
        # the persistent grid's items and its last, partial wave
        _flash_case("qwen2_prefill_s1280_h28", 1, 1280, 1280, 28, 128,
                    causal=True, timed=True, main_path=True, scale_fault=True),
        _flash_case("qwen2moe_prefill_s1280_h16", 1, 1280, 1280, 16, 128,
                    causal=True, timed=True, main_path=True, scale_fault=True),
        # the tensor-parallel caption prefill (phase parallel): one rank's
        # 32 / n heads of the Llama-3-8B prefill; TP=2's [1, 1280, 16, 128]
        # is the Qwen2-MoE case above, TP=4's is this one
        _flash_case("llama_tp4_prefill_s1280_h8", 1, 1280, 1280, 8, 128,
                    causal=True, timed=True, main_path=True),
        # the Gemma-7B QLoRA step's forward and recompute (phase
        # train_gemma): 4 records of 1536 tokens, 16 heads of 256, with lse
        _flash_case("gemma_train_s1536_d256", 4, 1536, 1536, 16, 256,
                    causal=True, lse=True, timed=True, main_path=True,
                    scale_fault=True),
        # D=256 at the edges of its tiles and with zero rows; padded D=72
        _flash_case("d256_ragged_tiles", 1, 1153, 1217, 3, 256, lse=True),
        _flash_case("d256_causal_sq_gt_sk", 1, 700, 300, 4, 256, causal=True,
                    lse=True),
        _flash_case("d72_causal_padded", 2, 300, 300, 3, 72, causal=True,
                    lse=True),
        # D=192, padded to 256 by the wrapper (the backward's case below)
        _flash_case("d192_causal_padded", 1, 1100, 1100, 4, 192, causal=True,
                    lse=True, timed=True, scale_fault=True),
    ] + _wide_cases()
    int4_matmul.launches = 0
    k2 = phase_k2()
    # the backward: the training step's attention (B=4 records of 1536
    # padded tokens, 32 heads of 128 after the GQA repeat, causal), D=64
    # non-causal, causal Sq < Sk and Sq > Sk (zero rows), ragged lengths
    bwd = [
        _flash_bwd_case("train_s1536", 4, 1536, 1536, 32, 128, causal=True,
                        timed=True, main_path=True),
        _flash_bwd_case("d64_noncausal", 2, 1024, 1024, 8, 64, timed=True),
        _flash_bwd_case("causal_sq_lt_sk", 1, 300, 700, 4, 128, causal=True),
        _flash_bwd_case("causal_sq_gt_sk", 1, 700, 300, 4, 64, causal=True),
        _flash_bwd_case("ragged_causal", 2, 1000, 1000, 4, 128, causal=True),
        _flash_bwd_case("ragged_noncausal", 1, 517, 1100, 4, 64),
        # the edges of the kernel's 128-key and 64-query tiles
        _flash_bwd_case("d128_causal_s1153", 1, 1153, 1153, 3, 128,
                        causal=True),
        _flash_bwd_case("d128_sq130_sk1100", 1, 130, 1100, 3, 128),
        _flash_bwd_case("d64_causal_s77", 2, 77, 77, 4, 64, causal=True),
        _flash_bwd_case("d128_causal_sq_gt_sk", 1, 700, 300, 4, 128,
                        causal=True),
        # head dims the wrapper pads to 128 / 64 (MLCD's 104, and 40)
        _flash_bwd_case("d104_padded", 1, 1025, 1025, 4, 104),
        _flash_bwd_case("d40_causal_padded", 1, 300, 300, 3, 40, causal=True),
    ] + _bwd_d256_cases() + _bwd_wide_cases()
    _reset_counts()
    return cases, k2, bwd


def _wide_cases():
    """K1 past D = 256 (csrc/flash_wide.cu): phase wide_head's train step
    (4 records of 1536 tokens, 8 heads of 512, causal, with lse) and its
    1280-token prefill, D=320 non-causal with kv_len padding, each timed
    with a planted 10% scale fault; causal Sq > Sk (zero rows) at D=384,
    D=288 padded to 320 across the 64-row tiles' edges, D=600 padded to
    640 (O split over two items)."""
    return [
        _flash_case("wide_train_s1536_d512", 4, 1536, 1536, 8, 512,
                    causal=True, lse=True, timed=True, main_path=True,
                    scale_fault=True),
        _flash_case("wide_prefill_s1280_d512", 1, 1280, 1280, 8, 512,
                    causal=True, timed=True, main_path=True, scale_fault=True),
        _flash_case("wide_d320_kv_len", 2, 1024, 1024, 4, 320, kv_len=1000,
                    lse=True, timed=True, scale_fault=True),
        _flash_case("wide_d384_causal_sq_gt_sk", 1, 700, 300, 2, 384,
                    causal=True, lse=True),
        _flash_case("wide_d288_padded", 1, 333, 517, 2, 288, causal=True,
                    kv_len=500, lse=True),
        # D=600 padded to 640: O's ten boxes split over two items
        _flash_case("wide_d600_padded", 1, 300, 300, 2, 600, causal=True,
                    lse=True),
    ]


def _bwd_wide_cases():
    """The backward past D = 256 (csrc/flash_wide.cu: prologue, then one
    kernel adding dQ into an fp32 workspace): phase wide_head's train step
    [4, 1536, 8, 512] causal and [2, 1024, 4, 320], timed, each with a
    planted 10% scale fault; causal Sq < Sk and Sq > Sk (zero rows), D=288
    padded to 320, D=600 padded to 640 (three items a key tile)."""
    return [
        _flash_bwd_case("wide_train_s1536_d512", 4, 1536, 1536, 8, 512,
                        causal=True, timed=True, main_path=True,
                        scale_fault=True),
        _flash_bwd_case("wide_d320_noncausal", 2, 1024, 1024, 4, 320,
                        timed=True, scale_fault=True),
        _flash_bwd_case("wide_d384_causal_sq_lt_sk", 1, 300, 700, 2, 384,
                        causal=True),
        _flash_bwd_case("wide_d512_causal_sq_gt_sk", 1, 700, 300, 2, 512,
                        causal=True),
        _flash_bwd_case("wide_d288_padded", 1, 333, 333, 2, 288,
                        causal=True),
        # D=600 padded to 640: dK / dV / dQ's ten boxes split over three
        # items a key tile (4 + 4 + 2)
        _flash_bwd_case("wide_d600_padded", 1, 300, 300, 2, 600,
                        causal=True),
    ]


def _bwd_d256_cases():
    """The D=256 backward (flash_bwd_d256_kernel, 64-key tiles): Gemma-7B's
    training step (4 records of 1536 tokens, 16 heads of 256, causal) and
    a non-causal [2, 1024, 8, 256], both timed and with a planted 10%
    scale fault; the edges of its 64-key and 64-query tiles, causal
    Sq < Sk and Sq > Sk (zero rows); D=192, which the wrapper pads to 256,
    forward and backward."""
    return [
        _flash_bwd_case("gemma_train_s1536_d256", 4, 1536, 1536, 16, 256,
                        causal=True, timed=True, main_path=True,
                        scale_fault=True),
        _flash_bwd_case("d256_noncausal", 2, 1024, 1024, 8, 256, timed=True,
                        scale_fault=True),
        _flash_bwd_case("d256_causal_s1153", 1, 1153, 1153, 3, 256,
                        causal=True),
        _flash_bwd_case("d256_sq130_sk1100", 1, 130, 1100, 3, 256),
        _flash_bwd_case("d256_causal_sq_lt_sk", 1, 300, 700, 2, 256,
                        causal=True),
        _flash_bwd_case("d256_causal_sq_gt_sk", 1, 700, 300, 2, 256,
                        causal=True),
        _flash_bwd_case("d256_causal_s77", 2, 77, 77, 2, 256, causal=True),
        _flash_bwd_case("d192_causal_padded", 1, 1100, 1100, 4, 192,
                        causal=True, timed=True),
    ]


def phase_k2():
    """K2's cases: one Llama-3-8B decode step's shapes (R = 1), rows 8 and
    32, ragged outs (out % 16 != 0 takes byte loads), ties, zero rows; the
    one-launch check; the decode step's shapes at 8 rows (folder mode) and
    at 5 rows (the speculative verify forward, spec_k + 1 tokens); the
    sums per decode step at 1, 8 and 5 rows; one rank's shard shapes of
    the TP=2 decode step and their sum."""
    import torch
    k2 = [_k2_case(name, 1, inf, out, main_path=True)
          for name, inf, out, _ in K2_STEP]
    k2 += [_k2_case("rows_8", 8, 4096, 4096),
           _k2_case("rows_32", 32, 4096, 4096),
           _k2_case("ragged_out_4144", 1, 4096, 4144),
           _k2_case("ragged_out_1000", 3, 512, 1000),
           # 19 pairs: no split count divides them, so the ranges are uneven
           _k2_case("uneven_splits_4864", 1, 4864, 4096),
           _k2_ties(), _k2_zero_rows(), _k2_one_launch()]
    # folder mode: a decode step of the batched caption, 8 rows
    k2 += [_k2_case(name + "_r8", 8, inf, out, main_path=True)
           for name, inf, out, _ in K2_STEP]
    # speculative decoding: the verify forward of spec_k + 1 = 5 tokens
    k2 += [_k2_case(name + "_r5", SPEC_K + 1, inf, out, main_path=True)
           for name, inf, out, _ in K2_STEP]
    _k2_step(k2)
    _k2_step(k2, rows=8, suffix="_r8")
    _k2_step(k2, rows=SPEC_K + 1, suffix="_r5")
    # one rank's shards of the Llama-3-8B decode step at TP=2 (phase
    # parallel), the row-parallel ones with fp32 partials
    k2 += [_k2_case(name, 1, inf, out, main_path=True,
                    out_dtype=torch.float32 if name.endswith("_f32") else None)
           for name, inf, out, _ in K2_TP2_STEP]
    _k2_step(k2, steps=K2_TP2_STEP, label="llama3_tp2")
    # the int4 Gemma-7B and Qwen2-7B decode steps (phase families)
    for family, shapes in K2_FAMILY_STEP.items():
        k2 += [_k2_case(name, 1, inf, out, main_path=True)
               for name, inf, out, _ in shapes]
        _k2_step(k2, steps=shapes, suffix="", label=family)
    return k2


def _reset_counts():
    from rsvldm_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    flash_attention.launches = int4_matmul.launches = 0
    flash_attention.launches_wide = 0
    flash_attention_bwd.launches = flash_attention_bwd.launches_d256 = 0
    flash_attention_bwd.launches_wide = 0


def _counts():
    """The launch counters: K1 at every head dim (`k1`) and, of those, the
    wide kernel's (D > 256, `k1wide`), K2, the backward at every head dim
    (`bwd`) and, of those, the D=256 kernel's (`bwd256`) and the wide
    one's (`bwdwide`)."""
    from rsvldm_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    return dict(k1=flash_attention.launches,
                k1wide=flash_attention.launches_wide, k2=int4_matmul.launches,
                bwd=flash_attention_bwd.launches,
                bwd256=flash_attention_bwd.launches_d256,
                bwdwide=flash_attention_bwd.launches_wide)


def _same(graph, direct) -> dict:
    """Graph replay's result against the direct call's."""
    import torch
    a, b = graph.float(), direct.float()
    err = float((a - b).abs().max())
    scale = max(1.0, float(b.abs().max()))
    return dict(max_abs_diff=err, bit_equal=bool(torch.equal(a, b)),
                finite=bool(torch.isfinite(a).all()),
                ok=bool(err <= GRAPH_TOL * scale and torch.isfinite(a).all()))


def _graph_vs_direct(pipe, seed: int, sr3_steps: int, sr3_size: int,
                     latent: int, edm_cases, ddim: bool = False) -> dict:
    """The loops' step functions on the card, once replayed as CUDA graphs
    and once called directly, on the same inputs: SR3 (`sr3_steps` steps
    of a schedule that long, a sr3_size^2 image), with `ddim` DDIM over
    the same schedule, RestoreEDM for each (name, steps, img_threshold,
    dec_img) of `edm_cases` on a latent^2 latent (CFG batch 2, churn on;
    dec_img 0 makes every step a miss: the threshold falls to 0 after the
    first measured change)."""
    import torch
    from rsvldm_tpu_torch.diffusion.samplers import (RestoreEDMConfig,
                                                     restore_edm_sample)
    from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser
    from rsvldm_tpu_torch.models.sr3.diffusion import (SR3Diffusion,
                                                       sr3_sample,
                                                       sr3_sample_ddim)

    modes = (True, False)
    gen_ = torch.Generator(device=pipe.device).manual_seed(seed)
    rnd = lambda *s, dt=torch.float32: torch.randn(s, generator=gen_,
                                                   device=pipe.device, dtype=dt)
    rec = {}
    s1 = pipe.cfg.stage1
    diff = SR3Diffusion.from_schedule(s1.schedule, sr3_steps, s1.linear_start,
                                      s1.linear_end)
    cond = rnd(1, sr3_size, sr3_size, 3).clamp(-1, 1)
    noise = rnd(sr3_steps + 1, 1, sr3_size, sr3_size, 3)
    samplers = {"sr3": sr3_sample}
    if ddim:
        samplers["ddim"] = lambda *a, **k: sr3_sample_ddim(
            *a, num_steps=sr3_steps, eta=0.5, **k)
    for name, fn in samplers.items():
        st = {m: {} for m in modes}
        out = {m: fn(diff, pipe.sr3, cond, noise, graphs=m, stats=st[m])
               for m in modes}
        rec[name] = dict(steps=sr3_steps, size=sr3_size,
                         capture_s=st[True]["capture_s"],
                         **_same(out[True], out[False]))
    den = ControlDenoiser(unet=pipe.unet, control_net=pipe.control)
    c = pipe.sdxl_cfg
    mk = lambda: dict(crossattn=rnd(1, 77, c.context_dim, dt=pipe.dtype),
                      vector=rnd(1, c.adm_in_channels),
                      control=rnd(1, latent, latent, 4))
    cond2, uc = mk(), mk()
    for name, steps, threshold, dec in edm_cases:
        x0, xc = rnd(1, latent, latent, 4), rnd(1, latent, latent, 4)
        churn = rnd(steps, 1, latent, latent, 4)
        scfg = RestoreEDMConfig(num_steps=steps, img_threshold=threshold,
                                dec_img=dec)
        st = {m: {} for m in modes}
        res = {m: restore_edm_sample(den, cond2, uc, x0, xc, scfg,
                                     churn_noise=churn, return_aux=True,
                                     graphs=m, stats=st[m]) for m in modes}
        traces = {m: "".join("H" if h else "." for h in res[m][1]["hit_trace"])
                  for m in modes}
        same = _same(res[True][0], res[False][0])
        rec[f"edm_{name}"] = dict(
            steps=steps, latent=latent, img_threshold=threshold,
            trace=traces[True], traces_equal=traces[True] == traces[False],
            capture_s=st[True]["capture_s"], **same)
        want = {"misses": "." * steps, "miss": "." * steps,
                "hits": "." + "H" * (steps - 1), "hit": "." + "H" * (steps - 1)}
        rec[f"edm_{name}"]["ok"] = (same["ok"] and traces[True] == traces[False]
                                    and traces[True] == want.get(name,
                                                                 traces[True]))
    rec["ok"] = all(v["ok"] for v in rec.values())
    return rec


def _decode_vs_direct(llama, embeds, new_tokens: int) -> dict:
    """The caption decode of `new_tokens` tokens after `embeds` (T = 0.2,
    the default Gumbel stream), once replayed as a CUDA graph and once
    called directly: the ids and the steps run must be equal. K2's
    launches of each, counted through the replays."""
    import numpy as np
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    gcfg = gen.GenerateConfig(max_new_tokens=new_tokens, temperature=0.2)
    st, ids, k2 = {}, {}, {}
    for m in (True, False):
        st[m] = {}
        before = int4_matmul.launches
        ids[m] = gen.generate(llama, embeds, gcfg, graphs=m, stats=st[m])
        k2[m] = int4_matmul.launches - before
    return dict(new_tokens=new_tokens, steps=st[True]["decode_steps"],
                capture_s=st[True]["capture_s"], ids=ids[True][:8].tolist(),
                k2_launches=k2[True],
                ok=bool(np.array_equal(ids[True], ids[False])
                        and st[True]["decode_steps"] == st[False]["decode_steps"]
                        and k2[True] == k2[False]))


# --------------------------------------------------------------- phase 4
def _small_cfgs(vae=None):
    """The small-width model configs of the reference phases; 64-channel
    heads so the self-attention at the 32^2 level (1024 tokens of a 64^2
    latent) and the ZeroCrossAttn there run on K1."""
    from rsvldm_tpu_torch.models.sdxl.unet import SDXLUNetConfig
    from rsvldm_tpu_torch.models.sr3.unet import SR3UNetConfig
    from rsvldm_tpu_torch.models.text.clip import CLIPTextConfig
    from rsvldm_tpu_torch.models.vae.model import VAEConfig
    return dict(
        sr3=SR3UNetConfig(inner_channel=32, norm_groups=8, channel_mults=(1, 2),
                          attn_res=(8,), res_blocks=1, image_size=16),
        sdxl=SDXLUNetConfig(model_channels=64, num_res_blocks=1,
                            attention_resolutions=(2,), channel_mult=(1, 2),
                            num_head_channels=64, transformer_depth=(1, 1),
                            context_dim=64, adm_in_channels=32 + 3 * 512),
        vae=vae or VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        clip_l=CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2),
        big_g=CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2,
                             quick_gelu=False, use_text_projection=True,
                             openclip=True))


def _card_vs_cpu(seed: int, small: dict, refine: dict, names, lr_side: int = 4):
    """process() of a seeded lr_side^2 tile (x4, 8 SR3 steps) at the `small`
    width on the CPU in fp32, then on the card in bf16 with the CPU's
    weights and draws. (record with the uint8 differences of each PNG of
    `names`, whether all are within REF_MEAN_TOL / REF_MAX_TOL, the card's
    pipeline)."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import (PipelineConfig, RefinementConfig,
                                         Stage1Config)
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.pipeline import (ReplayNoise, SuperResolutionPipeline,
                                           TorchNoise)

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ref_"))
    rng = np.random.default_rng(seed + 1)
    Image.fromarray((rng.random((lr_side, lr_side, 3)) * 255).astype(np.uint8)
                    ).save(work / "lr.png")

    def cfg(out):
        return PipelineConfig(input_img=str(work / "lr.png"),
                              output_dir=str(work / out), upscale=4,
                              seed=seed, no_llava=True,
                              params_dtype="fp32" if out == "cpu" else "bf16",
                              stage1=Stage1Config(steps=8),
                              refine=RefinementConfig(**refine))

    draws: dict = {}
    cpu_noise = TorchNoise(seed, torch.device("cpu"))

    def recording(name, shape):
        draws.setdefault(name, []).append(cpu_noise(name, shape).clone())
        return draws[name][-1]

    cpu = SuperResolutionPipeline(cfg("cpu"), device="cpu", model_cfgs=small,
                                  noise=recording)
    cpu.process()
    sds = {fam: getattr(cpu, fam).state_dict() for fam in
           ("sr3", "unet", "control", "vae", "clip_l", "big_g")}
    gpu = SuperResolutionPipeline(cfg("gpu"), device="cuda", model_cfgs=small,
                                  state_dicts=sds, noise=ReplayNoise(draws))
    flash_attention.launches = 0
    gpu.process()
    rec = dict(k1_launches=flash_attention.launches)
    ok = True
    for name in names:
        a = np.asarray(Image.open(work / "cpu" / name), np.int16)
        b = np.asarray(Image.open(work / "gpu" / name), np.int16)
        d = np.abs(a - b)
        rec[name] = dict(shape=list(a.shape), mean_abs=float(d.mean()),
                         max_abs=int(d.max()))
        ok = ok and a.shape == b.shape and d.mean() <= REF_MEAN_TOL \
            and d.max() <= REF_MAX_TOL
    rec["tol"] = f"mean <= {REF_MEAN_TOL}, max <= {REF_MAX_TOL} uint8 levels"
    return rec, ok, gpu


def phase_reference(seed: int):
    """process() at a small width on the card (bf16, K1 at 1024 tokens)
    against the same run on the CPU in fp32, with the same weights and the
    same noise. Cache off, so no threshold decision can flip between the two
    precisions. Passes when the PNGs agree to REF_MEAN_TOL mean and
    REF_MAX_TOL max uint8 levels."""
    rec, ok, gpu = _card_vs_cpu(seed, _small_cfgs(),
                                dict(min_size=128, edm_steps=4, img_threshold=0.0),
                                ("sr3_lr.png", "lr_final_0.png"))
    ok = ok and rec["k1_launches"] > 0
    # the same step functions replayed as graphs and called directly, at
    # this width: 64^2 latents put the 32^2 level's attention on K1
    rec["graphs"] = _graph_vs_direct(
        gpu, seed, sr3_steps=8, sr3_size=16, latent=64, ddim=True,
        edm_cases=(("mixed", 8, 0.3, 1.0), ("misses", 4, 0.3, 0.0),
                   ("hits", 4, 1e9, 1.0)))
    rec["graph_tol"] = (f"max |graph - direct| <= {GRAPH_TOL} * max(1, "
                        "max |direct|); ids and traces equal")
    rec["ok"] = bool(ok and rec["graphs"]["ok"])
    _say("reference", **rec)
    return rec


def phase_tiled_reference(seed: int):
    """The tiled VAE at a small width, card (bf16) against CPU (fp32):
    process() with use_tile_vae on a VAE with three downsamples (the
    stitch's factor 8), a 32^2 tile: Stage 1 at 128^2 and a 128^2
    refinement cut into 48-pixel encoder tiles (3 x 3, overlapping) and
    10-latent decoder tiles (2 x 2, overlapping), GroupNorm statistics
    pooled over the tiles; the final PNG (128^2) within the reference
    phase's tolerance."""
    from rsvldm_tpu_torch.models.vae.model import VAEConfig
    vae = VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
    rec, ok, gpu = _card_vs_cpu(
        seed, _small_cfgs(vae),
        dict(min_size=128, edm_steps=4, img_threshold=0.0, use_tile_vae=True,
             encoder_tile_size=48, decoder_tile_size=10), ("lr_final_0.png",),
        lr_side=32)
    rec["tiles_used"] = gpu._use_tiles((128, 128))
    rec["finite"] = all(gpu.outputs_finite.values())
    rec["ok"] = bool(ok and rec["tiles_used"] and rec["finite"])
    _say("reference", tiled_vae=rec)
    return rec


def _acts_quantized_alike(x):
    """Whether `quantize_acts` and `quantize_acts_grouped` give the card the
    CPU's int8 codes and fp32 scales, bit for bit, for x (CPU, bf16 values)
    and for rows whose amax is where a multiply by 1/127 differs from the
    division by 127 in fp32 (the quantizers divide exactly on both)."""
    import numpy as np
    import torch
    from rsvldm_tpu_torch.ops import quant
    a = (np.arange(1, 1 << 15, dtype=np.uint32) << 16).view(np.float32)
    a = a[np.isfinite(a) & (a > 1e-3) & (a < 1e3)]
    bad = a[(a * np.float32(1 / 127)) != (a / np.float32(127))][:128]
    rows = torch.rand((len(bad), x.shape[-1]), generator=torch.Generator()
                      .manual_seed(len(bad))) * 2 - 1
    rows = rows * torch.from_numpy(bad)[:, None]
    rows[:, 5] = torch.from_numpy(bad)
    x = torch.cat([x.float(), rows]).to(torch.bfloat16)
    same = {}
    for name, fn in (("quantize_acts", quant.quantize_acts),
                     ("quantize_acts_grouped",
                      lambda t: quant.quantize_acts_grouped(t, 128))):
        (qc, sc), (qg, sg) = fn(x), fn(x.cuda())
        same[name] = bool(torch.equal(qc, qg.cpu()) and torch.equal(sc, sg.cpu()))
    return dict(rows=x.shape[0], reciprocal_rows=len(bad), **same)


def _small_captioners(quant: str):
    """The small-width captioner on the CPU (fp32) and on the card (bf16):
    dense weights rounded to bf16 so that both sides quantize the same
    values to the same bytes. (captioners by device, llama config, vision
    config, tokenizer, whether the quantized bytes are equal)."""
    import torch
    from rsvldm_tpu_torch.models.vlm.captioner import (NEWLINE_KEY,
                                                       PROJECTOR_PREFIX,
                                                       VISION_PREFIX,
                                                       LlavaCaptioner)
    from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
    from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
    # K2's conditions (dim and ffn multiples of 256, group 128) and D = 128
    lcfg = LlamaConfig(vocab_size=128256, dim=512, layers=2, heads=4,
                       kv_heads=2, ffn_dim=1024)
    vcfg = CLIPVisionConfig(width=64, layers=2, heads=1)
    tok = StandInTokenizer()
    dense = LlavaCaptioner.seeded(lcfg, vcfg, tok, device="cpu",
                                  dtype=torch.float32)
    sd = {**dense.llama.state_dict(),
          **{VISION_PREFIX + k: v for k, v in dense.vision.state_dict().items()},
          **{PROJECTOR_PREFIX + k: v
             for k, v in dense.projector.state_dict().items()},
          NEWLINE_KEY: dense.image_newline}
    sd = {k: v.to(torch.bfloat16).float() for k, v in sd.items()}
    caps = {dev: LlavaCaptioner.from_state_dict(
        sd, lcfg, vcfg, tok, quant=quant, device=dev,
        dtype=torch.float32 if dev == "cpu" else torch.bfloat16)
        for dev in ("cpu", "cuda")}
    same_bytes = all(
        torch.equal(v.cpu(), caps["cpu"].llama.state_dict()[k])
        for k, v in caps["cuda"].llama.state_dict().items()
        if v.dtype == torch.int8)
    return caps, lcfg, vcfg, tok, same_bytes


def phase_caption_reference(seed: int, quant: str, steps: int = 8):
    """A small-width caption on the card (bf16) against the same captioner
    on the CPU (fp32): dense weights rounded to bf16 so that both sides
    quantize the same values to the same bytes, the same 224^2 image and
    prompt; the prefill (1280 tokens: K1) then `steps` decode steps (R = 1:
    K2 for int4) fed the CPU's greedy tokens on both sides."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import REFERENCE_IMG_PROMPT
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.ops.quant import int4_matmul

    caps, lcfg, vcfg, tok, same_bytes = _small_captioners(quant)
    rng = np.random.default_rng(seed + 2)
    img = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
    prompt = gen.llama3_chat_prompt(
        REFERENCE_IMG_PROMPT.format(DEFAULT_IMAGE_TOKEN="<image>"))
    encode = lambda t: tok.encode(t)
    toks = None
    logits = {}
    for dev in ("cpu", "cuda"):
        cap = caps[dev]
        flash_attention.launches = int4_matmul.launches = 0
        with torch.inference_mode():
            emb = gen.embed_multimodal_prompt(
                cap.llama, cap.vision, cap.projector, prompt, [img], encode,
                cap.image_newline, vcfg.image_size)
            s = emb.shape[0]
            s_pad = -(-s // 128) * 128
            cache = KVCache.init(lcfg, 1, s_pad + steps + 1,
                                 dtype=cap.llama.dtype, device=dev)
            lg, cache = cap.llama(
                torch.nn.functional.pad(emb, (0, 0, 0, s_pad - s))[None],
                cache, 0)
            rows = [lg[0, s - 1]]
            if toks is None:
                toks = [int(rows[0].argmax())]
            for i in range(steps):
                e = cap.llama.embed(torch.tensor([[toks[i]]], device=dev))
                lg, cache = cap.llama(e, cache, s + i)
                rows.append(lg[0, -1])
                if dev == "cpu":
                    toks.append(int(lg[0, -1].argmax()))
        torch.cuda.synchronize()
        logits[dev] = torch.stack(rows).float().cpu()
        if dev == "cpu":
            acts = _acts_quantized_alike(emb)
        launches = dict(k1=flash_attention.launches, k2=int4_matmul.launches)
    # the decode replayed as a CUDA graph against direct calls, on the card
    graphs = _decode_vs_direct(caps["cuda"].llama, emb, 40)
    a, b = logits["cpu"], logits["cuda"]
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    top1 = (a.argmax(-1) == b.argmax(-1)).float()
    rec = dict(quant=quant, prompt_len=s, padded_len=s_pad, steps=steps,
               cos=[round(float(c), 6) for c in cos],
               top1=[int(t) for t in top1], same_quantized_bytes=same_bytes,
               same_activation_codes=acts,
               card_launches=launches, graphs=graphs,
               tol=f"cos >= {CAP_COS_MIN} every step, top-1 agreement >= "
                   f"{CAP_TOP1_MIN}; graph ids equal to direct ids")
    rec["ok"] = bool(same_bytes and s_pad >= 1024
                     and acts["quantize_acts"] and acts["quantize_acts_grouped"]
                     and launches["k1"] == lcfg.layers
                     and (quant != "int4"
                          or launches["k2"] == steps * (7 * lcfg.layers + 1))
                     and float(cos.min()) >= CAP_COS_MIN
                     and float(top1.mean()) >= CAP_TOP1_MIN
                     and graphs["ok"]
                     # the decode steps and the prefill's lm_head
                     and (quant != "int4" or graphs["k2_launches"]
                          == graphs["steps"] * (7 * lcfg.layers + 1) + 1))
    flash_attention.launches = int4_matmul.launches = 0
    _say("reference", **rec)
    return rec


def phase_batch_caption_reference(seed: int, quant: str = "int4",
                                  steps: int = 8):
    """The batched caption (folder mode) at the small width, card (bf16)
    against CPU (fp32): three images of different shapes spliced into the
    prompt (ragged lengths), one batched prefill from 0 with the lm_head
    on each row's last real position, then `steps` decode steps of all
    three rows at their own positions, fed the CPU's greedy tokens on both
    sides. Per row: the logit cosine every step and the top-1 agreement,
    held to the single caption's limits."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import REFERENCE_IMG_PROMPT
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.ops.quant import int4_matmul

    caps, lcfg, vcfg, tok, same_bytes = _small_captioners(quant)
    rng = np.random.default_rng(seed + 3)
    imgs = [Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
            for h, w in ((224, 224), (168, 280), (300, 200))]
    prompt = gen.llama3_chat_prompt(
        REFERENCE_IMG_PROMPT.format(DEFAULT_IMAGE_TOKEN="<image>"))
    toks, logits = None, {}
    for dev in ("cpu", "cuda"):
        cap = caps[dev]
        flash_attention.launches = int4_matmul.launches = 0
        with torch.inference_mode():
            embs = [gen.embed_multimodal_prompt(
                cap.llama, cap.vision, cap.projector, prompt, [img],
                tok.encode, cap.image_newline, vcfg.image_size) for img in imgs]
            lens = [e.shape[0] for e in embs]
            s_pad = -(-max(lens) // 128) * 128
            cache = KVCache.init(lcfg, len(embs), s_pad + steps + 1,
                                 dtype=cap.llama.dtype, device=dev)
            x = torch.stack([torch.nn.functional.pad(e, (0, 0, 0, s_pad - len(e)))
                             for e in embs])
            at = torch.tensor(lens, device=dev)
            lg, cache = cap.llama(x, cache, 0, logits_at=at - 1)
            rows = [lg[:, 0]]
            if toks is None:
                toks = [rows[0].argmax(-1).cpu()]
            for i in range(steps):
                e = cap.llama.embed(toks[i].to(dev)[:, None])
                lg, cache = cap.llama(e, cache, at + i)
                rows.append(lg[:, -1])
                if dev == "cpu":
                    toks.append(lg[:, -1].argmax(-1))
        torch.cuda.synchronize()
        logits[dev] = torch.stack(rows).float().cpu()  # [steps+1, B, vocab]
        launches = dict(k1=flash_attention.launches, k2=int4_matmul.launches)
    a, b = logits["cpu"], logits["cuda"]
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)  # [steps+1, B]
    top1 = (a.argmax(-1) == b.argmax(-1)).float()
    rec = dict(quant=quant, rows=len(imgs), prompt_lens=lens, padded_len=s_pad,
               steps=steps, cos=[[round(float(c), 6) for c in r] for r in cos.T],
               top1=[[int(t) for t in r] for r in top1.T],
               same_quantized_bytes=same_bytes, card_launches=launches,
               tol=f"per row: cos >= {CAP_COS_MIN} every step, top-1 "
                   f"agreement >= {CAP_TOP1_MIN}")
    rec["ok"] = bool(same_bytes and s_pad >= 1024 and len(set(lens)) == 3
                     and launches["k1"] == lcfg.layers
                     and (quant != "int4" or launches["k2"]
                          == steps * (7 * lcfg.layers + 1) + 1)
                     and float(cos.min()) >= CAP_COS_MIN
                     and float(top1.mean(0).min()) >= CAP_TOP1_MIN)
    flash_attention.launches = int4_matmul.launches = 0
    _say("reference", batched_caption=rec)
    return rec


def _spec_round_ms(cap, draft, prompt_len: int, rounds: int = 10) -> dict:
    """Device time of a speculative round by replaying the kept sampled
    loop of `draft` `rounds` times (CUDA events; before each, its position
    and index are set back to the first round's, so every block stays
    inside the caches and tables) and the K2 launches a round counted
    through those replays; and the decode rate that round time would give
    were every proposal kept (k + 1 tokens a round: reckoned, not run)."""
    import torch
    from rsvldm_tpu_torch.models.vlm.speculative import SpecState
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    # the loop's key: ("spec", bucket, max_new, k, greedy, ..., id(draft))
    st = next(v for key, v in cap.decode_graphs.items()
              if isinstance(v, SpecState) and key[-1] == id(draft) and not key[4])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = int4_matmul.launches
        start.record()
        for _ in range(rounds):
            st.p.fill_(prompt_len)
            st.j0.fill_(1)
            st.runner()
        end.record()
        torch.cuda.synchronize()
    k2 = int4_matmul.launches - before
    int4_matmul.launches = before  # timing launches are not the path's
    ms = start.elapsed_time(end) / rounds
    return dict(ms_per_round=ms, k2_per_round=k2 / rounds,
                tok_s_if_all_kept=(SPEC_K + 1) * 1e3 / ms,
                replayed=st.runner.graph is not None)


def _accept_card_vs_cpu(seed: int, vocab: int = 64, cases: int = 12) -> dict:
    """accept_and_correct on the card against the CPU on the same seeded
    distributions (fp32, k = SPEC_K): in case c the draft's first c % (k+1)
    distributions are the target's (kept whatever the uniform), so every
    count of kept proposals 0..k occurs, the bonus token at k. The same
    committed tokens and counts."""
    import torch
    from rsvldm_tpu_torch.models.vlm.speculative import accept_and_correct
    g = torch.Generator().manual_seed(seed + 8)
    k, same, counts = SPEC_K, True, []
    for c in range(cases):
        t = torch.softmax(torch.randn(k + 1, vocab, generator=g) * 2, -1)
        d = torch.softmax(torch.randn(k, vocab, generator=g) * 2, -1)
        m = c % (k + 1)
        d[:m] = t[:m]
        toks = torch.stack([torch.multinomial(d[i], 1, generator=g)[0]
                            for i in range(k)])
        u = torch.rand(k, generator=g)
        res = -torch.log(-torch.log(torch.rand(k, vocab, generator=g)))
        bonus = -torch.log(-torch.log(torch.rand(vocab, generator=g)))
        args = (toks, d, t, u, res, bonus)
        want = accept_and_correct(*args)
        got = accept_and_correct(*(a.cuda() for a in args))
        same = same and all(torch.equal(x.cpu(), y) for x, y in zip(got, want))
        counts.append(int(want[1]))
    return dict(cases=cases, n_commit=counts, equal=bool(same),
                ok=bool(same and k + 1 in counts and 1 in counts))


def phase_spec_reference(seed: int, new_tokens: int = 40):
    """Speculative decoding at the small width on the card (int4, k = 4):
    with the bf16 captioner and a 1280-token prompt, greedy ids with a
    one-layer self-draft, and with the target as its own draft (every
    proposal kept, a bonus token each round), equal greedy `generate` ids
    on the card; every round after the first replayed from its graph; K1
    launches the target's layers plus the draft's (the prefills), K2
    k (7n + 1) + 7n + 7L + 1 a round plus the prefill's lm_head. Then
    sampled (T = 0.8) with the target as its own draft, in fp32 on a
    96-token prompt and fed the Gumbel rows of the `generate` run: its ids,
    and every proposal kept. And accept_and_correct on the card equals the
    CPU's (_accept_card_vs_cpu)."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import REFERENCE_IMG_PROMPT
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.speculative import (default_accept_noise,
                                                         self_draft,
                                                         speculative_generate)

    caps, lcfg, vcfg, tok, _ = _small_captioners("int4")
    cap = caps["cuda"]
    rng = np.random.default_rng(seed + 4)
    img = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
    prompt = gen.llama3_chat_prompt(
        REFERENCE_IMG_PROMPT.format(DEFAULT_IMAGE_TOKEN="<image>"))
    gcfg = gen.GenerateConfig(max_new_tokens=new_tokens, do_sample=False)
    L = lcfg.layers

    def run(draft, n, emb, cfg, **kw):
        st: dict = {}
        _reset_counts()
        ids = speculative_generate(cap.llama, draft, emb, cfg, SPEC_K,
                                   stats=st, **kw)
        c = _counts()
        _reset_counts()
        rec = dict(rounds=st["rounds"], replays=st["replays"],
                   accept_rate=st["accept_rate"], tokens=len(ids),
                   k1_launches=c["k1"], k2_launches=c["k2"])
        rec["replayed"] = bool(st["rounds"] >= 2
                               and st["replays"] == st["rounds"] - 1)
        return rec, ids

    with torch.inference_mode():
        emb = gen.embed_multimodal_prompt(
            cap.llama, cap.vision, cap.projector, prompt, [img], tok.encode,
            cap.image_newline, vcfg.image_size)
        ids_v = gen.generate(cap.llama, emb, gcfg)
        rec: dict = dict(new_tokens=new_tokens, prompt_len=int(emb.shape[0]))
        for name, draft, n in (("self_draft", self_draft(cap.llama, 1), 1),
                               ("draft_is_target", cap.llama, L)):
            r, ids_s = run(draft, n, emb, gcfg)
            r.update(ids=ids_s[:8].tolist(),
                     ids_equal=bool(np.array_equal(ids_v, ids_s)),
                     expected_k1=L + n,
                     expected_k2=1 + r["rounds"] * k2_per_round(n, SPEC_K, L))
            r["ok"] = bool(r["ids_equal"] and r["tokens"] == new_tokens
                           and r["replayed"]
                           and r["k1_launches"] == r["expected_k1"]
                           and r["k2_launches"] == r["expected_k2"])
            rec[name] = r
        rec["draft_is_target"]["ok"] = bool(rec["draft_is_target"]["ok"]
                                            and rec["draft_is_target"]["accept_rate"] == 1.0)
        # sampled, fp32: the 5-row verify then sums as the 1-row step does
        # to fp32 rounding, far below any acceptance uniform's resolution
        cap.llama.float()
        vocab = lcfg.vocab_size
        g = torch.Generator(device="cuda").manual_seed(seed + 5)
        toks = torch.randint(0, vocab, (96,), generator=g, device="cuda")
        emb32 = cap.llama.embed(toks)
        scfg = gen.GenerateConfig(max_new_tokens=new_tokens, temperature=0.8,
                                  do_sample=True)
        rows = gen.gumbel_noise(vocab, g, new_tokens + SPEC_K)(0)
        noise = lambda j: rows[j]
        ids_v32 = gen.generate(cap.llama, emb32, scfg, noise=noise)
        r, ids_s32 = run(cap.llama, L, emb32, scfg, noise=noise,
                         accept_noise=default_accept_noise(
                             vocab, torch.Generator(device="cuda").manual_seed(seed + 6)))
        r.update(ids=ids_s32[:8].tolist(), tokens_vanilla=len(ids_v32),
                 ids_equal=bool(np.array_equal(ids_v32, ids_s32)))
        r["ok"] = bool(r["ids_equal"] and r["replayed"]
                       and r["accept_rate"] == 1.0 and r["k1_launches"] == 0)
        rec["sampled_fp32_draft_is_target"] = r
    rec["accept_and_correct"] = _accept_card_vs_cpu(seed)
    rec["ok"] = bool(all(rec[k]["ok"] for k in (
        "self_draft", "draft_is_target", "sampled_fp32_draft_is_target",
        "accept_and_correct")))
    _say("reference", speculative=rec)
    return rec


# --------------------------------------------------------------- phase 5
CKPT_MARGIN = 1.1  # free space needed, as a multiple of the bytes written


def _split_even(sd, n: int):
    """sd's names in n consecutive groups of about equal bytes."""
    total = sum(t.numel() * t.element_size() for t in sd.values())
    groups, acc = [[] for _ in range(n)], 0
    for k, t in sd.items():
        groups[min(n - 1, acc * n // total)].append(k)
        acc += t.numel() * t.element_size()
    return groups


def _pick_dir(need: int):
    """(a new directory on the first of TMPDIR and the checkout with `need`
    bytes free, the free bytes of each)."""
    import shutil
    free = {}
    for base in (Path(tempfile.gettempdir()), REPO):
        free[str(base)] = shutil.disk_usage(base).free
        if free[str(base)] >= need:
            return Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base)), free
    return None, free


def _write_ckpt_dir(cd: Path, pipe0, cap0, seed: int, prompt: str, texts):
    """The reference layout (tests/test_e2e_ckpt_roundtrip.py:182-217) from
    seeded full-width modules on the card, in bf16: SR3's .pth, the
    juggernaut safetensors (UNet, VAE without its twin encoder, both text
    towers), SR-v0Q.ckpt (GLVControl and the denoise_encoder), the LLaVA
    state dict in four safetensors shards with a tokenizer.json, a
    Llava-next PEFT adapter (r=8, alpha=16 on q_proj and v_proj of every
    layer) and clip_vocab. Returns (bytes written, the adapter's sampled
    expectations, tokenizer assets)."""
    import torch
    from rsvldm_tpu_torch.models.vlm.captioner import (NEWLINE_KEY,
                                                       PROJECTOR_PREFIX,
                                                       VISION_PREFIX)
    from rsvldm_tpu_torch.pipeline import CHECKPOINTS
    nbytes = 0
    cpu = lambda sd: {k: v.cpu() for k, v in sd.items()}
    name, _ = CHECKPOINTS["sr3"]
    torch.save(cpu(pipe0.sr3.state_dict()), cd / name[0])
    jug_name, srq_name = CHECKPOINTS["unet"][0]
    jug, srq = {}, {}
    for fam in ("unet", "vae", "clip_l", "big_g", "control"):
        prefix = CHECKPOINTS[fam][1]
        for k, v in getattr(pipe0, fam).state_dict().items():
            dst = srq if fam == "control" or k.startswith("denoise_encoder.") else jug
            dst[f"{prefix}.{k}"] = v
    nbytes += write_safetensors(cd / jug_name, jug, {"format": "pt"})
    torch.save({"state_dict": cpu(srq)}, cd / srq_name)
    del jug, srq
    sd = dict(cap0.llama.state_dict())
    sd.update({VISION_PREFIX + k: v for k, v in cap0.vision.state_dict().items()})
    sd.update({PROJECTOR_PREFIX + k: v for k, v in cap0.projector.state_dict().items()})
    sd[NEWLINE_KEY] = cap0.image_newline
    (cd / "llava").mkdir()
    for i, keys in enumerate(_split_even(sd, 4)):
        nbytes += write_safetensors(cd / "llava" / f"model-{i + 1:05d}-of-00004.safetensors",
                                    {k: sd[k] for k in keys}, {"format": "pt"})
    llama_assets = Llama3Assets([prompt], seed=seed)
    llama_assets.write(cd / "llava")
    # the PEFT adapter; the expected merge of a few layers in fp32 on the CPU
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    adapter, expect, r, alpha = {}, {}, 8, 16
    n_layers = cap0.llama.cfg.layers
    for i in range(n_layers):
        for proj in ("q_proj", "v_proj"):
            w = sd[f"model.layers.{i}.self_attn.{proj}.weight"]
            a = (torch.randn(r, w.shape[1], generator=gen, device="cuda")
                 / w.shape[1] ** 0.5).to(torch.bfloat16)
            b = (torch.randn(w.shape[0], r, generator=gen, device="cuda")
                 * 0.02).to(torch.bfloat16)
            key = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            adapter[f"{key}.lora_A.weight"], adapter[f"{key}.lora_B.weight"] = a, b
            if i in (0, n_layers // 2, n_layers - 1):
                f32 = lambda t: t.float().cpu().numpy()
                merged = f32(w) + (alpha / r) * (f32(b) @ f32(a))
                expect[(i, proj)] = (torch.from_numpy(merged).to(torch.bfloat16),
                                     w.cpu())
    (cd / "Llava-next").mkdir()
    nbytes += write_safetensors(cd / "Llava-next" / "adapter_model.safetensors",
                                adapter, {"format": "pt"})
    (cd / "Llava-next" / "adapter_config.json").write_text(json.dumps(
        {"peft_type": "LORA", "r": r, "lora_alpha": alpha,
         "target_modules": ["q_proj", "v_proj"]}))
    clip_assets = ClipAssets(texts, seed=seed)
    clip_assets.write(cd / "clip_vocab")
    total = sum(f.stat().st_size for f in cd.rglob("*") if f.is_file())
    return total, expect, llama_assets, clip_assets


def _sd_digest(sd) -> str:
    """A digest of every byte of a state dict, computed on the card: per
    tensor, the position-weighted sum of its bytes in chunks."""
    import hashlib
    import torch
    h = hashlib.sha1()
    for name, t in sorted(sd.items()):
        flat = t.detach().contiguous().view(-1).view(torch.uint8)
        total = 0
        for i, chunk in enumerate(flat.split(1 << 26)):
            pos = torch.arange(1, chunk.numel() + 1, device=chunk.device,
                               dtype=torch.int64)
            total += int((chunk.to(torch.int64) * pos).sum()) * (i + 1)
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}:{total};".encode())
    return h.hexdigest()


def _family_digests(pipe, cap) -> dict:
    """Per family, a digest of what the checkpoint holds unchanged after the
    load: every parameter of the six pipeline families, and of the
    captioner the tower, projector, image_newline, embedding and norms (its
    projections are int4 after the load)."""
    out = {fam: _sd_digest(getattr(pipe, fam).state_dict())
           for fam in ("sr3", "unet", "control", "vae", "clip_l", "big_g")}
    out["llava_vision"] = _sd_digest(cap.vision.state_dict())
    out["llava_projector"] = _sd_digest(cap.projector.state_dict())
    out["llava_newline"] = _sd_digest({"n": cap.image_newline})
    out["llava_embed_norms"] = _sd_digest(
        {k: v for k, v in cap.llama.state_dict().items()
         if "norm" in k or "embed_tokens" in k})
    return out


def _decode_launches(llama, lora=None, pos: int = 1300):
    """Device kernels launched by one int4 decode step (position `pos` of a
    1536-slot cache, a device tensor as in the caption's loop), with and
    without a runtime LoRA, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    kv = KVCache.init(llama.cfg, 1, 1536, dtype=llama.dtype, device="cuda")
    tok = torch.tensor([[1000]], device="cuda")
    at = torch.tensor(pos, device="cuda")
    with torch.inference_mode():
        step = lambda: llama(llama.embed(tok), kv, at, lora=lora)[0]
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type == DeviceType.CUDA)


def phase_path(seed: int):
    """Full-width seeded modules written as the reference checkpoint
    directory, then the pipeline built from that directory alone through
    the CLI's own construction (infer.build_pipeline --quant int4), its
    weights and tokens checked against what was written, then process().
    Returns (record, pipeline, the directory): the caller deletes the
    directory after phase `folder` has read it."""
    import shutil
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch import infer
    from rsvldm_tpu_torch.config import (LlavaConfig, PipelineConfig,
                                         RefinementConfig)
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.generate import llama3_chat_prompt
    from rsvldm_tpu_torch.ops.quant import quantize_weight_int4
    from rsvldm_tpu_torch.pipeline import SuperResolutionPipeline
    from rsvldm_tpu_torch.training.vlm_trainer import (LoraConfig, init_lora,
                                                       save_lora_npz)

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    rng = np.random.default_rng(seed)
    lr = (rng.random((28, 28, 3)) * 255).astype(np.uint8)
    Image.fromarray(lr).save(work / "lr.png")
    refine = RefinementConfig()
    prompt = llama3_chat_prompt(LlavaConfig().img_prompt.format(
        DEFAULT_IMAGE_TOKEN="<image>"))
    # the modules to write: the full-width geometries with seeded bf16
    # weights (a directory with no files), LLaVA-NeXT-8B dense
    t0 = time.perf_counter()
    pipe0 = SuperResolutionPipeline(PipelineConfig(ckpt_dir=str(work / "none"),
                                                   no_llava=True), device="cuda")
    pipe0.ensure_stage2()
    cap0 = LlavaCaptioner.seeded(tokenizer=StandInTokenizer(), device="cuda",
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    mods = [getattr(pipe0, f) for f in ("sr3", "unet", "control", "vae", "clip_l",
                                        "big_g")] + [cap0.llama, cap0.vision, cap0.projector]
    need = sum(t.numel() * t.element_size() for m in mods
               for t in m.state_dict().values())
    # the adapter: r=8 on q_proj and v_proj of each layer, bf16
    lc = cap0.llama.cfg
    need += lc.layers * 8 * (3 * lc.dim + lc.kv_heads * lc.head_dim) * 2
    cd, free = _pick_dir(int(need * CKPT_MARGIN))
    rec = dict(ckpt_bytes_reckoned=need, free_bytes=free, seed_s=seed_s)
    if cd is None:
        rec.update(ok=False, error=f"no directory with {need * CKPT_MARGIN / 1e9:.1f} "
                   "GB free for the checkpoint directory")
        _say("path", **rec)
        return rec, None, None
    try:
        digests_written = _family_digests(pipe0, cap0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_bytes, expect, llama_assets, clip_assets = _write_ckpt_dir(
            cd, pipe0, cap0, seed, prompt, [refine.a_prompt, refine.n_prompt])
        write_s = time.perf_counter() - t0
        del pipe0, cap0, mods
        torch.cuda.empty_cache()

        # the pipeline as a user builds it: the CLI's construction, the
        # directory alone (no state dicts, no captioner)
        args = infer.parse_args([
            "--input_img", str(work / "lr.png"), "--output_dir", str(work / "out"),
            "--seed", str(seed), "--ckpt_dir", str(cd), "--quant", "int4"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = infer.build_pipeline(args)
        pipe.ensure_stage2()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cap = pipe.llava
        load_peak = torch.cuda.max_memory_allocated() / 2**30
        sources = pipe.weight_sources
        from_files = all(isinstance(sources.get(f), list) and sources[f]
                         for f in ("sr3", "unet", "control", "vae", "clip_l", "big_g"))
        digests = _family_digests(pipe, cap) if cap is not None else {}
        digests_equal = {k: digests.get(k) == v for k, v in digests_written.items()}
        peft = {}
        for (i, proj), (merged, plain) in expect.items():
            mod = getattr(cap.llama.model.layers[i].self_attn, proj)
            q = quantize_weight_int4(merged.cuda().t(), 128)
            q0 = quantize_weight_int4(plain.cuda().t(), 128)
            peft[f"{i}.{proj}"] = bool(torch.equal(q.packed, mod.kernel_q4)
                                       and torch.equal(q.scale, mod.scale)
                                       and not torch.equal(q0.packed, mod.kernel_q4))
        chunks = prompt.split("<image>")
        llama_ids_equal = all(cap.tokenizer.encode(c) == llama_assets.encode(c)
                              for c in chunks)
        clip_ids_equal = all(
            [pipe.tokenizer.sot, *pipe.tokenizer.encode(t), pipe.tokenizer.eot]
            == clip_assets.encode(t) for t in (refine.a_prompt, refine.n_prompt))
        ls = cap.load_stats
        load_s = dict(pipe.load_s, llava_split={k: ls[k] for k in (
            "open_s", "merge_s", "read_s", "quantize_s")})
        read_s = sum(v for k, v in pipe.load_s.items())
        torch.cuda.reset_peak_memory_stats()

        _reset_counts()
        t0 = time.perf_counter()
        pipe.process()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = _counts()
        launches, k2_launches = counts["k1"], counts["k2"]
        cs = pipe.caption_stats
        capture_s = dict(pipe.capture_s)
        process_peak = torch.cuda.max_memory_allocated() / 2**30

        # the loops' steps replayed as graphs against direct calls at full
        # width: 16 decode steps, 10 SR3 steps, a denoiser's miss steps
        # (the rest graph) and hit steps (the update graph)
        sr_img = Image.open(work / "out" / "sr3_lr.png").convert("RGB")
        with torch.inference_mode():
            emb = gen.embed_multimodal_prompt(
                cap.llama, cap.vision, cap.projector, prompt, [sr_img],
                lambda t: cap.tokenizer.encode(t, add_special_tokens=False),
                cap.image_newline, cap.vision.cfg.image_size)
        graphs = _graph_vs_direct(pipe, seed, sr3_steps=10, sr3_size=224,
                                  latent=128,
                                  edm_cases=(("miss", 3, 0.3, 0.0),
                                             ("hit", 3, 1e9, 1.0)))
        graphs["decode"] = _decode_vs_direct(cap.llama, emb, 17)
        graphs["ok"] = graphs["ok"] and graphs["decode"]["ok"]
        del emb

        # Stage 1 as DDIM at full width (the config's 50 steps)
        pipe.cfg.stage1.sampler = "ddim"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_stage1(str(work / "lr.png"))
        torch.cuda.synchronize()
        ddim = dict(steps=pipe.cfg.stage1.ddim_steps, eta=pipe.cfg.stage1.ddim_eta,
                    seconds=time.perf_counter() - t0,
                    capture_s=pipe.capture_s["stage1"],
                    finite=pipe.outputs_finite["stage1"])
        pipe.cfg.stage1.sampler = "ddpm"

        # one decode step's kernel launches, then with a train_vlm LoRA
        # archive (r=16 on the seven projections of every layer) attached
        # as the int4 decoder's runtime branch
        lora = init_lora(cap.llama, LoraConfig())
        for ab in lora.values():
            ab["b"].normal_(0.0, 0.01)
        save_lora_npz(lora, LoraConfig(), work / "lora.npz")
        decode_launches = _decode_launches(cap.llama)
        cap.attach_archives(lora_npz=work / "lora.npz")
        decode_launches_lora = _decode_launches(cap.llama, cap.lora)
        cap.lora = None
    except BaseException:
        shutil.rmtree(cd, ignore_errors=True)
        raise

    sr = np.asarray(Image.open(work / "out" / "sr3_lr.png"))
    fin = np.asarray(Image.open(work / "out" / "lr_final_0.png"))
    dfb = pipe.last_dfb
    n_params = sum(p.numel() for m in (pipe.sr3, pipe.unet, pipe.control,
                                       pipe.vae, pipe.clip_l, pipe.big_g)
                   for p in m.parameters())
    caption_bytes = sum(t.numel() * t.element_size()
                        for m in (cap.llama, cap.vision, cap.projector)
                        for t in [*m.parameters(), *m.buffers()])
    rec.update(
        ckpt_dir=str(cd), ckpt_bytes=ckpt_bytes, write_s=write_s,
        write_gbps=ckpt_bytes / write_s / 1e9,
        load_s=load_s, init_s=init_s,
        read_gbps=ckpt_bytes / read_s / 1e9,
        read_note="page cache warm: the files were written just before",
        load_peak_mem_gib=load_peak,
        weight_sources={k: [Path(p).name for p in v] if isinstance(v, list) else v
                        for k, v in sources.items()},
        digests_equal=digests_equal, peft_projections_equal=peft,
        peft_merged=ls.get("peft_merged"),
        llama_ids_equal=llama_ids_equal, clip_ids_equal=clip_ids_equal,
        process_s=total_s,
        stage_s=dict(pipe.timings), params=n_params,
        stage1_steps=pipe.cfg.stage1.steps,
        edm_steps=pipe.cfg.refine.edm_steps, dfb_hits=dfb["hits"],
        dfb_steps=dfb["steps"],
        dfb_trace="".join("H" if x else "." for x in dfb["trace"]),
        flash_fwd_launches=launches, int4_decode_launches=k2_launches,
        launches=counts,
        caption_weights_gib=caption_bytes / 2**30,
        caption_s=pipe.timings.get("caption", 0.0),
        prompt_len=cs.get("prompt_len"), padded_len=cs.get("padded_len"),
        prefill_s=cs.get("prefill_s", 0.0), decode_s=cs.get("decode_s", 0.0),
        decode_steps=cs.get("decode_steps"),
        decode_tok_s=cs["decode_steps"] / cs["decode_s"]
        if cs.get("decode_s") else None,
        decode_launches_per_step=decode_launches,
        decode_launches_per_step_lora=decode_launches_lora,
        caption_words=len(pipe.last_caption.split()),
        capture_s=capture_s, peak_mem_gib=process_peak,
        peak_mem_gib_with_checks=torch.cuda.max_memory_allocated() / 2**30,
        graphs=graphs, ddim_stage1=ddim,
        sr3_png=list(sr.shape), final_png=list(fin.shape),
        sr3_path=str(work / "out" / "sr3_lr.png"),
        outputs_finite=pipe.outputs_finite,
        sr3_std=float(sr.std()), final_std=float(fin.std()))
    misses = dfb["steps"] - dfb["hits"]
    rec["expected_launches"] = (misses * K1_PER_MISS + dfb["hits"] * K1_PER_HIT
                                + K1_PER_CAPTION)
    # the decode steps, and the prefill's lm_head on the last position
    rec["expected_k2_launches"] = K2_PER_STEP * (cs.get("decode_steps") or 0) + 1
    ok = bool(from_files and cap is not None
              and isinstance(sources.get("llava"), list)
              and all(digests_equal.values()) and len(peft) == 6
              and all(peft.values()) and ls.get("peft_merged") == 64
              and llama_ids_equal and clip_ids_equal
              and launches == rec["expected_launches"] > 0
              and k2_launches == rec["expected_k2_launches"] > 0
              and cs.get("padded_len", 0) >= 1024
              and sr.shape == (224, 224, 3)
              and fin.shape == (224, 224, 3)
              and all(pipe.outputs_finite.values())
              and sr.std() > 0 and fin.std() > 0
              and graphs["ok"] and ddim["finite"])
    rec["ok"] = ok
    _say("path", **rec)
    return rec, pipe, cd


# -------------------------------------------------------------- phase 5s
def _write_draft_dir(dd: Path, cfg, seed: int) -> int:
    """A seeded Llama draft checkpoint (`cfg`, weights of its own seed, not
    the target's) as a user has one: config.json and one safetensors file
    of HF-named bf16 tensors. Returns the bytes written."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import LlamaModel
    from rsvldm_tpu_torch.utils.weights import seeded_init_
    with torch.device("meta"):
        draft = LlamaModel(cfg)
    draft = draft.to(torch.bfloat16).to_empty(device="cuda")
    seeded_init_(draft, f"llama_draft_{seed}", torch.device("cuda"))
    dd.mkdir()
    (dd / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "hidden_size": cfg.dim,
        "intermediate_size": cfg.ffn_dim, "num_hidden_layers": cfg.layers,
        "num_attention_heads": cfg.heads, "num_key_value_heads": cfg.kv_heads,
        "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16"}))
    n = write_safetensors(dd / "model.safetensors", draft.state_dict(),
                          {"format": "pt"})
    del draft
    torch.cuda.empty_cache()
    return n


def _spec_run(cap, emb, gcfg, draft=None, n_layers: int = 0) -> dict:
    """One caption decode of the spliced prompt `emb`: vanilla
    (generate) without a draft, else speculative rounds with it (k =
    SPEC_K). Seconds, tokens/s, rounds, acceptance, capture seconds,
    replays and K1 / K2 launches (counts reset just before, read just
    after: K1 is the target's prefill and the draft's, K2 the decode's),
    and the ids."""
    import torch
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.speculative import speculative_generate
    layers = cap.llama.cfg.layers
    st: dict = {}
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    if draft is None:
        ids = gen.generate(cap.llama, emb, gcfg, stats=st,
                           graph_cache=cap.decode_graphs)
    else:
        ids = speculative_generate(cap.llama, draft, emb, gcfg, SPEC_K,
                                   stats=st, graph_cache=cap.decode_graphs)
    torch.cuda.synchronize()
    n = _counts()
    rec = dict(caption_s=time.perf_counter() - t0, tokens=len(ids),
               prefill_s=st["prefill_s"], decode_s=st["decode_s"],
               capture_s=st["capture_s"], k1_launches=n["k1"],
               k2_launches=n["k2"], expected_k1=layers + n_layers)
    # tokens after the prefill's first one, over the decode's seconds
    rec["decode_tok_s"] = (len(ids) - 1) / st["decode_s"] if st["decode_s"] else None
    if draft is not None:
        rec.update({k: st[k] for k in ("rounds", "proposed", "accepted",
                                       "accept_rate", "replays")})
        rec["draft_layers"] = n_layers
        rec["k2_per_round_formula"] = k2_per_round(n_layers, layers=layers)
        rec["k2_launches_per_round"] = ((rec["k2_launches"] - 1) / st["rounds"]
                                        if st["rounds"] else None)
        rec["ok"] = bool(st["rounds"] >= 2 and st["replays"] == st["rounds"] - 1
                         and rec["k2_launches"] - 1
                         == st["rounds"] * rec["k2_per_round_formula"])
    else:
        rec["ok"] = rec["k2_launches"] == K2_PER_STEP * st["decode_steps"] + 1
    rec["ok"] = bool(rec["ok"] and rec["k1_launches"] == rec["expected_k1"])
    _reset_counts()
    return rec, ids


def _greedy_gap(cap, emb, ids_v, ids_s) -> dict:
    """The prefix on which two greedy id streams agree and, where they
    part, the target's logits there: its top-2 gap and the logits of the
    two streams' tokens."""
    import numpy as np
    import torch
    n = min(len(ids_v), len(ids_s))
    m = next((i for i in range(n) if ids_v[i] != ids_s[i]), n)
    rec = dict(agree_prefix=m, lengths=[len(ids_v), len(ids_s)],
               equal=bool(np.array_equal(ids_v, ids_s)))
    if m < n:
        with torch.inference_mode():
            prev = torch.tensor(ids_v[:m], device=emb.device, dtype=torch.long)
            x = torch.cat([emb, cap.llama.embed(prev).to(emb.dtype)])[None]
            lg, _ = cap.llama(x, None, 0, logits_at=torch.tensor(
                [x.shape[1] - 1], device=emb.device))
        lg = lg[0, 0].float()
        top = lg.topk(2).values
        rec.update(top2_gap=float(top[0] - top[1]),
                   logit_vanilla=float(lg[int(ids_v[m])]),
                   logit_spec=float(lg[int(ids_s[m])]))
    return rec


def phase_spec(seed: int, pipe, cd: Path, sr_path: str):
    """Speculative caption decoding at full width, on the path's int4
    captioner and its Stage-1 image: the 256-token caption at T = 0.2
    three ways (vanilla; the self-draft of the first SELF_DRAFT_LAYERS
    layers, k = SPEC_K; a seeded DRAFT_LAYERS-layer draft checkpoint of
    the target's width and vocabulary written to <cd>/llava_draft and read
    through the CLI's construction, infer.build_pipeline --draft_dir);
    per run the caption's seconds, decode tok/s, rounds, acceptance, ms a
    round by graph replay, capture seconds and K2 launches a round; then
    the same three greedy (T = 0): the prefix on which the speculative ids
    agree with the vanilla ones and the target's top-2 gap where they
    part (reported; a 5-row verify and a 1-row step sum in other orders).
    Then the target as its own draft (n = 32), sampled with the vanilla
    run's draws: the accept branch at full width, its acceptance, round
    time, and the prefix it shares with the vanilla ids (a report). Each
    draft's round time also gives the rate were every proposal kept.
    Fails if a round is not replayed from its graph, if K2's launches a
    round are not k (7n + 1) + 7n + 225, if K1's a run are not 32 + n (the
    two prefills), or if an output is not finite. The draft directory is
    deleted at the end."""
    import gc
    import shutil
    import torch
    from PIL import Image
    from rsvldm_tpu_torch import infer
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.speculative import self_draft

    cap = pipe.llava
    lcfg = pipe.cfg.llava
    img = Image.open(sr_path).convert("RGB")
    prompt = gen.llama3_chat_prompt(lcfg.img_prompt.format(
        DEFAULT_IMAGE_TOKEN="<image>"))
    with torch.inference_mode():
        emb = gen.embed_multimodal_prompt(
            cap.llama, cap.vision, cap.projector, prompt, [img],
            lambda t: cap.tokenizer.encode(t, add_special_tokens=False),
            cap.image_newline, cap.vision.cfg.image_size)
    sampled = gen.GenerateConfig(max_new_tokens=lcfg.max_new_tokens,
                                 temperature=lcfg.temperature,
                                 do_sample=lcfg.do_sample)
    greedy = dataclasses.replace(sampled, do_sample=False)
    dd = cd / "llava_draft"
    rec: dict = dict(spec_k=SPEC_K, prompt_len=int(emb.shape[0]))
    ids: dict = {}
    try:
        cap.attach_draft(None)  # no draft: the decode_graphs start empty
        rec["vanilla"], ids["vanilla_sampled"] = _spec_run(cap, emb, sampled)
        rec["vanilla_greedy"], ids["vanilla"] = _spec_run(cap, emb, greedy)
        sd = self_draft(cap.llama, SELF_DRAFT_LAYERS)
        rec["self_draft"], _ = _spec_run(cap, emb, sampled, sd, SELF_DRAFT_LAYERS)
        rec["self_draft"].update(_spec_round_ms(cap, sd, int(emb.shape[0])))
        rec["self_draft_greedy"], ids["self"] = _spec_run(
            cap, emb, greedy, sd, SELF_DRAFT_LAYERS)
        # the target as its own draft, sampled with the vanilla run's
        # default draws: the accept branch at full width (a report: bf16
        # 5-row and 1-row sums may part at near-ties)
        layers = cap.llama.cfg.layers
        rec["draft_is_target"], ids["target"] = _spec_run(
            cap, emb, sampled, cap.llama, layers)
        rec["draft_is_target"].update(
            _spec_round_ms(cap, cap.llama, int(emb.shape[0])),
            vs_vanilla_sampled=_greedy_gap(cap, emb, ids["vanilla_sampled"],
                                           ids["target"]))
        # the user's entry point too: caption() with the self-draft attached
        cap.attach_draft(None, spec_k=SPEC_K, self_draft_layers=SELF_DRAFT_LAYERS)
        text = cap.caption(img, lcfg)
        rec["self_draft_caption"] = dict(words=len(text.split()),
                                         rounds=cap.last_stats["rounds"],
                                         accept_rate=cap.last_stats["accept_rate"])
        cap.attach_draft(None)
        dcfg = dataclasses.replace(cap.llama.cfg, layers=DRAFT_LAYERS)
        t0 = time.perf_counter()
        rec["draft_ckpt_bytes"] = _write_draft_dir(dd, dcfg, seed)
        rec["draft_write_s"] = time.perf_counter() - t0
        args = infer.parse_args([
            "--input_img", sr_path, "--ckpt_dir", str(cd), "--quant", "int4",
            "--draft_dir", str(dd), "--seed", str(seed)])
        t0 = time.perf_counter()
        pipe2 = infer.build_pipeline(args)
        pipe2._load_llava()
        cap2 = pipe2.llava
        if cap2 is None:
            raise RuntimeError(f"the captioner of {cd} with --draft_dir {dd} "
                               "did not load")
        torch.cuda.synchronize()
        rec["draft_pipeline_load_s"] = time.perf_counter() - t0
        rec["draft_load_s"] = cap2.load_stats.get("draft_s")
        rec["draft_loaded"] = bool(cap2.draft is not None
                                   and cap2.draft.cfg.layers == DRAFT_LAYERS
                                   and cap2.self_draft_layers == 0)
        rec["draft_ckpt"], _ = _spec_run(cap2, emb, sampled, cap2.draft,
                                         DRAFT_LAYERS)
        rec["draft_ckpt"].update(_spec_round_ms(cap2, cap2.draft, int(emb.shape[0])))
        rec["draft_ckpt_greedy"], ids["ckpt"] = _spec_run(
            cap2, emb, greedy, cap2.draft, DRAFT_LAYERS)
        text2 = cap2.caption(img, lcfg)
        rec["draft_ckpt_caption"] = dict(words=len(text2.split()),
                                         rounds=cap2.last_stats["rounds"])
        rec["greedy_self_vs_vanilla"] = _greedy_gap(cap, emb, ids["vanilla"],
                                                    ids["self"])
        rec["greedy_ckpt_vs_vanilla"] = _greedy_gap(cap, emb, ids["vanilla"],
                                                    ids["ckpt"])
        del pipe2, cap2
    finally:
        shutil.rmtree(dd, ignore_errors=True)
        cap.attach_draft(None)
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("vanilla", "self_draft", "draft_ckpt", "draft_is_target"):
        rec[name]["vanilla_decode_tok_s"] = rec["vanilla"]["decode_tok_s"]
    runs = [v for v in rec.values() if isinstance(v, dict) and "ok" in v]
    rec["launches"] = {c: sum(r[f"{c}_launches"] for r in runs)
                       for c in ("k1", "k2")}
    rec["finite"] = bool(torch.isfinite(emb).all())
    rec["ok"] = bool(all(r["ok"] for r in runs) and len(runs) == 7
                     and rec["draft_loaded"] and rec["finite"]
                     and all(rec[n]["replayed"] for n in (
                         "self_draft", "draft_ckpt", "draft_is_target"))
                     and rec["self_draft"]["k2_per_round"]
                     == k2_per_round(SELF_DRAFT_LAYERS)
                     and rec["draft_ckpt"]["k2_per_round"]
                     == k2_per_round(DRAFT_LAYERS)
                     and rec["draft_is_target"]["k2_per_round"]
                     == k2_per_round(layers)
                     and rec["self_draft_caption"]["rounds"] > 0
                     and rec["draft_ckpt_caption"]["rounds"] > 0)
    _say("spec", **rec)
    return rec


# -------------------------------------------------------------- phase 5t
def _vae_alone(pipe, x, tiles: bool) -> dict:
    """The VAE preparation and the final decode alone on x [1, H, W, 3]
    (NHWC), tiled or whole: seconds and peak memory of each."""
    import torch
    from rsvldm_tpu_torch.pipeline import _nchw
    pipe.cfg.refine.use_tile_vae = tiles
    out = {}
    with torch.inference_mode():
        for name in ("vae_prep", "decode"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if name == "vae_prep":
                _, x_stage1, z = pipe._vae_prep(_nchw(x))
            else:
                y = pipe._decode(z)
            torch.cuda.synchronize()
            out[f"{name}_s"] = time.perf_counter() - t0
            out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            out[f"{name}_peak_above_gib"] = (torch.cuda.max_memory_allocated()
                                             - base) / 2**30
        out["finite"] = bool(torch.isfinite(x_stage1).all() and torch.isfinite(y).all())
        out["shapes"] = [list(x_stage1.shape), list(z.shape), list(y.shape)]
    del x_stage1, z, y
    torch.cuda.empty_cache()
    return out


def phase_tiled(seed: int, pipe, sr_path: str, caption: str):
    """The tiled VAE at full width on the path's pipeline: the 1024^2
    refinement of the path's Stage-1 image (the path's caption, the same
    seed's draws) without and with use_tile_vae at the default 512 / 64
    tile sizes (4 encoder tiles of 576^2, 4 decoder tiles of 86^2
    latent): vae_prep and decode seconds and the whole refinement's peak
    memory, and the VAE alone (seconds, peak) each way; the mean and max
    uint8 difference between the two images, both resized back to the
    Stage-1 image's size as process() writes them (a report: halos and
    pooled statistics make them differ). Then the tiled VAE preparation and
    decode alone at 2048^2 (16 tiles each): seconds and peak; the whole
    VAE is not run there, its mid-attention scores would be 65536^2 fp32
    (the reckoned bytes are printed). Fails unless each refinement
    launches K1 106 times a denoiser miss and 58 a hit (Stage 2b; the
    VAE's attention is plain) and K2 never."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.pipeline import TorchNoise

    r = pipe.cfg.refine
    img = Image.open(sr_path).convert("RGB")
    rec: dict = dict(encoder_tile=r.encoder_tile_size,
                     decoder_tile=r.decoder_tile_size)
    outs = {}
    try:
        for tiles in (False, True):
            name = "tiled" if tiles else "whole"
            r.use_tile_vae = tiles
            pipe.noise = TorchNoise(seed, pipe.device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            outs[name] = np.asarray(pipe.run_refinement(img, caption,
                                                        use_bucket=False), np.int16)
            torch.cuda.synchronize()
            n, dfb = _counts(), pipe.last_dfb
            _reset_counts()
            rec[name] = dict(refine_s=time.perf_counter() - t0,
                             k1_launches=n["k1"], k2_launches=n["k2"],
                             expected_k1=(dfb["steps"] - dfb["hits"]) * K1_PER_MISS
                             + dfb["hits"] * K1_PER_HIT,
                             vae_prep_s=pipe.timings["vae_prep"],
                             decode_s=pipe.timings["decode"],
                             sampling_s=pipe.timings["sampling"],
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                             finite=pipe.outputs_finite["refined"],
                             shape=list(outs[name].shape),
                             tiles_used=pipe._use_tiles((1024, 1024)))
        d = np.abs(outs["whole"] - outs["tiled"])
        rec["tiled_vs_whole_uint8"] = dict(mean_abs=float(d.mean()),
                                           max_abs=int(d.max()))
        g = torch.Generator(device=pipe.device).manual_seed(seed + 9)
        for side in (1024, 2048):
            x = torch.rand((1, side, side, 3), generator=g,
                           device=pipe.device) * 2 - 1
            for tiles in ((False, True) if side == 1024 else (True,)):
                rec[f"vae_alone_{side}_{'tiled' if tiles else 'whole'}"] = \
                    _vae_alone(pipe, x, tiles)
            del x
        lat = (2048 // 8) ** 2
        rec["whole_2048_mid_attention_scores_bytes"] = lat * lat * 4
    finally:
        r.use_tile_vae = False
        torch.cuda.empty_cache()
    alone = [v for k, v in rec.items() if k.startswith("vae_alone")]
    rec["launches"] = {c: rec["whole"][f"{c}_launches"] + rec["tiled"][f"{c}_launches"]
                       for c in ("k1", "k2")}
    # the refined image comes back at the Stage-1 image's size
    rec["ok"] = bool(rec["whole"]["finite"] and rec["tiled"]["finite"]
                     and all(rec[n]["k1_launches"] == rec[n]["expected_k1"] > 0
                             and rec[n]["k2_launches"] == 0
                             for n in ("whole", "tiled"))
                     and rec["tiled"]["tiles_used"]
                     and not rec["whole"]["tiles_used"]
                     and rec["tiled"]["shape"] == rec["whole"]["shape"]
                     == [img.size[1], img.size[0], 3]
                     and all(a["finite"] for a in alone)
                     and rec["vae_alone_2048_tiled"]["shapes"][2]
                     == [1, 3, 2048, 2048])
    _say("tiled", **rec)
    return rec


# -------------------------------------------------------------- phase 5b
FOLDER_TILES = (28, 28, 28, 32, 28, 28, 28, 28)  # LR tile sides: 7 + 1


def _batched_graphs_vs_direct(pipe, llama, seed: int, rows: int = 8,
                              steps: int = 16, sr3_steps: int = 10) -> dict:
    """Graph replay against direct calls at folder width: `steps` decode
    steps of a B = `rows` loop state (a seeded cache, ragged positions,
    T = 0.2 Gumbel draws), once through a StepRunner (direct, capture,
    replays) and once called directly from the same state: the same ids
    and K2 launches; then `sr3_steps` steps of the batched SR3 loop at 7 x
    224^2, replayed and direct."""
    import copy
    import torch
    from rsvldm_tpu_torch.models.sr3.diffusion import (SR3Diffusion,
                                                       sr3_sample)
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    from rsvldm_tpu_torch.utils.graphs import StepRunner
    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    cfg = gen.GenerateConfig(max_new_tokens=steps + 1)
    st0 = gen._decode_state(llama, cfg, 1408, dev, rows)
    for t in (st0.cache.k, st0.cache.v):
        t.copy_(torch.randn(t.shape, generator=g, device=dev))
    st0.pos.copy_(torch.arange(1300, 1300 + 12 * rows, 12, device=dev))
    st0.tok.copy_(torch.randint(0, 128000, (rows, 1), generator=g, device=dev))
    st0.noise.copy_(gen.gumbel_noise(llama.cfg.vocab_size, g, rows)(0)
                    .expand_as(st0.noise))
    st0.noise.add_(torch.randn(st0.noise.shape, generator=g, device=dev))
    st0.temp.fill_(0.2)
    ids, k2 = {}, {}
    with torch.inference_mode():
        for graphs in (True, False):
            st = copy.copy(st0)
            for f in ("tok", "pos", "idx", "done", "toks"):
                setattr(st, f, getattr(st0, f).clone())
            st.cache = gen.KVCache(st0.cache.k.clone(), st0.cache.v.clone())
            runner = StepRunner(lambda: gen.decode_step(llama, st, None), graphs)
            before = int4_matmul.launches
            for _ in range(steps):
                runner()
            torch.cuda.synchronize()
            k2[graphs] = int4_matmul.launches - before
            ids[graphs] = st.toks.cpu()
            del runner, st
    rec = dict(decode=dict(rows=rows, steps=steps, ids=ids[True][1:4].tolist(),
                           k2_launches=k2[True],
                           ok=bool(torch.equal(ids[True], ids[False])
                                   and k2[True] == k2[False]
                                   == steps * K2_PER_STEP)))
    s1 = pipe.cfg.stage1
    diff = SR3Diffusion.from_schedule(s1.schedule, sr3_steps, s1.linear_start,
                                      s1.linear_end)
    cond = torch.randn((7, 224, 224, 3), generator=g, device=dev).clamp(-1, 1)
    noise = torch.randn((sr3_steps + 1, 7, 224, 224, 3), generator=g,
                        device=dev)
    out = {m: sr3_sample(diff, pipe.sr3, cond, noise, graphs=m)
           for m in (True, False)}
    rec["sr3_batch7"] = dict(steps=sr3_steps, **_same(out[True], out[False]))
    rec["ok"] = rec["decode"]["ok"] and rec["sr3_batch7"]["ok"]
    return rec


def phase_folder(seed: int, cd: Path, process_s: float | None,
                 profile: bool = False):
    """Folder mode at full width, as a user runs it: the processor built
    by the folder CLI's own construction (infer_dir.build_processor,
    --quant int4) from the checkpoint directory phase `path` wrote, then
    ImageBatchProcessor.run() over 8 seeded LR tiles (seven 28^2 and one
    32^2: Stage-1 groups of 7 at 224^2 and 1 at 256^2; one batched int4
    caption of 8, 256 tokens at T = 0.2; all refine at 1024^2, two
    batched RestoreEDM loops of 4, the second replaying the first's kept
    graphs). Every status must be ok, no fallback taken, all 16 PNGs
    written, finite and not flat, the K1 and K2 launches those of the
    batches run; then graph replay against direct calls at this width."""
    import gc
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch import infer_dir

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_folder_"))
    (work / "lr").mkdir()
    rng = np.random.default_rng(seed + 5)
    for i, side in enumerate(FOLDER_TILES):
        Image.fromarray((rng.random((side, side, 3)) * 255).astype(np.uint8)
                        ).save(work / "lr" / f"tile_{i}.png")
    gc.collect()
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated() / 2**30
    args = infer_dir.parse_args([
        "--image_dir", str(work / "lr"), "--save_dir", str(work / "out"),
        "--seed", str(seed), "--ckpt_dir", str(cd), "--quant", "int4"])
    t0 = time.perf_counter()
    proc = infer_dir.build_processor(args)
    proc.pipe.ensure_stage2()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = proc.pipe
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    results = proc.run()
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30

    n = len(FOLDER_TILES)
    pngs, pngs_ok = {}, True
    for sub, pat in (("sr3_output", "sr3_tile_{}.png"),
                     ("output", "tile_{}_final_0.png")):
        for i, side in enumerate(FOLDER_TILES):
            f = work / "out" / sub / pat.format(i)
            a = np.asarray(Image.open(f)) if f.exists() else None
            pngs[f"{sub}/{f.name}"] = None if a is None else dict(
                shape=list(a.shape), std=round(float(a.std()), 3))
            pngs_ok = pngs_ok and a is not None and a.std() > 0 \
                and a.shape == (8 * side, 8 * side, 3)
    caps = proc.caption_batches
    chunks = proc.refine_chunks
    k1_want = K1_PER_CAPTION * len(caps) + sum(
        (c["steps"] - c["hits"]) * K1_PER_MISS + c["hits"] * K1_PER_HIT
        for c in chunks)
    # the decode steps, and the prefill's lm_head on the rows' last positions
    k2_want = sum(K2_PER_STEP * c["decode_steps"] + 1 for c in caps)
    decode = [dict(rows=c["rows"], prompt_lens=c["prompt_lens"],
                   padded_len=c["padded_len"], prefill_s=c["prefill_s"],
                   decode_s=c["decode_s"], decode_steps=c["decode_steps"],
                   tok_s_all_rows=c["rows"] * c["decode_steps"] / c["decode_s"],
                   tok_s_per_row=c["decode_steps"] / c["decode_s"],
                   capture_s=c["capture_s"], seconds=c["seconds"])
              for c in caps if c.get("decode_s")]
    kept = [k[0] if isinstance(k[0], str) else "restore_edm"
            for k in pipe.loop_graphs]
    cap0, cap1 = ([c["capture_s"] for c in chunks] + [{}, {}])[:2]
    rec = dict(
        tiles=list(FOLDER_TILES), init_s=init_s, statuses=dict(results),
        fallbacks=proc.fallbacks, timings=proc.timings,
        folder_s=proc.timings["folder"],
        s_per_image=proc.timings["folder"] / n,
        path_process_s=process_s,
        stage1_groups=pipe.stage1_groups, captions=decode,
        refine_chunks=chunks, launches=counts,
        expected_launches=dict(k1=k1_want, k2=k2_want),
        peak_mem_gib=peak, reserved_gib=reserved,
        held_before_gib=held_before,
        kept_loops=kept,
        kept_decode_states=len(pipe.llava.decode_graphs) if pipe.llava else 0,
        pngs=pngs, outputs_finite=pipe.outputs_finite,
        out_dir=str(work / "out"))
    ok = bool(all(s == "ok" for _, s in results) and len(results) == n
              and not proc.fallbacks and pngs_ok
              and all(pipe.outputs_finite.values())
              and [g["n"] for g in pipe.stage1_groups] == [7, 1]
              and [c["n"] for c in caps] == [8]
              and [c["n"] for c in chunks] == [4, 4]
              # the second chunk replays every graph the first captured
              and cap0.get("sampling_first", 0) > 0
              and all(cap1.get(k) == 0 for k, v in cap0.items() if v > 0)
              and counts["k1"] == k1_want > 0 and counts["k2"] == k2_want > 0)
    if profile and pipe.llava is not None:
        from rsvldm_tpu_torch.models.vlm import generate as gen
        llama = pipe.llava.llama
        st = gen._decode_state(llama, gen.GenerateConfig(max_new_tokens=128),
                               1408, pipe.device, rows=8)
        st.pos.fill_(1300)
        rec["profile"] = _profile_steps(
            {"decode_b8": lambda: gen.decode_step(llama, st, None)},
            {"decode_b8": "int4_decode_kernel"}, 10)
        del st
    rec["graphs"] = _batched_graphs_vs_direct(pipe, pipe.llava.llama, seed)
    rec["ok"] = bool(ok and rec["graphs"]["ok"])
    _say("folder", **rec)
    del proc, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------ the sgm sampler family
def _cfg_denoisers(den, cond, uc, scfg):
    """The closures the extra samplers take, over a ControlDenoiser with
    the pipeline's linear CFG (scfg.cfg_scale_start at sigma_max to
    scfg.cfg_scale at 0): `tile_fn(tiles, sigma, lq_tiles)` runs the
    uncond and cond halves of every tile as one batch of 2 x tiles, each
    tile's control its LQ crop; `whole_fn(x, sigma)` is it on the whole
    latent with cond's control. NHWC fp32 in and out; `calls` counts the
    denoiser's calls."""
    import torch
    from rsvldm_tpu_torch.diffusion.guidance import apply_cfg, linear_cfg_scale
    calls = [0]

    def both(k, n):
        return torch.cat([uc[k].expand(n, *uc[k].shape[1:]),
                          cond[k].expand(n, *cond[k].shape[1:])])

    def tile_fn(tiles, sigma, lq):
        calls[0] += 1
        n = tiles.shape[0]
        c2 = dict(crossattn=both("crossattn", n), vector=both("vector", n),
                  control=torch.cat([lq, lq]).permute(0, 3, 1, 2).float())
        out = den(torch.cat([tiles, tiles]).permute(0, 3, 1, 2),
                  sigma.expand(2 * n), c2)
        scale = linear_cfg_scale(sigma, scfg.cfg_scale_start, scfg.cfg_scale)
        return apply_cfg(out.float(), scale).permute(0, 2, 3, 1)

    def whole_fn(x, sigma):
        return tile_fn(x, sigma, cond["control"])

    return whole_fn, tile_fn, calls


def _paired_cond(pipe, z_lq, texts):
    """(cond, uc) of `texts` against the negative prompt over the control
    latent z_lq [N, 4, h, w], as the pipeline's refinement builds them."""
    from rsvldm_tpu_torch.models.text.conditioner import SDXLConditioner
    r = pipe.cfg.refine
    tl_c, tg_c = pipe._tokens(texts)
    tl_u, tg_u = pipe._tokens([r.n_prompt] * len(texts))
    return SDXLConditioner(pipe.clip_l, pipe.big_g).paired(
        tl_c, tg_c, tl_u, tg_u, z_lq.permute(0, 2, 3, 1))


class _RecordedDraws:
    """A Brownian-tree draw source that keeps what `src` drew, by key, so
    another device can replay the same normals (`replay(device)`)."""

    def __init__(self, src):
        self.src, self.seen = src, {}

    def __call__(self, level, index, shape):
        key = (level, index, tuple(shape))
        if key not in self.seen:
            self.seen[key] = self.src(level, index, shape)
        return self.seen[key]

    def replay(self, device):
        return lambda level, index, shape: self.seen[
            (level, index, tuple(shape))].to(device)


def _k1_per_call(fn, *args) -> int:
    """K1 launches of one direct call of a denoiser closure."""
    import torch
    before = _counts()["k1"]
    with torch.inference_mode():
        fn(*args)
    return _counts()["k1"] - before


# The tiled samplers at small width, the same weights, noise and draws on
# every run. The card in fp32 (the CPU's modules moved there, plain
# attention) against the CPU: the same arithmetic in another order; max
# |card - cpu| over the latent <= SAMPLER_FP32_TOL * max(1, max |cpu|); an
# H100 gave 4.4e-6-4.7e-6. bf16 moves one call of this random-weight
# denoiser with CFG 2% rms off fp32, and any change of a bf16 rounding
# (K1 for plain attention, or K1 with its softmax scale 10% off) moves the
# 3-step latents 2-3.5% rms: the bf16 run with K1 against the bf16 run
# with plain attention, rel rms <= SAMPLER_K1_TOL (an H100 read 2.3-3.0%),
# catches only a gross fault. K1 is held finely in the fp32 modules, where
# the sequences K1 takes go through K1 or the plain attention on q, k, v
# rounded to bf16: rel rms <= SAMPLER_K1_FP32_TOL (read 5.8e-4-7.7e-4),
# and K1 with its softmax scale K1_FAULT_SCALE times the true one must
# exceed it (read 1.2e-2-1.6e-2). The bf16 runs' decodes against the CPU's
# are reported.
SAMPLER_FP32_TOL = 1e-4
SAMPLER_K1_TOL = 6e-2
SAMPLER_K1_FP32_TOL = 4e-3
K1_FAULT_SCALE = 1.1
K1_RUNS = ("card_bf16", "card_fp32_k1", "card_fp32_fault")
# The single-window tiled DPM++(2M) against the untiled one on the card in
# fp32 (plain attention), the same noise and draws: they differ by (v * w)
# / w in the stitch, within an ulp a step; max |tiled - untiled| <=
# SINGLE_TILE_FP32_TOL * max(1, max |untiled|), as the CPU test's 1e-5.
SINGLE_TILE_FP32_TOL = 1e-5


def phase_samplers_reference(seed: int, steps: int = 3, tile: int = 64):
    """The tiled samplers at a small width, as a tiled refinement of a 24^2
    Stage-1 image at 192^2 (a 96^2 latent, 2 x 2 windows of 64 at stride
    32): tiled_restore_edm_sample (restore_cfg 4) and
    tiled_restore_dpmpp2m_sample, `steps` steps each, over the controlled
    denoiser with CFG. The same weights (rounded to bf16 values, so the
    card's bf16 modules hold the CPU's numbers), the CPU's conditioning,
    initial noise and Brownian draws (replayed on the card). Seven runs:
    the CPU in fp32; the card in fp32 with plain attention, its latents
    within SAMPLER_FP32_TOL of the CPU's; the card in bf16 with K1 and
    with plain attention, within SAMPLER_K1_TOL of each other; the card's
    fp32 modules with K1, with the plain attention and with a planted K1
    fault, each on q, k, v rounded to bf16: K1 within SAMPLER_K1_FP32_TOL
    of the plain attention, the fault beyond it. K1 launches equal to the
    calls times one call's where K1 runs, none elsewhere. Reported: the
    bf16 run's decodes against the CPU's, raw (192^2) and as process()
    writes them (colour-fixed, resized to 24^2). Then, on the card in fp32
    and in bf16 with K1, restore_dpmpp2m_sample on the whole latent
    against tiled_restore_dpmpp2m_sample with one window: in fp32 within
    SINGLE_TILE_FP32_TOL; in bf16 reported (what bf16 makes of the
    stitch's rounding)."""
    import copy
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import PipelineConfig
    from rsvldm_tpu_torch.diffusion import samplers_extra as S
    from rsvldm_tpu_torch.diffusion.samplers import RestoreEDMConfig
    from rsvldm_tpu_torch.diffusion.schedules import legacy_ddpm_sigmas
    from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser
    from rsvldm_tpu_torch.ops import attention
    from rsvldm_tpu_torch.ops.image import pil_to_array, to_uint8
    from rsvldm_tpu_torch.pipeline import SuperResolutionPipeline

    small = _small_cfgs()
    fams = ("sr3", "unet", "control", "vae", "clip_l", "big_g")
    mk = lambda dt: PipelineConfig(no_llava=True, params_dtype=dt, seed=seed,
                                   ckpt_dir=str(REPO / "no_checkpoint_here"))
    cpu = SuperResolutionPipeline(mk("fp32"), device="cpu", model_cfgs=small)
    cpu.ensure_stage2()
    with torch.no_grad():
        for f in fams:
            for t in getattr(cpu, f).state_dict().values():
                if t.is_floating_point():
                    t.copy_(t.bfloat16().float())
    gpu = SuperResolutionPipeline(mk("bf16"), device="cuda", model_cfgs=small,
                                  state_dicts={f: getattr(cpu, f).state_dict()
                                               for f in fams})
    gpu.ensure_stage2()
    mods32 = {f: copy.deepcopy(getattr(cpu, f)).to("cuda")
              for f in ("unet", "control", "vae")}
    rng = np.random.default_rng(seed + 21)
    lat = tile + tile // 2
    side0 = 2 * lat // 8  # the Stage-1 size, 8x below the refinement
    x, h0, w0 = pil_to_array(Image.fromarray(rng.integers(
        0, 256, (side0, side0, 3), dtype=np.uint8)), upscale=1, min_size=2 * lat)
    with torch.inference_mode():
        z_lq = cpu.vae.encode_with_denoise(
            torch.from_numpy(x).permute(2, 0, 1)[None])  # the small VAE's factor 2
        cond, uc = _paired_cond(cpu, z_lq, ["a seeded tile of fields"])
    noise = torch.from_numpy(rng.standard_normal((1, lat, lat, 4)).astype(np.float32))
    sigmas = legacy_ddpm_sigmas(steps)
    scfg = RestoreEDMConfig()
    draws = _RecordedDraws(S.CounterDraws(seed, "cpu"))
    wins = S.sliding_windows(lat, lat, tile, tile // 2)
    metas = [(x.shape[0], x.shape[1], h0, w0)]
    # run: (device, denoiser, VAE, attention): "k1" as the path routes it;
    # "plain" plain attention everywhere; "k1_bf16io" / "plain_bf16io" /
    # "fault_bf16io" the sequences K1 takes (>= FLASH_MIN_SEQ) through K1 /
    # the plain attention / K1 with its softmax scale K1_FAULT_SCALE times
    # the true one, on q, k, v rounded to bf16, the output back to fp32
    card32 = ControlDenoiser(unet=mods32["unet"], control_net=mods32["control"])
    runs = {"cpu": ("cpu", cpu.denoiser, cpu.vae, "k1"),
            "card_fp32": ("cuda", card32, mods32["vae"], "plain"),
            "card_bf16": ("cuda", gpu.denoiser, gpu.vae, "k1"),
            "card_bf16_plain": ("cuda", gpu.denoiser, gpu.vae, "plain"),
            "card_fp32_k1": ("cuda", card32, mods32["vae"], "k1_bf16io"),
            "card_fp32_plain": ("cuda", card32, mods32["vae"], "plain_bf16io"),
            "card_fp32_fault": ("cuda", card32, mods32["vae"], "fault_bf16io")}
    k1, plain_attn = attention.flash_attention, attention.plain_attention

    def bf16io(fn, mult=1.0):
        return lambda q, k, v, causal=False, scale=None: fn(
            q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=causal,
            scale=(scale or q.shape[-1] ** -0.5) * mult).to(q.dtype)

    hooks = {"k1_bf16io": bf16io(k1), "plain_bf16io": bf16io(plain_attn),
             "fault_bf16io": bf16io(k1, K1_FAULT_SCALE)}
    out: dict = {}
    rel_rms = lambda a, b: float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())
    for run, (dev, den, vae, mode) in runs.items():
        dt = den.unet.dtype
        to = lambda d: {k: v.to(dev, dt if k == "crossattn" else v.dtype)
                        for k, v in d.items()}
        whole_fn, tile_fn, calls = _cfg_denoisers(den, to(cond), to(uc), scfg)
        lq = cond["control"].float().to(dev)
        res: dict = {}
        flash_min = attention.FLASH_MIN_SEQ
        if mode == "plain":
            attention.FLASH_MIN_SEQ = 1 << 30
        attention.flash_attention = hooks.get(mode, k1)
        try:
            with torch.inference_mode():
                x_stage1 = vae.decode(z_lq.to(dev, dt)).float().permute(0, 2, 3, 1)
                for name in ("tiled_restore_edm", "tiled_restore_dpmpp2m"):
                    calls[0] = 0
                    _reset_counts()
                    t0 = time.perf_counter()
                    if name == "tiled_restore_edm":
                        z = S.tiled_restore_edm_sample(
                            tile_fn, noise.to(dev), sigmas, lq, lq, tile=tile,
                            stride=tile // 2, restore_cfg=4.0)
                    else:
                        z = S.tiled_restore_dpmpp2m_sample(
                            tile_fn, noise.to(dev), sigmas, lq,
                            draws if dev == "cpu" else draws.replay(dev),
                            tile=tile, stride=tile // 2)
                    samples = vae.decode(z.permute(0, 3, 1, 2).to(dt)).float()
                    samples = samples.permute(0, 2, 3, 1)
                    res[name] = dict(
                        z=z.float().cpu(), calls=calls[0], k1=_counts()["k1"],
                        seconds=time.perf_counter() - t0,
                        finite=bool(torch.isfinite(samples).all()),
                        raw=to_uint8(samples[0].cpu().numpy()),
                        png=np.asarray(cpu._finish(samples.cpu(), x_stage1.cpu(),
                                                   metas)[0]))
                if run in ("card_fp32", "card_bf16"):
                    sig = torch.tensor(float(sigmas[0]), device=dev)
                    res["k1_per_call"] = _k1_per_call(
                        tile_fn, S.tile_slices(noise.to(dev), wins), sig,
                        S.tile_slices(lq, wins))
                    res["k1_per_whole_call"] = _k1_per_call(whole_fn, noise.to(dev), sig)
                    calls[0] = 0
                    _reset_counts()
                    untiled = S.restore_dpmpp2m_sample(
                        whole_fn, noise.to(dev), sigmas, S.CounterDraws(seed, dev))
                    one = S.tiled_restore_dpmpp2m_sample(
                        tile_fn, noise.to(dev), sigmas, lq, S.CounterDraws(seed, dev),
                        tile=lat, stride=lat)
                    diff = (one - untiled).abs()
                    res["single_window"] = dict(
                        max_abs=float(diff.max()), mean_abs=float(diff.mean()),
                        max_abs_untiled=float(untiled.abs().max()),
                        bit_equal=bool(torch.equal(one, untiled)),
                        calls=calls[0], k1=_counts()["k1"])
        finally:
            attention.FLASH_MIN_SEQ = flash_min
            attention.flash_attention = k1
        out[run] = res
    sw32, sw16 = out["card_fp32"]["single_window"], out["card_bf16"]["single_window"]
    rec: dict = dict(steps=steps, latent=lat, tile=tile, windows=len(wins),
                     stage1_side=side0, k1_per_call=out["card_bf16"]["k1_per_call"],
                     k1_per_whole_call=out["card_bf16"]["k1_per_whole_call"],
                     single_window_fp32=sw32, single_window_bf16=sw16,
                     tol=f"card fp32 latents: max <= {SAMPLER_FP32_TOL} * max(1, "
                     f"max |cpu|); K1 against plain attention: rel rms <= "
                     f"{SAMPLER_K1_TOL} in bf16, <= {SAMPLER_K1_FP32_TOL} in fp32 "
                     f"modules (K1 at scale x {K1_FAULT_SCALE}: above); single "
                     f"window in fp32: max <= {SINGLE_TILE_FP32_TOL} * max(1, max "
                     "|untiled|)")
    ok = bool(rec["windows"] == 4 and rec["k1_per_call"] > 0
              and out["card_fp32"]["k1_per_call"] == 0
              and sw32["max_abs"] <= SINGLE_TILE_FP32_TOL * max(1.0, sw32["max_abs_untiled"])
              and sw32["calls"] == sw16["calls"] == 2 * steps and sw32["k1"] == 0
              and sw16["k1"] == 2 * steps * rec["k1_per_whole_call"])
    launches = sw16["k1"]
    for name in ("tiled_restore_edm", "tiled_restore_dpmpp2m"):
        r = {run: res[name] for run, res in out.items()}
        a, b = r["cpu"], r["card_bf16"]
        zdiff = float((r["card_fp32"]["z"] - a["z"]).abs().max())
        d = np.abs(a["png"].astype(np.int16) - b["png"].astype(np.int16))
        raw = np.abs(a["raw"].astype(np.int16) - b["raw"].astype(np.int16))
        want = steps * rec["k1_per_call"]
        rec[name] = dict(
            fp32_latent_max_abs=zdiff, latent_max_abs_cpu=float(a["z"].abs().max()),
            fp32_latent_rel_rms=rel_rms(r["card_fp32"]["z"], a["z"]),
            k1_vs_plain_rel_rms=rel_rms(b["z"], r["card_bf16_plain"]["z"]),
            k1_vs_plain_fp32_rel_rms=rel_rms(r["card_fp32_k1"]["z"],
                                             r["card_fp32_plain"]["z"]),
            fault_vs_plain_fp32_rel_rms=rel_rms(r["card_fp32_fault"]["z"],
                                                r["card_fp32_plain"]["z"]),
            bf16_latent_rel_rms=rel_rms(b["z"], a["z"]),
            bf16_plain_latent_rel_rms=rel_rms(r["card_bf16_plain"]["z"], a["z"]),
            png_shape=list(b["png"].shape), mean_abs=float(d.mean()),
            max_abs=int(d.max()), raw_mean_abs=float(raw.mean()),
            raw_max_abs=int(raw.max()), calls=b["calls"], k1_launches=b["k1"],
            k1_reckoned=want, card_s=b["seconds"], cpu_s=a["seconds"],
            finite=all(v["finite"] for v in r.values()),
            raw_std=float(b["raw"].std()))
        launches += b["k1"]
        m = rec[name]
        ok = ok and bool(zdiff <= SAMPLER_FP32_TOL * max(1.0, m["latent_max_abs_cpu"])
                         and m["k1_vs_plain_rel_rms"] <= SAMPLER_K1_TOL
                         and m["k1_vs_plain_fp32_rel_rms"] <= SAMPLER_K1_FP32_TOL
                         < m["fault_vs_plain_fp32_rel_rms"]
                         and a["png"].shape == b["png"].shape == (side0, side0, 3)
                         and all(v["calls"] == steps for v in r.values())
                         and all(v["k1"] == (want if run in K1_RUNS else 0)
                                 for run, v in r.items())
                         and m["finite"] and b["raw"].std() > 0)
    rec["launches"] = dict(k1=launches, k2=0, bwd=0)
    rec["ok"] = bool(ok)
    _say("reference", samplers_reference=rec)
    return rec


SAMPLER_STEPS, TILED_STEPS = 10, 20
# The single-window tiled DPM++(2M) against the untiled one, both on the
# card in bf16 with the same noise and Brownian draws: they differ only by
# (v * w) / w in the stitch, within an ulp a step, which can move a bf16
# rounding inside the denoiser. Max |tiled - untiled| <= SINGLE_TILE_TOL *
# max(1, max |untiled|). The stitch itself is held to 1e-5 in fp32 by
# `samplers_reference`; here the untiled run from noise one fp32 ulp away
# shows what bf16 makes of such a rounding at full width (reported).
SINGLE_TILE_TOL = 5e-2


def phase_samplers(seed: int, pipe, sr_path: str, caption: str):
    """The sgm sampler family at full width on the path's pipeline: the
    controlled XL-base denoiser with CFG over the path tile's conditioning
    (its caption and the negative prompt, the control latent of its 1024^2
    Stage-1 image). On the 128^2 latent, SAMPLER_STEPS LegacyDDPM steps of
    EDM (churn 5), Heun, Euler-ancestral, DPM++(2S)-ancestral, DPM++(2M),
    linear multistep, RestoreDPMPP2M, and EDM over the 4-step substep
    sigmas; on a 192^2 latent (the control latent resized; a 1536^2 image:
    4 windows of 128 at stride 64), TILED_STEPS steps of both tiled
    samplers. Each: steps, denoiser calls against the count the sigma
    table implies (Heun skips its correction at the last sigma, DPM++(2S)
    takes the Euler branch where sigma_down <= 1e-14), K1 launches against
    K1_PER_MISS a call, seconds a step, finite output, peak memory. Then
    the tiled DPM++(2M) with one window over the 128^2 latent against the
    untiled run's latent (SINGLE_TILE_TOL), and, reported beside it, the
    untiled run from noise one fp32 ulp away against the untiled run."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from PIL import Image
    from rsvldm_tpu_torch.diffusion import samplers_extra as S
    from rsvldm_tpu_torch.diffusion.samplers import RestoreEDMConfig
    from rsvldm_tpu_torch.diffusion.schedules import legacy_ddpm_sigmas
    from rsvldm_tpu_torch.ops.image import pil_to_array

    dev = pipe.device
    r = pipe.cfg.refine
    x, _, _ = pil_to_array(Image.open(sr_path).convert("RGB"), upscale=1,
                           min_size=r.min_size)
    with torch.inference_mode():
        z_lq = pipe.vae.encode_with_denoise(
            torch.from_numpy(x).permute(2, 0, 1)[None].to(dev, pipe.dtype))
        cond, uc = _paired_cond(pipe, z_lq, [" ".join([caption, r.a_prompt])])
    whole_fn, tile_fn, calls = _cfg_denoisers(pipe.denoiser, cond, uc,
                                              RestoreEDMConfig())
    lat = cond["control"].shape[1]
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    noise, eps = rnd(1, lat, lat, 4), rnd(SAMPLER_STEPS, 1, lat, lat, 4)
    big = 3 * lat // 2
    lq_big = F.interpolate(cond["control"].float().permute(0, 3, 1, 2), size=(big, big),
                           mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    noise_big = rnd(1, big, big, 4)
    sig = legacy_ddpm_sigmas(SAMPLER_STEPS)
    sig_t = legacy_ddpm_sigmas(TILED_STEPS)
    host = sig.numpy()
    n = SAMPLER_STEPS
    heun = n + int((host[1:] > 0).sum())
    dpm2s = n + sum(int(S.get_ancestral_step(a, b)[0] > 1e-14)
                    for a, b in zip(host[:-1], host[1:]))
    cases = {
        "edm": (n, n, lambda: S.edm_sample(whole_fn, noise, sig, eps, s_churn=5.0,
                                           s_noise=1.003)),
        "heun": (n, heun, lambda: S.edm_sample(whole_fn, noise, sig, heun=True)),
        "euler_ancestral": (n, n, lambda: S.euler_ancestral_sample(
            whole_fn, noise, sig, eps)),
        "dpmpp2s_ancestral": (n, dpm2s, lambda: S.dpmpp2s_ancestral_sample(
            whole_fn, noise, sig, eps)),
        "dpmpp2m": (n, n, lambda: S.dpmpp2m_sample(whole_fn, noise, sig)),
        "linear_multistep": (n, n, lambda: S.linear_multistep_sample(
            whole_fn, noise, sig)),
        "substep": (4, 4, lambda: S.edm_sample(whole_fn, noise, S.substep_sigmas(4))),
        "restore_dpmpp2m": (n, n, lambda: S.restore_dpmpp2m_sample(
            whole_fn, noise, sig, S.CounterDraws(seed, dev))),
        "tiled_restore_edm": (TILED_STEPS, TILED_STEPS, lambda: S.tiled_restore_edm_sample(
            tile_fn, noise_big, sig_t, lq_big, lq_big, restore_cfg=4.0)),
        "tiled_restore_dpmpp2m": (TILED_STEPS, TILED_STEPS,
                                  lambda: S.tiled_restore_dpmpp2m_sample(
                                      tile_fn, noise_big, sig_t, lq_big,
                                      S.CounterDraws(seed, dev))),
    }
    rec: dict = dict(latent=lat, tiled_latent=big,
                     windows=len(S.sliding_windows(big, big, 128, 64)),
                     k1_per_call=_k1_per_call(whole_fn, noise,
                                              torch.tensor(float(sig[0]), device=dev)))
    ok = rec["windows"] == 4 and rec["k1_per_call"] == K1_PER_MISS
    launches, outs = 0, {}
    for name, (steps, want_calls, run) in cases.items():
        calls[0] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            z = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1 = _counts()["k1"]
        launches += k1
        outs[name] = z
        rec[name] = dict(steps=steps, calls=calls[0], calls_reckoned=want_calls,
                         k1_launches=k1, k1_reckoned=want_calls * K1_PER_MISS,
                         s_per_step=secs / steps, seconds=secs,
                         finite=bool(torch.isfinite(z).all()),
                         std=float(z.std()), shape=list(z.shape),
                         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        ok = ok and bool(calls[0] == want_calls and k1 == want_calls * K1_PER_MISS
                         and rec[name]["finite"] and rec[name]["std"] > 0)
    calls[0] = 0
    _reset_counts()
    with torch.inference_mode():
        one = S.tiled_restore_dpmpp2m_sample(tile_fn, noise, sig, cond["control"].float(),
                                             S.CounterDraws(seed, dev), tile=lat,
                                             stride=lat)
    one_calls, one_k1 = calls[0], _counts()["k1"]
    calls[0] = 0
    _reset_counts()
    with torch.inference_mode():
        ulp = S.restore_dpmpp2m_sample(whole_fn, torch.nextafter(noise, noise + 1), sig,
                                       S.CounterDraws(seed, dev))
    ulp_calls, ulp_k1 = calls[0], _counts()["k1"]
    launches += one_k1 + ulp_k1
    ref = outs["restore_dpmpp2m"]
    diff, udiff = (one - ref).abs(), (ulp - ref).abs()
    scale = max(1.0, float(ref.abs().max()))
    rec["single_window_vs_untiled"] = dict(
        max_abs=float(diff.max()), mean_abs=float(diff.mean()),
        max_abs_untiled=float(ref.abs().max()), bit_equal=bool(torch.equal(one, ref)),
        calls=one_calls, tol=f"max <= {SINGLE_TILE_TOL} * max(1, max |untiled|)")
    rec["one_ulp_noise_vs_untiled"] = dict(max_abs=float(udiff.max()),
                                           mean_abs=float(udiff.mean()), calls=ulp_calls)
    ok = ok and bool(float(diff.max()) <= SINGLE_TILE_TOL * scale
                     and one_calls == ulp_calls == n
                     and one_k1 == ulp_k1 == n * K1_PER_MISS)
    rec["launches"] = dict(k1=launches, k2=0, bwd=0)
    rec["ok"] = bool(ok)
    _say("samplers", **rec)
    del outs, one, ref, ulp
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------ quality evaluation
# The card's per-image metrics against the CPU's on the same files: both
# fp32 (TF32 off on the card), so they differ by summation order through
# the 24-layer tower and VGG16; absolute, on every metric (PSNR in dB). An
# H100 read at most 9.8e-7-2.1e-6. The same run with TF32 on must move a
# metric beyond it (`tf32_vs_fp32`: CLIP-IQA 3.4e-4, SMS 2.9e-5, LPIPS
# 7.5e-6 on an H100).
EVAL_TOL = 2e-5
EVAL_KEYS = ["num_images", "CLIP-IQA", "SMS", "PSNR", "SSIM", "LPIPS"]


def _write_eval_assets(d: Path, seed: int) -> int:
    """Seeded quality-harness assets as a user has them: a full-width CLIP
    ViT-L/14 at 224 (openai clip-vit-large-patch14's geometry: vision 24 x
    1024, 16 heads, patch 14; text 12 x 768, 12 heads; projection 768) in
    HF CLIPModel names, fp32, with config.json; a seeded CLIP vocabulary
    (clip_vocab/); VGG16's features in torchvision names and the LPIPS
    heads. Returns the bytes written."""
    import torch
    from rsvldm_tpu_torch.models.text.clip import CLIPTextConfig, CLIPTextTransformer
    from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig, CLIPVisionEmbedder
    from rsvldm_tpu_torch.utils.lpips import LPIPS
    from rsvldm_tpu_torch.utils.metrics import CLIPScorer
    from rsvldm_tpu_torch.utils.weights import init_params_

    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    with torch.device("cuda"):
        vision = CLIPVisionEmbedder(CLIPVisionConfig(
            image_size=224, patch_size=14, width=1024, layers=24, heads=16), 768)
        text = CLIPTextTransformer(CLIPTextConfig(
            vocab_size=49408, width=768, layers=12, heads=12,
            use_text_projection=True, projection_dim=768))
        lp = LPIPS()
    for m in (vision, text, lp):
        init_params_(m, gen)
    (d / "clip").mkdir(parents=True)
    n = write_safetensors(d / "clip" / "model.safetensors",
                          {**vision.state_dict(), **text.state_dict(),
                           "logit_scale": torch.tensor(4.6052)})
    (d / "clip" / "config.json").write_text(json.dumps({
        "projection_dim": 768,
        "vision_config": {"hidden_size": 1024, "num_hidden_layers": 24,
                          "num_attention_heads": 16, "patch_size": 14,
                          "image_size": 224},
        "text_config": {"hidden_size": 768, "num_hidden_layers": 12,
                        "num_attention_heads": 12}}))
    ClipAssets(list(CLIPScorer.GOOD_BAD)).write(d / "clip_vocab")
    (d / "lpips").mkdir()
    sd = {k: v.cpu() for k, v in lp.state_dict().items()}
    torch.save({k: v for k, v in sd.items() if k.startswith("features.")},
               d / "lpips" / "vgg16.pth")
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")},
               d / "lpips" / "lpips_vgg.pth")
    del vision, text, lp
    torch.cuda.empty_cache()
    return n + sum(f.stat().st_size for f in (d / "lpips").iterdir())


def _eval_cli(sr_dir, hr_dir, ckpt, out, device: str | None = None):
    """`python -m rsvldm_tpu_torch.eval_dir` in a subprocess: (its JSON
    line, its --out records, seconds, return code, the end of stderr)."""
    cmd = [sys.executable, "-m", "rsvldm_tpu_torch.eval_dir", "--sr_dir", str(sr_dir),
           "--hr_dir", str(hr_dir), "--ckpt_dir", str(ckpt), "--out", str(out)]
    if device:
        cmd += ["--device", device]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    line = None
    if res.returncode == 0 and res.stdout.strip():
        line = json.loads(res.stdout.strip().splitlines()[-1])
    recs = json.loads(Path(out).read_text())["images"] if Path(out).exists() else []
    return line, recs, secs, res.returncode, res.stderr[-2000:]


def phase_eval(seed: int, out_dir: Path):
    """The quality harness as a user runs it, over phase folder's 8 final
    PNGs (seven 224^2, one 256^2): seeded full-width CLIP ViT-L/14 and
    LPIPS-VGG assets (`_write_eval_assets`), HR images from
    data.prepare_triplets (seeded sources named as the tiles, centre-cropped
    to 224^2; the 256^2 output is resized to that grid), then `python -m
    rsvldm_tpu_torch.eval_dir` on the card: its JSON line (JAX's keys),
    the aggregate per metric, seconds. In process on the card: seconds an
    image through evaluate_dir, the CLIP tower's and LPIPS's ms an image at
    the HR size, peak memory, K1 launches (none: the tower's 257 tokens
    take the plain attention). Then the same CLI with --device cpu on two
    of the images (a 224^2 one and the resized one): each per-image metric
    of the card within EVAL_TOL of the CPU's; the in-process run again
    with TF32 on moves some metric beyond EVAL_TOL."""
    import shutil
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.data.prepare import prepare_triplets
    from rsvldm_tpu_torch.eval.quality import build_clip_scorer, evaluate_dir
    from rsvldm_tpu_torch.utils.metrics import load_lpips

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_"))
    try:
        t0 = time.perf_counter()
        ckpt_bytes = _write_eval_assets(work / "ckpt", seed)
        write_s = time.perf_counter() - t0
        sr_dir = Path(out_dir) / "output"
        srs = sorted(sr_dir.glob("*.png"))
        rng = np.random.default_rng(seed + 43)
        (work / "src").mkdir()
        for p in srs:
            stem = p.stem[:-len("_final_0")]
            Image.fromarray(rng.integers(0, 256, (300, 260, 3), dtype=np.uint8)
                            ).save(work / "src" / f"{stem}.png")
        prepare_triplets(str(work / "src"), str(work / "prep"), l_res=28, r_res=224)
        hr_dir = work / "prep" / "hr_224"

        line, card, cli_s, rc, err = _eval_cli(sr_dir, hr_dir, work / "ckpt",
                                               work / "card.json")
        rec: dict = dict(images=len(srs), ckpt_bytes=ckpt_bytes, write_s=write_s,
                         cli_rc=rc, cli_s=cli_s, cli_line=line,
                         cli_s_per_image=cli_s / max(1, len(srs)))
        if rc != 0:
            rec.update(ok=False, cli_stderr=err)
            _say("eval", **rec)
            return rec

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        scorer = build_clip_scorer(work / "ckpt", "cuda")
        lp = load_lpips(work / "ckpt", "cuda")
        _reset_counts()
        t0 = time.perf_counter()
        res = evaluate_dir(sr_dir, hr_dir, scorer=scorer, lpips=lp, device="cuda")
        torch.cuda.synchronize()
        rec["in_process_s_per_image"] = (time.perf_counter() - t0) / len(srs)
        rec["launches"] = _counts()
        # the same with TF32 on for the products and convolutions
        # (resolve_device, which turns it off, held back for this call)
        import rsvldm_tpu_torch.eval.quality as Q
        keep = Q.resolve_device
        Q.resolve_device = lambda d: torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            tf = evaluate_dir(sr_dir, hr_dir, scorer=scorer, lpips=lp, device="cuda")
        finally:
            Q.resolve_device = keep
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        rec["tf32_vs_fp32"] = {k: max(abs(a[k] - b[k]) for a, b in
                                      zip(tf["images"], res["images"]))
                               for k in EVAL_KEYS[1:]}
        x = torch.rand((1, 224, 224, 3), device="cuda")
        y = torch.rand((1, 224, 224, 3), device="cuda")
        with torch.inference_mode():
            rec["clip_tower_ms_per_image"] = _time_ms(lambda: scorer.vision_embed(x), 20)
            rec["lpips_ms_per_image"] = _time_ms(lambda: lp(x * 2 - 1, y * 2 - 1), 20)
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        anchor_ids = scorer.tokenizer(list(scorer.GOOD_BAD), pad_id=0)
        rec["anchor_ids_equal"] = all(
            list(row[:len(want)]) == want
            for row, want in zip(anchor_ids, (ClipAssets(list(scorer.GOOD_BAD)).encode(t)
                                              for t in scorer.GOOD_BAD)))
        del scorer, lp
        torch.cuda.empty_cache()

        # the CPU on two of the images: a 224^2 one and the resized one
        two = sorted({srs[0], *(p for p in srs if Image.open(p).size != (224, 224))})[:2]
        (work / "two").mkdir()
        for p in two:
            shutil.copy(p, work / "two" / p.name)
        cpu_line, cpu, cpu_s, cpu_rc, cpu_err = _eval_cli(
            work / "two", hr_dir, work / "ckpt", work / "cpu.json", "cpu")
        by_name = {r["image"]: r for r in card}
        diffs = {}
        for r in cpu:
            c = by_name.get(r["image"], {})
            diffs[r["image"]] = {k: abs(c[k] - r[k]) if k in c else None
                                 for k in EVAL_KEYS[1:] if k in r}
        worst = max((v for d in diffs.values() for v in d.values() if v is not None),
                    default=None)
        rec.update(cpu_rc=cpu_rc, cpu_s=cpu_s, cpu_images=[p.name for p in two],
                   card_vs_cpu=diffs, card_vs_cpu_max=worst,
                   tol=f"|card - cpu| <= {EVAL_TOL} per image and metric",
                   in_process_equals_cli={k: abs(res[k] - line[k])
                                          for k in EVAL_KEYS[1:]})
        if cpu_rc != 0:
            rec["cpu_stderr"] = cpu_err
        ok = bool(line is not None and list(line) == EVAL_KEYS
                  and line["num_images"] == len(srs) == 8
                  and all(np.isfinite(line[k]) for k in EVAL_KEYS)
                  and 0.0 <= line["CLIP-IQA"] <= 1.0
                  and all(len(r) == 6 for r in card)
                  and cpu_rc == 0 and len(cpu) == 2
                  and all(v is not None and v <= EVAL_TOL
                          for d in diffs.values() for v in d.values())
                  and max(rec["tf32_vs_fp32"].values()) > EVAL_TOL
                  and rec["anchor_ids_equal"] and rec["launches"]["k1"] == 0)
        rec["ok"] = ok
        _say("eval", **rec)
        return rec
    finally:
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------- phase 4b, 5c
# the small Gemma of phase_train_reference: Gemma-7B's knobs (heads of
# 256 that are not dim // heads, (1 + w) norms, the embedding scale, the
# tied head, tanh GELU) at 2 heads, so that K1 and the D=256 backward run
GEMMA_SMALL = dict(vocab_size=1024, dim=256, layers=2, heads=2, kv_heads=2,
                   ffn_dim=512, head_dim_cfg=256, norm_plus_one=True,
                   scale_embeds=True, tie_lm_head=True, act="gelu_tanh",
                   rms_eps=1e-6)
# the small decoder of phase_train_reference's "wide" family: heads of 512
# (q_proj 256 -> 2 x 512, GQA), so that the wide K1 and backward run
WIDE_SMALL = dict(vocab_size=1024, dim=256, layers=2, heads=2, kv_heads=1,
                  ffn_dim=512, head_dim_cfg=512)


def phase_train_reference(seed: int, quant: str, seq: int = 1024,
                          family: str = "llama"):
    """The three training losses at a small width with 128-wide heads and
    {seq} tokens (so K1 and the backward run), on the card in bf16 with
    remat against the CPU in fp32 without: the same weights (rounded to
    bf16 so both quantize the same values to the same bytes), adapters
    (nonzero B), projector and batch. `sft`: vlm_loss and the adapters'
    gradients; `mm`: mm_loss, the projector (fp32, as MMTrainer trains it)
    filling a zero span of each row, and the adapters' and the projector's
    gradients; `dpo`: dpo_loss over chosen / rejected rows and the adapters'
    gradients. Passes on each loss's relative error, every trainable
    leaf's gradient cosine and the launches each loss implies.
    family "gemma": `sft` alone on GEMMA_SMALL (the D=256 backward);
    "wide": `sft` alone on WIDE_SMALL (the wide kernels), quant None for
    the bf16 base phase wide_head trains."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import (LlamaConfig, LlamaModel,
                                                   quantize_llama_)
    from rsvldm_tpu_torch.models.vlm.projector import MLPProjector
    from rsvldm_tpu_torch.training import vlm_trainer as vt
    from rsvldm_tpu_torch.utils.weights import seeded_init_

    lcfg = (LlamaConfig(**GEMMA_SMALL) if family == "gemma" else
            LlamaConfig(**WIDE_SMALL) if family == "wide" else
            LlamaConfig(vocab_size=1024, dim=256, layers=2, heads=2,
                        kv_heads=1, ffn_dim=512))
    dense = seeded_init_(LlamaModel(lcfg), "llama", torch.device("cpu"))
    sd = {k: v.to(torch.bfloat16).float() for k, v in dense.state_dict().items()}
    gen = torch.Generator().manual_seed(seed + 5)
    b, t_img, dv = 2, 64, 64
    bf = lambda x: x.to(torch.bfloat16).float()
    emb = bf(torch.randn((b, seq, lcfg.dim), generator=gen) * 0.5)
    labels = torch.randint(0, lcfg.vocab_size, (b, seq), generator=gen)
    labels[:, : seq // 2] = vt.IGNORE_INDEX
    rejected = bf(torch.randn((b, seq, lcfg.dim), generator=gen) * 0.5)
    rej_labels = torch.randint(0, lcfg.vocab_size, (b, seq), generator=gen)
    rej_labels[:, : seq // 2 + 7] = vt.IGNORE_INDEX
    vis = bf(torch.randn((b, t_img, dv), generator=gen))
    pos = [100, 300]
    span = emb.clone()
    for row, p in enumerate(pos):
        span[row, p:p + t_img] = 0
    proj0 = seeded_init_(MLPProjector(dv, lcfg.dim), "projector",
                         torch.device("cpu"))
    cfg = vt.LoraConfig(r=16, alpha=16)
    models = {}
    for dev in ("cpu", "cuda"):
        m = LlamaModel(dataclasses.replace(lcfg, remat=dev == "cuda"))
        m.load_state_dict(sd)
        m = m.to(dev, torch.float32 if dev == "cpu" else torch.bfloat16)
        m.requires_grad_(False)
        models[dev] = quantize_llama_(m, quant) if quant else m
    lora0 = vt.init_lora(models["cpu"], cfg, torch.Generator().manual_seed(seed))
    for ab in lora0.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.01
    same_bytes = all(torch.equal(v.cpu(), models["cpu"].state_dict()[k])
                     for k, v in models["cuda"].state_dict().items()
                     if v.dtype == torch.int8)
    L = lcfg.layers
    # loss name -> (its function of (model, lora, projector, dtype, dev),
    # trains the projector, K1 launches, backward launches)
    cases = {
        "sft": (lambda m, lora, proj, dt, d: vt.vlm_loss(
            m, lora, cfg, emb.to(d, dt), labels.to(d)), False, 2 * L, L),
        "mm": (lambda m, lora, proj, dt, d: vt.mm_loss(
            m, lora, cfg, proj, vis.to(d, dt), span.to(d, dt), pos,
            labels.to(d)), True, 2 * L, L),
        "dpo": (lambda m, lora, proj, dt, d: vt.dpo_loss(
            m, lora, cfg, emb.to(d, dt), labels.to(d), rejected.to(d, dt),
            rej_labels.to(d), beta=DPO_BETA), False, 6 * L, 2 * L),
    }
    if family in ("gemma", "wide"):
        cases = {"sft": cases["sft"]}

    @torch.no_grad()
    def logprobs(m, lora, dt, d):
        """The four sums DPO's margin is made of: policy / reference,
        chosen / rejected."""
        rows = ((emb, labels), (rejected, rej_labels))
        return [float(x) for a in (lora, None) for e, lab in rows
                for x in vt.sequence_logprob(m, e.to(d, dt), lab.to(d), a,
                                             cfg)]

    recs = {}
    for name, (loss_fn, with_proj, k1_want, bwd_want) in cases.items():
        grads, losses, lps = {}, {}, {}
        for dev in ("cpu", "cuda"):
            lora = {p: {n: t.to(dev).requires_grad_() for n, t in ab.items()}
                    for p, ab in lora0.items()}
            leaves = [(f"{p}.{n}", t) for p, ab in lora.items()
                      for n, t in ab.items()]
            proj = None
            if with_proj:
                proj = MLPProjector(dv, lcfg.dim).to(dev)
                proj.load_state_dict(proj0.state_dict())
                leaves += [(f"projector.{n}", t)
                           for n, t in proj.named_parameters()]
            _reset_counts()
            loss = loss_fn(models[dev], lora, proj, models[dev].dtype, dev)
            g = torch.autograd.grad(loss, [t for _, t in leaves])
            torch.cuda.synchronize()
            grads[dev] = {k: x.float().cpu() for (k, _), x in zip(leaves, g)}
            losses[dev] = float(loss.detach())
            launches = _counts()
            if name == "dpo":
                lps[dev] = logprobs(models[dev], lora, models[dev].dtype, dev)
        cos = {k: float(torch.nn.functional.cosine_similarity(
            grads["cpu"][k].flatten(), grads["cuda"][k].flatten(), dim=0))
            for k in grads["cpu"]}
        loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        rec = dict(loss=name, family=family, quant=quant, seq=seq, batch=b,
                   layers=L,
                   head_dim=lcfg.head_dim, loss_cpu=losses["cpu"],
                   loss_card=losses["cuda"], loss_rel_err=loss_rel,
                   leaves=len(cos), grad_cos_min=min(cos.values()),
                   grad_cos_min_leaf=min(cos, key=cos.get),
                   same_quantized_bytes=same_bytes, card_launches=launches,
                   want_launches={"k1": k1_want, "bwd": bwd_want},
                   tol=f"loss rel err <= {TRAIN_LOSS_RTOL}, every leaf's "
                       f"gradient cosine >= {TRAIN_COS_MIN}")
        if with_proj:
            rec["projector_grad_cos_min"] = min(
                v for k, v in cos.items() if k.startswith("projector."))
        loss_ok = loss_rel <= TRAIN_LOSS_RTOL
        if name == "dpo":
            rec.update(_dpo_check(lps["cuda"], lps["cpu"], losses["cuda"], b))
            loss_ok = rec["dpo_ok"]
        rec["ok"] = bool(same_bytes and loss_ok
                         and min(cos.values()) >= TRAIN_COS_MIN
                         and launches["k1"] == k1_want
                         and launches["bwd"] == bwd_want
                         and launches["bwd256"] == (
                             bwd_want if lcfg.head_dim == 256 else 0)
                         and launches["k1wide"] == (
                             k1_want if lcfg.head_dim > 256 else 0)
                         and launches["bwdwide"] == (
                             bwd_want if lcfg.head_dim > 256 else 0))
        _say("train_reference", **rec)
        recs[name] = rec
    _reset_counts()
    return {"ok": all(r["ok"] for r in recs.values()), "cases": recs}


def _dpo_deltas(sums: list, b: int) -> list:
    """sums: policy chosen, policy rejected, reference chosen, reference
    rejected, b rows each -> the 2b policy-minus-reference deltas."""
    return [sums[i] - sums[2 * b + i] for i in range(2 * b)]


def _dpo_formula(sums: list, b: int) -> float:
    """-log sigmoid(beta * margin) averaged over the b pairs, in fp64."""
    d = _dpo_deltas(sums, b)
    return sum(math.log1p(math.exp(-DPO_BETA * (d[i] - d[b + i])))
               for i in range(b)) / b


def _dpo_check(card: list, cpu: list, loss_card: float, b: int) -> dict:
    """DPO on the card against the CPU (DPO_DELTA_ATOL's comment): the
    sums, the per-row deltas, and dpo_loss against the formula on the
    card's sums. Planted faults, made from the card's own sums, must fail:
    the reference run with the adapters on (its sums the policy's, the loss
    log 2), and its chosen and rejected rows swapped."""
    want = _dpo_deltas(cpu, b)

    def judge(sums, loss):
        rel = max(abs(x - y) / abs(y) for x, y in zip(sums, cpu))
        delta = max(abs(x - y) for x, y in zip(_dpo_deltas(sums, b), want))
        self_err = abs(loss - _dpo_formula(sums, b))
        return {"logprob_rel_err_max": rel, "delta_abs_err_max": delta,
                "loss_self_err": self_err,
                "ok": bool(rel <= TRAIN_LOSS_RTOL and delta <= DPO_DELTA_ATOL
                           and self_err <= DPO_LOSS_SELF_ATOL)}

    pol, ref = card[:2 * b], card[2 * b:]
    faults = {
        "reference_with_adapters": (pol + pol, math.log(2.0)),
        "reference_rows_swapped": (pol + ref[b:] + ref[:b], None),
        "loss_reference_with_adapters": (card, math.log(2.0)),
    }
    controls = {}
    for fault, (sums, loss) in faults.items():
        controls[fault] = judge(sums, _dpo_formula(sums, b) if loss is None
                                else loss)
    sound = judge(card, loss_card)
    return dict(logprobs_cpu=cpu, logprobs_card=card,
                deltas_cpu=want, deltas_card=_dpo_deltas(card, b),
                **{k: v for k, v in sound.items() if k != "ok"},
                loss_abs_err=abs(loss_card - _dpo_formula(cpu, b)),
                controls=controls,
                dpo_ok=bool(sound["ok"] and not any(
                    c["ok"] for c in controls.values())),
                tol=f"each sequence log-prob sum's rel err <= "
                    f"{TRAIN_LOSS_RTOL}, each row's policy - reference "
                    f"delta within {DPO_DELTA_ATOL} nats of the CPU's, "
                    f"dpo_loss within {DPO_LOSS_SELF_ATOL} of the formula on "
                    f"the card's sums, every planted fault rejected, every "
                    f"leaf's gradient cosine >= {TRAIN_COS_MIN}")


def _train_data(work: Path, cap, tok, seed: int, n: int, width: int):
    """n anyres image records (seeded 224^2 PNGs) whose answers make the
    spliced sequences width-60 .. width-1 tokens long, so every batch pads
    to `width`. Returns (image tokens per record, the record lengths)."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.models.vlm.generate import anyres_image_features
    rng = np.random.default_rng(seed + 3)
    (work / "imgs").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
        img.save(work / "imgs" / f"tile_{i}.png")
    with torch.no_grad():
        n_img = anyres_image_features(cap.vision, cap.projector, img,
                                      cap.image_newline,
                                      cap.vision.cfg.image_size).shape[0]
    question = "<image>\nDescribe the remote sensing image in detail."
    recs, lengths = [], []
    for i in range(n):
        lengths.append(width - 60 + (i * 7) % 60)
        recs.append({"id": i, "image": f"tile_{i}.png", "conversations": _conv(
            question, _answer_for(tok, question, lengths[-1], n_img - 1, i))})
    (work / "train.json").write_text(json.dumps(recs))
    return n_img, lengths


def _device_kernels(prof):
    """(device ms by kernel name, total device ms) from a torch.profiler
    run: device-side kernel events only (a CPU op's self device time
    repeats its kernels')."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == DeviceType.CUDA]
    return rows, sum(t for _, t, _ in rows)


def _train_loop(name: str, cap, tok, argv, steps: int, k1_per_step: int,
                bwd_per_step: int, projector_trains: bool = False,
                profile: bool = False) -> tuple:
    """train_vlm.train on `cap` with the CLI's arguments `argv`, launch
    counts reset just before the loop and read just after (and per step in
    between). Fails unless every step launched k1_per_step K1 and
    bwd_per_step backward kernels, the losses are finite, the frozen base's
    bytes did not move, and the projector moved exactly when it trains.
    Returns (record, trainer)."""
    import torch
    from rsvldm_tpu_torch import train_vlm
    args = train_vlm.parse_args(argv)
    digest = _sd_digest(cap.llama.state_dict())
    proj_digest = _sd_digest(cap.projector.state_dict())
    per_step, prof = [], []
    last = {}

    def on_step(r):
        now = _counts()
        r = dict(r, tokens_per_s=r["batch"] * r["width"] / r["seconds"],
                 launches={k: now[k] - last[k] for k in now})
        last.update(now)
        per_step.append(r)
        _say(name, **r)
        if profile and r["step"] == steps - 1:
            # the last step (its batch's preparation included) is traced
            from torch.profiler import ProfilerActivity
            prof.append(torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            prof[0].__enter__()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    last.update(_counts())
    t0 = time.perf_counter()
    res, trainer = train_vlm.train(args, cap, encode=tok.encode,
                                   on_step=on_step)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = _counts()
    if prof:
        prof[0].__exit__(None, None, None)
        rows, dev_ms = _device_kernels(prof[0])
        share = lambda n: sum(t for k, t, _ in rows if n in k)
        hand = {k: share(n) for k, n in (
            ("k1", "flash_fwd_kernel"), ("bwd", "flash_bwd_kernel"),
            ("bwd_prep", "flash_bwd_prep_kernel"))}
        _say("profile", step=name, device_ms=dev_ms,
             unprofiled_step_ms=per_step[-2]["seconds"] * 1e3,
             hand_ms=hand,
             hand_share_of_device={k: v / dev_ms for k, v in hand.items()},
             kernel_launches=sum(c for _, _, c in rows),
             top_kernels=[[k[:80], round(t, 3), c] for k, t, c in
                          sorted(rows, key=lambda r: -r[1])[:12]])
    lora = getattr(trainer, "lora", None)
    moved = lora is None or all(float(ab["b"].detach().abs().max()) > 0
                                for ab in lora.values())
    unchanged = _sd_digest(cap.llama.state_dict()) == digest
    proj_moved = _sd_digest(cap.projector.state_dict()) != proj_digest
    rec = dict(loop_s=loop_s, steps=res["steps"], batch=args.batch_size,
               widths=[r["width"] for r in per_step],
               losses=[r["loss"] for r in per_step],
               step_s=[r["seconds"] for r in per_step],
               tokens_per_s=[r["tokens_per_s"] for r in per_step],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches,
               want_per_step={"k1": k1_per_step, "bwd": bwd_per_step},
               adapters=0 if lora is None else len(lora),
               adapters_moved=moved, base_unchanged=unchanged,
               projector_moved=proj_moved, base_digest=digest)
    rec["ok"] = bool(
        res["steps"] == steps
        and all(w >= 1024 for w in rec["widths"])
        and all(r["launches"]["k1"] == k1_per_step
                and r["launches"]["bwd"] == bwd_per_step for r in per_step)
        and launches["k1"] == k1_per_step * steps
        and launches["bwd"] == bwd_per_step * steps
        and launches["k2"] == 0
        and all(math.isfinite(x) for x in rec["losses"])
        and moved and unchanged and proj_moved == projector_trains)
    _say(name, **{k: v for k, v in rec.items() if k != "losses"},
         losses=rec["losses"])
    return rec, trainer


def _conv(question: str, answer: str):
    return [{"from": "human", "value": question},
            {"from": "gpt", "value": answer}]


def _answer_for(tok, question: str, target: int, extra: int, seed: int):
    """An answer of words that makes the llama-3 record of `question`
    `target` tokens long once `extra` - 1 rows replace its <image> (the
    StandInTokenizer gives one id a word)."""
    from rsvldm_tpu_torch.training.vlm_data import (normalize_multimodal,
                                                    preprocess_llama3)
    base = len(preprocess_llama3(normalize_multimodal(_conv(question, "w")),
                                 tok.encode)[0]) + extra
    return " ".join(f"a{(seed * 31 + j) % 977}" for j in range(target - base + 1))


def _write_pngs(d: Path, n: int, side: int, rng, prefix: str = "tile"):
    import numpy as np
    from PIL import Image
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.random((side, side, 3)) * 255).astype(
            np.uint8)).save(d / f"{prefix}_{i:03d}.png")


def _mm_data(work: Path, tok, seed: int, n: int, img_tokens: int,
             width: int = 1024):
    """n pad-recipe image records (seeded 224^2 PNGs, resized to the tower's
    336^2) whose spliced rows are width-60 .. width-1 tokens long."""
    import numpy as np
    _write_pngs(work / "imgs", n, 224, np.random.default_rng(seed + 7))
    q = "<image>\nDescribe the remote sensing image in detail."
    recs = [{"id": i, "image": f"tile_{i:03d}.png",
             "conversations": _conv(q, _answer_for(
                 tok, q, width - 60 + (i * 7) % 60, img_tokens - 1, i))}
            for i in range(n)]
    (work / "mm.json").write_text(json.dumps(recs))


def _dpo_data(work: Path, tok, seed: int, n: int, width: int = 1024):
    """n text preference pairs whose chosen and rejected rows are
    width-60 .. width-1 tokens long."""
    prompt_words = width - 300
    recs = []
    for i in range(n):
        prompt = " ".join(f"p{(i * 17 + j) % 991}" for j in range(prompt_words))
        sides = {side: _answer_for(tok, prompt, width - 60 + (i * 13 + k * 29)
                                   % 60, 0, i + 5 * k)
                 for k, side in enumerate(("chosen", "rejected"))}
        recs.append({"id": i, "prompt": prompt, **sides})
    (work / "dpo.json").write_text(json.dumps(recs))


def _video_data(work: Path, tok, seed: int, n: int, frames: int = 8,
                folders: int = 4):
    """`folders` frame folders of `frames` seeded 224^2 PNGs under a
    shareVideoGPTV path (so no container decoder is needed) and n records
    over them, each with a 40-word answer."""
    import numpy as np
    rng = np.random.default_rng(seed + 11)
    for v in range(folders):
        _write_pngs(work / "vids" / "shareVideoGPTV" / f"v{v}", frames, 224,
                    rng, prefix="frame")
    q = "<image>\nDescribe what changes over the video."
    recs = [{"id": i, "video": f"shareVideoGPTV/v{i % folders}",
             "conversations": _conv(q, " ".join(
                 f"a{(i * 31 + j) % 977}" for j in range(40 + i)))}
            for i in range(n)]
    (work / "video.json").write_text(json.dumps(recs))


def phase_train(seed: int, cap, tok, work: Path, steps: int = 4,
                batch: int = 4, width: int = 1536, profile: bool = False):
    """The port's train_vlm loop at full width on the seeded LLaVA-NeXT-8B
    captioner (CLIP-L/336, mlp2x_gelu, Llama-3-8B, int8 decoder): LoRA
    r=16 alpha=16 on the seven projections, AdamW lr 2e-4, gradient
    checkpointing, anyres image records, batch 4 padded to `width` tokens.
    K1 64 and the backward 32 a step; the projector stays as it is."""
    n_img, lengths = _train_data(work, cap, tok, seed, steps * batch, width)
    rec, trainer = _train_loop("train", cap, tok, [
        "--data_path", str(work / "train.json"),
        "--image_folder", str(work / "imgs"), "--output_dir", str(work / "out"),
        "--image_aspect_ratio", "anyres", "--bits", "8", "--lora_r", "16",
        "--lora_alpha", "16", "--lr", "2e-4", "--batch_size", str(batch),
        "--steps", str(steps), "--seed", str(seed), "--num_workers", "2",
        "--pad_to", str(width)], steps, 64, 32, profile=profile)
    rec.update(image_tokens=n_img, record_tokens=[min(lengths), max(lengths)])
    rec["ok"] = rec["ok"] and all(w == width for w in rec["widths"])
    del trainer
    return rec


def phase_train_video(seed: int, cap, tok, work: Path, steps: int = 3,
                      batch: int = 4):
    """--tune lora on frame-folder video records: 8 frames a record, each
    through the tower and projector in one batched call, pooled 2x2
    bilinear with a newline a grid row (156 rows a frame, 1248 a record),
    batches padded to a multiple of 64. K1 64 and the backward 32 a step
    (the tower's 577-token attention stays plain)."""
    _video_data(work, tok, seed, steps * batch)
    rec, trainer = _train_loop("train_video", cap, tok, [
        "--data_path", str(work / "video.json"),
        "--video_folder", str(work / "vids"), "--frames_upbound", "8",
        "--force_sample", "--output_dir", str(work / "out_video"),
        "--bits", "8", "--batch_size", str(batch), "--steps", str(steps),
        "--seed", str(seed), "--num_workers", "2"], steps, 64, 32)
    del trainer
    return rec


def phase_train_dpo(seed: int, cap, tok, work: Path, steps: int = 3,
                    batch: int = 4, width: int = 1024):
    """--dpo on text preference pairs padded to `width`: per step the
    policy's chosen and rejected forwards (K1 32 each), their recomputes
    (32 each) and backwards (32 each), and the reference's two forwards
    without a graph (32 each): K1 192, the backward 64."""
    _dpo_data(work, tok, seed, steps * batch, width)
    rec, trainer = _train_loop("train_dpo", cap, tok, [
        "--data_path", str(work / "dpo.json"), "--dpo", "--dpo_beta", "0.1",
        "--lr", "5e-5", "--output_dir", str(work / "out_dpo"), "--bits", "8",
        "--batch_size", str(batch), "--steps", str(steps), "--seed",
        str(seed), "--num_workers", "2", "--pad_to", str(width)],
        steps, 192, 64)
    rec["ok"] = rec["ok"] and all(w == width for w in rec["widths"])
    del trainer
    return rec


def phase_train_mm(seed: int, cap, tok, work: Path, tune: str,
                   steps: int = 3, batch: int = 4, width: int = 1024):
    """--tune projector (the pretrain stage) or --tune lora,projector
    --mm_projector_lr 2e-5 on pad-recipe image records padded to `width`:
    the projector (fp32) inside the graph fills each row's 576-row span.
    K1 64 and the backward 32 a step; the projector must move."""
    img_tokens = (cap.vision.cfg.image_size // cap.vision.cfg.patch_size) ** 2
    if not (work / "mm.json").exists():
        _mm_data(work, tok, seed, steps * batch, img_tokens, width)
    argv = ["--data_path", str(work / "mm.json"),
            "--image_folder", str(work / "imgs"), "--tune", tune,
            "--output_dir", str(work / f"out_{tune.replace(',', '_')}"),
            "--bits", "8", "--batch_size", str(batch), "--steps", str(steps),
            "--seed", str(seed), "--num_workers", "2", "--pad_to", str(width)]
    if "lora" in tune:
        argv += ["--mm_projector_lr", "2e-5"]
    name = "train_mm_" + tune.replace(",", "_")
    rec, trainer = _train_loop(name, cap, tok, argv, steps, 64, 32,
                               projector_trains=True)
    rec.update(tune=tune, image_tokens=img_tokens,
               projector_dtype=str(next(cap.projector.parameters()).dtype),
               lrs=[g["lr"] for g in trainer.opt.param_groups])
    rec["ok"] = rec["ok"] and all(w == width for w in rec["widths"])
    del trainer
    return rec


def _text_batch(model, gen, batch: int, width: int):
    """A batch of text records for a decoder's LoRA step: token ids drawn
    from `gen` on its device, rows of width - w .. width - 1 tokens (w =
    min(60, width / 4)) padded to `width` with token 0, supervised after a
    prompt of min(256, width / 4) tokens and up to each row's end, so the
    rows' supervised counts differ; (their embeddings through model.embed,
    Gemma's scale included; labels)."""
    import torch
    from rsvldm_tpu_torch.training.vlm_trainer import IGNORE_INDEX
    dev = gen.device
    toks = torch.randint(1, model.cfg.vocab_size, (batch, width),
                         generator=gen, device=dev)
    labels = toks.clone()
    labels[:, :min(256, width // 4)] = IGNORE_INDEX
    w = min(60, width // 4)
    for row in range(batch):
        end = width - w + int(torch.randint(0, w, (1,), generator=gen,
                                            device=dev))
        toks[row, end:] = 0
        labels[row, end:] = IGNORE_INDEX
    with torch.no_grad():
        return model.embed(toks), labels


def phase_train_gemma(seed: int, steps: int = 3, batch: int = 4,
                      width: int = 1536) -> dict:
    """The Gemma-family QLoRA step at full width and depth, through JAX's
    own API (neither package has a Gemma training CLI): VLMTrainer over the
    seeded Gemma-7B decoder (28 layers, 16 heads of 256, dim 3072, the
    256k vocabulary on the tied head) quantized to int8, LoRA r=16
    alpha=16 on the seven projections, AdamW lr 2e-4, remat; text records,
    batch 4 padded to 1536 tokens. Per step K1 56 (28 forward + 28
    recompute) and the D=256 backward 28 (`bwd256`), K2 none; finite
    losses, the base's bytes unchanged, every B moved."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import (GEMMA_7B_CONFIG,
                                                   LlamaModel, quantize_llama_)
    from rsvldm_tpu_torch.training import vlm_trainer as vt
    _free_card()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(GEMMA_7B_CONFIG, remat=True)
    model = quantize_llama_(_seeded_on_card(lambda: LlamaModel(cfg), "gemma"),
                            "int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    digest = _sd_digest(model.state_dict())
    tr = vt.VLMTrainer(model, vt.LoraConfig(r=16, alpha=16), lr=2e-4,
                       generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    L = cfg.layers
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    per_step = []
    for i in range(steps):
        emb, labels = _text_batch(model, gen, batch, width)
        torch.cuda.synchronize()
        before, t1 = _counts(), time.perf_counter()
        loss = tr.train_step(emb, labels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        now = _counts()
        per_step.append(dict(step=i, loss=loss, seconds=secs,
                             tokens_per_s=batch * width / secs,
                             launches={k: now[k] - before[k] for k in now}))
        _say("train_gemma", **per_step[-1])
    launches = _counts()
    moved = all(float(ab["b"].detach().abs().max()) > 0
                for ab in tr.lora.values())
    unchanged = _sd_digest(model.state_dict()) == digest
    want = {"k1": 2 * L, "k1wide": 0, "k2": 0, "bwd": L, "bwd256": L,
            "bwdwide": 0}
    rec = dict(config="GEMMA_7B_CONFIG int8, LoRA r=16 (7 projections), "
                      "remat", seconds=time.perf_counter() - t0, layers=L, heads=cfg.heads,
               head_dim=cfg.head_dim, vocab=cfg.vocab_size, batch=batch,
               width=width, build_s=build_s,
               losses=[r["loss"] for r in per_step],
               step_s=[r["seconds"] for r in per_step],
               tokens_per_s=[r["tokens_per_s"] for r in per_step],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches, want_per_step=want,
               adapters=len(tr.lora), adapters_moved=moved,
               base_unchanged=unchanged, base_digest=digest)
    rec["ok"] = bool(
        all(r["launches"] == want for r in per_step)
        and all(launches[k] == v * steps for k, v in want.items())
        and all(math.isfinite(x) for x in rec["losses"])
        and len(tr.lora) == 7 * L and moved and unchanged)
    _say("train_gemma", **rec)
    del tr, model
    _free_card()
    return rec


# phase wide_head: Llama-3-8B's widths (dim 4096, ffn 14336, vocab 128256)
# regrouped into 8 query heads and 2 KV heads of 512, so that every
# projection keeps Llama-3-8B's shape; in bf16, cut to 4 of its 32 layers
WIDE_HEAD_LAYERS = 4


def phase_wide_head(seed: int, steps: int = 3, batch: int = 4,
                    width: int = 1536, prefill: int = 1280) -> dict:
    """The wide-head decoder path (K1 and the backward past D = 256, the
    kernels of csrc/flash_wide.cu), through the decoder-alone route of
    phase_train_gemma: a {prefill}-token prefill into a KV cache (K1 wide
    one a layer), then LoRA r=16 alpha=16 on the seven projections, AdamW
    lr 2e-4, remat, over text records of batch 4 x 1536 (per step K1 wide
    2 a layer: forward and recompute; the wide backward one a layer).
    Passes on exact launch counts, finite logits and losses, the base's
    bytes unchanged and every B moved."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import (LLAMA3_8B_CONFIG, KVCache,
                                                   LlamaModel)
    from rsvldm_tpu_torch.training import vlm_trainer as vt
    _free_card()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(LLAMA3_8B_CONFIG, heads=8, kv_heads=2,
                              head_dim_cfg=512, layers=WIDE_HEAD_LAYERS,
                              remat=True)
    model = _seeded_on_card(lambda: LlamaModel(cfg), "llama")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    digest = _sd_digest(model.state_dict())
    L = cfg.layers
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    toks = torch.randint(1, cfg.vocab_size, (1, prefill), generator=gen,
                         device="cuda")
    _reset_counts()
    with torch.no_grad():
        cache = KVCache.init(model.cache_cfg, 1, prefill + 64, model.dtype,
                             "cuda")
        emb = model.embed(toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, _ = model(emb, cache, 0,
                          logits_at=torch.tensor([prefill - 1], device="cuda"))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
    pre = _counts()
    pre_want = {"k1": L, "k1wide": L, "k2": 0, "bwd": 0, "bwd256": 0,
                "bwdwide": 0}
    prefill_finite = bool(torch.isfinite(logits).all())
    del cache, emb, logits
    tr = vt.VLMTrainer(model, vt.LoraConfig(r=16, alpha=16), lr=2e-4,
                       generator=torch.Generator().manual_seed(seed))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    per_step = []
    for i in range(steps):
        emb, labels = _text_batch(model, gen, batch, width)
        torch.cuda.synchronize()
        before, t1 = _counts(), time.perf_counter()
        loss = tr.train_step(emb, labels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        now = _counts()
        per_step.append(dict(step=i, loss=loss, seconds=secs,
                             tokens_per_s=batch * width / secs,
                             launches={k: now[k] - before[k] for k in now}))
        _say("wide_head", **per_step[-1])
    launches = _counts()
    moved = all(float(ab["b"].detach().abs().max()) > 0
                for ab in tr.lora.values())
    unchanged = _sd_digest(model.state_dict()) == digest
    want = {"k1": 2 * L, "k1wide": 2 * L, "k2": 0, "bwd": L, "bwd256": 0,
            "bwdwide": L}
    rec = dict(config=f"LLAMA3_8B_CONFIG widths, 8 q / 2 kv heads of 512, "
                      f"bf16, {L} of 32 layers; LoRA r=16 (7 projections), "
                      "remat", seconds=time.perf_counter() - t0, layers=L,
               heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
               batch=batch, width=width, build_s=build_s, prefill=prefill,
               prefill_s=prefill_s, prefill_launches=pre,
               prefill_want=pre_want, prefill_finite=prefill_finite,
               losses=[r["loss"] for r in per_step],
               step_s=[r["seconds"] for r in per_step],
               tokens_per_s=[r["tokens_per_s"] for r in per_step],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches={k: launches[k] + pre[k] for k in launches},
               want_per_step=want, adapters=len(tr.lora),
               adapters_moved=moved, base_unchanged=unchanged)
    rec["ok"] = bool(
        pre == pre_want and prefill_finite
        and all(r["launches"] == want for r in per_step)
        and all(launches[k] == v * steps for k, v in want.items())
        and all(math.isfinite(x) for x in rec["losses"])
        and len(tr.lora) == 7 * L and moved and unchanged)
    _say("wide_head", **rec)
    del tr, model
    _free_card()
    return rec


def phase_train_all(seed: int, profile: bool = False) -> dict:
    """The caption finetune's recipes on one full-width captioner, built
    once: anyres LoRA (`train`), video LoRA, DPO, then the projector
    tuning (pretrain stage, then joint), which widens the projector to fp32
    and trains it, last."""
    import shutil
    import torch
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        t0 = time.perf_counter()
        tok = StandInTokenizer()
        cap = LlavaCaptioner.seeded(tokenizer=tok, quant="int8", device="cuda",
                                    dtype=torch.bfloat16)
        torch.cuda.synchronize()
        out = {"init_s": time.perf_counter() - t0}
        out["train"] = phase_train(seed, cap, tok, work, profile=profile)
        out["train_video"] = phase_train_video(seed, cap, tok, work)
        out["train_dpo"] = phase_train_dpo(seed, cap, tok, work)
        out["train_mm"] = [phase_train_mm(seed, cap, tok, work, tune)
                           for tune in ("projector", "lora,projector")]
        del cap
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["ok"] = all(out[k]["ok"] for k in ("train", "train_video",
                                           "train_dpo")) and all(
        r["ok"] for r in out["train_mm"])
    return out


def phase_train_sr3(seed: int, steps: int = 4, images: int = 24):
    """python -m rsvldm_tpu_torch.train_sr3 as a user runs it, through its
    own construction (parse_args, build_trainer, run): the path's SR3 UNet
    (64 channels, x(1, 2, 4, 8, 8), 224^2) in fp32, Adam and the EMA, the
    CLI's default batch 8 from an LRHR folder of seeded images (hr_224,
    lr_28, sr_28_224: decoded by worker threads, staged on the card by the
    prefetcher), `steps` steps, saved as I{steps}_gen.pth / _opt.pth; then
    a second trainer resumes from those files (--resume_iter) and takes
    one more step beside the uninterrupted trainer on the same batch and
    draws: the loss, every parameter and the EMA must be equal. No hand
    kernel runs here: the launch counts read 0."""
    import shutil
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch import train_sr3
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_sr3_"))
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        rng = np.random.default_rng(seed + 13)
        for sub in ("hr_224", "lr_28", "sr_28_224"):
            (work / "data" / sub).mkdir(parents=True)
        for i in range(images):
            hr = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
            lr = hr.resize((28, 28), Image.BICUBIC)
            hr.save(work / "data" / "hr_224" / f"{i:03d}.png")
            lr.save(work / "data" / "lr_28" / f"{i:03d}.png")
            lr.resize((224, 224), Image.BICUBIC).save(
                work / "data" / "sr_28_224" / f"{i:03d}.png")
        # the resume check compares bit for bit: deterministic conv kernels
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        argv = ["--data_root", str(work / "data"), "--save_dir",
                str(work / "ckpt"), "--steps", str(steps), "--log_every", "1",
                "--seed", str(seed), "--num_workers", "2"]
        args = train_sr3.parse_args(argv)
        trainer = train_sr3.build_trainer(args)
        per_step = []
        clock = [time.perf_counter()]

        def on_step(r):  # the loss's float() synchronised the step
            now = time.perf_counter()
            per_step.append(dict(r, seconds=now - clock[0]))
            clock[0] = now

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        clock[0] = t0
        train_sr3.run(args, trainer, on_step=on_step)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        files = sorted(p.name for p in (work / "ckpt").iterdir())
        resumed = train_sr3.build_trainer(train_sr3.parse_args(
            argv + ["--resume_iter", str(steps)]))
        gen = torch.Generator(device="cuda").manual_seed(seed + 17)
        hr = torch.rand((8, 224, 224, 3), generator=gen, device="cuda") * 2 - 1
        sr = torch.rand((8, 224, 224, 3), generator=gen, device="cuda") * 2 - 1
        draws = (torch.randint(1, 2001, (8,), generator=gen, device="cuda"),
                 torch.rand((8,), generator=gen, device="cuda"),
                 torch.randn((8, 224, 224, 3), generator=gen, device="cuda"))
        la = trainer.train_step(hr, sr, *draws)
        lb = resumed.train_step(hr, sr, *draws)
        param_err = max(float((a - b).abs().max()) for a, b in zip(
            trainer.model.state_dict().values(),
            resumed.model.state_dict().values()))
        ema_err = max(float((trainer.ema.params[k] - resumed.ema.params[k])
                            .abs().max()) for k in trainer.ema.params)
        rec = dict(steps=trainer.step, batch=args.batch_size, size=224,
                   params=sum(p.numel() for p in trainer.model.parameters()),
                   loop_s=loop_s, losses=[r["loss"] for r in per_step],
                   step_s=[r["seconds"] for r in per_step],
                   peak_mem_gib=peak, launches=launches, files=files,
                   resumed_step=resumed.step, resumed_loss=lb,
                   uninterrupted_loss=la, resumed_param_max_err=param_err,
                   resumed_ema_max_err=ema_err)
        rec["ok"] = bool(
            len(per_step) == steps and trainer.step == resumed.step == steps + 1
            and all(math.isfinite(x) for x in rec["losses"])
            and all(v == 0 for v in launches.values())
            and files == [f"I{steps}_gen.pth", f"I{steps}_opt.pth"]
            and la == lb and param_err == 0 and ema_err == 0)
        _say("train_sr3", **rec)
        del trainer, resumed
        torch.cuda.empty_cache()
        return rec
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------- serving phases
# serve_reference: the engine at the small width, card (bf16) against CPU
# (fp32). Each request decodes SERVE_NEW tokens; its first SERVE_AGREE
# greedy ids are held against the CPU teacher-forced on them (the prompt,
# then the card's ids before each position). bf16 moves a logit by about
# 2.5% of the logits' rms (an H100 gave caption cosines 0.9997-0.9998 with
# these weights), and 128256 random-weight logits have near-ties: at every
# position the card's token must lie within SERVE_NEAR_TIE * rms of the
# CPU's best (a tie that bf16 may break either way), hence be the CPU's
# best wherever the CPU's top two lie further apart. A scheduling fault (a
# wrong slot, position, key or dequantization) gives another token where
# the CPU's top is clear.
SERVE_NEW, SERVE_AGREE, SERVE_NEAR_TIE = 24, 16, 0.15
# serve: the LLM worker's engine at full width; the registered system
# prefix of its --prefix-file engine (padded past 1024: K1 at registration)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PREFIX_TOKENS = 8, 4096, 1100


def _serve_k1_per_admission(s: int, whole: bool, layers: int) -> int:
    """K1 launches of one admission: one per layer when its prompt is
    prefilled whole from position 0 at a padded length of 1024 or more."""
    return layers if whole and -(-s // 128) * 128 >= 1024 else 0


def _serve_k2_expected(eng, k2_step: int, k2_round: int = 0) -> int:
    """K2 launches of an engine's run: the lm_head row of every admission,
    k2_step a decode step (H of them a horizon), k2_round a round."""
    return (eng.admissions + k2_step * (eng.steps["decode"] + eng.decode_horizon
                                        * eng.steps["horizon"])
            + k2_round * eng.steps["spec"])


def _teacher_forced(model, prompt, card_ids, cpu_ids, n: int,
                    kv_8bit: bool) -> dict:
    """The CPU's logits at each of the card's first n greedy ids: the
    prompt prefilled from 0 into a cache (int8 under kv_8bit, as the
    engine's pool), then the card's first n - 1 ids as one block after it
    (the einsum path over the cache, as the engine's decode steps). Per
    position, the card token's distance below the CPU's best and the gap
    of the CPU's top two, in units of the logits' rms. `agree`: where the
    card's ids first part from the CPU engine's own greedy run."""
    import dataclasses
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    ids = [int(t) for t in card_ids[:n]]
    a, b = ids, [int(t) for t in cpu_ids[:n]]
    j = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), None)
    cfg = (dataclasses.replace(model.cfg, kv_quant=True) if kv_8bit
           else model.cfg)
    s = prompt.shape[0]
    cache = KVCache.init(cfg, 1, s + n, torch.float32, "cpu")
    with torch.inference_mode():
        lg0, _ = model(prompt[None], cache, 0, logits_at=torch.tensor([s - 1]))
        rows = [lg0[0, 0]]
        if len(ids) > 1:
            x = model.embed(torch.tensor(ids[:-1], dtype=torch.long))
            lg, _ = model(x[None], cache, torch.tensor(s))
            rows += list(lg[0])
    lg = torch.stack(rows).float()                        # [len(ids), V]
    rms = lg.square().mean(-1).sqrt()
    top2 = lg.topk(2, dim=-1).values
    gap = (top2[:, 0] - lg[torch.arange(len(ids)), torch.tensor(ids)]) / rms
    clear = (top2[:, 0] - top2[:, 1]) / rms > SERVE_NEAR_TIE
    exact = lg.argmax(-1) == torch.tensor(ids)
    parted = [[i, round(float(gap[i]), 4)] for i in range(len(ids))
              if not exact[i]]
    return dict(agree=min(len(a), len(b)) if j is None else j,
                positions=len(ids), exact=int(exact.sum()),
                max_gap_over_rms=round(float(gap.max()), 4), parted=parted,
                ok=bool(len(ids) >= n and float(gap.max()) <= SERVE_NEAR_TIE
                        and bool(exact[clear].all())))


def phase_serve_reference(seed: int):
    """The continuous-batching engine at the small width (2 layers, 128-wide
    heads, int4; the caption references' captioner), card (bf16, CUDA
    graphs) against the same engine on the CPU (fp32), same quantized
    bytes and prompts: a 224^2 image prompt (1280 tokens: K1), text
    prompts of 40-900 tokens and two requests on a registered 300-token
    prefix, 6 requests on 4 slots admitted in two waves, with the decode
    horizon (4); a chunked admission (3 chunks of 512) while a co-tenant
    decodes; an int8 KV pool; speculative rounds with a one-layer
    self-draft (k = 4). Each request's first SERVE_AGREE greedy ids the
    CPU's teacher-forced best (up to a near-tie, above) at every position,
    its first token's logit cosine
    >= CAP_COS_MIN, K1 / K2 launches equal to the count reckoned from the
    admissions and steps. Then on the card a sampled request (T = 0.7,
    the default counter draws) alone and among co-tenants in another slot:
    the same first SERVE_AGREE ids."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import REFERENCE_IMG_PROMPT
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.speculative import self_draft
    from rsvldm_tpu_torch.serving.engine import DecodeEngine

    caps, lcfg, vcfg, tok, same_bytes = _small_captioners("int4")
    L, k2_step = lcfg.layers, 7 * lcfg.layers + 1
    rng = np.random.default_rng(seed + 12)
    img = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
    prompt = gen.llama3_chat_prompt(
        REFERENCE_IMG_PROMPT.format(DEFAULT_IMAGE_TOKEN="<image>"))
    with torch.inference_mode():
        P = {"img": {d: c.embed_mm(prompt, [img]) for d, c in caps.items()}}
        for n in (900, 600, 300, 100, 50, 40):
            ids = torch.from_numpy(rng.integers(0, 128000, n))
            P[n] = {d: c.llama.embed(ids.to(c.image_newline.device))
                    for d, c in caps.items()}
    greedy = gen.GenerateConfig(max_new_tokens=SERVE_NEW, do_sample=False)
    models = {d: c.llama for d, c in caps.items()}

    def run(dev, model, reqs, wave: int, gap_steps: int, **kw):
        """reqs: (prompt key, prefix key or None); the first `wave`
        submitted, `gap_steps` steps, then the rest."""
        eng = DecodeEngine(model, max_len=2048, **kw)
        logits = {}
        first = eng._first_token

        def first_token(lg, nonce, temp):
            logits[nonce] = lg[0].float().cpu()
            return first(lg, nonce, temp)

        eng._first_token = first_token
        eng.warmup()
        pids = {p: eng.register_prefix(P[p][dev]) for _, p in reqs if p}
        replays0 = {k: r.replays for k, r in eng.runners.items()}
        _reset_counts()
        uids = []
        for i, (key, pre) in enumerate(reqs):
            if i == wave:
                for _ in range(gap_steps):
                    eng.step()
            uids.append(eng.submit(P[key][dev], greedy,
                                   prefix_id=pids.get(pre)))
        eng.run_until_idle()
        if dev == "cuda":
            torch.cuda.synchronize()
        out = dict(ids=[eng.result(u) for u in uids],
                   logits=[logits[eng._requests[u].nonce] for u in uids],
                   counts=_counts(), steps=dict(eng.steps),
                   admissions=eng.admissions,
                   replays={k: r.replays - replays0[k]
                            for k, r in eng.runners.items()})
        return out, eng

    def full_prompt(key, pre):
        x = P[key]["cpu"]
        return torch.cat([P[pre]["cpu"], x]) if pre else x

    cases = {
        "pool": (dict(slots=4, decode_horizon=4),
                 [("img", None), (900, None), (40, None), (100, 300),
                  (600, None), (50, 300)], 4, 3, 0),
        "chunk": (dict(slots=2, prefill_chunk=512),
                  [(40, None), ("img", None)], 1, 2, 0),
        "kv8": (dict(slots=2, kv_8bit=True), [(300, None), (40, None)], 2, 0,
                0),
        "spec": (dict(slots=2, spec_k=SPEC_K), [(300, None), (40, None)], 2,
                 0, 1)}
    rec: dict = dict(same_bytes=same_bytes)
    ok = same_bytes
    for name, (kw, reqs, wave, gap_steps, n_draft) in cases.items():
        got = {}
        for dev in ("cpu", "cuda"):
            m = models[dev]
            kw_dev = dict(kw, draft=self_draft(m, n_draft)) if n_draft else kw
            got[dev], eng = run(dev, m, reqs, wave, gap_steps, **kw_dev)
            if dev == "cuda":
                whole = [p is None and not (kw.get("prefill_chunk") and
                                            P[k]["cpu"].shape[0] > kw["prefill_chunk"])
                         for k, p in reqs]
                exp_k1 = sum(_serve_k1_per_admission(P[k]["cpu"].shape[0], w,
                                                     L + n_draft)
                             for (k, _), w in zip(reqs, whole))
                exp_k2 = _serve_k2_expected(
                    eng, k2_step, k2_per_round(n_draft, SPEC_K, L) if n_draft else 0)
                replayed = all(got[dev]["replays"][k] == got[dev]["steps"][k]
                               for k in eng.runners)
            del eng
        agree = [_teacher_forced(models["cpu"], full_prompt(k, p), a, b,
                                 SERVE_AGREE, kw.get("kv_8bit", False))
                 for (k, p), a, b in zip(reqs, got["cuda"]["ids"], got["cpu"]["ids"])]
        cos = [float(torch.nn.functional.cosine_similarity(a, b, dim=0))
               for a, b in zip(got["cuda"]["logits"], got["cpu"]["logits"])]
        c = got["cuda"]["counts"]
        r = dict(agree=agree, first_token_cos=[round(x, 6) for x in cos],
                 steps=got["cuda"]["steps"], admissions=got["cuda"]["admissions"],
                 tokens=[len(i) for i in got["cuda"]["ids"]],
                 k1=c["k1"], k2=c["k2"], expected_k1=exp_k1, expected_k2=exp_k2,
                 replayed=replayed, ids=[i[:6].tolist() for i in got["cuda"]["ids"]])
        r["ok"] = bool(all(a["ok"] for a in agree) and min(cos) >= CAP_COS_MIN
                       and c["k1"] == exp_k1 and c["k2"] == exp_k2 and replayed
                       and all(n == SERVE_NEW for n in r["tokens"]))
        rec[name] = r
        ok = ok and r["ok"]
    # a sampled request alone, then in slot 2 among co-tenants (card)
    sampled = gen.GenerateConfig(max_new_tokens=SERVE_NEW, temperature=0.7)
    m = models["cuda"]
    alone = DecodeEngine(m, slots=4, max_len=2048)
    a = alone.generate_all([P[300]["cuda"]], sampled)[0]
    busy = DecodeEngine(m, slots=4, max_len=2048)
    busy._free = [2, 0, 1, 3]
    uid = busy.submit(P[300]["cuda"], sampled)
    for key in (40, 100, 600):
        busy.submit(P[key]["cuda"], sampled)
    busy.run_until_idle()
    b = busy.result(uid)
    rec["sampled_placement"] = dict(
        slot=busy._requests[uid].slot, ids=a[:6].tolist(),
        equal=bool(np.array_equal(a[:SERVE_AGREE], b[:SERVE_AGREE])),
        ok=bool(busy._requests[uid].slot == 2 and len(a) == SERVE_NEW
                and np.array_equal(a[:SERVE_AGREE], b[:SERVE_AGREE])))
    ok = ok and rec["sampled_placement"]["ok"]
    _reset_counts()
    rec["ok"] = bool(ok)
    _say("reference", serve=rec)
    return rec


def _b64_png(img) -> str:
    import base64
    import io
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _chat_of_length(tok, words, n: int, offset: int) -> str:
    """A Llama-3 chat prompt of about n tokens (at least the template's):
    the user message is words[offset:offset + m], m found by bisection."""
    from rsvldm_tpu_torch.models.vlm.generate import llama3_chat_prompt
    count = lambda m: len(tok.encode(llama3_chat_prompt(
        " ".join(words[offset:offset + m])), add_special_tokens=False))
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if count(mid) <= n else (lo, mid - 1)
    return llama3_chat_prompt(" ".join(words[offset:offset + lo]))


def _serve_step_timing(eng, pos: int, iters: int = 20) -> dict:
    """The engine's decode step at all its slots, replayed from its graph
    at position `pos` of every row (sampled, T = 0.7): host wall per step
    with the token read, device time by CUDA events, and one replay under
    torch.profiler (device ms, the bf16 -> fp32 cache casts' share, K2's).
    The launches counted here are taken back."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    before = _counts()
    runner, out = eng.runners["decode"], eng._outs["decode"]
    with torch.inference_mode():
        st = eng._state
        st[0].copy_(torch.arange(eng.slots) * 997 + 11)
        st[1].fill_(pos)
        st[2].copy_(torch.arange(1, eng.slots + 1))
        st[3].fill_(8)
        eng._temps.fill_(0.7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            runner()
            out.cpu()
        wall = (time.perf_counter() - t0) * 1e3 / iters
        dev_ms = _time_ms(runner, iters, warmup=0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runner()
            torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type == DeviceType.CUDA]
    prof_ms = sum(t for _, t, _ in kernels)
    copy_ms = sum(t for k, t, _ in kernels if "copy_kernel" in k)
    k2_ms = sum(t for k, t, _ in kernels if "int4_decode_kernel" in k)
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    flash_attention.launches, int4_matmul.launches = before["k1"], before["k2"]
    return dict(slots=eng.slots, pos=pos, step_wall_ms=round(wall, 3),
                step_device_ms=round(dev_ms, 3),
                profiled_device_ms=round(prof_ms, 3),
                idle_share=round(1 - dev_ms / wall, 4),
                cast_copy_ms=round(copy_ms, 3),
                cast_copy_share=round(copy_ms / prof_ms, 4) if prof_ms else None,
                k2_ms=round(k2_ms, 3),
                k2_share=round(k2_ms / prof_ms, 4) if prof_ms else None,
                top_kernels=[[k[:70], round(t, 3), c] for k, t, c in
                             sorted(kernels, key=lambda r: -r[1])[:6]])


def _serve_http(worker, server, tok, words, seed: int) -> dict:
    """SERVE traffic over HTTP: 16 requests from threads, 50 ms apart: 4
    multimodal (a base64 224^2 tile each) and 12 text prompts of 40-900
    tokens, 64-128 new tokens each at T 0 / 0.2 / 0.7, one of them on
    /worker_generate_stream. Returns the per-request records and the
    wall seconds from the first send to the last reply."""
    import threading
    import urllib.request
    import numpy as np
    from PIL import Image
    from rsvldm_tpu_torch.models.vlm.generate import llama3_chat_prompt
    rng = np.random.default_rng(seed + 13)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    mm_prompt = llama3_chat_prompt(
        "<image>\nDescribe the land cover of this remote sensing tile.")
    reqs = []
    for i in range(4):
        tile = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
        reqs.append(dict(prompt=mm_prompt, images=[_b64_png(tile)]))
    for i, n in enumerate((40, 90, 150, 220, 300, 380, 460, 540, 620, 700, 800, 900)):
        reqs.append(dict(prompt=_chat_of_length(tok, words, n, 60 * i)))
    order = rng.permutation(len(reqs))
    temps = (0.0, 0.2, 0.7)
    for j, i in enumerate(order):
        reqs[i].update(max_new_tokens=int(64 + 64 * (j % 5) / 4),
                       temperature=temps[j % 3])
    stream_i = int(order[5])
    out = [None] * len(reqs)

    def client(j, i):
        time.sleep(0.05 * j)
        body = json.dumps(reqs[i]).encode()
        path = "/worker_generate_stream" if i == stream_i else "/worker_generate"
        t0 = time.perf_counter()
        try:
            r = urllib.request.urlopen(urllib.request.Request(
                url + path, body, {"Content-Type": "application/json"}), timeout=600)
            with r:
                if i == stream_i:
                    frames, first = [], None
                    for line in r:
                        if line.strip():
                            frames.append(json.loads(line))
                            first = first or time.perf_counter() - t0
                    res = dict(frames[-1], frames=len(frames), first_frame_s=first)
                else:
                    res = json.loads(r.read())
        except Exception as e:  # reported, and the phase fails
            res = {"error": f"{type(e).__name__}: {e}"}
        res.update(seconds=time.perf_counter() - t0, t_start=t0)
        out[i] = res

    threads = [threading.Thread(target=client, args=(j, int(i)))
               for j, i in enumerate(order)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return dict(reqs=reqs, out=out, wall_s=time.perf_counter() - t0,
                stream_i=stream_i)


def phase_serve(seed: int, cd: Path) -> dict:
    """The LLM worker at full width, as a user launches it:
    serving.llm_worker.main(--ckpt_dir <the path's directory> --load-4bit
    --slots 8 --max-len 4096 --no-register --port 0) loads the int4
    LLaVA-NeXT-8B captioner from the checkpoint directory, captures the
    engine's step graph and serves; 16 concurrent HTTP requests
    (_serve_http). Checks: every reply without error and not empty; every
    prompt embedded on the card by a handler thread while the stepping
    thread stepped; the graph captured before the first request and
    replayed at every decode step; K1 = 32 for each admission whose
    padded prompt is >= 1024 tokens, K2 = 225 a decode step + 1 an
    admission. Reports wall seconds, tokens, aggregate tok/s, time to
    first token (engine: submit to token 0), the admissions' seconds (each
    closed by a stream sync) and prompt tokens, the replayed decode step at
    8 slots (_serve_step_timing), capture seconds, load seconds, peak
    memory. Then on the same captioner one engine each, built from the
    worker's flags by llm_worker.build_engine: --prefix-file (a ~1100-token
    system prefix registered once: K1 32; 8 requests through
    LLMWorker.generate_text from threads), --prefill-chunk 512 (7 slots
    decoding, then an image request admitted in 3 chunks), --decode-horizon
    8, --kv-8bit (an int8 pool, one image request), and --self-draft 4
    --spec-k 4 at 4 slots (K2 k (7n + 1) + 7n + 225 a round); each with
    its launches against the reckoning, tokens and tok/s."""
    import gc
    import threading
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.models.vlm.generate import GenerateConfig
    from rsvldm_tpu_torch.serving import llm_worker

    rng = np.random.default_rng(seed + 14)
    words = _seeded_words(seed + 15, 20000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    worker, server = llm_worker.main(
        ["--ckpt_dir", str(cd), "--load-4bit", "--slots", str(SERVE_SLOTS),
         "--max-len", str(SERVE_MAX_LEN), "--no-register", "--port", "0"],
        block=False)
    rec: dict = dict(start_s=round(time.perf_counter() - t0, 3))
    eng = worker.engine
    cap = worker.embed_mm.__self__
    tok = cap.tokenizer
    captured = {k: (r.graph is not None, r.capture_s) for k, r in eng.runners.items()}
    seen = []

    def recorded(fn):
        def embed(*a):
            x = fn(*a)
            seen.append((x.device.type, threading.current_thread().name, x.shape[0]))
            return x
        return embed

    worker.embed_prompt = recorded(worker.embed_prompt)
    worker.embed_mm = recorded(worker.embed_mm)
    _reset_counts()
    http = _serve_http(worker, server, tok, words, seed)
    torch.cuda.synchronize()
    c = _counts()
    lens = [n for _, _, n in seen]
    exp_k1 = sum(_serve_k1_per_admission(n, True, 32) for n in lens)
    exp_k2 = _serve_k2_expected(eng, K2_PER_STEP)
    errors = [o.get("error") for o in http["out"] if "error" in o]
    tokens_expected = sum(r["max_new_tokens"] for r in http["reqs"])
    ttft = sorted(eng.first_token_s)
    graphs_kept = all(eng.runners[k].graph is not None and eng.runners[k].capture_s == s
                      and ok0 for k, (ok0, s) in captured.items())
    rec.update(
        requests=len(http["reqs"]), multimodal=4,
        prompt_tokens=lens, wall_s=round(http["wall_s"], 3),
        tokens=eng.generated, tokens_expected=tokens_expected,
        tok_s=round(eng.generated / http["wall_s"], 2),
        ttft_median_s=round(ttft[len(ttft) // 2], 3) if ttft else None,
        ttft_max_s=round(ttft[-1], 3) if ttft else None,
        stream=dict({k: v for k, v in http["out"][http["stream_i"]].items()
                     if k in ("frames", "first_frame_s", "finished", "seconds")}),
        decode_steps=eng.steps["decode"], admissions=eng.admissions,
        admission_s=round(eng.admission_s, 3),
        prefill_tokens=eng.prefill_tokens,
        admission_ms_per_token=(round(1e3 * eng.admission_s / eng.prefill_tokens, 4)
                                if eng.prefill_tokens else None),
        capture_s=round(sum(r.capture_s for r in eng.runners.values()), 3),
        graphs_captured_before_traffic=graphs_kept,
        replays=eng.runners["decode"].replays,
        embeds_on_card=all(d == "cuda" for d, _, _ in seen),
        embed_threads=len({t for _, t, _ in seen}),
        k1=c["k1"], k2=c["k2"], expected_k1=exp_k1, expected_k2=exp_k2,
        load_s=round(sum(v for k, v in cap.load_stats.items()
                         if k.endswith("_s")), 3),
        errors=errors[:3])
    rec["step"] = _serve_step_timing(eng, 1400)
    rec["peak_mem_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    rec["launches"] = dict(k1=c["k1"], k2=c["k2"], bwd=c["bwd"])
    ok = bool(not errors and len(seen) == 16 and rec["embeds_on_card"]
              and rec["embed_threads"] > 1 and graphs_kept
              and all(o.get("text") for o in http["out"])
              and c["k1"] == exp_k1 and c["k2"] == exp_k2 and exp_k1 > 0
              and eng.runners["decode"].replays >= eng.steps["decode"] > 0)
    worker.stop()
    server.shutdown()
    server.server_close()
    del worker, server, eng
    gc.collect()
    torch.cuda.empty_cache()

    # the engine's options on the same captioner
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    mm = cap.embed_mm
    text = lambda n, i: mm(_chat_of_length(tok, words, n, 500 + 80 * i), [])
    tile = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
    img = lambda: mm(_chat_of_length(tok, words, 0, 0).replace(
        "<|start_header_id|>user<|end_header_id|>\n\n",
        "<|start_header_id|>user<|end_header_id|>\n\n<image>\n"), [tile])
    modes, by_mode = {}, {}

    def mode(name, argv, drive, slots=SERVE_SLOTS, n_draft=0):
        args = llm_worker.parse_args(
            ["--ckpt_dir", str(cd), "--load-4bit", "--slots", str(slots),
             "--max-len", str(SERVE_MAX_LEN)] + argv)
        e = llm_worker.build_engine(args, cap)
        e.warmup()
        _reset_counts()
        t = time.perf_counter()
        lens_whole, extra_k1, info = drive(e, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        cc = _counts()
        exp1 = extra_k1 + sum(_serve_k1_per_admission(n, w, 32 + n_draft)
                              for n, w in lens_whole)
        exp2 = _serve_k2_expected(e, K2_PER_STEP,
                                  k2_per_round(n_draft) if n_draft else 0)
        r = dict(wall_s=round(wall, 3), tokens=e.generated,
                 tok_s=round(e.generated / wall, 2), steps=dict(e.steps),
                 admissions=e.admissions, admission_s=round(e.admission_s, 3),
                 prefill_tokens=e.prefill_tokens, k1=cc["k1"], k2=cc["k2"],
                 expected_k1=exp1, expected_k2=exp2,
                 capture_s=round(sum(x.capture_s for x in e.runners.values()), 3),
                 **info)
        r["ok"] = bool(cc["k1"] == exp1 and cc["k2"] == exp2
                       and r.pop("fine", True) and e.generated > 0)
        modes[name] = r
        by_mode[name] = cc
        del e
        gc.collect()
        torch.cuda.empty_cache()

    def drive_prefix(e, args):
        pf = work / "prefix.txt"
        head = "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
        n_pre = lambda m: len(tok.encode(head + " ".join(words[:m]) + "<|eot_id|>",
                                         add_special_tokens=False))
        m = next(m for m in range(50, 2000, 25) if n_pre(m) >= SERVE_PREFIX_TOKENS)
        pre = head + " ".join(words[:m]) + "<|eot_id|>"
        pf.write_text(pre, encoding="utf-8")
        w = llm_worker.LLMWorker(
            e, embed_prompt=lambda p: mm(p, []), decode_fn=tok.decode,
            worker_name="prefix", prefix_text=pf.read_text(encoding="utf-8"),
            embed_mm=mm, base_cfg=GenerateConfig(max_new_tokens=32,
                                                 temperature=0.0, do_sample=False))
        p_len = len(tok.encode(pre, add_special_tokens=False))
        outs = [None] * 8

        def ask(i):
            q = ("<|start_header_id|>user<|end_header_id|>\n\n"
                 + " ".join(words[2000 + 30 * i: 2000 + 30 * i + 10 + 8 * i])
                 + "<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n")
            outs[i] = w.generate_text(pre + q, temperature=0.2 * (i % 2))
        ts = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        w.stop()
        k1_prefix = 32 if -(-p_len // 128) * 128 >= 1024 else 0
        # the prefix registered inside the window; suffixes admitted at
        # offset p take the einsum path
        return [], k1_prefix, dict(prefix_tokens=p_len,
                                   fine=all(o for o in outs))

    def drive_chunk(e, args):
        cfg = GenerateConfig(max_new_tokens=64, temperature=0.2)
        embs = [text(40 + 40 * i, i) for i in range(7)]
        for x in embs:
            e.submit(x, cfg)
        e.step()
        x_img = img()
        uid = e.submit(x_img, cfg)
        req = e._requests[uid]
        gained, chunk_steps = 0, 0
        while not req.out_ids and not req.done:
            before = sum(len(r.out_ids) for r in e._active.values())
            e.step()
            chunk_steps += 1
            gained += sum(len(r.out_ids) for s, r in e._active.items()
                          if r is not req) - before
        e.run_until_idle()
        return ([(int(x.shape[0]), True) for x in embs]
                + [(int(x_img.shape[0]), False)], 0,
                dict(image_tokens=int(x_img.shape[0]), chunks=req.n_chunks,
                     steps_while_chunking=chunk_steps,
                     cotenant_tokens_while_chunking=gained,
                     fine=bool(req.n_chunks == chunk_steps and gained > 0)))

    def drive_batch(n_img, max_new, texts):
        def drive(e, args):
            cfg = GenerateConfig(max_new_tokens=max_new, temperature=0.2)
            embs = [img() for _ in range(n_img)] + [text(n, i) for i, n in enumerate(texts)]
            uids = [e.submit(x, cfg) for x in embs]
            e.run_until_idle()
            info = dict(prompt_tokens=[int(x.shape[0]) for x in embs],
                        fine=all(len(e.result(u)) for u in uids))
            if e.draft is not None:
                info["rounds"] = e.steps["spec"]
            if e.cache.k_scale is not None:
                info["pool_dtype"] = str(e.cache.k.dtype)
            return [(int(x.shape[0]), True) for x in embs], 0, info
        return drive

    mode("prefix", ["--prefix-file", str(work / "prefix.txt")], drive_prefix)
    mode("chunk", ["--prefill-chunk", "512"], drive_chunk)
    mode("horizon", ["--decode-horizon", "8"],
         drive_batch(0, 64, (40, 80, 120, 160, 200, 240, 280, 320)))
    mode("kv8", ["--kv-8bit"], drive_batch(1, 32, (40, 90, 140, 190, 240, 290, 340)))
    cap.attach_draft(None, named=False, spec_k=SPEC_K,
                     self_draft_layers=SELF_DRAFT_LAYERS)
    mode("spec", ["--self-draft", str(SELF_DRAFT_LAYERS), "--spec-k", str(SPEC_K)],
         drive_batch(1, 64, (60, 150, 300)), slots=4, n_draft=SELF_DRAFT_LAYERS)
    cap.attach_draft(None, named=False)
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    rec["modes"] = modes
    rec["ok"] = bool(ok and all(m["ok"] for m in modes.values()))
    rec["launches_modes"] = {k: sum(by_mode[m][k] for m in by_mode if m != "spec")
                             for k in ("k1", "k2", "bwd")}
    rec["launches_spec"] = by_mode.get("spec", {})
    _say("serve", **rec)
    del cap
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------- phase 6
# ----------------------------------------------- the other model families
# Card (bf16) against CPU (fp32) at a small width, on weights rounded to
# bf16 (families_reference): per family, the cosine of the logits at the
# prefill's last position and at 8 decode steps fed the CPU's greedy
# tokens; per tower or text module, the relative rms error of the features.
# An H100 gave cosines 0.99917-0.99999, the lowest 0.99752 at Mixtral's
# prefill position (a bf16 router picks another expert for a few tokens),
# and features 3.6e-3-1.1e-2; the limits leave 4x margin on 1 - cos
# there and 2.7x on the features. The cosine is only a gross-fault check:
# 1 - cos is second order in the error, so a fault that moves the logits
# by 10% of their norm costs only about 0.005. K1 at each family's prefill
# shape is held to K1's own limits, against a planted fault, in `kernels`.
FAM_COS_MIN = 0.99
TOWER_REL_TOL = 3e-2
# the small widths: heads of 128 (256 for Gemma) so that a 1100-token
# prefill reaches K1 on the card; MLCD at 448 pixels with heads of 104
_FAM_SMALL = dict(vocab_size=32000, dim=512, layers=2, heads=4, kv_heads=2,
                  ffn_dim=1024)
FAMILY_KNOBS = {
    "qwen2": dict(attn_bias=True, rope_theta=1e6, rms_eps=1e-6),
    "mistral": dict(sliding_window=512, rope_theta=1e4),
    "gemma": dict(norm_plus_one=True, scale_embeds=True, tie_lm_head=True,
                  act="gelu_tanh", heads=2, kv_heads=2, head_dim_cfg=256,
                  rms_eps=1e-6),
    "mixtral": dict(num_experts=4, experts_per_tok=2),
    "qwen2_moe": dict(attn_bias=True, num_experts=8, experts_per_tok=4,
                      moe_ffn_dim=256, norm_topk_prob=False,
                      shared_expert_dim=512),
}
FAM_QUANT = {"qwen2": "int4", "gemma": "int4"}  # the rest in bf16


def _bf16_rounded(module):
    import torch
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_floating_point():
                t.copy_(t.to(torch.bfloat16).float())
    return module


def _pair(build, family: str, quant: str | None = None):
    """(CPU fp32, card bf16) copies of one seeded module, its weights
    rounded to bf16 first (so both quantize the same values alike)."""
    import copy
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import quantize_llama_
    from rsvldm_tpu_torch.utils.weights import seeded_init_
    cpu = _bf16_rounded(seeded_init_(build(), family, torch.device("cpu")))
    card = copy.deepcopy(cpu).to("cuda", torch.bfloat16)
    if quant:
        quantize_llama_(cpu, quant)
        quantize_llama_(card, quant)
    return cpu.eval().requires_grad_(False), card.eval().requires_grad_(False)


def _teacher_forced_logits(model, toks, steps: int, cache, greedy=None):
    """The prefill's last logits and `steps` decode steps' logits (fed
    `greedy`, else the model's own argmax): ([steps + 1, vocab] fp32 CPU,
    the tokens fed)."""
    import torch
    dev = toks.device
    lg, _ = model(model.embed(toks), cache, 0)
    rows, fed = [lg[0, -1]], []
    for i in range(steps):
        nxt = int(rows[-1].argmax()) if greedy is None else greedy[i]
        fed.append(nxt)
        lg, _ = model(model.embed(torch.tensor([[nxt]], device=dev)), cache,
                      torch.tensor(toks.shape[1] + i, device=dev))
        rows.append(lg[0, -1])
    return torch.stack(rows).float().cpu(), fed


def phase_families_reference(seed: int, prompt: int = 1100, steps: int = 8):
    """Each decoder family at a small width, card against CPU on the same
    bf16-rounded weights and tokens: Qwen2 and Gemma on int4 bases (K2),
    Mistral with a 512-token window (no K1: its prefill takes the windowed
    general path), Mixtral and Qwen2-MoE (MoEFFN), MPT (ALiBi, no K1).
    K1 must launch once per layer for the others (1100 tokens), K2 7 times
    a layer and step (+ Qwen2's lm_head)."""
    import torch
    from rsvldm_tpu_torch.models.vlm import mpt
    from rsvldm_tpu_torch.models.vlm.llama import (KVCache, LlamaConfig,
                                                   LlamaModel)
    gen = torch.Generator().manual_seed(seed + 14)
    recs, ok = {}, True
    for family in list(FAMILY_KNOBS) + ["mpt"]:
        if family == "mpt":
            cfg = mpt.MPTConfig(vocab_size=32000, dim=512, layers=2, heads=4)
            cpu, card = _pair(lambda: mpt.MPTModel(cfg), "mpt")
            cache = lambda dev, dt: mpt.MPTKVCache.init(cfg, 1, prompt + steps,
                                                        dt, dev)
            quant = None
        else:
            cfg = LlamaConfig(**dict(_FAM_SMALL, **FAMILY_KNOBS[family]))
            quant = FAM_QUANT.get(family)
            cpu, card = _pair(lambda: LlamaModel(cfg), family, quant)
            cache = lambda dev, dt: KVCache.init(cfg, 1, prompt + steps, dt, dev)
        toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen)
        with torch.inference_mode():
            a, fed = _teacher_forced_logits(cpu, toks, steps,
                                            cache("cpu", torch.float32))
            _reset_counts()
            b, _ = _teacher_forced_logits(card, toks.cuda(), steps,
                                          cache("cuda", torch.bfloat16), fed)
            torch.cuda.synchronize()
            n = _counts()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        k1_want = (0 if family == "mpt" or getattr(cfg, "sliding_window", None)
                   else cfg.layers)
        k2_want = (steps * (7 * cfg.layers + (0 if cfg.tie_lm_head else 1))
                   if quant == "int4" else 0)
        rec = dict(quant=quant, cos=[round(float(c), 6) for c in cos],
                   top1=int((a.argmax(-1) == b.argmax(-1)).sum()),
                   k1=n["k1"], k1_reckoned=k1_want, k2=n["k2"],
                   k2_reckoned=k2_want)
        rec["ok"] = bool(float(cos.min()) >= FAM_COS_MIN and n["k1"] == k1_want
                         and n["k2"] == k2_want)
        ok = ok and rec["ok"]
        recs[family] = rec
        del cpu, card
    _reset_counts()
    towers = _towers_reference(seed)
    ok = ok and towers["ok"]
    runs = list(recs.values()) + list(towers["modules"].values())
    launches = dict(k1=sum(r["k1"] for r in runs),
                    k2=sum(r.get("k2", 0) for r in runs), bwd=0)
    rec = dict(families=recs, towers=towers, ok=ok, launches=launches,
               tol=f"cos >= {FAM_COS_MIN} at every position; features "
                   f"rel rms <= {TOWER_REL_TOL}; launches as reckoned")
    _say("families_reference", **rec)
    return rec


def _towers_reference(seed: int):
    """The towers, resamplers, projectors and T5 at a small width, card
    (bf16) against CPU (fp32) on bf16-rounded weights: MLCD at 448 pixels
    with heads of 104 (1025 tokens: K1 padded, once per block run), EVA02
    and EVA01, SigLIP, open_clip indexing, T5 on 77 tokens, the Q-Former,
    the perceiver and the pooler projector."""
    import torch
    from rsvldm_tpu_torch.models.text import t5
    from rsvldm_tpu_torch.models.vlm import (eva_vit, projector, resampler,
                                             siglip, vision)
    gen = torch.Generator().manual_seed(seed + 15)
    px = lambda side: torch.randn((2, side, side, 3), generator=gen)
    mods = {
        "mlcd_448_d104": (lambda: vision.CLIPVisionTower(vision.CLIPVisionConfig(
            image_size=448, width=208, layers=3, heads=2, act="gelu",
            ffn_width=256, pos_embed="rope2d")), px(448), 2),
        "open_clip_336": (lambda: vision.CLIPVisionTower(vision.CLIPVisionConfig(
            width=128, layers=4, heads=2, hidden_base="open_clip",
            select_feature="slicefour_patch", select_layer=-1)), px(336), 0),
        "eva02_336": (lambda: eva_vit.EvaVisionTower(eva_vit.EvaVitConfig(
            width=128, layers=3)), px(336), 0),
        "eva01_224": (lambda: eva_vit.EvaVisionTower(eva_vit.EvaVitConfig(
            image_size=224, width=128, layers=3, head_width=64, rope=False,
            naiveswiglu=False, subln=False, intp_freq=False,
            ls_init_value=0.1)), px(224), 0),
        "siglip_384": (lambda: siglip.SigLIPVisionTower(siglip.SigLIPVisionConfig(
            width=128, layers=3, heads=2, mlp_dim=256)), px(384), 0),
        "t5_77": (lambda: t5.T5Encoder(t5.T5Config(
            vocab_size=32128, d_model=256, d_kv=64, d_ff=512, layers=2,
            heads=4)), torch.randint(0, 32128, (2, 77), generator=gen), 0),
        "qformer": (lambda: resampler.QFormerResampler(resampler.QFormerConfig(
            hidden_size=128, layers=2, heads=2, intermediate=256,
            encoder_width=128, num_latents=32)), torch.randn((2, 576, 128),
                                                             generator=gen), 0),
        "perceiver": (lambda: resampler.PerceiverResampler(
            resampler.PerceiverConfig(dim=128, depth=2, heads=2)),
            torch.randn((2, 576, 128), generator=gen), 0),
        "pooler": (lambda: projector.PoolerProjector(128, 256, hw=24),
                   torch.randn((2, 576, 128), generator=gen), 0),
    }
    recs, ok = {}, True
    rms = lambda t: float(t.square().mean().sqrt())
    for name, (build, x, k1_want) in mods.items():
        cpu, card = _pair(build, name)
        xc = x.cuda() if not x.is_floating_point() else x.cuda().to(torch.bfloat16)
        with torch.inference_mode():
            a = cpu(x).float()
            _reset_counts()
            b = card(xc).float().cpu()
            torch.cuda.synchronize()
            k1 = _counts()["k1"]
        rel = rms(a - b) / max(rms(a), 1e-30)
        recs[name] = dict(shape=list(a.shape), rel_rms_err=rel, k1=k1,
                          k1_reckoned=k1_want,
                          ok=bool(rel <= TOWER_REL_TOL and k1 == k1_want
                                  and bool(torch.isfinite(b).all())))
        ok = ok and recs[name]["ok"]
    _reset_counts()
    return dict(modules=recs, ok=ok)


def _free_card():
    """Collect the previous model (a decode loop's state and its graph refer
    to each other) and return its memory, so that each run's peak is its
    own."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _seeded_on_card(build, family: str):
    """`build()` on the meta device, then on the card in bf16 with seeded
    weights (utils/weights.seeded_init_)."""
    import torch
    from rsvldm_tpu_torch.utils.weights import seeded_init_
    with torch.device("meta"):
        m = build()
    m = m.to(dtype=torch.bfloat16).to_empty(device="cuda")
    return seeded_init_(m, family, torch.device("cuda")).eval().requires_grad_(False)


def _family_caption(cfg, quant: str, seed: int, name: str) -> dict:
    """One 224^2 tile captioned through LlavaCaptioner.seeded on the card
    (CLIP-L/336 + mlp2x_gelu to cfg.dim + the family's decoder, `quant`):
    64 tokens at T = 0.2."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import LlavaConfig
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.vision import CLIP_VIT_L_336_CONFIG
    _free_card()
    t0 = time.perf_counter()
    cap = LlavaCaptioner.seeded(cfg, CLIP_VIT_L_336_CONFIG, StandInTokenizer(),
                                quant=quant, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 16)
    img = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
    lcfg = LlavaConfig(max_new_tokens=64)
    cap.caption(img, lcfg)  # the first call captures the decode graph
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = cap.caption(img, lcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, st = _counts(), cap.last_stats
    steps = st["decode_steps"]
    per_step = 7 * cfg.layers + (0 if cfg.tie_lm_head else 1)
    rec = dict(model=name, quant=quant, build_s=build_s, caption_s=wall,
               prompt_len=st["prompt_len"], padded_len=st["padded_len"],
               prefill_ms=st["prefill_s"] * 1e3, decode_steps=steps,
               decode_tok_s=steps / max(st["decode_s"], 1e-9),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               k1=n["k1"], k1_reckoned=cfg.layers, k2=n["k2"],
               k2_reckoned=steps * per_step + (0 if cfg.tie_lm_head else 1),
               caption_words=len(text.split()))
    rec["ok"] = bool(st["padded_len"] >= 1024 and n["k1"] == rec["k1_reckoned"]
                     and n["k2"] == rec["k2_reckoned"] and steps > 0)
    del cap
    _free_card()
    return rec


def _family_decode(build, family: str, cfg, seed: int, name: str,
                   prompt: int = 1200, steps: int = 32) -> dict:
    """A seeded bf16 decoder on the card: a `prompt`-token prefill (padded
    to 1280) and `steps` greedy decode steps through generate (replayed
    from a CUDA graph after the first run); MPT by its own loop."""
    import torch
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm import mpt
    _free_card()
    t0 = time.perf_counter()
    model = _seeded_on_card(build, family)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                         device="cuda")
    with torch.inference_mode():
        if isinstance(model, mpt.MPTModel):
            def run():
                cache = mpt.MPTKVCache.init(cfg, 1, prompt + steps, torch.bfloat16,
                                            "cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, _ = model(model.embed(toks), cache, 0)
                tok = lg[0, -1].argmax().reshape(1, 1)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for i in range(steps):
                    lg, _ = model(model.embed(tok), cache,
                                  torch.tensor(prompt + i, device="cuda"))
                    tok = lg[0, -1].argmax().reshape(1, 1)
                torch.cuda.synchronize()
                return dict(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                            decode_steps=steps, padded_len=prompt)
        else:
            emb = model.embed(toks[0])
            gcfg = gen.GenerateConfig(max_new_tokens=steps + 1, do_sample=False,
                                      eot_ids=(-1,))
            cache: dict = {}

            def run():
                st = {}
                gen.generate(model, emb, gcfg, stats=st, graph_cache=cache)
                return st
        run()  # the first run builds (and on the card captures) the loop
        _reset_counts()
        st = run()
    n = _counts()
    k1_want = (0 if isinstance(model, mpt.MPTModel)
               or getattr(cfg, "sliding_window", None) else cfg.layers)
    rec = dict(model=name, build_s=build_s, prefill_ms=st["prefill_s"] * 1e3,
               padded_len=st["padded_len"], decode_steps=st["decode_steps"],
               decode_tok_s=st["decode_steps"] / max(st["decode_s"], 1e-9),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               k1=n["k1"], k1_reckoned=k1_want, k2=n["k2"], k2_reckoned=0)
    rec["ok"] = bool(n["k1"] == k1_want and n["k2"] == 0
                     and st["decode_steps"] == steps)
    del model
    _free_card()
    return rec


MIXTRAL_LAYERS = 8  # of Mixtral-8x7B's 32: 93 GB in bf16 at full depth


def phase_families(seed: int) -> dict:
    """The other decoder families at their published widths, one at a time:
    Gemma-7B and Qwen2-7B int4 captions of one tile (LlavaCaptioner.seeded
    + caption: K1 28 in the prefill, K2 196 / 197 a decode step, + 1 for
    Qwen2's prefill lm_head), Qwen2-MoE-A2.7B, Mistral-7B (window cut to
    512 for this run: no K1), Mixtral-8x7B at MIXTRAL_LAYERS layers and
    MPT-7B (ALiBi, no K1) in bf16: a prefill and 32 decode steps each."""
    import dataclasses as dc
    from rsvldm_tpu_torch.models.vlm import llama, mpt
    recs = [_family_caption(llama.GEMMA_7B_CONFIG, "int4", seed, "gemma-7b"),
            _family_caption(llama.QWEN2_7B_CONFIG, "int4", seed, "qwen2-7b")]
    for name, cfg in (
            ("qwen2-moe-a2.7b", llama.QWEN2_MOE_A2_7B_CONFIG),
            ("mistral-7b-window512", dc.replace(llama.MISTRAL_7B_CONFIG,
                                                sliding_window=512)),
            (f"mixtral-8x7b-{MIXTRAL_LAYERS}l",
             dc.replace(llama.MIXTRAL_8X7B_CONFIG, layers=MIXTRAL_LAYERS))):
        recs.append(_family_decode(lambda c=cfg: llama.LlamaModel(c),
                                   name.split("-")[0], cfg, seed, name))
    recs.append(_family_decode(lambda: mpt.MPTModel(mpt.MPT_7B_CONFIG), "mpt",
                               mpt.MPT_7B_CONFIG, seed, "mpt-7b"))
    for r in recs:
        _say("families", **r)
    launches = dict(k1=sum(r["k1"] for r in recs), k2=sum(r["k2"] for r in recs),
                    bwd=0)
    rec = dict(ok=all(r["ok"] for r in recs), launches=launches)
    _say("families", **rec)
    _reset_counts()
    return rec


def _tower_run(spec, x, name: str, k1_want: int, s2: bool = False) -> dict:
    import torch
    from rsvldm_tpu_torch.models.vlm.vision import s2_multiscale_features
    fn = ((lambda t: s2_multiscale_features(spec.module, t, scales=(336, 672)))
          if s2 else spec.module)
    with torch.inference_mode():
        fn(x)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    k1 = _counts()["k1"]
    rec = dict(module=name, batch=int(x.shape[0]), ms=ms,
               feature_shape=list(y.shape), k1=k1, k1_reckoned=k1_want,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               ok=bool(torch.isfinite(y.float()).all() and k1 == k1_want))
    _say("towers", **rec)
    return rec


def phase_towers(seed: int, batch: int = 5) -> dict:
    """Every build_vision_tower family at its published size (seeded bf16
    weights, one batch of `batch` normalized images each): CLIP-L-336,
    SigLIP-so400m-384, EVA02-L-336, EVA01-g-14, open_clip ViT-H-14-378,
    MLCD-bigG-336, MLCD-bigG-448 (1025 tokens: K1 with heads of 104 padded
    to 128, once in each of the 47 blocks run), S2 over CLIP-L at (336,
    672); then T5-XXL's encoder on 77 tokens, a Q-Former and a perceiver
    resampler over 576 CLIP-L features and the pooler projector to 4096:
    ms (host clock around a synchronised call, after one warm call), the
    feature shape, K1 launches against the reckoning."""
    from types import SimpleNamespace
    import torch
    from rsvldm_tpu_torch.models.text import t5
    from rsvldm_tpu_torch.models.vlm import projector, resampler
    from rsvldm_tpu_torch.models.vlm.towers import build_vision_tower
    g = torch.Generator(device="cuda").manual_seed(seed + 18)
    recs = []
    names = (("openai/clip-vit-large-patch14-336", 0),
             ("google/siglip-so400m-patch14-384", 0),
             ("EVA02-CLIP-L-14-336", 0), ("EVA01-CLIP-g-14", 0),
             ("open_clip_hub:ViT-H-14-378-quickgelu", 0),
             ("DeepGlint-AI/mlcd-vit-bigG-patch14-336", 0),
             ("DeepGlint-AI/mlcd-vit-bigG-patch14-448", 47))
    for name, k1_want in names:
        _free_card()
        spec = build_vision_tower(name, device="cuda")
        x = torch.randn((batch, spec.image_size, spec.image_size, 3), generator=g,
                        device="cuda").to(torch.bfloat16)
        recs.append(_tower_run(spec, x, name, k1_want))
        if name.startswith("openai"):
            x = torch.randn((1, 672, 672, 3), generator=g, device="cuda")
            recs.append(_tower_run(spec, x.to(torch.bfloat16), "s2(336,672)", 0,
                                   s2=True))
        del spec, x
        torch.cuda.empty_cache()
    for name, build, x in (
            ("t5-v1_1-xxl encoder, 77 tokens",
             lambda: t5.T5Encoder(t5.T5_V1_1_XXL_CONFIG),
             torch.randint(0, 32128, (batch, 77), generator=g, device="cuda")),
            ("qformer (bert-base, 32 queries)",
             lambda: resampler.QFormerResampler(resampler.QFormerConfig()),
             torch.randn((batch, 576, 1024), generator=g, device="cuda")),
            ("perceiver (depth 3, 32 latents)",
             lambda: resampler.PerceiverResampler(resampler.PerceiverConfig()),
             torch.randn((batch, 576, 1024), generator=g, device="cuda")),
            ("pooler projector 1024 -> 4096",
             lambda: projector.PoolerProjector(1024, 4096, hw=24),
             torch.randn((batch, 576, 1024), generator=g, device="cuda"))):
        _free_card()
        module = _seeded_on_card(build, name)
        xin = x if not x.is_floating_point() else x.to(torch.bfloat16)
        recs.append(_tower_run(SimpleNamespace(module=module), xin, name, 0))
        del module
        torch.cuda.empty_cache()
    rec = dict(ok=all(r["ok"] for r in recs),
               launches=dict(k1=sum(r["k1"] for r in recs), k2=0, bwd=0))
    _say("towers", **rec)
    _reset_counts()
    return rec


def phase_profile(pipe, iters: int = 10):
    """The loops' steps as process() runs them, each replayed from a CUDA
    graph (utils/graphs.StepRunner): one int4 decode step of the caption
    (position 1300 of a 1536-slot cache), one SR3 ancestral step (224^2),
    one cache-miss step (GLVControl + UNet input blocks + rest + CFG) and
    one cache-hit step (GLVControl + input blocks) of the 128^2-latent
    RestoreEDM loop, CFG batch 2: wall time per replay and per direct call,
    device time by kernel under torch.profiler, K1's or K2's share, and the
    device's idle share while replaying."""
    import torch
    from rsvldm_tpu_torch.diffusion.guidance import apply_cfg
    from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser
    from rsvldm_tpu_torch.models.sr3.diffusion import ancestral_step
    from rsvldm_tpu_torch.models.vlm import generate as gen

    dev, cfg = pipe.device, pipe.sdxl_cfg
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s, dt=torch.float32: torch.randn(s, generator=g, device=dev,
                                                   dtype=dt)
    cond = dict(crossattn=rnd(2, 77, cfg.context_dim, dt=pipe.dtype),
                vector=rnd(2, cfg.adm_in_channels), control=rnd(2, 4, 128, 128))
    x, sigma = rnd(2, 4, 128, 128), torch.full((2,), 5.0, device=dev)
    cs = torch.ones((), device=dev)
    scale = torch.full((), 7.5, device=dev)
    den = ControlDenoiser(unet=pipe.unet, control_net=pipe.control)
    llama = pipe.llava.llama
    st = gen._decode_state(llama, gen.GenerateConfig(max_new_tokens=128),
                           1408, dev)
    st.pos.fill_(1300)
    sr3_step, _ = ancestral_step(pipe.sr3_diff, pipe.sr3,
                                 rnd(1, 224, 224, 3).clamp(-1, 1),
                                 rnd(pipe.sr3_diff.buffers.num_timesteps + 1,
                                     1, 224, 224, 3))
    steps = {"decode": lambda: gen.decode_step(llama, st, None),
             "sr3": sr3_step,
             "miss": lambda: apply_cfg(den.rest(den.first(x, sigma, cond),
                                                cond, cs), scale),
             "hit": lambda: den.first(x, sigma, cond).h}
    hand_of = {"decode": "int4_decode_kernel", "sr3": None,
               "miss": "flash_fwd_kernel", "hit": "flash_fwd_kernel"}
    return _profile_steps(steps, hand_of, iters)


def _profile_steps(steps: dict, hand_of: dict, iters: int) -> dict:
    """Each step function of `steps` replayed from a CUDA graph: wall time
    per replay and per direct call, device time by kernel under
    torch.profiler, the share of its hand kernel (`hand_of`), the share
    of bf16 -> fp32 copies, and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rsvldm_tpu_torch.utils.graphs import StepRunner
    out = {}

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    with torch.inference_mode():
        for name, fn in steps.items():
            runner = StepRunner(fn, True)
            runner()  # direct
            runner()  # capture, replay
            direct_ms = wall_ms(fn)
            replay_ms = wall_ms(runner)
            event_ms = _time_ms(runner, iters, warmup=0)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                runner()
                torch.cuda.synchronize()
            kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0
                       and e.device_type == DeviceType.CUDA]
            dev_ms = sum(t for _, t, _ in kernels)
            copy_ms = sum(t for k, t, _ in kernels if "copy_kernel" in k)
            mine = hand_of[name]
            hand = [(t, c) for k, t, c in kernels if mine and mine in k]
            hand_ms = sum(t for t, _ in hand)
            out[name] = dict(
                replay_wall_ms=round(replay_ms, 3),
                direct_wall_ms=round(direct_ms, 3),
                replay_event_ms=round(event_ms, 3),
                device_ms=round(dev_ms, 3),
                device_idle_share=round(1 - dev_ms / replay_ms, 4),
                capture_s=round(runner.capture_s, 3), hand_kernel=mine,
                hand_ms=round(hand_ms, 3),
                hand_launches=sum(c for _, c in hand),
                hand_share_of_device=round(hand_ms / dev_ms, 4)
                if dev_ms else None,
                copy_ms=round(copy_ms, 3),
                copy_share_of_device=round(copy_ms / dev_ms, 4)
                if dev_ms else None,
                kernel_launches=sum(c for _, _, c in kernels),
                top_kernels=[[k[:80], round(t, 3), c] for k, t, c in
                             sorted(kernels, key=lambda r: -r[1])[:10]])
            _say("profile", step=name, **out[name])
            del runner
    return out


# ---------------------------------------------------------- phase parallel
# Two ranks on the one card over gloo (NCCL refuses two ranks on one
# device), workers of this same script (--parallel-worker), against the
# script's own process run without a mesh on the same seed; then a world of
# one over NCCL in the script's process. Limits:
# - the TP=2 caption's logits (prefill and every step, teacher-forced on
#   the unsharded run's greedy ids): cosine >= PAR_COS_MIN. The row-parallel
#   int4 products sum two fp32 partials where the unsharded one sums all
#   groups in one order, then both round to bf16: a few bf16 ulps a layer.
#   A rank that dropped its partial gives a cosine near 0.7;
# - folder Stage 1 at data=2 against the unsharded run: uint8 images within
#   REF_MEAN_TOL / REF_MAX_TOL levels (phase reference's limit);
#   bit-equality is reported;
# - the tiled VAE at tile=2 against the unsharded tiled VAE, held in fp32
#   (the weights widened): latents within PAR_VAE_REL_RMS relative rms and
#   the image within PAR_VAE_MAX_LEVELS uint8 levels; what differs is the
#   sharded GroupNorm's E[x^2] - mean^2 formula and two batches of 8 tiles
#   for one of 16. In bf16 (the path's dtype) an H100 gave 0.95% latent
#   rms and 1.40 mean / 17 max levels against the unsharded run, over
#   phase tiled's REF_MAX_TOL: there only the mean is held (REF_MEAN_TOL).
#   The script's process runs three witnesses in bf16 (`_Meet`): the
#   ranks' batch of 8 with the one process's statistics (on an H100: the
#   latents bit-equal, 4 levels), the one batch of 16 with the ranks'
#   formula (the whole 0.95% and 17 levels: its fp32 cancellation is the
#   cause), and both, which is what the ranks compute: the bf16 ranks are
#   held to it with the fp32 limits;
# - DP SR3 training, 4 steps at global batch 8 (4 a rank): each step's
#   loss within PAR_LOSS_RTOL of the single process's (fp32 sums in
#   another order), the parameters' distance from the single process's
#   within PAR_UPDATE_RTOL of the distance they moved (a rank training on
#   its half alone, without the gradient all-reduce, is off by about the
#   whole update), and every rank's parameters equal bit for bit;
# - the world of one over NCCL: the caption's decoder stays whole (no tp,
#   its steps captured) and its ids equal the unsharded run's; the
#   collectives of parallel/distributed.py give their values on it;
# - Stage 1 at data=2 also against its one-process witness at the ranks'
#   batch size (each rank's rows in a loop of their own, with their rows
#   of the group's draw): uint8-equal, bit for bit;
# - the TP=2 caption again with a LoRA archive attached (each rank its
#   slices of the adapters, the int4 decoder's runtime branch), against
#   one process with the same archive: logit cosine >= PAR_COS_MIN at
#   every teacher-forced position, greedy ids equal, K1 and K2 as
#   reckoned, over PAR_LORA_TOKENS tokens;
# - VLMTrainer at data=2 (`mesh=`) on the int8 Llama-3-8B, LoRA r=16 on
#   the seven projections, remat, 2 of PAR_VLM_ROWS text records of
#   PAR_VLM_WIDTH tokens a rank, whose supervised counts differ: each
#   step's loss within TRAIN_LOSS_RTOL of one process on all rows, K1 64
#   and the backward 32 a step a rank, the ranks' adapters equal bit for
#   bit.
PAR_NEW_TOKENS = 64
PAR_LORA_TOKENS = 32
PAR_LORA_B_STD = 0.01  # the seeded archive's b ~ N(0, std^2)
PAR_VLM_STEPS, PAR_VLM_ROWS, PAR_VLM_WIDTH = 3, 4, 1536
PAR_COS_MIN = 0.999
PAR_VAE_REL_RMS, PAR_VAE_MAX_LEVELS = 1e-3, 2
PAR_LOSS_RTOL, PAR_UPDATE_RTOL = 1e-4, 1e-2
PAR_LR_SIDES = (28, 28, 28, 28)
PAR_TRAIN_STEPS, PAR_TRAIN_BATCH = 4, 8
PAR_TIMEOUT_S = 600
# the TP=2 DecodeEngine (int4 Llama-3-8B, 2 slots): the caption's image
# prompt (padded to 1280: K1 at its admission) and three text prompts of
# these lengths, 32 greedy tokens each; a speculative engine (draft ==
# target, k = 2) on the second prompt; the teacher-forced positions whose
# logits are held to the one process's (cosine >= PAR_COS_MIN)
PAR_ENGINE_TOKENS, PAR_ENGINE_SHORT, PAR_ENGINE_TF = 32, (37, 150, 290), 16
PAR_ENGINE_MAX_LEN, PAR_SPEC_K = 1408, 2
# a rank's stream may leave the one process's only where the one process's
# best logit and its logit of the rank's token tie within this many bf16
# ulps of the best (both argmaxes are then right; the logits come out of
# the lm_head in bf16, where random weights tie often)
PAR_TIE_ULPS = 2
# sequence-parallel attention against one process: fp32 max |err| (the
# same fp32 products in another grouping) and bf16 relative rms (the
# probabilities rounded to bf16 before the product, as JAX's einsum takes
# them, against an fp32 reference)
PAR_SP_ATOL_FP32, PAR_SP_REL_RMS_BF16 = 1e-5, 1e-2
# GPipe against the sequential run: bit-equality expected (the same kernels
# on the same inputs), else within this relative rms
PAR_PP_REL_RMS = 1e-3
PAR_PP_STAGES, PAR_PP_BLOCKS, PAR_PP_MICRO = 2, 4, 4


def _par_cfg(tiny: bool) -> dict:
    """The phase's models: full width, or (`tiny`, a CPU rehearsal of the
    phase's control flow) the tests' tiny geometries."""
    from rsvldm_tpu_torch.models.vlm.llama import LLAMA3_8B_CONFIG, LlamaConfig
    from rsvldm_tpu_torch.models.vlm.vision import (CLIP_VIT_L_336_CONFIG,
                                                    CLIPVisionConfig)
    if not tiny:
        return dict(device="cuda", llama=LLAMA3_8B_CONFIG,
                    vision=CLIP_VIT_L_336_CONFIG, quant="int4", model_cfgs=None,
                    vae_side=2048, enc_tile=512, dec_tile=64, train_side=224,
                    lr_sides=PAR_LR_SIDES, upscale=8, s1_steps=None,
                    vlm_width=PAR_VLM_WIDTH, sp=(1, 4096, 32, 8, 128),
                    pp_tokens=1024)
    from rsvldm_tpu_torch.infer import tiny_model_cfgs
    # 128-wide heads and FFN, so the int4 shards keep whole 128-groups
    llama = LlamaConfig(vocab_size=128256, dim=512, layers=2, heads=4,
                        kv_heads=4, ffn_dim=512)
    vision = CLIPVisionConfig(width=32, layers=2, heads=1)
    return dict(device="cpu", llama=llama, vision=vision, quant="int4",
                model_cfgs=tiny_model_cfgs(), vae_side=128, enc_tile=64,
                dec_tile=8, train_side=16, lr_sides=(4, 4, 4, 4), upscale=4,
                s1_steps=4, vlm_width=64, sp=(1, 256, 4, 2, 32), pp_tokens=64)


def _par_sync(dev):
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()


def _par_peak_gib(dev) -> float | None:
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda" else None


def _par_image(seed: int):
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed + 16)
    return Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))


def _par_prompt():
    from rsvldm_tpu_torch.config import LlavaConfig
    from rsvldm_tpu_torch.models.vlm.generate import llama3_chat_prompt
    return llama3_chat_prompt(LlavaConfig().img_prompt.format(
        DEFAULT_IMAGE_TOKEN="<image>"))


def _par_gcfg(tokens: int = PAR_NEW_TOKENS):
    from rsvldm_tpu_torch.models.vlm.generate import GenerateConfig
    # eot never: every run makes exactly `tokens` tokens
    return GenerateConfig(max_new_tokens=tokens, do_sample=False,
                          eot_ids=(-1,))


def _tf_logits(model, spliced, ids, lora=None):
    """fp32 logits [1 + len(ids) - 1, vocab] on the host: the prefill's at
    the prompt's last position, then one decode step per id of `ids`
    (teacher-forced) but the last; `lora` as the forward takes it."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    dev = spliced.device
    s = spliced.shape[0]
    with torch.inference_mode():
        cache = KVCache.init(model.cache_cfg, 1, s + len(ids), model.dtype, dev)
        lg, _ = model(spliced[None], cache, 0, lora=lora,
                      logits_at=torch.tensor([s - 1], device=dev))
        out = [lg[0, -1].float().cpu()]
        for i, t in enumerate(ids[:-1]):
            tok = torch.tensor([[int(t)]], device=dev)
            lg, _ = model(model.embed(tok), cache,
                          torch.tensor(s + i, device=dev), lora=lora)
            out.append(lg[0, -1].float().cpu())
    return torch.stack(out)


def _par_lora_archive(cfg: dict, path: Path, seed: int) -> int:
    """A seeded LoRA archive (save_lora_npz, r=16 alpha=16) for the
    decoder of `cfg`: a ~ U(+-1/sqrt(in)) as init_lora draws it, b ~
    N(0, PAR_LORA_B_STD^2), on the host; its bytes."""
    import torch
    from rsvldm_tpu_torch.training.vlm_trainer import LoraConfig, save_lora_npz
    from rsvldm_tpu_torch.utils.weights import lora_module_path
    c, r = cfg["llama"], 16
    q, kv = c.heads * c.head_dim, c.kv_heads * c.head_dim
    dims = {"q_proj": (c.dim, q), "k_proj": (c.dim, kv), "v_proj": (c.dim, kv),
            "o_proj": (q, c.dim), "gate_proj": (c.dim, c.ffn_dim),
            "up_proj": (c.dim, c.ffn_dim), "down_proj": (c.ffn_dim, c.dim)}
    gen = torch.Generator().manual_seed(seed + 22)
    lora = {lora_module_path(i, proj): {
        "a": (torch.rand((fin, r), generator=gen) * 2 - 1) / fin ** 0.5,
        "b": torch.randn((r, fout), generator=gen) * PAR_LORA_B_STD}
        for i in range(c.layers) for proj, (fin, fout) in dims.items()}
    save_lora_npz(lora, LoraConfig(r=r, alpha=r), path)
    return path.stat().st_size


def _par_lora_ref(cap, spliced, work: Path) -> dict:
    """The unsharded caption again with the archive <work>/lora.npz
    attached (the int4 decoder's runtime branch): PAR_LORA_TOKENS greedy
    ids and their teacher-forced logits, saved for the ranks."""
    import torch
    from rsvldm_tpu_torch.models.vlm.generate import generate
    cap.attach_archives(lora_npz=work / "lora.npz")
    gcfg, st = _par_gcfg(PAR_LORA_TOKENS), {}
    generate(cap.llama, spliced, gcfg, lora=cap.lora)  # captures
    _reset_counts()
    ids = generate(cap.llama, spliced, gcfg, stats=st, lora=cap.lora)
    n = _counts()
    logits = _tf_logits(cap.llama, spliced, ids, cap.lora)
    torch.save({"ids": torch.from_numpy(ids.astype("int64")),
                "logits": logits}, work / "caption_lora_ref.pt")
    return dict(tokens=len(ids), k1=n["k1"], k2=n["k2"],
                decode_tok_s=st["decode_steps"] / max(st["decode_s"], 1e-9))


def _par_caption_ref(seed: int, cfg: dict, work: Path) -> dict:
    """The unsharded caption: greedy ids, teacher-forced logits (saved for
    the ranks); then the same captioner sharded over a world of one on
    NCCL, whose ids must be the same."""
    import torch
    import torch.distributed as dist
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.generate import generate
    from rsvldm_tpu_torch.parallel.distributed import init_world_of_one
    from rsvldm_tpu_torch.parallel.llama_sharding import shard_llama_
    from rsvldm_tpu_torch.parallel.mesh import make_mesh
    dev = cfg["device"]
    if dev == "cuda":
        _free_card()
    cap = LlavaCaptioner.seeded(cfg["llama"], cfg["vision"], StandInTokenizer(),
                                quant=cfg["quant"], device=dev)
    spliced = cap.embed_mm(_par_prompt(), [_par_image(seed)])
    gcfg, st = _par_gcfg(), {}
    generate(cap.llama, spliced, gcfg)  # captures the decode graph
    _reset_counts()
    ids = generate(cap.llama, spliced, gcfg, stats=st)
    n = _counts()
    logits = _tf_logits(cap.llama, spliced, ids)
    torch.save({"ids": torch.from_numpy(ids.astype("int64")),
                "logits": logits}, work / "caption_ref.pt")
    rec = dict(prompt_len=st["prompt_len"], padded_len=st["padded_len"],
               prefill_ms=st["prefill_s"] * 1e3,
               decode_tok_s=st["decode_steps"] / max(st["decode_s"], 1e-9),
               k1=n["k1"], k2=n["k2"], peak_gib=_par_peak_gib(dev))
    # a world of one over NCCL (gloo in the CPU rehearsal): the decoder
    # "sharded" over it stays whole (no tp), so its steps keep their graph;
    # the collectives themselves are held on the group's CUDA tensors
    backend = "nccl" if dev == "cuda" else "gloo"
    init_world_of_one(backend)
    try:
        mesh = make_mesh(1)
        shard_llama_(cap.llama, mesh.get_group("data"))
        _reset_counts()
        st1 = {}
        ids1 = generate(cap.llama, spliced, gcfg, stats=st1)
        n1 = _counts()
        rec["world_of_one"] = dict(
            backend=dist.get_backend(), tp_none=cap.llama.tp is None,
            ids_equal=bool(len(ids1) == len(ids) and (ids1 == ids).all()),
            decode_tok_s=st1["decode_steps"] / max(st1["decode_s"], 1e-9),
            unsharded_tok_s=rec["decode_tok_s"], k1=n1["k1"], k2=n1["k2"],
            collectives_ok=_par_collectives_ok(mesh.get_group("data"), dev))
    finally:
        dist.destroy_process_group()
    rec["archive_bytes"] = _par_lora_archive(cfg, work / "lora.npz", seed)
    rec["lora"] = _par_lora_ref(cap, spliced, work)
    rec["engine"] = _par_engine_ref(cap, spliced, cfg, seed, work)
    del cap
    if dev == "cuda":
        _free_card()
    return rec


def _par_collectives_ok(group, dev) -> bool:
    """parallel/distributed.py's all_reduce, all_gather and broadcast on
    tensors of `dev` over a group of one give what they must."""
    import torch
    from rsvldm_tpu_torch.parallel.distributed import (all_gather, all_reduce,
                                                       broadcast)
    t = torch.arange(6, dtype=torch.float32, device=dev)
    want = t.clone()
    ok = torch.equal(all_reduce(t.clone(), group), want)
    ok &= torch.equal(all_gather(t[None], group, 0), want[None])
    ok &= torch.equal(broadcast(t.clone(), group, 0), want)
    return bool(ok)


def _par_pipe(cfg: dict, work: Path, mesh=None):
    from rsvldm_tpu_torch.config import PipelineConfig
    from rsvldm_tpu_torch.pipeline import SuperResolutionPipeline
    pcfg = PipelineConfig(no_llava=True, ckpt_dir=str(work / "no_ckpt"),
                          upscale=cfg["upscale"])
    if cfg["s1_steps"]:
        pcfg.stage1.sampler, pcfg.stage1.ddim_steps = "ddim", cfg["s1_steps"]
    return SuperResolutionPipeline(pcfg, device=cfg["device"],
                                   model_cfgs=cfg["model_cfgs"], mesh=mesh)


def _par_lr(seed: int, cfg: dict, work: Path) -> list:
    import numpy as np
    from PIL import Image
    d = work / "lr"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed + 18)
    paths = []
    for i, side in enumerate(cfg["lr_sides"]):
        p = d / f"tile_{i}.png"
        Image.fromarray((rng.random((side, side, 3)) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def _par_vae_input(seed: int, cfg: dict, dtype):
    import torch
    g = torch.Generator(device=cfg["device"]).manual_seed(seed + 19)
    side = cfg["vae_side"]
    return (torch.rand((1, 3, side, side), generator=g, device=cfg["device"])
            * 2 - 1).to(dtype)


def _par_vae(vae, x, cfg, mesh=None, wrap=lambda fn: fn) -> tuple:
    """The tiled VAE alone: the twin encoder over 512^2 tiles, then the
    decoder over 64^2 latent tiles (JAX's and the pipeline's sizes).
    `wrap`: how the tile batch is run (`_Meet`'s witnesses)."""
    import torch
    from rsvldm_tpu_torch.models.vae import tiled
    x = x.to(next(vae.parameters()).dtype)
    with torch.inference_mode():
        _par_sync(cfg["device"])
        t0 = time.perf_counter()
        z = tiled.tiled_encode(wrap(vae.encode_with_denoise), x,
                               tile=cfg["enc_tile"], mesh=mesh)
        _par_sync(cfg["device"])
        t1 = time.perf_counter()
        y = tiled.tiled_decode(wrap(vae.decode), z, tile=cfg["dec_tile"],
                               mesh=mesh)
        _par_sync(cfg["device"])
        t2 = time.perf_counter()
    return z.float().cpu(), y.float().cpu(), dict(encode_s=t1 - t0,
                                                   decode_s=t2 - t1)


class _Meet:
    """The tiled VAE's one-process witnesses: the tile batch cut into
    `parts` equal parts, run by as many threads (`threaded`) or as one
    batch, whose GroupNorm32s meet and normalise every part with the
    statistics of all tiles: JAX's pmean formula over the parts' moments,
    as the ranks of the 'tile' group take them (`pmean`), else the one
    process's two-pass statistics. Threaded with pmean, a process
    computes what the ranks do at their batch size; threaded without it,
    the ranks' batch size with the one process's statistics; one batch
    with pmean, the one process's batch size with the ranks' formula."""

    def __init__(self, parts: int, threaded: bool, pmean: bool):
        import threading
        self.parts, self.threaded, self.pmean = parts, threaded, pmean
        self.barrier = threading.Barrier(parts if threaded else 1)
        self.slots: list = [None] * parts
        self.stats = None

    def stats_of(self, xs: list) -> tuple:
        """(mean, var) over the fp32 grouped parts xs [n, G, C/G, HW]."""
        import torch
        dims = (0, 2, 3)
        if not self.pmean:
            xa = torch.cat(xs)
            mean = xa.mean(dim=dims, keepdim=True)
            return mean, (xa - mean).square().mean(dim=dims, keepdim=True)
        st = 0
        for x in xs:
            m = x.mean(dim=dims, keepdim=True)
            v = (x - m).square().mean(dim=dims, keepdim=True)
            st = st + torch.stack([m, v + m.square()])
        st = st / len(xs)
        return st[0], st[1] - st[0].square()

    def norm(self, gn, x, i: int):
        """GroupNorm32.forward_fp32 of part i's tiles x (all parts for one
        batch), as `_group_fp32` writes it."""
        import torch
        n, c = x.shape[:2]
        xg = x.float().reshape(n, gn.num_groups, c // gn.num_groups, -1)
        if not self.threaded:
            mean, var = self.stats_of(list(xg.chunk(self.parts)))
        else:
            self.slots[i] = xg
            if self.barrier.wait() == 0:
                self.stats = self.stats_of(self.slots)
            self.barrier.wait()
            mean, var = self.stats
        y = (xg - mean).mul_(torch.rsqrt(var + gn.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return y.mul_(gn.weight.float().reshape(shape)).add_(
            gn.bias.float().reshape(shape))

    @staticmethod
    def wrap(parts: int, threaded: bool, pmean: bool):
        """A `_par_vae` wrap: fn over the tiles as such a witness runs it
        (a fresh _Meet a call)."""
        def wrap(fn):
            def apply(tiles):
                import threading
                import torch
                from rsvldm_tpu_torch.ops.norm import tile_collective_gn
                meet = _Meet(parts, threaded, pmean)
                if not threaded:
                    with tile_collective_gn((meet, 0)):
                        return fn(tiles)
                out, err = [None] * parts, []
                per = tiles.shape[0] // parts

                def run(i):
                    try:
                        with torch.inference_mode(), \
                                tile_collective_gn((meet, i)):
                            out[i] = fn(tiles[i * per:(i + 1) * per])
                    except BaseException as e:  # raised below
                        err.append(e)
                        meet.barrier.abort()
                ts = [threading.Thread(target=run, args=(i,))
                      for i in range(parts)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                if err:
                    raise err[0]
                return torch.cat(out)
            return apply
        return wrap


def _par_witnesses(vae, x, cfg, parts: int, ref: dict) -> tuple:
    """The bf16 tiled VAE's one-process witnesses (`_Meet`) against the
    unsharded run `ref`: ({name: times and differences}, {name: z, y})."""
    from rsvldm_tpu_torch.ops.norm import GroupNorm32
    orig = GroupNorm32._group_fp32

    def group_fp32(gn, x, group):
        if isinstance(group, tuple) and isinstance(group[0], _Meet):
            return group[0].norm(gn, x, group[1])
        return orig(gn, x, group)
    rec, outs = {}, {}
    GroupNorm32._group_fp32 = group_fp32
    try:
        for name, threaded, pmean in (("split_pooled", True, False),
                                      ("whole_pmean", False, True),
                                      ("split_pmean", True, True)):
            z, y, secs = _par_vae(vae, x, cfg,
                                  wrap=_Meet.wrap(parts, threaded, pmean))
            rec[name] = dict(secs, **_vae_diff(z, y, ref))
            outs[name] = {"z": z, "y": y}
    finally:
        GroupNorm32._group_fp32 = orig
    return rec, outs


def _vae_diff(z, y, ref: dict) -> dict:
    """A tiled VAE run's (z, y) against `ref`'s: the latents' relative
    rms and the uint8 image's levels."""
    import torch
    to8 = lambda t: ((t.clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8).numpy()
    rel = float((z - ref["z"]).square().mean().sqrt()
                / ref["z"].square().mean().sqrt().clamp_min(1e-30))
    return dict(latent_rel_rms=rel,
                latent_bit_equal=bool(torch.equal(z, ref["z"])),
                image_uint8=_uint8_diff(to8(y), to8(ref["y"])),
                finite=bool(torch.isfinite(y).all()))


def _par_vaes(pipe) -> dict:
    """The seeded VAE in the pipeline's dtype and widened to fp32."""
    import copy
    from rsvldm_tpu_torch.models.vae.model import AutoencoderKL
    vae = pipe._build("vae", AutoencoderKL, pipe.vae_cfg)
    return {"bf16": vae, "fp32": copy.deepcopy(vae).float()}


def _par_train_data(seed: int, cfg: dict):
    import numpy as np
    rng = np.random.default_rng(seed + 20)
    s = cfg["train_side"]
    shape = (PAR_TRAIN_BATCH, s, s, 3)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _par_trainer(seed: int, cfg: dict, mesh=None):
    import torch
    from rsvldm_tpu_torch.models.sr3.unet import SR3UNetConfig
    from rsvldm_tpu_torch.training.sr3_trainer import SR3TrainConfig, SR3Trainer
    mc = SR3UNetConfig(image_size=cfg["train_side"])
    if cfg["device"] == "cpu":
        from rsvldm_tpu_torch.train_sr3 import TINY_SR3
        mc = dataclasses.replace(mc, **TINY_SR3)
    dev = cfg["device"]
    return SR3Trainer(mc, SR3TrainConfig(), device=dev, mesh=mesh,
                      generator=torch.Generator(dev).manual_seed(seed))


def _flat_params(model):
    import torch
    return torch.cat([p.detach().float().reshape(-1).cpu()
                      for p in model.parameters()])


def _par_references(seed: int, cfg: dict, work: Path, ranks: int) -> dict:
    """The unsharded runs in this process, their outputs saved in `work`;
    the tiled VAE's witnesses at the `ranks` ranks' split."""
    import numpy as np
    import torch
    dev = cfg["device"]
    rec = {"caption": _par_caption_ref(seed, cfg, work)}
    pipe = _par_pipe(cfg, work)
    paths = _par_lr(seed, cfg, work)
    t0 = time.perf_counter()
    outs = pipe.run_stage1_batch(paths)
    _par_sync(dev)
    rec["stage1"] = dict(seconds=time.perf_counter() - t0, n=len(outs))
    np.save(work / "stage1_ref.npy", np.stack(outs))
    t0 = time.perf_counter()
    wit = _par_stage1_witness(pipe, paths, ranks, cfg)
    _par_sync(dev)
    rec["stage1"].update(witness_s=time.perf_counter() - t0,
                         witness_vs_whole=_uint8_diff(np.stack(wit),
                                                      np.stack(outs)))
    np.save(work / "stage1_witness.npy", np.stack(wit))
    vaes = _par_vaes(pipe)
    x = _par_vae_input(seed, cfg, pipe.dtype)
    rec["vae"], refs = {}, {}
    for dt, vae in vaes.items():
        z, y, rec["vae"][dt] = _par_vae(vae, x, cfg)
        refs[dt] = {"z": z, "y": y}
    rec["vae"]["witness"], wit = _par_witnesses(vaes["bf16"], x, cfg, ranks,
                                                refs["bf16"])
    refs.update(wit)
    torch.save(refs, work / "vae_ref.pt")
    del pipe, vaes
    tr = _par_trainer(seed, cfg)
    p0 = _flat_params(tr.model)
    hr, sr = _par_train_data(seed, cfg)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    _par_sync(dev)
    t0 = time.perf_counter()
    losses = [tr.train_step(hr, sr, generator=gen)
              for _ in range(PAR_TRAIN_STEPS)]
    _par_sync(dev)
    rec["train"] = dict(losses=losses,
                        s_per_step=(time.perf_counter() - t0) / PAR_TRAIN_STEPS)
    p1 = _flat_params(tr.model)
    torch.save({"params": p1, "moved": float((p1 - p0).norm()),
                "losses": losses}, work / "train_ref.pt")
    del tr
    if dev == "cuda":
        _free_card()
    rec["vlm_train"] = _par_vlm_train(seed, cfg, work)
    torch.save(rec["vlm_train"], work / "vlm_train_ref.pt")
    rec["sp"] = _par_sp_ref(seed, cfg, work)
    rec["gpipe"] = _par_pp_ref(seed, cfg, work)
    return rec


def _par_engine_prompts(cap, seed: int, spliced) -> list:
    """The engine's four prompts [S, D]: the caption's spliced image prompt
    and three text prompts of seeded token ids (PAR_ENGINE_SHORT)."""
    import torch
    gen = torch.Generator().manual_seed(seed + 31)
    vocab = cap.llama.cfg.vocab_size
    out = [spliced]
    with torch.inference_mode():
        for n in PAR_ENGINE_SHORT:
            ids = torch.randint(1, vocab, (1, n), generator=gen)
            out.append(cap.llama.embed(ids.to(spliced.device))[0])
    return out


def _par_engine_run(eng, prompts, gcfg) -> list:
    """Rank 0 (or a lone process) submits and drains, then stops the
    followers; the other ranks follow. Every rank returns its streams."""
    if eng._rank:
        eng.follow()
        return [eng.result(u) for u in sorted(eng._requests)]
    ids = eng.generate_all(prompts, gcfg)
    if eng._group is not None:
        eng.stop_followers()
    return ids


def _par_engine_ref(cap, spliced, cfg: dict, seed: int, work: Path) -> dict:
    """The one-process DecodeEngine on the unsharded int4 decoder (its steps
    replayed as graphs): the four prompts' greedy ids, the speculative
    engine's ids, the teacher-forced logits (saved for the ranks)."""
    import torch
    from rsvldm_tpu_torch.serving.engine import DecodeEngine
    dev = cfg["device"]
    prompts = _par_engine_prompts(cap, seed, spliced)
    gcfg = _par_gcfg(PAR_ENGINE_TOKENS)
    t0 = time.perf_counter()
    eng = DecodeEngine(cap.llama, slots=2, max_len=PAR_ENGINE_MAX_LEN,
                       pad_to=128)
    ids = _par_engine_run(eng, prompts, gcfg)
    _par_sync(dev)
    greedy_s = time.perf_counter() - t0
    spec = DecodeEngine(cap.llama, slots=2, max_len=PAR_ENGINE_MAX_LEN,
                        pad_to=128, draft=cap.llama, spec_k=PAR_SPEC_K)
    spec_ids = _par_engine_run(spec, prompts[1:2], gcfg)
    logits = [_tf_logits(cap.llama, p, i) for p, i in zip(prompts, ids)]
    spec_logits = [_tf_logits(cap.llama, prompts[1], spec_ids[0])]
    torch.save({"ids": ids, "spec_ids": spec_ids, "logits": logits,
                "spec_logits": spec_logits}, work / "engine_ref.pt")
    rec = dict(prompt_lens=[int(p.shape[0]) for p in prompts],
               tokens=[len(i) for i in ids], greedy_s=greedy_s,
               steps=dict(eng.steps), spec_rounds=spec.steps["spec"],
               spec_equals_greedy=bool((spec_ids[0] == ids[1]).all()))
    del eng, spec
    return rec


def _par_sp_inputs(seed: int, cfg: dict, dtype):
    """q [B, S, H, D] and k, v [B, S, kvh, D] for the SP attention, seeded
    on the device in fp32, then in `dtype`."""
    import torch
    b, s, h, kvh, d = cfg["sp"]
    gen = torch.Generator(device=cfg["device"]).manual_seed(seed + 41)
    mk = lambda heads: torch.randn((b, s, heads, d), generator=gen,
                                   device=cfg["device"]).to(dtype)
    return mk(h), mk(kvh), mk(kvh)


def _par_sp_ref(seed: int, cfg: dict, work: Path) -> dict:
    """Causal GQA attention over the whole sequence in one process, in fp32
    (K/V repeated, fp32 softmax and product: tests/test_parallel_spp.py's
    reference), on the fp32 inputs and on the bf16 ones widened; saved for
    the ranks."""
    import torch
    out = {}
    t0 = time.perf_counter()
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = (x.float() for x in _par_sp_inputs(seed, cfg, dt))
        rep = q.shape[2] // k.shape[2]
        k, v = (x.repeat_interleave(rep, dim=2) for x in (k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        w = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
        del logits
        out[name] = torch.einsum("bhqk,bkhd->bqhd", w, v).cpu()
        del w
    _par_sync(cfg["device"])
    torch.save(out, work / "sp_ref.pt")
    return dict(shape=list(cfg["sp"]), seconds=time.perf_counter() - t0)


def _par_pp_blocks(seed: int, cfg: dict):
    """PAR_PP_STAGES x PAR_PP_BLOCKS seeded decoder blocks of cfg's Llama
    (full width: Llama-3-8B's), bf16 on the card (fp32 on the CPU), and
    the microbatches [M, 1, T, dim]."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import LlamaBlock
    from rsvldm_tpu_torch.utils.weights import init_params_
    dev = cfg["device"]
    dt = torch.bfloat16 if dev == "cuda" else torch.float32
    lcfg = cfg["llama"]
    with torch.device("meta"):
        blocks = torch.nn.ModuleList(
            LlamaBlock(lcfg) for _ in range(PAR_PP_STAGES * PAR_PP_BLOCKS))
    blocks = blocks.to(dtype=dt).to_empty(device=dev)
    init_params_(blocks, torch.Generator(device=dev).manual_seed(seed + 51))
    gen = torch.Generator(device=dev).manual_seed(seed + 52)
    x = torch.randn((PAR_PP_MICRO, 1, cfg["pp_tokens"], lcfg.dim),
                    generator=gen, device=dev).to(dt)
    return blocks.eval().requires_grad_(False), x


def _par_pp_stage(blocks):
    """A module running `blocks` in order on x [1, T, dim] (a prefill from
    0 without a cache): one pipeline stage, for functional_call."""
    import torch

    class Stage(torch.nn.Module):
        def __init__(self, blocks):
            super().__init__()
            self.blocks = blocks

        def forward(self, x):
            for blk in self.blocks:
                x = blk(x, None, None, 0)
            return x

    return Stage(blocks)


def _par_pp_ref(seed: int, cfg: dict, work: Path) -> dict:
    """The sequential run of the GPipe stages' blocks, one microbatch at a
    time, in one process; saved for the ranks."""
    import torch
    dev = cfg["device"]
    if dev == "cuda":
        _free_card()
    blocks, x = _par_pp_blocks(seed, cfg)
    stage = _par_pp_stage(blocks)
    _par_sync(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        y = torch.stack([stage(x[i]) for i in range(x.shape[0])])
    _par_sync(dev)
    secs = time.perf_counter() - t0
    torch.save(y.cpu(), work / "pp_ref.pt")
    del blocks, stage, x, y
    if dev == "cuda":
        _free_card()
    return dict(seconds=secs, blocks=PAR_PP_STAGES * PAR_PP_BLOCKS,
                microbatches=PAR_PP_MICRO, tokens=cfg["pp_tokens"])


def _par_stage1_witness(pipe, paths, ranks: int, cfg: dict) -> list:
    """Folder Stage 1 as `ranks` ranks of data run it, in one process: the
    group's batch cut into the ranks' rows (pipeline._mesh_rows), each part
    one loop at that batch size with its rows of the whole batch's
    "stage1" draw (the noise generator restarted for each part, as each
    rank's fresh pipeline draws)."""
    import numpy as np
    import torch
    from rsvldm_tpu_torch.ops.image import load_lr_conditioning
    from rsvldm_tpu_torch.pipeline import TorchNoise
    conds = [load_lr_conditioning(str(p), cfg["upscale"]) for p in paths]
    if len({c.shape for c in conds}) != 1:
        raise ValueError("the witness takes one Stage-1 group")
    batch, n = np.stack(conds), len(conds)
    per, extra = divmod(n, ranks)
    outs = []
    with torch.inference_mode():
        for r in range(ranks):
            start = r * per + min(r, extra)
            pipe.noise = TorchNoise(pipe.cfg.seed, pipe.device)
            outs += pipe._stage1(batch, slice(start, start + per + (r < extra)))
    return outs


def _par_vlm_train(seed: int, cfg: dict, work: Path, mesh=None) -> dict:
    """VLMTrainer on the seeded int8 decoder of `cfg` (Llama-3-8B at full
    width), remat, LoRA r=16 alpha=16 on the seven projections, AdamW lr
    2e-4: PAR_VLM_STEPS steps of one global batch of PAR_VLM_ROWS text
    records (`_text_batch`, cfg["vlm_width"] tokens). Without a mesh, all
    rows in this process (the reference); with one, this rank's rows and
    `mesh=` (the gradients summed over it). Launches per step, losses, the
    adapters' digest."""
    import hashlib
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import LlamaModel, quantize_llama_
    from rsvldm_tpu_torch.parallel.mesh import batch_sharding
    from rsvldm_tpu_torch.training import vlm_trainer as vt
    from rsvldm_tpu_torch.utils.weights import seeded_init_
    dev = cfg["device"]
    if dev == "cuda":
        _free_card()
    t0 = time.perf_counter()
    lcfg = dataclasses.replace(cfg["llama"], remat=True)
    with torch.device("meta"):
        model = LlamaModel(lcfg)
    model = model.to(dtype=torch.bfloat16 if dev == "cuda" else
                     torch.float32).to_empty(device=dev)
    seeded_init_(model, "llama", torch.device(dev))
    model = quantize_llama_(model.eval().requires_grad_(False), "int8")
    _par_sync(dev)
    build_s = time.perf_counter() - t0
    tr = vt.VLMTrainer(model, vt.LoraConfig(r=16, alpha=16), lr=2e-4,
                       generator=torch.Generator().manual_seed(seed + 23),
                       mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(seed + 24)
    emb, labels = _text_batch(model, gen, PAR_VLM_ROWS, cfg["vlm_width"])
    if mesh is not None:
        rows = batch_sharding(mesh, PAR_VLM_ROWS)
        emb, labels = emb[rows], labels[rows]
    supervised = int(vt.supervised_count(labels))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, per_step = [], []
    _par_sync(dev)
    t0 = time.perf_counter()
    for _ in range(PAR_VLM_STEPS):
        before = _counts()
        losses.append(tr.train_step(emb, labels))
        now = _counts()
        per_step.append({k: now[k] - before[k] for k in now})
    _par_sync(dev)
    s_per_step = (time.perf_counter() - t0) / PAR_VLM_STEPS
    flat = torch.cat([t.detach().float().reshape(-1).cpu()
                      for ab in tr.lora.values() for t in ab.values()])
    rec = dict(rows=int(emb.shape[0]), width=int(emb.shape[1]),
               supervised=supervised, build_s=build_s, losses=losses,
               s_per_step=s_per_step, launches_per_step=per_step,
               k1=sum(c["k1"] for c in per_step),
               k2=sum(c["k2"] for c in per_step),
               bwd=sum(c["bwd"] for c in per_step),
               bwd256=sum(c["bwd256"] for c in per_step),
               lora_digest=hashlib.sha256(flat.numpy().tobytes()).hexdigest()[:16],
               peak_gib=_par_peak_gib(dev))
    del tr, model, emb, labels
    if dev == "cuda":
        _free_card()
    return rec


def _cos(a, b) -> float:
    import torch
    return float(torch.nn.functional.cosine_similarity(a.double(), b.double(),
                                                       dim=0))


def _uint8_diff(a, b) -> dict:
    import numpy as np
    d = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
    return dict(mean_abs=float(d.mean()), max_abs=int(d.max()),
                bit_equal=bool(d.max() == 0))


def _par_worker_caption(seed, cfg, mesh, work) -> dict:
    import torch
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.generate import generate
    dev = cfg["device"]
    t0 = time.perf_counter()
    cap = LlavaCaptioner.seeded(cfg["llama"], cfg["vision"], StandInTokenizer(),
                                quant=cfg["quant"], device=dev, mesh=mesh)
    _par_sync(dev)
    build_s = time.perf_counter() - t0
    q = cap.llama.model.layers[0].self_attn.q_proj
    q_rows = (q.kernel_q4 if hasattr(q, "kernel_q4") else q.weight.t()).shape[1]
    spliced = cap.embed_mm(_par_prompt(), [_par_image(seed)])
    _reset_counts()
    st = {}
    ids = generate(cap.llama, spliced, _par_gcfg(), stats=st)
    n = _counts()
    ref = torch.load(work / "caption_ref.pt")
    logits = _tf_logits(cap.llama, spliced, ref["ids"].numpy())
    cos = [_cos(a, b) for a, b in zip(logits, ref["logits"])]
    rids = ref["ids"].numpy()
    same = (ids[:len(rids)] == rids[:len(ids)])
    diverge = int(same.argmin()) if not same.all() else None
    steps = st["decode_steps"]
    layers = cfg["llama"].layers
    rec = dict(build_s=build_s, q_proj_out=int(q_rows),
               q_proj_out_full=cfg["llama"].heads * cfg["llama"].head_dim,
               prompt_len=st["prompt_len"], padded_len=st["padded_len"],
               prefill_ms=st["prefill_s"] * 1e3, decode_steps=steps,
               decode_tok_s=steps / max(st["decode_s"], 1e-9),
               k1=n["k1"], k1_reckoned=layers if dev == "cuda" else 0,
               k2=n["k2"], k2_reckoned=(steps * (7 * layers + 1) + 1
                                        if dev == "cuda" else 0),
               cos_min=min(cos), cos_prefill=cos[0], cos=cos,
               first_divergence=diverge,
               tokens=len(ids), peak_gib=_par_peak_gib(dev))
    rec["ok"] = bool(rec["cos_min"] >= PAR_COS_MIN
                     and rec["q_proj_out"] * mesh.size() == rec["q_proj_out_full"]
                     and n["k1"] == rec["k1_reckoned"]
                     and n["k2"] == rec["k2_reckoned"]
                     and len(ids) == PAR_NEW_TOKENS)
    rec["lora"] = _par_worker_caption_lora(cap, spliced, cfg, mesh, work)
    rec["engine"] = _par_worker_engine(cap, spliced, cfg, seed, mesh, work)
    rec["ok"] = rec["ok"] and rec["lora"]["ok"] and rec["engine"]["ok"]
    del cap
    if dev == "cuda":
        _free_card()
    return rec


def _par_worker_caption_lora(cap, spliced, cfg, mesh, work) -> dict:
    """This rank's TP caption with the archive attached (its slices of the
    adapters) against the unsharded one with it (`_par_lora_ref`)."""
    import torch
    from rsvldm_tpu_torch.models.vlm.generate import generate
    dev = cfg["device"]
    t0 = time.perf_counter()
    cap.attach_archives(lora_npz=work / "lora.npz")
    _par_sync(dev)
    attach_s = time.perf_counter() - t0
    _reset_counts()
    st = {}
    ids = generate(cap.llama, spliced, _par_gcfg(PAR_LORA_TOKENS), stats=st,
                   lora=cap.lora)
    n = _counts()
    ref = torch.load(work / "caption_lora_ref.pt")
    rids = ref["ids"].numpy()
    logits = _tf_logits(cap.llama, spliced, rids, cap.lora)
    cos = [_cos(a, b) for a, b in zip(logits, ref["logits"])]
    c, steps = cfg["llama"], st["decode_steps"]
    b_cols = cap.lora["model.layers.0.self_attn.q_proj"]["b"].shape[1]
    rec = dict(attach_s=attach_s, q_proj_b_cols=int(b_cols),
               ids_equal=bool(len(ids) == len(rids) and (ids == rids).all()),
               cos_min=min(cos), cos=cos, tokens=len(ids),
               decode_tok_s=steps / max(st["decode_s"], 1e-9),
               k1=n["k1"], k1_reckoned=c.layers if dev == "cuda" else 0,
               k2=n["k2"], k2_reckoned=(steps * (7 * c.layers + 1) + 1
                                        if dev == "cuda" else 0))
    rec["ok"] = bool(rec["cos_min"] >= PAR_COS_MIN and rec["ids_equal"]
                     and b_cols * mesh.size() == c.heads * c.head_dim
                     and n["k1"] == rec["k1_reckoned"]
                     and n["k2"] == rec["k2_reckoned"]
                     and len(ids) == PAR_LORA_TOKENS)
    return rec


def _par_worker_engine(cap, spliced, cfg, seed, mesh, work) -> dict:
    """DecodeEngine(mesh=) on this rank's int4 shards (the TP captioner's
    decoder, taken as it is): rank 0 submits the four prompts and steps,
    the other rank follows; then the speculative engine (draft == target).
    Against the one process: the same ids, teacher-forced logits within
    PAR_COS_MIN; every rank's streams rank 0's, no rank's own tokens
    different; K1 32 an admission of >= 1024 tokens, K2 225 a decode step
    + 1 an admission (a round: k x 225 + 224 + 225), per rank."""
    import torch
    import torch.distributed as dist
    from rsvldm_tpu_torch.serving.engine import DecodeEngine
    dev = cfg["device"]
    ref = torch.load(work / "engine_ref.pt", weights_only=False)
    prompts = _par_engine_prompts(cap, seed, spliced)
    gcfg = _par_gcfg(PAR_ENGINE_TOKENS)
    L = cfg["llama"].layers
    on_card = dev == "cuda"
    rec: dict = {"prompt_lens": [int(p.shape[0]) for p in prompts]}
    for name, kw, ps, want, lgs in (
            ("greedy", {}, prompts, ref["ids"], ref["logits"]),
            ("spec", dict(draft=cap.llama, spec_k=PAR_SPEC_K), prompts[1:2],
             ref["spec_ids"], ref["spec_logits"])):
        eng = DecodeEngine(cap.llama, slots=2, max_len=PAR_ENGINE_MAX_LEN,
                           pad_to=128, mesh=mesh, **kw)
        _reset_counts()
        _par_sync(dev)
        t0 = time.perf_counter()
        ids = _par_engine_run(eng, ps, gcfg)
        _par_sync(dev)
        secs = time.perf_counter() - t0
        n = _counts()
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, [i.tolist() for i in ids])
        long_ = sum(-(-p.shape[0] // 128) * 128 >= 1024 for p in ps)
        rounds = eng.steps["spec"]
        k2 = (eng.steps["decode"] * (7 * L + 1)
              + rounds * k2_per_round(L, PAR_SPEC_K, L) + eng.admissions)
        # where a stream leaves the one process's, if it does
        first = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                      None if len(x) == len(y) else min(len(x), len(y)))
                 for x, y in zip(ids, want)]
        # there, the one process's best logit less its logit of this
        # rank's token (teacher-forced on the same history)
        gap = [float(lg[f].max() - lg[f][int(x[f])])
               if f is not None and f < min(len(lg), len(x)) else None
               for x, lg, f in zip(ids, lgs, first)]
        r = dict(seconds=secs, tokens=sum(len(i) for i in ids),
                 first_divergence=first, gap_at_divergence=gap,
                 tok_s=sum(len(i) for i in ids) / secs,
                 steps=dict(eng.steps), admissions=eng.admissions,
                 ids_equal=len(ids) == len(want) and all(
                     len(a) == len(b) and bool((a == b).all())
                     for a, b in zip(ids, want)),
                 ranks_equal=all(e == every[0] for e in every),
                 disagreements=eng.disagreements, sharded=eng.model.tp is not None,
                 k1=n["k1"], k1_reckoned=L * long_ * (2 if kw else 1)
                 if on_card else 0,
                 k2=n["k2"], k2_reckoned=k2 if on_card else 0)
        best = [abs(float(lg[f].max())) if g is not None else None
                for lg, f, g in zip(lgs, first, gap)]
        r["ties_only"] = all(
            f is None or (g is not None
                          and g <= PAR_TIE_ULPS * 2.0 ** (math.floor(
                              math.log2(max(b, 1e-30))) - 7))
            for f, g, b in zip(first, gap, best))
        r["ok"] = bool(r["ties_only"] and r["ranks_equal"] and r["sharded"]
                       and r["disagreements"] == 0
                       and n["k1"] == r["k1_reckoned"]
                       and n["k2"] == r["k2_reckoned"])
        rec[name] = r
        del eng
    cos = [_cos(a, b) for p, i, lg in zip(prompts, ref["ids"], ref["logits"])
           for a, b in zip(_tf_logits(cap.llama, p, i[:PAR_ENGINE_TF]), lg)]
    rec.update(cos_min=min(cos), k1=sum(rec[k]["k1"] for k in ("greedy", "spec")),
               k2=sum(rec[k]["k2"] for k in ("greedy", "spec")))
    rec["ok"] = bool(rec["greedy"]["ok"] and rec["spec"]["ok"]
                     and rec["cos_min"] >= PAR_COS_MIN)
    return rec


def _par_worker_sp(seed, cfg, work) -> dict:
    """sequence_parallel_attention over an ("sp",) mesh of the ranks, each
    holding its S/n rows, causal, GQA, fp32 and bf16, against the one
    process's attention on the whole sequence."""
    import torch
    import torch.distributed as dist
    from rsvldm_tpu_torch.parallel import make_mesh, sequence_parallel_attention
    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh(n, axis="sp")
    ref = torch.load(work / "sp_ref.pt")
    rec = {"mesh": [list(mesh.mesh_dim_names), list(mesh.shape)]}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = _par_sp_inputs(seed, cfg, dt)
        per = q.shape[1] // n
        cut = lambda x: x[:, rank * per:(rank + 1) * per].contiguous()
        q, k, v = cut(q), cut(k), cut(v)
        _par_sync(cfg["device"])
        t0 = time.perf_counter()
        with torch.inference_mode():
            o = sequence_parallel_attention(q, k, v, mesh, "sp", causal=True)
        _par_sync(cfg["device"])
        secs = time.perf_counter() - t0
        want = ref[name][:, rank * per:(rank + 1) * per]
        err = o.float().cpu() - want
        rms = lambda x: float(x.square().mean().sqrt())
        rec[name] = dict(seconds=secs, max_abs_err=float(err.abs().max()),
                         rel_rms_err=rms(err) / rms(want),
                         dtype=str(o.dtype).split(".")[-1])
        del q, k, v, o
    rec["ok"] = bool(rec["fp32"]["max_abs_err"] <= PAR_SP_ATOL_FP32
                     and rec["bf16"]["rel_rms_err"] <= PAR_SP_REL_RMS_BF16
                     and rec["bf16"]["dtype"] == "bfloat16")
    return rec


def _par_worker_gpipe(seed, cfg, work) -> dict:
    """gpipe_apply over a ("stage",) mesh of the ranks: stage r runs blocks
    [4r, 4r + 4) of the seeded decoder blocks (this rank's slice of the
    stacked parameters), 4 microbatches, against the sequential run."""
    import torch
    import torch.distributed as dist
    from torch.func import functional_call
    from rsvldm_tpu_torch.parallel import gpipe_apply, make_mesh
    dev = cfg["device"]
    if dev == "cuda":
        _free_card()
    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh(n, axis="stage")
    blocks, x = _par_pp_blocks(seed, cfg)
    nb = PAR_PP_BLOCKS
    stage = _par_pp_stage(blocks[:nb])
    mine = {f"blocks.{k}": t[None] for k, t in
            blocks[rank * nb:(rank + 1) * nb].state_dict().items()}
    _reset_counts()
    _par_sync(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        y = gpipe_apply(lambda p, xi: functional_call(stage, p, (xi,)), mine,
                        x, mesh, "stage")
    _par_sync(dev)
    secs = time.perf_counter() - t0
    k1 = _counts()["k1"]
    want = torch.load(work / "pp_ref.pt")
    got = y.cpu()
    err = got.float() - want.float()
    rms = lambda t: float(t.square().mean().sqrt())
    rec = dict(stages=n, blocks_per_stage=nb, microbatches=x.shape[0],
               ticks=x.shape[0] + n - 1, seconds=secs,
               bit_equal=bool(torch.equal(got, want)),
               max_abs_err=float(err.abs().max()),
               rel_rms_err=rms(err) / rms(want.float()), k1=k1,
               k1_reckoned=(nb * (x.shape[0] + n - 1)
                            if dev == "cuda" and cfg["pp_tokens"] >= 1024
                            else 0),
               peak_gib=_par_peak_gib(dev))
    rec["ok"] = bool((rec["bit_equal"] or rec["rel_rms_err"] <= PAR_PP_REL_RMS)
                     and got.shape == want.shape and k1 == rec["k1_reckoned"])
    del blocks, stage, mine, x, y
    if dev == "cuda":
        _free_card()
    return rec


def _par_worker_vlm_train(seed, cfg, mesh, work) -> dict:
    """This rank's VLMTrainer steps at data=n against the one process's."""
    import torch
    import torch.distributed as dist
    rec = _par_vlm_train(seed, cfg, work, mesh)
    ref = torch.load(work / "vlm_train_ref.pt")
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (rec["lora_digest"], rec["supervised"]))
    L = cfg["llama"].layers
    want = ({"k1": 2 * L, "k2": 0, "bwd": L, "bwd256": 0}
            if cfg["device"] == "cuda" else
            {"k1": 0, "k2": 0, "bwd": 0, "bwd256": 0})
    want.update(k1wide=0, bwdwide=0)
    rel = [abs(x - y) / abs(y) for x, y in zip(rec["losses"], ref["losses"])]
    rec.update(ref_losses=ref["losses"], loss_rel_err=max(rel),
               ranks_supervised=[s for _, s in every],
               ranks_equal=len({d for d, _ in every}) == 1,
               ref_s_per_step=ref["s_per_step"], want_per_step=want)
    rec["ok"] = bool(max(rel) <= TRAIN_LOSS_RTOL and rec["ranks_equal"]
                     and len(set(rec["ranks_supervised"])) > 1
                     and all(c == want for c in rec["launches_per_step"])
                     and all(math.isfinite(x) for x in rec["losses"]))
    return rec


def _par_worker_stage1(seed, cfg, mesh, work) -> dict:
    import numpy as np
    paths = sorted((work / "lr").glob("tile_*.png"))
    pipe = _par_pipe(cfg, work, mesh)
    _par_sync(cfg["device"])
    t0 = time.perf_counter()
    outs = pipe.run_stage1_batch(paths, mesh=mesh)
    _par_sync(cfg["device"])
    secs = time.perf_counter() - t0
    d = _uint8_diff(np.stack(outs), np.load(work / "stage1_ref.npy"))
    rec = dict(seconds=secs, n=len(outs), groups=pipe.stage1_groups, **d,
               vs_witness=_uint8_diff(np.stack(outs),
                                      np.load(work / "stage1_witness.npy")))
    rec["ok"] = bool(len(outs) == len(paths) and d["mean_abs"] <= REF_MEAN_TOL
                     and d["max_abs"] <= REF_MAX_TOL
                     and rec["vs_witness"]["bit_equal"])
    return rec, pipe


def _par_worker_vae(seed, cfg, pipe, mesh, work) -> dict:
    import torch
    refs = torch.load(work / "vae_ref.pt")
    x = _par_vae_input(seed, cfg, pipe.dtype)
    rec = {}
    for dt, vae in _par_vaes(pipe).items():
        z, y, secs = _par_vae(vae, x, cfg, mesh)
        rec[dt] = dict(secs, **_vae_diff(z, y, refs[dt]))
        if dt == "bf16":
            rec["bf16_vs_split_pmean"] = _vae_diff(z, y, refs["split_pmean"])
        del vae
    rec["peak_gib"] = _par_peak_gib(cfg["device"])
    f32, b16, wit = rec["fp32"], rec["bf16"], rec["bf16_vs_split_pmean"]
    tight = lambda d: (d["latent_rel_rms"] <= PAR_VAE_REL_RMS
                       and d["image_uint8"]["max_abs"] <= PAR_VAE_MAX_LEVELS)
    rec["ok"] = bool(tight(f32) and tight(wit)
                     and b16["finite"] and f32["finite"]
                     and b16["image_uint8"]["mean_abs"] <= REF_MEAN_TOL)
    return rec


def _par_worker_train(seed, cfg, mesh, work) -> dict:
    import hashlib
    import torch
    import torch.distributed as dist
    from rsvldm_tpu_torch.parallel.distributed import local_batch_range
    dev = cfg["device"]
    tr = _par_trainer(seed, cfg, mesh)
    hr, sr = _par_train_data(seed, cfg)
    a, b = local_batch_range(PAR_TRAIN_BATCH)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    _par_sync(dev)
    t0 = time.perf_counter()
    losses = [tr.train_step(hr[a:b], sr[a:b], generator=gen)
              for _ in range(PAR_TRAIN_STEPS)]
    _par_sync(dev)
    s_per_step = (time.perf_counter() - t0) / PAR_TRAIN_STEPS
    ref = torch.load(work / "train_ref.pt")
    p = _flat_params(tr.model)
    digest = hashlib.sha256(p.numpy().tobytes()).hexdigest()[:16]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, digest)
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(losses, ref["losses"]))
    update_rel = float((p - ref["params"]).norm()) / max(ref["moved"], 1e-30)
    rec = dict(losses=losses, ref_losses=ref["losses"], loss_rel_err=loss_rel,
               update_rel_err=update_rel, digest=digest,
               ranks_equal=len(set(every)) == 1, s_per_step=s_per_step,
               rows=[a, b], peak_gib=_par_peak_gib(dev))
    rec["ok"] = bool(loss_rel <= PAR_LOSS_RTOL
                     and update_rel <= PAR_UPDATE_RTOL and rec["ranks_equal"])
    return rec


def parallel_worker(rank: int, work: str, seed: int, tiny: bool) -> int:
    """One of the n ranks of phase `parallel` (RSVLDM_* env set by the
    phase; n = 2 on one card): the TP=n caption, folder Stage 1 at data=n,
    the tiled VAE at tile=n and DP SR3 training; its record in
    <work>/rank<i>.json."""
    import torch.distributed as dist
    from rsvldm_tpu_torch.device import resolve_device
    from rsvldm_tpu_torch.parallel.distributed import init_distributed
    from rsvldm_tpu_torch.parallel.mesh import make_mesh
    cfg = _par_cfg(tiny)
    resolve_device(cfg["device"])
    work = Path(work)
    rec: dict = {"rank": rank}
    try:
        assert init_distributed()
        n = dist.get_world_size()
        rec.update(backend=dist.get_backend(), world=n)
        mesh = make_mesh(n, tile=1)
        rec["caption"] = _par_worker_caption(seed, cfg, mesh, work)
        rec["stage1"], pipe = _par_worker_stage1(seed, cfg, mesh, work)
        rec["vae"] = _par_worker_vae(seed, cfg, pipe, make_mesh(n, tile=n), work)
        del pipe
        rec["train"] = _par_worker_train(seed, cfg, mesh, work)
        rec["vlm_train"] = _par_worker_vlm_train(seed, cfg, mesh, work)
        rec["sp"] = _par_worker_sp(seed, cfg, work)
        rec["gpipe"] = _par_worker_gpipe(seed, cfg, work)
        rec["ok"] = all(rec[k]["ok"] for k in ("caption", "stage1", "vae",
                                                 "train", "vlm_train", "sp",
                                                 "gpipe"))
    except Exception as e:  # reported, and fails the phase
        import traceback
        rec["error"] = traceback.format_exc()[-3000:]
        rec["ok"] = False
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        (work / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0 if rec["ok"] else 1


def phase_parallel(seed: int, tiny: bool = False, ranks: int = 2,
                   backend: str = "gloo") -> dict:
    """The parallel layer (rsvldm_tpu_torch/parallel) on the card: the
    unsharded runs and the NCCL world of one in this process, then
    `ranks` worker ranks over `backend` (module docstring, limits above):
    two over gloo on the one card by default; over NCCL one rank a card
    (--parallel-ranks / --parallel-backend, a machine with that many)."""
    import shutil
    import socket
    cfg = _par_cfg(tiny)
    work = Path(tempfile.mkdtemp(prefix="rsv_parallel_"))
    procs, rec, recs = [], {}, []
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        rec["unsharded"] = _par_references(seed, cfg, work, ranks)
        rec["unsharded"]["seconds"] = time.perf_counter() - t0
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        for rank in range(ranks):
            env = dict(os.environ, RSVLDM_COORDINATOR=f"127.0.0.1:{port}",
                       RSVLDM_NUM_PROCESSES=str(ranks),
                       RSVLDM_PROCESS_ID=str(rank), RSVLDM_BACKEND=backend,
                       OMP_NUM_THREADS="2")
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--parallel-worker", str(rank), str(work), str(seed)]
            procs.append(subprocess.Popen(cmd + (["--tiny"] if tiny else []),
                                          env=env, cwd=str(REPO)))
        deadline = time.time() + PAR_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
        rec["workers_s"] = time.perf_counter() - t0
        recs = [json.loads((work / f"rank{r}.json").read_text())
                for r in range(ranks)]
    except Exception as e:  # reported, and fails the phase
        import traceback
        rec["error"] = traceback.format_exc()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    rec["ranks"] = recs
    one = rec.get("unsharded", {}).get("caption", {}).get("world_of_one", {})
    # every worker rank's TP captions (without and with the archive) and
    # VLMTrainer steps, and the world of one's caption
    rec["launches"] = {k: sum(r.get("caption", {}).get(k, 0)
                              + r.get("caption", {}).get("lora", {}).get(k, 0)
                              + r.get("caption", {}).get("engine", {}).get(k, 0)
                              + r.get("gpipe", {}).get(k, 0)
                              + r.get("vlm_train", {}).get(k, 0) for r in recs)
                       + one.get(k, 0)
                       for k in ("k1", "k2", "bwd", "bwd256")}
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = bool(len(recs) == ranks and all(r["ok"] for r in recs)
                     and all(p.returncode == 0 for p in procs)
                     and one.get("ids_equal") is True
                     and one.get("tp_none") is True
                     and one.get("collectives_ok") is True)
    _say("parallel", **rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-path", action="store_true",
                    help="stop after the kernel checks (no pipeline run)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="only the build and phase parallel (no result "
                         "line)")
    ap.add_argument("--parallel-ranks", type=int, default=2,
                    help="phase parallel's worker ranks (with --parallel-only)")
    ap.add_argument("--parallel-backend", default="gloo",
                    help="their backend: gloo (two ranks on one card) or "
                         "nccl (one rank a card)")
    ap.add_argument("--parallel-worker", nargs=3, metavar=("RANK", "WORK", "SEED"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tiny", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true",
                    help="after the path, profile a replayed decode step, "
                         "SR3 step, cache-miss and cache-hit denoising step, "
                         "and the last training step")
    args = ap.parse_args(argv)

    if args.parallel_worker:  # a rank of phase parallel, started by it
        sys.path.insert(0, str(REPO))
        rank, work, seed = args.parallel_worker
        return parallel_worker(int(rank), work, int(seed), args.tiny)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "rsvldm_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: the rsvldm_tpu_torch package is not beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    smi = phase_device()
    phase_build()
    if args.parallel_only:
        par = phase_parallel(SEED, ranks=args.parallel_ranks,
                             backend=args.parallel_backend)
        print("chip_smoke: --parallel-only given, no result line",
              file=sys.stderr)
        return 0 if par["ok"] else 1
    cases, k2, bwd = phase_kernels()
    ok = all(c["ok"] for c in cases + k2 + bwd)
    ok = phase_reference(SEED)["ok"] and ok
    for quant in ("int4", "int8"):
        ok = phase_caption_reference(SEED, quant)["ok"] and ok
    ok = phase_batch_caption_reference(SEED)["ok"] and ok
    ok = phase_spec_reference(SEED)["ok"] and ok
    ok = phase_serve_reference(SEED)["ok"] and ok
    ok = phase_tiled_reference(SEED)["ok"] and ok
    sref = phase_samplers_reference(SEED)
    ok = sref["ok"] and ok
    for quant in ("int8", "int4"):
        ok = phase_train_reference(SEED, quant)["ok"] and ok
    ok = phase_train_reference(SEED, "int8", family="gemma")["ok"] and ok
    ok = phase_train_reference(SEED, None, family="wide")["ok"] and ok
    fref = phase_families_reference(SEED)
    ok = fref["ok"] and ok
    path = folder = spec = tiled = sr3 = serve = samplers = ev = None
    fam = tow = par = gem = wide = None
    tr = {}
    if not args.skip_path:
        import shutil
        path, pipe, cd = phase_path(SEED)
        ok = ok and path["ok"]
        if cd is not None:
            try:
                if args.profile and pipe is not None:
                    phase_profile(pipe)
                if pipe is not None:
                    spec = phase_spec(SEED, pipe, cd, path["sr3_path"])
                    ok = ok and spec["ok"]
                    tiled = phase_tiled(SEED, pipe, path["sr3_path"],
                                        pipe.last_caption)
                    ok = tiled["ok"] and ok
                    samplers = phase_samplers(SEED, pipe, path["sr3_path"],
                                              pipe.last_caption)
                    ok = samplers["ok"] and ok
                del pipe  # its weights and kept graphs, before the folder's
                folder = phase_folder(SEED, cd, path.get("process_s"),
                                      profile=args.profile)
                ok = ok and folder["ok"]
                ev = phase_eval(SEED, Path(folder["out_dir"]))
                ok = ok and ev["ok"]
                serve = phase_serve(SEED, cd)
                ok = ok and serve["ok"]
            finally:
                shutil.rmtree(cd, ignore_errors=True)
        else:
            ok = False
        tr = phase_train_all(SEED, profile=args.profile)
        ok = ok and tr["ok"]
        gem = phase_train_gemma(SEED)
        ok = ok and gem["ok"]
        wide = phase_wide_head(SEED)
        ok = ok and wide["ok"]
        sr3 = phase_train_sr3(SEED)
        ok = ok and sr3["ok"]
        fam = phase_families(SEED)
        ok = ok and fam["ok"]
        tow = phase_towers(SEED)
        ok = ok and tow["ok"]
        par = phase_parallel(SEED)
        ok = ok and par["ok"]
    mm = tr.get("train_mm", [])
    by_path = {"process": path.get("launches", {}) if path else {},
               "spec": spec["launches"] if spec else {},
               "tiled": tiled["launches"] if tiled else {},
               "folder": folder["launches"] if folder else {},
               "train": tr["train"]["launches"] if tr else {},
               # the pretrain-stage and the joint run together
               "train_mm": ({k: sum(r["launches"][k] for r in mm)
                             for k in mm[0]["launches"]} if mm else {}),
               "train_dpo": tr["train_dpo"]["launches"] if tr else {},
               "train_video": tr["train_video"]["launches"] if tr else {},
               "train_gemma": gem["launches"] if gem else {},
               # the wide-head decoder's prefill and LoRA steps
               "wide_head": wide["launches"] if wide else {},
               "train_sr3": sr3["launches"] if sr3 else {},
               # the LLM worker over HTTP; its engine's options (prefix,
               # chunk, horizon, int8 KV); speculative rounds
               "serve": serve["launches"] if serve else {},
               "serve_modes": serve["launches_modes"] if serve else {},
               "serve_spec": serve["launches_spec"] if serve else {},
               # the sgm sampler family: small width card vs CPU, full width
               "samplers_reference": sref["launches"],
               "samplers": samplers["launches"] if samplers else {},
               "eval": ev.get("launches", {}) if ev else {},
               # the other decoder families and towers: small width card
               # vs CPU, then at their published widths
               "families_reference": fref["launches"],
               "families": fam["launches"] if fam else {},
               "towers": tow["launches"] if tow else {},
               # the two gloo ranks' TP=2 caption (both ranks' launches)
               "parallel": par["launches"] if par else {}}

    def launches(k):
        # None where a path's run did not read this kernel's count; k a
        # counter's name or a function of a path's counts
        return {p: (k(c) if callable(k) else c.get(k))
                for p, c in by_path.items()}

    def k1_flash_fwd(c):
        # K1 of flash_fwd.cu: every launch but the wide kernel's (a path
        # that read no wide count launched none)
        return None if c.get("k1") is None else c["k1"] - c.get("k1wide", 0)

    def bwd_d64_d128(c):
        # the fused backward at D 64 / 128: every launch but the D=256 and
        # the wide kernels' (a path that read no such count launched none)
        return None if c.get("bwd") is None else (
            c["bwd"] - c.get("bwd256", 0) - c.get("bwdwide", 0))

    def entry(name, source, replaces, k, rows, keys, kernels=None):
        head = rows[0]
        n = launches(k)
        # ptxas's registers and spills of the entry's kernels, where given
        built = PTXAS.get(Path(source).name, {})
        extra = ({"ptxas": {kn: built.get(kn) for kn in kernels}}
                 if kernels else {})
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(v for v in n.values() if v is not None),
                "launches_by_path": n,
                "max_abs_err": max(c["max_abs_err"] for c in rows
                                   if "max_abs_err" in c),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "library_op": head.get("library_op"),
                "shapes": [{k: c.get(k) for k in keys} for c in rows
                           if "plain_ms" in c],
                "card": smi, **extra}

    fwd_keys = ("case", "shape", "causal", "ms", "wrapper_ms", "plain_ms",
                "bound_ms", "library_ms", "library_op", "tflops",
                "max_abs_err")
    bwd_keys = ("case", "shape", "causal", "ms", "whole_ms", "wrapper_ms",
                "plain_ms", "bound_ms", "library_ms", "library_wrapper_ms",
                "library_op", "tflops", "max_abs_err")
    report = {"kernels": [
        entry("flash_fwd", "rsvldm_tpu_torch/csrc/flash_fwd.cu",
              "rsvldm_tpu/ops/flash_attention.py:67", k1_flash_fwd,
              [c for c in cases if c["shape"][4] <= 256],
              fwd_keys),
        entry("int4_decode", "rsvldm_tpu_torch/csrc/int4_decode.cu",
              "rsvldm_tpu/ops/quant.py:185", "k2", k2,
              ("case", "shape", "ms", "wrapper_ms", "plain_ms", "bound_ms",
               "library", "library_ms", "gbps", "max_abs_err",
               "max_err_over_tol")),
        # one fused kernel for the TPU's dK/dV and dQ kernels, at D 64 /
        # 128 (flash_bwd_kernel) and at D 256 and the D padded to it
        # (flash_bwd_d256_kernel)
        entry("flash_bwd", "rsvldm_tpu_torch/csrc/flash_bwd.cu",
              "rsvldm_tpu/ops/flash_attention.py:326 + "
              "rsvldm_tpu/ops/flash_attention.py:376", bwd_d64_d128,
              [c for c in bwd if c["shape"][4] <= 128], bwd_keys),
        entry("flash_bwd_d256", "rsvldm_tpu_torch/csrc/flash_bwd.cu",
              "rsvldm_tpu/ops/flash_attention.py:326 + "
              "rsvldm_tpu/ops/flash_attention.py:376", "bwd256",
              [c for c in bwd if 128 < c["shape"][4] <= 256], bwd_keys),
        # K1 and the backward past D = 256: csrc/flash_wide.cu's forward,
        # and its prologue and backward kernel (one call)
        entry("flash_fwd_wide", "rsvldm_tpu_torch/csrc/flash_wide.cu",
              "rsvldm_tpu/ops/flash_attention.py:67", "k1wide",
              [c for c in cases if c["shape"][4] > 256], fwd_keys,
              kernels=("flash_wide_fwd_kernel",)),
        entry("flash_bwd_wide", "rsvldm_tpu_torch/csrc/flash_wide.cu",
              "rsvldm_tpu/ops/flash_attention.py:326 + "
              "rsvldm_tpu/ops/flash_attention.py:376", "bwdwide",
              [c for c in bwd if c["shape"][4] > 256], bwd_keys,
              kernels=("flash_wide_bwd_kernel", "flash_wide_prep_kernel"))]}
    print(json.dumps(report), flush=True)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    if args.skip_path:
        print("chip_smoke: --skip-path given, no result line", file=sys.stderr)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
