"""Stage 2a in plain torch: the Llama-3 chat template and image prompt the
captioner renders, the anyres image features (CLIP tower, projector,
spatial-unpad assembly with the image newline) spliced at <image>, and
the decoder's logits over the prompt and the served tokens. Sampling is
argmax(logits / T + g_i), g_i JAX's Gumbels of PRNGKey(0) for token 0 and
fold_in(PRNGKey(0), i) for token i, as the port's `generate` draws them;
`gaps` says by how much each served token's score lies below the
best score the reference gives at its position, in logits."""

from __future__ import annotations

import numpy as np
import torch

from . import anyres, prng
from .vision import normalize_pixels

IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
SYSTEM_PROMPT = ("You are a helpful language and vision assistant. "
                 "You are able to understand the visual content that the user "
                 "provides, and assist the user with a variety of tasks using "
                 "natural language.")


def llama3_chat_prompt(user_message: str, system: str = SYSTEM_PROMPT) -> str:
    return ("<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
            f"{system}<|eot_id|>"
            f"<|start_header_id|>user<|end_header_id|>\n\n{user_message}"
            "<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n")


def tokenize_with_image(prompt: str, encode) -> np.ndarray:
    chunks = [encode(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    ids = list(chunks[0])
    for chunk in chunks[1:]:
        ids.append(IMAGE_TOKEN_INDEX)
        ids.extend(chunk)
    return np.asarray(ids, dtype=np.int64)


def image_features(tower, projector, image, newline: torch.Tensor,
                   patch_size: int) -> torch.Tensor:
    """One PIL image -> its anyres token stream [T, D] in fp32."""
    grid = anyres.grid_pinpoints_for(patch_size)
    patches = anyres.process_anyres_image(image, patch_size, grid)
    px = torch.from_numpy(patches).to(newline.device, torch.float32)
    feats = projector(tower(normalize_pixels(px)))
    tokens = anyres.assemble_spatial_unpad(
        feats.float().cpu().numpy(), image.size,
        newline.float().cpu().numpy(), grid, patch_size)
    return torch.from_numpy(tokens).to(newline.device, torch.float32)


def prompt_embeds(decoder, tower, projector, newline, image, img_prompt: str,
                  encode, patch_size: int) -> torch.Tensor:
    """The spliced prompt [S, D], fp32."""
    prompt = llama3_chat_prompt(img_prompt.format(
        DEFAULT_IMAGE_TOKEN=DEFAULT_IMAGE_TOKEN))
    ids = tokenize_with_image(prompt, encode)
    pos = int(np.where(ids == IMAGE_TOKEN_INDEX)[0][0])
    text = decoder.embed_tokens(torch.from_numpy(ids[ids != IMAGE_TOKEN_INDEX]))
    feats = image_features(tower, projector, image, newline, patch_size)
    return torch.cat([text[:pos], feats, text[pos:]], dim=0)


def gumbels(n: int, vocab: int, device) -> torch.Tensor:
    """[n, vocab] fp32: the caption's sampling noise."""
    k = prng.key(0)
    rows = [(k, None)] + [(k, i) for i in range(1, n)]
    return prng.draw(rows, (vocab,), "gumbel", torch.float32, device)


def scores(decoder, prompt: torch.Tensor, served, temperature: float,
           max_new_tokens: int) -> torch.Tensor:
    """[len(served), vocab] fp32: the score of every token at each served
    token's position, teacher-forced on the served tokens before it:
    logits / T + g (greedy, T = 0: the logits)."""
    served = torch.as_tensor(np.asarray(served, np.int64))
    n = int(served.shape[0])
    dev = prompt.device
    embeds = torch.cat([prompt, decoder.embed_tokens(served[:-1]).to(dev)], 0)
    at = torch.arange(prompt.shape[0] - 1, prompt.shape[0] - 1 + n, device=dev)
    logits = decoder.logits(embeds, at)
    if temperature <= 0:
        return logits
    return logits / temperature + gumbels(max_new_tokens, logits.shape[-1],
                                          dev)[:n]


def gaps(score: torch.Tensor, tokens, temperature: float) -> np.ndarray:
    """[n]: T * (the best score - the score of tokens[i]) at each position,
    in logits (T = 1 when greedy)."""
    t = temperature if temperature > 0 else 1.0
    tokens = torch.as_tensor(np.asarray(tokens, np.int64)).to(score.device)
    own = score.gather(1, tokens[:, None])[:, 0]
    return (t * (score.max(-1).values - own)).cpu().numpy()
