"""Interactive CLI chat with the captioner (the JAX package's
rsvldm_tpu/serving/cli.py; llava/serve/cli.py parity).

Multi-turn: the first user message carries the <image> token; later turns
append to the conversation and the whole prompt is prefilled again (the
reference reuses HF generate's cache per call; at interactive scale a
fresh prefill per turn is equivalent). Each turn decodes with
models/vlm/generate.py::generate on the captioner's device (a CUDA graph
on the card). `main` runs on the card unless given --device cpu.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.vlm.generate import (DEFAULT_IMAGE_TOKEN, GenerateConfig,
                                   IMAGE_TOKEN_INDEX, anyres_image_features,
                                   generate, render_llama3_chat,
                                   splice_image_embeds, tokenize_with_image)
from ..utils import prng


@dataclasses.dataclass
class ChatSession:
    """Conversation state and one image (cli.py:54-93: the image's
    features attach to the first user message only)."""
    captioner: object
    image: object
    cfg: GenerateConfig = dataclasses.field(
        default_factory=lambda: GenerateConfig(max_new_tokens=512))
    turns: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    _image_tokens: Optional[torch.Tensor] = None

    def _encode_image(self) -> torch.Tensor:
        if self._image_tokens is None:
            cap = self.captioner
            self._image_tokens = anyres_image_features(
                cap.vision, cap.projector, self.image, cap.image_newline,
                cap.vision.cfg.image_size)
        return self._image_tokens

    @torch.inference_mode()
    def ask(self, user_msg: str, key=None, noise=None) -> str:
        """One turn: the reply, appended to the conversation. Sampling
        draws come from `noise(i)` ([vocab] Gumbel rows, as
        generate.generate takes them) or JAX's Gumbels of `key` (a
        utils/prng key, default PRNGKey(len(turns)), as JAX keys a
        turn)."""
        cap = self.captioner
        if DEFAULT_IMAGE_TOKEN in user_msg:
            # splice_image_embeds fills one sentinel; a typed placeholder
            # would embed token 0 in silence
            raise ValueError(
                "the CLI attaches the image automatically — remove the "
                f"{DEFAULT_IMAGE_TOKEN} placeholder from the message")
        if not self.turns:  # the first turn carries the image (cli.py:68-73)
            user_msg = DEFAULT_IMAGE_TOKEN + "\n" + user_msg
        self.turns.append(("user", user_msg))
        prompt = render_llama3_chat(self.turns)
        encode = lambda s: cap.tokenizer.encode(s, add_special_tokens=False)
        ids = tokenize_with_image(prompt, encode)
        dev = cap.image_newline.device
        safe = torch.from_numpy(np.where(ids == IMAGE_TOKEN_INDEX, 0, ids)).long()
        text_embeds = cap.llama.embed(safe.to(dev))
        if (ids == IMAGE_TOKEN_INDEX).any():
            embeds = splice_image_embeds(ids, text_embeds,
                                         self._encode_image().to(text_embeds.dtype))
        else:
            embeds = text_embeds
        if key is None:
            key = prng.key(len(self.turns))
        out_ids = generate(cap.llama, embeds, self.cfg, key, noise=noise)
        reply = cap.tokenizer.decode(out_ids.tolist(),
                                     skip_special_tokens=True).strip()
        self.turns.append(("assistant", reply))
        return reply


def main(argv=None):
    import argparse
    from pathlib import Path

    from PIL import Image

    from ..models.vlm.captioner import LlavaCaptioner

    ap = argparse.ArgumentParser(description="LLaVA CLI chat (serve/cli.py)")
    ap.add_argument("--ckpt_dir", default="./CKPT_PTH")
    ap.add_argument("--image-file", required=True)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--load-8bit", action="store_true", default=True,
                    help="int8 weight-only decoder (model_worker.py "
                         "--load-8bit equivalent; default on)")
    ap.add_argument("--no-load-8bit", dest="load_8bit", action="store_false")
    ap.add_argument("--load-4bit", action="store_true",
                    help="int4 weight-only decoder (--load-4bit / NF4 "
                         "equivalent; the decode runs K2)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    quant = "int4" if args.load_4bit else ("int8" if args.load_8bit else None)
    cap = LlavaCaptioner.load(Path(args.ckpt_dir), quant=quant,
                              device=args.device)
    if cap is None:
        raise SystemExit(f"no llava assets under {args.ckpt_dir}")
    sess = ChatSession(cap, Image.open(args.image_file).convert("RGB"),
                       GenerateConfig(max_new_tokens=args.max_new_tokens,
                                      temperature=args.temperature,
                                      do_sample=args.temperature > 0))
    while True:
        try:
            inp = input("user: ")
        except EOFError:
            inp = ""
        if not inp:
            print("exit...")
            break
        try:
            print("assistant:", sess.ask(inp))
        except ValueError as e:  # e.g. a typed <image> placeholder
            print(f"error: {e}")
    return sess


if __name__ == "__main__":
    main()
