"""Conversation template registry (rsvldm_tpu/models/vlm/conversation.py,
the reference's llava/conversation.py conv_templates): the six templates by
name, each a (system, user) -> prompt renderer with its stop tokens and
default system message. The caption stage renders llava_llama_3
(generate.llama3_chat_prompt, the same string); the others serve the
reference's other model families.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

DEFAULT_SYSTEM = ("You are a helpful language and vision assistant. "
                  "You are able to understand the visual content that the "
                  "user provides, and assist the user with a variety of "
                  "tasks using natural language.")


@dataclasses.dataclass
class Conversation:
    name: str
    render: Callable[[str, str], str]   # (system, user) -> prompt
    stop_tokens: tuple = ()
    system: str = DEFAULT_SYSTEM

    def prompt(self, user_message: str) -> str:
        return self.render(self.system, user_message)


def _llama_3(system, user):
    return ("<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
            f"{system}<|eot_id|><|start_header_id|>user<|end_header_id|>\n\n"
            f"{user}<|eot_id|>"
            "<|start_header_id|>assistant<|end_header_id|>\n\n")


def _vicuna_v1(system, user):
    return f"{system} USER: {user} ASSISTANT:"


def _chatml(system, user):
    return (f"<|im_start|>system\n{system}<|im_end|>\n"
            f"<|im_start|>user\n{user}<|im_end|>\n"
            "<|im_start|>assistant\n")


def _mistral_instruct(system, user):
    return f"<s>[INST] {user} [/INST]"


def _gemma_instruct(system, user):
    return (f"<start_of_turn>user\n{user}<end_of_turn>\n"
            "<start_of_turn>model\n")


def _plain(system, user):
    return user + "\n"


conv_templates = {
    "llava_llama_3": Conversation("llava_llama_3", _llama_3,
                                  stop_tokens=("<|eot_id|>",)),
    "v1": Conversation("v1", _vicuna_v1, stop_tokens=("</s>",)),
    "qwen": Conversation("qwen", _chatml, stop_tokens=("<|im_end|>",),
                         system="You are a helpful assistant."),
    "mistral_instruct": Conversation("mistral_instruct", _mistral_instruct,
                                     stop_tokens=("</s>",), system=""),
    "gemma_instruct": Conversation("gemma_instruct", _gemma_instruct,
                                   stop_tokens=("<end_of_turn>",), system=""),
    "plain": Conversation("plain", _plain, system=""),
}
