"""Conversation templates.

A copy of the JAX package's templates (this package imports nothing of
it), so both render byte-identical prompts: the reference StreamMind
templates (its conversation.py:11-567) for every separator style, which
tokenized inputs of the published checkpoints depend on.  A registry of
small renderer functions rather than a monolithic ``get_prompt``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Sequence, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = "single"
    TWO = "two"
    MPT = "mpt"
    PLAIN = "plain"
    LLAMA_2 = "llama_2"
    LLAMA_2_LIVE = "llama_2_live"


def _msg_text(message: Any) -> str:
    """Messages may be (text, media, mode) tuples; extract the text."""
    if isinstance(message, tuple):
        return message[0]
    return message


def _render_single(conv: "Conversation", messages) -> str:
    out = conv.system + conv.sep
    for role, message in messages:
        if message:
            out += role + ": " + _msg_text(message) + conv.sep
        else:
            out += role + ":"
    return out


def _render_two(conv: "Conversation", messages) -> str:
    seps = (conv.sep, conv.sep2)
    out = conv.system + seps[0]
    for i, (role, message) in enumerate(messages):
        if message:
            out += role + ": " + _msg_text(message) + seps[i % 2]
        else:
            out += role + ":"
    return out


def _render_mpt(conv: "Conversation", messages) -> str:
    out = conv.system + conv.sep
    for role, message in messages:
        if message:
            out += role + _msg_text(message) + conv.sep
        else:
            out += role
    return out


def _render_plain(conv: "Conversation", messages) -> str:
    seps = (conv.sep, conv.sep2)
    out = conv.system
    for i, (_, message) in enumerate(messages):
        if message:
            out += _msg_text(message) + seps[i % 2]
    return out


# The reference (conversation.py:91) injects this directive after the system
# block of every LLAMA_2-style first user turn.
_LLAMA2_VIDEO_DIRECTIVE = (
    "Please describe the video content in detail based on the provided information."
)


def _render_llama2(conv: "Conversation", messages, *, inject_directive: bool) -> str:
    out = ""
    for i, (role, message) in enumerate(messages):
        if i == 0:
            assert message, "first message should not be none"
            assert role == conv.roles[0], "first message should come from user"
        if not message:
            continue
        text = _msg_text(message)
        if i == 0:
            sys_block = f"<<SYS>>\n{conv.system}\n<</SYS>>\n\n"
            directive = _LLAMA2_VIDEO_DIRECTIVE if inject_directive else ""
            text = sys_block + directive + text
        if i % 2 == 0:
            out += conv.sep + f"[INST] {text} [/INST]"
        else:
            out += " " + text + " " + conv.sep2
    if conv.sep:
        out = out.lstrip(conv.sep)
    return out


def merge_consecutive_user_turns(
    messages: Sequence[Sequence[Any]], user_role: str = "USER"
) -> List[List[Any]]:
    """Fold runs of consecutive user turns into one, dropping a trailing
    unanswered user turn — the LIVE-template behavior
    (reference conversation.py:101-130)."""
    merged: List[List[Any]] = []
    buffer = None
    for role, message in messages:
        if role == user_role:
            buffer = message if buffer is None else buffer + " " + message
        else:
            if buffer is not None:
                merged.append([user_role, buffer])
                buffer = None
            merged.append([role, message])
    if buffer is not None:
        merged.append([user_role, buffer])
    if merged and merged[-1][0] == user_role:
        merged.pop()
    return merged


def _render_llama2_live(conv: "Conversation", messages) -> str:
    messages = merge_consecutive_user_turns(list(messages), conv.roles[0])
    return _render_llama2(conv, messages, inject_directive=False)


_RENDERERS: Dict[SeparatorStyle, Callable] = {
    SeparatorStyle.SINGLE: _render_single,
    SeparatorStyle.TWO: _render_two,
    SeparatorStyle.MPT: _render_mpt,
    SeparatorStyle.PLAIN: _render_plain,
    SeparatorStyle.LLAMA_2: lambda c, m: _render_llama2(c, m, inject_directive=True),
    SeparatorStyle.LLAMA_2_LIVE: _render_llama2_live,
}


@dataclasses.dataclass
class Conversation:
    """Rolling dialogue state + prompt renderer."""

    system: str
    roles: Tuple[str, str]
    messages: List[List[Any]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = ""
    version: str = "Unknown"
    modality: str = "image"

    def get_prompt(self) -> str:
        messages = list(self.messages)
        # If the first message carries media (a tuple), move the modal token
        # to the front of the text on its own line — or, for mmtag
        # templates, strip it and prepend a tagged exchange (reference
        # conversation.py:39-48: "<Image><image></Image>" / "Received.").
        if messages and isinstance(messages[0][1], tuple):
            role, payload = messages[0]
            text = payload[0].replace(f"<{self.modality}>", "").strip()
            if "mmtag" in self.version:
                messages = [
                    [self.roles[0], "<Image><image></Image>"],
                    [self.roles[1], "Received."],
                    [role, text],
                ] + messages[1:]
            else:
                messages = [[role, f"<{self.modality}>\n" + text]] + messages[1:]
        return _RENDERERS[self.sep_style](self, messages)

    def append_message(self, role: str, message: Any) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
            modality=self.modality,
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": [[r, _msg_text(m)] for r, m in self.messages],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


_ASSISTANT_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)

_HUMAN_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)

conv_mistral_instruct = Conversation(
    system=_ASSISTANT_SYSTEM,
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="",
    sep2="</s>",
)

conv_mistral_instruct_live = Conversation(
    system=_ASSISTANT_SYSTEM,
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2_LIVE,
    sep="",
    sep2="</s>",
)

conv_vicuna_v1 = Conversation(
    system=_ASSISTANT_SYSTEM,
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = Conversation(
    system=(
        "You are a helpful, respectful and honest assistant. Always answer as "
        "helpfully as possible, while being safe.  Your answers should not include "
        "any harmful, unethical, racist, sexist, toxic, dangerous, or illegal "
        "content. Please ensure that your responses are socially unbiased and "
        "positive in nature.\n\nIf a question does not make any sense, or is not "
        "factually coherent, explain why instead of answering something not "
        "correct. If you don't know the answer to a question, please don't share "
        "false information."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = Conversation(
    system=(
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = Conversation(
    system=(
        "<|im_start|>system\nA conversation between a user and an LLM-based AI "
        "assistant. The assistant gives helpful and honest answers."
    ),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

# Qwen2 ChatML.  The reference detects qwen backbones (__init__.py:27-29 sets
# version='qwen') but its conv_templates table (conversation.py:549) has no
# 'qwen' entry, so that path KeyErrors upstream; we supply the standard Qwen2
# chat format so the backbone branch is actually usable.
conv_qwen = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="qwen",
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>\n",
)

conv_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

# vicuna v0 ships a baked-in few-shot exchange (reference
# conversation.py:409-438, offset=2) that every "default"/"v0" prompt
# re-renders verbatim ahead of the live dialogue.
conv_vicuna_v0 = Conversation(
    system=_HUMAN_SYSTEM,
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "What are the key differences between renewable and non-renewable energy sources?"],
        ["Assistant",
            "Renewable energy sources are those that can be replenished naturally in a relatively "
            "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
            "Non-renewable energy sources, on the other hand, are finite and will eventually be "
            "depleted, such as coal, oil, and natural gas. Here are some key differences between "
            "renewable and non-renewable energy sources:\n"
            "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
            "energy sources are finite and will eventually run out.\n"
            "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
            "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
            "and other negative effects.\n"
            "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
            "have lower operational costs than non-renewable sources.\n"
            "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
            "locations than non-renewable sources.\n"
            "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
            "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
            "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
            "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>."
)

conv_llava_v0_mmtag = Conversation(
    system=_MMTAG_SYSTEM,
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1_mmtag = Conversation(
    system=_MMTAG_SYSTEM,
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

conv_llava_v0 = Conversation(
    system=_HUMAN_SYSTEM,
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v1 = Conversation(
    system=_HUMAN_SYSTEM,
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

default_conversation = conv_vicuna_v1

# Key set mirrors the reference registry exactly (conversation.py:549-567):
# same keys → same template objects, incl. "default" → vicuna_v0 (with its
# baked few-shot block) and the mmtag pair.  Extra aliases beyond the
# reference: "qwen" (whose backbone branch upstream had no template at all)
# and "mistral_instruct_live" (snake-case alias for the LIVE key).
conv_templates: Dict[str, Conversation] = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_plain,
    "v0_plain": conv_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "video_llama_beta": conv_llava_llama_2,
    "mistral_instruct": conv_mistral_instruct,
    "mpt": conv_mpt,
    "qwen": conv_qwen,
    "conv_mistral_instruct_LIVE": conv_mistral_instruct_live,
    "mistral_instruct_live": conv_mistral_instruct_live,
}
