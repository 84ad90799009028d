"""Content-safety hooks for the serving plane: a keyword scan over streamed
text (the worker runs it every few tokens and replaces the stream with a
refusal on a hit), and an optional moderation call on user input."""
from __future__ import annotations

import os
from typing import Iterable, Sequence

DEFAULT_KEYWORDS: Sequence[str] = (
    "child sexual", "csam", "make a bomb", "build a bomb",
)

SAFETY_MSG = "I cannot help with that request."


def safety_check(text: str, keywords: Iterable[str] = DEFAULT_KEYWORDS) -> bool:
    """True → the text is safe."""
    lower = text.lower()
    return not any(k in lower for k in keywords)


def violates_moderation(text: str) -> bool:
    """The OpenAI moderation check, only when OPENAI_API_KEY is set; fails
    open (False) without a key or a connection."""
    if not os.environ.get("OPENAI_API_KEY"):
        return False
    try:
        import openai  # type: ignore

        client = openai.OpenAI()
        result = client.moderations.create(input=text)
        return bool(result.results[0].flagged)
    except Exception:  # noqa: BLE001
        return False
