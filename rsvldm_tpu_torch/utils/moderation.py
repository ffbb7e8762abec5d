"""Content moderation check (rsvldm_tpu/utils/moderation.py, LLaVA's
llava/utils.py violates_moderation): POSTs the text to the OpenAI
moderation API and returns its `flagged` verdict; any error (network,
missing key, malformed response) fails open to False with a warning, as
LLaVA's try/except does. Standard library only (urllib); the endpoint and
key layout are LLaVA's, and `moderation_msg` is its user-facing string.
"""

from __future__ import annotations

import json
import logging
import os
import urllib.request

log = logging.getLogger("rsvldm_torch")

MODERATION_URL = "https://api.openai.com/v1/moderations"
moderation_msg = ("I am sorry. Your input may violate our content "
                  "moderation guidelines. Please avoid using harmful or "
                  "offensive content.")


def violates_moderation(text: str, *, timeout: float = 5.0,
                        _urlopen=urllib.request.urlopen) -> bool:
    """True when the moderation API flags `text`; False on any failure
    (fail-open, as LLaVA's). Requires
    OPENAI_API_KEY in the environment."""
    key = os.environ.get("OPENAI_API_KEY")
    if not key:
        log.warning("moderation: OPENAI_API_KEY not set — skipping check")
        return False
    payload = json.dumps({"input": text.replace("\n", "")}).encode()
    req = urllib.request.Request(
        MODERATION_URL, payload,
        {"Content-Type": "application/json",
         "Authorization": "Bearer " + key})
    try:
        with _urlopen(req, timeout=timeout) as r:
            return bool(json.loads(r.read())["results"][0]["flagged"])
    except Exception as e:  # network / key / schema — fail open
        log.warning("moderation error: %s", e)
        return False
