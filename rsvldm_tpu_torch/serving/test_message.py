"""Send a test message through the serving stack and stream the reply
(the JAX package's rsvldm_tpu/serving/test_message.py).

Parity target: the reference LLaVA repo's llava/serve/test_message.py — resolve a
worker via the controller (/refresh_all_workers + /list_models +
/get_worker_address) or hit one directly, render the conversation
template around the message, then consume /worker_generate_stream frames.

Usage:
  python -m rsvldm_tpu_torch.serving.test_message \
      --controller-address http://localhost:21001 \
      --model-name rsvldm-llm --message "Describe remote sensing."
"""

from __future__ import annotations

import json
import urllib.request

from .http_util import post_json


def stream_generate(worker_addr: str, payload: dict, timeout: float = 600):
    """Yield the text of each /worker_generate_stream frame (growing
    decoded prefixes, reference model_worker semantics). Raises on an
    error frame."""
    req = urllib.request.Request(
        worker_addr + "/worker_generate_stream",
        json.dumps(payload).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:  # http.client deframes the chunked ndjson body
            if not line.strip():
                continue
            frame = json.loads(line)
            if "error" in frame:
                raise RuntimeError(frame["error"])
            yield frame["text"]
            if frame.get("finished"):
                return


def main(argv=None) -> str:
    import argparse
    ap = argparse.ArgumentParser(description="send a test message")
    ap.add_argument("--controller-address", type=str,
                    default="http://localhost:21001")
    ap.add_argument("--worker-address", type=str, default=None,
                    help="skip the controller and hit this worker directly")
    ap.add_argument("--model-name", type=str, default="rsvldm-llm")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--message", type=str,
                    default="Tell me a story with more than 1000 words.")
    ap.add_argument("--raw-prompt", action="store_true",
                    help="send the message untemplated")
    args = ap.parse_args(argv)

    if args.worker_address:
        worker_addr = args.worker_address
    else:
        # refresh probes every worker (5 s timeout each, in parallel) —
        # give the round-trip headroom beyond one probe timeout
        post_json(args.controller_address + "/refresh_all_workers", {},
                  timeout=30)
        models = post_json(args.controller_address + "/list_models",
                           {})["models"]
        print(f"Models: {sorted(models)}", flush=True)
        worker_addr = post_json(
            args.controller_address + "/get_worker_address",
            {"model": args.model_name})["address"]
        print(f"worker_addr: {worker_addr}", flush=True)
    if not worker_addr:
        print("no available worker", flush=True)
        return ""

    prompt = args.message
    if not args.raw_prompt:
        # default_conversation.get_prompt() equivalent (test_message.py:29)
        from ..models.vlm.generate import llama3_chat_prompt
        prompt = llama3_chat_prompt(args.message)

    text = ""
    for text in stream_generate(worker_addr, {
            "prompt": prompt, "max_new_tokens": args.max_new_tokens,
            "temperature": args.temperature}):
        print(text, end="\r", flush=True)
    print(text, flush=True)
    return text


if __name__ == "__main__":
    main()
