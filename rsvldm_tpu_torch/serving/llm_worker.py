"""Continuous-batching LLM worker (the JAX package's
rsvldm_tpu/serving/llm_worker.py; sglang_worker parity surface).

Parity target: the reference LLaVA repo's llava/serve/sglang_worker.py — a
model worker that delegates generation to a high-throughput runtime
instead of calling HF generate per request. Here the runtime is the
port's :class:`~rsvldm_tpu_torch.serving.engine.DecodeEngine`: concurrent
HTTP requests land in the slot pool and share every weight read of the
decode stream, so worker throughput scales with concurrency instead of
serializing.

Protocol (stdlib http.server, same controller handshake as
serving/worker.py):
  POST /worker_generate  {"prompt": str, "max_new_tokens"?, "temperature"?}
                         -> {"text": str}
  POST /worker_generate_stream  same payload -> chunked body of
                         newline-delimited JSON {"text": <prefix so far>}
                         frames, final frame flagged {"finished": true}
                         (model_worker.py generate_stream parity: the
                         reference streams growing-prefix frames too)
  POST /worker_get_status -> {"model_names": [...], "queue_length": N}

`embed_prompt(prompt) -> [S, D]` turns the rendered prompt into spliced
input embeddings — for the captioner this is where anyres vision features
enter; for plain chat it is embed(tokenize(prompt)).

On the card the engine's step graphs are captured when its stepping
thread starts (`serve` starts it before the HTTP server exists, or the
first request does while holding the state lock), so handler threads that
embed prompts on the card never run during a capture. `main` runs on the card unless
given --device cpu.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from ..models.vlm.generate import GenerateConfig
from .engine import DecodeEngine
from .worker import Worker


class LLMWorker(Worker):
    """Worker whose generate path is the continuous-batching engine."""

    def __init__(self, engine: DecodeEngine,
                 embed_prompt: Callable, decode_fn: Callable,
                 worker_name: str, controller_url: str | None = None,
                 model_names: tuple = ("rsvldm-llm",),
                 base_cfg: GenerateConfig | None = None,
                 prefix_text: str | None = None,
                 embed_mm: Callable | None = None):
        """prefix_text: optional shared prompt scaffold (system prompt +
        conversation header). Its KV block is prefilled once via the
        engine's prefix cache; any request whose rendered prompt starts
        with it prefills only the remainder. The split MUST fall on a
        token boundary (end it at a special token such as <|eot_id|>) so
        embed_prompt(suffix) equals the suffix of embed_prompt(full).

        embed_mm: optional (prompt, pil_images) -> [S, D] multimodal
        embedder (models/vlm/generate.py::embed_multimodal_prompt via
        LlavaCaptioner.embed_mm) — enables the reference model_worker's
        base64-`images` payloads (:114-141). Image prompts skip the
        prefix cache (the scaffold split is text-only)."""
        super().__init__(pipeline=None, worker_name=worker_name,
                         controller_url=controller_url,
                         model_names=model_names)
        self.engine = engine
        self.embed_prompt = embed_prompt
        self.embed_mm = embed_mm
        self.decode_fn = decode_fn
        self.base_cfg = base_cfg or GenerateConfig()
        self.prefix_text = prefix_text
        self._prefix_id = (engine.register_prefix(embed_prompt(prefix_text))
                           if prefix_text else None)
        self._stepping = False
        self._state_lock = threading.Lock()

    def _submit(self, prompt: str, cfg: GenerateConfig,
                images=None) -> int:
        if images:
            if self.embed_mm is None:
                raise ValueError("worker is not multimodal (no embed_mm)")
            import base64
            import io

            from PIL import Image
            n_tok = prompt.count("<image>")
            if len(images) != n_tok:
                raise ValueError(f"{len(images)} images does not match "
                                 f"{n_tok} <image> tokens in prompt")
            pil = [Image.open(io.BytesIO(base64.b64decode(b))).convert("RGB")
                   for b in images]
            return self.engine.submit(self.embed_mm(prompt, pil), cfg)
        if self._prefix_id is not None and prompt.startswith(self.prefix_text):
            return self.engine.submit(
                self.embed_prompt(prompt[len(self.prefix_text):]), cfg,
                prefix_id=self._prefix_id)
        return self.engine.submit(self.embed_prompt(prompt), cfg)

    # the engine needs one thread calling step(); HTTP handler threads
    # only submit and wait
    def _step_loop(self):
        import logging
        log = logging.getLogger("rsvldm_torch")
        while not self._stop.is_set():
            try:
                n = self.engine.step()
            except Exception as e:  # one bad step must not wedge the worker
                log.exception("engine.step failed — failing in-flight "
                              "requests and continuing")
                self.engine.fail_all(f"{type(e).__name__}: {e}")
                self._stop.wait(0.1)
                continue
            if n == 0:
                self._stop.wait(0.005)

    def _ensure_stepping(self):
        with self._state_lock:
            if self._stepping:
                return
            # every step graph captured before any request is embedded:
            # other callers wait on the lock meanwhile
            self.engine.warmup()
            self._stepping = True
        threading.Thread(target=self._step_loop, daemon=True).start()

    def _make_cfg(self, max_new_tokens, temperature) -> GenerateConfig:
        cfg = self.base_cfg
        if max_new_tokens is not None:
            cfg = dataclasses.replace(cfg, max_new_tokens=int(max_new_tokens))
        if temperature is not None:
            cfg = dataclasses.replace(cfg, temperature=float(temperature),
                                      do_sample=float(temperature) > 0)
        return cfg

    def generate_text(self, prompt: str, max_new_tokens: int | None = None,
                      temperature: float | None = None,
                      images=None) -> str:
        self._ensure_stepping()
        cfg = self._make_cfg(max_new_tokens, temperature)
        with self._state_lock:
            self.queue_length += 1
        uid = None
        try:
            uid = self._submit(prompt, cfg, images=images)
            ids = self.engine.wait(uid, timeout=600)
            return self.decode_fn(ids.tolist()).lstrip()
        finally:
            if uid is not None:
                self.engine.release(uid)
            with self._state_lock:
                self.queue_length -= 1

    def generate_stream(self, prompt: str, max_new_tokens=None,
                        temperature=None, poll_s: float = 0.01,
                        images=None):
        """Yield growing-prefix decoded strings while the engine decodes,
        then the final text. Decoding a PREFIX of the id stream each frame
        keeps multi-byte/BPE merges correct (the reference decodes the
        full prefix per frame for the same reason)."""
        self._ensure_stepping()
        cfg = self._make_cfg(max_new_tokens, temperature)
        with self._state_lock:
            self.queue_length += 1
        uid = None
        try:
            uid = self._submit(prompt, cfg, images=images)
            req = self.engine._requests[uid]
            sent = 0
            while not req.event.wait(poll_s):
                n = len(req.out_ids)
                if n > sent:
                    sent = n
                    yield self.decode_fn(list(req.out_ids[:n])).lstrip()
            if req.error is not None:
                raise RuntimeError(req.error)
            yield self.decode_fn(list(req.out_ids)).lstrip()
        finally:
            if uid is not None:
                self.engine.release(uid)
            with self._state_lock:
                self.queue_length -= 1

    def serve(self, host: str = "0.0.0.0", port: int = 40001):
        self._ensure_stepping()
        worker = self

        class Handler(BaseHTTPRequestHandler):
            # chunked Transfer-Encoding (the stream endpoint) is an
            # HTTP/1.1 construct — the 1.0 default would advertise a
            # version whose clients don't deframe chunked bodies
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                # any failure (bad payload, engine timeout) must come back
                # as a JSON error body, not a dropped socket
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/worker_generate_stream":
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/x-ndjson")
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()

                        def chunk(obj):
                            frame = json.dumps(obj).encode() + b"\n"
                            self.wfile.write(
                                f"{len(frame):x}\r\n".encode() + frame
                                + b"\r\n")
                            self.wfile.flush()
                        # once headers are out NOTHING may escape this
                        # branch: a leaked exception would reach the outer
                        # handler, which writes a SECOND response into the
                        # unterminated chunked body
                        try:
                            last = ""
                            for text in worker.generate_stream(
                                    payload["prompt"],
                                    payload.get("max_new_tokens"),
                                    payload.get("temperature"),
                                    images=payload.get("images")):
                                last = text
                                chunk({"text": text})
                            chunk({"text": last, "finished": True})
                            self.wfile.write(b"0\r\n\r\n")
                        except ConnectionError:
                            # client hung up mid-stream — routine; the
                            # chunked body is unterminated so the
                            # connection must not be reused
                            self.close_connection = True
                        except Exception as e:
                            try:
                                chunk({"error": f"{type(e).__name__}: {e}"})
                                self.wfile.write(b"0\r\n\r\n")
                            except OSError:
                                self.close_connection = True
                        return
                    if self.path == "/worker_generate":
                        out = {"text": worker.generate_text(
                            payload["prompt"],
                            payload.get("max_new_tokens"),
                            payload.get("temperature"),
                            images=payload.get("images"))}
                    elif self.path == "/worker_get_status":
                        out = dict(model_names=worker.model_names,
                                   speed=worker.speed,
                                   queue_length=worker.queue_length)
                    else:
                        out = {"error": "unknown endpoint"}
                except Exception as e:
                    out = {"error": f"{type(e).__name__}: {e}"}
                from .http_util import send_json
                send_json(self, out)

            def log_message(self, *a):
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        return self._finish_serve(server)


def parse_args(argv=None):
    """The worker's flags (JAX's, with --device for --platform)."""
    import argparse
    ap = argparse.ArgumentParser(
        description="rsvldm continuous-batching LLM worker")
    ap.add_argument("--host", type=str, default="localhost")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--worker-address", type=str, default=None)
    ap.add_argument("--controller-address", type=str,
                    default="http://localhost:21001")
    ap.add_argument("--no-register", action="store_true")
    ap.add_argument("--model-name", type=str, default="rsvldm-llm")
    ap.add_argument("--ckpt_dir", type=str, default="./CKPT_PTH")
    ap.add_argument("--load-8bit", action="store_true", default=True,
                    help="int8 weight-only decoder (default on)")
    ap.add_argument("--no-load-8bit", dest="load_8bit", action="store_false")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--kv-8bit", action="store_true",
                    help="int8 KV cache: half the cache bytes -> double "
                         "the slots/context per card")
    ap.add_argument("--slots", type=int, default=8,
                    help="concurrent decode rows (continuous batching)")
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunk long-prompt admission (tokens per step; "
                         "0 = whole-prompt prefill)")
    ap.add_argument("--draft_dir", type=str, default="",
                    help="Llama-family draft checkpoint for engine-composed "
                         "speculative decoding")
    ap.add_argument("--no-draft", action="store_true",
                    help="ignore an auto-discovered <ckpt_dir>/llava_draft/ "
                         "(disable speculative decoding)")
    ap.add_argument("--self-draft", type=int, default=0, metavar="N",
                    help="speculative decoding with a depth-pruned SELF-"
                         "draft (the target's first N layers; no draft "
                         "checkpoint, no extra memory) when no real draft "
                         "is available")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--decode-horizon", type=int, default=1, metavar="H",
                    help="decode H tokens per device dispatch when the "
                         "scheduler is idle (amortizes the per-step host "
                         "sync H-fold; streams arrive in bursts of up to "
                         "H tokens). Does not compose with speculative "
                         "decoding")
    ap.add_argument("--prefix-file", type=str, default="",
                    help="file holding a shared prompt scaffold; its KV "
                         "block is prefilled once (prefix caching). Must "
                         "end on a token boundary")
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def build_engine(args, cap) -> DecodeEngine:
    """The engine `main` serves, over a built captioner: its decoder (an
    int8 KV pool under --kv-8bit), the draft it carries, and the flags'
    slots, length, chunk, proposals and horizon."""
    return DecodeEngine(cap.llama, slots=args.slots, max_len=args.max_len,
                        kv_8bit=args.kv_8bit,
                        prefill_chunk=args.prefill_chunk or None,
                        draft=cap.draft, spec_k=args.spec_k,
                        decode_horizon=args.decode_horizon)


def main(argv=None, block: bool = True):
    """`python -m rsvldm_tpu_torch.serving.llm_worker` — the reference's
    `python -m llava.serve.sglang_worker` launch: a worker whose generate
    path is the continuous-batching engine. --slots is the
    --limit-model-concurrency equivalent (but decode here batches the
    concurrent requests over one weight stream instead of gating them).
    block=False returns (worker, server)."""
    args = parse_args(argv)
    from ..models.vlm.captioner import LlavaCaptioner
    quant = "int4" if args.load_4bit else ("int8" if args.load_8bit else None)

    # speculative decoding does not compose with prefix caching or chunked
    # prefill (engine.submit/DecodeEngine refuse) — fail or opt out at
    # LAUNCH, not per request after the worker registered healthy
    wants_prefix_or_chunk = bool(args.prefix_file) or bool(args.prefill_chunk)
    if (args.draft_dir or args.self_draft) and wants_prefix_or_chunk:
        raise SystemExit(
            "--draft_dir/--self-draft (speculative decoding) does not "
            "compose with --prefix-file/--prefill-chunk — drop one of them")
    if (args.draft_dir or args.self_draft) and args.decode_horizon > 1:
        raise SystemExit(
            "--draft_dir/--self-draft (speculative decoding) does not "
            "compose with --decode-horizon — drop one of them")
    draft_dir = (False if (args.no_draft or wants_prefix_or_chunk
                           or args.decode_horizon > 1)
                 else (args.draft_dir or None))
    if draft_dir is False and not args.no_draft:
        from pathlib import Path
        if (Path(args.ckpt_dir) / "llava_draft").is_dir():
            print("note: auto-discovered llava_draft/ ignored — "
                  "--prefix-file/--prefill-chunk/--decode-horizon do not "
                  "compose with speculative decoding", flush=True)

    cap = LlavaCaptioner.load(args.ckpt_dir, quant=quant,
                              draft_dir=draft_dir,
                              spec_k=args.spec_k,
                              self_draft_layers=(0 if args.no_draft
                                                 else args.self_draft),
                              device=args.device)
    if cap is None:
        raise SystemExit(f"no llava assets under {args.ckpt_dir}")

    engine = build_engine(args, cap)
    decode_fn = lambda ids: cap.tokenizer.decode(ids,
                                                 skip_special_tokens=True)
    prefix_text = None
    if args.prefix_file:
        with open(args.prefix_file, encoding="utf-8") as f:
            prefix_text = f.read()
    name = args.worker_address or f"http://{args.host}:{args.port}"
    worker = LLMWorker(
        engine, embed_prompt=lambda p: cap.embed_mm(p, []),
        decode_fn=decode_fn, worker_name=name,
        controller_url=(None if args.no_register
                        else args.controller_address),
        model_names=(args.model_name,),
        base_cfg=GenerateConfig(max_new_tokens=args.max_new_tokens,
                                temperature=args.temperature,
                                do_sample=args.temperature > 0),
        prefix_text=prefix_text, embed_mm=cap.embed_mm)
    server = worker.serve(args.host, args.port)
    print(f"llm worker {worker.worker_name} serving model "
          f"'{args.model_name}' "
          f"({args.slots} slots, quant={quant or 'bf16'})", flush=True)
    if not block:
        return worker, server
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        worker.stop()
        server.shutdown()


if __name__ == "__main__":
    main()
