"""Model worker: registers with the controller, heartbeats, serves SR jobs
(the JAX package's rsvldm_tpu/serving/worker.py over the port's
SuperResolutionPipeline).

Parity target: the reference LLaVA repo's llava/serve/model_worker.py
(:38-90 — register on start, periodic heartbeat with queue length,
streaming generate). Dependency-free: the http.server endpoint
/worker_generate runs the pipeline on a base64-encoded image. `main` runs
on the card unless given --device cpu.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .http_util import post_json, send_json

log = logging.getLogger("rsvldm_torch")

HEARTBEAT_INTERVAL = 15  # model_worker.py:38-43


class Worker:
    def __init__(self, pipeline, worker_name: str,
                 controller_url: str | None = None,
                 model_names: tuple = ("rsvldm-sr",), speed: float = 1.0):
        self.pipeline = pipeline
        self.worker_name = worker_name
        self.controller_url = controller_url
        self.model_names = list(model_names)
        self.speed = speed  # lottery-dispatch weight (model_worker parity)
        self.queue_length = 0
        self._stop = threading.Event()
        # ThreadingHTTPServer handles requests concurrently — the counter
        # the controller load-balances on must not lose updates
        self._queue_lock = threading.Lock()

    # ---- controller protocol ----
    def _post(self, path: str, payload: dict) -> dict:
        return post_json(self.controller_url + path, payload)

    def register(self):
        if self.controller_url:
            self._post("/register_worker",
                       dict(worker_name=self.worker_name,
                            model_names=self.model_names,
                            speed=self.speed,
                            queue_length=self.queue_length))

    def heartbeat_loop(self):
        if not self.controller_url:  # standalone worker: nothing to beat
            return
        while not self._stop.is_set():
            try:
                out = self._post("/receive_heart_beat",
                                 dict(worker_name=self.worker_name,
                                      queue_length=self.queue_length))
                if not out.get("exist"):
                    self.register()  # controller restarted (worker.py:78-90)
            except Exception:
                pass
            self._stop.wait(HEARTBEAT_INTERVAL)

    # ---- job execution ----
    def generate(self, image_b64: str) -> dict:
        import os
        import tempfile

        from PIL import Image
        with self._queue_lock:
            self.queue_length += 1
        try:
            img = Image.open(io.BytesIO(base64.b64decode(image_b64)))
            with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
                img.save(f, format="PNG")
                path = f.name
            try:
                out = self.pipeline.process(path)
            finally:
                os.unlink(path)
            buf = io.BytesIO()
            out.save(buf, format="PNG")
            return {"image": base64.b64encode(buf.getvalue()).decode()}
        finally:
            with self._queue_lock:
                self.queue_length -= 1

    def _advertise_bound_port(self, server) -> None:
        """An advertised name ending in :0 (OS-assigned port) must be
        rewritten to the port the server actually bound BEFORE the
        controller hears it — the controller probes that URL."""
        if self.worker_name.endswith(":0"):
            self.worker_name = (self.worker_name.rsplit(":", 1)[0]
                                + f":{server.server_address[1]}")

    def _finish_serve(self, server):
        """Shared serve() tail: start serving, advertise the BOUND port,
        register, start heartbeats. Binding first means the controller's
        registration probe can already be answered. Initial registration
        tolerates an absent/restarting controller — a model load takes
        minutes and must not be thrown away over a refused connect; the
        heartbeat loop re-registers within HEARTBEAT_INTERVAL."""
        threading.Thread(target=server.serve_forever, daemon=True).start()
        self._advertise_bound_port(server)
        try:
            self.register()
        except Exception as e:
            log.warning("initial register with %s failed (%s) — the "
                        "heartbeat loop will retry", self.controller_url, e)
        threading.Thread(target=self.heartbeat_loop, daemon=True).start()
        return server

    def serve(self, host: str = "0.0.0.0", port: int = 40000):
        worker = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                # any failure (bad payload, PIL decode, pipeline error) must
                # come back as a JSON error body, not a dropped socket
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/worker_generate":
                        out = worker.generate(payload["image"])
                    elif self.path == "/worker_get_status":
                        out = dict(model_names=worker.model_names,
                                   speed=worker.speed,
                                   queue_length=worker.queue_length)
                    else:
                        out = {"error": "unknown endpoint"}
                except Exception as e:
                    out = {"error": f"{type(e).__name__}: {e}"}
                send_json(self, out)

            def log_message(self, *a):
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        return self._finish_serve(server)

    def stop(self):
        self._stop.set()


def main(argv=None, block: bool = True):
    """`python -m rsvldm_tpu_torch.serving.worker` — the reference's
    `python -m llava.serve.model_worker` launch for the SR pipeline:
    registers with the controller and serves /worker_generate on a
    base64-encoded image (model_worker.py argparse tail; pipeline knobs
    replace --model-path)."""
    import argparse
    ap = argparse.ArgumentParser(description="rsvldm SR model worker")
    ap.add_argument("--host", type=str, default="localhost")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--worker-address", type=str, default=None,
                    help="advertised URL (default http://<host>:<port>)")
    ap.add_argument("--controller-address", type=str,
                    default="http://localhost:21001")
    ap.add_argument("--no-register", action="store_true",
                    help="standalone worker (no controller handshake)")
    ap.add_argument("--model-name", type=str, default="rsvldm-sr")
    ap.add_argument("--ckpt_dir", type=str, default="./CKPT_PTH")
    ap.add_argument("--upscale", type=int, default=8)
    ap.add_argument("--num_steps", type=int, default=50)
    ap.add_argument("--img_threshold", type=float, default=0.3)
    ap.add_argument("--no_llava", action="store_true")
    ap.add_argument("--debug_tiny", action="store_true",
                    help="the tiny geometries (infer.py's), no caption")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .. import pipeline as pl
    from ..config import PipelineConfig
    from ..infer import tiny_model_cfgs
    cfg = PipelineConfig(upscale=args.upscale, ckpt_dir=args.ckpt_dir,
                         no_llava=args.no_llava or args.debug_tiny)
    cfg.refine.img_threshold = args.img_threshold
    cfg.refine.edm_steps = args.num_steps
    model_cfgs = None
    if args.debug_tiny:
        model_cfgs = tiny_model_cfgs()
        cfg.refine.min_size = 64
    pipeline = pl.SuperResolutionPipeline(cfg, device=args.device,
                                          model_cfgs=model_cfgs)

    name = args.worker_address or f"http://{args.host}:{args.port}"
    w = Worker(pipeline, worker_name=name,
               controller_url=(None if args.no_register
                               else args.controller_address),
               model_names=(args.model_name,))
    server = w.serve(args.host, args.port)
    print(f"worker {w.worker_name} serving model '{args.model_name}'",
          flush=True)
    if not block:
        return w, server
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        w.stop()
        server.shutdown()


if __name__ == "__main__":
    main()
