"""Serving control plane: worker registry with heartbeat expiry + dispatch
(the JAX package's rsvldm_tpu/serving/controller.py, kept here as a copy so
that the port imports nothing of that package).

Parity target: the reference LLaVA repo's llava/serve/controller.py (:28-120 —
DispatchMethod lottery/shortest-queue, heartbeat-based worker expiry,
FastAPI endpoints). Rebuilt dependency-free on http.server (fastapi is not
in the image): same REST surface — /register_worker, /receive_heart_beat,
/list_models, /get_worker_address — and the same expiry/dispatch logic.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

HEARTBEAT_EXPIRATION = 90  # controller.py:51-55


@dataclasses.dataclass
class WorkerInfo:
    model_names: list
    speed: float
    queue_length: int
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        assert dispatch_method in ("lottery", "shortest_queue")
        self.dispatch_method = dispatch_method
        self.workers: dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()

    # ---- registry ----
    def get_worker_status(self, name: str) -> dict | None:
        """Probe a worker's /worker_get_status (controller.py:84-95).
        None on any transport/JSON failure — the caller drops the worker."""
        from .http_util import post_json
        try:
            out = post_json(name + "/worker_get_status", {}, timeout=5)
        except Exception:
            return None
        return None if "error" in out else out

    def register_worker(self, name: str, model_names: list | None = None,
                        speed: float = 1.0, queue_length: int = 0) -> bool:
        """model_names=None is the reference's `worker_status: None` path
        (register_worker.py:20-25): the controller probes the worker for
        its own status and refuses to register an unreachable one."""
        if model_names is None:
            status = self.get_worker_status(name)
            if not status:
                return False
            model_names = status.get("model_names", [])
            speed = status.get("speed", 1.0)
            queue_length = status.get("queue_length", 0)
        with self.lock:
            self.workers[name] = WorkerInfo(model_names, speed, queue_length,
                                            time.time())
        return True

    def refresh_all_workers(self) -> list:
        """Re-probe every registered worker; drop the unreachable ones
        (controller.py:100-106). Probes run in parallel so a fleet with
        several dead hosts resolves in one probe timeout (~5 s), not a
        serial sum that outlives the client's own timeout. Returns the
        removed names."""
        with self.lock:
            names = list(self.workers)
        alive: dict[str, bool] = {}

        def probe(n):
            alive[n] = self.register_worker(n)

        threads = [threading.Thread(target=probe, args=(n,), daemon=True)
                   for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        removed = [n for n in names if not alive[n]]
        with self.lock:
            for n in removed:
                self.workers.pop(n, None)
        return removed

    def receive_heart_beat(self, name: str, queue_length: int) -> bool:
        with self.lock:
            w = self.workers.get(name)
            if w is None:
                return False  # worker must re-register (controller.py:118)
            w.queue_length = queue_length
            w.last_heart_beat = time.time()
            return True

    def remove_stale_workers(self):
        cutoff = time.time() - HEARTBEAT_EXPIRATION
        with self.lock:
            stale = [n for n, w in self.workers.items()
                     if w.last_heart_beat < cutoff]
            for n in stale:
                del self.workers[n]
        return stale

    def list_models(self) -> list:
        with self.lock:
            names = set()
            for w in self.workers.values():
                names.update(w.model_names)
        return sorted(names)

    # ---- dispatch (controller.py:28-39) ----
    def get_worker_address(self, model_name: str) -> str:
        with self.lock:
            cand = [(n, w) for n, w in self.workers.items()
                    if model_name in w.model_names]
            if not cand:
                return ""
            if self.dispatch_method == "lottery":
                # guard all-zero speeds like the shortest-queue branch
                # (random.choices raises on a zero weight total)
                weights = [max(w.speed, 1e-6) for _, w in cand]
                return random.choices([n for n, _ in cand], weights=weights)[0]
            # shortest queue, normalized by speed
            return min(cand, key=lambda nw: nw[1].queue_length
                       / max(nw[1].speed, 1e-6))[0]

    # ---- http ----
    def serve(self, host: str = "0.0.0.0", port: int = 10000):
        ctrl = self

        from .http_util import send_json

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                # malformed JSON / missing keys come back as a structured
                # error (the reference FastAPI controller 422s), never a
                # dropped socket + stderr traceback
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/register_worker":
                        # model_names omitted == the reference's
                        # `worker_status: None` (controller probes the
                        # worker itself; register_worker.py CLI)
                        ok = ctrl.register_worker(
                            payload["worker_name"],
                            payload.get("model_names"),
                            payload.get("speed", 1.0),
                            payload.get("queue_length", 0))
                        send_json(self, {"ok": ok})
                    elif self.path == "/refresh_all_workers":
                        send_json(self, {"removed":
                                         ctrl.refresh_all_workers()})
                    elif self.path == "/receive_heart_beat":
                        ok = ctrl.receive_heart_beat(
                            payload["worker_name"],
                            payload.get("queue_length", 0))
                        send_json(self, {"exist": ok})
                    elif self.path == "/list_models":
                        ctrl.remove_stale_workers()
                        send_json(self, {"models": ctrl.list_models()})
                    elif self.path == "/get_worker_address":
                        ctrl.remove_stale_workers()
                        send_json(self, {"address": ctrl.get_worker_address(
                            payload.get("model", ""))})
                    else:
                        send_json(self, {"error": "unknown endpoint"}, 404)
                except Exception as e:
                    send_json(self, {"error": f"{type(e).__name__}: {e}"},
                              400)

            def log_message(self, *a):
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server


def main(argv=None, block: bool = True):
    """`python -m rsvldm_tpu_torch.serving.controller` — the reference's
    `python -m llava.serve.controller` launch command (controller.py:
    argparse tail), same flags. block=False returns the live server
    (tests)."""
    import argparse
    ap = argparse.ArgumentParser(description="rsvldm serving controller")
    ap.add_argument("--host", type=str, default="localhost")
    ap.add_argument("--port", type=int, default=21001)
    ap.add_argument("--dispatch-method", type=str, default="shortest_queue",
                    choices=["lottery", "shortest_queue"])
    args = ap.parse_args(argv)
    ctrl = Controller(dispatch_method=args.dispatch_method)
    server = ctrl.serve(args.host, args.port)
    print(f"controller listening on http://{args.host}:"
          f"{server.server_address[1]}", flush=True)
    if not block:
        return server
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
