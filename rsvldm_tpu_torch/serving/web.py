"""Minimal web frontend (llava/serve/gradio_web_server.py equivalent; the
JAX package's rsvldm_tpu/serving/web.py, kept here as a copy).

The reference's gradio UI posts to the controller, which picks a worker by
lottery/shortest-queue; the worker runs the model. Same topology here with
zero dependencies: a stdlib http.server that serves an upload form, asks
the controller for a worker address (/get_worker_address) and forwards the
base64 image to the worker's /worker_generate. A /chat page covers the
multimodal chat UIs (gradio_web_server + gradio_multi_image): a prompt with
any number of <image> placeholders plus uploaded files, routed to an
LLMWorker (serving/llm_worker.py) whose payload protocol already carries
base64 `images`.
"""

from __future__ import annotations

import json
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PAGE = """<!doctype html>
<title>rsvldm-tpu</title>
<h1>Remote-sensing super-resolution</h1>
<form method=post enctype=application/json onsubmit=\"return go(event)\">
  <input type=file id=f accept=image/*> <button>Upscale</button>
</form>
<pre id=out></pre>
<script>
async function go(e) {
  e.preventDefault();
  const file = document.getElementById('f').files[0];
  const b64 = await new Promise(r => { const fr = new FileReader();
    fr.onload = () => r(fr.result.split(',')[1]); fr.readAsDataURL(file); });
  const resp = await fetch('/generate', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({image: b64, model: 'rsvldm-sr'})});
  document.getElementById('out').textContent = await resp.text();
  return false;
}
</script>
<p><a href=/chat>multimodal chat</a></p>"""

CHAT_PAGE = """<!doctype html>
<title>rsvldm-tpu chat</title>
<h1>Multimodal chat</h1>
<p>Write a prompt; use one <code>&lt;image&gt;</code> placeholder per
uploaded file (gradio_multi_image parity).</p>
<textarea id=p rows=4 cols=80>&lt;image&gt;\nDescribe this image.</textarea>
<br><input type=file id=f accept=image/* multiple>
<button onclick=go()>Send</button>
<pre id=out></pre>
<script>
async function go() {
  const files = [...document.getElementById('f').files];
  const imgs = await Promise.all(files.map(f => new Promise(r => {
    const fr = new FileReader();
    fr.onload = () => r(fr.result.split(',')[1]); fr.readAsDataURL(f); })));
  const resp = await fetch('/generate_stream', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({prompt: document.getElementById('p').value,
                          images: imgs, model: 'rsvldm-llm'})});
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  const out = document.getElementById('out');
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    let i;
    while ((i = buf.indexOf('\\n')) >= 0) {
      const line = buf.slice(0, i); buf = buf.slice(i + 1);
      if (!line.trim()) continue;
      const j = JSON.parse(line);
      out.textContent = j.text !== undefined ? j.text : (j.error || '');
    }
  }
}
</script>"""


class WebServer:
    """dispatch_fn(payload_dict) -> result_dict. The default dispatcher
    routes via the controller like gradio_web_server.http_bot."""

    def __init__(self, controller_url: str | None = None,
                 dispatch_fn=None, host: str = "127.0.0.1", port: int = 0):
        if controller_url is None and dispatch_fn is None:
            raise ValueError("WebServer needs a controller_url or a "
                             "dispatch_fn (fail fast, not per-request)")
        self.controller_url = controller_url
        self.dispatch = dispatch_fn or self._controller_dispatch
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, PAGE.encode(), "text/html")
                elif self.path == "/chat":
                    self._send(200, CHAT_PAGE.encode(), "text/html")
                else:
                    self._send(404, b"{}")

            # /generate_stream relays a chunked ndjson body — HTTP/1.1
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                if self.path == "/generate_stream":
                    self._stream()
                    return
                if self.path != "/generate":
                    self._send(404, b"{}")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n))
                    result = outer.dispatch(outer._render_prompt(payload))
                    self._send(200, json.dumps(result).encode())
                except Exception as e:  # surface worker errors to the UI
                    self._send(500, json.dumps({"error": str(e)}).encode())

            def _stream(self):
                """Relay the worker's /worker_generate_stream frames to
                the browser (gradio_web_server.http_bot streams the
                worker's growing-prefix frames the same way)."""
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n))
                    frames = outer._stream_dispatch(
                        outer._render_prompt(payload))
                except Exception as e:
                    self._send(500, json.dumps({"error": str(e)}).encode())
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                # headers are out — nothing may escape (a leaked exception
                # would write a second response into the chunked body)
                try:
                    for frame in frames:
                        body = json.dumps(frame).encode() + b"\n"
                        self.wfile.write(f"{len(body):x}\r\n".encode()
                                         + body + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except ConnectionError:
                    self.close_connection = True
                except Exception as e:
                    try:
                        body = (json.dumps({"error": str(e)}).encode()
                                + b"\n")
                        self.wfile.write(f"{len(body):x}\r\n".encode()
                                         + body + b"\r\n0\r\n\r\n")
                    except OSError:
                        self.close_connection = True

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    @staticmethod
    def _render_prompt(payload: dict) -> dict:
        """Render the llama-3 chat template around a raw textarea prompt —
        the reference gradio server posts conv.get_prompt(), never the raw
        text (an un-templated prompt has no BOS/headers, so the model never
        positions itself as assistant and rarely emits <|eot_id|>).
        Already-rendered prompts (multi-turn clients) and non-LLM payloads
        pass through; raw_prompt=true opts out."""
        p = payload.get("prompt")
        if (p is None or payload.get("raw_prompt")
                or p.startswith("<|begin_of_text|>")):
            return payload
        from ..models.vlm.generate import llama3_chat_prompt
        return {**payload, "prompt": llama3_chat_prompt(p)}

    def _post_json(self, url: str, payload: dict) -> dict:
        req = urllib.request.Request(
            url, json.dumps(payload).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    def _controller_dispatch(self, payload: dict) -> dict:
        """gradio_web_server.http_bot topology: ask the controller for a
        worker, then forward the job."""
        addr = self._post_json(self.controller_url + "/get_worker_address",
                               {"model": payload.get("model", "rsvldm-sr")})
        worker = addr.get("address")
        if not worker:
            return {"error": "no available worker"}
        return self._post_json(worker + "/worker_generate", payload)

    def _stream_dispatch(self, payload: dict):
        """Generator of worker /worker_generate_stream frames, resolved
        via the controller — the browser sees tokens as they decode
        (gradio_web_server.http_bot consumes the same worker stream)."""
        if self.controller_url is None:
            yield {"error": "streaming requires a controller"}
            return
        addr = self._post_json(self.controller_url + "/get_worker_address",
                               {"model": payload.get("model", "rsvldm-llm")})
        worker = addr.get("address")
        if not worker:
            yield {"error": "no available worker"}
            return
        req = urllib.request.Request(
            worker + "/worker_generate_stream",
            json.dumps(payload).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            for line in r:
                if line.strip():
                    yield json.loads(line)

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None, block: bool = True):
    """`python -m rsvldm_tpu_torch.serving.web` — the reference's
    `python -m llava.serve.gradio_web_server` launch: a browser frontend
    that routes jobs through the controller. block=False returns the live
    WebServer (tests)."""
    import argparse
    import threading
    ap = argparse.ArgumentParser(description="rsvldm web frontend")
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--controller-url", type=str,
                    default="http://localhost:21001")
    args = ap.parse_args(argv)
    srv = WebServer(controller_url=args.controller_url, host=args.host,
                    port=args.port)
    print(f"web UI on http://{args.host}:{srv.port} "
          f"(controller {args.controller_url})", flush=True)
    if not block:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
