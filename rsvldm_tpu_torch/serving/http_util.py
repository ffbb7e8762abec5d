"""Shared stdlib-HTTP plumbing of the serving package (the JAX package's
rsvldm_tpu/serving/http_util.py): one JSON POST client and one JSON
response writer for the controller, the workers and the web frontend."""

from __future__ import annotations

import json
import urllib.request


def post_json(url: str, payload: dict, timeout: float = 10.0) -> dict:
    req = urllib.request.Request(
        url, json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def send_json(handler, obj: dict, status: int = 200) -> None:
    """Write a complete JSON response on a BaseHTTPRequestHandler."""
    body = json.dumps(obj).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)
