"""Manually (re-)register a worker with the controller (the JAX package's
rsvldm_tpu/serving/register_worker.py; the reference LLaVA repo's
llava/serve/register_worker.py): POST /register_worker without model
names, so that the controller probes the worker's own /worker_get_status
and refuses one it cannot reach.

    python -m rsvldm_tpu_torch.serving.register_worker \
        --controller-address http://localhost:21001 \
        --worker-name http://localhost:21002
"""

from __future__ import annotations

from .http_util import post_json


def main(argv=None) -> bool:
    import argparse
    ap = argparse.ArgumentParser(description="manually register a worker")
    ap.add_argument("--controller-address", type=str,
                    default="http://localhost:21001")
    ap.add_argument("--worker-name", type=str, required=True,
                    help="the worker's advertised URL")
    args = ap.parse_args(argv)
    # no model_names: the controller probes the worker itself
    out = post_json(args.controller_address + "/register_worker",
                    {"worker_name": args.worker_name})
    ok = bool(out.get("ok"))
    print(f"register {args.worker_name}: {'ok' if ok else 'FAILED'}",
          flush=True)
    return ok


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
