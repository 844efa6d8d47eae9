"""Web UI/API server CLI.

  totton-web [--host 0.0.0.0] [--port 8080]

Serves the control surface (EQ management, OPRA browse/apply/sync, daemon
control, status, config) — the reference's uvicorn+FastAPI entrypoint,
on aiohttp.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    import sys

    from aiohttp import web

    from totton_tpu_torch.web.app import create_app
    from totton_tpu_torch.web.services.restart import resolve_restart_fn

    p = argparse.ArgumentParser(prog="totton-web", description=__doc__)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)

    # POST /api/daemon/restart strategy (TOTTON_RESTART_CMD, or the Docker
    # socket when reachable; see web/services/restart.py). None -> 501.
    restart_fn = resolve_restart_fn()
    if restart_fn is not None:
        print("daemon restart hook: configured", file=sys.stderr)
    web.run_app(create_app(restart_fn=restart_fn), host=args.host,
                port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
