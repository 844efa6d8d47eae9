"""Control daemon CLI — the `zmq_control_server` equivalent.

  totton-control [--endpoint ipc:///tmp/totton_zmq.sock]
                 [--pub-endpoint tcp://0.0.0.0:5556]

Endpoint precedence: --endpoint flag > TOTTON_ZMQ_ENDPOINT env > default
(reference: src/zmq/zmq_server_main.cpp:101-103).
"""

from __future__ import annotations

import argparse
import signal
import sys

from totton_tpu_torch.control.daemon import ControlDaemon


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="totton-control", description=__doc__)
    p.add_argument("--endpoint", default=None)
    p.add_argument("--pub-endpoint", default=None)
    p.add_argument("--stats-path", default=None)
    args = p.parse_args(argv)

    daemon = ControlDaemon(
        endpoint=args.endpoint,
        pub_endpoint=args.pub_endpoint,
        stats_path=args.stats_path,
    )

    stopping = []

    def handle_signal(signum, frame):
        stopping.append(signum)

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)

    daemon.start()
    print(f"ZMQ server listening on {daemon.endpoint}", flush=True)
    if args.pub_endpoint:
        print(f"ZMQ pub endpoint {args.pub_endpoint}", flush=True)

    try:
        while not daemon.shutdown_requested and not stopping:
            daemon.wait_for_shutdown(timeout=0.2)
    finally:
        daemon.stop()
    print("ZMQ server stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
