"""The port's ServeClient validates rates (ROADMAP C5's client fault,
repaired in the port's copy; the reference client stays as it is): a
rate <= 0 raises ValueError before connecting, and an announced output
rate that is not a positive multiple of the rate closes the socket and
raises OSError. A fake server answers the handshake with a chosen
rate."""

import socket
import threading

import pytest

torch = pytest.importorskip("torch")

from totton_tpu_torch.io.serve_client import ServeClient
from totton_tpu_torch.io.sockets import HEADER_BYTES, pack_header


def _fake_server(answer_rate):
    """A one-shot server that reads the client's header and answers with
    ``answer_rate``; returns (port, accepted-connection list)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    conns = []

    def run():
        srv.settimeout(10)
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        finally:
            srv.close()
        conns.append(conn)
        got = b""
        while len(got) < HEADER_BYTES:
            chunk = conn.recv(HEADER_BYTES - len(got))
            if not chunk:
                return
            got += chunk
        conn.sendall(pack_header(None, 2, answer_rate))

    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[1], conns


@pytest.mark.parametrize("rate", [0, -44100])
def test_rate_not_positive_raises_before_connecting(rate):
    port, conns = _fake_server(88200)
    with pytest.raises(ValueError, match="positive"):
        ServeClient(f"tcp://127.0.0.1:{port}", 2, rate, connect_window_s=1)
    assert conns == []  # never connected


@pytest.mark.parametrize("announced", [88201, 22050, 0])
def test_announced_rate_not_a_multiple_closes_and_raises(announced):
    port, _ = _fake_server(announced)
    with pytest.raises(OSError, match="not a positive multiple"):
        ServeClient(f"tcp://127.0.0.1:{port}", 2, 44100, connect_window_s=5)


def test_announced_multiple_gives_the_ratio():
    port, conns = _fake_server(44100 * 16)
    with ServeClient(f"tcp://127.0.0.1:{port}", 2, 44100,
                     connect_window_s=5) as c:
        assert (c.output_rate, c.ratio) == (705600, 16)
    for conn in conns:
        conn.close()
