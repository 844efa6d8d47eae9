"""totton-serve-client: consume a totton-serve stream from the shell.

Streams a local endpoint (WAV/raw/null) through a running totton-serve
(one duplex connection = one server stream slot) and writes the
upsampled result to a local endpoint:

  totton-serve-client --server tcp://dsp-host:9100 \\
      --in music.wav --out music_16x.wav

The serve rate is negotiated from the input (WAV header) or --rate; the
output rate comes back in the server's reply header. --eq-profile sends
the profile as the stream's per-stream EQ block (applied by the server
to THIS stream only). --wire-format picks the on-the-wire PCM encoding
independently of the local file formats (f32 = lossless float, default;
s16 is required by --device-pcm servers).

The reference has no remote-consumption path at all (one local ALSA
process per stream, src/alsa/alsa_streamer_main.cpp); this CLI is how a
shell user reaches the rebuild's multi-stream serving tier.

Exit codes: 0 ok, 1 runtime failure, 2 bad arguments.
"""

from __future__ import annotations

import argparse
import socket
import sys

import numpy as np

from totton_tpu_torch.io.devices import WavFileSource, open_sink, open_source
from totton_tpu_torch.io.pcm import parse_format
from totton_tpu_torch.io.serve_client import DEFAULT_CHUNK_FRAMES, ServeClient


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="totton-serve-client", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--server", required=True,
                   help="totton-serve endpoint (tcp://host:port | "
                        "unix:/path)")
    p.add_argument("--in", dest="in_spec", required=True,
                   help="input endpoint (file.wav | wav:path | file:path "
                        "| null)")
    p.add_argument("--out", dest="out_spec", required=True,
                   help="output endpoint (file.wav | wav:path | "
                        "file:path | null)")
    p.add_argument("--rate", type=int,
                   help="input sample rate (required unless the input "
                        "is a WAV; must match the server's --rate)")
    p.add_argument("--channels", type=int, default=2,
                   help="channels (WAV input overrides)")
    p.add_argument("--format", default="s32",
                   help="local raw/WAV file PCM format (s16|s24|s32)")
    p.add_argument("--wire-format", default="f32",
                   help="on-the-wire PCM encoding to the server "
                        "(f32 = lossless float32, default; s16|s24|s32 "
                        "halve/shrink the socket bytes; --device-pcm "
                        "servers require s16)")
    p.add_argument("--eq-profile",
                   help="Equalizer-APO profile file sent as this "
                        "stream's per-stream EQ block")
    p.add_argument("--chunk", type=int, default=DEFAULT_CHUNK_FRAMES,
                   metavar="FRAMES", help="frames per send")
    p.add_argument("--connect-window", type=float, default=10.0,
                   metavar="SEC",
                   help="connect retry window (the server may still be "
                        "binding)")
    p.add_argument("--timeout", type=float, default=120.0, metavar="SEC",
                   help="socket timeout, including the wait for the "
                        "server's reply header — a COLD server may spend "
                        "minutes compiling its warmup shapes before "
                        "accepting, with connections queued at the "
                        "listener meanwhile; raise this to wait it out")
    p.add_argument("--dither", action="store_true",
                   help="TPDF dither on output quantization")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    try:
        fmt = parse_format(args.format)
    except ValueError as e:
        print(f"error: --format: {e}", file=sys.stderr)
        return 2
    if args.wire_format.lower() in ("f32", "float32", "float"):
        wire_fmt = None
    else:
        try:
            wire_fmt = parse_format(args.wire_format)
        except ValueError as e:
            print(f"error: --wire-format: {e}", file=sys.stderr)
            return 2

    eq_text = None
    if args.eq_profile:
        try:
            with open(args.eq_profile, encoding="utf-8") as f:
                eq_text = f.read()
        except OSError as e:
            print(f"error: --eq-profile: {e}", file=sys.stderr)
            return 2

    try:
        source = open_source(args.in_spec, fmt, args.channels, args.rate)
    except (OSError, ValueError) as e:
        print(f"error: --in: {e}", file=sys.stderr)
        return 2
    if isinstance(source, WavFileSource):
        rate, channels = source.sample_rate, source.channels
    else:
        rate, channels = args.rate, args.channels
    if not rate:
        print("error: --rate is required for non-WAV input",
              file=sys.stderr)
        source.close()
        return 2

    try:
        client = ServeClient(args.server, channels, rate, fmt=wire_fmt,
                             eq_text=eq_text, timeout_s=args.timeout,
                             connect_window_s=args.connect_window)
    except (OSError, ValueError) as e:
        print(f"error: cannot open stream on {args.server}: {e}",
              file=sys.stderr)
        source.close()
        return 1
    print(f"Streaming {args.in_spec} through {args.server}: {rate} Hz -> "
          f"{client.output_rate} Hz ({client.ratio}x)", file=sys.stderr)

    try:
        sink = open_sink(args.out_spec, client.output_rate, fmt,
                         dither=args.dither)
    except (OSError, ValueError) as e:
        print(f"error: --out: {e}", file=sys.stderr)
        client.close()
        source.close()
        return 2

    # Full-duplex pump (serve_client.upsample's shape, but streaming the
    # sink as output arrives instead of holding the signal in memory).
    import threading

    err: list[BaseException] = []

    def pump() -> None:
        try:
            while True:
                x = source.read_frames(args.chunk)
                if x.shape[1] == 0:
                    break
                client.send(x)
            client.end_input()
        except BaseException as e:
            err.append(e)

    frames_out = 0
    t = threading.Thread(target=pump, name="serve-client-pump")
    t.start()
    try:
        while (y := client.read_frames()) is not None:
            sink.write_frames(y)
            frames_out += y.shape[1]
    except OSError as e:
        print(f"error: stream failed: {e}", file=sys.stderr)
        return 1
    finally:
        # Shut the socket down before joining: a pump blocked in sendall
        # (a server that stopped reading) then fails at once, where a
        # join first would hold the exit for up to --timeout.
        try:
            client.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        t.join(timeout=10.0)
        client.close()
        source.close()
        sink.close()
    if err:
        print(f"error: send side failed: {err[0]}", file=sys.stderr)
        return 1
    print(f"Done: {frames_out} output frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
