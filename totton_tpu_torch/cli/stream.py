"""Streaming upsampler CLI on the port (file mode): ``totton-stream-torch``.

The flag surface of ``totton-stream`` for files, WAV and stdio endpoints,
running the port's engine on a CUDA device (or the plain torch path with
``--device cpu``):

  totton-stream-torch --in song.wav --out up.wav --ratio 16 \\
      --filter-dir data/coefficients --format s16
  totton-stream-torch --in-file in.raw --out-file out.raw --rate 44100 \\
      --ratio 16 --format s32

Sharding, crossfeed, the threaded session and the control plane are not
ported yet; their flags exit with code 2.

Exit codes: 0 ok, 1 runtime failure, 2 bad arguments or no CUDA device.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

import numpy as np

_NOT_PORTED = ("shard_time", "shard_channel", "distributed", "crossfeed",
               "threaded", "control_endpoint", "control_pub_endpoint")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="totton-stream-torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--in", dest="in_spec",
                   help="input endpoint (null | path.wav | file:path | -)")
    p.add_argument("--out", dest="out_spec",
                   help="output endpoint (null | path.wav | file:path | -)")
    p.add_argument("--in-file", dest="in_file",
                   help="raw PCM input file (interleaved)")
    p.add_argument("--out-file", dest="out_file",
                   help="raw PCM output file (interleaved)")
    p.add_argument("--filter", help="filter JSON path (docs/filter_format.md)")
    p.add_argument("--filter-dir", default="data/coefficients",
                   help="filter directory for auto lookup")
    p.add_argument("--phase", default=None, choices=["min", "minimum", "linear"],
                   help="filter phase for auto lookup (default: config.json's "
                        "filter.phaseType when --config is given, else min)")
    p.add_argument("--ratio", type=int, default=1, choices=[1, 2, 4, 8, 16],
                   help="upsample ratio for auto lookup")
    p.add_argument("--latency", default="normal", choices=["normal", "low"],
                   help="filter-bank latency mode for auto lookup: 'normal' "
                        "picks the highest tap count, 'low' the lowest")
    p.add_argument("--rate", type=int, help="input sample rate (Hz)")
    p.add_argument("--channels", type=int, default=2)
    p.add_argument("--format", default="s32", help="PCM format (s16|s24|s32)")
    p.add_argument("--period", type=int, default=4096, help="period frames")
    p.add_argument("--eq-profile", help="Equalizer-APO profile to bake in")
    p.add_argument("--config", dest="config_path",
                   default=os.environ.get("TOTTON_CONFIG_PATH"),
                   help="config.json: eqEnabled/eqProfilePath and "
                        "filter.phaseType are read at startup "
                        "(default $TOTTON_CONFIG_PATH)")
    p.add_argument("--dither", action="store_true",
                   help="TPDF-dither the float->PCM output quantization")
    p.add_argument("--device-pcm", choices=["auto", "on", "off"],
                   default="auto",
                   help="quantize float->s16 on the device (halves the "
                        "device->host transfer). auto: on for s16 output")
    p.add_argument("--swap-fade", type=int, default=4096, metavar="FRAMES",
                   help="crossfade length (output frames) for filter/EQ "
                        "hot swaps (0 = abrupt swap)")
    p.add_argument("--batch-blocks", type=int, default=None,
                   help="filter blocks per device dispatch (default auto: "
                        "deep batches for file sources, small for realtime)")
    p.add_argument("--stats-path", help="write stats JSON here")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; exits 2 without CUDA) "
                        "or cpu (the plain torch path)")
    # Not ported yet: accepted so the refusal is explicit.
    p.add_argument("--threaded", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--shard-time", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--shard-channel", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--distributed", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--crossfeed", help=argparse.SUPPRESS)
    p.add_argument("--control-endpoint", help=argparse.SUPPRESS)
    p.add_argument("--control-pub-endpoint", help=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name):
            flag = "--" + name.replace("_", "-")
            print(f"error: {flag} is not yet ported to totton-stream-torch",
                  file=sys.stderr)
            return 2

    import torch

    from totton_tpu_torch import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no CUDA, or not a device name
        print(f"error: --device: {e}", file=sys.stderr)
        return 2

    from totton_tpu.control.wiring import (
        resolve_eq_response,
        resolve_startup_phase,
    )
    from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter, load_filter
    from totton_tpu.io.devices import open_sink, open_source
    from totton_tpu.io.pcm import PcmFormat, parse_format
    from totton_tpu_torch.engine.selector import (
        FilterSelectionError,
        resolve_filter_path,
    )
    from totton_tpu_torch.engine.upsampler import StreamingUpsampler
    from totton_tpu_torch.io.stream import StreamSession

    in_spec = args.in_file or args.in_spec
    out_spec = args.out_file or args.out_spec
    if not in_spec or not out_spec:
        print("error: --in/--in-file and --out/--out-file are required",
              file=sys.stderr)
        return 2
    if (args.in_file or args.out_file) and not (
            args.rate or in_spec.endswith(".wav")):
        print("error: --rate is required in raw file mode", file=sys.stderr)
        return 2
    try:
        fmt = parse_format(args.format)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        source = open_source(in_spec, fmt, args.channels, args.rate)
    except (OSError, ValueError) as e:
        print(f"error: cannot open input {in_spec}: {e}", file=sys.stderr)
        return 1
    input_rate = source.sample_rate or args.rate
    if not input_rate:
        print("error: input rate unknown; pass --rate", file=sys.stderr)
        return 2

    phase = resolve_startup_phase(args.phase, args.config_path)
    try:
        if args.filter or args.ratio > 1:
            filter_path = resolve_filter_path(
                filter_path=args.filter, filter_dir=args.filter_dir,
                phase=phase, ratio=args.ratio, input_rate=input_rate,
                latency=args.latency)
            loaded = load_filter(filter_path)
            print(f"Loaded filter: {filter_path} "
                  f"(taps={loaded.sidecar.taps}, ratio={loaded.ratio})",
                  file=sys.stderr)
        else:
            # Ratio-1 passthrough: identity single-tap filter.
            taps = np.zeros(1025, dtype=np.float32)
            taps[0] = 1.0
            loaded = LoadedFilter(
                taps=taps,
                sidecar=FilterSidecar(
                    coefficients_bin="<identity>", taps=1025, fft_size=4096,
                    block_size=4096 - 1024, upsample_factor=1,
                ),
            )
    except (FilterSelectionError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    try:
        eq_response, eq_desc = resolve_eq_response(
            args.eq_profile, args.config_path, loaded.sidecar.fft_size,
            input_rate * loaded.ratio)
    except (OSError, ValueError) as e:
        if args.eq_profile:
            print(f"error: --eq-profile: {e}", file=sys.stderr)
            return 1
        print(f"warning: EQ from config skipped ({e})", file=sys.stderr)
        eq_response, eq_desc = None, None
    if eq_desc:
        print(f"EQ profile baked in: {eq_desc}", file=sys.stderr)

    pcm_eligible = fmt is PcmFormat.S16_LE
    if args.device_pcm == "on" and not pcm_eligible:
        print("error: --device-pcm on requires --format s16", file=sys.stderr)
        return 2
    device_pcm_on = args.device_pcm != "off" and pcm_eligible

    try:
        engine = StreamingUpsampler(
            loaded, channels=source.channels, eq_response=eq_response,
            swap_fade_frames=args.swap_fade,
            device_pcm=PcmFormat.S16_LE if device_pcm_on else None,
            pcm_dither=args.dither and device_pcm_on, device=device)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if device_pcm_on:
        print("Device PCM: s16 quantization on-device"
              + (" (TPDF dither)" if args.dither else ""), file=sys.stderr)
    try:
        # Device-PCM mode: the engine's samples are final — the sink must
        # not re-dither them.
        sink = open_sink(out_spec, input_rate * engine.ratio, fmt,
                         dither=args.dither and not device_pcm_on)
    except (OSError, ValueError) as e:
        print(f"error: cannot open output {out_spec}: {e}", file=sys.stderr)
        return 1

    session = StreamSession(
        source, sink, engine,
        period_frames=args.period,
        max_batch_blocks=args.batch_blocks,
        stats_path=args.stats_path,
    )

    # First signal: graceful stop (drain in-flight dispatches, close files).
    # Second signal: hard exit.
    signal_count = {"n": 0}

    def handle_signal(signum, frame):
        signal_count["n"] += 1
        if signal_count["n"] >= 2:
            print("forced exit (second signal)", file=sys.stderr)
            os._exit(1)
        session.stop()

    old_handlers = {s: signal.signal(s, handle_signal)
                    for s in (signal.SIGINT, signal.SIGTERM)}
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else str(device))
    print("Streaming started "
          f"({input_rate} Hz -> {input_rate * engine.ratio} Hz, "
          f"{source.channels}ch, ratio {engine.ratio}, device {dev_name})",
          file=sys.stderr)
    try:
        stats = session.run()
    finally:
        source.close()
        sink.close()
        for s, h in old_handlers.items():
            signal.signal(s, h)
    print("Streaming stopped", file=sys.stderr)
    print(f"frames_in={stats.frames_in} frames_out={stats.frames_out} "
          f"blocks={stats.blocks_processed} "
          f"realtime_factor={stats.realtime_factor:.1f}x", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
