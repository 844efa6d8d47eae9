"""WAV <-> raw PCM conversion CLI.

Parity with the reference's scripts/test/convert_audio.py:

  python -m totton_tpu_torch.testing.convert_audio wav2raw in.wav out.raw --format s32
  python -m totton_tpu_torch.testing.convert_audio raw2wav in.raw out.wav \
      --rate 44100 --channels 2 --format s32
"""

from __future__ import annotations

import argparse

from totton_tpu_torch.io.pcm import (
    deinterleave,
    float_to_pcm,
    interleave,
    parse_format,
    pcm_to_float,
)
from totton_tpu_torch.io.wav import read_wav, write_wav


def wav_to_raw(wav_path: str, raw_path: str, fmt_name: str) -> tuple[int, int]:
    fmt = parse_format(fmt_name)
    x, rate = read_wav(wav_path)
    with open(raw_path, "wb") as f:
        f.write(float_to_pcm(interleave(x), fmt))
    return rate, x.shape[1]


def raw_to_wav(raw_path: str, wav_path: str, rate: int, channels: int,
               fmt_name: str) -> int:
    fmt = parse_format(fmt_name)
    with open(raw_path, "rb") as f:
        raw = f.read()
    usable = len(raw) - len(raw) % (channels * fmt.bytes)
    x = deinterleave(pcm_to_float(raw[:usable], fmt), channels)
    write_wav(wav_path, x, rate, fmt)
    return x.shape[1]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="mode", required=True)

    w2r = sub.add_parser("wav2raw")
    w2r.add_argument("input")
    w2r.add_argument("output")
    w2r.add_argument("--format", default="s32")

    r2w = sub.add_parser("raw2wav")
    r2w.add_argument("input")
    r2w.add_argument("output")
    r2w.add_argument("--rate", type=int, required=True)
    r2w.add_argument("--channels", type=int, default=2)
    r2w.add_argument("--format", default="s32")

    args = p.parse_args(argv)
    if args.mode == "wav2raw":
        rate, frames = wav_to_raw(args.input, args.output, args.format)
        print(f"wrote {frames} frames @ {rate} Hz -> {args.output}")
    else:
        frames = raw_to_wav(args.input, args.output, args.rate,
                            args.channels, args.format)
        print(f"wrote {frames} frames @ {args.rate} Hz -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
