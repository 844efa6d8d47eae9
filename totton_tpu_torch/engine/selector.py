"""Filter artifact selection (a copy of ``totton_tpu.engine.selector``).

Carried as a copy because importing it from the JAX package loads jax:
``totton_tpu/engine/__init__.py`` imports the JAX upsampler. The copy stays:
the JAX package is the frozen reference, so its imports will not become
lazy. ``tests/test_torch_copies.py`` holds it equal to the reference.

Behavioral parity with the reference's ResolveFilterPath
(src/alsa/alsa_filter_selector.cpp:8-108): explicit path wins; otherwise a
directory scan for filter_{44|48}k_{ratio}x_{taps}_{min|linear}_phase.json,
family chosen by input-rate divisibility, highest tap count wins, and the
legacy "2m" tap token means 640000 taps.
"""

from __future__ import annotations

import os


class FilterSelectionError(ValueError):
    pass


def _parse_taps_token(token: str) -> int:
    """Tap-count token from a filter filename; 0 if unparsable."""
    if token == "2m":  # legacy bundled name from the reference's parent project
        return 640000
    return int(token) if token.isdigit() else 0


def rate_family(input_rate: int) -> int:
    """44 or 48 by divisibility; raises on other rates."""
    if input_rate % 44100 == 0:
        return 44
    if input_rate % 48000 == 0:
        return 48
    raise FilterSelectionError(f"Unsupported input rate family: {input_rate}")


def resolve_filter_path(
    filter_path: str | None = None,
    filter_dir: str | None = None,
    phase: str = "minimum",
    ratio: int = 2,
    input_rate: int = 44100,
    latency: str = "normal",
) -> str:
    """Resolve which .json sidecar to load.

    ``latency``: "normal" picks the highest tap count (the reference
    rule — best attenuation); "low" picks the LOWEST tap count, i.e.
    the short-filter bank whose smaller block size minimizes the
    block-accumulation latency (live-monitoring use; the reference has
    no such mode and carries >= 72 ms at its only geometry).

    Raises FilterSelectionError with a message mirroring the reference's
    error strings when nothing matches.
    """
    if latency not in ("normal", "low"):
        raise FilterSelectionError(f"Unknown latency mode: {latency}")
    if filter_path:
        if not os.path.exists(filter_path):
            raise FilterSelectionError(f"Filter file not found: {filter_path}")
        return filter_path

    if not filter_dir:
        raise FilterSelectionError("No filter path or directory given")
    if not os.path.isdir(filter_dir):
        raise FilterSelectionError(f"Filter directory not found: {filter_dir}")

    family = rate_family(input_rate)

    phase_suffix = phase
    if phase_suffix in ("min", "minimum"):
        phase_suffix = "min_phase"
    elif phase_suffix == "linear":
        phase_suffix = "linear_phase"

    prefix = f"filter_{family}k_{ratio}x_"
    suffix = f"_{phase_suffix}.json"

    best_path: str | None = None
    best_taps = 0
    for name in os.listdir(filter_dir):
        full = os.path.join(filter_dir, name)
        if not os.path.isfile(full):
            continue
        if len(name) <= len(prefix) + len(suffix):
            continue
        if not (name.startswith(prefix) and name.endswith(suffix)):
            continue
        taps = _parse_taps_token(name[len(prefix) : len(name) - len(suffix)])
        if taps <= 0:
            continue
        better = (taps < best_taps) if latency == "low" else (taps > best_taps)
        if best_path is None or better:
            best_taps = taps
            best_path = full

    if best_path is None:
        raise FilterSelectionError(
            f"Filter file not found: {filter_dir}/{prefix}*{suffix}"
        )
    return best_path
