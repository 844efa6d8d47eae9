"""The comparison that decides ``correct``.

It judges what the clients received, stream by stream, against the float64
reference (``reference.py``):

- ``lost_streams``: streams that failed to connect, were cut, or whose
  reply did not end by the drain limit (limit 0);
- ``length_gap``: frames by which the replies' lengths differ from ratio x
  the frames sent, plus any trailing partial frame (limit 0): every
  answer came, the EOF flush included;
- ``blocks_lost`` (paced traffic): blocks due in the window whose output
  never arrived (limit 0); a late block is late, not lost;
- on seeded segments of every stream (its first frames, segments spread
  over it from the seed, and its last frames, the flush's): ``max_rel``,
  the largest |reply - reference| over the largest |reference|, for the
  float32 wire; or ``max_lsb``, the largest gap in s16 steps between the
  reply and the reference quantized as the wire quantizes, for the s16
  wire. Their limits are the configuration's (``check``).
"""

from __future__ import annotations

import numpy as np

from portbench.reference import Reference, quantize_s16


def segment_items(streams: list[dict]) -> tuple[list, list]:
    """([(seed, first frame, frames)], [received [n, C] arrays]) of every
    segment kept, the tail last, for streams that ended cleanly."""
    items, got = [], []
    for s in streams:
        if s["error"] is not None or not s["done"]:
            continue
        for a, arr in sorted(s["segments"].items()):
            items.append((s["seed"], int(a), len(arr)))
            got.append(arr)
        a, arr = s["tail"]
        if len(arr):
            items.append((s["seed"], int(a), len(arr)))
            got.append(arr)
    return items, got


def sample_number(fmt: str, got: list[np.ndarray],
                  want: list[np.ndarray]) -> float:
    """``max_rel`` (f32) or ``max_lsb`` (s16) of received against
    reference segments."""
    if not got:
        return 1e308  # nothing came to compare: fails any limit
    if fmt == "s16":
        return float(max(np.abs(g.astype(np.int64) - quantize_s16(w)).max()
                         for g, w in zip(got, want)))
    diff = max(float(np.abs(g.astype(np.float64) - w).max())
               for g, w in zip(got, want))
    scale = max(float(np.abs(w).max()) for w in want)
    return diff / scale


def judge(streams: list[dict], ref: Reference, limits: dict,
          paced: bool, candidate: Reference | None = None
          ) -> tuple[dict, int]:
    """({check name: {"value", "limit"}}, segments compared).
    ``candidate`` puts another
    computation (the control) in the program's place on the same
    segments."""
    ratio = ref.ratio
    lost = sum(1 for s in streams if s["error"] is not None or not s["done"])
    gap = sum(abs(s["recv_frames"] - ratio * s["sent_frames"])
              + (s["recv_tail_bytes"] > 0) for s in streams)
    checks = {"lost_streams": {"value": lost, "limit": 0},
              "length_gap": {"value": gap, "limit": 0}}
    if paced:
        missing = sum(int(np.isinf(s["block_lat_s"]).sum()) for s in streams)
        checks["blocks_lost"] = {"value": missing, "limit": 0}
    items, got = segment_items(streams)
    want = ref.segments(items)
    if candidate is not None:
        got = candidate.segments(items)
        if ref.fmt == "s16":
            got = [quantize_s16(g) for g in got]
    name = "max_lsb" if ref.fmt == "s16" else "max_rel"
    checks[name] = {"value": sample_number(ref.fmt, got, want),
                    "limit": limits[name]}
    return checks, len(items)


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
