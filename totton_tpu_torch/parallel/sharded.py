"""Sharded overlap-save upsampling: channels x time spans over a Mesh, the
counterpart of ``totton_tpu.parallel.sharded`` on torch devices and
``torch.distributed``.

One step over an input x[C, T]:

  - cell (c, t) of the mesh computes channel rows c over time span t on
    its own device, with the port's block step (``make_block_step``): on
    a CUDA cell the frames go through the fused frame kernel, on a CPU
    cell through its plain version;
  - its halo is the last halo_in input samples of span t-1. Inside one
    process that is a slice of the input the process already holds,
    moved to the cell's device. At a process boundary it comes from the
    left neighbour's process by a point-to-point send per mesh row (the
    counterpart of the JAX step's ``ppermute``);
  - time column 0 takes the carried stream tail (zeros at the start): the
    last halo_in samples of the previous step, which the process owning
    the last column sends round to the one owning column 0 when they
    differ;
  - no other communication; each process drains its own cells' output.

On a 1x1 mesh the step is one cell: ``make_block_step`` on the tail and
the whole input, bit-identical to ``engine.StreamingUpsampler``.

The filter is folded once per distinct device per swap (``fold_bundle``)
and passed to the step, so a filter RELOAD or EQ hot swap rebuilds no
step.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import torch

from totton_tpu_torch.engine.upsampler import (
    _fade_prefix,
    download,
    fade_warm_widths,
    fetch,
    upload,
)
from totton_tpu_torch.filters.sidecar import LoadedFilter
from totton_tpu_torch.io.pcm import PcmFormat
from totton_tpu_torch.ops import device_pcm as _dp
from totton_tpu_torch.ops.overlap_save import (
    OverlapSaveConfig,
    fold_bundles,
    make_block_step,
)
from totton_tpu_torch.parallel.mesh import Mesh, _world

#: Default lead time (in engine steps) a scheduled hot swap gives the
#: control fan-out: the leader stamps apply_at_step = current + margin so
#: every process (whose PUB subscription delivers in ~ms while a live
#: step spans >= 72 ms of audio) schedules the same bundle for the same
#: step boundary. A process that still misses the deadline applies the
#: swap at its next step, counts swap_deadline_misses, and logs: bounded
#: divergence, never a deadlock (the fade path is collective-free).
SWAP_MARGIN_STEPS = 8


def _exchange(x: np.ndarray, mesh: Mesh, rows: list[int], cols: list[int],
              cpr: int, halo: int, step_index: int,
              global_t: int) -> dict[int, torch.Tensor]:
    """Send this process's last halo_in input samples of each of its mesh
    rows to the process owning the next time column (round to column 0),
    and receive the same from the process owning the previous one.
    Returns {mesh row: received [cpr, halo]} for the rows whose previous
    column another process owns: the halo of this process's first column,
    or, where that column is 0, the stream tail for the next step.

    Each message goes with the sender's (step_index, global_t); a
    mismatch raises, because the ranks' dispatches have diverged. On gloo
    the halo travels as a CPU tensor (gloo moves host memory only); on
    NCCL it travels on the cells' cards.
    """
    import torch.distributed as dist

    me = _world()[0]
    n_time = mesh.shape["time"]
    gloo = dist.get_backend() == "gloo"
    cpu = torch.device("cpu")
    meta = torch.tensor([step_index, global_t], dtype=torch.int64)
    ops, received, checks = [], {}, []
    for i, r in enumerate(rows):
        dst = mesh.rank(r, (cols[-1] + 1) % n_time)
        src = mesh.rank(r, (cols[0] - 1) % n_time)
        if dst != me:
            dev = cpu if gloo else mesh.device(r, cols[-1])
            send = torch.from_numpy(np.ascontiguousarray(
                x[i * cpr:(i + 1) * cpr, x.shape[1] - halo:])).to(dev)
            ops += [dist.P2POp(dist.isend, meta.to(dev), dst, tag=2 * r),
                    dist.P2POp(dist.isend, send, dst, tag=2 * r + 1)]
        if src != me:
            dev = cpu if gloo else mesh.device(r, cols[0])
            got = torch.empty(2, dtype=torch.int64, device=dev)
            buf = torch.empty((cpr, halo), dtype=torch.float32, device=dev)
            ops += [dist.P2POp(dist.irecv, got, src, tag=2 * r),
                    dist.P2POp(dist.irecv, buf, src, tag=2 * r + 1)]
            received[r] = buf
            checks.append((r, src, got))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for r, src, got in checks:
        theirs = got.tolist()
        if theirs != [step_index, global_t]:
            raise RuntimeError(
                f"rank {src} sent mesh row {r}'s halo for step {theirs[0]} "
                f"({theirs[1]} frames); rank {me} is at step {step_index} "
                f"({global_t} frames): the ranks' dispatches diverged")
    return received


def make_sharded_step(cfg: OverlapSaveConfig, mesh: Mesh):
    """Sharded streaming step for a fixed geometry and mesh.

    Returns step(tails, x, bundles, step_index=0) -> (y, new_tails) where
      x:       numpy [local_channels, T_local] float32, this process's
               block (the whole [C, T] input in one process), T_local a
               whole number of its time spans;
      tails:   {mesh row: [C/n_channel, halo_in] tensor on the device of
               the row's time-column-0 cell}, for the rows whose column 0
               this process owns;
      bundles: {device: FoldedBundle} (``fold_bundle`` on each device);
      y:       [[cell output [C/n_channel, span * ratio] on the cell's
               device for each local column] for each local row];
      new_tails: as tails, the stream's last halo_in samples.
    ``step_index`` rides with the halos sent between processes.
    """
    rows, cols = ShardedUpsampler._resolve_local_block(mesh)
    n_time = mesh.shape["time"]
    halo = cfg.halo_in
    block = make_block_step(cfg)
    multi = _world()[1] > 1

    def step(tails, x, bundles, step_index: int = 0):
        cpr = x.shape[0] // len(rows)
        span = x.shape[1] // len(cols)
        received = (_exchange(x, mesh, rows, cols, cpr, halo, step_index,
                              span * n_time)
                    if multi and halo else {})

        def from_left(r, dev):
            # What the previous column's process sent (nothing to send
            # for a filter without history).
            if not halo:
                return torch.zeros((cpr, 0), dtype=torch.float32, device=dev)
            return received[r].to(dev)

        y, new_tails = [], {}
        for i, r in enumerate(rows):
            xr = x[i * cpr:(i + 1) * cpr]
            y_row = []
            for j, t in enumerate(cols):
                dev = mesh.device(r, t)
                a = j * span
                if j > 0:
                    # The halo is the previous span's end: one upload.
                    xin = upload(np.ascontiguousarray(
                        xr[:, a - halo:a + span]), dev)
                    h, xc = xin[:, :halo], xin[:, halo:]
                else:
                    h = tails[r] if t == 0 else from_left(r, dev)
                    xc = upload(np.ascontiguousarray(xr[:, a:a + span]), dev)
                yc, tail = block(h, xc, bundles[dev])
                y_row.append(yc)
                if t == n_time - 1 and cols[0] == 0:
                    new_tails[r] = tail.to(mesh.device(r, 0))
            if cols[0] == 0 and cols[-1] != n_time - 1:
                new_tails[r] = from_left(r, mesh.device(r, 0))
            y.append(y_row)
        return y, new_tails

    return step


def _check_shapes(cfg: OverlapSaveConfig, mesh: Mesh, channels: int, t: int):
    n_ch = mesh.shape["channel"]
    n_t = mesh.shape["time"]
    if channels % n_ch != 0:
        raise ValueError(
            f"channels ({channels}) not divisible by mesh channel axis ({n_ch})"
        )
    shard_t = t // n_t
    if t % n_t != 0 or shard_t % cfg.block_in != 0 or shard_t == 0:
        raise ValueError(
            f"input length {t} must split into {n_t} time shards of whole "
            f"blocks (block_in={cfg.block_in})"
        )
    if cfg.halo_in > shard_t:
        raise ValueError(
            f"per-shard input ({shard_t}) shorter than the halo "
            f"({cfg.halo_in}); enlarge the per-step input or shrink the mesh"
        )


def sharded_upsample(
    x: np.ndarray,
    filt: LoadedFilter,
    mesh: Mesh,
    eq_response: np.ndarray | None = None,
) -> np.ndarray:
    """One-shot sharded upsample of [C, T] (T a multiple of
    block_in * n_time) in one process. Returns [C, T * ratio]."""
    cfg = OverlapSaveConfig.from_sidecar(filt.sidecar)
    x = np.asarray(x, dtype=np.float32)
    _check_shapes(cfg, mesh, x.shape[0], x.shape[1])
    eng = ShardedUpsampler(filt, mesh, channels=x.shape[0],
                           eq_response=eq_response)
    return eng.process_block(x)


def _cat(parts: list[np.ndarray], axis: int) -> np.ndarray:
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)


def _download_cells(y: list[list[torch.Tensor]]):
    """Queue every cell's output into its place in one host tensor
    [local rows * cpr, local cols * width] (pinned, non-blocking, one
    event per CUDA device after its copies) and return the
    (host tensor, events) handle for ``_local_output``. A cell covering
    whole rows is one copy; the cells of a time span copy row by row,
    each into a contiguous stretch of its channel's row, so the spans
    are never concatenated on the host."""
    cpr, width = y[0][0].shape
    cuda = sorted({yc.device.index for row in y for yc in row
                   if yc.device.type == "cuda"})
    host = torch.empty((len(y) * cpr, len(y[0]) * width),
                       dtype=y[0][0].dtype, pin_memory=bool(cuda))
    for i, row in enumerate(y):
        for j, yc in enumerate(row):
            nb = yc.device.type == "cuda"
            if len(row) == 1:
                host[i * cpr:(i + 1) * cpr].copy_(yc, non_blocking=nb)
                continue
            for k in range(cpr):
                host[i * cpr + k, j * width:(j + 1) * width].copy_(
                    yc[k], non_blocking=nb)
    events = []
    for index in cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(index))
        events.append(event)
    return host, events


class ShardedUpsampler:
    """Streaming facade over the sharded step (multi-device analog of
    engine.StreamingUpsampler)."""

    def __init__(
        self,
        filt: LoadedFilter,
        mesh: Mesh,
        channels: int = 2,
        eq_response: np.ndarray | None = None,
        swap_fade_frames: int = 0,
        device_pcm: PcmFormat | None = None,
    ) -> None:
        if swap_fade_frames < 0:
            raise ValueError(
                f"swap_fade_frames must be >= 0: {swap_fade_frames}")
        if device_pcm is not None and device_pcm is not PcmFormat.S16_LE:
            raise ValueError(
                f"device_pcm supports S16_LE only, got {device_pcm}")
        # Device-PCM mode quantizes each cell's output on its device, so
        # every process's drain moves int16. Undithered only: dither
        # noise drawn per cell would depend on the layout, and the
        # sharded output must equal the plain engine's; dithering stays
        # with the sink on sharded deployments.
        self.device_pcm = device_pcm
        # Click-free hot swap, StreamingUpsampler's contract: fade the
        # first swap_fade_frames output samples after a swap from old to
        # new, the ramp position carried across steps (_fade_pos). The
        # old-bundle output of the fade window comes from a LOCAL plain
        # block step (_fade_step) on the process owning time column 0,
        # never from the sharded step, so a fade sends nothing between
        # processes and costs about one block.
        self._swap_fade_frames = swap_fade_frames
        self._fade_from = None
        self._fade_pos = 0
        self._fade_total = None
        # Step-synchronized hot swap: every process takes part in every
        # step, so step_index advances in lockstep, and a swap scheduled
        # for the same apply_at_step lands at the same output sample
        # everywhere.
        self.step_index = 0
        self._pending_swap: tuple | None = None
        self.swap_deadline_misses = 0
        self.config = OverlapSaveConfig.from_sidecar(filt.sidecar)
        self.mesh = mesh
        self._filter = filt
        self._channels = channels
        if any(d.type == "cuda" for d in mesh.devices()) \
                and self.config.overlap % 2 == 0:
            from totton_tpu_torch.ops.fused_frames import kernel_plan

            kernel_plan(self.config)  # raises on what the kernel cannot run
        self._bundles = self._fold(filt, eq_response)
        self._step = make_sharded_step(self.config, mesh)
        n_time = mesh.shape["time"]
        #: fresh input samples required per process_block call
        self.step_input_frames = self.config.block_in * n_time
        # Per-shard input must cover the halo; this multiplier makes
        # block_input_frames a safe dispatch granule for stream sessions.
        mult = 1
        while (mult * self.config.block_in) < self.config.halo_in:
            mult *= 2
        #: safe dispatch granule (multiple of step_input_frames whose
        #: per-shard length covers the halo)
        self.block_input_frames = self.step_input_frames * mult
        self._local_channel_rows, self._local_time_cols = (
            self._resolve_local_block(mesh))
        if channels % mesh.shape["channel"] != 0:
            raise ValueError(
                f"channels ({channels}) not divisible by mesh channel "
                f"axis ({mesh.shape['channel']})"
            )
        self._rows_per_cell = channels // mesh.shape["channel"]
        #: audio channels THIS process feeds/drains (= all of them in a
        #: single process; its channel rows' share in a group)
        self.local_channels = (
            self._rows_per_cell * len(self._local_channel_rows))
        self._lock = threading.Lock()
        #: does this process hold global time column 0 (the fade window)?
        self._owns_col0 = self._local_time_cols[0] == 0
        self._tails = self._zero_tails()
        # The fade's plain block step, warmed on every power-of-two prefix
        # width a fade can dispatch, so a live fade never builds or
        # allocates mid-stream.
        self._fade_step = None
        if swap_fade_frames > 0 and self._owns_col0:
            self._fade_step = make_block_step(self.config)
            for r, tail in self._tails.items():
                dev = mesh.device(r, 0)
                for nb in fade_warm_widths(swap_fade_frames,
                                           self.config.block_size):
                    z = torch.zeros((self._rows_per_cell,
                                     nb * self.config.block_in),
                                    dtype=torch.float32, device=dev)
                    fetch(download(
                        self._fade_step(tail, z, self._bundles[dev])[0]))

    def _zero_tails(self) -> dict[int, torch.Tensor]:
        if not self._owns_col0:
            return {}
        return {r: torch.zeros((self._rows_per_cell, self.config.halo_in),
                               dtype=torch.float32,
                               device=self.mesh.device(r, 0))
                for r in self._local_channel_rows}

    def _fold(self, filt: LoadedFilter, eq_response: np.ndarray | None):
        return fold_bundles(filt.taps, self.config, eq_response,
                            self.mesh.devices())

    @classmethod
    def local_channel_count(cls, mesh: Mesh, channels: int) -> int:
        """Channels THIS process will feed/drain for a global channel
        count on this mesh: the pre-construction helper for callers that
        must size their IO endpoints before building the engine (the CLI
        opens sources first). Validates the same contracts the
        constructor enforces."""
        if channels % mesh.shape["channel"] != 0:
            raise ValueError(
                f"channels ({channels}) not divisible by mesh channel "
                f"axis ({mesh.shape['channel']})"
            )
        rows, _cols = cls._resolve_local_block(mesh)
        local = channels // mesh.shape["channel"] * len(rows)
        if local == 0:
            raise ValueError(
                f"process {_world()[0]} owns no channel rows for "
                f"channels={channels} on mesh {mesh.shape}"
            )
        return local

    @staticmethod
    def _resolve_local_block(mesh: Mesh) -> tuple[list[int], list[int]]:
        """(channel rows, time cols) of the mesh owned by THIS process.

        The per-process ingest contract: each process's cells form a
        contiguous (channel rows x time cols) rectangle, so every process
        feeds exactly the channel/time block its own devices compute.
        make_mesh lays process groups out this way.
        """
        me, world = _world()
        if world == 1:
            return (list(range(mesh.shape["channel"])),
                    list(range(mesh.shape["time"])))
        cells = [
            (r, t)
            for r in range(mesh.shape["channel"])
            for t in range(mesh.shape["time"])
            if mesh.rank(r, t) == me
        ]
        rows = sorted({c[0] for c in cells})
        cols = sorted({c[1] for c in cells})
        rect = (
            rows == list(range(rows[0], rows[0] + len(rows)))
            and cols == list(range(cols[0], cols[0] + len(cols)))
            and len(cells) == len(rows) * len(cols)
        ) if cells else False
        if not rect:
            raise ValueError(
                "multi-process ingest needs each process's devices to form "
                f"a contiguous channel x time rectangle; process {me} owns "
                f"cells {cells} (build the mesh with parallel.make_mesh)"
            )
        return rows, cols

    @property
    def ratio(self) -> int:
        return self.config.ratio

    @property
    def channels(self) -> int:
        return self._channels

    @property
    def local_block_input_frames(self) -> int:
        """This process's share of one dispatch granule: the input frames a
        stream session must feed process_block per call. Equals
        block_input_frames in one process; in a group it is the granule's
        slice over this process's time columns."""
        n_time = self.mesh.shape["time"]
        return (self.block_input_frames // n_time
                * len(self._local_time_cols))

    def reset(self) -> None:
        with self._lock:
            self._tails = self._zero_tails()
            self._fade_from = None
            self._fade_pos = 0
            self._fade_total = None

    def _note_swap(self, old_bundles) -> None:
        """Arm the crossfade (keep the ORIGINAL pre-swap bundles if several
        swaps land between two steps).

        IMMEDIATE swaps in a process group stay fade-less: each process's
        control thread applies them at an uncoordinated step, so the fade
        window would start at different output samples per process. Use
        schedule_swap (step-synchronized, published with apply_at_step)
        for click-free swaps across processes.
        """
        if _world()[1] > 1:
            return
        if self._swap_fade_frames and self._fade_from is None:
            self._fade_from = old_bundles
            self._fade_pos = 0

    def schedule_swap(
        self,
        filt: LoadedFilter | None = None,
        eq_response: np.ndarray | None = None,
        apply_at_step: int | None = None,
        margin_steps: int = SWAP_MARGIN_STEPS,
    ) -> int:
        """Queue a filter/EQ swap to land at an exact step boundary.

        The LEADER calls this without apply_at_step (stamping
        current + margin_steps) and publishes the returned step with the
        control event; FOLLOWERS call it with the published value, so the
        swap lands at the SAME output sample on every process, with the
        crossfade (when configured) armed at that boundary everywhere.

        A newer scheduled swap replaces a still-pending one. If the
        deadline has already passed when the swap is applied, it applies
        at the next boundary instead, counted in swap_deadline_misses and
        logged.

        Returns the step index the swap will apply at.
        """
        lf = filt or self._filter
        cfg = OverlapSaveConfig.from_sidecar(lf.sidecar)
        if cfg != self.config:
            raise ValueError(
                "sharded engine filter swap requires identical "
                f"overlap-save geometry (have {self.config}, new {cfg})"
            )
        bundles = self._fold(lf, eq_response)
        with self._lock:
            if apply_at_step is None:
                apply_at_step = self.step_index + margin_steps
            self._pending_swap = (apply_at_step, filt, bundles)
        return apply_at_step

    def _apply_pending_swap_locked(self) -> None:
        """Apply a due scheduled swap at this step boundary (lock held)."""
        if self._pending_swap is None:
            return
        apply_at, filt, bundles = self._pending_swap
        if self.step_index < apply_at:
            return
        self._pending_swap = None
        if self.step_index > apply_at:
            self.swap_deadline_misses += 1
            print(
                f"sharded engine: scheduled swap missed its step deadline "
                f"(apply_at={apply_at}, now={self.step_index}) — applied "
                f"late; divergence window of "
                f"{self.step_index - apply_at} step(s)", file=sys.stderr)
        if filt is not None:
            self._filter = filt
        # Deterministic boundary -> the fade is safe on every process
        # (bypass _note_swap's immediate-swap gate).
        if self._swap_fade_frames and self._fade_from is None:
            self._fade_from = self._bundles
            self._fade_pos = 0
        self._bundles = bundles

    def set_eq(self, eq_response: np.ndarray | None) -> None:
        bundles = self._fold(self._filter, eq_response)
        with self._lock:
            self._note_swap(self._bundles)
            self._bundles = bundles

    def set_dither(self, enabled: bool) -> bool:
        """Sharded device-PCM is undithered by design (see __init__ note);
        the live dither toggle has nothing to switch here."""
        return False

    def load_filter(
        self, filt: LoadedFilter, eq_response: np.ndarray | None = None
    ) -> None:
        """Swap filters (same-geometry swaps rebuild nothing)."""
        cfg = OverlapSaveConfig.from_sidecar(filt.sidecar)
        # Validate BEFORE touching any state: a rejected swap must leave
        # filter/bundles/config consistent (a later set_eq folds from
        # self._filter.taps).
        if cfg != self.config:
            raise ValueError(
                "sharded engine filter swap requires identical "
                f"overlap-save geometry (have {self.config}, new {cfg})"
            )
        bundles = self._fold(filt, eq_response)
        with self._lock:
            self._filter = filt
            self._note_swap(self._bundles)
            self._bundles = bundles

    def _local_output(self, handle) -> np.ndarray:
        """This process's contiguous span of the output (each local row's
        cells side by side, the rows stacked), once its copies are done:
        waits on the copies' events only, never on the whole device."""
        host, events = handle
        for event in events:
            event.synchronize()
        return host.numpy()

    def dispatch_block(self, x: np.ndarray):
        """Submit one step of input; returns an opaque handle for fetch().

        In one process x is the global [C, T] block; in a group it is this
        process's local block [local_channels, T_local] (its channel rows
        over its time span). The step's cells queue on their devices and
        their downloads into pinned memory are queued behind events; in a
        group the halo exchange with the neighbouring processes completes
        before the cells that need it are queued. The lock orders tail
        updates and hot swaps against dispatch; fades are bookkept here
        (dispatch order = output order).
        """
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[0] != self.local_channels:
            raise ValueError(
                f"expected [local_channels={self.local_channels}, n], "
                f"got {x.shape}"
            )
        n_time = self.mesh.shape["time"]
        n_local = len(self._local_time_cols)
        if x.shape[1] % n_local != 0:
            raise ValueError(
                f"local input length {x.shape[1]} must split across "
                f"{n_local} local time shards"
            )
        global_t = x.shape[1] // n_local * n_time
        if global_t % self.step_input_frames != 0 or global_t == 0:
            raise ValueError(
                f"global input length {global_t} must be a positive multiple "
                f"of step_input_frames {self.step_input_frames}"
            )
        _check_shapes(self.config, self.mesh, self._channels, global_t)
        cfg = self.config
        with self._lock:
            self._apply_pending_swap_locked()
            tails_before = self._tails
            y, self._tails = self._step(tails_before, x, self._bundles,
                                        self.step_index)
            self.step_index += 1
            fade = None
            if self._fade_from is not None:
                # Fade window = the first n LOCAL output samples of the
                # post-swap step(s), which live in global time column 0.
                # The old-bundle output of that window comes from the
                # local plain block step on the tail and this process's
                # input prefix (usually one block). The position
                # bookkeeping runs identically on every process (local
                # output spans are equal), so the fade state machines stay
                # in lockstep; only the column-0 owner computes and mixes.
                local_out = x.shape[1] * cfg.ratio
                if self._fade_total is None:
                    self._fade_total = self._swap_fade_frames
                    if _world()[1] > 1 and n_time > 1:
                        # Time-sharded across processes: samples beyond
                        # this process's span belong to ANOTHER process's
                        # columns, which hold no old output; the ramp
                        # completes at the span boundary.
                        self._fade_total = min(self._fade_total, local_out)
                total = self._fade_total
                n = min(total - self._fade_pos, local_out)
                y_old = None
                if self._owns_col0 and self._fade_step is not None:
                    y_old = []
                    for i, r in enumerate(self._local_channel_rows):
                        dev = self.mesh.device(r, 0)
                        rows = x[i * self._rows_per_cell:
                                 (i + 1) * self._rows_per_cell]
                        pref = _fade_prefix(torch.from_numpy(rows), n,
                                            cfg.block_size, cfg.block_in)
                        y_old.append(download(self._fade_step(
                            tails_before[r],
                            upload(pref.contiguous().numpy(), dev),
                            self._fade_from[dev])[0]))
                ramp = (self._fade_pos
                        + np.arange(n, dtype=np.float32)) / total
                fade = (y_old, ramp, n)
                self._fade_pos += n
                if self._fade_pos >= total:
                    self._fade_from = None
                    self._fade_pos = 0
                    self._fade_total = None
            if self.device_pcm is not None and fade is None:
                # Fade steps mix old/new on the host in float and
                # quantize in fetch().
                y = [[_dp.quantize_s16(yc) for yc in row] for row in y]
            return _download_cells(y), fade

    def fetch(self, handle) -> np.ndarray:
        """Wait for a dispatched step's LOCAL output (its events only).
        Fetch in dispatch order (fade ramps are stateful in that order)."""
        cells, fade = handle
        out = self._local_output(cells)
        if fade is not None and fade[0] is not None:
            # The fade window starts at global output position 0 of the
            # first step after the swap; only the process owning time
            # column 0 holds that span and computed the old output.
            y_old, ramp, n = fade
            old = _cat([fetch(h) for h in y_old], axis=0)
            out = np.array(out)
            out[:, :n] = old[:, :n] * (1.0 - ramp) + out[:, :n] * ramp
        if self.device_pcm is not None and fade is not None:
            from totton_tpu_torch.io.pcm import quantize_s16_host

            out = quantize_s16_host(out)
        return out

    def process_block(self, x: np.ndarray) -> np.ndarray:
        """Upsample one step of input synchronously (dispatch + fetch).

        In one process x is the global [C, T] block, returns [C, T*ratio].
        In a group x is this process's local block [local_channels,
        T_local], returns the matching [local_channels, T_local*ratio].
        """
        return self.fetch(self.dispatch_block(x))
