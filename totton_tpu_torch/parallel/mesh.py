"""Device mesh for the ('channel', 'time') layout: the counterpart of
``totton_tpu.parallel.mesh`` on torch devices.

A ``Mesh`` is a ``[n_channel, n_time]`` grid of cells, each the
``(rank, torch.device)`` that computes it: the rank of the process that
owns the cell in the ``torch.distributed`` group (0 without one) and the
device it runs on. A device may appear in several cells (for example
``[cpu] * 8`` in the tests, or ``[cuda:0, cuda:0]`` on a one-card
machine), but only where the caller passes such a list: nothing here
repeats a device on its own.
"""

from __future__ import annotations

import os

import torch


class Mesh:
    """A ``[n_channel][n_time]`` grid of ``(rank, torch.device)`` cells."""

    def __init__(self, cells: list[list[tuple[int, torch.device]]]) -> None:
        if not cells or not cells[0] or any(
                len(row) != len(cells[0]) for row in cells):
            raise ValueError("a mesh needs a non-empty rectangular grid")
        self.cells = [[(int(r), torch.device(d)) for r, d in row]
                      for row in cells]

    @property
    def shape(self) -> dict[str, int]:
        return {"channel": len(self.cells), "time": len(self.cells[0])}

    @property
    def size(self) -> int:
        return len(self.cells) * len(self.cells[0])

    def rank(self, row: int, col: int) -> int:
        return self.cells[row][col][0]

    def device(self, row: int, col: int) -> torch.device:
        return self.cells[row][col][1]

    def devices(self) -> list[torch.device]:
        """Every cell's device, row by row (repeats kept)."""
        return [d for row in self.cells for _, d in row]


def _world() -> tuple[int, int]:
    """(rank, world size) of this process's torch.distributed group, or
    (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _normalize(device) -> torch.device:
    """A torch.device with its index filled in; a CUDA device without CUDA
    raises (no CPU fallback)."""
    from totton_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(world_size: int | None = None) -> list[torch.device]:
    """This process's default mesh devices: every CUDA card it sees, or,
    under a launcher that sets ``LOCAL_RANK`` in a group of several
    processes (``world_size``, default the current group's), the one card
    ``LOCAL_RANK`` names (modulo the card count, so ranks on a one-card
    machine share it; only gloo can run them). Raises without CUDA: a CPU
    mesh is asked for with ``devices=``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device for the mesh; pass devices= explicitly "
            "(e.g. [torch.device('cpu')] * k) to run on the CPU")
    if world_size is None:
        world_size = _world()[1]
    local_rank = os.environ.get("LOCAL_RANK")
    if world_size > 1 and local_rank is not None:
        return [torch.device("cuda", int(local_rank) % n)]
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    n_channel: int | None = None,
    n_time: int | None = None,
    devices=None,
) -> Mesh:
    """Build a 2D Mesh with axes ('channel', 'time').

    ``devices`` are this process's devices (default ``local_devices()``);
    in a torch.distributed group every rank's list is gathered in rank
    order, so the grid holds every process's cells. Defaults: all channels
    on one shard, all devices along 'time'. In a group the grid is laid
    out so every process owns a contiguous (channel rows x time cols)
    rectangle, the ingest contract ``ShardedUpsampler`` checks.
    """
    local = [_normalize(d) for d in (local_devices() if devices is None
                                     else devices)]
    _, world = _world()
    if world > 1:
        import torch.distributed as dist

        gathered: list = [None] * world
        dist.all_gather_object(gathered, [str(d) for d in local])
        flat = [(r, torch.device(d)) for r in range(world)
                for d in gathered[r]]
    else:
        flat = [(0, d) for d in local]
    n = len(flat)
    if n_channel is None and n_time is None:
        n_channel, n_time = 1, n
    elif n_channel is None:
        n_channel = n // n_time
    elif n_time is None:
        n_time = n // n_channel
    need = n_channel * n_time
    if need > n or need == 0:
        raise ValueError(
            f"mesh {n_channel}x{n_time} does not cover {n} devices"
        )
    flat = flat[:need]
    if world > 1:
        # Column-major (whole time columns per process) suits
        # time-sharded streaming; row-major (whole channel rows per
        # process) covers the channel-heavy corner (n_time=1), where
        # column-major would split a time column across processes.
        grid = [[flat[t * n_channel + c] for t in range(n_time)]
                for c in range(n_channel)]
        if not _process_blocks_rectangular(grid):
            grid = [flat[c * n_time:(c + 1) * n_time]
                    for c in range(n_channel)]
            if not _process_blocks_rectangular(grid):
                raise ValueError(
                    f"no ({n_channel}x{n_time}) grid over these {need} "
                    "devices gives every process a contiguous channel x "
                    "time rectangle; choose axis sizes so each process's "
                    "device count is a multiple of n_channel or of n_time"
                )
    else:
        grid = [flat[c * n_time:(c + 1) * n_time] for c in range(n_channel)]
    return Mesh(grid)


def _process_blocks_rectangular(grid) -> bool:
    """True iff every process's cells form a full contiguous rectangle."""
    cells_by_proc: dict[int, list[tuple[int, int]]] = {}
    for r, row in enumerate(grid):
        for t, (rank, _dev) in enumerate(row):
            cells_by_proc.setdefault(rank, []).append((r, t))
    for cells in cells_by_proc.values():
        rows = sorted({c[0] for c in cells})
        cols = sorted({c[1] for c in cells})
        if rows != list(range(rows[0], rows[0] + len(rows))):
            return False
        if cols != list(range(cols[0], cols[0] + len(cols))):
            return False
        if len(cells) != len(rows) * len(cols):
            return False
    return True
