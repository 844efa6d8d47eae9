"""Process-group initialization: the counterpart of
``totton_tpu.parallel.distributed`` on ``torch.distributed``.

The JAX package wires N hosts into one global device mesh with
``jax.distributed``; here N processes join one ``torch.distributed``
group, and the sharded engine moves its halos between them with
point-to-point sends (``parallel/sharded.py``).
"""

from __future__ import annotations

import os
import socket


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join a torch.distributed process group from the arguments or
    torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).

    No-op when no coordinator address is given or set, or when the group
    already exists. ``backend`` defaults to ``nccl`` where CUDA is present
    and ``gloo`` elsewhere. NCCL cannot run two ranks on one card: when
    the NCCL ranks share a card this raises, naming ``backend="gloo"``;
    it never switches backend on its own.
    """
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    host, port = coordinator_address.rsplit(":", 1)
    # The group's store is made here so that the NCCL ranks can compare
    # their cards through it before NCCL itself starts. Under a launcher
    # that hosts the store itself, every rank connects as a client.
    agent_store = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0 and not agent_store)
    if backend == "nccl":
        _refuse_shared_cards(store, num_processes, process_id)
        # NCCL's communicator works on the current card: this rank's.
        from totton_tpu_torch.parallel.mesh import local_devices

        torch.cuda.set_device(local_devices(num_processes)[0])
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)


def _refuse_shared_cards(store, num_processes: int, process_id: int) -> None:
    """Raise when two NCCL ranks would drive one card (same host, same
    card UUID)."""
    import torch

    from totton_tpu_torch.parallel.mesh import local_devices

    cards = sorted({str(torch.cuda.get_device_properties(d).uuid)
                    for d in local_devices(num_processes)})
    mine = f"{socket.gethostname()}|{','.join(cards)}"
    store.set(f"totton/cards/{process_id}", mine)
    seen: dict[str, int] = {}
    for r in range(num_processes):
        host, uuids = store.get(f"totton/cards/{r}").decode().split("|")
        for uuid in uuids.split(","):
            other = seen.setdefault(f"{host}|{uuid}", r)
            if other != r:
                raise RuntimeError(
                    f"ranks {other} and {r} share CUDA card {uuid} on "
                    f"{host}; NCCL cannot run two ranks on one card: "
                    'pass backend="gloo" (--backend gloo)')
