"""Control plane: copies of the JAX package's ``control/{server,client,
daemon,follower,wiring}.py`` (ZeroMQ REQ/REP command server, daemon,
client, follower and the engine callbacks' wiring).

The reference's exports are here too, but imported on first access
(``_LAZY``, through a module ``__getattr__``): importing
``control.wiring`` must not load ``zmq``, which ``server`` and ``client``
import at their top and ``follower`` when it starts.
"""

import importlib

#: Exported name -> the module that defines it, imported on first access.
_LAZY = {
    "ZmqCommandServer": "totton_tpu_torch.control.server",
    "DaemonClient": "totton_tpu_torch.control.client",
    "ControlDaemon": "totton_tpu_torch.control.daemon",
    "DEFAULT_ENDPOINT": "totton_tpu_torch.control.daemon",
    "ControlFollower": "totton_tpu_torch.control.follower",
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
