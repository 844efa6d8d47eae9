"""Control plane: copies of the JAX package's ``control/{server,client,
daemon,follower,wiring}.py`` (ZeroMQ REQ/REP command server, daemon,
client, follower and the engine callbacks' wiring).

Unlike the reference's, this ``__init__`` imports nothing, so importing
``control.wiring`` does not load ``zmq``: ``server`` and ``client`` import it
at their top, ``follower`` when it starts."""
