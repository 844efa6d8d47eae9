"""The benchmark of ``totton_tpu_torch``'s serve plane, measured from the
client's side.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once: an in-process
``StreamServer`` on the card, clients in generator processes over loopback
TCP, a timed window, an untimed drain, and a float64 reference that judges
what the clients received. Everything that belongs to one configuration,
traffic mix or metric is a file of its own, found by its name:

- ``configs/<name>.json``: the server's flags and the filter bank;
- ``traffic/<name>.json``: the parameters ``loadgen.py`` reads;
- ``metrics/<name>.py``: a ``read(ctx)`` that returns the metric's value,
  or None where the run has nothing to read.

Nothing here imports ``jax``, ``jaxlib`` or ``totton_tpu``; the reference
(``reference.py``) imports nothing of ``totton_tpu_torch`` either.
"""
