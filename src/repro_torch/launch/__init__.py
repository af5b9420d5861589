"""Entry points of the port, the counterparts of ``repro.launch``:

* ``serve`` — governed static-batching generation
  (``python -m repro_torch.launch.serve``);
* ``train`` — governed training (``python -m repro_torch.launch.train``);
* ``dryrun`` — every (arch x shape) cell traced on the meta device at full
  size and costed on the H100's roofline
  (``python -m repro_torch.launch.dryrun --all``);
* ``bus_server`` — the network shared log's server, which fronts a memory,
  SQLite or KV log for ``NetBus`` clients (``python -m
  repro_torch.launch.bus_server --backend sqlite --path bus.db --port 0
  --port-file bus.port``);
* ``procs`` — the components (driver, standby driver, voters, executor) as
  OS processes of their own whose only channel is a ``NetBus`` to one bus
  server (``python -m repro_torch.launch.procs --role driver --address
  127.0.0.1:PORT --spec '{...}'``), and the helpers that spawn them and the
  server as children (``BusServerProcess``, ``spawn_component``,
  ``sigkill``).

``serve`` and ``train`` run on the card unless ``--device cpu`` is given,
and raise without CUDA; ``dryrun`` allocates no tensor of a cell and needs
no card, and ``bus_server`` and ``procs`` run no model. The reference's
``launch/mesh.py`` builds a TPU device mesh and has no counterpart on one
card.
"""
