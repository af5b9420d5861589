"""Entry points of the port, the counterparts of ``repro.launch``:

* ``serve`` — governed static-batching generation
  (``python -m repro_torch.launch.serve``);
* ``train`` — governed training (``python -m repro_torch.launch.train``);
* ``dryrun`` — every (arch x shape) cell traced on the meta device at full
  size and costed on the H100's roofline
  (``python -m repro_torch.launch.dryrun --all``).

``serve`` and ``train`` run on the card unless ``--device cpu`` is given,
and raise without CUDA; ``dryrun`` allocates no tensor of a cell and needs
no card. The reference's ``launch/mesh.py`` builds a TPU device mesh and
has no counterpart on one card. ``launch/bus_server.py`` and
``launch/procs.py`` (the networked log and its processes) are not ported.
"""
