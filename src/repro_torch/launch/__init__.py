"""Entry points of the port, the counterparts of ``repro.launch``:

* ``serve`` — governed static-batching generation
  (``python -m repro_torch.launch.serve``);
* ``train`` — governed training (``python -m repro_torch.launch.train``).

Both run on the card unless ``--device cpu`` is given, and raise without
CUDA. The reference's ``launch/mesh.py`` builds a TPU device mesh and has
no counterpart on one card. ``launch/bus_server.py`` and
``launch/procs.py`` (the networked log and its processes) and
``launch/dryrun.py`` (the compile on 512 fake devices) are not ported.
"""
