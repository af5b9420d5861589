"""The port's counterpart of ``repro.distributed`` on one card.

* ``analytic`` — the reference's analytic FLOP / HBM-byte /
  collective-byte model, a verbatim copy (it imports only the configs).
* ``roofline`` — the three-term roofline of the reference, with the
  constants of an NVIDIA H100 SXM in place of the TPU v5e's.

``sharding.py`` (whose ``shard`` is the identity without a mesh) and
``hlo_analysis.py`` (the collectives of XLA's partitioned HLO) exist only
for a device mesh and have no counterpart on one card.
"""
