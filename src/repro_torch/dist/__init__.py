"""Distribution plane (the port of `repro/dist/`): named-axis sharding
rules and elastic resharding on a torch `DeviceMesh`.

The package between the model/optimizer plane and the distributed entry
points (launch/train, launch/serve):

  sharding  mesh context (`use_mesh` / `active_mesh`), logical-axis
            specs (`spec` / `constrain`), the auto param-sharding rule
            table (`_auto_spec`, `params_pspecs` / `params_shardings`),
            the cache rules (`cache_shardings`), and the DTensor
            placements every spec maps to (`placements`);
  reshard   placement of a state tree onto a mesh, and elastic
            checkpoint restore onto a different mesh shape.

Everything degrades to replication on a (1, 1) mesh, so the same
train and serve code runs from one card to a mesh of ranks.
"""

from . import reshard, sharding

__all__ = ["reshard", "sharding"]
