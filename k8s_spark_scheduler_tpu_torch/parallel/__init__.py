"""Sharding the solver's node axis over a ``torch.distributed`` process
group: the mesh (``mesh.py``), the node-axis reductions the programs run
through (``axis.py``) and a launcher of local worlds (``launch.py``)."""
