"""Entry points (``repro.launch``): ``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve`` and ``python -m
repro_torch.launch.dryrun``, and the production meshes
(``launch/mesh.py``)."""
