"""Entry points (``repro.launch``): ``python -m repro_torch.launch.train``
and ``python -m repro_torch.launch.serve``.  The dry run and the mesh
helpers (``launch/{dryrun,mesh}.py``) are later slices of the port."""
