"""Entry points (``repro.launch``): ``python -m repro_torch.launch.train``.
Serving the LM (``launch/serve.py``), the dry run and the mesh helpers
(``launch/{dryrun,mesh}.py``) are later slices of the port."""
