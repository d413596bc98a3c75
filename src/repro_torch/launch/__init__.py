"""Entry points of the port (``python -m repro_torch.launch.serve``, ``.train``,
``.dryrun``) and the meshes, input specs and roofline model they use."""
