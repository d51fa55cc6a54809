"""Roofline constants of the port's card (``roofline``) and the serving
launcher (``serve``: ``python -m repro_torch.launch.serve``)."""
