"""Roofline constants of the port's card (``roofline``), the functions
that make the train, prefill and serve steps (``steps``), and the
launchers: serving (``serve``: ``python -m
repro_torch.launch.serve``) and training (``train``: ``python -m
repro_torch.launch.train``)."""
