"""Training: optimizers (``optimizer``), schedules (``schedule``), int8
error-feedback gradient compression (``grad_compress``), the trainer
(``train_loop``) and its tree helpers (``tree``)."""
