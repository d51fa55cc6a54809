"""PyTorch / CUDA port of the GeStore reproduction (``repro``).

Mirrors the JAX package's module layout: ``core`` holds the versioned
store, ``kernels`` the hand-written Hopper kernels and their plain torch
versions, ``obs`` the telemetry the store calls, ``launch`` the roofline
constants of the card. Every entry point runs on the CUDA card unless the
caller passes ``device="cpu"``; nothing falls back quietly.
"""
