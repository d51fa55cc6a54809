"""Fault tolerance: delta-compressed versioned training checkpoints and
the streaming ingest's chunk journal (``checkpoint``), and the straggler
monitor (``straggler``)."""
