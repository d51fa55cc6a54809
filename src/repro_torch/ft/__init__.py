"""Fault tolerance: delta-compressed versioned training checkpoints and
the streaming ingest's chunk journal (``checkpoint``), restore onto
another mesh (``elastic``), and the straggler monitor (``straggler``)."""
