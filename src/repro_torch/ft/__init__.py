"""Fault tolerance: the streaming ingest's chunk journal (``checkpoint``)."""
