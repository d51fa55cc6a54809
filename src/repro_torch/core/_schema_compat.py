"""Re-export of FieldSchema for parser modules (avoids a circular import of
the full store module at parser-definition time)."""
from .store import FieldSchema  # noqa: F401
