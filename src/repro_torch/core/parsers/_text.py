"""Fixed-width text <-> numeric row helpers shared by the format parsers."""
from __future__ import annotations

import numpy as np


def pad_bytes(s: str | bytes, width: int) -> np.ndarray:
    """Encode text into a fixed-width int8 row (zero padded, truncated)."""
    b = s.encode() if isinstance(s, str) else bytes(s)
    out = np.zeros(width, np.int8)
    b = b[:width]
    out[: len(b)] = np.frombuffer(b, np.uint8).astype(np.int8)
    return out


def unpad_bytes(row: np.ndarray) -> bytes:
    b = row.astype(np.uint8).tobytes()
    return b.rstrip(b"\x00")


def f32_row(*vals: float) -> np.ndarray:
    return np.asarray(vals, np.float32)


def i32_row(*vals: int) -> np.ndarray:
    return np.asarray(vals, np.int32)
