"""Plain torch versions of the port's kernels (and host oracles).

Each ``ref_*`` is the semantic ground truth of one kernel: the wrappers
run it for tensors on the CPU, and ``chip_smoke.py`` holds each CUDA
kernel against it on the card. They repeat the kernel's arithmetic and are
no yardstick of speed. Integer wraparound is done explicitly in int64
(``_wrap32``): torch makes no promise about signed int32 overflow.
"""
from __future__ import annotations

import numpy as np
import torch

from ._compat import cdiv, round_up

# ---------------------------------------------------------------------------
# fingerprint: 2x32-bit multiplicative (FNV-style) row hashing.
# ---------------------------------------------------------------------------

FNV1_INIT = np.int32(-2128831035)  # 0x811C9DC5 as int32
FNV1_MUL = np.int32(16777619)
FNV2_INIT = np.int32(-1442509163)  # arbitrary odd second basis
FNV2_MUL = np.int32(374761393)  # prime (from xxHash)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> the same values wrapped to the int32 range (still
    int64): the two's-complement result of the int32 arithmetic."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def ref_fingerprint(lanes: torch.Tensor) -> torch.Tensor:
    """lanes: (N, W) int32 row lanes -> (N, 2) int32 fingerprints."""
    if lanes.ndim != 2 or lanes.dtype != torch.int32:
        raise ValueError(f"lanes must be (N, W) int32, got "
                         f"{tuple(lanes.shape)} {lanes.dtype}")
    n, w = lanes.shape
    x = lanes.to(torch.int64)
    h1 = torch.full((n,), int(FNV1_INIT), dtype=torch.int64,
                    device=lanes.device)
    h2 = torch.full((n,), int(FNV2_INIT), dtype=torch.int64,
                    device=lanes.device)
    for j in range(w):
        xj = x[:, j]
        h1 = _wrap32((h1 ^ xj) * int(FNV1_MUL))
        h2 = _wrap32(h2 * int(FNV2_MUL)) ^ _wrap32(xj + (j + 1))
    # final mix; >> is an arithmetic shift on the signed value
    h1 = h1 ^ _wrap32(h2 << 13)
    h2 = h2 ^ (h1 >> 7)
    return torch.stack([h1, h2], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# masked_cumsum: cumulative count of (ts <= T), the scan behind
# get_version / get_increment (segmented last-cell-<=T selection).
# ---------------------------------------------------------------------------


def ref_masked_cumsum(ts: torch.Tensor, t_query: int) -> torch.Tensor:
    """ts: (C,) int32 -> (C,) int32 inclusive cumsum of (ts <= T)."""
    return torch.cumsum((ts <= int(t_query)).to(torch.int32), dim=0,
                        dtype=torch.int32)


def ref_batched_masked_cumsum(ts: torch.Tensor,
                              t_queries: torch.Tensor) -> torch.Tensor:
    """ts: (C,); t_queries: (Q,) -> (Q, C) int32 inclusive cumsum of
    (ts <= t_q), one row per query."""
    m = ts[None, :] <= t_queries.to(ts.dtype)[:, None]
    return torch.cumsum(m.to(torch.int32), dim=1, dtype=torch.int32)


def ref_stacked_masked_cumsum(ts_stack: torch.Tensor,
                              t_queries: torch.Tensor) -> torch.Tensor:
    """ts_stack: (S, C) one padded fused-ts row per shard; t_queries: (Q,)
    -> (S, Q, C) int32 inclusive cumsum of (ts <= t_q) per (shard, query).
    Padding cells hold int32 max, above every clamped query, so they never
    count."""
    m = ts_stack[:, None, :] <= t_queries.to(ts_stack.dtype)[None, :, None]
    return torch.cumsum(m.to(torch.int32), dim=2, dtype=torch.int32)


def ref_stacked_boundary_select(ts_stack: torch.Tensor,
                                t_queries: torch.Tensor,
                                boundaries: torch.Tensor) -> torch.Tensor:
    """Entry (s, q, b) is the count of cells with ts <= t_q among the
    first ``boundaries[s, b]`` cells of shard s: the per-shard superlog
    boundary cumsums of every shard at once. boundaries: (S, B) int32 CSR
    positions in [0, C] -> (S, Q, B) int32."""
    cum = ref_stacked_masked_cumsum(ts_stack, t_queries)
    s, q, _ = cum.shape
    cum0 = torch.cat([torch.zeros((s, q, 1), dtype=torch.int32,
                                  device=cum.device), cum], dim=2)
    idx = boundaries.long()[:, None, :].expand(s, q, boundaries.shape[1])
    return torch.gather(cum0, 2, idx)


def ref_batched_version_select(log_vals, log_ts, row_ptr, t_queries):
    """Q-query segmented last-cell-with-ts<=T selection over a CSR log:
    returns (out (Q, N, W), found (Q, N))."""
    (q,) = t_queries.shape
    n = row_ptr.shape[0] - 1
    if log_ts.shape[0] == 0:
        return (torch.zeros((q, n) + tuple(log_vals.shape[1:]),
                            dtype=log_vals.dtype, device=log_vals.device),
                torch.zeros((q, n), dtype=torch.bool, device=log_vals.device))
    cum = ref_batched_masked_cumsum(log_ts, t_queries)
    cum0 = torch.cat([torch.zeros((q, 1), dtype=torch.int32,
                                  device=cum.device), cum], dim=1)
    lo = row_ptr[:-1].long()
    hi = row_ptr[1:].long()
    cnt = cum0[:, hi] - cum0[:, lo]
    found = cnt > 0
    idx = torch.clamp(lo[None, :] + cnt - 1, 0, log_ts.shape[0] - 1)
    out = torch.where(found[..., None], log_vals[idx],
                      torch.zeros((), dtype=log_vals.dtype,
                                  device=log_vals.device))
    return out, found


def ref_version_select(log_vals, log_ts, row_ptr, t_query: int):
    """Single-query form of ``ref_batched_version_select``:
    (out_vals (N, W), found (N,) bool)."""
    tq = torch.tensor([int(t_query)], dtype=torch.int32,
                      device=log_ts.device)
    out, found = ref_batched_version_select(log_vals, log_ts, row_ptr, tq)
    return out[0], found[0]


# ---------------------------------------------------------------------------
# shard_route: stable key -> shard hashing for the sharded store.
# ---------------------------------------------------------------------------

# xxHash 32-bit primes, wrapped to int32 (the same bits as the uint32
# multiplies the kernel does)
RT_MUL1 = np.int32(-1640531535)   # 0x9E3779B1
RT_MUL2 = np.int32(-2048144777)   # 0x85EBCA77
RT_MUL3 = np.int32(-1028477379)   # 0xC2B2AE3D
RT_MUL4 = np.int32(668265263)     # 0x27D4EB2F


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the 32-bit pattern of ``x`` (int64 holding an
    int32 value): torch's ``>>`` is arithmetic, so the sign bits are masked
    off first. The result lies in [0, 2**(32 - s)), a non-negative int32
    for s >= 1."""
    return (x & 0xFFFFFFFF) >> s


def ref_shard_route(lanes: torch.Tensor, lengths: torch.Tensor,
                    n_shards: int) -> torch.Tensor:
    """lanes: (N, W) int32 little-endian-packed key bytes (zero-padded);
    lengths: (N,) int32 key byte lengths -> (N,) int32 shard ids in
    [0, n_shards), routing version ``xor-rotate-fold-v1``.

    A zero lane contributes nothing to the fold, so a key routes the same
    at any padded width; the length in the final mix tells keys whose real
    bytes end in zeros apart. Wraparound multiplies go through
    ``_wrap32`` on int64 values (each product stays below 2**62)."""
    if lanes.ndim != 2 or lanes.dtype != torch.int32:
        raise ValueError(f"lanes must be (N, W) int32, got "
                         f"{tuple(lanes.shape)} {lanes.dtype}")
    n, w = lanes.shape
    x = lanes.to(torch.int64)
    h = torch.zeros(n, dtype=torch.int64, device=lanes.device)
    for j in range(w):
        t = _wrap32(x[:, j] * int(RT_MUL1))
        t = t ^ _lsr(t, 15)
        t = _wrap32(t * int(RT_MUL2))
        r = (j % 31) + 1  # position-dependent rotate, never by 0 or 32
        h = h ^ (_wrap32((t & 0xFFFFFFFF) << r) | _lsr(t, 32 - r))
    h = h ^ _wrap32(lengths.to(torch.int64) * int(RT_MUL3))
    h = h ^ _lsr(h, 16)
    h = _wrap32(h * int(RT_MUL4))
    h = h ^ _lsr(h, 13)
    return ((h & 0x7FFFFFFF) % int(n_shards)).to(torch.int32)


def ref_shard_route_bytes(flat: torch.Tensor, offsets: torch.Tensor,
                          n_shards: int) -> torch.Tensor:
    """flat: (B,) uint8, every key's bytes end to end; offsets: (N + 1,)
    int64, key i = flat[offsets[i]:offsets[i + 1]] -> (N,) int32 shard ids,
    ``ref_shard_route`` of the keys' zero-padded little-endian lanes (the
    batch's widest key sets W). The lanes are built by indexing, with no
    loop over keys: byte b of key i is flat[offsets[i] + b] where b < its
    length, else a zero byte appended to ``flat``."""
    start = offsets[:-1]
    lens = offsets[1:] - start
    n = lens.shape[0]
    w = max((int(lens.max()) + 3) // 4, 1) if n else 1
    pos = torch.arange(4 * w, device=flat.device)
    padded = torch.cat([flat, flat.new_zeros(1)]).to(torch.int64)
    idx = torch.where(pos[None, :] < lens[:, None],
                      start[:, None] + pos[None, :], flat.shape[0])
    b = padded[idx].view(n, w, 4)
    lanes = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return ref_shard_route(_wrap32(lanes).to(torch.int32),
                           lens.to(torch.int32), n_shards)


# ---------------------------------------------------------------------------
# keep mask: the compaction horizon mask plus survivor counts per tile.
# ---------------------------------------------------------------------------


def ref_keep_mask(ts: torch.Tensor, cutoff: int,
                  tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ts: (C,) int32 -> (keep (C,) int32 = ts > cutoff, counts
    (ceil(C / tile),) int32 survivors per tile)."""
    keep = (ts > int(cutoff)).to(torch.int32)
    (c,) = ts.shape
    padded = torch.cat([keep, keep.new_zeros(round_up(c, tile) - c)])
    return keep, padded.view(cdiv(c, tile), tile).sum(dim=1,
                                                      dtype=torch.int32)


# ---------------------------------------------------------------------------
# chain decode: host oracle of the segmented scan over chain deltas.
# ---------------------------------------------------------------------------


def ref_chain_decode(deltas: np.ndarray, heads: np.ndarray, *,
                     xor: bool = False) -> np.ndarray:
    """Host oracle for the device chain decode: sequential prefix op
    within each head-delimited chain (int path widened to int32 like the
    device scan; the caller truncates to the stored dtype)."""
    out = (deltas.copy() if xor
           else deltas.astype(np.int32))
    with np.errstate(over="ignore"):
        for i in range(1, len(out)):
            if not heads[i]:
                out[i] = (out[i] ^ out[i - 1]) if xor else out[i] + out[i - 1]
    return out


# ---------------------------------------------------------------------------
# delta codec: elementwise version-chain delta packing (sub for ints,
# XOR of the bits for floats, so unchanged mantissa bytes zero out).
# ---------------------------------------------------------------------------

_LANES = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _wrap_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 tensor of exact results -> their low ``bits`` bits as the
    signed int of that width (two's-complement wraparound)."""
    sign = 1 << (bits - 1)
    return (((x + sign) & ((1 << bits) - 1)) - sign).to(
        _LANES[bits // 8])


def _add64(a: torch.Tensor, b: torch.Tensor, sign: int) -> torch.Tensor:
    """a + sign * b modulo 2**64 on int64 tensors, on (lo, hi) 32-bit
    halves so no int64 operation overflows (the borrow or carry moves from
    lo into hi; ``hi * 2**32 + lo`` stays inside the int64 range)."""
    lo = (a & 0xFFFFFFFF) + sign * (b & 0xFFFFFFFF)  # in (-2**32, 2**33)
    hi = (a >> 32) + sign * (b >> 32) + (lo >> 32)   # arithmetic shifts
    return _wrap32(hi) * 2**32 + (lo & 0xFFFFFFFF)


def int_lanes(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as the signed int of its item size (bits unchanged)."""
    return x.view(_LANES[x.element_size()])


def ref_codec(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """a op b (op "sub", "add" or "xor") on the int lanes of a and b, in
    wraparound arithmetic of their width; the result has a's dtype."""
    x, y = int_lanes(a), int_lanes(b)
    if op == "xor":
        out = x ^ y
    elif x.dtype == torch.int64:
        out = _add64(x, y, -1 if op == "sub" else 1)
    else:
        wide = (x.to(torch.int64) - y.to(torch.int64) if op == "sub"
                else x.to(torch.int64) + y.to(torch.int64))
        out = _wrap_bits(wide, 8 * x.element_size())
    return out.view(a.dtype)


def ref_delta_pack(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """new - old (wraparound) for ints, XOR of the bits for floats."""
    return ref_codec(new, old, "xor" if new.is_floating_point() else "sub")


def ref_delta_unpack(delta: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """delta + old (wraparound) for ints, XOR of the bits for floats."""
    return ref_codec(delta, old, "xor" if delta.is_floating_point() else "add")


def ref_delta_pack64(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """The 8-byte pack: exact 64-bit modular subtract for int64, XOR of
    the bits for float64."""
    return ref_delta_pack(new, old)


def ref_delta_unpack64(delta: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """The 8-byte unpack: 64-bit modular add, or XOR for float64."""
    return ref_delta_unpack(delta, old)


def ref_tile_stat(delta: torch.Tensor, tile: int, kind: str, *,
                  unsigned: bool = False) -> torch.Tensor:
    """The codec's per-tile stat over (N, W) ``delta``, one int32 per tile
    of ``tile`` rows, the ragged last tile padded with zero rows.

    kind "maxabs": max over the tile of |d| with d widened to int32
    (zero-extended when ``unsigned``; |INT32_MIN| wraps to INT32_MIN);
    "nonzero": the count of nonzero lanes; "none": 0."""
    n = delta.shape[0]
    n_tiles = cdiv(n, tile)
    if kind == "none" or n_tiles == 0:
        return torch.zeros(n_tiles, dtype=torch.int32, device=delta.device)
    d = int_lanes(delta.reshape(n, -1)).to(torch.int64)
    if kind == "nonzero":
        v = (d != 0).to(torch.int64)
    else:
        bits = 8 * delta.element_size()
        if unsigned and bits < 32:
            d = d & ((1 << bits) - 1)
        v = _wrap32(d.abs())
    pad = round_up(n, tile) - n
    v = torch.cat([v, v.new_zeros((pad, v.shape[1]))])
    v = v.reshape(n_tiles, -1)
    if kind == "nonzero":
        return v.sum(dim=1).to(torch.int32)
    return v.amax(dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# masked_merge: fused (row-mask & field-mask) select + EXISTS/ts stamping.
# ---------------------------------------------------------------------------


def ref_masked_merge(base: torch.Tensor, upd: torch.Tensor,
                     row_mask: torch.Tensor, field_mask: torch.Tensor,
                     ts_base: torch.Tensor, ts_new: int):
    """base/upd: (N, W) of one dtype; row_mask: (N,) bool; field_mask:
    (W,) bool; ts_base: (N,) int32 or int64; ts_new: int -> (merged (N, W),
    ts_out (N,) of ts_base's dtype). The select runs on the values' bits,
    so float NaN payloads and signed zeros come through unchanged."""
    sel = row_mask[:, None] & field_mask[None, :]
    merged = torch.where(sel, int_lanes(upd), int_lanes(base))
    ts_out = torch.where(row_mask, torch.tensor(ts_new, dtype=ts_base.dtype,
                                                device=ts_base.device),
                         ts_base)
    return merged.view(base.dtype), ts_out


# ---------------------------------------------------------------------------
# flash attention (causal, GQA): the oracle is plain softmax attention.
# ---------------------------------------------------------------------------

NEG = -1e30


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float | None = None
                  ) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D) with H % K == 0, f32 math over
    the full (Sq, Sk) logits (f64 for f64 inputs: the backward's check
    differentiates it in f64). Queries are the last Sq positions of the key
    axis; a query that sees no key gives NaN (softmax over nothing)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    ct = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(ct) * (scale if scale is not None else d ** -0.5)
    qf = qf.reshape(b, sq, kh, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(ct))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(qpos >= kpos), float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(ct))
    return out.reshape(b, sq, h, d).to(q.dtype)


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, bq: int = 128, bk: int = 128,
                        return_lse: bool = False):
    """The flash kernel's plain version: q (B, Sq, H, D), k/v (B, Sk, K, D)
    -> (B, Sq, H, D) in q's dtype, causal with the queries aligned to the
    end of the key axis; with ``return_lse``, also each query row's
    log-sum-exp m + log(max(l, 1e-30)) of its scaled logits, (B, H, Sq)
    f32 (-1e30 for a row that sees no key), what the backward recomputes
    P from.

    An online softmax over ``bk``-key tiles for each ``bq``-row query tile,
    with f32 m, l and acc, q scaled by D^-0.5 before the product, masked
    logits at -1e30 and p = 0 where masked, the tiles past the diagonal
    skipped (the causal trip count), and acc / max(l, 1e-30): a query that
    sees no key gives 0, as the Pallas kernel does. It never holds more than
    (bq, bk) logits per head, so it runs at 32k tokens where the full
    logits of ``ref_attention`` would not fit."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    offset = sk - sq
    qf = (q.float() * d ** -0.5).reshape(b, sq, kh, g, d).permute(0, 2, 3, 1,
                                                                  4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]   # (B, K, 1, Sk, D)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, kh, g, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, bq):
        q1 = min(q0 + bq, sq)
        qt = qf[:, :, :, q0:q1]                      # (B, K, G, n, D)
        qpos = torch.arange(q0, q1, device=q.device) + offset
        m = torch.full(qt.shape[:-1], NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
        n_tiles = min(max(cdiv(offset + q1, bk), 0), cdiv(sk, bk))
        for t in range(n_tiles):
            k0, k1 = t * bk, min((t + 1) * bk, sk)
            logits = qt @ kf[:, :, :, k0:k1].transpose(-1, -2)
            kpos = torch.arange(k0, k1, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            logits = torch.where(mask, logits, NEG)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vf[:, :, :, k0:k1]
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(b, q1 - q0, h,
                                                         d).to(q.dtype)
        lse[..., q0:q1] = m + torch.log(torch.clamp(l, min=1e-30))
    if return_lse:
        return out, lse.reshape(b, h, sq)
    return out


def ref_flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The backward's row term: delta = rowsum(dO * o) in f32, o and dO
    (B, Sq, H, D) -> (B, H, Sq), the delta kernel's plain version."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def ref_flash_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            delta: torch.Tensor | None = None,
                            bq: int = 64, bk: int = 64):
    """The flash backward's plain version: (dq, dk, dv) in q's dtype from
    q (B, Sq, H, D), k/v (B, Sk, K, D), the forward's output o and
    log-sum-exp lse (B, H, Sq), and the output's gradient do (B, Sq, H,
    D); causal with the queries at the end of the key axis.

    The kernels' tiled recurrence (``csrc/flash_attention_bwd.cu``) in
    torch ops, in f32: for each ``bk``-key tile, the ``bq``-row query
    tiles from the first that sees one of its keys, P = exp(q k^T D^-0.5
    - lse) with 0 where masked, dP = dO v^T, dS = P (dP - delta) with
    delta = rowsum(dO o); dV += P^T dO and dK += dS^T q D^-0.5 summed over
    the query heads of each KV head, dQ += dS k D^-0.5. Masked pairs, and
    rows that see no key, add exactly 0. ``delta`` (B, H, Sq), where
    given, stands for rowsum(dO o), and o is not read."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    offset = sk - sq
    scale = d ** -0.5
    dev = q.device
    if delta is None:
        delta = ref_flash_bwd_delta(o, do)
    delta = delta.reshape(b, kh, g, sq)
    lse = lse.float().reshape(b, kh, g, sq)

    def heads(t):   # (B, S, H, D) -> (B, K, G, S, D) f32
        return t.float().reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)

    qs, dof = heads(q) * scale, heads(do)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]   # (B, K, 1, Sk, D)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    dq = torch.zeros(qs.shape, dtype=torch.float32, device=dev)
    dk = torch.zeros((b, kh, sk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, bk):
        k1 = min(k0 + bk, sk)
        kpos = torch.arange(k0, k1, device=dev)
        for q0 in range(max(k0 - offset, 0) // bq * bq, sq, bq):
            q1 = min(q0 + bq, sq)
            qpos = torch.arange(q0, q1, device=dev) + offset
            mask = qpos[:, None] >= kpos[None, :]
            s = qs[..., q0:q1, :] @ kf[..., k0:k1, :].transpose(-1, -2)
            p = torch.where(mask, torch.exp(s - lse[..., q0:q1, None]), 0.0)
            dp = dof[..., q0:q1, :] @ vf[..., k0:k1, :].transpose(-1, -2)
            ds = p * (dp - delta[..., q0:q1, None])
            dv[:, :, k0:k1] += (p.transpose(-1, -2) @ dof[..., q0:q1, :]).sum(2)
            dk[:, :, k0:k1] += (ds.transpose(-1, -2) @ qs[..., q0:q1, :]).sum(2)
            dq[..., q0:q1, :] += ds @ kf[..., k0:k1, :]
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# ---------------------------------------------------------------------------
# Mamba's selective scan and RWKV6's WKV recurrence (models/ssm.py,
# models/rwkv.py). The chunked forms are the prefill's plain versions, the
# sequential ones the decode step's; the training forward runs the chunked
# forms directly, so autograd differentiates them.
# ---------------------------------------------------------------------------

SSM_CHUNK = 128
WKV_CHUNK = 32


def affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix composition along dim 1 of the maps h -> a_t h +
    b_t (a broadcast against b's trailing dims): (A_t, B_t) with h_t =
    A_t h_0 + B_t. Log-depth: at step i each position composes its map
    with the one 2^i before it (the later map applied last)."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_hi = a[:, off:]
        b = torch.cat([b[:, :off], _times(a_hi, b[:, :-off]) + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a_hi * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _times(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a times b, a's dims a leading prefix of b's."""
    while a.ndim < b.ndim:
        a = a[..., None]
    return a * b


def ssm_scan_chunked(dt, bmat, cmat, x1, a, h0, *, chunk: int = SSM_CHUNK):
    """dt: (B, L, di); bmat/cmat: (B, L, N); x1: (B, L, di); a: (di, N);
    h0: (B, di, N). Returns (y (B, L, di) f32, h_final (B, di, N) f32)."""
    l = dt.shape[1]
    chunk = min(chunk, l)
    h = h0.float()
    ys = []
    for c0 in range(0, l, chunk):
        dtc = dt[:, c0:c0 + chunk]                       # (B, c, di)
        bc, cc = bmat[:, c0:c0 + chunk], cmat[:, c0:c0 + chunk]
        xc = x1[:, c0:c0 + chunk].float()
        la = dtc[..., None] * a                          # log decay <= 0
        binp = dtc[..., None] * bc[:, :, None, :] * xc[..., None]
        aa, bb = affine_scan(torch.exp(la), binp)
        h_t = aa * h[:, None] + bb                       # (B, c, di, N)
        ys.append(torch.einsum("bcn,bcdn->bcd", cc, h_t))
        h = h_t[:, -1]
    return torch.cat(ys, dim=1), h


def ssm_scan_sequential(dt, bmat, cmat, x1, a, h0):
    """The plain per-token recurrence (the decode step, and the tests'
    reference). In f32, or in f64 where ``dt`` is f64 (the card's
    reference of the kernel over a long prompt)."""
    acc = torch.float64 if dt.dtype == torch.float64 else torch.float32
    h = h0.to(acc)
    ys = []
    for t in range(dt.shape[1]):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * a)
        h = da * h + dtt[..., None] * bmat[:, t, None, :] \
            * x1[:, t].to(acc)[..., None]
        ys.append(torch.einsum("bn,bdn->bd", cmat[:, t], h))
    return torch.stack(ys, dim=1), h


def wkv_sequential(r, k, v, logw, u, s0):
    """The plain recurrence. r/k/v/logw: (B, L, H, Dk); u: (H, Dk); s0:
    (B, H, Dk, Dv)."""
    s = s0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,Dk,Dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 s + u[..., None] * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv_chunked(r, k, v, logw, u, s0, *, chunk: int = WKV_CHUNK):
    """The WKV recurrence a chunk at a time: within a chunk the state
    maps compose by ``affine_scan``, the decay applied before the add."""
    l = r.shape[1]
    chunk = min(chunk, l)
    s = s0
    outs = []
    for c0 in range(0, l, chunk):
        rc, kc, vc = (t[:, c0:c0 + chunk] for t in (r, k, v))
        w = torch.exp(logw[:, c0:c0 + chunk])                 # (B, c, H, Dk)
        kv = kc[..., :, None] * vc[..., None, :]              # (B,c,H,Dk,Dv)
        aa, bb = affine_scan(w, kv)
        s_t = aa[..., None] * s[:, None] + bb                 # S after t
        s_prev = torch.cat([s[:, None], s_t[:, :-1]], dim=1)
        outs.append(torch.einsum("bchk,bchkv->bchv", rc,
                                 s_prev + u[..., None] * kv))
        s = s_t[:, -1]
    return torch.cat(outs, dim=1), s
