"""The port's tile resolution (``repro_torch.kernels.launch``) against the
JAX package's (``repro.kernels.launch``), on the CPU.

The ports of ``tests/test_kernel_launch.py``'s resolution cases (the
env override over the winner cache over the default, the sweep and its
cache), then what the port adds: its winner cache is its own file, keyed
by the device, so a JAX winner file changes no port tile; one
environment (``GESTORE_TILE_<KERNEL>``, the JAX package's variable) gives
both packages the same codec stats, saved store directories, keep-mask
counts and scan buckets; and a tile the kernel cannot launch is refused
on the card, naming the variable.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import compact_rewrite as jcompact  # noqa: E402
from repro.kernels import delta_codec as jcodec  # noqa: E402
from repro.kernels import launch as jlaunch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import delta_codec as tcodec  # noqa: E402
from repro_torch.kernels import launch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_segments import (WIDE_SCHEMA, mk_table, new_store,  # noqa: E402
                                 tree, twin_history)

CPU = "cpu"


@pytest.fixture
def tile_cache(tmp_path, monkeypatch):
    """Both packages' winner caches in files of the test's own, their
    mirrors dropped before and after, and no tile override set."""
    for k in launch.DEFAULT_TILES:
        monkeypatch.delenv(launch.ENV_PREFIX + k.upper(), raising=False)
    path = str(tmp_path / "tiles_torch.json")
    monkeypatch.setenv(launch.CACHE_ENV, path)
    monkeypatch.setenv(jlaunch.CACHE_ENV, str(tmp_path / "tiles.json"))
    launch.reset_cache()
    jlaunch.reset_cache()
    yield path
    launch.reset_cache()
    jlaunch.reset_cache()


def test_pow2_bucket():
    for n, floor in ((0, 1), (1, 1), (5, 1), (8, 1), (9, 1), (3, 8),
                     (900, 512)):
        assert (launch.pow2_bucket(n, floor=floor)
                == jlaunch.pow2_bucket(n, floor=floor))
    assert launch.pow2_bucket(900, floor=512) == 1024


def test_tile_env_override_wins(tile_cache, monkeypatch):
    launch.record_winner("batched_select", 8192, 4096, device=CPU)
    monkeypatch.setenv(launch.ENV_PREFIX + "BATCHED_SELECT", "1024")
    assert launch.tile_for("batched_select", n=5000, device=CPU) == 1024
    # malformed override falls through to the cached winner
    monkeypatch.setenv(launch.ENV_PREFIX + "BATCHED_SELECT", "zero")
    assert launch.tile_for("batched_select", n=5000, device=CPU) == 4096
    monkeypatch.delenv(launch.ENV_PREFIX + "BATCHED_SELECT")
    assert launch.tile_for("batched_select", n=5000, device=CPU) == 4096
    # other buckets still see the built-in default, the JAX package's
    assert launch.tile_for("batched_select", n=100, device=CPU) \
        == launch.DEFAULT_TILES["batched_select"]
    assert launch.DEFAULT_TILES == jlaunch.DEFAULT_TILES
    assert launch.SWEEP_CANDIDATES == jlaunch.SWEEP_CANDIDATES
    assert launch.ENV_PREFIX == jlaunch.ENV_PREFIX


def test_sweep_records_and_caches(tile_cache):
    calls = []

    def bench(tile):
        calls.append(tile)
        return 1.0 if tile != 256 else 0.5

    res = launch.sweep("shard_route", bench, n=900,
                       candidates=(256, 512, 1024), device=CPU)
    assert res["tile"] == 256 and not res["cached"]
    assert res["bucket"] == 1024
    assert sorted(calls) == [256, 512, 1024]
    # winner persisted to the env-pointed file, keyed by the device...
    with open(tile_cache) as f:
        disk = json.load(f)
    assert disk == {"shard_route/cpu/b1024": 256}
    # ...the serving path resolves it, and a repeat sweep is a cache read
    assert launch.tile_for("shard_route", n=900, device=CPU) == 256
    calls.clear()
    res2 = launch.sweep("shard_route", bench, n=1000, device=CPU)
    assert res2["cached"] and res2["tile"] == 256 and calls == []
    # force=True re-runs even with a winner on disk
    res3 = launch.sweep("shard_route", bench, n=900,
                        candidates=(256, 512), force=True, device=CPU)
    assert not res3["cached"] and calls == [256, 512]


def test_winner_cache_survives_reset(tile_cache):
    launch.record_winner("delta_codec", 2048, 1024, device=CPU)
    launch.reset_cache()  # drop the mirror: must re-read from disk
    assert launch.tile_for("delta_codec", n=1500, device=CPU) == 1024


def test_winners_are_keyed_by_the_card(tile_cache, monkeypatch):
    """A winner timed on a card is that card's: the CPU, and another
    card, resolve the default."""
    names = {0: "NVIDIA H100 80GB HBM3", 1: "NVIDIA H200"}
    monkeypatch.setattr(launch, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev: names[dev.index])
    launch.record_winner("compact_rewrite", 1 << 20, 2048, device="cuda:0")
    with open(tile_cache) as f:
        assert json.load(f) == {
            "compact_rewrite/cuda:NVIDIA H100 80GB HBM3/b1048576": 2048}
    assert launch.tile_for("compact_rewrite", n=600_000,
                           device="cuda:0") == 2048
    assert launch.tile_for("compact_rewrite", n=600_000,
                           device="cuda:1") == 512
    assert launch.tile_for("compact_rewrite", n=600_000, device=CPU) == 512


def test_a_jax_winner_file_changes_no_port_tile(tile_cache):
    """The JAX package's winners (its file, its backend's keys) are not
    the port's: the port keeps its default and writes no file."""
    jlaunch.record_winner("shard_route", 1024, 256)
    jlaunch.record_winner("compact_rewrite", 4096, 2048)
    assert jlaunch.tile_for("shard_route", n=900) == 256
    assert launch.tile_for("shard_route", n=900, device=CPU) == 512
    assert launch.tile_for("compact_rewrite", n=3000, device=CPU) == 512
    assert not os.path.exists(tile_cache)


@pytest.mark.parametrize("dtype", ["int32", "float32", "int16"])
def test_codec_stats_follow_one_tile_in_both_packages(tile_cache,
                                                      monkeypatch, dtype,
                                                      rng):
    """Under ``GESTORE_TILE_DELTA_CODEC=1024`` the codec's per-tile stats
    are the JAX kernel's (interpret), one per 1,024 rows."""
    monkeypatch.setenv("GESTORE_TILE_DELTA_CODEC", "1024")
    n, w = 3000, 4
    new = rng.integers(-500, 500, (n, w)).astype(dtype)
    old = rng.integers(-500, 500, (n, w)).astype(dtype)
    d, stat = tcodec.delta_pack(torch.as_tensor(new), torch.as_tensor(old))
    jd, jstat = jcodec.delta_pack(jnp.asarray(new), jnp.asarray(old),
                                  interpret=True)
    assert np.asarray(d.numpy()).tobytes() == np.asarray(jd).tobytes()
    assert stat.tolist() == np.asarray(jstat).tolist()
    assert len(stat) == 3
    assert tcodec.codec_plan(n, w, 4, "maxabs").n_tiles == 3


def test_saved_stores_identical_under_one_tile(tile_cache, monkeypatch,
                                               rng, tmp_path):
    """Under ``GESTORE_TILE_DELTA_CODEC=1024`` the same history saves to
    the same bytes in both packages."""
    monkeypatch.setenv("GESTORE_TILE_DELTA_CODEC", "1024")
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    j, t = twin_history(rng, jdir, tdir, n=40, releases=3)
    assert j.save(jdir) == t.save(tdir)
    assert tree(jdir) == tree(tdir)


def test_scan_bucket_and_device_bytes_follow_one_tile(tile_cache,
                                                      monkeypatch, rng):
    """Under ``GESTORE_TILE_BATCHED_SELECT=4096`` both packages floor the
    scan's buckets at 4,096 cells, so a store's device bytes agree."""
    from repro.core import store as jstore
    monkeypatch.setenv("GESTORE_TILE_BATCHED_SELECT", "4096")
    for n in (0, 1, 2048, 4097, 6_666_179):
        assert tops.scan_bucket(n) == jops.scan_bucket(n)
    assert tops.scan_bucket(100) == 4096
    keys = [f"k{i}" for i in range(30)]
    j = jstore.VersionedStore("t", [jstore.FieldSchema(*f)
                                    for f in WIDE_SCHEMA])
    t = new_store(WIDE_SCHEMA)
    for v in (10, 20):
        tab = mk_table(rng, 30, WIDE_SCHEMA)
        for s in (j, t):
            s.update(v, keys, tab)
    for s in (j, t):
        s.get_versions([10, 20])  # a batched scan: the ts go to the device
    assert t._superlog._ts_dev.numel() == 4096
    assert j.nbytes()["device"] == t.nbytes()["device"] > 4 * 4096


@pytest.mark.parametrize("tile", [128, 256, 1024])
def test_keep_mask_counts_follow_one_tile(tile_cache, monkeypatch, tile,
                                          rng):
    """Under ``GESTORE_TILE_COMPACT_REWRITE`` the keep mask's per-tile
    counts are the JAX kernel's at the same tile (cutoffs >= 0: the JAX
    launch counts a ragged tile's zero padding below 0)."""
    monkeypatch.setenv("GESTORE_TILE_COMPACT_REWRITE", str(tile))
    c = 3000
    ts = rng.integers(-100, 100, c).astype(np.int32)
    jt = jlaunch.tile_for("compact_rewrite", n=c)
    assert jt == tile
    for cutoff in (0, 57):
        keep, counts = tops.keep_mask(torch.as_tensor(ts), cutoff)
        jkeep, jcounts = jcompact._keep_mask(jnp.asarray(ts), cutoff=cutoff,
                                             interpret=True, tile=jt)
        assert np.array_equal(keep.numpy(), np.asarray(jkeep))
        assert counts.tolist() == np.asarray(jcounts).tolist()
        assert len(counts) == -(-c // tile)


class OnCard(torch.Tensor):
    """A CPU tensor that reports the CUDA card as its device: what a
    wrapper sees of a tensor on the card, on a machine without one."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        owner = getattr(getattr(func, "__self__", None), "__name__", "")
        if getattr(func, "__name__", "") == "__get__" and owner == "device":
            return torch.device("cuda", 0)
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kernel,tile", [
    ("compact_rewrite", 100), ("compact_rewrite", 8192),
    ("shard_route", 2048), ("delta_codec", 1 << 40)])
def test_a_tile_the_kernel_cannot_launch_is_refused(tile_cache, monkeypatch,
                                                    kernel, tile):
    """On the card the tile is launch geometry: one the kernel cannot
    launch raises before anything is allocated or launched, naming the
    variable (nothing clamps it); on the CPU the plain version takes it,
    as the JAX package's does. The default sweep times only launchable
    candidates, and a given one it cannot launch raises."""
    var = launch.ENV_PREFIX + kernel.upper()
    monkeypatch.setenv(var, str(tile))
    tops.keep_mask.launches = tops.shard_route.launches = 0
    if kernel == "compact_rewrite":
        ts = torch.zeros(3000, dtype=torch.int32)
        with pytest.raises(ValueError, match=var):
            tops.keep_mask(ts.as_subclass(OnCard), 0)
        assert tops.keep_mask(ts, 0)[1].tolist() == [0] * -(-3000 // tile)
    elif kernel == "shard_route":
        lanes = torch.zeros(5, 2, dtype=torch.int32)
        lens = torch.zeros(5, dtype=torch.int32)
        with pytest.raises(ValueError, match=var):
            tops.shard_route(lanes.as_subclass(OnCard),
                             lens.as_subclass(OnCard), 4)
        flat, offs = torch.zeros(8, dtype=torch.uint8), torch.zeros(
            3, dtype=torch.int64)
        with pytest.raises(ValueError, match=var):
            tops.shard_route_bytes(flat.as_subclass(OnCard),
                                   offs.as_subclass(OnCard), 4)
        assert tops.shard_route(lanes, lens, 4).shape == (5,)
        monkeypatch.delenv(var)
        res = launch.sweep(kernel, lambda t: 1.0 / t, n=606_894, device=CPU)
        assert sorted(res["walls"]) == [256, 512, 1024]
        with pytest.raises(ValueError, match=var):
            launch.sweep(kernel, lambda t: 1.0, n=606_894,
                         candidates=(512, 2048), force=True, device=CPU)
    else:
        with pytest.raises(ValueError, match=var):
            tcodec.codec_plan(1 << 20, 64, 4, "maxabs",
                              launch.tile_for(kernel))
    assert tops.keep_mask.launches == tops.shard_route.launches == 0
