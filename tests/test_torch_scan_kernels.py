"""The scan kernels' wrappers (``kernels/ssm_scan.py``: Mamba's selective
scan, ``csrc/ssm_scan.cu``; ``kernels/wkv.py``: RWKV6's WKV recurrence,
``csrc/wkv.cu``) on the CPU, where they take their plain versions:

* against the JAX package's ``ssm_scan_chunked`` / ``ssm_scan_sequential``
  and ``wkv_chunked`` / ``wkv_sequential`` within ``SCAN_TOL`` (1e-5
  absolute + 1e-5 relative, elementwise: the port's log-depth composition
  of the affine maps against ``jax.lax.associative_scan``'s order, and
  the same recurrence step by step), at ragged lengths from a nonzero
  state, N 8 and 16, Dk 16, x in f32 and bf16, B and C as the strided
  views ``torch.split`` leaves;
* ``transformer.prefill`` and ``decode_step`` of jamba-smoke and
  rwkv6-smoke reach the wrappers (once a Mamba or RWKV layer), and
  ``forward_train`` the chunked torch ops instead;
* the wrappers refuse bad dtypes, shapes and devices, and on the card
  (a CPU tensor that reports the card) N or Dk outside the kernels'
  templates and a call autograd would record, and go to the kernel's
  launch, never to the plain version;
* under a mesh (a fake group of 8 ranks) the dry run's prefill and decode
  cells reach the wrappers with each rank's local tensors, and a DTensor
  handed to a wrapper raises.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build, ref as tref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssm_scan as kssm  # noqa: E402
from repro_torch.kernels import wkv as kwkv  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from test_torch_flash_new_dims import OnCard  # noqa: E402

SCAN_TOL = (1e-5, 1e-5)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def scan_close(got, want) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got.shape == want.shape and bool(np.all(
        np.abs(got - want) <= SCAN_TOL[0] + SCAN_TOL[1] * np.abs(want)))


def ssm_args(seed, b, l, n, di=24, x_dtype=torch.float32,
             strided=False):
    """(torch inputs, JAX inputs) of the selective scan from numpy: dt of
    the model's softplus range, A = -(exp(.) + 1), a nonzero h0; x in
    ``x_dtype`` (JAX gets the same bf16 values); B and C, where
    ``strided``, views of one (B, L, r + 2N) product as ``_dt_bc``'s split
    leaves them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dt = np.log1p(np.exp(rng.standard_normal((b, l, di)) - 1.0)).astype(f32)
    dbl = rng.standard_normal((b, l, 3 + 2 * n)).astype(f32)
    x = rng.standard_normal((b, l, di)).astype(f32)
    a = -(np.exp(rng.standard_normal((di, n)) * 0.3) + 1.0).astype(f32)
    h0 = (rng.standard_normal((b, di, n)) * 0.5).astype(f32)
    xt = torch.as_tensor(x).to(x_dtype)
    if strided:
        _, bt, ct = torch.split(torch.as_tensor(dbl), [3, n, n], dim=-1)
        assert not bt.is_contiguous()
    else:
        bt, ct = (torch.as_tensor(dbl[..., 3 + i * n:3 + (i + 1) * n].copy())
                  for i in (0, 1))
    tor = [torch.as_tensor(dt), bt, ct, xt, torch.as_tensor(a),
           torch.as_tensor(h0)]
    jx = jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32)
    jx_args = [jnp.asarray(dt), jnp.asarray(bt.contiguous().numpy()),
               jnp.asarray(ct.contiguous().numpy()), jx, jnp.asarray(a),
               jnp.asarray(h0)]
    return tor, jx_args


@pytest.mark.parametrize("l,n,x_dtype,strided", [
    (1, 8, torch.float32, True), (37, 16, torch.bfloat16, False),
    (129, 8, torch.bfloat16, True), (129, 16, torch.float32, True)],
    ids=["l1-n8-f32-strided", "l37-n16-bf16", "l129-n8-bf16-strided",
         "l129-n16-f32-strided"])
def test_ssm_scan_wrapper_matches_jax(l, n, x_dtype, strided):
    """The wrapper on CPU tensors: chunked against the JAX package's
    ``ssm_scan_chunked`` and, with ``chunked=False``, against its
    ``ssm_scan_sequential``, within SCAN_TOL; no launch counted."""
    tor, jx = ssm_args(l + n, 2, l, n, x_dtype=x_dtype, strided=strided)
    before = tops.ssm_scan.launches
    y, h = tops.ssm_scan(*tor)
    jy, jh = jssm.ssm_scan_chunked(*jx)
    assert y.dtype == h.dtype == torch.float32
    assert scan_close(y, jy) and scan_close(h, jh)
    y, h = tops.ssm_scan(*tor, chunked=False)
    jy, jh = jssm.ssm_scan_sequential(*jx)
    assert scan_close(y, jy) and scan_close(h, jh)
    assert tops.ssm_scan.launches == before


def wkv_args(seed, b, l, h, dk):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, l, h, dk)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(np.clip(rng.standard_normal((b, l, h, dk)), -8, 4))
    u = rng.standard_normal((h, dk)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, dk, dk)) * 0.5).astype(np.float32)
    return [r, k, v, logw.astype(np.float32), u, s0]


@pytest.mark.parametrize("l", [1, 37, 129])
def test_wkv_wrapper_matches_jax(l):
    """The wrapper on CPU tensors at Dk 16 (rwkv6-smoke's heads), from a
    nonzero state: chunked against the JAX package's ``wkv_chunked``,
    ``chunked=False`` against its ``wkv_sequential``, within SCAN_TOL."""
    args = wkv_args(200 + l, 2, l, 3, 16)
    before = tops.wkv.launches
    o, s = tops.wkv(*map(torch.as_tensor, args))
    jo, js = jrwkv.wkv_chunked(*map(jnp.asarray, args))
    assert scan_close(o, jo) and scan_close(s, js)
    o, s = tops.wkv(*map(torch.as_tensor, args), chunked=False)
    jo, js = jrwkv.wkv_sequential(*map(jnp.asarray, args))
    assert scan_close(o, jo) and scan_close(s, js)
    assert tops.wkv.launches == before


@contextlib.contextmanager
def recorded(monkeypatch):
    """Count the model modules' calls of the scan wrappers (``ssm_scan``
    and ``wkv``, with their ``chunked``) and of the chunked torch ops the
    training forward runs."""
    calls = {"ssm_scan": [], "wkv": [], "ssm_chunked": 0, "wkv_chunked": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name].append(kw.get("chunked", True))
            return fn(*a, **kw)
        return wrapped

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tssm, "ssm_scan", spy("ssm_scan", tssm.ssm_scan))
    monkeypatch.setattr(trwkv, "wkv", spy("wkv", trwkv.wkv))
    monkeypatch.setattr(tssm, "ssm_scan_chunked",
                        count("ssm_chunked", tssm.ssm_scan_chunked))
    monkeypatch.setattr(trwkv, "wkv_chunked",
                        count("wkv_chunked", trwkv.wkv_chunked))
    yield calls


@pytest.mark.parametrize("arch,wrapper", [("jamba-v0.1-52b", "ssm_scan"),
                                          ("rwkv6-7b", "wkv")])
def test_served_path_reaches_the_wrappers_and_training_does_not(
        arch, wrapper, monkeypatch):
    """prefill calls the wrapper once a scan layer with ``chunked``, each
    decode step once a layer without it; forward_train never calls it,
    and runs the chunked torch ops once a layer instead."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    n_scan = sum(m in ("mamba", "rwkv") for m, _ in ttf.layer_kinds(cfg))
    assert n_scan == (7 if wrapper == "ssm_scan" else 2)
    params = build(cfg).init(0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        3, cfg.vocab, (2, 9)))
    chunked_ops = "ssm_chunked" if wrapper == "ssm_scan" else "wkv_chunked"
    with recorded(monkeypatch) as calls:
        logits, state = ttf.prefill(params, cfg, {"tokens": tokens},
                                    pad_to=12)
        assert calls[wrapper] == [True] * n_scan
        for _ in range(2):
            tok = logits[:, 0].argmax(-1, keepdim=True)
            logits, state = ttf.decode_step(params, cfg, tok, state)
        assert calls[wrapper] == [True] * n_scan + [
            wrapper == "wkv"] * 2 * n_scan
        assert torch.isfinite(logits).all()
        n_served = calls[chunked_ops]
        calls[wrapper].clear()
        x, _ = ttf.forward_train(params, cfg, {"tokens": tokens})
        assert calls[wrapper] == []
        assert calls[chunked_ops] - n_served == n_scan
        assert torch.isfinite(x).all()


def on_card(t):
    """``t`` as a tensor that reports the card (``OnCard``)."""
    return t.as_subclass(OnCard)


class Launched(Exception):
    pass


@pytest.fixture
def stub_launch(monkeypatch):
    """The launchers as the wrappers ask for them, stopped where the
    kernel would run (outputs allocated on the CPU); the plain versions
    raise if reached."""
    asked = []

    def kernel_fn(source, symbol, argtypes):
        def launch(*args):
            asked.append((source, symbol, args))
            raise Launched
        return launch

    def plain(*a, **k):
        raise AssertionError("a card tensor reached the plain version")

    empty = torch.empty

    def cpu_empty(*a, **k):  # nothing can allocate on the card here
        k.pop("device", None)
        return empty(*a, **k)

    for mod in (kssm, kwkv):
        monkeypatch.setattr(mod._build, "kernel_fn", kernel_fn)
        monkeypatch.setattr(mod, "stream_ptr", lambda t: 0)
        monkeypatch.setattr(mod.torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(mod.torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(mod.torch, "empty", cpu_empty)
    for name in ("ssm_scan_chunked", "ssm_scan_sequential", "wkv_chunked",
                 "wkv_sequential"):
        monkeypatch.setattr(tref, name, plain)
    return asked


@pytest.mark.parametrize("n,x_dtype", [(8, torch.float32),
                                       (16, torch.bfloat16)])
def test_ssm_scan_on_the_card_goes_to_the_kernel(n, x_dtype, stub_launch):
    """A card tensor goes to ``ssm_scan_launch`` (never the plain
    version) with N, x's dtype and B's and C's own strides, in either
    ``chunked``; N outside the templates and a call with grad raise;
    nothing counts as launched."""
    tor, _ = ssm_args(3, 2, 5, n, x_dtype=x_dtype, strided=True)
    before = tops.ssm_scan.launches
    for chunked in (True, False):
        stub_launch.clear()
        with pytest.raises(Launched):
            tops.ssm_scan(*map(on_card, tor), chunked=chunked)
        ((source, symbol, args),) = stub_launch
        assert (source, symbol) == ("ssm_scan", "ssm_scan_launch")
        assert args[8:13] == (2, 5, 24, n, int(x_dtype == torch.bfloat16))
        assert args[13:17] == (tor[1].stride(0), tor[1].stride(1),
                               tor[2].stride(0), tor[2].stride(1))
        assert tor[1].stride(1) == 3 + 2 * n
    assert tops.ssm_scan.launches == before
    tor4, _ = ssm_args(3, 2, 5, 4)
    with pytest.raises(ValueError, match="N in"):
        tops.ssm_scan(*map(on_card, tor4))
    grad = [t.clone() for t in tor]
    grad[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tops.ssm_scan(*map(on_card, grad))


@pytest.mark.parametrize("dk", [16, 64])
def test_wkv_on_the_card_goes_to_the_kernel(dk, stub_launch):
    """A card tensor goes to ``wkv_launch`` with (B, L, H, Dk), never the
    plain version; Dk outside the templates (8: the mixer tests' heads)
    and a call with grad raise; nothing counts as launched."""
    args = [on_card(torch.as_tensor(a)) for a in wkv_args(4, 2, 3, 5, dk)]
    before = tops.wkv.launches
    with pytest.raises(Launched):
        tops.wkv(*args)
    ((source, symbol, largs),) = stub_launch
    assert (source, symbol) == ("wkv", "wkv_launch")
    assert largs[8:12] == (2, 3, 5, dk)
    assert tops.wkv.launches == before
    with pytest.raises(ValueError, match="Dk in"):
        tops.wkv(*[on_card(torch.as_tensor(a))
                   for a in wkv_args(4, 2, 3, 5, 8)])
    grad = [torch.as_tensor(a) for a in wkv_args(4, 2, 3, 5, dk)]
    grad[5].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tops.wkv(*map(on_card, grad))


def test_wrappers_refuse_bad_inputs():
    tor, _ = ssm_args(5, 2, 4, 8)
    dt, bm, cm, x, a, h0 = tor
    for bad, err in (
            ((dt.double(), bm, cm, x, a, h0), ValueError),          # dtype
            ((dt, bm, cm, x.half(), a, h0), ValueError),            # x dtype
            ((dt, bm[:, :3], cm, x, a, h0), ValueError),            # shape
            ((dt, bm, cm, x, a[:, :4], h0), ValueError),            # N
            ((dt[:, :0], bm[:, :0], cm[:, :0], x[:, :0], a, h0),
             ValueError),                                           # L 0
            ((dt, bm, cm, x, a, h0.to("meta")), ValueError),        # device
            ((dt.numpy(), bm, cm, x, a, h0), TypeError)):
        with pytest.raises(err):
            tops.ssm_scan(*bad)
    r, k, v, lw, u, s0 = map(torch.as_tensor, wkv_args(6, 2, 4, 3, 16))
    for bad, err in (
            ((r.double(), k, v, lw, u, s0), ValueError),
            ((r, k, v, lw.bfloat16(), u, s0), ValueError),
            ((r, k[:, :2], v, lw, u, s0), ValueError),
            ((r, k, v, lw, u[:2], s0), ValueError),
            ((r, k, v, lw, u, s0[..., :8]), ValueError),
            ((r, k, v, lw, u, s0.to("meta")), ValueError),
            ((r, k, v, lw, u.numpy(), s0), TypeError)):
        with pytest.raises(err):
            tops.wkv(*bad)


def test_kernels_are_built_and_registered():
    """Both sources are built by ``_build`` (one nvcc each) and both
    wrappers are in ``KERNELS``, so the chip smoke test's counts see
    them."""
    assert {"ssm_scan", "wkv"} <= set(_build.SOURCES)
    for name in ("ssm_scan", "wkv"):
        assert (_build.CSRC / f"{name}.cu").exists()
        assert tops.KERNELS[name] is getattr(tops, name)
    assert kssm.STATES == (8, 16) and kwkv.HEAD_DIMS == (16, 64)


_MESH = """
import json
import torch
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import rwkv, ssm
dryrun.init_fake_group(8)
mesh = make_test_mesh(device="cpu")
seen = {"ssm_scan": [], "wkv": []}
def spy(name, fn):
    def wrapped(*a, **kw):
        seen[name].append(any(isinstance(t, DTensor) for t in a))
        return fn(*a, **kw)
    return wrapped
ssm.ssm_scan = spy("ssm_scan", ssm.ssm_scan)
rwkv.wkv = spy("wkv", rwkv.wkv)
out = {}
for arch in ("jamba-v0.1-52b", "rwkv6-7b"):
    cfg = get_smoke_config(arch)
    for mode in ("prefill", "decode"):
        row = dryrun.row(cfg, ShapeConfig(mode, 64, 8, mode), mesh, "2x4")
        out[f"{arch}/{mode}"] = row["roofline"]["flops_per_device"]
refused = 0
for call, shapes in ((ops.ssm_scan, [(2, 3, 4), (2, 3, 8), (2, 3, 8),
                                     (2, 3, 4), (4, 8), (2, 4, 8)]),
                     (ops.wkv, [(2, 3, 2, 16)] * 4 + [(2, 16),
                                                      (2, 2, 16, 16)])):
    args = [DTensor.from_local(torch.zeros(s), mesh,
                               [Replicate(), Replicate()], run_check=False)
            for s in shapes]
    try:
        call(*args)
    except TypeError as e:
        refused += "DTensor" in str(e)
print(json.dumps({"flops": out, "seen": seen, "refused": refused}))
"""


def test_sharded_serving_reaches_the_wrappers_per_rank():
    """The dry run's prefill and decode cells of jamba-smoke and
    rwkv6-smoke on a fake group of 8 ranks (2 x 4): the scans reach the
    wrappers with each rank's local tensors (plain ``Tensor``s, by
    ``_ssm_sharded`` and ``_wkv_sharded``: no DTensor), once a scan layer
    a step, and each cell counts FLOPs; a DTensor handed to a wrapper
    raises."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_MESH)],
                         capture_output=True, text=True, env=env,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(v > 0 for v in got["flops"].values()) and len(
        got["flops"]) == 4
    assert len(got["seen"]["ssm_scan"]) == 2 * 7
    assert len(got["seen"]["wkv"]) == 2 * 2
    for calls in got["seen"].values():
        assert not any(calls), calls
    assert got["refused"] == 2


def test_scan_bound_splits_the_exponentials():
    """``chip_smoke.exp_bound_s``, the selective scan's compute floor: at
    Jamba-v0.1's layer its exponentials share the special-function units
    with the FMA pipe, so the floor lies between the other f32 work alone
    and every exponential on the units, where both pipes end together;
    where the other work alone outlasts the units it is the floor."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs
    exps, peak = 4096 * 8192 * 16, 67e12
    t = cs.exp_bound_s(exps, 7 * exps, peak)
    assert 7 * exps / peak < t < exps / cs.SFU_EX2_PER_S
    on_fma = exps - cs.SFU_EX2_PER_S * t
    assert 0 < on_fma < exps
    assert np.isclose((7 * exps + cs.EXP_POLY_OPS * on_fma) / peak, t,
                      rtol=1e-12)
    assert cs.exp_bound_s(1e6, 1e12, peak) == 1e12 / peak
