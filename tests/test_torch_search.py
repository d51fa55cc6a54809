"""The port's versioned search and data slice against the JAX package's,
on the CPU: ``repro_torch.core.search`` (``EmbeddingSearchDB``,
``SearchResult``), ``repro_torch.data`` (``ByteTokenizer``,
``TokenPipeline``, ``VersionedCorpus``), ``repro_torch.configs.metapipe``
and ``models.transformer.forward_train``.

The cases of ``tests/test_search.py`` and the data cases of
``tests/test_data_serve_workflow.py`` run through both packages, the
port's stores with ``device="cpu"``. Scores are f32 matmuls, which the
two packages may round differently in the last place: scores, each
segment's log-sum-exp and ``z`` agree within ``SCORE_RTOL``, and top-k
indices are compared at every rank whose score is apart from its
neighbours by more than that (a near tie may swap). Within the port, an
incremental query equals the full recompute exactly: indices, scores and
``z``. Token streams, batches and store views are compared exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hyp import given, settings, st  # noqa: E402  optional-hypothesis shim

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.configs import metapipe as jmetapipe  # noqa: E402
from repro.core.store import FieldSchema as JField  # noqa: E402
from repro.core.store import VersionedStore as JStore  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.data.tokenizer import ByteTokenizer as JTokenizer  # noqa: E402
from repro.data.versioned_dataset import VersionedCorpus as JCorpus  # noqa: E402,E501
from repro.models.transformer import FwdOpts as JFwdOpts  # noqa: E402
from repro.models.transformer import forward_train as jforward  # noqa: E402
from repro_torch.configs import metapipe as tmetapipe  # noqa: E402
from repro_torch.core.store import FieldSchema as TField  # noqa: E402
from repro_torch.core.store import VersionedStore as TStore  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.data.versioned_dataset import VersionedCorpus  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.models.transformer import FwdOpts, forward_train  # noqa: E402

SCORE_RTOL = 1e-5
F32_TOL = 1e-5   # hidden states: max |port - jax| over max(1, max |jax|)
# the ENCODER family at a test's size: 2 layers, narrow, the encoder's
# head dim (32: the mma_f32 flash design's) and MHA, in f32
SMALL = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=32, dtype="float32")


# -- the JAX package's search cases (tests/test_search.py) --------------------

def build_store(side, rng, n, w=16):
    store = (JStore("c", [JField("sequence", w, "int32")]) if side == "jax"
             else TStore("c", [TField("sequence", w, "int32")],
                         device="cpu"))
    store.update(100, [f"d{i}" for i in range(n)],
                 {"sequence": rng.integers(0, 20, (n, w)).astype(np.int32)})
    return store


def mutate(store, rng, t0, t1, n_mut, n_new, n_del, w=16):
    view = store.get_version(t0)
    keys = [k.decode() for k in view.keys]
    tbl = view.values["sequence"].copy()
    mut = rng.choice(len(keys), size=min(n_mut, len(keys)), replace=False)
    tbl[mut] = rng.integers(0, 20, (len(mut), w))
    drop = set(rng.choice(len(keys), size=min(n_del, len(keys) - 1),
                          replace=False).tolist()) - set(mut.tolist())
    keep = [i for i in range(len(keys)) if i not in drop]
    new_keys = [f"n{t1}_{i}" for i in range(n_new)]
    all_keys = [keys[i] for i in keep] + new_keys
    all_tbl = np.concatenate([tbl[keep],
                              rng.integers(0, 20, (n_new, w)).astype(np.int32)])
    store.update(t1, all_keys, {"sequence": all_tbl})


def encoder(rng_seed=0, w=16, d=8):
    proj = np.random.default_rng(rng_seed).normal(size=(w, d)).astype(
        np.float32)
    return lambda toks: (toks.astype(np.float32) @ proj) / 4.0


def same_exactly(a, b):
    """Two of the port's results, bit for bit."""
    assert np.array_equal(a.topk_idx, b.topk_idx)
    assert np.array_equal(a.topk_score, b.topk_score)
    assert np.array_equal(a.z, b.z)
    assert np.array_equal(a.seg_topk_idx, b.seg_topk_idx)
    assert np.array_equal(a.seg_lse, b.seg_lse)


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.allclose(got[fin], want[fin], rtol=SCORE_RTOL, atol=1e-6)


def determined(scores, k):
    """(Q, k) mask of the global top-k ranks whose score stands apart
    from its neighbours' (the next one below included, from every
    segment's top-k) by more than the score tolerance."""
    flat = -np.sort(-scores.reshape(len(scores), -1), axis=1)
    flat = np.concatenate([flat, np.full((len(flat), 1), -np.inf)], 1)
    tol = SCORE_RTOL * np.maximum(np.abs(flat), 1.0)
    gap_below = (flat[:, :k] - flat[:, 1:k + 1]) > tol[:, :k]
    gap_above = np.ones_like(gap_below)
    gap_above[:, 1:] = (flat[:, :k - 1] - flat[:, 1:k]) > tol[:, 1:k]
    return gap_below & gap_above


def agrees_with_jax(t, j):
    """The port's result against the JAX package's within the stated
    tolerance; indices at the ranks no near tie decides."""
    assert (t.k, t.ts, t.query_ids) == (j.k, j.ts, j.query_ids)
    assert t.seg_topk_idx.shape == j.seg_topk_idx.shape
    close(t.seg_lse, j.seg_lse)
    close(t.seg_topk_score, j.seg_topk_score)
    close(t.topk_score, j.topk_score)
    close(t.z, j.z)
    m = determined(j.seg_topk_score, j.k)
    assert m.any()
    assert np.array_equal(t.topk_idx[m], j.topk_idx[m])


def run_search(side, core, seed, n_mut, n_new, n_del):
    rng = np.random.default_rng(seed)
    store = build_store(side, rng, 40)
    mutate(store, rng, 100, 200, n_mut, n_new, n_del)
    enc = encoder()
    q = rng.integers(0, 20, (3, 16)).astype(np.int32)
    qids = [b"q0", b"q1", b"q2"]
    db = core.EmbeddingSearchDB(store, enc, seg_size=8)
    db.refresh(100)
    r1 = db.query(qids, q, ts=100, k=5)
    r2 = db.incremental_query(r1, qids, q, t_last=100, ts=200, k=5)
    full = core.EmbeddingSearchDB(store, enc, seg_size=8)
    full.refresh(200)
    rf = full.query(qids, q, ts=200, k=5)
    assert np.array_equal(r2.topk_idx, rf.topk_idx)
    assert np.allclose(r2.topk_score, rf.topk_score, atol=1e-5)
    assert np.allclose(r2.z, rf.z, atol=1e-4)
    return r1, r2, rf, r2.n_embedded


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10**6), st.integers(0, 6), st.integers(0, 5),
       st.integers(0, 3))
def test_incremental_equals_full(seed, n_mut, n_new, n_del):
    j = run_search("jax", jcore, seed, n_mut, n_new, n_del)
    t = run_search("torch", tcore, seed, n_mut, n_new, n_del)
    same_exactly(t[1], t[2])
    assert t[3] == j[3]
    for a, b in zip(t[:3], j[:3]):
        agrees_with_jax(a, b)


def work(side, core):
    rng = np.random.default_rng(1)
    store = build_store(side, rng, 200)
    mutate(store, rng, 100, 200, n_mut=4, n_new=2, n_del=0)
    db = core.EmbeddingSearchDB(store, encoder(), seg_size=16)
    db.refresh(100)
    assert db.n_embedded_total == 200
    r1 = db.query([b"q"], rng.integers(0, 20, (1, 16)).astype(np.int32),
                  ts=100)
    r2 = db.incremental_query(r1, [b"q"],
                              rng.integers(0, 20, (1, 16)).astype(np.int32),
                              t_last=100, ts=200)
    assert db.n_embedded_total <= 200 + 6
    return db.n_embedded_total, r2.n_embedded, r1, r2


def test_incremental_work_is_proportional():
    j, t = work("jax", jcore), work("torch", tcore)
    assert t[:2] == j[:2]
    agrees_with_jax(t[2], j[2])
    agrees_with_jax(t[3], j[3])


def evalues(side, core):
    rng = np.random.default_rng(2)
    store = build_store(side, rng, 32)
    db = core.EmbeddingSearchDB(store, encoder(), seg_size=8)
    db.refresh(100)
    q = rng.integers(0, 20, (2, 16)).astype(np.int32)
    r = db.query([b"a", b"b"], q, ts=100, k=32)
    sums = r.evalue().sum(axis=1)
    assert np.all(sums <= 1.0 + 1e-5)
    assert np.all(sums > 0.95)
    return r


def test_evalue_normalization():
    t, j = evalues("torch", tcore), evalues("jax", jcore)
    agrees_with_jax(t, j)
    close(t.evalue(), j.evalue())


# -- the Meta-pipe encoder ----------------------------------------------------

def test_metapipe_config_matches_jax():
    for name in ("ENCODER", "SMOKE", "CONFIG"):
        assert (dataclasses.asdict(getattr(tmetapipe, name))
                == dataclasses.asdict(getattr(jmetapipe, name)))
    from repro_torch.configs.base import PORTED
    assert tmetapipe.ENCODER.name not in PORTED


@pytest.fixture(scope="module")
def small_encoder():
    """The ENCODER family at ``SMALL`` in both packages' configs, and one
    JAX-layout tree of seeded weights both load."""
    jc = dataclasses.replace(jmetapipe.ENCODER, **SMALL)
    tc = dataclasses.replace(tmetapipe.ENCODER, **SMALL)
    tree = weights.random_tree(tc, np.random.default_rng(5))
    return jc, tc, tree


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_forward_train_matches_jax(small_encoder, impl):
    """Hidden states of the port's ``forward_train`` on both attention
    paths (``chunked``: the flash kernel's plain version on the CPU)
    against the JAX package's with ``attn_impl="xla"``, within 1e-5 in
    f32; the aux loss is a 0-d zero, and gradients reach the weights."""
    jc, tc, tree = small_encoder
    toks = np.random.default_rng(6).integers(0, tc.vocab, (3, 17)).astype(
        np.int32)
    jx, jaux = jforward(jax.tree_util.tree_map(jnp.asarray, tree), jc,
                        {"tokens": jnp.asarray(toks)},
                        JFwdOpts(attn_impl="xla", remat="none"))
    params = weights.from_jax_tree(tc, tree, device="cpu")
    x, aux = forward_train(params, tc, {"tokens": torch.as_tensor(toks)},
                           FwdOpts(attn_impl=impl))
    want = np.asarray(jx)
    assert x.shape == want.shape == (3, 17, tc.d_model)
    assert x.dtype == torch.float32 and float(jaux) == 0.0
    assert aux.shape == () and float(aux) == 0.0
    err = float(np.max(np.abs(x.detach().numpy() - want)))
    assert err / max(1.0, float(np.max(np.abs(want)))) < F32_TOL, err
    assert x.requires_grad is False  # weights are plain tensors
    w = params["layers"][0]["mlp"]["wi"].requires_grad_()
    forward_train(params, tc, {"tokens": torch.as_tensor(toks)},
                  FwdOpts(attn_impl=impl))[0].sum().backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())


def mean_pool_encoder(fwd, batch: int):
    """table4's encoder: hidden states mean-pooled over the sequence, in
    batches padded to ``batch`` rows (one shape, so a row's embedding
    does not depend on the rows batched with it)."""
    def enc(tokens):
        out = []
        for i in range(0, len(tokens), batch):
            chunk = tokens[i:i + batch]
            pad = batch - len(chunk)
            chunk = np.concatenate([chunk, np.zeros((pad, chunk.shape[1]),
                                                    chunk.dtype)])
            out.append(fwd(chunk)[:batch - pad])
        return (np.concatenate(out) if out else np.zeros((0, 1), np.float32))
    return enc


def table4(side, core, store, enc, q):
    qids = [f"q{i}".encode() for i in range(len(q))]
    db = core.EmbeddingSearchDB(store, enc, seg_size=8)
    db.refresh(1)
    r1 = db.query(qids, q, ts=1, k=4)
    r2 = db.incremental_query(r1, qids, q, t_last=1, ts=2, k=4)
    full = core.EmbeddingSearchDB(store, enc, seg_size=8)
    full.refresh(2)
    return r1, r2, full.query(qids, q, ts=2, k=4), r2.n_embedded


def test_search_with_the_metapipe_encoder_matches_jax(small_encoder):
    """``benchmarks/table4_application.py``'s flow at a test's size: a
    corpus, a release at 3.1% churn (rounded up), the encoder mean-pooled
    in padded batches; the port on its flash path against the JAX
    package on ``xla``."""
    jc, tc, tree = small_encoder
    n, w = 96, 12
    rng = np.random.default_rng(8)
    seqs = rng.integers(0, 25, (n, w)).astype(np.int32)
    seqs2 = seqs.copy()
    seqs2[rng.choice(n, 3, replace=False)] = rng.integers(0, 25, (3, w))
    q = rng.integers(0, 25, (3, w)).astype(np.int32)
    keys = [f"d{i}" for i in range(n)]

    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jfwd = jax.jit(lambda t: jforward(jparams, jc, {"tokens": t % jc.vocab},
                                      JFwdOpts(attn_impl="xla",
                                               remat="none"))[0].mean(1))
    jstore = JStore("c", [JField("sequence", w, "int32")])
    tparams = weights.from_jax_tree(tc, tree, device="cpu")

    @torch.inference_mode()
    def tfwd(t):
        x, _ = forward_train(tparams, tc,
                             {"tokens": torch.as_tensor(t) % tc.vocab},
                             FwdOpts(attn_impl="chunked"))
        return x.mean(1).numpy()

    tstore = TStore("c", [TField("sequence", w, "int32")], device="cpu")
    for s in (jstore, tstore):
        s.update(1, keys, {"sequence": seqs})
        s.update(2, keys, {"sequence": seqs2})
    j = table4("jax", jcore, jstore,
               mean_pool_encoder(lambda t: np.asarray(jfwd(t)), 32), q)
    t = table4("torch", tcore, tstore, mean_pool_encoder(tfwd, 32), q)
    same_exactly(t[1], t[2])
    assert t[3] == j[3] == 3
    for a, b in zip(t[:3], j[:3]):
        agrees_with_jax(a, b)


# -- data (tests/test_data_serve_workflow.py) ---------------------------------

def test_tokenizer_roundtrip():
    s = "hello GeStore — メタデータ"
    for tok in (ByteTokenizer(), JTokenizer()):
        assert tok.decode(tok.encode(s)) == s
    got, want = ByteTokenizer().encode(s), JTokenizer().encode(s)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (ByteTokenizer().decode(want), JTokenizer().decode(got)) == (s, s)


def pipeline_batches(Pipeline, Config):
    toks = np.arange(10000, dtype=np.int32)
    a = Pipeline(toks, Config(seq_len=31, global_batch=8, seed=3))
    b = Pipeline(toks, Config(seq_len=31, global_batch=8, seed=3))
    for step in (0, 5, 17):
        assert np.array_equal(a.batch_at(step)["tokens"],
                              b.batch_at(step)["tokens"])
    h0 = Pipeline(toks, Config(31, 8, seed=3, host_id=0, n_hosts=2))
    h1 = Pipeline(toks, Config(31, 8, seed=3, host_id=1, n_hosts=2))
    full = a.batch_at(2)["tokens"]
    assert np.array_equal(np.concatenate([h0.batch_at(2)["tokens"],
                                          h1.batch_at(2)["tokens"]]), full)
    ba = a.batch_at(0)
    assert np.array_equal(ba["tokens"][:, 1:], ba["labels"][:, :-1])
    it = iter(a)
    return [a.batch_at(s) for s in (0, 5, 17, 400)] + [
        h0.batch_at(2), h1.batch_at(2), next(it), next(it)]


def test_pipeline_determinism_and_host_sharding():
    got = pipeline_batches(TokenPipeline, DataConfig)
    want = pipeline_batches(JPipeline, JDataConfig)
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


def view_rec(v):
    return ([bytes(k) for k in v.keys], v.row_idx.tobytes(),
            {f: (str(a.dtype), a.tobytes()) for f, a in v.values.items()})


def corpus_run(c, reopen=None):
    docs = {f"d{i}": f"document number {i} body text" for i in range(20)}
    c.add_release(10, docs)
    n0 = c.tokens_encoded_total
    if reopen is not None:
        c.store = reopen(c.store)
    docs2 = dict(docs)
    docs2["d3"] = "changed!"
    docs2["new"] = "brand new doc"
    del docs2["d7"]
    info = c.incremental_release(10, 20, docs2)
    assert c.tokens_encoded_total - n0 == 2
    v20 = c.store.get_version(20)
    assert b"d7" not in v20.keys and b"new" in v20.keys
    v10 = c.store.get_version(10)
    assert b"d7" in v10.keys and b"new" not in v10.keys
    s20, s10 = c.token_stream(20), c.token_stream(10)
    assert len(s20) != len(s10) or not np.array_equal(s20, s10)
    return (dataclasses.asdict(info), view_rec(v10), view_rec(v20),
            s10.tobytes(), s20.tobytes(), c.tokens_encoded_total)


def test_versioned_corpus_incremental_tokenization():
    assert corpus_run(VersionedCorpus(device="cpu")) == corpus_run(JCorpus())


def test_versioned_corpus_on_a_lazily_reopened_store(tmp_path):
    """After a save and a lazy reopen the heads are stale; the corpus
    rebuilds the text head before it reads ``head_fp``, so the release
    re-tokenizes the same two documents and stores the same bytes."""
    def reopen(store):
        store.save(str(tmp_path / "corpus"))
        return TStore.load(str(tmp_path / "corpus"), lazy=True,
                           device="cpu")
    assert (corpus_run(VersionedCorpus(device="cpu"), reopen)
            == corpus_run(JCorpus()))


def test_without_a_device_the_corpus_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VersionedCorpus()
    assert VersionedCorpus(device="cpu").store.device.type == "cpu"
