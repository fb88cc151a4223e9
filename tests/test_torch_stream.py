"""The port's streaming retrieval-decode engine
(``repro_torch.serving.stream``) against ``repro.serving.stream``, on the
CPU.

The ``.reduced()`` qwen3-1.7b and mamba2-780m configs (2 layers, d_model
128, vocab 512, float32) are initialised by the reference and carried
across with ``convert.lm_params_from_reference``; the kNN-LM datastores
are built by the reference (the index of ``tests/test_stream.py``) and
carried across with ``convert.index_from_arrays``. Per request, the
port's emitted tokens equal the reference's in the LM-only, overlapped,
serialized, int8 and sampled runs; ``stats()`` has the same keys and
equal counts; the prefill's logits and hidden state agree to rtol 1e-5,
atol 1e-4 (float32 sums in another order). The tests of
``tests/test_stream.py`` are mirrored on the port, the fault storm under
the ``faults`` marker.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.common.config import PyramidConfig as RefPyramidConfig
from repro.common.registry import get_arch as ref_get_arch
from repro.models import transformer as RT
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import Tracer as RefTracer
from repro.serving import batcher as RB
from repro.serving import retrieval as RR
from repro.serving import sampler as RSa
from repro.serving import stream as RStream
from repro_torch import convert
from repro_torch.common.registry import get_arch
from repro_torch.models import transformer as TT
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving import batcher as TB
from repro_torch.serving import retrieval as TR
from repro_torch.serving import sampler as TSa
from repro_torch.serving.faults import FaultEvent, FaultSchedule
from repro_torch.serving.stream import BackpressureError, StreamEngine

CPU = dict(device="cpu")
# the index of tests/test_stream.py's datastore
PYR = dict(metric="l2", num_shards=2, meta_size=16, sample_size=100,
           branching_factor=2, max_degree=8, max_degree_upper=4,
           ef_construction=20, ef_search=30)
SESSION_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _lm(arch: str) -> dict:
    """Both packages' model and kNN-LM datastore of ``arch`` reduced."""
    rcfg = ref_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    corpus = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(8, 24)).astype(np.int32)
    ref_ds = RR.build_datastore(rparams, rcfg, [corpus],
                                RefPyramidConfig(**PYR))
    index = ref_ds.index
    arrays = lambda g: {f: getattr(g, f)  # noqa: E731
                        for f in convert.GRAPH_FIELDS}
    port_index = convert.index_from_arrays(
        dataclasses.asdict(index.config), arrays(index.meta),
        index.part_of_center, [arrays(g) for g in index.subs], **CPU)
    ds = TR.Datastore(index=port_index, values=ref_ds.values.copy())
    return dict(rcfg=rcfg, rparams=rparams, ref_ds=ref_ds, cfg=cfg,
                params=params, ds=ds)


@pytest.fixture(scope="module")
def qwen3():
    return _lm("qwen3-1.7b")


@pytest.fixture(scope="module")
def mamba2():
    return _lm("mamba2-780m")


def _prompts(cfg, n, seed=0, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size,
                         size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _run(eng, prompts, n_new=5, request=TB.Request):
    for i, p in enumerate(prompts):
        eng.submit(request(i, p, max_new_tokens=n_new))
    done = eng.run_until_drained()
    return {c.request_id: c for c in done}


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

RETRIEVAL = dict(retrieval=True, knn_k=4, lam=0.3)
RUNS = {
    "qwen3-lm": ("qwen3", {}),
    "qwen3-overlap": ("qwen3", dict(RETRIEVAL, overlap=True)),
    "qwen3-serialized": ("qwen3", dict(RETRIEVAL, overlap=False)),
    "qwen3-int8": ("qwen3", dict(RETRIEVAL, quantize=True,
                                 rerank_factor=4)),
    "qwen3-sampled": ("qwen3", dict(RETRIEVAL, seed=3, sampler=dict(
        temperature=0.7, top_k=5))),
    "mamba2-lm": ("mamba2", {}),
    "mamba2-retrieval": ("mamba2", dict(RETRIEVAL)),
}


def _serve_both(lm: dict, prompts, n_new: int, kw: dict, max_seq=32):
    """The same requests through both packages' engines; returns per
    package (tokens by request id, stats, sessions by request id)."""
    kw = dict(kw)
    retrieval = kw.pop("retrieval", False)
    sampler = kw.pop("sampler", None)
    out = {}
    for pkg in ("ref", "port"):
        ref = pkg == "ref"
        eng_kw = dict(kw, num_slots=4, max_seq=max_seq)
        if sampler is not None:
            eng_kw["sampler"] = (RSa if ref else TSa).SamplerConfig(
                **sampler)
        if retrieval:
            eng_kw["datastore"] = lm["ref_ds"] if ref else lm["ds"]
        if not ref:
            eng_kw.update(CPU)
        cls = RStream.StreamEngine if ref else StreamEngine
        request = RB.Request if ref else TB.Request
        with cls(lm["rparams"] if ref else lm["params"],
                 lm["rcfg"] if ref else lm["cfg"], **eng_kw) as eng:
            sessions = {i: eng.submit(request(i, p, max_new_tokens=n_new))
                        for i, p in enumerate(prompts)}
            done = eng.run_until_drained()
            st = eng.stats()
        out[pkg] = ({c.request_id: c.tokens for c in done}, st, sessions)
    return out["ref"], out["port"]


def _keys(tree):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


def _same_counts(st, ref_st):
    assert _keys(st) == _keys(ref_st)
    for key in ("num_slots", "slots_per_group", "overlap", "steps",
                "tokens_emitted", "sessions"):
        assert st[key] == ref_st[key], key
    for key in ("enabled", "knn_k", "lam", "lookups"):
        assert st["retrieval"][key] == ref_st["retrieval"][key], key
    np.testing.assert_equal(st["retrieval"]["knn_hit_rate"],
                            ref_st["retrieval"]["knn_hit_rate"])


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tokens_and_stats_match_reference(run, request):
    arch, kw = RUNS[run]
    lm = request.getfixturevalue(arch)
    prompts = _prompts(lm["cfg"], 5, seed=1)
    (r_tok, r_st, r_sess), (t_tok, t_st, t_sess) = _serve_both(
        lm, prompts, 6, kw)
    assert sorted(t_tok) == list(range(len(prompts)))
    assert t_tok == r_tok
    _same_counts(t_st, r_st)
    for i in r_sess:
        np.testing.assert_allclose(t_sess[i].lm_logits, r_sess[i].lm_logits,
                                   **SESSION_TOL)
        np.testing.assert_allclose(t_sess[i].hidden, r_sess[i].hidden,
                                   **SESSION_TOL)
        assert t_sess[i].lm_logits.dtype == np.float32
        assert t_sess[i].state == "done"


def test_session_running_into_max_seq_matches_reference(qwen3):
    """Prompts that leave fewer rows than ``max_new_tokens``: each session
    stops when its position reaches ``max_seq - 1``, and free slots
    decode at their last position, inside the cache."""
    cfg = qwen3["cfg"]
    max_seq = 16
    prompts = _prompts(cfg, 5, seed=4, lo=9, hi=15)
    (r_tok, r_st, _), (t_tok, t_st, _) = _serve_both(
        qwen3, prompts, 100, {}, max_seq=max_seq)
    assert t_tok == r_tok
    _same_counts(t_st, r_st)
    for i, p in enumerate(prompts):
        assert len(t_tok[i]) == max_seq - len(p)


def test_position_outside_the_cache_raises(qwen3):
    cfg, params = qwen3["cfg"], qwen3["params"]
    with StreamEngine(params, cfg, num_slots=4, max_seq=8, **CPU) as eng:
        eng.submit(TB.Request(0, np.zeros(3, np.int32), max_new_tokens=9))
        eng.generate_step()
        g = eng.groups[0]
        assert g.sessions[0] is not None and g.inflight is not None
        eng.generate_step()      # the other group: nothing to decode
        g.pos[1] = 8             # a free slot of the live group
        with pytest.raises(RuntimeError, match="outside the cache"):
            eng.generate_step()


def test_metrics_and_spans_match_reference(qwen3):
    """The ``pyramid_stream_*`` metrics carry the reference's names, kinds
    and help texts, and the traces hold the same ``stream.*`` spans; the
    owned datastore client's engine joins the stream's registry and
    tracer, and is shut down on close."""
    prompts = _prompts(qwen3["cfg"], 3, seed=2)
    found = {}
    for pkg in ("ref", "port"):
        ref = pkg == "ref"
        reg = (RefRegistry if ref else MetricsRegistry)()
        tracer = (RefTracer if ref else Tracer)()
        kw = {} if ref else CPU
        cls = RStream.StreamEngine if ref else StreamEngine
        with cls(qwen3["rparams"] if ref else qwen3["params"],
                 qwen3["rcfg"] if ref else qwen3["cfg"], num_slots=2,
                 max_seq=32, datastore=qwen3["ref_ds"] if ref else
                 qwen3["ds"], knn_k=4, registry=reg, tracer=tracer,
                 **kw) as eng:
            _run(eng, prompts, 3, RB.Request if ref else TB.Request)
            client = eng.client
            assert eng.obs is reg
        assert client._closed
        snap = reg.snapshot()
        found[pkg] = (
            {n: (m["type"], m["help"]) for n, m in snap.items()
             if n.startswith("pyramid_stream_")},
            {s.name for s in tracer.snapshot()
             if s.name.startswith("stream.")},
            any(n.startswith("pyramid_engine_") or n.startswith(
                "pyramid_query") for n in snap))
    assert found["port"] == found["ref"]
    metrics, spans, engine_joined = found["port"]
    assert len(metrics) == 12 and engine_joined
    assert spans == {"stream.prefill", "stream.generate_step",
                     "stream.gather", "stream.dispatch"}


def test_sliding_window_config_is_refused():
    """Sliding-window configs are served, not refused: gemma3's
    local-global stack (reduced, six layers: five keep 8-slot rings, one a
    full cache) through ``StreamEngine``, prompts shorter and longer than
    the window and decoding past it, completes the same greedy tokens as
    ``ContinuousBatcher``, whose tokens ``tests/test_torch_sliding.py``
    holds to the reference's. (The name is kept from when
    ``StreamEngine`` refused these configs.)"""
    cfg = dataclasses.replace(get_arch("gemma3-12b").reduced(),
                              sliding_window=8, num_layers=6)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), **CPU)
    assert set(TT.make_cache(cfg, 1, 32, **CPU)) == {"attention@swa",
                                                     "attention"}
    prompts = _prompts(cfg, 5, seed=4, lo=3, hi=14)
    b = TB.ContinuousBatcher(params, cfg, num_slots=4, max_seq=32, **CPU)
    for i, p in enumerate(prompts):
        b.submit(TB.Request(i, p, max_new_tokens=12))
    want = {c.request_id: c.tokens for c in b.run_until_drained()}
    with StreamEngine(params, cfg, num_slots=4, max_seq=32, **CPU) as eng:
        by_id = _run(eng, prompts, n_new=12)
    assert {i: c.tokens for i, c in by_id.items()} == want
    assert all(len(t) == 12 for t in want.values())


def test_needs_the_card_unless_asked(qwen3, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEngine(qwen3["params"], qwen3["cfg"], num_slots=2, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEngine(qwen3["params"], qwen3["cfg"], num_slots=2, max_seq=8,
                     datastore=qwen3["ds"])


# ---------------------------------------------------------------------------
# tests/test_stream.py, mirrored on the port
# ---------------------------------------------------------------------------


def _sequential_greedy(params, cfg, prompt, n_new, max_seq):
    """Single-sequence greedy decode through the in-forward head."""
    cache = TT.make_cache(cfg, 1, max_seq, **CPU)
    with torch.no_grad():
        for t in range(len(prompt)):
            logits, _, cache = TT.forward(
                params, cfg, torch.tensor([[int(prompt[t])]]), cache=cache,
                decode_pos=torch.tensor([t], dtype=torch.int32))
        out = [int(torch.argmax(logits[0, 0]))]
        pos = len(prompt)
        while len(out) < n_new:
            logits, _, cache = TT.forward(
                params, cfg, torch.tensor([[out[-1]]]), cache=cache,
                decode_pos=torch.tensor([pos], dtype=torch.int32))
            out.append(int(torch.argmax(logits[0, 0])))
            pos += 1
    return out


def test_stream_no_retrieval_matches_sequential(qwen3):
    cfg, params = qwen3["cfg"], qwen3["params"]
    prompts = _prompts(cfg, 4)
    with StreamEngine(params, cfg, num_slots=4, max_seq=32, **CPU) as eng:
        by_id = _run(eng, prompts, n_new=5)
    assert len(by_id) == len(prompts)
    for i, p in enumerate(prompts):
        ref = _sequential_greedy(params, cfg, p, 5, 32)
        assert by_id[i].tokens == ref, (i, by_id[i].tokens, ref)


def test_stream_matches_continuous_batcher(qwen3):
    cfg, params = qwen3["cfg"], qwen3["params"]
    prompts = _prompts(cfg, 6, seed=3)
    b = TB.ContinuousBatcher(params, cfg, num_slots=4, max_seq=32, **CPU)
    for i, p in enumerate(prompts):
        b.submit(TB.Request(i, p, max_new_tokens=5))
    ref = {c.request_id: c.tokens for c in b.run_until_drained()}
    with StreamEngine(params, cfg, num_slots=4, max_seq=32, **CPU) as eng:
        by_id = _run(eng, prompts, n_new=5)
    assert {i: c.tokens for i, c in by_id.items()} == ref


def test_stream_overlap_equals_serialized(qwen3):
    cfg, params = qwen3["cfg"], qwen3["params"]
    prompts = _prompts(cfg, 5, seed=1)
    out = {}
    for overlap in (True, False):
        with StreamEngine(params, cfg, num_slots=4, max_seq=32,
                          datastore=qwen3["ds"], knn_k=4, lam=0.3,
                          overlap=overlap, **CPU) as eng:
            by_id = _run(eng, prompts, n_new=6)
            assert len(by_id) == len(prompts)
        out[overlap] = {i: c.tokens for i, c in by_id.items()}
    assert out[True] == out[False]


def test_stream_retrieval_steers_decode(qwen3):
    cfg, params = qwen3["cfg"], qwen3["params"]
    prompts = _prompts(cfg, 3, seed=2)
    with StreamEngine(params, cfg, num_slots=2, max_seq=32, **CPU) as eng:
        lm_only = {i: c.tokens for i, c in _run(eng, prompts).items()}
    with StreamEngine(params, cfg, num_slots=2, max_seq=32,
                      datastore=qwen3["ds"], knn_k=8, lam=0.9,
                      **CPU) as eng:
        mixed = {i: c.tokens for i, c in _run(eng, prompts).items()}
        st = eng.stats()
    assert mixed != lm_only
    assert st["retrieval"]["lookups"] > 0
    assert st["retrieval"]["knn_hit_rate"] > 0.5


def test_stream_slot_recycling_exactly_once(qwen3):
    cfg, params = qwen3["cfg"], qwen3["params"]
    rng = np.random.default_rng(5)
    prompts = _prompts(cfg, 9, seed=5)
    lens = [int(rng.integers(2, 7)) for _ in prompts]
    with StreamEngine(params, cfg, num_slots=2, max_seq=32, **CPU) as eng:
        for i, p in enumerate(prompts):
            eng.submit(TB.Request(i, p, max_new_tokens=lens[i]))
        done = eng.run_until_drained()
        st = eng.stats()
    ids = [c.request_id for c in done]
    assert sorted(ids) == list(range(len(prompts)))
    assert len(set(ids)) == len(ids)
    for c in done:
        assert len(c.tokens) == lens[c.request_id]
    assert st["sessions"]["completed"] == len(prompts)
    assert st["sessions"]["active"] == 0 and st["sessions"]["queued"] == 0


def test_stream_backpressure(qwen3):
    cfg, params = qwen3["cfg"], qwen3["params"]
    prompts = _prompts(cfg, 3, seed=6)
    with StreamEngine(params, cfg, num_slots=2, max_seq=32, max_queue=2,
                      **CPU) as eng:
        eng.submit(TB.Request(0, prompts[0], max_new_tokens=2))
        eng.submit(TB.Request(1, prompts[1], max_new_tokens=2))
        with pytest.raises(BackpressureError):
            eng.submit(TB.Request(2, prompts[2], max_new_tokens=2))
        # draining frees queue capacity; the retried insert succeeds
        eng.generate_step()
        eng.submit(TB.Request(2, prompts[2], max_new_tokens=2))
        done = eng.run_until_drained()
        assert eng.stats()["sessions"]["rejected"] == 1
    assert sorted(c.request_id for c in done) == [0, 1, 2]


def test_stream_rejects_bad_inputs(qwen3):
    cfg, params = qwen3["cfg"], qwen3["params"]
    with StreamEngine(params, cfg, num_slots=2, max_seq=8, **CPU) as eng:
        with pytest.raises(ValueError, match="max_seq"):
            eng.prefill(TB.Request(0, np.zeros(8, np.int32),
                                   max_new_tokens=2))
        sess = eng.submit(TB.Request(1, np.zeros(3, np.int32),
                                     max_new_tokens=2))
        with pytest.raises(ValueError, match="queued"):
            eng.insert(sess)     # double-insert
        eng.run_until_drained()
    with pytest.raises(ValueError, match="datastore"):
        StreamEngine(params, cfg, client=object(), **CPU)
    with pytest.raises(ValueError, match="engine kwargs"):
        StreamEngine(params, cfg, quantize=True, **CPU)


def test_stream_stats_surface(qwen3):
    cfg, params = qwen3["cfg"], qwen3["params"]
    prompts = _prompts(cfg, 4, seed=8)
    with StreamEngine(params, cfg, num_slots=4, max_seq=32,
                      datastore=qwen3["ds"], knn_k=4, **CPU) as eng:
        _run(eng, prompts, n_new=4)
        st = eng.stats()
    assert st["tokens_emitted"] == 4 * len(prompts)
    assert st["tokens_per_s"] > 0
    r = st["retrieval"]
    assert r["enabled"] and r["lookups"] == st["tokens_emitted"]
    for key in ("latency_p50_s", "latency_p99_s",
                "wait_p50_s", "wait_p99_s"):
        assert np.isfinite(r[key]) and r[key] >= 0
    assert r["latency_p99_s"] >= r["latency_p50_s"]


@pytest.mark.faults
def test_stream_decode_under_fault_storm(qwen3):
    """Kill one replica mid-batch and throttle another to 0.1 CPU share
    while streaming decode runs (the reference test's schedule): every
    session completes exactly once with the fault-free run's tokens."""
    cfg, params = qwen3["cfg"], qwen3["params"]
    prompts = _prompts(cfg, 5, seed=9)
    engine_kw = dict(replicas=2, hedge=True, hedge_deadline_s=0.25,
                     auto_restart=False, executor_batch=4)

    def run(schedule):
        with StreamEngine(params, cfg, num_slots=4, max_seq=32,
                          datastore=qwen3["ds"], knn_k=4, lam=0.3,
                          fault_schedule=schedule, **CPU,
                          **engine_kw) as eng:
            by_id = _run(eng, prompts, n_new=6)
            st = eng.stats()
        return {i: c.tokens for i, c in by_id.items()}, st

    clean, _ = run(None)
    storm = FaultSchedule([
        FaultEvent(step=2, action="kill", target="exec-s0-r0",
                   when_actor="exec-s0-r0"),
        FaultEvent(step=3, action="cpu_share", target="exec-s1-r1",
                   value=0.1),
    ])
    stormy, st = run(storm)
    assert len(storm.fired) == len(storm.events)
    assert sorted(stormy) == sorted(clean)
    assert stormy == clean
    assert st["sessions"]["completed"] == len(prompts)
