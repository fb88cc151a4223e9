"""The port's multi-device path against the JAX package, on the CPU over
gloo: ``make_pyramid_search_fn`` (the SPMD search), ``kmeans_distributed``,
the device mesh, the sharding rules, and the per-worker dataset reads.

Ranks are processes started with ``torch.multiprocessing`` (spawn); they
meet through a ``FileStore`` in the test's temporary directory, never a
TCP port. The rank functions live at the top of this module, and JAX and
``repro`` are imported only by the parent's helpers, so a rank loads
neither.

Tolerances: SPMD ids equal to the reference's ``make_pyramid_search_fn``
on a one-device ``model`` mesh, scores to rtol 1e-5 and atol 1e-5, at
model-world sizes 1, 2 and 4 and on a (2, 2) data x model mesh (each data
half held to the reference at that half's batch); k-means centres within
1e-4 of the reference's ``kmeans_distributed`` on a (1, 1) mesh (the
reference's own tolerance against its ``kmeans``), counts equal.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch import convert
from repro_torch.common import sharding as TS
from repro_torch.core import distributed as TD
from repro_torch.core import kmeans as TK
from repro_torch.data import vectors as TV
from repro_torch.launch import mesh as TM

N, D, K, B = 600, 16, 10, 24
CFG = dict(metric="l2", num_shards=4, meta_size=40, sample_size=400,
           branching_factor=2, max_degree=8, max_degree_upper=4,
           ef_construction=32, ef_search=32, kmeans_iters=6, seed=0)
INDEX_CFGS = {"l2": {}, "ip": dict(metric="ip", replication_r=20)}
# each case: the index it searches, make_pyramid_search_fn's options, and
# a change of the config; "drops" cuts C to ceil(B * K / w * 0.5) = 6 of
# loads near B * K / w = 12, so routed pairs are dropped
CASES = {
    "l2": ("l2", {}, {}),
    "ip": ("ip", {}, {}),
    "naive": ("l2", dict(naive=True), {}),
    "int8": ("l2", dict(quantize=True, rerank_factor=4), {}),
    "drops": ("l2", {}, dict(capacity_factor=0.5)),
}
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
# k-means: 1,001 rows so that worker_slice splits them unevenly (501 and
# 500 at two workers)
KM_N, KM_M, KM_ITERS, KM_SEED = 1001, 8, 6, 3
KM_TOL = dict(rtol=1e-4, atol=1e-4)
AXES = ("data", "model")


# ---------------------------------------------------------------------------
# rank side: no JAX, no repro
# ---------------------------------------------------------------------------


def _spmd_answers(mesh, payload, data_axis=None):
    """Every case's (ids, scores) for the whole batch on ``mesh`` (with
    ``data_axis``, each replica searches its share and ``batch`` is that
    share), and the number of shards of this rank's arenas."""
    out, held = {}, {}
    for name, (which, kw, cfg_change) in CASES.items():
        index = payload["indexes"][which]
        q = payload["queries"][which]
        batch = len(q) // (TM.axis_size(mesh, data_axis) if data_axis
                           else 1)
        cfg = dataclasses.replace(index.config, **cfg_change)
        fn = TD.make_pyramid_search_fn(
            mesh, cfg, k=K, batch=batch, data_axis=data_axis,
            index=index if kw.get("quantize") else None, **kw)
        arena = TD.local_arena(index, mesh,
                               quantize=kw.get("quantize", False))
        ids, scores = fn(arena, index.meta_arrays(),
                         index.part_of_center_tensor(), q)
        out[name] = (np.asarray(ids), np.asarray(scores))
        held[name] = arena.num_shards
    return out, held


def _kmeans_answers(mesh, payload):
    """This rank's k-means results over its own rows of the dataset file,
    read through worker_slice."""
    rank, world = mesh.get_local_rank("data"), TM.axis_size(mesh, "data")
    start, count = TV.worker_slice(payload["km_rows"], rank, world)
    x = TV.load_dataset(payload["km_path"], start, count)
    out = {"rows": (start, count)}
    for name, init in payload["km_inits"].items():
        out[name] = TK.kmeans_distributed(
            x, KM_M, mesh, iters=KM_ITERS, spherical=name == "spherical",
            init_centers=init)
    for init in TK.INITS:
        out["seeded", init] = TK.kmeans_distributed(
            x, KM_M, mesh, iters=KM_ITERS, seed=KM_SEED, init=init)
    return out


def _sharding_answers(mesh):
    """(spec, placements) of the hand-worked cases on a (2, 2) mesh."""
    cases = {
        "batch": TS.logical_to_sharding(mesh, ("batch", None)),
        "fsdp_model": TS.logical_to_sharding_shaped(
            mesh, ("fsdp", "model"), (6, 4)),
        "fsdp_undivided": TS.logical_to_sharding_shaped(
            mesh, ("fsdp", "model"), (5, 4)),
        "moe_ff_moved": TS.logical_to_sharding_shaped(
            mesh, ("expert", None, "moe_ff"), (3, 8, 6)),
        "moe_ff_kept": TS.logical_to_sharding_shaped(
            mesh, ("expert", None, "moe_ff"), (4, 8, 6)),
        "data": TS.data_sharding(mesh, 2),
        "replicated": TS.replicated(mesh),
    }
    out = {name: (s.spec, s.placements) for name, s in cases.items()}
    out["count"] = TS.count_devices(mesh)
    return out


def _rank_main(rank, world, init_file, payload, out_dir):
    """One of four ranks: the SPMD cases over four model ranks (a (1, 4)
    mesh), over two (each data row of a (2, 2) mesh searching the whole
    batch), and on the (2, 2) mesh with ``data_axis`` (each data row its
    half); k-means over the (2, 2) mesh's two data ranks; the sharding
    rules on it."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        line = TM.make_local_mesh("cpu")
        grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)
        out = {"coords": (grid.get_local_rank("data"),
                          grid.get_local_rank("model"))}
        out["spmd", 4], out["held", 4] = _spmd_answers(line, payload)
        out["spmd", 2], out["held", 2] = _spmd_answers(grid, payload)
        out["grid"], out["grid_held"] = _spmd_answers(grid, payload,
                                                      data_axis="data")
        out["kmeans"] = _kmeans_answers(grid, payload)
        out["sharding"] = _sharding_answers(grid)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parent side: the reference and the ranks' results
# ---------------------------------------------------------------------------


def _data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(12, D))
    x = centers[rng.integers(0, 12, size=N)] + 0.3 * rng.normal(size=(N, D))
    q = x[rng.integers(0, N, size=B)] + 0.05 * rng.normal(size=(B, D))
    return x.astype(np.float32), q.astype(np.float32)


def _km_data():
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(KM_M, D))
    x = centers[rng.integers(0, KM_M, size=KM_N)] \
        + 0.4 * rng.normal(size=(KM_N, D))
    return x.astype(np.float32)


def _graph_arrays(g):
    return {f: getattr(g, f) for f in convert.GRAPH_FIELDS}


def _carry(ref):
    return convert.index_from_arrays(
        dataclasses.asdict(ref.config), _graph_arrays(ref.meta),
        ref.part_of_center, [_graph_arrays(g) for g in ref.subs],
        quant=ref.quant_params().to_manifest(), device="cpu")


def _reference_spmd(ref, batches, kw, cfg_change):
    """The reference's SPMD search on a one-device model mesh, built for
    the batch of ``batches[0]`` and run on each of ``batches``."""
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as RD
    fn = RD.make_pyramid_search_fn(
        jax.make_mesh((1,), ("model",)),
        dataclasses.replace(ref.config, **cfg_change), k=K,
        batch=len(batches[0]), index=ref if kw.get("quantize") else None,
        **kw)
    arena = ref.arena("int8" if kw.get("quantize") else "float32")
    out = []
    for q in batches:
        ids, scores = fn(arena, ref.meta_arrays(),
                         jnp.asarray(ref.part_of_center), jnp.asarray(q))
        out.append((np.asarray(ids), np.asarray(scores)))
    return out


def _capacity(batch, capacity_factor):
    return int(np.ceil(batch * CFG["branching_factor"] / CFG["num_shards"]
                       * capacity_factor))


@pytest.fixture(scope="module")
def world():
    """The reference indexes, their port copies, the queries, the
    reference's answers (whole batch, and each half), and the k-means
    dataset and the reference's k-means, shared by every test here."""
    import jax
    import jax.numpy as jnp
    from repro.common.config import PyramidConfig as RefConfig
    from repro.core import kmeans as RK
    from repro.core import metrics as RM
    from repro.core.meta_index import build_pyramid_index as ref_build
    x, q = _data()
    refs = {name: ref_build(x, RefConfig(**{**CFG, **change}))
            for name, change in INDEX_CFGS.items()}
    queries = {name: RM.preprocess_queries(q, ref.config.metric)
               for name, ref in refs.items()}
    expect, halves = {}, {}
    for name, (which, kw, cfg_change) in CASES.items():
        ref, qq = refs[which], queries[which]
        expect[name], = _reference_spmd(ref, [qq], kw, cfg_change)
        halves[name] = _reference_spmd(ref, [qq[:B // 2], qq[B // 2:]], kw,
                                       cfg_change)

    xk = _km_data()
    xj = jnp.asarray(xk)
    xn = xj / (jnp.linalg.norm(xj, axis=-1, keepdims=True) + 1e-12)
    mesh = jax.make_mesh((1, 1), AXES)
    km_ref, km_inits = {}, {}
    for name, spherical, rows in (("l2", False, xj), ("spherical", True, xn)):
        km_inits[name] = np.asarray(RK._init_centers(rows, KM_M, KM_SEED))
        c, n = RK.kmeans_distributed(xj, KM_M, mesh, iters=KM_ITERS,
                                     spherical=spherical, seed=KM_SEED)
        km_ref[name] = (np.asarray(c), np.asarray(n))
    payload = {"indexes": {name: _carry(ref) for name, ref in refs.items()},
               "queries": queries, "km_inits": km_inits, "km_rows": KM_N}
    return {"refs": refs, "payload": payload, "expect": expect,
            "halves": halves, "km_x": xk, "km_ref": km_ref}


@pytest.fixture(scope="module")
def km_file(world, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vectors") / "km.fvecs")
    TV.write_fvecs(path, world["km_x"])
    world["payload"]["km_path"] = path
    return path


@pytest.fixture(scope="module")
def spmd_world1(world):
    """The SPMD answers at world size 1, in this process: the mesh starts
    its own gloo group from a HashStore."""
    assert not dist.is_initialized()
    try:
        mesh = TM.make_local_mesh("cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        answers, held = _spmd_answers(mesh, world["payload"])
        index = world["payload"]["indexes"]["l2"]
        same = {dtype: TD.local_arena(index, mesh, quantize=dtype == "int8")
                is index.arena(dtype) for dtype in ("float32", "int8")}
    finally:
        dist.destroy_process_group()
    return answers, held, same


@pytest.fixture(scope="module")
def world4(world, km_file, tmp_path_factory):
    """The four ranks' results (``_rank_main``), in rank order."""
    out_dir = tmp_path_factory.mktemp("ranks")
    mp.spawn(_rank_main, args=(4, str(out_dir / "store"), world["payload"],
                               str(out_dir)), nprocs=4, join=True)
    results = []
    for r in range(4):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _assert_deduped(ids):
    for row in np.asarray(ids):
        valid = row[row >= 0]
        assert len(set(valid.tolist())) == len(valid), row


def _assert_same(ref, port):
    np.testing.assert_array_equal(ref[0], port[0])
    np.testing.assert_allclose(ref[1], port[1], **SCORE_TOL)


# ---------------------------------------------------------------------------
# the SPMD search
# ---------------------------------------------------------------------------


def test_reference_cases_exercise_what_they_name(world):
    """The "ip" index replicates items; the "drops" case's capacity is
    below the largest shard load of the whole batch and of each half
    (routed pairs are dropped), while the "l2" case's is the batch."""
    from repro.core import distributed as RD
    assert world["refs"]["ip"].build_stats["replicated_items"] > 0
    q = world["payload"]["queries"]["l2"]
    for rows in (q, q[:B // 2], q[B // 2:]):
        _, _, mask = RD.search_single_host(world["refs"]["l2"], rows, K)
        load = int(mask.sum(axis=0).max())
        assert load > _capacity(len(rows), 0.5), load
    assert _capacity(B, 2.0) == B


@pytest.mark.parametrize("case", tuple(CASES))
def test_spmd_at_world_1_matches_reference(world, spmd_world1, case):
    answers, held, _ = spmd_world1
    assert held[case] == CFG["num_shards"]
    _assert_same(world["expect"][case], answers[case])
    if case == "ip":
        _assert_deduped(answers[case][0])


def test_world_1_local_arena_is_the_index_arena(spmd_world1):
    assert spmd_world1[2] == {"float32": True, "int8": True}


@pytest.mark.parametrize("case", tuple(CASES))
@pytest.mark.parametrize("size", (2, 4))
def test_spmd_across_model_ranks_matches_reference(world, world4, size,
                                                   case):
    for res in world4:          # every rank returns the whole answer
        assert res["held", size][case] == CFG["num_shards"] // size
        _assert_same(world["expect"][case], res["spmd", size][case])
        if case == "ip":
            _assert_deduped(res["spmd", size][case][0])


@pytest.mark.parametrize("case", tuple(CASES))
def test_spmd_on_data_by_model_mesh_matches_reference(world, world4, case):
    """(2, 2) with ``data_axis``: every rank is given the whole batch and
    ``batch`` = B / 2; each data rank serves its half over two model
    ranks of two shards each, and every rank returns both halves, each
    equal to the reference at that half's batch."""
    halves = world["halves"][case]
    expect = tuple(np.concatenate([h[i] for h in halves]) for i in (0, 1))
    for res in world4:
        assert res["grid_held"][case] == CFG["num_shards"] // 2
        _assert_same(expect, res["grid"][case])
    assert sorted(r["coords"] for r in world4) == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]


def test_quantize_needs_the_index(world):
    import jax
    from repro.core import distributed as RD
    cfg_ref = world["refs"]["l2"].config
    with pytest.raises(ValueError):
        RD.make_pyramid_search_fn(jax.make_mesh((1,), ("model",)), cfg_ref,
                                  k=K, batch=B, quantize=True)
    cfg = world["payload"]["indexes"]["l2"].config
    with pytest.raises(ValueError, match="needs index="):
        TD.make_pyramid_search_fn(None, cfg, k=K, batch=B, quantize=True)


def test_data_axis_needs_the_global_batch(world):
    """With ``data_axis`` the fn takes the batch of every replica: one
    replica's rows alone raise instead of being split again."""
    index = world["payload"]["indexes"]["l2"]
    q = world["payload"]["queries"]["l2"]
    try:
        mesh = TM.make_local_mesh("cpu")
        fn = TD.make_pyramid_search_fn(mesh, index.config, k=K, batch=B,
                                       data_axis="data")
        args = (index.arena(), index.meta_arrays(),
                index.part_of_center_tensor())
        with pytest.raises(ValueError, match="do not split into 1 "
                                             "replicas of batch=24"):
            fn(*args, q[:B // 2])
        ids, scores = fn(*args, q)
    finally:
        dist.destroy_process_group()
    _assert_same(world["expect"]["l2"], (np.asarray(ids), np.asarray(scores)))


def test_rerank_table_is_read_at_call_time(world, monkeypatch):
    """The int8 fn reads ``index.rerank_table()`` at every call, never
    when it is built: ids added to the index in between are reranked
    against their own rows."""
    index = world["payload"]["indexes"]["l2"]
    calls = []
    table = index.rerank_table
    monkeypatch.setattr(index, "rerank_table",
                        lambda: calls.append(1) or table())
    try:
        mesh = TM.make_local_mesh("cpu")
        fn = TD.make_pyramid_search_fn(mesh, index.config, k=K, batch=B,
                                       quantize=True, index=index)
        assert not calls
        for n in (1, 2):
            ids, _ = fn(index.arena("int8"), index.meta_arrays(),
                        index.part_of_center_tensor(),
                        world["payload"]["queries"]["l2"])
            assert len(calls) == n
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(ids, world["expect"]["int8"][0])


# ---------------------------------------------------------------------------
# distributed k-means
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def km_world1(world, km_file):
    try:
        return _kmeans_answers(TM.make_local_mesh("cpu"), world["payload"])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ("l2", "spherical"))
@pytest.mark.parametrize("size", (1, 2))
def test_kmeans_distributed_matches_reference(world, km_world1, world4,
                                              size, kind):
    """At two data ranks (the (2, 2) mesh), each reads its own rows of
    the file through worker_slice, split unevenly."""
    results = [km_world1] if size == 1 else [r["kmeans"] for r in world4]
    c_ref, n_ref = world["km_ref"][kind]
    for res in results:
        c, n = res[kind]
        np.testing.assert_allclose(c, c_ref, **KM_TOL)
        np.testing.assert_array_equal(n, n_ref)
    rows = {r["rows"] for r in results}
    assert rows == ({(0, KM_N)} if size == 1 else {(0, 501), (501, 500)})


@pytest.mark.parametrize("init", TK.INITS)
def test_kmeans_distributed_with_a_seed_agrees_across_ranks(world, world4,
                                                            init):
    """From ``seed`` alone every rank starts from the same centres (drawn
    from the rows gathered over ``data``) and ends with the same ones,
    within 1e-4 of the port's one-process ``kmeans`` on all the rows."""
    runs = [r["kmeans"]["seeded", init] for r in world4]
    for c, n in runs[1:]:
        np.testing.assert_array_equal(c, runs[0][0])
        np.testing.assert_array_equal(n, runs[0][1])
    c1, n1 = TK.kmeans(world["km_x"], KM_M, iters=KM_ITERS, seed=KM_SEED,
                       init=init, device="cpu")
    np.testing.assert_allclose(runs[0][0], c1, **KM_TOL)
    np.testing.assert_array_equal(runs[0][1], n1)


@pytest.mark.parametrize("init", TK.INITS)
def test_kmeans_distributed_seeding_moves_only_the_chosen_rows(
        world, monkeypatch, init):
    """Seeding from ``seed`` sends the m chosen rows (one at a time for
    k-means++, with one D² total a rank) across ranks, never the ranks'
    rows: no collective carries more than m x d numbers. The centres are
    ``kmeans``'s from the same seed."""
    sizes = []
    for op in ("all_gather", "all_reduce"):
        real = getattr(dist, op)

        def spy(*args, _real=real, **kw):
            t = args[0]
            sizes.append(sum(p.numel() for p in t) if isinstance(t, list)
                         else t.numel())
            return _real(*args, **kw)
        monkeypatch.setattr(dist, op, spy)
    x = world["km_x"]
    try:
        c, n = TK.kmeans_distributed(x, KM_M, TM.make_local_mesh("cpu"),
                                     iters=0, seed=KM_SEED, init=init)
    finally:
        dist.destroy_process_group()
    assert sizes and max(sizes) <= KM_M * D < x.size
    c1, _ = TK.kmeans(x, KM_M, iters=0, seed=KM_SEED, init=init,
                      device="cpu")
    np.testing.assert_array_equal(c, c1)


# ---------------------------------------------------------------------------
# the mesh, the sharding rules, the dataset reads
# ---------------------------------------------------------------------------


def test_cuda_mesh_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.make_local_mesh("cuda")
    assert not dist.is_initialized()
    # a card, but a gloo group: a cuda mesh refuses it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="nccl"):
            TM.make_local_mesh("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,need", ((False, 256), (True, 512)))
def test_production_mesh_names_the_world_it_needs(multi_pod, need):
    with pytest.raises(ValueError, match=f"world size {need}; this one "
                                         f"has 1"):
        TM.make_production_mesh(multi_pod=multi_pod, device="cpu")


SPEC_CASES = [
    (("batch", None), None),
    (("fsdp", "model"), None),
    (("shard", None), None),
    ((None, "expert", "fsdp"), None),
    (("fsdp", "model"), (6, 4)),
    (("expert", None, "moe_ff"), (3, 8, 6)),
    ((None, "batch"), (2, 50280)),
]


@pytest.mark.parametrize("logical,shape", SPEC_CASES, ids=str)
def test_sharding_specs_equal_reference_at_1x1(logical, shape):
    import jax
    from repro.common import sharding as RS
    ref_mesh = jax.make_mesh((1, 1), AXES)
    try:
        mesh = TM.make_local_mesh("cpu")
        if shape is None:
            ref = RS.logical_to_sharding(ref_mesh, logical)
            port = TS.logical_to_sharding(mesh, logical)
        else:
            ref = RS.logical_to_sharding_shaped(ref_mesh, logical, shape)
            port = TS.logical_to_sharding_shaped(mesh, logical, shape)
        extra = [(RS.data_sharding(ref_mesh, 3), TS.data_sharding(mesh, 3)),
                 (RS.replicated(ref_mesh), TS.replicated(mesh))]
        assert TS.count_devices(mesh) == RS.count_devices(ref_mesh) == 1
        assert TS.batch_axes(mesh) == RS.batch_axes(ref_mesh)
        assert TS.fsdp_axes(mesh) == RS.fsdp_axes(ref_mesh)
        with pytest.raises(ValueError, match="unknown logical axis"):
            TS.logical_to_sharding(mesh, ("vocab",))
    finally:
        dist.destroy_process_group()
    for r, p in [(ref, port)] + extra:
        assert len(p.spec) == len(r.spec)
        for a, b in zip(r.spec, p.spec):
            assert a == b, (r.spec, p.spec)


def test_sharding_on_a_2x2_mesh(world4):
    """Cases worked by hand from the reference's rules: a dim keeps its
    axis only if the axis's size divides it; 'moe_ff' takes ``model``
    only when the expert dim lost it."""
    expect = {
        "batch": (("data", None), (Shard(0), Replicate())),
        "fsdp_model": (("data", "model"), (Shard(0), Shard(1))),
        "fsdp_undivided": ((None, "model"), (Replicate(), Shard(1))),
        "moe_ff_moved": ((None, None, "model"), (Replicate(), Shard(2))),
        "moe_ff_kept": (("model", None, None), (Replicate(), Shard(0))),
        "data": (("data", None), (Shard(0), Replicate())),
        "replicated": ((), (Replicate(), Replicate())),
    }
    for res in world4:
        got = res["sharding"]
        assert got.pop("count") == 4
        assert got == expect


def test_vector_files_round_trip_across_packages(tmp_path):
    from repro.data import vectors as RV
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 12)).astype(np.float32)
    ours, theirs = str(tmp_path / "a.fvecs"), str(tmp_path / "b.fvecs")
    TV.write_fvecs(ours, x)
    RV.write_fvecs(theirs, x)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path in (ours, theirs):
        for read in (TV.read_fvecs, RV.read_fvecs, TV.load_dataset,
                     RV.load_dataset):
            np.testing.assert_array_equal(read(path), x)
            np.testing.assert_array_equal(read(path, 5, 10), x[5:15])
    ints = rng.integers(0, 1000, size=(9, 4)).astype(np.int32)
    ivecs = str(tmp_path / "g.ivecs")
    np.concatenate([np.full((9, 1), 4, np.int32), ints], 1).tofile(ivecs)
    np.testing.assert_array_equal(TV.read_ivecs(ivecs), ints)
    np.testing.assert_array_equal(TV.read_ivecs(ivecs, 2, 3),
                                  RV.read_ivecs(ivecs, 2, 3))
    b = rng.integers(0, 256, size=(6, 8)).astype(np.uint8)
    bvecs = str(tmp_path / "s.bvecs")
    rec = np.empty((6, 12), np.uint8)
    rec[:, :4] = np.frombuffer(np.full(6, 8, np.int32).tobytes(),
                               np.uint8).reshape(6, 4)
    rec[:, 4:] = b
    rec.tofile(bvecs)
    np.testing.assert_array_equal(TV.read_bvecs(bvecs), b.astype(np.float32))
    np.testing.assert_array_equal(TV.load_dataset(bvecs, 1, 2),
                                  RV.load_dataset(bvecs, 1, 2))
    npy = str(tmp_path / "x.npy")
    np.save(npy, x)
    np.testing.assert_array_equal(TV.load_dataset(npy, 3, 4), x[3:7])
    with pytest.raises(ValueError, match="unknown dataset format"):
        TV.load_dataset(str(tmp_path / "x.bin"))


@pytest.mark.parametrize("total,workers", ((103, 8), (1001, 2), (5, 8),
                                           (64, 4)))
def test_worker_slices_cover_exactly(total, workers):
    from repro.data import vectors as RV
    seen = []
    for w in range(workers):
        s, c = TV.worker_slice(total, w, workers)
        assert (s, c) == RV.worker_slice(total, w, workers)
        seen += list(range(s, s + c))
    assert seen == list(range(total))
