"""``repro_torch`` stands alone: every module imports without JAX and
without any module of the reference package, and the entry points run on
the card unless the caller asks for the CPU."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.common.config import PyramidConfig
from repro_torch.common.registry import get_arch
from repro_torch.convert import index_from_arrays
from repro_torch.core import distributed as TD
from repro_torch.core.hnsw import build_hnsw
from repro_torch.core.meta_index import PyramidIndex, build_pyramid_index
from repro_torch.core.api import Brokers, GraphConstructor
from repro_torch.launch import maintain, serve, train
from repro_torch.launch.build_index import load_index
from repro_torch.models.transformer import init_params
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.tenancy import TenantManager
from repro_torch.store import IndexStore
from repro_torch.serving.retrieval import build_datastore
from repro_torch.serving.stream import StreamEngine

MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_reference():
    assert "repro_torch.kernels.beam_search.ops" in MODULES
    assert "repro_torch.launch.serve" in MODULES
    assert {"repro_torch.models.ssm", "repro_torch.kernels.ssd.ops",
            "repro_torch.configs.mamba2_780m"} <= set(MODULES)
    assert {"repro_torch.serving.engine", "repro_torch.serving.faults",
            "repro_torch.serving.autoscaler", "repro_torch.core.client",
            "repro_torch.common.utils", "repro_torch.obs.registry",
            "repro_torch.obs.trace", "repro_torch.obs.stats_server",
            "repro_torch.obs.logs",
            "repro_torch.kernels.quant_distance.ops"} <= set(MODULES)
    assert {"repro_torch.store", "repro_torch.store.format",
            "repro_torch.store.store", "repro_torch.core.updates",
            "repro_torch.core.api", "repro_torch.serving.tenancy",
            "repro_torch.launch.build_index"} <= set(MODULES)
    assert {"repro_torch.store.maintenance", "repro_torch.core.lsh",
            "repro_torch.launch.maintain"} <= set(MODULES)
    assert {"repro_torch.data.vectors", "repro_torch.launch.mesh",
            "repro_torch.common.sharding", "repro_torch.core.kmeans",
            "repro_torch.core.distributed"} <= set(MODULES)
    assert {"repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.train_step", "repro_torch.train.checkpoint",
            "repro_torch.train.tree", "repro_torch.launch.train",
            "repro_torch.kernels.ssd", "repro_torch.kernels.ssd.ops",
            "repro_torch.kernels.ssd.ref"} <= set(MODULES)
    assert "repro_torch.serving.stream" in MODULES
    assert {"repro_torch.configs.gemma3_12b",
            "repro_torch.configs.h2o_danube_1_8b",
            "repro_torch.configs.chatglm3_6b"} <= set(MODULES)
    assert {"repro_torch.models.moe", "repro_torch.configs.phi35_moe_42b",
            "repro_torch.configs.grok_1_314b"} <= set(MODULES)
    assert {"repro_torch.configs.zamba2_7b", "repro_torch.configs.internvl2_2b",
            "repro_torch.configs.musicgen_medium"} <= set(MODULES)
    code = ("import importlib, sys\n"
            f"for name in {MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_need_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(40, 4)).astype(np.float32)
    cfg = PyramidConfig(num_shards=2, meta_size=8, sample_size=40,
                        max_degree=4, max_degree_upper=2, ef_construction=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pyramid_index(x, cfg)
    g = build_hnsw(x[:10], max_degree=4, max_degree_upper=2,
                   ef_construction=8)
    fields = {f: getattr(g, f) for f in ("data", "ids", "neighbors",
                                         "levels", "entry", "metric")}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_from_arrays({}, fields, np.zeros(10, np.int32), [fields])
    index = PyramidIndex(config=cfg, meta=g,
                         part_of_center=np.zeros(10, np.int32), subs=[g],
                         build_stats={})
    assert index.device.type == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.search_single_host(index, x[:2], 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(index)
    lm = get_arch("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(lm)
    params = init_params(lm, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(params, lm, num_slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEngine(params, lm, num_slots=2, max_seq=8)
    toks = np.zeros((1, 4), np.int64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_datastore(params, lm, [toks], cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--tokens", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
    IndexStore(str(tmp_path)).publish(index)   # host work only
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IndexStore(str(tmp_path)).load()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine.from_store(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Brokers()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphConstructor(x, "l2", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TenantManager(1 << 20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        maintain.main(["--store", str(tmp_path)])
    assert IndexStore(str(tmp_path)).load(device="cpu").device.type == "cpu"
