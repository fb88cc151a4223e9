"""The port's examples (``examples/torch_*.py``, twins of the six
``examples/*.py``) run end to end on the CPU (``--device cpu``), each in a
subprocess in which neither ``jax`` nor any ``repro.*`` module is loaded.

The streaming ones print what ``tests/test_examples.py`` asserts of their
twins. The three that build an index take ``--n`` rows: the host HNSW
builder takes some 30 ms a row at the quickstart's settings, so they
build over 1,000 rows here; the training one runs 20 steps.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"

# example: (arguments beside --device cpu, lines its output must hold)
CASES = {
    "torch_continuous_batching": ((), ("10 requests",)),
    "torch_retrieval_decode": ((), ("streaming decode", "sessions",
                                    "kNN hit rate")),
    "torch_quickstart": (("--n", "1000"), ("precision@10",
                                           "reload parity: True")),
    "torch_mips_search": (("--n", "1000"), ("r=   0:", "r= 100:")),
    "torch_serve_cluster": (("--n", "1000"), ("phase 2 (straggler)",
                                              "overall precision@10")),
    "torch_train_lm": (("--steps", "20"), ("checkpoint roundtrip verified",
                                           "match=True")),
}

# runs the example as __main__, then fails if jax or repro was loaded
RUNNER = """\
import runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.")]
assert not bad, bad
"""


def test_every_example_has_a_port_twin():
    twins = {p.stem for p in EXAMPLES.glob("*.py")
             if not p.stem.startswith("torch_")}
    assert {"torch_" + t for t in twins} == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_cpu_without_jax_or_reference(name, tmp_path):
    args, expect = CASES[name]
    if name == "torch_train_lm":
        args = args + ("--ckpt", str(tmp_path / "ckpt"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", RUNNER, str(EXAMPLES / f"{name}.py"),
         "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    for line in expect:
        assert line in out.stdout, (line, out.stdout[-2000:])
