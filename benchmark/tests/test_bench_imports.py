"""What `benchmark/run.py` loads holds no module of JAX or of the JAX
package (compared by whole top-level names: `shockwave_tpu_torch` is the
port, `shockwave_tpu` the JAX package), and a run without a card, or
without the program, prints no result."""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "shockwave_tpu"}

LOAD_ALL = """
import json, sys
sys.argv = ["run.py"]
import benchmark.run
from benchmark import control, faults, harness, spec
bench = json.load(open("BENCHMARK.json"))
for w in bench["workloads"]:
    spec.load(w["name"])
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.metric_reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_nothing_loaded_is_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.splitlines()[-1]))
    assert "shockwave_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_top_level_names():
    from benchmark import harness
    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert harness.forbidden_modules(["shockwave_tpu_torch.models.transformer", "numpy",
                                      "jaxtyping", "flaxen.x"]) == []
    assert harness.forbidden_modules(["shockwave_tpu.core", "jax.numpy", "optax"]) == [
        "jax", "optax", "shockwave_tpu"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "transformer_base.doc2048", "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
