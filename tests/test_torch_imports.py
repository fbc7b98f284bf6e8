"""The port imports torch, never JAX and nothing of the JAX package.

An AST scan of every module of `shockwave_tpu_torch/` and of
`chip_smoke.py`: no import of `jax`, `flax` or `optax`, and none of
`shockwave_tpu` itself (matched as a whole package name, so
`shockwave_tpu_torch` passes). Then the two things the port shares with
the JAX package on purpose: the wire schema of the control plane, and
nothing else loaded on the lease-free path (no grpc).
"""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "shockwave_tpu"}


def port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "shockwave_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "build")]
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def imported_packages(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_the_scan_covers_the_port():
    names = {os.path.relpath(p, REPO) for p in port_files()}
    assert "chip_smoke.py" in names
    assert "shockwave_tpu_torch/ops/flash_attention.py" in names
    assert "shockwave_tpu_torch/workloads/translation/train.py" in names
    assert "shockwave_tpu_torch/runtime/iterator.py" in names
    assert "shockwave_tpu_torch/runtime/worker.py" in names
    assert "shockwave_tpu_torch/runtime/proto/control_pb2.py" in names
    for module in ("constants", "job_table", "oracle", "artifacts", "timing", "job", "trace"):
        assert f"shockwave_tpu_torch/core/{module}.py" in names
    for module in ("device", "measure_throughput", "extrapolate_sf", "measure_startup",
                   "bench_gpu", "measure_deployed", "bench_serving_decode", "headline"):
        assert f"shockwave_tpu_torch/profiling/{module}.py" in names
    for path in ("obs/quantiles.py", "serving/__init__.py", "serving/load.py",
                 "serving/measured.py", "models/decoder.py", "models/a3c.py",
                 "models/cyclegan.py", "workloads/serving/serve.py", "workloads/rl/main.py",
                 "workloads/cyclegan/cyclegan.py", "obs/clock.py", "obs/propagation.py",
                 "obs/tracing.py", "obs/shard.py", "obs/exporter.py", "runtime/spans.py"):
        assert f"shockwave_tpu_torch/{path}" in names


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_and_no_reference_package(path):
    packages = set(imported_packages(path))
    assert not packages & FORBIDDEN, sorted(packages & FORBIDDEN)


def test_the_scan_catches_the_reference_package(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import shockwave_tpu_torch\nfrom shockwave_tpu.core import job\n")
    assert set(imported_packages(str(bad))) & FORBIDDEN == {"shockwave_tpu"}


def test_the_wire_schema_is_the_reference_packages():
    """The port's proto module registers the same serialized descriptor
    (file control.proto, package shockwave_tpu), so its RPCs reach the
    unchanged scheduler and both modules load in one process."""
    from shockwave_tpu.runtime.proto import control_pb2 as ref
    from shockwave_tpu_torch.runtime.proto import control_pb2 as port
    assert port.DESCRIPTOR.serialized_pb == ref.DESCRIPTOR.serialized_pb
    assert port.DESCRIPTOR.package == "shockwave_tpu"
    assert port.UpdateLeaseRequest is ref.UpdateLeaseRequest


def test_the_lease_free_trainer_does_not_load_grpc():
    code = ("import sys; import shockwave_tpu_torch.workloads.translation.train; "
            "assert 'grpc' not in sys.modules, 'grpc loaded'")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
