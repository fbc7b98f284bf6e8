"""One run of each cell on the card, as `BENCHMARK.json`'s command runs it (marked
`cuda`; skips without a card): `correct` true, the cell's metrics
present, and nothing printed after the result line."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = _cells()
    for cell in bench["workloads"]:
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell["name"],
                               "--seed", str(2**31 + 77), "--seconds", "2", "--trace", str(trace)],
                              cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-4000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["correct"], result["checks"]
        kind = "per_layer" if trace else "end_to_end"
        wanted = {m["name"] for m in bench[kind]
                  if cell["name"] in m.get("workloads", [cell["name"]])}
        assert set(result["metrics"]) == wanted
