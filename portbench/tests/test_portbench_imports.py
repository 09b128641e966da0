"""Nothing the benchmark runs imports JAX, flax, orbax or the JAX
package: every module of ``portbench`` and of the port, imported in a
fresh process, compared by whole top-level names."""

import json
import subprocess
import sys

from portbench.harness import BANNED, ROOT

PROBE = r"""
import importlib, json, pkgutil, sys
from pathlib import Path
import portbench, abstracts_search_tpu_torch
names = []
for pkg in (portbench, abstracts_search_tpu_torch):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if ".tests" in m.name:
            continue
        importlib.import_module(m.name)
        names.append(m.name)
from portbench import harness
for p in sorted((Path(portbench.__file__).parent / "metrics").glob("*.py")):
    harness.reader(p.stem)
print(json.dumps({"imported": names, "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_no_jax_in_the_benchmark_or_the_port():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "portbench.run" in got["imported"]
    assert "abstracts_search_tpu_torch.serve.app" in got["imported"]
    assert not set(got["top"]) & set(BANNED), set(got["top"]) & set(BANNED)
    assert "abstracts_search_tpu_torch" in got["top"]


def test_no_file_of_the_benchmark_reads_the_jax_side():
    for p in (ROOT / "portbench").rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        for word in ("import jax", "from jax", "import flax", "chip_smoke", "bench.py",
                     "BENCH_r", "abstracts_search_tpu.", "abstracts_search_tpu import"):
            assert word not in text, (p, word)
