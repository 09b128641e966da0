"""The port stands alone: it never imports JAX or the JAX package, and
its entry points do not silently run on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "abstracts_search_tpu_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_importing_the_port_leaves_jax_out():
    # a fresh interpreter: this test process already imported jax
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {list(_modules())!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'abstracts_search_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_port_file_imports_the_jax_package():
    for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py", *(ROOT / "tools").glob("*.py")]:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "abstracts_search_tpu"), \
                    (p, n)


def test_entry_points_refuse_the_cpu_without_asking(tmp_path):
    from abstracts_search_tpu_torch.index import IVFPQIndex
    from abstracts_search_tpu_torch.ops.adc import adc_topk

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        IVFPQIndex(8, 16, pq_m=4, pq_nbits=4)
    (tmp_path / "meta.json").write_text(
        '{"n_lists": 8, "dim": 16, "pq_m": 4, "pq_nbits": 4, "use_opq": false, '
        '"seg_size": 32, "spherical": true}')
    with pytest.raises(RuntimeError, match="CUDA"):
        IVFPQIndex.load(tmp_path)
    codes = torch.zeros((2, 2, 32), dtype=torch.uint8)
    luts = torch.zeros((1, 4, 16))
    slots = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        adc_topk(codes, luts, slots, slots, slots, 4, impl="cuda")


def test_tf32_is_off():
    import abstracts_search_tpu_torch  # noqa: F401
    from abstracts_search_tpu_torch.device import assert_exact_f32

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert_exact_f32()
