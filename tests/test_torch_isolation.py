"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``, and
the entry points refuse to run on the CPU unless asked to."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(imported_roots(p) & FORBIDDEN)
           for p in files}
    assert {p: r for p, r in bad.items() if r} == {}


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import repro_torch.core as tc
    import repro_torch.graphs as tg

    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.grid2d(4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.from_coo(3, np.array([0, 1]), np.array([1, 2]))
    g = tg.grid2d(4, 4, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.partition(g, 2)
    assert tc.partition(g, 2, device="cpu").labels.device.type == "cpu"


def test_checkpoints_are_refused():
    import repro_torch.core as tc
    import repro_torch.graphs as tg

    g = tg.grid2d(4, 4, device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        tc.partition(g, 2, device="cpu", resume="some/dir")
    with pytest.raises(ValueError, match="checkpoint"):
        tc.partition(g, 2, device="cpu", ckpt=object())
