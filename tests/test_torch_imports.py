"""The port stands alone: no module of ``neuroimagedisttraining_tpu_torch``,
and not ``chip_smoke.py``, imports JAX, flax, optax, msgpack or the
reference package, and importing the port compiles nothing."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "neuroimagedisttraining_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack",
             "neuroimagedisttraining_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax_or_cuda():
    """A fresh interpreter imports every port module with JAX blocked:
    nothing reaches JAX, and no kernel is built at import time."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from neuroimagedisttraining_tpu_torch.ops import _cuda\n"
        "from neuroimagedisttraining_tpu_torch.utils import native\n"
        "assert not _cuda._libs, _cuda._libs\n"
        "assert native._lib is None\n"
        "assert 'h5py' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module", [
    "engines/fedavg.py", "engines/fedprox.py", "engines/ditto.py",
    "engines/local.py", "ops/flops.py", "utils/logging.py",
    "engines/subavg.py", "engines/dispfl.py", "ops/prune.py",
    "ops/masks.py", "faults/schedule.py", "engines/dpsgd.py",
    "engines/fedfomo.py", "engines/turboaggregate.py", "ops/mpc.py",
    "ops/mpc_device.py", "core/optim.py", "data/federate.py",
    "data/hdf5.py", "data/stream.py", "data/synthetic.py",
    "utils/native.py", "preprocess.py", "__main__.py", "models/neuro3d.py",
    "models/__init__.py", "ops/pooling.py", "ops/stemconv.py",
    "core/losses.py", "core/trainer.py", "device.py", "weights.py",
    "data/partition.py", "data/vision.py", "models/layers2d.py",
    "models/resnet2d.py", "models/vision2d.py", "models/meta.py",
    "models/darts.py", "faults/adversary.py", "core/robust.py",
    "privacy/__init__.py", "privacy/accountant.py", "codec/__init__.py",
    "codec/wire.py", "codec/device.py", "faults/__init__.py",
    "ops/masks.py", "engines/program.py", "core/graphs.py",
    "parallel/__init__.py", "parallel/mesh.py", "parallel/topology.py",
    "parallel/cohort.py", "parallel/hierarchical.py", "parallel/gossip.py",
    "parallel/spatial.py"])
def test_engine_slice_modules_are_checked(module):
    """The engines', the data planes', the model zoo's (the 2D one with its
    vision data included), the precision contract's and the defended
    round's (faults, defenses, accountant, wire codec) modules are among
    the sources checked above (none imports JAX or the reference
    package)."""
    path = PORT / module
    assert path in SOURCES
    assert not [m for m in _imported_modules(path)
                if m.split(".")[0] in FORBIDDEN]
