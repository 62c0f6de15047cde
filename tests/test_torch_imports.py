"""Import hygiene of the PyTorch port: it imports neither ``jax`` nor any
module of the JAX package ``repro``, and ``chip_smoke.py`` fails before
printing a result where it cannot run the port on a card."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import repro_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 20, names\n"
        "for want in ('core.graph_builder', 'core.ppr', 'core.losses',\n"
        "             'core.negatives', 'core.pipeline', 'data.synthetic',\n"
        "             'optim.optimizers', 'kernels.ppr_walk.ops',\n"
        "             'kernels.fused_contrastive.ops',\n"
        "             'kernels.embedding_bag.ops',\n"
        "             'kernels.embedding_bag.embedding_bag',\n"
        "             'kernels.embedding_bag.ref', 'models.recsys.models',\n"
        "             'launch.steps', 'launch.train', 'configs.dlrm_rm2',\n"
        "             'configs.wide_deep', 'configs.sasrec', 'configs.bst',\n"
        "             'configs.llama3_2_3b', 'configs.gemma_2b',\n"
        "             'configs.olmo_1b', 'models.lm.model',\n"
        "             'kernels.flash_attention.ops',\n"
        "             'kernels.flash_attention.flash_attention',\n"
        "             'kernels.flash_attention.ref', 'obs', 'obs.clock',\n"
        "             'obs.sink', 'obs.metrics', 'obs.telemetry', 'faults',\n"
        "             'faults.plan', 'checkpoint', 'checkpoint.checkpointer',\n"
        "             'core.evaluation', 'lifecycle', 'lifecycle.publish',\n"
        "             'lifecycle.snapshot', 'lifecycle.swap',\n"
        "             'lifecycle.runtime'):\n"
        "    assert 'repro_torch.' + want in names, want\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_source_file_of_the_port_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {name}"
           for f in files for line, name in _imported_names(f)
           if _forbidden(name)]
    assert not bad, bad


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")     # no card visible
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
