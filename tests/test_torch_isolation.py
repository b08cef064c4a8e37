"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor the JAX package, and an entry point never falls back to the
CPU when no GPU is there."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_every_module_imports_with_jax_blocked():
    """Import every module of the package in a fresh interpreter where
    ``import jax`` fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert {'repro_torch.serve.engine', 'repro_torch.kernels.ops', 'repro_torch.obs.trace',\n"
        "        'repro_torch.fusion.rng', 'repro_torch.train.trainer', 'repro_torch.optim.adamw',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.checkpoint.checkpoint'} <= set(names)\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 32


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama2_13b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 8)
    assert lm.init_params(cfg, device="cpu")["embed"].device.type == "cpu"

    from repro_torch.data import DataConfig, SyntheticCorpus, to_device
    from repro_torch.train import TrainConfig, TrainerConfig, init_train_state, train
    tcfg = TrainConfig(loss_chunk=8)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, tcfg, dcfg, TrainerConfig(num_steps=1, log_every=0))
    batch = SyntheticCorpus(dcfg).batch_at(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_device(batch)
    assert to_device(batch, "cpu")["tokens"].device.type == "cpu"
    params, _ = init_train_state(cfg, tcfg, device="cpu")
    assert params["embed"].device.type == "cpu"
