"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the entry points do not quietly run
on the CPU when a card was asked for."""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import convert, module, transformer, vig  # noqa: E402
from repro_torch.serve.engine import ServeEngine, VigServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The ring and mesh slice's modules.
MESH_MODULES = ("repro_torch.core.ring", "repro_torch.launch.mesh",
                "repro_torch.distributed.compression",
                "repro_torch.distributed.pipeline",
                "repro_torch.distributed.tree")


def test_port_and_chip_smoke_import_no_jax():
    snippet = textwrap.dedent(f"""
        import importlib, json, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(json.dumps({{"modules": names, "bad": bad}}))
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", snippet], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.kernels.ops" in out["modules"]
    for name in ("repro_torch.serve.engine", "repro_torch.models.transformer",
                 "repro_torch.launch.serve", "repro_torch.configs",
                 "repro_torch.configs.olmo_1b", "repro_torch.models.encdec",
                 "repro_torch.launch.train", "repro_torch.launch.train_vig",
                 "repro_torch.train.trainer", "repro_torch.ckpt.checkpoint",
                 "repro_torch.data.pipeline",
                 "repro_torch.distributed.straggler",
                 *MESH_MODULES):
        assert name in out["modules"]
    assert out["bad"] == []


@pytest.mark.parametrize("name", MESH_MODULES)
def test_mesh_modules_import_neither_jax_nor_repro(name):
    """Every import statement of the slice's modules, read from the
    source (function-level imports included)."""
    path = ROOT / "src" / (name.replace(".", "/") + ".py")
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert roots, name
    assert not roots & {"jax", "jaxlib", "repro"}, (name, sorted(roots))


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
        image_size=16, patch=4, embed_dims=(8,), depths=(1,), num_classes=2)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.init_params(cfg, generator=gen)
    params = convert.init_params(cfg, generator=gen, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(cfg, convert.params_to_numpy(params))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vig.Vig(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VigServeEngine(cfg, params)
    eng = VigServeEngine(cfg, params, device="cpu")
    assert eng.infer(np.zeros((1, 16, 16, 3), np.float32)).shape == (1, 2)
    lm = get_smoke("olmo-1b")
    spec = transformer.param_spec(lm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.init_params(spec, generator=gen)
    lm_params = module.init_params(spec, generator=gen, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(lm, lm_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(lm, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_numpy(lm, convert.lm_params_to_numpy(lm_params))
    assert ServeEngine(lm, lm_params, device="cpu").cache["k"].device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    env = {**os.environ, "PYTHONPATH": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_training_and_encdec_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.launch import api, train, train_vig
    from repro_torch.models import encdec

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vig.main(["--steps", "1"])
    cfg = get_smoke("whisper-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encdec.encdec_init_cache(cfg, 1, 4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_api(cfg).init_cache(1, 4)
    assert api.get_api(cfg).init_cache(1, 4, device="cpu")["mk"].shape[2] == 64
