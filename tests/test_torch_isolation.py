"""repro_torch stands alone: no module of it, and not chip_smoke.py, imports
jax or any module of the JAX package ``repro``; and chip_smoke.py fails,
printing no result, where there is no card or no repository beside it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
#: the wire and its exposition, imported and scanned like every module
WIRE_MODULES = ("repro_torch.net", "repro_torch.net.__main__",
                "repro_torch.net.protocol", "repro_torch.net.shard_server",
                "repro_torch.net.router", "repro_torch.obs.http",
                "repro_torch.obs.scrape")
#: the clients, the load harness and the launcher, named so that a module
#: the package walk misses fails the import check; the ``__main__`` ones
#: run nothing when imported
CLIENT_MODULES = ("repro_torch.client", "repro_torch.client.session",
                  "repro_torch.client.url", "repro_torch.loadgen",
                  "repro_torch.loadgen.__main__", "repro_torch.loadgen.spec",
                  "repro_torch.loadgen.driver", "repro_torch.loadgen.slo",
                  "repro_torch.loadgen.cluster", "repro_torch.launch",
                  "repro_torch.launch.serve")
#: the LM substrate: configs, models and the tokenizer, scanned like every
#: module (``models/config.py`` and ``configs/`` are the port's own copies)
LM_MODULES = ("repro_torch.models", "repro_torch.models.config",
              "repro_torch.models.layers", "repro_torch.models.ssm",
              "repro_torch.models.transformer", "repro_torch.models.model",
              "repro_torch.configs", "repro_torch.configs.gemma2_2b",
              "repro_torch.configs.h2o_danube_1p8b",
              "repro_torch.configs.jamba_1p5_large",
              "repro_torch.configs.llama32_vision_90b",
              "repro_torch.configs.mamba2_780m",
              "repro_torch.configs.mixtral_8x22b",
              "repro_torch.configs.qwen1p5_4b",
              "repro_torch.configs.qwen3_moe_30b_a3b",
              "repro_torch.configs.whisper_medium", "repro_torch.configs.yi_9b",
              "repro_torch.core.tokenizer", "repro_torch.convert")
#: the training path: optimizer, state and step, checkpoints, the loop, the
#: data plane and the launcher (``launch.train`` runs nothing when imported)
TRAIN_MODULES = ("repro_torch.tree", "repro_torch.optim",
                 "repro_torch.optim.adamw", "repro_torch.train",
                 "repro_torch.train.state", "repro_torch.train.train_step",
                 "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
                 "repro_torch.runtime", "repro_torch.runtime.loop",
                 "repro_torch.data", "repro_torch.data.corpus",
                 "repro_torch.data.pipeline", "repro_torch.launch.train")
#: the distributed layer: the sharding rules, the compressed all-reduce, the
#: collective counter, the meshes, mesh training, the dry-run and the
#: roofline report (importing them starts no process group)
DIST_MODULES = ("repro_torch.distributed", "repro_torch.distributed.sharding",
                "repro_torch.distributed.compress", "repro_torch.distributed.comm",
                "repro_torch.distributed.tp",
                "repro_torch.launch.mesh", "repro_torch.train.mesh_step",
                "repro_torch.launch.dryrun", "repro_torch.launch.roofline")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # no module starts a process group\n"
        "wire = sorted(set(WIRE) - set(names))\n"
        "print(len(names), bad, wire)\n").replace(
            "WIRE", repr(WIRE_MODULES + CLIENT_MODULES + LM_MODULES
                         + TRAIN_MODULES + DIST_MODULES))
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad, missing = proc.stdout.strip().split(" ", 2)
    assert int(count) >= 20  # every module was imported
    assert bad == "[]"
    assert missing == "[]"  # the wire's, the clients', the LM's, training's, the mesh's


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(map(_forbidden, names)), f"{path}:{node.lineno} {names}"


def _module_path(module: str) -> Path:
    parts = module.split(".")[1:]
    package = PKG.joinpath(*parts, "__init__.py")
    return package if package.exists() else PKG.joinpath(*parts[:-1],
                                                          parts[-1] + ".py")


@pytest.mark.parametrize("module", WIRE_MODULES)
def test_wire_modules_are_scanned(module):
    assert _module_path(module) in set(PKG.rglob("*.py"))


@pytest.mark.parametrize("module", CLIENT_MODULES)
def test_client_modules_are_scanned(module):
    assert _module_path(module) in set(PKG.rglob("*.py"))


@pytest.mark.parametrize("module", DIST_MODULES)
def test_dist_modules_are_scanned(module):
    assert _module_path(module) in set(PKG.rglob("*.py"))


@pytest.mark.parametrize("module", LM_MODULES)
def test_lm_modules_are_scanned(module):
    assert _module_path(module) in set(PKG.rglob("*.py"))


@pytest.mark.parametrize("module", TRAIN_MODULES)
def test_train_modules_are_scanned(module):
    assert _module_path(module) in set(PKG.rglob("*.py"))


@pytest.mark.parametrize("module", [m for m in WIRE_MODULES + CLIENT_MODULES
                                    + TRAIN_MODULES if m.endswith("__main__")
                                    or m.startswith("repro_torch.launch.")])
def test_entry_modules_run_nothing_when_imported(module):
    tree = ast.parse(_module_path(module).read_text())
    top = [n for n in tree.body if not isinstance(
        n, (ast.Import, ast.ImportFrom, ast.FunctionDef, ast.ClassDef))]
    # a docstring, constants, and the one `if __name__ == "__main__":` guard
    guards = [n for n in top if isinstance(n, ast.If)]
    assert len(guards) == 1 and ast.unparse(guards[0].test) == \
        "__name__ == '__main__'"
    assert all(isinstance(n, (ast.Expr, ast.Assign, ast.If)) for n in top)


def _run_smoke(cwd: Path, fake_card: bool = False) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, wherever the test runs
    # with fake_card, torch reports a card so the script gets past its
    # availability check and on to importing the port
    stub = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    cmd = ["-c", stub] if fake_card else [str(cwd / "chip_smoke.py")]
    return subprocess.run([sys.executable, *cmd], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, fake_card=True)
    assert proc.returncode != 0
    assert "No module named 'repro_torch'" in proc.stderr
    assert '"ok"' not in proc.stdout
