"""The port runs where JAX, scikit-learn and pandas are not installed: no
module of ganmf_tpu_torch (nor chip_smoke.py) imports jax, ganmf_tpu, sklearn
or pandas, directly or through another module. Importing it turns TF32 and
bf16 reduced-precision reductions off."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys

class _Refuse:
    # a finder that fails any import of jax, ganmf_tpu, sklearn or pandas,
    # even if some earlier code had already imported them
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ganmf_tpu", "sklearn", "pandas"):
            raise ImportError(f"the port imported {name}")
        return None

for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ganmf_tpu", "sklearn", "pandas")]:
    del sys.modules[name]
sys.meta_path.insert(0, _Refuse())

import ganmf_tpu_torch
names = ["ganmf_tpu_torch"] + [m.name for m in pkgutil.walk_packages(ganmf_tpu_torch.__path__, "ganmf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ganmf_tpu", "sklearn", "pandas"))
assert not leaked, leaked
print("IMPORTED", len(names))
print("NAMES", " ".join(names))
"""


def test_port_imports_neither_jax_nor_ganmf_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True, text=True,
                       cwd=str(REPO), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    # every module of the port was imported, the training slice's host
    # copies, the run_best and experiment entry points, the tuner, the
    # DisGANMF, PureSVD, CAAE, IALS and TopPop models, the similarity
    # family (ops/similarity, ops/simscore, utils/weighting, the ItemKNN,
    # P3alpha and SLIM-BPR models), the MF-SGD family, IRGAN, NMF / EASE-R /
    # PredefinedList, the study CLIs and their host helpers, the keyed draw,
    # the host engine, the debug and profiling utilities and the mesh
    # layer (parallel.comm, parallel.mesh, parallel.distributed,
    # parallel.adversarial, parallel.baselines) and the distributed
    # Cholesky (ops.distchol), and the graft entry points (graft) among them
    assert int(r.stdout.split("IMPORTED")[1].split()[0]) >= 59, r.stdout
    names = set(r.stdout.split("NAMES")[1].split())
    for module in ("models.mf_sgd", "models.irgan", "models.extras", "utils.analysis", "utils.timing",
                   "eval.significance", "cli.describe", "cli.ablation", "cli.mf_learned",
                   "ops.keyed", "ops.host", "utils.debug", "utils.profiling",
                   "parallel.comm", "parallel.mesh", "parallel.distributed", "parallel.adversarial",
                   "parallel.baselines", "ops.distchol", "data.synthetic", "cli.scale20m", "graft"):
        assert f"ganmf_tpu_torch.{module}" in names, module


def test_chip_smoke_imports_neither_jax_nor_ganmf_tpu():
    """chip_smoke.py runs where JAX and pandas are not installed: no import
    statement of it, at the top or inside a function, names jax, ganmf_tpu,
    sklearn or pandas, and importing it under the refusing finder works."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "ganmf_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "ganmf_tpu", "sklearn", "pandas"}, roots
    check = _CHECK.split("import ganmf_tpu_torch")[0] + "import chip_smoke\nprint('IMPORTED', 1)\n"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", check], capture_output=True, text=True,
                       cwd=str(REPO), env=env, timeout=300)
    assert r.returncode == 0 and "IMPORTED" in r.stdout, r.stderr[-2000:]


def test_port_models_cover_the_jax_packages():
    """Every public name of ganmf_tpu.models has its class in
    ganmf_tpu_torch.models, under the same name; the CLIs likewise."""
    import ganmf_tpu.cli
    import ganmf_tpu.models as jm
    import ganmf_tpu_torch.cli
    import ganmf_tpu_torch.models as pm

    public = [n for n in dir(jm) if not n.startswith("_") and isinstance(getattr(jm, n), type)]
    assert len(public) >= 26
    missing = [n for n in public if not isinstance(getattr(pm, n, None), type)]
    assert not missing, missing
    assert [m.__name__ for m in pm.GAN_MODELS] == [m.__name__ for m in jm.GAN_MODELS]
    entry_points = [n for n in dir(ganmf_tpu.cli) if n.endswith("_main")]
    assert entry_points == [n for n in dir(ganmf_tpu_torch.cli) if n.endswith("_main")]


_PRECISION = r"""
import torch
assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction  # PyTorch's default
import ganmf_tpu_torch.models
m = torch.backends.cuda.matmul
print("FLAGS", m.allow_tf32, m.allow_bf16_reduced_precision_reduction, torch.backends.cudnn.allow_tf32)
"""


def test_importing_the_port_turns_off_reduced_precision():
    # TF32 and bf16 reduced-precision reductions stay off on every build and
    # scoring path: the Gram of 0/1 data must be exact
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _PRECISION], capture_output=True, text=True,
                       cwd=str(REPO), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("FLAGS")[1].split() == ["False", "False", "False"]
