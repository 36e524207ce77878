"""The port runs where JAX and scikit-learn are not installed: no module of
ganmf_tpu_torch imports jax, ganmf_tpu or sklearn, directly or through another
module. Importing it turns TF32 and bf16 reduced-precision reductions off."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys

class _Refuse:
    # a finder that fails any import of jax, ganmf_tpu or sklearn, even if
    # some earlier code had already imported them
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ganmf_tpu", "sklearn"):
            raise ImportError(f"the port imported {name}")
        return None

for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ganmf_tpu", "sklearn")]:
    del sys.modules[name]
sys.meta_path.insert(0, _Refuse())

import ganmf_tpu_torch
names = ["ganmf_tpu_torch"] + [m.name for m in pkgutil.walk_packages(ganmf_tpu_torch.__path__, "ganmf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ganmf_tpu", "sklearn"))
assert not leaked, leaked
print("IMPORTED", len(names))
"""


def test_port_imports_neither_jax_nor_ganmf_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True, text=True,
                       cwd=str(REPO), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    # every module of the port was imported, the training slice's host
    # copies, the run_best and experiment entry points, the tuner, the
    # DisGANMF, PureSVD, CAAE, IALS and TopPop models and the similarity
    # family (ops/similarity, ops/simscore, utils/weighting, the ItemKNN,
    # P3alpha and SLIM-BPR models) among them
    assert int(r.stdout.split("IMPORTED")[1]) >= 45, r.stdout


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
