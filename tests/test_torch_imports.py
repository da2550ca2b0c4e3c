"""The port stands alone: no module of ``src/repro_torch/``, and not
``chip_smoke.py``, imports ``jax``, ``jaxlib`` or the reference package
``repro``; and a run asked for the card never continues on the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f) if mod in FORBIDDEN]
    assert not bad, bad


def test_port_calls_no_library_attention_or_compiler():
    """K5 is the port's own kernel: no module of the port reaches PyTorch's
    fused attention, cuDNN attention or torch.compile."""
    banned = ("scaled_dot_product_attention", "torch.compile", "_cudnn_attention",
              "cudnn_attention", "flash_attention_forward", "_efficient_attention")
    bad = [f"{f.relative_to(ROOT)}: {word}"
           for f in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
           for word in banned if word in f.read_text()]
    assert not bad, bad


def test_port_imports_no_finished_ssd_kernels():
    """K7 is the port's own kernel: no module of the port imports a package
    of finished SSD or selective-scan kernels."""
    banned = ("mamba_ssm", "causal_conv1d", "selective_scan", "flash_attn")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert ROOT / "src" / "repro_torch" / "kernels" / "ssd_scan.py" in files
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f) if mod in banned]
    assert not bad, bad


def test_port_calls_no_library_grouped_matmul():
    """K6 is the port's own kernel: no module of the port, and not
    ``chip_smoke.py`` outside its yardstick timing, reaches PyTorch's grouped
    matmul or a finished MoE kernel package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    for name in ("kernels/moe_gmm.py", "models/moe.py", "kernels/ops.py"):
        assert ROOT / "src" / "repro_torch" / name in files
    banned = ("_grouped_mm", "grouped_mm(", "megablocks", "grouped_gemm")
    bad = [f"{f.relative_to(ROOT)}: {word}" for f in files for word in banned
           if word in f.read_text()]
    assert not bad, bad
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files + [ROOT / "chip_smoke.py"] for mod, line in _imported_roots(f)
           if mod in ("megablocks", "grouped_gemm")]
    assert not bad, bad


def test_cuda_request_without_a_card_raises():
    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    env = {**os.environ, "PYTHONPATH": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# The modules slice 6 added or extended.
SLICE6_MODULES = ("repro_torch.core.theory", "repro_torch.core.selection",
                  "repro_torch.kernels.score_select", "repro_torch.kernels.ops",
                  "repro_torch.fed.server", "repro_torch.fed.client",
                  "repro_torch.data.synthetic", "repro_torch.examples.paper_reproduction")

# The modules slice 7 added or extended.
SLICE7_MODULES = ("repro_torch", "repro_torch.configs.base", "repro_torch.configs.registry",
                  "repro_torch.configs.shapes", "repro_torch.configs.zamba2_7b",
                  "repro_torch.configs.hubert_xlarge",
                  "repro_torch.configs.llama_3_2_vision_90b", "repro_torch.configs.minicpm_2b",
                  "repro_torch.configs.yi_9b", "repro_torch.configs.llama3_405b",
                  "repro_torch.kernels._math", "repro_torch.models.layers",
                  "repro_torch.models.attention", "repro_torch.models.hybrid",
                  "repro_torch.models.encoder", "repro_torch.models.vlm",
                  "repro_torch.models.model", "repro_torch.examples.quickstart",
                  "repro_torch.examples.federated_llm")

# The modules slice 8 added or extended.
SLICE8_MODULES = ("repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
                  "repro_torch.core.adaptive", "repro_torch.fed.clock",
                  "repro_torch.fed.availability", "repro_torch.fed.async_engine",
                  "repro_torch.fed.engine", "repro_torch.fed.hierarchy", "repro_torch.fed")


# One fresh interpreter loads torch and numpy, then forks a child for each
# module; the child imports that module alone and reports what of JAX and the
# reference package sys.modules then holds. One interpreter start-up (most of
# the cost, importing torch) serves every module.
_FORK_EACH = """
import json, os, sys
import numpy, torch
found = {}
for module in sys.argv[1:]:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            __import__(module)
            bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
        except BaseException as e:
            bad = ['import failed: ' + repr(e)]
        os.write(w, json.dumps(bad).encode())
        os._exit(0)
    os.close(w)
    out = b''
    while chunk := os.read(r, 1 << 16):
        out += chunk
    os.close(r)
    os.waitpid(pid, 0)
    found[module] = json.loads(out)
print(json.dumps(found))
"""


@pytest.fixture(scope="module")
def loaded_by_import():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _FORK_EACH, *SLICE6_MODULES,
                           *SLICE7_MODULES, *SLICE8_MODULES],
                          capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", SLICE6_MODULES)
def test_slice6_module_loads_no_jax_and_no_reference(module, loaded_by_import):
    """Imported alone in a fresh process (a child forked from an interpreter
    that has loaded only torch and numpy), the module pulls in neither JAX
    nor the reference package (the scan above checks import statements;
    this checks what an import actually loads)."""
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert path.exists()
    assert loaded_by_import[module] == [], loaded_by_import[module]


@pytest.mark.parametrize("module", SLICE7_MODULES)
def test_slice7_module_loads_no_jax_and_no_reference(module, loaded_by_import):
    """As for slice 6: imported alone in a fresh process, the module pulls in
    neither JAX nor the reference package."""
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert path.exists() or (path.parent / path.stem / "__init__.py").exists()
    assert loaded_by_import[module] == [], loaded_by_import[module]


@pytest.mark.parametrize("module", SLICE8_MODULES)
def test_slice8_module_loads_no_jax_and_no_reference(module, loaded_by_import):
    """As for slices 6 and 7: imported alone in a fresh process, the module
    pulls in neither JAX nor the reference package."""
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert path.exists() or (path.parent / path.stem / "__init__.py").exists()
    assert loaded_by_import[module] == [], loaded_by_import[module]
