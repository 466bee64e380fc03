"""The port stands alone: ``mxtpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, nothing of the port builds or loads a
kernel at import, and a kernel's library is named after its sources."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mxtpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_tp_world.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_mxtpu(path):
    bad = {"jax", "jaxlib", "mxtpu"} & set(_imported_roots(path))
    assert not bad, "%s imports %s" % (path.relative_to(ROOT), sorted(bad))


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import mxtpu_torch\n"
        "import mxtpu_torch.parallel.serving, mxtpu_torch.models.convert\n"
        "import mxtpu_torch.resilience, mxtpu_torch.resilience.faults\n"
        "import mxtpu_torch.resilience.checkpoint, mxtpu_torch.observability\n"
        "import mxtpu_torch.parallel.trainer, mxtpu_torch.gluon.loss\n"
        "import mxtpu_torch.optimizer\n"
        "import mxtpu_torch.ops.paged_attention as pa\n"
        "import mxtpu_torch.ops.prefill_attention as pf\n"
        "import mxtpu_torch.ops.flash_attention as fa\n"
        "import mxtpu_torch.ops.conv_bwd as cb, mxtpu_torch.ops.nn\n"
        "import mxtpu_torch.ops.linear as lin\n"
        "import mxtpu_torch.ops.quantized as qz\n"
        "import mxtpu_torch.contrib.quantization\n"
        "import mxtpu_torch.gluon.nn, mxtpu_torch.gluon.trainer\n"
        "import mxtpu_torch.gluon.model_zoo.vision, mxtpu_torch.initializer\n"
        "from mxtpu_torch.ops import _build\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'mxtpu')]\n"
        "assert not bad, bad\n"
        "assert not _build._LOADED and not pa._FNS and not pf._FNS\n"
        "import mxtpu_torch.ops.contrib as contrib\n"
        "assert not fa._FNS and not cb._FNS and not lin._FNS\n"
        "assert not qz._FNS\n"
        "assert not contrib._FNS\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_library_name_follows_its_sources(tmp_path, monkeypatch):
    """A library is named by a digest of its ``.cu`` and every ``.cuh``,
    so an edited kernel (or shared header) rebuilds instead of loading a
    stale library."""
    import shutil

    from mxtpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    first = {n: _build._library(n) for n in _build.SOURCES}
    assert all(p.parent == _build.BUILD_DIR for p in first.values())
    assert len(set(first.values())) == len(_build.SOURCES)
    with open(src / "paged_common.cuh", "a") as f:
        f.write("\n// edited\n")
    for n in _build.SOURCES:
        assert _build._library(n) != first[n]


def test_building_without_nvcc_raises(monkeypatch):
    from mxtpu_torch.base import MXTPUError
    from mxtpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(MXTPUError, match="nvcc"):
        _build.nvcc_path()
