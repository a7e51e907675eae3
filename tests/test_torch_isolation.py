"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                        "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.core.chunk_stream" in mods
    assert "repro_torch.kernels.hash_accum_spgemm" in mods
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['jaxlib'] = None",
        "sys.modules['repro'] = None",
        "import importlib",
        f"for name in {mods!r}:",
        "    importlib.import_module(name)",
        "import chip_smoke",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')"
        " and sys.modules[m] is not None)",
        "assert not bad, bad",
        "print('ok', len(sys.modules))",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_source_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        hit = _FORBIDDEN.search(text)
        assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0).strip()}"
        assert "import jax" not in text and "from repro." not in text, path


def test_kernel_sources_are_cuda_for_sm90a():
    from repro_torch.kernels import _build

    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces:" in src and "Bound on this card" in src, name
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # the build directory is one .gitignore lists
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_launch_timer_is_active_only_inside_its_block():
    from repro_torch.kernels import _build

    assert _build._TIMER is None
    with _build.LaunchTimer() as timer:
        assert _build._TIMER is timer and timer.events == []
    assert _build._TIMER is None
    try:
        with _build.LaunchTimer():
            raise KeyError("inside")
    except KeyError:
        pass
    assert _build._TIMER is None


def test_ptxas_resources_per_kernel():
    """The build log's per-kernel registers, spills and shared memory, parsed
    from ``-Xptxas -v`` output as nvcc 12 prints it."""
    from repro_torch.kernels import _build

    text = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 98 registers, used 1 barriers, 8704 bytes smem",
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers",
    ])
    assert _build.ptxas_resources(text) == {
        "_Z3fooPf": {"registers": 98, "spill_stores": 0, "spill_loads": 0,
                     "smem_bytes": 8704},
        "_Z3barv": {"registers": 40, "spill_stores": 4, "spill_loads": 12,
                    "smem_bytes": 0},
    }
