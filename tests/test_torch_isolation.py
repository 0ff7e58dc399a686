"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor the reference package ``repro``, and the port's entry points
run on the card unless asked for the CPU.

The prefix matters: ``repro_torch`` starts with ``repro``, so the checks
look for the module ``repro`` and its submodules ``repro.*``, not for the
string."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)",
                        re.MULTILINE)


def _modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    assert "repro_torch.engine.deployment" in _modules()
    assert {"repro_torch.core.ulysses", "repro_torch.parallel.collectives",
            "repro_torch.launch.mesh"} <= set(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'repro') or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_name_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    hits = [(str(f.relative_to(ROOT)), m.group(0).strip())
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits
    # the pattern does catch what it is for
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.cache import x")
    assert not _FORBIDDEN.search("from repro_torch.cache import x")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default would run")


def test_entry_points_default_to_cuda(no_card):
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    cfg = get_config("qwen3-8b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ShiftEngine(Model(cfg), EngineConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_engine()
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main([])          # full width: must raise before allocating


@pytest.mark.parametrize("kw", [{"mixed": False},
                                {"paged": False, "mixed": False}],
                         ids=["serialized", "dense"])
def test_serialized_entry_points_default_to_cuda(no_card, kw):
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_engine(**kw)        # full width: raises before allocating
    with pytest.raises(RuntimeError, match="cuda"):
        ShiftEngine(Model(get_config("qwen3-8b").reduced()),
                    EngineConfig(**kw))


def test_mamba2_entry_points_default_to_cuda(no_card):
    """mamba2 through the same entry points: the dense fallback still runs
    on the card unless asked for the CPU."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_engine("mamba2-1.3b")   # full width: raises at once
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "mamba2-1.3b"])
    with pytest.raises(RuntimeError, match="cuda"):
        ShiftEngine(Model(get_config("mamba2-1.3b").reduced()),
                    EngineConfig())


def test_cpu_runs_mamba2_when_asked(capsys):
    """The serve CLI's mamba2 on the CPU: the dense serialized fallback,
    reported with its reason, and the SSD chunk counter listed."""
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
                "--dtype", "fp32", "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "iteration: serialized" in out
    assert "dense cache: 8 slots" in out and "non-pageable" in out
    assert "ssd_chunk=0" in out and "6 tokens in" in out


def test_cpu_runs_when_asked():
    from repro_torch.launch import serve
    eng = serve.build_engine(reduced=True, device="cpu", dtype=torch.float32)
    reqs = serve.workload(2, 3)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert [len(r.generated) for r in reqs] == [3, 3]
    assert eng.kv.num_free_blocks == eng.kv.num_blocks - 1


@pytest.mark.parametrize("kw", [{"mixed": False},
                                {"paged": False, "mixed": False}],
                         ids=["serialized", "dense"])
def test_cpu_runs_serialized_when_asked(kw, capsys):
    from repro_torch.launch import serve
    eng = serve.build_engine(reduced=True, device="cpu", dtype=torch.float32,
                             **kw)
    reqs = serve.workload(2, 3)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert [len(r.generated) for r in reqs] == [3, 3]
    if eng.paged:
        assert eng.kv.num_free_blocks == eng.kv.num_blocks - 1
    else:
        assert eng.kv is None and eng.model.cache is not None
    serve.print_summary(eng)            # works with or without a pool
    out = capsys.readouterr().out
    assert ("paged cache" in out) == eng.paged
    assert "eager steps on the CPU" in out
    assert "flash_attention=0" in out and "decode_attention=0" in out
