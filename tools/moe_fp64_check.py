"""Is a gap between the port's and the reference's fp32 MoE training
rounding, or a fault? Runs the comparison of
``tests/test_torch_train_moe_pod.py`` with every fp32 cast of both
packages made fp64.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_fp64_check.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_fp64_check.py \\
        --arch qwen-30b-a3b --mesh 1 2 2

It copies ``src/`` and ``tests/`` into ``build/fp64/`` (which git
ignores) and there replaces ``jnp.float32``, ``torch.float32`` and
``np.float32`` by their 64-bit types and ``.float()`` by ``.double()``;
then, in that copy, with jax's x64 on and torch's default type fp64, it
holds each rank's loss and gradients of one ``loss_fn`` call to the
reference's per-device ones on the mesh (``ref_on_mesh``), and the
params after three int8 Trainer steps. It prints the worst error of a
gradient against its leaf's largest entry and the worst params error. A
few 1e-13 says the fp32 gap is rounding. CPU only: the ranks are gloo
processes, as in the tests.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SUBS = [(r"jnp\.float32", "jnp.float64"), (r"torch\.float32", "torch.float64"),
        (r"np\.float32", "np.float64"), (r"\.float\(\)", ".double()")]


def make_copy(dest: Path):
    """``src/`` and ``tests/`` under ``dest`` with every fp32 cast fp64."""
    if dest.exists():
        shutil.rmtree(dest)
    for part in ("src", "tests"):
        shutil.copytree(ROOT / part, dest / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for path in dest.rglob("*.py"):
        text = path.read_text()
        for pat, rep in SUBS:
            text = re.sub(pat, rep, text)
        path.write_text(text)


def _grads_job(rank, groups, arch, mesh, state):
    import torch
    import moe_train_common as C
    from repro_torch.convert import shard_state
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    torch.set_default_dtype(torch.float64)
    cfg, lay = C.port_cfg(arch), Layout(*mesh)
    m = Model(cfg, device="cpu", dtype=torch.float64, lay=lay, groups=groups)
    m.load_params(shard_state(state, cfg, lay, rank))
    loss, grads = C.loss_and_grads(m)
    m = Model(cfg, device="cpu", dtype=torch.float64, lay=lay, groups=groups)
    m.load_params(shard_state(state, cfg, lay, rank))
    return loss, grads, C.trained(m, "int8")["params"]


def inside(arch: str, mesh):
    """The comparison, run in the fp64 copy."""
    import numpy as np
    import torch
    import moe_train_common as C
    from conftest import make_mesh
    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import run_ranks
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(1)
    dp, sp, tp = mesh
    ranks = run_ranks(_grads_job, sp, tp, dp=dp, device="cpu",
                      backend="gloo", timeout_s=600,
                      args=(arch, mesh, C.ref_state(arch)))
    ref = C.ref_on_mesh(arch, make_mesh(tuple(mesh)), ("int8",))
    cfg = C.port_cfg(arch)
    loss_err = grad_err = param_err = 0.0
    for r, (loss, grads, params) in enumerate(ranks):
        loss_err = max(loss_err, abs(loss - ref["loss_True"][r]))
        want = from_jax_params(ref["grads"][r], cfg)
        for name, g in grads.items():
            scale = max(float(np.abs(want[name]).max()), 1e-300)
            grad_err = max(grad_err,
                           float(np.abs(g - want[name]).max()) / scale)
        want = from_jax_params(ref["int8"]["params"][r], cfg)
        for name, p in params.items():
            param_err = max(param_err, float(np.abs(p - want[name]).max()))
    print(f"{arch} on {tuple(mesh)} in fp64: loss within {loss_err:.3g}, "
          f"every gradient within {grad_err:.3g} of its leaf's largest "
          f"entry, the params after three int8 steps within {param_err:.3g}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama4-17b-16e")
    ap.add_argument("--mesh", type=int, nargs=3, default=[2, 2, 2],
                    metavar=("DP", "SP", "TP"))
    ap.add_argument("--inside", action="store_true",
                    help="run the comparison (in the fp64 copy)")
    args = ap.parse_args(argv)
    if args.inside:
        inside(args.arch, args.mesh)
        return 0
    dest = ROOT / "build" / "fp64"
    make_copy(dest)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(dest / "src"),
                                           str(dest / "tests")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tools')!r}); "
            "import moe_fp64_check as M; sys.exit(M.main(sys.argv[1:]))")
    return subprocess.run(
        [sys.executable, "-c", code, "--inside", "--arch", args.arch,
         "--mesh", *map(str, args.mesh)], env=env, cwd=str(dest)).returncode


if __name__ == "__main__":
    sys.exit(main())
