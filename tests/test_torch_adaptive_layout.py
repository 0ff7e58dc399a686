"""The adaptive shift policy on the Shift Parallelism layout: four CPU ranks
of (sp, tp) = (2, 2) over gloo, held to the reference's ``ShiftEngine`` on
its ``mesh122`` under the same policy.

One four-rank job (``launch.mesh.run_ranks``, a module-scoped fixture)
serves the serve CLI's six prompts (8 new tokens each) through the SPMD
engine (base on the grid, shift on its ``to_shift()``, one pool per rank)
under ``AdaptivePolicy(CostModel(cfg), 2, 2)`` at the H100's numbers,
with and without pool pressure, on reduced qwen3-8b at fp32 with the
reference's weights (``test_torch_layout``'s state, cut per rank). Every
rank's streams, per-step configs, config counts and preemptions equal the
reference's, both configs occur, and each step's config is what the
port's policy gives for that step's recorded facts. JAX is imported only
in this process, inside the fixtures.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.core import AdaptivePolicy  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402
from repro_torch.sim import CostModel  # noqa: E402
from test_torch_layout import (MAX_NEW, SP, TIGHT, TP, Reference,  # noqa: E402
                               _cfg, _models, _prompts, _trivial_state)

KWS = {"free": {}, "tight": TIGHT}


def _policy():
    return AdaptivePolicy(CostModel(_cfg()), SP, TP)


def _serve(eng, make):
    reqs = [make(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return reqs


def _facts(rec):
    return (rec["n_tokens"], rec["prefill_tokens"], rec["ctx_tokens"],
            rec["n_rows"], rec["ctx_max"], rec.get("spec_tokens", 0))


def _job(rank, groups, state):
    out = {}
    for name, kw in KWS.items():
        base, shift = _models(_cfg(), state, Layout(sp=SP, tp=TP), groups)
        eng = ShiftEngine(base, EngineConfig(**kw), shift=shift,
                          policy=_policy())
        reqs = _serve(eng, Request)
        out[name] = {"streams": [r.generated for r in reqs],
                     "finish": [r.finish_reason for r in reqs],
                     "configs": [r["config"] for r in eng.step_log],
                     "facts": [_facts(r) for r in eng.step_log
                               if r["config"] is not None],
                     "counts": dict(eng.config_counts),
                     "preempt": eng.preemptions,
                     "free": eng.kv.num_free_blocks,
                     "total": eng.kv.num_blocks}
    return out


@pytest.fixture(scope="module")
def state():
    return _trivial_state()


@pytest.fixture(scope="module")
def ranks(state):
    return mesh.run_ranks(_job, SP, TP, device="cpu", backend="gloo",
                          timeout_s=120, args=(state,))


@pytest.fixture(scope="module")
def reference(mesh122):
    import jax
    import jax.numpy as jnp
    from repro.core.policy import AdaptivePolicy as JaxAdaptive
    from repro.engine import EngineConfig as JaxEngineConfig
    from repro.engine import Request as JaxRequest
    from repro.engine import ShiftEngine as JaxEngine
    from repro.roofline.terms import Hardware as JaxHardware
    from repro.sim.costmodel import CostModel as JaxCostModel
    from repro_torch.roofline import H100
    ref = Reference(mesh122)
    out = {}
    for name, kw in KWS.items():
        pol = JaxAdaptive(JaxCostModel(ref.mb.cfg, hw=JaxHardware(
            **dataclasses.asdict(H100))), SP, TP)
        eng = JaxEngine(ref.mb, ref.ms, jax.tree.map(jnp.asarray, ref.pb),
                        jax.tree.map(jnp.asarray, ref.ps),
                        JaxEngineConfig(**kw), policy=pol)
        reqs = _serve(eng, JaxRequest)
        out[name] = {"streams": [r.generated for r in reqs],
                     "configs": [r["config"] for r in eng.step_log],
                     "counts": dict(eng.config_counts),
                     "preempt": eng.preemptions,
                     "free": eng.kv.num_free_blocks}
    return out


@pytest.mark.parametrize("name", list(KWS))
def test_adaptive_layout_matches_reference(ranks, reference, name):
    want = reference[name]
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["streams"] == want["streams"], f"rank {r}"
        assert got["configs"] == want["configs"], f"rank {r}"
        assert got["counts"] == want["counts"], f"rank {r}"
        assert got["preempt"] == want["preempt"], f"rank {r}"
        assert got["free"] == want["free"] == got["total"] - 1, f"rank {r}"
        assert all(f == "ok" for f in got["finish"])
    counts = ranks[0][name]["counts"]
    assert counts["base"] > 0 and counts["shift"] > 0
    if name == "tight":
        assert ranks[0][name]["preempt"] > 0


@pytest.mark.parametrize("name", list(KWS))
def test_adaptive_layout_configs_follow_the_facts(ranks, name):
    """Each step's config on every rank is what the port's policy gives for
    that step's recorded facts."""
    pol = _policy()
    for res in ranks:
        got = res[name]
        chosen = [c for c in got["configs"] if c is not None]
        assert len(chosen) == len(got["facts"]) > 0
        for config, (n, npf, ctx, rows, cmax, spec) in zip(chosen,
                                                           got["facts"]):
            want = pol.use_base(n, npf, ctx_tokens=ctx, n_rows=rows,
                                ctx_max=cmax, spec_tokens=spec)
            assert config == ("base" if want else "shift")
