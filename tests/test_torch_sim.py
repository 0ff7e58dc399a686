"""The port's pricing layer (``repro_torch.roofline``, ``repro_torch.sim``)
against the reference's (``repro.roofline``, ``repro.sim``).

* The hardware entries: ``H100`` holds the H100 SXM5 data sheet's numbers,
  ``H200`` equals the reference's, and the port carries no TPU entry.
* ``CostModel``'s every method on a grid of inputs for llama-70b, qwen-32b,
  reduced qwen3-8b, the paper's MoE models qwen-30b-a3b and
  llama4-17b-16e, and two synthetic configurations that reach the MoE,
  MLA and sliding-window branches (full and reduced), under the reference's ``V5E`` and ``H200`` (handed
  to the port as ``Hardware(**asdict(...))``) and the port's ``H100``
  (handed to the reference the same way), with both attention pricings:
  the results are equal (the same float arithmetic in the same order).
* The traces, ``simulate``, ``ServeSim`` under every option (serialized,
  prefix cache, speculation, faults, deadlines, shed policies, replicas
  and routing), ``simulate_elastic`` and ``reshard_policy_ab``: the result
  dicts and the observability dumps equal the reference's.
* The port's runs of the reference's own checks: ``tests/test_sim.py``,
  the simulator cases of ``tests/test_ft_faults.py``, ``tests/test_obs.py``
  (the shared schema and the registry views), ``tests/test_spec_decode.py``
  (the speculative mirror and verify pricing), ``tests/test_cluster.py``
  (replica routing) and ``tests/test_workprop_attention.py`` (the two
  attention pricings), at the port's default ``H100`` unless they name
  hardware.
"""
import dataclasses
import itertools
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import sim as jsim  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.ft import Fault as JaxFault  # noqa: E402
from repro.ft import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.roofline import terms as jterms  # noqa: E402
from repro.sim import costmodel as jcm  # noqa: E402
from repro.sim import simulator as jsimulator  # noqa: E402
from repro_torch import roofline  # noqa: E402
from repro_torch.configs import (MLAConfig, ModelConfig,  # noqa: E402
                                 MoEConfig, get_config)
from repro_torch.ft import Fault, FaultPlan  # noqa: E402
from repro_torch.obs import build_report, schema  # noqa: E402
from repro_torch.roofline.terms import H100, H200, Hardware  # noqa: E402
from repro_torch.sim import (CostModel, ServeSim, SimRequest,  # noqa: E402
                             Strategy, azure_code_trace, bursty_trace,
                             mooncake_conv_trace, reshard_policy_ab,
                             simulate, simulate_elastic, uniform_trace)
from repro_torch.sim.costmodel import _pow2  # noqa: E402

# ---------------------------------------------------------------------------
# the two sides, on the same configuration and hardware numbers
# ---------------------------------------------------------------------------
# Synthetic configurations (no architecture the port serves sets these
# fields yet) that reach the MoE, MLA and sliding-window branches of
# ``active_params``, ``reduced`` and the cost model.
SYNTH = {
    "synth-moe-local": dict(
        family="moe", num_layers=8, d_model=2048, num_heads=16,
        num_kv_heads=4, d_ff=5632, vocab_size=32000,
        layer_pattern=("local", "moe"), local_window=1024,
        moe=dict(num_experts=16, top_k=2, d_ff_expert=1408,
                 num_shared_experts=2)),
    "synth-mla-moe": dict(
        family="moe", num_layers=6, d_model=2048, num_heads=16,
        num_kv_heads=16, d_ff=10944, vocab_size=102400,
        layer_pattern=("attn", "moe", "moe"),
        mla=dict(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                 qk_rope_head_dim=64, v_head_dim=128),
        moe=dict(num_experts=64, top_k=6, d_ff_expert=1408,
                 num_shared_experts=2, d_ff_shared=2816)),
}
# the paper's two MoE models (Table 4), which the port serves
MOE_ARCHS = ("qwen-30b-a3b", "llama4-17b-16e")
ARCHS = ("llama-70b", "qwen-32b", "qwen3-8b-reduced") + tuple(SYNTH) + \
    tuple(f"{a}-reduced" for a in SYNTH) + MOE_ARCHS
HWS = ("v5e", "h200", "h100")


def _synth(name):
    """(port config, reference config) of the synthetic ``name``."""
    kw = dict(SYNTH[name], name=name)
    mla, moe = kw.pop("mla", None), kw.pop("moe", None)
    return (ModelConfig(**kw, mla=mla and MLAConfig(**mla),
                        moe=moe and MoEConfig(**moe)),
            jbase.ModelConfig(**kw, mla=mla and jbase.MLAConfig(**mla),
                              moe=moe and jbase.MoEConfig(**moe)))


def _cfgs(arch):
    """(port config, reference config) of ``arch``."""
    name = arch.removesuffix("-reduced")
    p, j = _synth(name) if name in SYNTH else (get_config(name),
                                                jax_get_config(name))
    return (p.reduced(), j.reduced()) if arch != name else (p, j)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a.startswith("synth")])
def test_synthetic_configs_match_reference(arch):
    """The port's fields equal the reference's (the MoE and MLA ones too)
    at full size and as ``reduced()`` cuts them, and so does
    ``active_params()``."""
    p, j = _cfgs(arch)
    for f in dataclasses.fields(p):
        got, want = getattr(p, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(got):
            want = {k: v for k, v in dataclasses.asdict(want).items()
                    if k in dataclasses.asdict(got)}
            got = dataclasses.asdict(got)
        assert got == want, f.name
    assert p.active_params() == j.active_params() < j.num_params()


@pytest.mark.parametrize("arch", MOE_ARCHS + tuple(f"{a}-reduced"
                                                  for a in MOE_ARCHS))
def test_moe_configs_match_reference(arch):
    """The port's qwen-30b-a3b and llama4-17b-16e equal the reference's in
    every field the port has (the MoE ones too, capacity factor, aux
    coefficient and dispatch type included), at full size and reduced, and
    in ``active_params()``; ``num_params()`` counts the port's modules,
    which add the norm scales to the reference's count."""
    p, j = _cfgs(arch)
    for f in dataclasses.fields(p):
        got, want = getattr(p, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(got):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert p.active_params() == j.active_params() < j.num_params()
    norms = p.num_layers * (2 * p.d_model + 2 * p.head_dim * p.qk_norm) \
        + p.d_model
    assert p.num_params() == j.num_params() + norms


def _hws(hw):
    """(port Hardware, reference Hardware) with the same numbers."""
    if hw == "h100":
        return H100, jterms.Hardware(**dataclasses.asdict(H100))
    ref = {"v5e": jterms.V5E, "h200": jterms.H200}[hw]
    return Hardware(**dataclasses.asdict(ref)), ref


def _models(arch, hw, **kw):
    (pc, jc), (ph, jh) = _cfgs(arch), _hws(hw)
    return CostModel(pc, hw=ph, **kw), jcm.CostModel(jc, hw=jh, **kw)


def _js(x):
    return json.dumps(x, sort_keys=True)


# ---------------------------------------------------------------------------
# hardware and roofline
# ---------------------------------------------------------------------------
def test_hardware_entries():
    assert (H100.peak_flops, H100.hbm_bw, H100.ici_bw, H100.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 80 * 2 ** 30)
    assert dataclasses.asdict(H200) == dataclasses.asdict(jterms.H200)
    assert not hasattr(roofline, "V5E")
    assert set(roofline.__all__) == {"Hardware", "roofline_terms", "H100",
                                     "H200"}


@pytest.mark.parametrize("hw", HWS)
def test_roofline_terms_match_reference(hw):
    ph, jh = _hws(hw)
    for f, b, x in itertools.product((0, 1e9, 3e15), (0, 5e8, 7e10),
                                     (0, 1e6, 4e9)):
        assert roofline.roofline_terms(f, b, x, ph) == \
            jterms.roofline_terms(f, b, x, jh)


# ---------------------------------------------------------------------------
# the cost model, method by method
# ---------------------------------------------------------------------------
GRID_TOKENS = [(0, 0), (0, 1), (0, 6), (7, 0), (64, 6), (134, 0),
               (4096, 0), (512, 256), (0, 256)]
GRID_CTX = [1, 100, 4096]
GRID_LENS = [None, [8, 8, 8, 2000], [2048] * 4, [1, 300, 17]]
GRID_STRATS = [(k, n) for k in ("dp", "tp", "sp") for n in (1, 2, 4, 8)]


def _calls(m):
    """Every method of one cost model over the grid, as a list of
    results (floats, tuples)."""
    strat = jcm.Strategy if isinstance(m, jcm.CostModel) else Strategy
    out = [m._weight_bytes(), m._kv_bytes_per_tok(), m.kv_bytes_per_block(),
           m.kv_bytes_per_block(8), m._attn_copy_factor]
    for ctx in GRID_CTX:
        for lens in GRID_LENS:
            out.append(m.attn_ctx_eff(ctx, lens))
            out.append(m.attn_hbm_bytes(lens))
        for n_tok in (1, 64, 4096):
            out.append(m._flops(n_tok, ctx))
    for (k, n), tokens in itertools.product(GRID_STRATS, (1, 64, 4096)):
        out.append(m._comm_bytes(tokens, strat(k, n)))
    for (np_, nd), ctx, lens, (k, n) in itertools.product(
            GRID_TOKENS, GRID_CTX, GRID_LENS, GRID_STRATS):
        for n_spec in (0, 2) if nd >= 2 else (0,):
            out.append(m.iteration_time(np_, nd, ctx, strat(k, n),
                                        ctx_lens=lens, n_spec=n_spec))
    for (np_, nd), ctx, lens, n in itertools.product(
            GRID_TOKENS, GRID_CTX, GRID_LENS, (1, 4, 8)):
        out.append(m.best_config(np_, nd, ctx, n, ctx_lens=lens))
    for k, acc, ctx, (s, n) in itertools.product(
            (0, 1, 4), (0.0, 1.5, 4.0), GRID_CTX, GRID_STRATS[::3]):
        out.append(m.verify_speedup(k, acc, ctx, strat(s, n)))
    return out


@pytest.mark.parametrize("work_prop", [True, False],
                         ids=["work-prop", "gather"])
@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("arch", ARCHS)
def test_costmodel_matches_reference(arch, hw, work_prop):
    port, ref = _models(arch, hw, attn_work_prop=work_prop)
    got, want = _calls(port), _calls(ref)
    assert len(got) == len(want) > 2000
    assert got == want


def test_costmodel_defaults():
    """The port prices at the H100 by default, with the reference's model
    parameters (overhead, achievable fractions)."""
    m = CostModel(get_config("qwen-32b"))
    j = jcm.CostModel(jax_get_config("qwen-32b"))
    assert m.hw == H100
    for k in ("overhead_s", "mfu", "bw_eff", "ici_eff", "attn_work_prop",
              "GATHER_COPY_FACTOR", "COLL_LATENCY"):
        assert getattr(m, k) == getattr(j, k), k
    # the weight-read bound of qwen-32b at one H100: 65.52 GB of bf16
    assert m._weight_bytes() == 2 * 32_761_446_400
    assert m._weight_bytes() / H100.hbm_bw == pytest.approx(0.019559, 1e-4)


# ---------------------------------------------------------------------------
# traces and the simulator against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gen", ["uniform_trace", "bursty_trace",
                                 "azure_code_trace", "mooncake_conv_trace"])
def test_traces_match_reference(gen):
    from repro_torch import sim as psim
    for seed in (0, 3):
        assert getattr(psim, gen)(seed=seed) == getattr(jsim, gen)(seed=seed)


def _prefix_trace(n=12):
    """Requests annotated with two shared prefixes, arrivals 50 ms apart."""
    return [(0.05 * i, 256 + 32 * (i % 4), 16 + i, i % 2, 128 + 64 * (i % 2))
            for i in range(n)]


@pytest.mark.parametrize("strategy", ["dp", "tp", "sp", "shift"])
@pytest.mark.parametrize("arch,hw", [("qwen-32b", "h100"),
                                     ("llama-70b", "h200"),
                                     ("qwen3-8b-reduced", "v5e"),
                                     ("qwen-30b-a3b", "h100"),
                                     ("llama4-17b-16e", "h200")])
def test_simulate_matches_reference(arch, hw, strategy):
    (pc, jc), (ph, jh) = _cfgs(arch), _hws(hw)
    tr = uniform_trace(n=24, rate=3.0, n_in=1024, n_out=48)
    got = simulate(pc, tr, strategy, hw=ph, n_chips=8)
    want = jsim.simulate(jc, tr, strategy, hw=jh, n_chips=8)
    assert _js(got) == _js(want)
    assert got["n_done"] == 24


def test_simulate_bursty_matches_reference_at_the_default_hardware():
    """``hw=None`` prices at H100 in the port, so the reference gets the
    port's numbers explicitly."""
    got = simulate(get_config("qwen-32b"), bursty_trace(), "shift")
    want = jsim.simulate(jax_get_config("qwen-32b"), jsim.bursty_trace(),
                         "shift", hw=_hws("h100")[1])
    assert _js(got) == _js(want)


def _plans(kind):
    """(port FaultPlan, reference FaultPlan) of one fault case."""
    spec = {"forward": [(1, "forward", {"kind": "nan"}),
                        (5, "forward", {"kind": "raise"})],
            "alloc": [(2, "alloc", {}), (4, "alloc", {})],
            "route": [(2, "route", {"row": 0}), (9, "route", {"row": 1})]}[kind]
    return (FaultPlan([Fault(s, seam, **kw) for s, seam, kw in spec]),
            JaxFaultPlan([JaxFault(s, seam, **kw) for s, seam, kw in spec]))


SIM_OPTIONS = {
    "serialized": dict(mixed=False),
    "prefix": dict(prefix_cache=True, kv_capacity_tokens=4096),
    "spec": dict(spec_k=4),
    "prefix-spec-affinity": dict(prefix_cache=True, spec_k=3, replicas=2,
                                 routing="affinity"),
    "round-robin": dict(replicas=3, routing="round-robin"),
    "least-loaded-prefix": dict(replicas=2, prefix_cache=True),
    "deadline": dict(deadline_s=0.05, max_concurrent=2),
    "reject-newest": dict(max_queue=2, max_concurrent=1),
    "evict-longest-queued": dict(max_queue=2, max_concurrent=1,
                                 shed_policy="evict-longest-queued"),
    "faults-forward": dict(faults="forward", quarantine_after=2),
    "faults-alloc": dict(faults="alloc"),
    "faults-route": dict(faults="route", replicas=2),
    "small-pool": dict(kv_capacity_tokens=1024, kv_block_size=8,
                       prefill_chunk=256),
}


def _sim_pair(opts, strategy="shift"):
    """The port's and the reference's ``ServeSim`` with ``opts`` over the
    prefix trace, run; faults are built per side."""
    port_cm, ref_cm = _models("qwen-32b", "h100")
    sims = []
    for cm, cls, req, plan in ((port_cm, ServeSim, SimRequest, 0),
                               (ref_cm, jsimulator.ServeSim,
                                jsimulator.SimRequest, 1)):
        kw = dict(opts)
        if "faults" in kw:
            kw["faults"] = _plans(kw["faults"])[plan]
        sim = cls(cm, strategy, n_chips=8, **kw)
        reqs = [req(i, t, ni, no, prefix_id=pid, prefix_len=pl)
                for i, (t, ni, no, pid, pl) in enumerate(_prefix_trace())]
        sim.run(reqs)
        sims.append((sim, reqs))
    return sims


def _outcome(sim, reqs):
    return {"requests": [(r.rid, r.start, r.first_token, r.finish,
                          r.finish_reason, r.prefilled, r.decoded,
                          r.shared_blocks, r.fail_count) for r in reqs],
            "iterations": sim.iterations, "starved": sim.starved_steps,
            "saved": sim.prefill_tokens_saved,
            "evictions": sim.prefix_evictions,
            "shared_peak": sim.shared_blocks_peak,
            "step_count": sim.step_count, "kv_cap": sim.kv_cap,
            "trace_tokens": sim.trace_tokens,
            "dump": sim.obs.dump()}


@pytest.mark.parametrize("opts", list(SIM_OPTIONS))
def test_servesim_matches_reference(opts):
    (port, preqs), (ref, rreqs) = _sim_pair(SIM_OPTIONS[opts])
    got, want = _outcome(port, preqs), _outcome(ref, rreqs)
    assert _js(got) == _js(want)
    assert got["iterations"] > 0


def _bimodal_trace():
    # a quiet 10s window (~130 tok/s offered) then a burst (~3700 tok/s)
    low = [(float(i), 128, 32) for i in range(8)]
    high = [(10.0 + 0.1 * i, 2048, 256) for i in range(16)]
    return low + high


@pytest.mark.parametrize("hw", ["h200", "h100"])
def test_elastic_matches_reference(hw):
    ph, jh = _hws(hw)
    for start in (None, "dp"):
        got = simulate_elastic(get_config("llama-70b"), _bimodal_trace(),
                               hw=ph, start_strategy=start)
        want = jsim.simulate_elastic(jax_get_config("llama-70b"),
                                     _bimodal_trace(), hw=jh,
                                     start_strategy=start)
        assert _js(got) == _js(want)
    got = reshard_policy_ab(get_config("llama-70b"), _bimodal_trace(), hw=ph,
                            window_s=5.0, high_load_tok_s=1500.0)
    want = jsim.reshard_policy_ab(jax_get_config("llama-70b"),
                                  _bimodal_trace(), hw=jh, window_s=5.0,
                                  high_load_tok_s=1500.0)
    assert _js(got) == _js(want)


# ---------------------------------------------------------------------------
# the reference's own checks on the port (tests/test_sim.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cm():
    return CostModel(get_config("llama-70b"), hw=H200)


def test_table1_ttft_ordering(cm):
    """TTFT: SP best, DP worst (paper Table 1)."""
    t = {s: cm.iteration_time(4096, 0, 4096, Strategy(s, 8))
         for s in ("dp", "tp", "sp")}
    assert t["sp"] < t["tp"] < t["dp"]


def test_table1_tpot_ordering(cm):
    """TPOT (low traffic): TP best; SP ~ DP (weights replicated)."""
    t = {s: cm.iteration_time(0, 1, 4096, Strategy(s, 8))
         for s in ("dp", "tp", "sp")}
    assert t["tp"] < t["sp"] and t["tp"] < t["dp"]
    assert abs(t["sp"] - t["dp"]) / t["dp"] < 0.25


def test_comm_volume_scaling(cm):
    """Paper Table 2: TP comm/compute grows with degree; SP stays ~const."""
    r2 = cm._comm_bytes(4096, Strategy("tp", 2)) / \
        cm._comm_bytes(4096, Strategy("sp", 2))
    r8 = cm._comm_bytes(4096, Strategy("tp", 8)) / \
        cm._comm_bytes(4096, Strategy("sp", 8))
    assert r8 > r2 > 1


def test_shift_is_argmin(cm):
    for (np_, nd, ctx) in [(4096, 0, 4096), (0, 1, 4096), (0, 256, 8192)]:
        kind, t = cm.best_config(np_, nd, ctx, 8)
        t_sp = cm.iteration_time(np_, nd, ctx, Strategy("sp", 8))
        t_tp = cm.iteration_time(np_, nd, ctx, Strategy("tp", 8))
        assert t == min(t_sp, t_tp)


@pytest.mark.parametrize("hw", [H200, H100], ids=["h200", "h100"])
def test_bursty_reproduces_table5(hw):
    """Paper Table 5 on llama-70b: shift ~lowest TTFT and TPOT; peak
    throughput well above TP, at most DP's. Also at the H100's numbers."""
    cfg = get_config("llama-70b")
    res = {s: simulate(cfg, bursty_trace(), s, hw=hw)
           for s in ("dp", "tp", "sp", "shift")}
    assert res["shift"]["tpot_p50_ms"] <= res["dp"]["tpot_p50_ms"]
    assert res["shift"]["ttft_p50_ms"] <= res["tp"]["ttft_p50_ms"]
    assert res["shift"]["peak_tput_tok_s"] >= \
        1.2 * res["tp"]["peak_tput_tok_s"]
    assert res["dp"]["peak_tput_tok_s"] >= res["shift"]["peak_tput_tok_s"]


def test_sim_deterministic():
    cfg = get_config("qwen-32b")
    tr = uniform_trace(n=32, rate=4.0)
    assert simulate(cfg, tr, "shift", hw=H200) == \
        simulate(cfg, tr, "shift", hw=H200)


def test_elastic_switches_with_load_and_charges_pause():
    cfg = get_config("llama-70b")
    res = simulate_elastic(cfg, _bimodal_trace(), hw=H200, window_s=10.0,
                           high_load_tok_s=2000.0, reshard_pause_s=0.25)
    assert res["window_strategies"] == ["tp", "dp"]
    assert res["reshards"] == 1
    assert res["reshard_pause_s"] == pytest.approx(0.25)
    assert res["n_done"] == 24
    # starting from the wrong deployment costs one more reshard
    res2 = simulate_elastic(cfg, _bimodal_trace(), hw=H200, window_s=10.0,
                            high_load_tok_s=2000.0, start_strategy="dp")
    assert res2["reshards"] == 2


def test_reshard_policy_ab_compares_static_deployments():
    cfg = get_config("llama-70b")
    ab = reshard_policy_ab(cfg, _bimodal_trace(), hw=H200, window_s=10.0,
                           high_load_tok_s=2000.0)
    assert set(ab) == {"elastic", "static_dp", "static_tp"}
    assert ab["elastic"]["n_done"] == ab["static_dp"]["n_done"] \
        == ab["static_tp"]["n_done"] == 24
    assert ab == reshard_policy_ab(cfg, _bimodal_trace(), hw=H200,
                                   window_s=10.0, high_load_tok_s=2000.0)


# ---------------------------------------------------------------------------
# the simulator's fault vocabulary (tests/test_ft_faults.py)
# ---------------------------------------------------------------------------
def _fault_cases():
    """name -> (trace, kwargs, plan spec or None)."""
    return {
        "no-faults": ([(0.0, 64, 8), (0.1, 64, 8)], {}, None),
        "deadline": ([(0.0, 64, 4), (0.0, 64, 4096)],
                     dict(deadline_s=1e-6, max_concurrent=1), None),
        "bounded-queue": ([(0.0, 64, 256)] * 6,
                          dict(max_queue=1, max_concurrent=1), None),
        "forward-retry": ([(0.0, 64, 8)], {}, [(1, "forward", "nan")]),
        "forward-quarantine": ([(0.0, 64, 8)], dict(quarantine_after=3),
                               [(s, "forward", "raise")
                                for s in range(200)]),
        "route": ([(0.0, 64, 8), (0.0, 48, 8)], {}, [(2, "route", None)]),
    }


def _fault_run(name, port=True, hw=None):
    trace, kw, spec = _fault_cases()[name]
    kw = dict(kw)
    if spec is not None:
        F, P = (Fault, FaultPlan) if port else (JaxFault, JaxFaultPlan)
        kw["faults"] = P([F(s, seam, kind=k) if k else F(s, seam, row=0)
                          for s, seam, k in spec])
    if port:
        out = simulate(get_config("qwen3-8b").reduced(), trace, "tp",
                       n_chips=4, hw=hw, **kw)
    else:
        out = jsim.simulate(jax_get_config("qwen3-8b").reduced(), trace,
                            "tp", n_chips=4, hw=hw, **kw)
    return out, kw.get("faults")


@pytest.mark.parametrize("name", list(_fault_cases()))
def test_sim_fault_cases(name):
    """The reference's checks of each case on the port (default H100), and
    the port's result dict equal to the reference's at the V5E's numbers."""
    out, plan = _fault_run(name)
    if name == "no-faults":
        assert out["outcomes"] == {"ok": 2} and out["n_done"] == 2
    elif name == "deadline":
        assert out["outcomes"].get("timeout", 0) >= 1 and out["n_done"] < 2
    elif name == "bounded-queue":
        assert out["outcomes"].get("shed", 0) >= 1
        assert sum(out["outcomes"].values()) == 6
    elif name == "forward-retry":
        assert out["outcomes"] == {"ok": 1} and plan.fired
    elif name == "forward-quarantine":
        assert out["outcomes"] == {"failed": 1}
    else:
        assert out["outcomes"] == {"ok": 2}
    ph, jh = _hws("v5e")
    got, _ = _fault_run(name, hw=ph)
    want, _ = _fault_run(name, port=False, hw=jh)
    assert _js(got) == _js(want)


# ---------------------------------------------------------------------------
# one schema for the engine and the simulator (tests/test_obs.py)
# ---------------------------------------------------------------------------
def _run_sim():
    sim = ServeSim(CostModel(get_config("qwen3-8b"), hw=H200), "shift",
                   n_chips=8, prefix_cache=True)
    reqs = [SimRequest(i, 0.05 * i, 256 + 64 * (i % 3), 16,
                       prefix_id=0, prefix_len=128) for i in range(8)]
    sim.run(reqs)
    return sim


def _assert_within_schema(obs):
    names = obs.registry.emitted_names()
    assert names["counters"] <= set(schema.COUNTERS), \
        names["counters"] - set(schema.COUNTERS)
    assert names["gauges"] <= set(schema.GAUGES)
    assert names["histograms"] <= set(schema.HISTOGRAMS)
    assert {e["kind"] for e in obs.events.events} <= set(schema.EVENTS)
    for r in obs.step_records:
        schema.check_step_record(r)
    return names


def test_engine_and_sim_share_one_schema():
    """Both of the port's emitters stay within the declared vocabulary and
    share the core counters, so that their dumps feed the same report."""
    from repro_torch.engine import EngineConfig, Request, ShiftEngine
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.models import Model
    model = Model(get_config("qwen3-8b").reduced(), device="cpu",
                  dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    c = itertools.count()
    eng = ShiftEngine(model, EngineConfig(
        max_slots=4, s_max=64, prefill_chunk=8, threshold=4,
        prefix=PrefixConfig(enabled=True)), now=lambda: next(c) * 1e-3)
    for i in range(3):
        eng.submit(Request(i, list(range(1, 12 + 3 * i)), max_new_tokens=5))
    eng.run_until_idle()
    sim = _run_sim()
    n_eng = _assert_within_schema(eng.obs)
    n_sim = _assert_within_schema(sim.obs)
    core = set(schema.CORE_COUNTERS)
    assert core <= n_eng["counters"], core - n_eng["counters"]
    assert core <= n_sim["counters"], core - n_sim["counters"]
    r_eng = build_report(eng.obs.dump())
    r_sim = build_report(sim.obs.dump())
    assert set(r_eng) == set(r_sim)
    assert set(r_eng["latency"]) == set(r_sim["latency"])
    assert r_sim["requests"]["finished"] == 8


def test_sim_legacy_counters_are_registry_views():
    sim = _run_sim()
    reg = sim.obs.registry
    assert sim.iterations == reg.counter_total("steps_total") > 0
    assert sim.prefill_tokens_saved \
        == reg.counter_total("prefix_tokens_saved_total") > 0
    assert sim.starved_steps \
        == reg.counter_total("decode_starved_steps_total")
    assert sim.shared_blocks_peak \
        == reg.gauge_value("shared_blocks_peak") > 0
    # sim steps label with the engine's config vocabulary (base/shift)
    assert {r["config"] for r in sim.obs.step_records} <= {"base", "shift"}


# ---------------------------------------------------------------------------
# the speculative mirror and verify pricing (tests/test_spec_decode.py)
# ---------------------------------------------------------------------------
def test_sim_spec_ab_fewer_steps_same_tokens():
    cm = CostModel(get_config("llama-70b"), hw=H200)

    def run(spec_k):
        sim = ServeSim(cm, "shift", n_chips=8, spec_k=spec_k)
        sim.run([SimRequest(rid=i, arrival=0.0, n_in=64, n_out=32)
                 for i in range(4)])
        return sim

    s0, s4 = run(0), run(4)
    ct = lambda s, k: s.obs.registry.counter_total(k)  # noqa: E731
    assert s4.step_count < s0.step_count
    assert ct(s4, "tokens_decode_total") == ct(s0, "tokens_decode_total")
    assert ct(s4, "requests_finished_total") == 4
    prop, acc = ct(s4, "spec_proposed_total"), ct(s4, "spec_accepted_total")
    assert 0 < acc <= prop
    s4b = run(4)
    assert s4b.step_count == s4.step_count
    assert ct(s4b, "spec_accepted_total") == acc


def test_sim_spec_requires_mixed():
    cm = CostModel(get_config("llama-70b"), hw=H200)
    with pytest.raises(ValueError):
        ServeSim(cm, "shift", n_chips=8, mixed=False, spec_k=4)


def test_costmodel_prices_verify_cheaper_than_serial_decode():
    """k draft queries share their row's KV read: a (1+k)-query verify
    pass costs less than 1+k one-token iterations, and the modeled speedup
    grows with acceptance."""
    cm = CostModel(get_config("llama-70b"), hw=H200)
    strat = Strategy("tp", 8)
    k = 4
    t_plain = cm.iteration_time(0, 1, 4096, strat)
    t_verify = cm.iteration_time(0, 1 + k, 4096, strat, n_spec=k)
    assert t_verify < (1 + k) * t_plain
    assert t_verify <= cm.iteration_time(0, 1 + k, 4096, strat)
    s_none = cm.verify_speedup(k, 0.0, 4096, strat)
    s_full = cm.verify_speedup(k, float(k), 4096, strat)
    assert s_full > s_none and s_full > 1.0
    assert cm.verify_speedup(0, 2.0, 4096, strat) == 1.0


# ---------------------------------------------------------------------------
# replica routing (tests/test_cluster.py)
# ---------------------------------------------------------------------------
def test_sim_multi_replica_routing_ab():
    cfg = get_config("qwen3-8b")

    def run(routing):
        sim = ServeSim(CostModel(cfg, hw=H200), "shift", n_chips=8,
                       prefill_chunk=512, prefix_cache=True, replicas=2,
                       routing=routing)
        sim.run([SimRequest(i, 0.05 * i, 256 + 64, 16, prefix_id=0,
                            prefix_len=256) for i in range(8)])
        return sim

    aff, rr, ll = run("affinity"), run("round-robin"), run("least-loaded")
    assert len(aff.reps) == 2
    # affinity: the shared span prefills once cluster-wide (7 of 8 reuse);
    # round-robin pays it once per replica (6 of 8 reuse)
    assert aff.prefill_tokens_saved == 7 * 256
    assert rr.prefill_tokens_saved == 6 * 256
    assert ll.prefill_tokens_saved >= rr.prefill_tokens_saved
    with pytest.raises(ValueError):
        ServeSim(CostModel(cfg, hw=H200), "shift", routing="teleport")


# ---------------------------------------------------------------------------
# the two attention pricings (tests/test_workprop_attention.py)
# ---------------------------------------------------------------------------
def test_costmodel_work_prop_vs_gather_pricing():
    """Skewed batches cost the sum of their occupancies on the kernel path
    but rows x pow2(max) on the gather path."""
    cfg = get_config("llama-70b")
    wp = CostModel(cfg, attn_work_prop=True)
    ga = CostModel(cfg, attn_work_prop=False)
    skew = [8, 8, 8, 2000]
    t_wp = wp.iteration_time(0, 4, 0, Strategy("tp", 8), ctx_lens=skew)
    t_ga = ga.iteration_time(0, 4, 0, Strategy("tp", 8), ctx_lens=skew)
    assert t_wp < t_ga
    assert wp.attn_hbm_bytes(skew) == pytest.approx(
        wp._kv_bytes_per_tok() * sum(skew))
    assert ga.attn_hbm_bytes(skew) == pytest.approx(
        ga._kv_bytes_per_tok() * 4 * _pow2(2000) * ga.GATHER_COPY_FACTOR)
    assert wp.iteration_time(0, 4, 0, Strategy("tp", 8),
                             ctx_lens=[2048] * 4) <= t_ga
