"""The port's ``Deployment`` on the CPU against the reference's.

Mirrors ``tests/test_elastic_reshard.py::test_engine_delegates_to_deployment``
at the trivial layout for the port's three engines (mixed paged,
serialized paged, serialized dense): the engine holds a ``Deployment``, reads
its models through it, and the step tables have the shape of a reference
``ShiftEngine``'s built on ``Layout()`` with the same ``EngineConfig``.
Then the table's errors, and that a deployment on the CPU runs its steps
eagerly and captures no CUDA graph. The graphed tables are held to the
eager ones on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.core.policy import ThresholdPolicy as JaxPolicy  # noqa: E402
from repro.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.engine import ShiftEngine as JaxEngine  # noqa: E402
from repro.engine.deployment import Deployment as JaxDeployment  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.parallel import Layout as JaxLayout  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.engine.deployment import Deployment  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import Layout  # noqa: E402

ENGINES = [{}, {"mixed": False}, {"paged": False, "mixed": False}]
ENGINE_IDS = ["mixed", "serialized-paged", "dense"]


@pytest.fixture(scope="module")
def reference():
    jm = build_model(reduced_cfg("qwen3-8b"), dtype=jnp.float32)
    return jm, jm.init_params(jax.random.key(0))


def _port_engine(kw, arch="qwen3-8b"):
    model = Model(get_config(arch).reduced(), device="cpu",
                  dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    return ShiftEngine(model, EngineConfig(**kw))


def test_layout_signature_matches_reference():
    assert Layout().signature == JaxLayout().signature == (1, 1, 1, 1)
    assert Layout().describe() == JaxLayout().describe() == "dp1·sp1·tp1"
    with pytest.raises(NotImplementedError, match="ep=2"):
        Layout(ep=2)


@pytest.mark.parametrize("kw", ENGINES, ids=ENGINE_IDS)
def test_engine_delegates_to_deployment(reference, kw):
    jm, params = reference
    ref = JaxEngine(jm, jm, params, params, JaxEngineConfig(**kw),
                    policy=JaxPolicy(32))
    eng = _port_engine(kw)
    d = eng.deploy
    assert isinstance(d, Deployment) and isinstance(ref.deploy, JaxDeployment)
    assert eng.base is d.base and eng.shift is d.shift
    assert eng.base is eng.model and d.p_base is eng.model.params
    assert eng.dp == ref.dp == 1
    assert d.signature == ref.deploy.signature == (1, 1, 1, 1)
    assert d.layout.describe() == ref.deploy.layout.describe()
    assert (d.mixed, d.paged) == (ref.deploy.mixed, ref.deploy.paged) \
        == (eng.mixed, eng.paged)
    for name in ("forward", "prefill", "decode"):
        mine, theirs = getattr(d, name), getattr(ref.deploy, name)
        assert (mine is None) == (theirs is None), name
        if mine is not None:
            assert set(mine) == set(theirs) == {"base", "shift"}
    if eng.mixed:
        assert set(d.forward) == {"base", "shift"}
        assert d.prefill is None and d.decode is None
    else:
        assert d.forward is None
        assert set(d.prefill) == set(d.decode) == {"base", "shift"}
    # one model on the trivial layout: base and shift share one entry
    for table in (d.forward, d.prefill, d.decode):
        if table is not None:
            assert table["base"] is table["shift"]


def test_forward_at_errors(reference):
    jm, params = reference
    ref = JaxEngine(jm, jm, params, params, JaxEngineConfig(mixed=False),
                    policy=JaxPolicy(32))
    with pytest.raises(ValueError, match="forward_at"):
        ref.deploy.forward_at("base")
    with pytest.raises(ValueError, match="forward_at"):
        _port_engine({"mixed": False}).deploy.forward_at("base")
    d = _port_engine({}).deploy
    assert d.forward_at("shift") is d.forward["shift"]
    assert d.forward_at("base", n_last=1) is d.forward["base"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        d.forward_at("base", n_last=3)


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-8b", ENGINES[0]), ("qwen3-8b", ENGINES[1]),
    ("qwen3-8b", ENGINES[2]), ("mamba2-1.3b", {})],
    ids=ENGINE_IDS + ["mamba2-dense"])
def test_cpu_deployment_captures_nothing(arch, kw):
    """On the CPU every entry runs its step eagerly: after a served
    workload no bucket, graph or memory pool exists, and the streams equal
    those of the eager tables built explicitly."""
    streams = []
    for graphed in (True, False):
        eng = _port_engine(kw, arch)
        if not graphed:
            eng.deploy = Deployment.build(eng.model, eng.model,
                                          mixed=eng.mixed, paged=eng.paged,
                                          graphed=False)
            assert eng.deploy.graphs is None
        reqs = [Request(i, list(range(1, 12 + 5 * i)), max_new_tokens=4)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        d = eng.deploy
        assert d.captures == 0
        entries = [e for t in (d.forward, d.prefill, d.decode) if t
                   for e in t.values()]
        assert entries and all(not e.buckets for e in entries)
        if graphed:
            assert d.graphs.handle is None and d.graphs.capture_s == 0.0
        streams.append([r.generated for r in reqs])
        assert all(len(s) == 4 for s in streams[-1])
    assert streams[0] == streams[1]


def test_entry_converts_host_arrays_like_the_model():
    """An entry takes host arrays (None for the block tables of a dense
    step) and returns what the model's host method returns for them."""
    eng = _port_engine({})
    d = eng.deploy
    toks = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    args = (toks, [8, 3], [0, 0], np.array([[1, 2], [3, 0]], np.int32))
    nxt = d.forward_at("base")(*args)
    eng.model.init_paged_cache(eng.kv.num_blocks, eng.cfg.block_size)
    want, _ = eng.model.forward_mixed(*args)
    assert nxt.dtype == want.dtype and torch.equal(nxt, want)
    dense = _port_engine({"paged": False, "mixed": False})
    dense.model.init_cache(2, 32)
    logits = dense.deploy.prefill["shift"](toks, [0, 24], None)
    dense.model.init_cache(2, 32)
    want, _ = dense.model.prefill(toks, [0, 24])
    assert logits.shape == (2, dense.mcfg.vocab_size)
    assert torch.equal(logits, want)
