"""The aux draft tier of the port: ``models/registry.py draft_twin`` and
``runtime/continuous.py`` ``DraftProvider`` / ``AuxModelDraft`` and the
engine's ``draft_provider=`` (JAX ``continuous.py:144-180``, ``:912-934``,
``registry.py:401-450``), mirroring ``tests/test_spec_draft.py`` on
``llama-tiny`` (f32) on the CPU, JAX's weights carried over through
``from_jax_params``:

- the twin's shape is JAX's twin's; its proposals are deterministic,
  inside the vocabulary and JAX's twin's tokens;
- a non-llama adapter is rejected (``ModelError``), a mesh raises;
- an aux engine's rows are bitwise the spec-off engine's (tokens and
  logprobs: the chain verify accepts only the target's own chain), its
  greedy tokens the JAX aux engine's; the proposals run on the engine
  thread inside its ``DEVICE_LOCK`` hold (ROADMAP §3);
- a misbehaving provider degrades to plain decode, bitwise;
- ``aux`` without a provider serves lookup; an aux row collapses to
  lookup, as JAX's does;
- ``/v1/debug/knobs`` accepts ``draft_mode=aux`` with a provider and
  refuses it without one, as the JAX handler does."""

import logging
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.runtime.continuous import AuxModelDraft as JaxAuxModelDraft
from lambdipy_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.models.graphs import DEVICE_LOCK
from lambdipy_tpu_torch.models.params import from_jax_params
from lambdipy_tpu_torch.runtime.continuous import (AuxModelDraft,
                                                   ContinuousBatcher,
                                                   DraftProvider)
from lambdipy_tpu_torch.runtime.handlers import (HandlerContext,
                                                 generate_handler,
                                                 make_engine)
from lambdipy_tpu_torch.runtime.metrics import SpecDecodeStats
from tests.test_torch_window import _burst

EXTRA = {"attn_backend": "blocked"}
BASE = {"batch_max": "2", "batch_segment": "4"}
AUX = {"spec_k": "4", "draft_mode": "aux"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def target():
    adapter = jreg.get("llama-tiny").build(extra=EXTRA)
    params = adapter.init_params(seed=0)
    server = treg.get("llama-tiny").build(extra=EXTRA).make_server(
        from_jax_params(_np(params)), device="cpu")
    return adapter, params, server


def _twins(layers=1, hidden=None):
    """JAX's twin (random weights from seed 0) and the port's over the
    same weights."""
    jadapter = jreg.get("llama-tiny").build(extra=EXTRA)
    jtwin = jreg.draft_twin(jadapter, layers=layers, hidden=hidden)
    twin = treg.draft_twin(treg.get("llama-tiny").build(extra=EXTRA),
                           layers=layers, hidden=hidden,
                           params=from_jax_params(_np(jtwin.params)),
                           device="cpu")
    return jtwin, twin


@pytest.fixture(scope="module")
def twins():
    return _twins()


@pytest.mark.parametrize("layers,hidden", [(1, None), (2, 32)],
                         ids=["one-layer", "narrow"])
def test_draft_twin_proposes_the_jax_twins_tokens(layers, hidden):
    """The port's twin has JAX's twin's shape and, over the same weights,
    proposes its tokens: deterministic, inside the vocabulary."""
    jtwin, twin = _twins(layers, hidden)
    fields = ("vocab_size", "layers", "hidden", "heads", "kv_heads", "mlp",
              "quant", "kv_quant", "max_len")
    assert {f: getattr(twin.model.cfg, f) for f in fields} == \
        {f: getattr(jtwin.model.cfg, f) for f in fields}
    prov, jprov = AuxModelDraft(twin), JaxAuxModelDraft(jtwin)
    for ctx, k in (([1, 2, 3], 4), ([9, 8, 7, 6, 5, 4], 7), ([42], 1)):
        a = prov.propose(ctx, k)
        assert len(a) == k and all(0 <= t < 512 for t in a)
        assert prov.propose(ctx, k) == a
        assert a == jprov.propose(ctx, k)
    assert prov.propose([], 4) == prov.propose([1], 0) == []
    assert prov.proposals == 6 and prov.propose_s > 0


def test_draft_twin_rejects_non_llama():
    with pytest.raises(treg.ModelError):
        treg.draft_twin(treg.get("resnet50-tiny").build(), layers=1)
    with pytest.raises(treg.ModelError):
        treg.draft_twin(SimpleNamespace(config=None), layers=1)
    with pytest.raises(ValueError, match="mesh"):
        treg.draft_twin(treg.get("llama-tiny").build(), layers=1,
                        mesh="tp=2", device="cpu")


class _Holder(DraftProvider):
    """A provider that records whether the engine thread held
    ``DEVICE_LOCK`` while it proposed."""

    def __init__(self, inner):
        self.inner, self.held = inner, []

    def propose(self, context, k):
        self.held.append(DEVICE_LOCK._owner == threading.get_ident())
        return self.inner.propose(context, k)


REQUESTS = [([5, 6, 7, 8] * 3, 16, {}),
            ([9, 1, 9, 1, 9, 1], 12, {"temperature": 0.8, "seed": 4}),
            (list(range(20, 31)), 10, {})]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_aux_engine_is_bitwise_spec_off_and_jax(target, twins, kind):
    """``draft_mode=aux`` over the port's twin: every row bitwise the
    spec-off engine's, greedy rows the JAX aux engine's tokens over JAX's
    twin; the aux provider counted; proposals made inside the engine's
    ``DEVICE_LOCK`` hold without a deadlock."""
    jadapter, params, server = target
    jtwin, twin = twins
    extra = {**BASE, **({"kv_paged": "1", "prefix_block": "16"}
                        if kind == "paged" else {})}
    prov = _Holder(AuxModelDraft(twin))
    engine = make_engine(server, {**extra, **AUX})
    engine.draft_provider = prov
    engine.draft_mode = "aux"
    got = _burst(engine, REQUESTS)
    want = _burst(make_engine(server, extra), REQUESTS)
    for (t, lp), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(lp, wl)
    provs = engine.stats()["spec"]["draft"]["providers"]
    assert provs["aux"]["steps"] > 0 and provs["aux"]["accepted"] >= 0
    assert prov.held and all(prov.held)
    jengine = JaxBatcher(jadapter.make_server(params), slots=2, segment=4,
                         spec_k=4, draft_mode="aux",
                         draft_provider=JaxAuxModelDraft(jtwin))
    greedy = [r for r in REQUESTS if not r[2]]
    jout = _burst(jengine, greedy, logprobs=False)
    for (t, _), jt in zip([g for g, r in zip(got, REQUESTS) if not r[2]],
                          jout):
        np.testing.assert_array_equal(t, np.asarray(jt))


def test_misbehaving_provider_degrades_safely(target):
    """A provider that raises or proposes short garbage only misses: the
    pad is raw ``-1`` (never accepted), so the rows stay the spec-off
    rows bitwise."""

    class Hostile(DraftProvider):
        def __init__(self):
            self.n = 0

        def propose(self, context, k):
            self.n += 1
            if self.n % 2:
                raise RuntimeError("injected provider failure")
            return [0] * (int(k) // 2)   # short and wrong

    server = target[2]
    hostile = Hostile()
    engine = ContinuousBatcher(server, slots=2, segment=4, spec_k=4,
                               draft_mode="aux", draft_provider=hostile)
    got = _burst(engine, REQUESTS)
    want = _burst(ContinuousBatcher(server, slots=2, segment=4), REQUESTS)
    for (t, lp), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(lp, wl)
    assert hostile.n > 0 and engine.draft_errors == (hostile.n + 1) // 2
    assert engine.stats()["spec"]["draft_misses"] > 0


def test_aux_without_a_provider_serves_lookup(target, caplog):
    with caplog.at_level(logging.WARNING, "lambdipy_tpu_torch.continuous"):
        engine = ContinuousBatcher(target[2], slots=2, segment=4, spec_k=4,
                                   draft_mode="aux")
    assert engine.draft_mode == "lookup" and engine.draft_provider is None
    assert "draft_provider" in caplog.text
    jengine = JaxBatcher(jreg.get("llama-tiny").build().make_server(
        target[1]), slots=2, segment=4, spec_k=4, draft_mode="aux")
    assert jengine.draft_mode == engine.draft_mode


def test_an_aux_row_collapses_to_lookup(target, twins):
    """The adaptive k demotes an aux row at k = 2 to lookup, then off, as
    JAX's ``_spec_adapt`` does (``model/aux -> lookup -> off``)."""
    engine = ContinuousBatcher(target[2], slots=2, segment=4, spec_k=4,
                               draft_mode="aux",
                               draft_provider=AuxModelDraft(twins[1]))
    engine.spec_metrics = SpecDecodeStats()  # not the server's shared one
    entry = {"draft_mode": "aux", "k_row": 2, "accept_ewma": None}
    engine._spec_adapt(entry, "aux", 2, 1)
    assert (entry["draft_mode"], entry["k_row"]) == ("lookup", 2)
    engine._spec_adapt(entry, "lookup", 2, 1)
    assert (entry["draft_mode"], entry["k_row"]) == ("off", 1)
    assert engine.spec_metrics.report()["draft"]["fallbacks"] == {
        "aux->lookup": 1, "lookup->off": 1}


def test_knobs_take_aux_only_with_a_provider(target, twins):
    """The knob route (JAX ``handlers.py:1040-1062``): ``aux`` needs a
    spec-on boot and a provider on the engine; with one it is taken."""
    extra = {**EXTRA, "batch_mode": "continuous", "spec_k": "4",
             "batch_max": "2", "batch_segment": "4",
             "warm_group_prefill": "0", "prefix_cache_mb": "0"}
    ctx = HandlerContext(device="cpu", state_dict=target[2].model.state_dict())
    state = generate_handler({"model": "llama-tiny", "dtype": "float32",
                              "extra": extra}, ctx)
    knobs = state.knobs_admin_fn
    out = knobs({"draft_mode": "aux"})
    assert not out["ok"] and "draft_provider" in out["error"]
    state.engine.draft_provider = AuxModelDraft(twins[1])
    out = knobs({"draft_mode": "aux"})
    assert out["ok"] and out["draft_mode"] == "aux"
    assert state.engine.draft_mode == "aux"
    row = state.invoke({"tokens": [5, 6, 7, 8] * 3, "max_new_tokens": 8})
    assert row["tokens"] == target[2].generate(
        [5, 6, 7, 8] * 3, max_new_tokens=8).tolist()
    plain = generate_handler(
        {"model": "llama-tiny", "dtype": "float32",
         "extra": {k: v for k, v in extra.items() if k != "spec_k"}}, ctx)
    plain.engine.draft_provider = AuxModelDraft(twins[1])
    assert "off at boot" in plain.knobs_admin_fn({"draft_mode": "aux"})[
        "error"]
