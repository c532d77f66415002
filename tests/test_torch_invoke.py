"""``HandlerState.invoke`` of the port against the JAX package's, on the
CPU: the handler gets a copy of the request (``{}`` for None), and the
result a ``latency_ms`` unless the handler set one. Exact, apart from
``latency_ms``'s value (a wall time)."""

import pytest

from lambdipy_tpu.runtime import handlers as jhandlers
from lambdipy_tpu_torch.runtime import handlers as thandlers

PACKAGES = {"jax": jhandlers, "port": thandlers}


@pytest.mark.parametrize("request_", [None, {}, {"n": 8, "seed": 3}],
                         ids=["none", "empty", "sized"])
def test_invoke_answers_as_jaxs(request_):
    """``hello_handler``'s answer (the config-1 handler, host only) has
    the same keys and values in both packages, ``latency_ms`` among the
    keys."""
    outs = {name: pkg.hello_handler({}, None).invoke(request_)
            for name, pkg in PACKAGES.items()}
    for out in outs.values():
        assert isinstance(out.pop("latency_ms"), float)
    assert outs["port"] == outs["jax"]
    assert outs["port"]["ok"] and outs["port"]["n"] == (request_ or {}).get(
        "n", 64)


def test_a_handler_that_mutates_its_request_leaves_the_callers_dict():
    """Both packages hand the handler a copy: its writes do not reach the
    caller; a ``latency_ms`` the handler sets is kept."""
    def invoke_fn(req):
        req["seen"] = True
        req.pop("drop", None)
        return {"ok": True, "keys": sorted(req), "latency_ms": -1.0}

    for pkg in PACKAGES.values():
        caller = {"drop": 1, "keep": 2}
        out = pkg.HandlerState(invoke_fn=invoke_fn, meta={}).invoke(caller)
        assert caller == {"drop": 1, "keep": 2}
        assert out == {"ok": True, "keys": ["keep", "seen"],
                       "latency_ms": -1.0}
