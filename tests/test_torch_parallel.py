"""The port's mesh, sharding and process-group layer
(``lambdipy_tpu_torch/parallel/``) against the JAX package's, on the host
alone (no process is spawned; the JAX side on its 8 virtual CPU devices).
Exact throughout: meshes, specs, shards and byte counts are integers,
tuples and copied values.

- ``parse_mesh_spec``, ``mesh_shape_for``, ``make_mesh`` and
  ``make_hybrid_mesh`` give JAX's results over grids of specs and device
  counts, and JAX's errors with JAX's messages (a port mesh's ranks stand
  where JAX's device ids stand).
- Every leaf of every registry model with sharding rules gets JAX's spec,
  path for path, from ``param_shardings`` and from ``train_shardings``
  with FSDP on and off, on ``{"dp": 2}``, ``{"dp": 4, "tp": 2}`` and
  ``{"dp": 2, "ep": 2}``; a convolution kernel's spec names the same dims
  in the port's layout.
- ``shard_params`` and ``shard_batch`` give each rank the block JAX puts
  on the device of that id; ``device_bytes`` counts JAX's bytes.
- ``initialize_from_env`` is a no-op in one process, as JAX's.
- ``job_mesh`` refuses what the port does not train, naming its item.
"""

import jax
import numpy as np
import pytest
import torch

from lambdipy_tpu.models import registry as jreg
from lambdipy_tpu.parallel import distributed as jdist
from lambdipy_tpu.parallel import mesh as jmesh
from lambdipy_tpu.parallel import sharding as jshard
from lambdipy_tpu.train.step import train_shardings as jax_train_shardings
from lambdipy_tpu_torch.models import params as tparams
from lambdipy_tpu_torch.models import registry as treg
from lambdipy_tpu_torch.parallel import distributed as tdist
from lambdipy_tpu_torch.parallel import mesh as tmesh
from lambdipy_tpu_torch.parallel import sharding as tshard
from lambdipy_tpu_torch.train.step import train_shardings

SPECS = ["tp=2", "tp=2,sp=1", "dp=2 tp=4", "2", "2x4", "TP=2", "", "0", "1",
         "off", "none", None, "tp=1", "dp=2,ep=2", "pp=2 sp=2", "fsdp=4",
         "tq=2", "tp=two", "2x2x2", "tp=-2", "banana", "dp=0", "x", "tp"]


def _outcome(fn, *args, **kw):
    """A call's result, or its error's type and message."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_parse_mesh_spec_is_jaxs(spec):
    assert _outcome(tmesh.parse_mesh_spec, spec) \
        == _outcome(jmesh.parse_mesh_spec, spec)


def test_mesh_shape_for_is_jaxs():
    for n in range(1, 9):
        for tp in (None, 1, 2, 3, 4):
            for sp in (1, 2):
                for pp in (1, 2):
                    assert _outcome(tmesh.mesh_shape_for, n, tp=tp, sp=sp,
                                    pp=pp) \
                        == _outcome(jmesh.mesh_shape_for, n, tp=tp, sp=sp,
                                    pp=pp), (n, tp, sp, pp)


def _mesh_view(m) -> tuple:
    """(axis names, shape, device ids or ranks) of a JAX or a port mesh."""
    ids = np.vectorize(lambda d: getattr(d, "id", d))(np.asarray(m.devices))
    return tuple(m.axis_names), dict(m.shape), ids.tolist()


MESH_SHAPES = [{"dp": 2}, {"dp": -1}, {"dp": 2, "tp": -1}, {"tp": 2, "sp": 2},
               {"dp": 1}, {}, {"dp": 2, "tp": 2, "ep": 2}, {"pp": 2, "dp": 2},
               {"fsdp": 2, "tp": -1}, {"dp": -1, "tp": -1}, {"xx": 2},
               {"dp": 3}, {"dp": 1, "tp": 1}]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_is_jaxs(cpu_devices, n):
    """Axis names, shape and the device array (ids against ranks) over a
    grid of shapes, errors included; ``flat_mesh`` too."""
    for shape in MESH_SHAPES:
        want = _outcome(jmesh.make_mesh, shape, devices=cpu_devices[:n])
        got = _outcome(tmesh.make_mesh, shape, devices=range(n))
        if want[0] == "ok":
            want, got = ("ok", _mesh_view(want[1])), \
                ("ok", _mesh_view(got[1]) if got[0] == "ok" else got)
        assert got == want, shape
    assert _mesh_view(tmesh.flat_mesh("tp", devices=range(n))) \
        == _mesh_view(jmesh.flat_mesh("tp", devices=cpu_devices[:n]))


HYBRID = [({"dp": 2, "tp": 4}, None), ({"tp": 4}, {"dp": 2}),
          ({"dp": 2, "tp": 2}, {"dp": 2}), ({"tp": 2, "sp": 2}, {"dp": 2}),
          ({"tp": 2}, {"dp": 2, "pp": 2}), ({"dp": 4}, {"tp": 2}),
          ({"dp": 8}, {}), ({"xx": 8}, None), ({"dp": 3}, None),
          ({"tp": 4}, {"dp": 4})]


def test_make_hybrid_mesh_is_jaxs(cpu_devices):
    """The rank array equals JAX's device-id array over (ici, dcn) on 8
    devices: the dcn factor of every axis outermost."""
    for ici, dcn in HYBRID:
        want = _outcome(jdist.make_hybrid_mesh, ici, dcn)
        got = _outcome(tdist.make_hybrid_mesh, ici, dcn, devices=range(8))
        if want[0] == "ok":
            want = ("ok", _mesh_view(want[1]))
            got = ("ok", _mesh_view(got[1])) if got[0] == "ok" else got
        assert got == want, (ici, dcn)


# ------------------------------------------------------------ the specs

RULED_MODELS = ["llama-tiny", "llama-moe-tiny", "llama3-8b", "llama-hf",
                "resnet50-tiny", "resnet50", "bert-tiny", "bert-base"]
TRAIN_MESHES = [{"dp": 2}, {"dp": 4, "tp": 2}, {"dp": 2, "ep": 2}]


def _jax_key(path) -> tuple[str, str]:
    """A JAX leaf's path string and its port key."""
    parts = [str(getattr(k, "key", k)) for k in path]
    return "/".join(parts), tparams.port_key(".".join(parts))


def _entries(spec, key: str, ndim: int) -> tuple:
    """A JAX spec's entries in the port's layout (a conv kernel's flax
    ``[kh, kw, in, out]`` dims as torch's ``[out, in, kh, kw]``)."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if key.endswith("kernel") and ndim == 4:
        entries = (entries[3], entries[2], entries[0], entries[1])
    return entries


@pytest.fixture(scope="module")
def model_shapes():
    """Per model: JAX's abstract params and the port's meta ``state_dict``
    (shapes, no weights)."""
    out = {}
    for name in RULED_MODELS:
        jad, tad = jreg.get(name).build(), treg.get(name).build()
        jtree = jax.eval_shape(lambda jad=jad: jad.init_params(seed=0))
        meta = tparams.empty_model(tad.config, device="meta").state_dict()
        out[name] = (jad, tad, jtree, meta)
    return out


@pytest.mark.parametrize("shape", TRAIN_MESHES,
                         ids=["dp2", "dp4_tp2", "dp2_ep2"])
@pytest.mark.parametrize("name", RULED_MODELS)
def test_every_leaf_gets_jaxs_spec(model_shapes, cpu_devices, name, shape):
    """``param_shardings`` and ``train_shardings`` (FSDP on and off), leaf
    for leaf: the same keys, and each spec JAX's."""
    jad, tad, jtree, meta = model_shapes[name]
    n = int(np.prod(list(shape.values())))
    jm = jmesh.make_mesh(shape, devices=cpu_devices[:n])
    tm = tmesh.make_mesh(shape, devices=range(n))
    assert tad.tp_rules is not None
    cases = {
        "param": (jshard.param_shardings(jtree, jm, jad.tp_rules),
                  tshard.param_shardings(meta, tm, tad.tp_rules)),
        "fsdp": (jax_train_shardings(jtree, jm, jad.tp_rules, fsdp=True),
                 train_shardings(meta, tm, tad.tp_rules, fsdp=True)),
        "no_fsdp": (jax_train_shardings(jtree, jm, jad.tp_rules, fsdp=False),
                    train_shardings(meta, tm, tad.tp_rules, fsdp=False)),
    }
    sharded = 0
    for case, (jsh, tsh) in cases.items():
        flat = jax.tree_util.tree_leaves_with_path(jsh)
        want = {}
        for path, ns in flat:
            _, key = _jax_key(path)
            want[key] = _entries(ns.spec, key, meta[key].dim())
        assert set(tsh) == set(want), case
        for key, entries in want.items():
            assert tuple(tsh[key].spec) == entries, (case, key)
            assert tsh[key].mesh == tm
            sharded += any(e is not None for e in entries)
    assert sharded  # every mesh here splits some leaf of every model


@pytest.fixture(scope="module")
def tiny_params():
    jad = jreg.get("llama-tiny").build()
    jparams = jad.init_params(seed=0)
    return jad, jparams, tparams.from_jax_params(jax.device_get(jparams))


def _device_blocks(tree, key):
    """JAX leaf ``key`` of a sharded tree: {device id: its block}."""
    leaves = dict((_jax_key(p)[1], leaf)
                  for p, leaf in jax.tree_util.tree_leaves_with_path(tree))
    return {s.device.id: np.asarray(s.data)
            for s in leaves[key].addressable_shards}


def test_shard_params_gives_each_rank_jaxs_block(tiny_params, cpu_devices):
    """On ``{"dp": 4, "tp": 2}`` (and ``train_shardings``' FSDP specs), rank
    ``r``'s block of every leaf is the block JAX puts on device ``r``, and
    ``device_bytes`` is JAX's ``(per_device_max, logical_total)``."""
    jad, jparams, sd = tiny_params
    jm = jmesh.make_mesh({"dp": 4, "tp": 2}, devices=cpu_devices[:8])
    tm = tmesh.make_mesh({"dp": 4, "tp": 2}, devices=range(8))
    tad = treg.get("llama-tiny").build()
    jtree = jshard.shard_params(jparams, jm, jad.tp_rules)
    fsdp = jax.device_put(jparams, jax_train_shardings(jparams, jm,
                                                       jad.tp_rules))
    tsh = train_shardings(sd, tm, tad.tp_rules)
    for rank in range(8):
        local = tshard.shard_params(sd, tm, tad.tp_rules, rank=rank)
        local_fsdp = {k: tsh[k].shard(v, rank) for k, v in sd.items()}
        for key in sd:
            np.testing.assert_array_equal(
                local[key].numpy(), _device_blocks(jtree, key)[rank])
            np.testing.assert_array_equal(
                local_fsdp[key].numpy(), _device_blocks(fsdp, key)[rank])
    rank0 = {k: tsh[k].shard(v, 0) for k, v in sd.items()}
    assert tshard.device_bytes(rank0, tsh) == jshard.device_bytes(fsdp)
    assert tshard.device_bytes(sd) == jshard.device_bytes(jparams)


def test_shard_batch_gives_each_rank_jaxs_rows(cpu_devices):
    batch = np.arange(8 * 17, dtype=np.int32).reshape(8, 17)
    jm = jmesh.make_mesh({"dp": 4, "sp": 2}, devices=cpu_devices[:8])
    tm = tmesh.make_mesh({"dp": 4, "sp": 2}, devices=range(8))
    arr = jshard.shard_batch({"tokens": batch}, jm)["tokens"]
    want = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    for rank in range(8):
        got = tshard.shard_batch({"tokens": batch}, tm, rank=rank)["tokens"]
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want[rank])


def test_rules_match_first_rule_and_filter_like_jaxs():
    """``spec_for`` (first match wins, the default last) and
    ``named_sharding``'s filter over the llama rules, on paths of both
    layouts."""
    jrules = jreg.get("llama-tiny").build().tp_rules
    trules = treg.get("llama-tiny").build().tp_rules
    assert [(g, tuple(s)) for g, s in trules.rules] \
        == [(g, tuple(s)) for g, s in jrules.rules]
    for path in ("params/layer_0/o_proj/kernel", "params/layer_3/q_proj/kernel_int8",
                 "params/lm_head/scale", "params/embed/embedding",
                 "params/layer_0/moe/experts_down_int8", "params/final_norm/scale",
                 "params/layer_0/moe/router"):
        assert tuple(trules.spec_for(path)) == tuple(jrules.spec_for(path))
    assert tshard.jax_path("layer_0.q_proj.kernel") \
        == "params/layer_0/q_proj/kernel"
    tm = tmesh.make_mesh({"tp": 2}, devices=range(2))
    assert tuple(tshard.named_sharding(tm, "dp", "tp", None).spec) \
        == (None, "tp", None)


# ------------------------------------------------------- the process group

def _clear_env(monkeypatch):
    for var in ("LAMBDIPY_COORDINATOR", "LAMBDIPY_NUM_PROCESSES",
                "LAMBDIPY_PROCESS_ID", "JAX_COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    """JAX's test: no variables, no group; the context equals JAX's."""
    _clear_env(monkeypatch)
    ctx = tdist.initialize_from_env(device="cpu")
    assert ctx == tdist.DistributedContext(False, 0, 1, None)
    assert ctx.is_primary
    jctx = jdist.initialize_from_env()
    assert (ctx.initialized, ctx.process_index, ctx.process_count,
            ctx.coordinator) == (jctx.initialized, jctx.process_index,
                                 jctx.process_count, jctx.coordinator)
    assert not torch.distributed.is_initialized()


def test_initialize_ignores_a_process_count_of_one(monkeypatch):
    """JAX's test, with the port's variables and with torchrun's: a count
    of 1 starts nothing, and the coordinator is reported."""
    _clear_env(monkeypatch)
    monkeypatch.setenv("LAMBDIPY_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("LAMBDIPY_NUM_PROCESSES", "1")
    ctx = tdist.initialize_from_env(device="cpu")
    assert not ctx.initialized and ctx.coordinator == "localhost:1234"
    _clear_env(monkeypatch)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    ctx = tdist.initialize_from_env(device="cpu")
    assert ctx == tdist.DistributedContext(False, 0, 1, "127.0.0.1:29500")
    assert not torch.distributed.is_initialized()
    assert tdist.process_batch_slice(32) == (32, 0)
    assert tdist.process_batch_slice(32, process_index=3,
                                     process_count=4) == (8, 24)


def test_use_mesh_sets_the_ambient_mesh():
    tm = tmesh.make_mesh({"dp": 1})
    assert tmesh.current_mesh() is None
    with tmesh.use_mesh(tm) as m:
        assert m is tm and tmesh.current_mesh() is tm
    assert tmesh.current_mesh() is None
    assert tm.shape == {"dp": 1} and tm.size == 1
    with pytest.raises(RuntimeError, match="process group"):
        tm.device_mesh()


@pytest.mark.parametrize("shape,error,message", [
    ({"tp": 2}, NotImplementedError, "training's tensor parallelism is not "
                                     "ported yet (ROADMAP queue 1, item 3 "
                                     "(c))"),
    ({"ep": 2}, NotImplementedError, "item 3 (d)"),
    ({"sp": 2}, NotImplementedError, "item 3 (e)"),
    ({"pp": 2}, NotImplementedError, "item 3 (f)"),
    ({"dp": 2}, ValueError, "needs 2 processes, one device each; this job "
                            "has 1"),
    ({"zz": 1}, ValueError, "unknown mesh axes"),
], ids=["tp", "ep", "sp", "pp", "dp2", "unknown"])
def test_job_mesh_refuses_what_the_port_does_not_train(shape, error, message):
    """One process: a mesh of more devices than processes raises, and each
    axis not ported names its ROADMAP item; ``{"dp": -1}`` and ``{"dp":
    1}`` are the one device."""
    with pytest.raises(error) as e:
        tmesh.job_mesh(shape)
    assert message in str(e.value)
    for ok in ({"dp": -1}, {"dp": 1}, tmesh.make_mesh({})):
        assert tmesh.job_mesh(ok).shape == {"dp": 1}
    assert tmesh.job_mesh(None) is None
