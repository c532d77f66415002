"""The port's recipes (``lambdipy_tpu_torch/recipes/``) against the JAX
package's: every JAX builtin TOML loads through both loaders to equal
fields and an equal ``artifact_id``; JAX's malformed-recipe cases raise in
both; each of the port's ten builtin twins differs from its JAX recipe
only in what the card requires (device, base layer, requires, the
handler's module, the mesh); the store's layering and lookup are JAX's.
Exact throughout (a recipe is data)."""

import dataclasses
from pathlib import Path

import pytest

from lambdipy_tpu.recipes import schema as jschema
from lambdipy_tpu.recipes import store as jstore
from lambdipy_tpu_torch.recipes import schema as tschema
from lambdipy_tpu_torch.recipes import store as tstore

JAX_BUILTIN = sorted(jstore.BUILTIN_DIR.glob("*.toml"))
PORT_BUILTIN = sorted(tstore.BUILTIN_DIR.glob("*.toml"))
# what a twin may change, by recipe field and payload field
TWIN_FIELDS = {"device", "base_layer", "requires"}
TWIN_PAYLOAD_FIELDS = {"handler", "mesh"}


def test_the_port_ships_a_twin_of_every_builtin_recipe():
    assert [p.name for p in PORT_BUILTIN] == [p.name for p in JAX_BUILTIN]
    assert len(PORT_BUILTIN) == 10


@pytest.mark.parametrize("path", JAX_BUILTIN, ids=lambda p: p.stem)
def test_a_jax_builtin_recipe_loads_to_equal_fields(path):
    want = jschema.load_recipe_file(path)
    got = tschema.load_recipe_file(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_model == want.is_model
    for py in ("3.12", "3.10"):
        assert got.artifact_id(py) == want.artifact_id(py)


@pytest.mark.parametrize("path", PORT_BUILTIN, ids=lambda p: p.stem)
def test_a_twin_differs_only_where_the_card_requires(path):
    twin = dataclasses.asdict(tschema.load_recipe_file(path))
    ref = dataclasses.asdict(jschema.load_recipe_file(
        jstore.BUILTIN_DIR / path.name))
    changed = {k for k in ref if k != "payload" and twin[k] != ref[k]}
    assert changed <= TWIN_FIELDS, changed
    assert twin["name"] == ref["name"] and twin["version"] == ref["version"]
    assert twin["prune"] == ref["prune"]
    if ref["payload"] is None:
        assert twin["payload"] is None and not changed
        return
    payload_changed = {k for k in ref["payload"]
                       if twin["payload"][k] != ref["payload"][k]}
    assert payload_changed <= TWIN_PAYLOAD_FIELDS, payload_changed
    module, attr = twin["payload"]["handler"].split(":")
    assert module == "lambdipy_tpu_torch.runtime.handlers"
    assert attr == ref["payload"]["handler"].split(":")[1]
    if ref["device"].startswith("tpu"):
        assert twin["device"] == "gpu-h100-1"
    else:
        assert twin["device"] == ref["device"]
    if ref["base_layer"] == "jax-tpu":
        assert twin["base_layer"] == "torch"
        assert twin["requires"] == ("torch", "numpy")
    # the mesh: one card, so tensor parallelism 1 (jax-llama3-8b's tp=4)
    assert all(v == 1 for _, v in twin["payload"]["mesh"])


def test_the_twins_artifact_ids_name_the_card():
    store = tstore.builtin_store()
    assert store.get("jax-resnet50").artifact_id("3.12") == \
        "jax-resnet50-1.0.0-py312-gpu-h100-1"
    llama = store.get("jax-llama3-8b")
    assert llama.payload.mesh_dict() == {"dp": 1, "tp": 1}
    assert llama.payload.quant == "int8"
    assert llama.payload.params_format == "fpk"
    assert store.get("hello-numpy").artifact_id("3.12") == \
        jstore.builtin_store().get("hello-numpy").artifact_id("3.12")


def test_the_card_is_a_device_of_the_port_alone():
    doc = {"name": "x", "version": "1", "device": "gpu-h100-1"}
    assert tschema.load_recipe_dict(doc).device == "gpu-h100-1"
    with pytest.raises(jschema.RecipeError, match="unknown device"):
        jschema.load_recipe_dict(doc)


BAD_DOCS = {
    "unknown keys": ({"name": "x", "version": "1", "bogus": True},
                     "unknown recipe keys"),
    "bad device": ({"name": "x", "version": "1", "device": "gpu-h100"},
                   "unknown device"),
    "sdist without source": ({"name": "x", "version": "1",
                              "build": {"backend": "sdist"}},
                             "sdist build needs build.source"),
    "handler format": ({"name": "x", "version": "1",
                        "payload": {"model": "m", "handler": "no_colon"}},
                       "module:attr"),
    "bad name": ({"name": "Bad Name", "version": "1"},
                 "invalid recipe name"),
    "no version": ({"name": "x"}, "version is required"),
    "bad schema": ({"name": "x", "version": "1", "schema": 2},
                   "unsupported schema"),
    "bad params_format": ({"name": "x", "version": "1",
                           "payload": {"model": "m", "handler": "a:b",
                                       "params_format": "zip"}},
                          "params_format"),
    "bad mesh": ({"name": "x", "version": "1",
                  "payload": {"model": "m", "handler": "a:b",
                              "mesh": {"tp": 0}}}, "payload.mesh"),
}


@pytest.mark.parametrize("case", sorted(BAD_DOCS))
def test_a_malformed_recipe_raises_in_both(case):
    doc, match = BAD_DOCS[case]
    for mod in (jschema, tschema):
        with pytest.raises(mod.RecipeError, match=match):
            mod.load_recipe_dict(doc)


def test_invalid_toml_is_reported_with_its_path_in_both(tmp_path):
    p = tmp_path / "bad.toml"
    p.write_text("name = [unclosed")
    for mod in (jschema, tschema):
        with pytest.raises(mod.RecipeError, match="invalid TOML"):
            mod.load_recipe_file(p)


def test_a_project_store_overrides_the_builtins(tmp_path):
    (tmp_path / "numpy.toml").write_text(
        'schema = 1\nname = "numpy"\nversion = "9.9.9"\n')
    store = tstore.RecipeStore([tstore.BUILTIN_DIR, tmp_path])
    assert store.get("numpy").version == "9.9.9"
    assert tstore.builtin_store(str(tmp_path)).get("numpy").version == \
        "9.9.9"
    assert sorted(store.names()) == sorted(
        jstore.RecipeStore([jstore.BUILTIN_DIR, tmp_path]).names())


def test_covering_canonicalizes_as_jax_does():
    t, j = tstore.builtin_store(), jstore.builtin_store()
    for name in ("NumPy", "numpy", "hello_numpy", "nonexistent-pkg"):
        got, want = t.covering(name), j.covering(name)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.name == want.name
    with pytest.raises(tschema.RecipeError, match="no recipe named"):
        t.get("nope")


def test_the_builtin_dir_is_the_ports():
    assert tstore.BUILTIN_DIR == Path(tschema.__file__).parent / "builtin"
