"""The port's project resolution and stores (``lambdipy_tpu_torch/resolve/``)
against the JAX package's: requirements.txt, Pipfile, Pipfile.lock and
pyproject parse to equal lists and resolve to equal splits; the port's
registry reads artifacts the JAX registry published; ``pack_bundle`` gives
byte-identical archives in both packages for one tree (a symlink and an
empty directory in it); unpacking refuses the same escapes; the release
store, its token and the hash-verified fetch behave as JAX's, and each
package's fetcher reads the other's store. Exact throughout."""

import dataclasses
import json
import tarfile

import pytest

from lambdipy_tpu.recipes import builtin_store as jax_store
from lambdipy_tpu.resolve import registry as jregistry
from lambdipy_tpu.resolve import releases as jreleases
from lambdipy_tpu.resolve import requirements as jreq
from lambdipy_tpu_torch.recipes import builtin_store as port_store
from lambdipy_tpu_torch.resolve import registry as tregistry
from lambdipy_tpu_torch.resolve import releases as treleases
from lambdipy_tpu_torch.resolve import requirements as treq


def _rows(reqs):
    return [dataclasses.asdict(r) for r in reqs]


PROJECT_FILES = {
    "requirements.txt": "numpy==2.0.2\n# comment\n\nscipy>=1.0  # inline\n"
                        "click\nfoo; python_version < '3'\n",
    "Pipfile": '[[source]]\nurl = "https://pypi.org/simple"\n\n[packages]\n'
               'numpy = "==2.0.2"\nclick = "*"\n'
               'requests = {version = ">=2.0", extras = ["socks"]}\n'
               'colorama = {version = "*", markers = '
               '"sys_platform == \'win32\'"}\n\n'
               '[dev-packages]\npytest = "*"\n',
    "Pipfile.lock": json.dumps({
        "default": {"numpy": {"version": "==2.0.2", "hashes": []},
                    "click": {"version": "==8.4.2"},
                    "colorama": {"version": "==0.4.6",
                                 "markers": "sys_platform == 'win32'"}},
        "develop": {"pytest": {"version": "==8.0.0"}}}),
    "pyproject.toml": '[project]\nname = "demo"\nversion = "0"\n'
                      'dependencies = ["numpy>=2.0", "click; python_version '
                      '>= \'3.8\'", "definitely-missing; python_version < '
                      '\'3\'"]\n',
}


@pytest.mark.parametrize("name", sorted(PROJECT_FILES))
def test_a_project_file_parses_to_equal_requirements(name, tmp_path):
    path = tmp_path / name
    path.write_text(PROJECT_FILES[name])
    assert _rows(treq.parse_project_file(path)) == \
        _rows(jreq.parse_project_file(path))


def test_pipfile_dev_sections_parse_alike():
    text = PROJECT_FILES["Pipfile"]
    assert _rows(treq.parse_pipfile_text(text, dev=True)) == \
        _rows(jreq.parse_pipfile_text(text, dev=True))
    lock = PROJECT_FILES["Pipfile.lock"]
    assert _rows(treq.parse_pipfile_lock_text(lock, dev=True)) == \
        _rows(jreq.parse_pipfile_lock_text(lock, dev=True))


BAD_TEXT = {
    "option line": (lambda m: m.parse_requirements_text("-r other.txt\n"),
                    "option lines"),
    "garbage": (lambda m: m.parse_requirements_text("not a req!!!\n"),
                "invalid requirement"),
    "vcs pipfile": (lambda m: m.parse_pipfile_text(
        '[packages]\nfoo = {git = "https://x/y.git"}\n'), "git"),
    "unpinned lock": (lambda m: m.parse_pipfile_lock_text(
        json.dumps({"default": {"x": {}}})), "missing pinned version"),
    "conflict": (lambda m: m.pin_against_local(
        m.parse_requirement("numpy==0.0.1")), "cannot be satisfied"),
    "missing": (lambda m: m.pin_against_local(
        m.parse_requirement("surely-not-installed-pkg")), "not available"),
}


@pytest.mark.parametrize("case", sorted(BAD_TEXT))
def test_a_bad_requirement_raises_in_both(case):
    fn, match = BAD_TEXT[case]
    for mod in (jreq, treq):
        with pytest.raises(mod.ResolutionError, match=match):
            fn(mod)


@pytest.mark.parametrize("name", ["requirements.txt", "Pipfile",
                                  "pyproject.toml"])
def test_a_project_resolves_to_equal_splits(name, tmp_path):
    path = tmp_path / name
    path.write_text({"requirements.txt": "numpy>=2.0\nclick\n"}.get(
        name, PROJECT_FILES[name].replace('\nrequests = {version = ">=2.0", '
                                          'extras = ["socks"]}', "")))
    got = treq.resolve_project(path, port_store())
    want = jreq.resolve_project(path, jax_store())
    assert [(dataclasses.asdict(r), n) for r, n in got.recipe_covered] == \
        [(dataclasses.asdict(r), n) for r, n in want.recipe_covered]
    assert _rows(got.plain) == _rows(want.plain)
    assert [n for _, n in got.recipe_covered] == ["numpy"]


def _bundle(root):
    (root / "site" / "pkg").mkdir(parents=True)
    (root / "site" / "pkg" / "__init__.py").write_text("VALUE = 42\n")
    (root / "handler.py").write_text("def handler(req): return req\n")
    (root / "manifest.json").write_text(json.dumps({"artifact_id": "d-1"}))
    (root / "params").mkdir()
    (root / "params" / "w.bin").write_bytes(bytes(range(256)) * 64)
    (root / "pkg-link").symlink_to("site/pkg", target_is_directory=True)
    (root / "file-link").symlink_to("handler.py")
    (root / "empty").mkdir()
    return root


def test_pack_bundle_is_byte_identical_across_the_packages(tmp_path):
    tree = _bundle(tmp_path / "bundle")
    a = treleases.pack_bundle(tree, tmp_path / "port.tar.gz")
    b = jreleases.pack_bundle(tree, tmp_path / "jax.tar.gz")
    again = treleases.pack_bundle(tree, tmp_path / "again.tar.gz")
    assert a.read_bytes() == b.read_bytes() == again.read_bytes()
    out = treleases.unpack_archive(b, tmp_path / "out")
    assert (out / "pkg-link").is_symlink()
    assert (out / "pkg-link" / "__init__.py").read_text() == "VALUE = 42\n"
    assert (out / "file-link").is_symlink() and (out / "empty").is_dir()
    assert (out / "params" / "w.bin").read_bytes() == \
        (tree / "params" / "w.bin").read_bytes()


def _evil_archive(path, kind):
    with tarfile.open(path, "w:gz") as tar:
        if kind == "dotdot":
            info = tarfile.TarInfo("../escape.txt")
        elif kind == "absolute":
            info = tarfile.TarInfo("/abs/escape.txt")
        elif kind == "symlink":
            info = tarfile.TarInfo("link")
            info.type = tarfile.SYMTYPE
            info.linkname = "../../outside"
        elif kind == "hardlink":
            info = tarfile.TarInfo("hard")
            info.type = tarfile.LNKTYPE
            info.linkname = "../../etc/passwd"
        else:  # a device node
            info = tarfile.TarInfo("dev")
            info.type = tarfile.CHRTYPE
        info.size = 0
        tar.addfile(info)
    return path


@pytest.mark.parametrize("kind", ["dotdot", "absolute", "symlink",
                                  "hardlink", "device"])
def test_unpacking_refuses_the_same_escapes(kind, tmp_path):
    evil = _evil_archive(tmp_path / f"{kind}.tar.gz", kind)
    for mod in (jreleases, treleases):
        with pytest.raises(mod.ReleaseError) as exc:
            mod.unpack_archive(evil, tmp_path / f"out-{mod.__name__}")
        msg = str(exc.value)
        assert ("unsafe" in msg) or ("unsupported member" in msg)
    assert not (tmp_path / "escape.txt").exists()


def test_the_port_reads_a_registry_the_jax_package_published(tmp_path):
    bundle = _bundle(tmp_path / "bundle")
    jreg = jregistry.ArtifactRegistry(tmp_path / "registry")
    jreg.publish("pkg-1.0-py312-cpu", bundle, recipe="pkg", version="1.0",
                 device="cpu", manifest={"k": "v"})
    treg = tregistry.ArtifactRegistry(tmp_path / "registry")
    assert treg.has("pkg-1.0-py312-cpu")
    assert [dataclasses.asdict(i) for i in treg.list()] == \
        [dataclasses.asdict(i) for i in jreg.list()]
    got = treg.fetch("pkg-1.0-py312-cpu")
    assert (got / "site" / "pkg" / "__init__.py").read_text() == \
        "VALUE = 42\n"
    with pytest.raises(tregistry.RegistryError):
        treg.fetch("nope")
    treg.delete("pkg-1.0-py312-cpu")
    assert jreg.list() == [] and not jreg.has("pkg-1.0-py312-cpu")


def test_publishes_at_once_each_keep_their_index_entry(tmp_path):
    """Builds running at once (several processes of the CLI) publish into
    one registry: the index's lock keeps every entry."""
    import multiprocessing

    bundle = _bundle(tmp_path / "bundle")
    for i in range(300):  # a tree whose copy and size take a while
        (bundle / "site" / "pkg" / f"m{i}.py").write_text(f"X = {i}\n")
    ids = [f"pkg{i}-1.0-py312-cpu" for i in range(12)]
    ctx = multiprocessing.get_context("spawn")
    start = ctx.Barrier(len(ids))
    procs = [ctx.Process(target=_publish_one,
                         args=(tmp_path / "registry", aid, bundle, start))
             for aid in ids]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert all(p.exitcode == 0 for p in procs)
    treg = tregistry.ArtifactRegistry(tmp_path / "registry")
    assert sorted(i.artifact_id for i in treg.list()) == sorted(ids)


def _publish_one(root, artifact_id, bundle, start):
    registry = tregistry.ArtifactRegistry(root)
    start.wait(60)
    registry.publish(artifact_id, bundle, recipe=artifact_id.split("-")[0],
                     version="1.0", device="cpu")


def test_the_registry_roots_are_the_ports_own():
    from lambdipy_tpu_torch.resolve import sources
    from lambdipy_tpu_torch.runtime import deploy

    root = tregistry.DEFAULT_ROOT.parent
    assert root.name == ".lambdipy-tpu-torch"
    assert treleases.DEFAULT_CACHE == root / "cache" / "assets"
    assert sources.DEFAULT_CACHE == root / "sources"
    assert deploy.DEFAULT_STATE == root / "deployments.json"
    assert tregistry.DEFAULT_ROOT != jregistry.DEFAULT_ROOT


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_fetcher_reads_the_others_store(writer, tmp_path):
    w, r = ((jreleases, treleases) if writer == "jax"
            else (treleases, jreleases))
    bundle = _bundle(tmp_path / "bundle")
    store = w.ReleaseStore.create(tmp_path / "store")
    asset = store.upload_asset(
        "v1", w.pack_bundle(bundle, tmp_path / "a.tar.gz"),
        artifact_id="demo-0.1-py312-any", recipe="demo", version="0.1",
        python="3.12", device="any")
    assert asset.hash.startswith("sha256:")
    found = r.ReleaseStore(tmp_path / "store").find_asset(
        recipe="demo", python="3.12", device="gpu-h100-1")
    assert found is not None and found.hash == asset.hash
    registry = (jregistry if r is jreleases else tregistry).ArtifactRegistry(
        tmp_path / "registry")
    got = r.ReleaseFetcher(r.ReleaseStore(tmp_path / "store"),
                           cache_dir=tmp_path / "cache"
                           ).fetch_into_registry(found, registry)
    assert (got / "handler.py").exists() and (got / "pkg-link").is_symlink()


def test_a_protected_store_requires_the_token(tmp_path, monkeypatch):
    monkeypatch.delenv("LAMBDIPY_RELEASE_TOKEN", raising=False)
    bundle = _bundle(tmp_path / "bundle")
    store = treleases.ReleaseStore.create(tmp_path / "store", protected=True)
    archive = treleases.pack_bundle(bundle, tmp_path / "a.tar.gz")
    with pytest.raises(treleases.ReleaseError, match="protected"):
        store.upload_asset("v1", archive, artifact_id="a", recipe="demo",
                           version="0.1", python="3.12", device="any")
    monkeypatch.setenv("LAMBDIPY_RELEASE_TOKEN", "tok")
    treleases.ReleaseStore(store.root).upload_asset(
        "v1", archive, artifact_id="a", recipe="demo", version="0.1",
        python="3.12", device="any")
    assert treleases.ReleaseStore(store.root, token=None).list_assets()
    # the index's ids flow into paths: a tampered one is refused
    with pytest.raises(treleases.ReleaseError, match="unsafe asset"):
        treleases.Asset(name="x.tar.gz", tag="v1", size=1, hash="sha256:0",
                        artifact_id="../../escape", recipe="demo",
                        version="0.1", python="3.12", device="any",
                        uploaded=0.0)


def test_the_fetcher_verifies_and_caches(tmp_path):
    bundle = _bundle(tmp_path / "bundle")
    store = treleases.ReleaseStore.create(tmp_path / "store")
    asset = store.upload_asset(
        "v1", treleases.pack_bundle(bundle, tmp_path / "a.tar.gz"),
        artifact_id="demo-0.1-py312-any", recipe="demo", version="0.1",
        python="3.12", device="any")
    fetcher = treleases.ReleaseFetcher(store, cache_dir=tmp_path / "cache")
    cached = fetcher.fetch(asset)
    store.asset_path(asset).unlink()  # a cache hit needs no store copy
    assert fetcher.fetch(asset) == cached
    cached.write_bytes(cached.read_bytes() + b"x")
    path = tmp_path / "store" / "releases" / "v1" / "assets" / asset.name
    path.write_bytes(b"tampered")
    with pytest.raises(treleases.ReleaseError, match="failed verification"):
        fetcher.fetch(asset)
