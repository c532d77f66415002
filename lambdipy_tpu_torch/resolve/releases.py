"""Release store and fetcher of the port, the twin of
``lambdipy_tpu/resolve/releases.py``: prebuilt bundles as release assets,
so users fetch instead of building.

- :func:`pack_bundle` / :func:`unpack_archive`: a deterministic tar.gz of
  a bundle tree (sorted entries, mtime ``_EPOCH``, no owners, no gzip
  name or time), byte-identical to the JAX package's for the same tree;
  and hardened extraction (no absolute paths, no ``..``, no link out of
  the root), since assets are remote content.
- :class:`ReleaseStore`: the release index, file-backed, with the shape
  of GitHub Releases (releases by tag, assets by name with size, hash,
  recipe, version, python and device) and a write token
  (``LAMBDIPY_RELEASE_TOKEN``) that a protected store requires for
  uploads.
- :class:`ReleaseFetcher`: hash-verified fetch into a content-addressed
  asset cache (``~/.lambdipy-tpu-torch/cache/assets``, or
  ``LAMBDIPY_CACHE_DIR``), then unpacked into the local
  :class:`~lambdipy_tpu_torch.resolve.registry.ArtifactRegistry`, so
  deploy and serve work as for a local build.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import shutil
import tarfile
import time
from dataclasses import asdict, dataclass
from pathlib import Path

from lambdipy_tpu_torch.utils.fsutil import atomic_write_text, hash_file

TOKEN_ENV = "LAMBDIPY_RELEASE_TOKEN"
STORE_ENV = "LAMBDIPY_RELEASE_STORE"
DEFAULT_CACHE = Path.home() / ".lambdipy-tpu-torch" / "cache" / "assets"
_EPOCH = 315532800  # fixed mtime (1980-01-01) for deterministic archives


class ReleaseError(RuntimeError):
    pass


# -- archive format ----------------------------------------------------------


def _pack_entries(root: Path):
    """Deterministic walk for packing: regular files, symlinks (including
    symlinks to directories, which ``walk_files`` would drop — os.walk
    files them under dirnames), and empty directories, so a fetched bundle
    unpacks to exactly the tree that was published."""
    for dirpath, dirnames, filenames in os.walk(root, followlinks=False):
        dirnames.sort()
        if not dirnames and not filenames and Path(dirpath) != Path(root):
            yield Path(dirpath)
        for name in sorted(dirnames):
            p = Path(dirpath) / name
            if p.is_symlink():
                yield p
        for name in sorted(filenames):
            yield Path(dirpath) / name


def pack_bundle(bundle_dir: Path, archive_path: Path) -> Path:
    """Pack a bundle tree into a deterministic ``.tar.gz``.

    Determinism matters because the asset hash doubles as the integrity
    check and the cache key: entries are sorted, mtime/uid/gid/uname are
    normalized, and the gzip header carries no timestamp.
    """
    bundle_dir = Path(bundle_dir)
    archive_path = Path(archive_path)
    archive_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = archive_path.with_suffix(archive_path.suffix + ".tmp")
    with open(tmp, "wb") as out:
        # filename="" keeps the output path out of the gzip header (FNAME),
        # which would otherwise break byte-determinism; streaming the tar
        # through keeps memory O(chunk) for multi-GB model bundles
        with gzip.GzipFile(filename="", fileobj=out, mode="wb", mtime=0) as gz:
            with tarfile.open(fileobj=gz, mode="w", format=tarfile.PAX_FORMAT) as tar:
                for path in _pack_entries(bundle_dir):
                    info = tar.gettarinfo(
                        path, arcname=path.relative_to(bundle_dir).as_posix())
                    info.mtime = _EPOCH
                    info.uid = info.gid = 0
                    info.uname = info.gname = ""
                    if info.issym() or info.isdir():
                        tar.addfile(info)
                    else:
                        with open(path, "rb") as f:
                            tar.addfile(info, f)
    os.replace(tmp, archive_path)
    return archive_path


def unpack_archive(archive_path: Path, dest: Path) -> Path:
    """Extract a release asset, refusing path-escape entries.

    Release assets are downloaded content: absolute member names, ``..``
    components, and symlinks targeting outside the extraction root are
    all rejected before anything is written.
    """
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    root = dest.resolve()
    with tarfile.open(archive_path, mode="r:gz") as tar:
        for member in tar.getmembers():
            name = Path(member.name)
            if name.is_absolute() or ".." in name.parts:
                raise ReleaseError(f"unsafe archive member {member.name!r}")
            if member.issym() or member.islnk():
                target = (root / name).parent / member.linkname
                if not target.resolve().is_relative_to(root):
                    raise ReleaseError(
                        f"unsafe link {member.name!r} -> {member.linkname!r}")
            elif not (member.isfile() or member.isdir()):
                raise ReleaseError(f"unsupported member type in {member.name!r}")
        tar.extractall(dest, filter="data")
    return dest


# -- release store -----------------------------------------------------------


_SAFE_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


@dataclass(frozen=True)
class Asset:
    """One release asset: a packed bundle plus its index metadata.

    Name/id fields are validated on construction (which covers every index
    load): release.json is remote content, and these fields flow into
    filesystem paths on the fetch side — a tampered index must not be able
    to direct writes outside the cache/registry."""

    name: str  # "<recipe>-<version>-py<N>-<device>.tar.gz"
    tag: str  # release tag it belongs to
    size: int
    hash: str  # content hash of the archive ("xxh64:..." / "sha256:...")
    artifact_id: str
    recipe: str
    version: str
    python: str  # "3.12"
    device: str
    uploaded: float

    def __post_init__(self):
        for field_name in ("name", "tag", "artifact_id"):
            value = getattr(self, field_name)
            if not _SAFE_NAME_RE.match(value) or ".." in value:
                raise ReleaseError(
                    f"unsafe asset {field_name} {value!r} in release index")


class ReleaseStore:
    """File-backed release index with the GitHub-Releases access shape.

    Layout::

        <root>/store.json                      # {"protected": bool}
        <root>/releases/<tag>/release.json     # tag metadata + asset index
        <root>/releases/<tag>/assets/<name>    # the packed bundles

    ``protected`` stores require the ``LAMBDIPY_RELEASE_TOKEN`` env (or an
    explicit ``token=``) for uploads — the offline stand-in for GitHub's
    authenticated asset upload (``GITHUB_TOKEN``'s role).
    Reads never need a token, matching public releases.
    """

    def __init__(self, root: Path, *, token: str | None = None):
        self.root = Path(root)
        self.releases_dir = self.root / "releases"
        self.token = token if token is not None else os.environ.get(TOKEN_ENV)

    # - store admin -

    @classmethod
    def create(cls, root: Path, *, protected: bool = False) -> "ReleaseStore":
        root = Path(root)
        (root / "releases").mkdir(parents=True, exist_ok=True)
        atomic_write_text(root / "store.json",
                          json.dumps({"protected": protected}))
        return cls(root)

    @property
    def protected(self) -> bool:
        cfg = self.root / "store.json"
        return bool(json.loads(cfg.read_text()).get("protected")) if cfg.exists() else False

    def _check_write(self) -> None:
        if self.protected and not self.token:
            raise ReleaseError(
                f"release store {self.root} is protected; set {TOKEN_ENV} to upload")

    # - releases -

    def _release_path(self, tag: str) -> Path:
        if not tag or "/" in tag or tag.startswith("."):
            raise ReleaseError(f"invalid release tag {tag!r}")
        return self.releases_dir / tag

    def _load_release(self, tag: str) -> dict:
        path = self._release_path(tag) / "release.json"
        if not path.exists():
            raise ReleaseError(f"no release tagged {tag!r} in {self.root}")
        return json.loads(path.read_text())

    def _save_release(self, tag: str, doc: dict) -> None:
        atomic_write_text(self._release_path(tag) / "release.json",
                          json.dumps(doc, indent=1, sort_keys=True))

    def create_release(self, tag: str, *, notes: str = "") -> dict:
        """Idempotent: returns the existing release if the tag exists."""
        path = self._release_path(tag)
        if (path / "release.json").exists():
            return self._load_release(tag)
        self._check_write()
        (path / "assets").mkdir(parents=True, exist_ok=True)
        doc = {"tag": tag, "notes": notes, "created": time.time(), "assets": {}}
        self._save_release(tag, doc)
        return doc

    def list_releases(self) -> list[str]:
        if not self.releases_dir.is_dir():
            return []
        return sorted(p.name for p in self.releases_dir.iterdir()
                      if (p / "release.json").exists())

    # - assets -

    def upload_asset(self, tag: str, archive_path: Path, *, artifact_id: str,
                     recipe: str, version: str, python: str, device: str) -> Asset:
        """Upload a packed bundle as a release asset (call stack C's
        'create/append release, upload asset' step)."""
        self._check_write()
        archive_path = Path(archive_path)
        doc = self.create_release(tag)
        name = f"{artifact_id}.tar.gz"
        dst = self._release_path(tag) / "assets" / name
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_suffix(".tmp")
        shutil.copyfile(archive_path, tmp)
        os.replace(tmp, dst)
        asset = Asset(
            name=name, tag=tag, size=dst.stat().st_size,
            # sha256 always: asset hashes must verify on machines without
            # the optional native xxh64 extension (the fetch side of the
            # "users never compile" channel)
            hash=hash_file(dst, algo="sha256"), artifact_id=artifact_id,
            recipe=recipe, version=version, python=python, device=device,
            uploaded=time.time(),
        )
        doc["assets"][name] = asdict(asset)
        self._save_release(tag, doc)
        return asset

    def list_assets(self, tag: str | None = None) -> list[Asset]:
        tags = [tag] if tag else self.list_releases()
        out: list[Asset] = []
        for t in tags:
            doc = self._load_release(t)
            out.extend(Asset(**a) for a in doc["assets"].values())
        return out

    def find_asset(self, *, recipe: str, python: str,
                   device: str | None = None,
                   version: str | None = None) -> Asset | None:
        """Newest asset matching recipe × python (× device/version), the
        release-index lookup of call stack A. ``device=None`` accepts any;
        a concrete device also accepts ``any``-device assets."""
        matches = [
            a for a in self.list_assets()
            if a.recipe == recipe and a.python == python
            and (version is None or a.version == version)
            and (device is None or a.device in (device, "any"))
        ]
        return max(matches, key=lambda a: a.uploaded) if matches else None

    def asset_path(self, asset: Asset) -> Path:
        path = self._release_path(asset.tag) / "assets" / asset.name
        if not path.exists():
            raise ReleaseError(f"asset {asset.name!r} missing from release {asset.tag!r}")
        return path


# -- user-side fetch path ----------------------------------------------------


class ReleaseFetcher:
    """Download + verify + cache release assets (call stack A's hit branch:
    'download artifact; unpack into build dir; cache')."""

    def __init__(self, store: ReleaseStore, cache_dir: Path | None = None):
        self.store = store
        self.cache_dir = Path(
            cache_dir or os.environ.get("LAMBDIPY_CACHE_DIR") or DEFAULT_CACHE)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _cache_path(self, asset: Asset) -> Path:
        # content-addressed: a re-published asset with new bytes gets a new
        # cache entry instead of silently shadowing the old one
        return self.cache_dir / f"{asset.hash.replace(':', '-')}-{asset.name}"

    def fetch(self, asset: Asset) -> Path:
        """Return a verified local archive for the asset (cache hit = no
        store access beyond metadata)."""
        cached = self._cache_path(asset)
        if cached.exists() and hash_file(cached, algo=asset.hash.split(":", 1)[0]) == asset.hash:
            return cached
        src = self.store.asset_path(asset)
        tmp = cached.with_suffix(".tmp")
        shutil.copyfile(src, tmp)
        got = hash_file(tmp, algo=asset.hash.split(":", 1)[0])
        if got != asset.hash:
            tmp.unlink()
            raise ReleaseError(
                f"asset {asset.name!r} failed verification: index says "
                f"{asset.hash}, downloaded {got}")
        os.replace(tmp, cached)
        return cached

    def fetch_into_registry(self, asset: Asset, registry) -> Path:
        """Fetch + unpack an asset into the local artifact registry; returns
        the bundle path. After this, deploy/serve behave exactly as if the
        artifact had been built locally."""
        import tempfile

        archive = self.fetch(asset)
        with tempfile.TemporaryDirectory(prefix="lambdipy-fetch-") as td:
            bundle = unpack_archive(archive, Path(td) / "bundle")
            manifest = None
            mpath = bundle / "manifest.json"
            if mpath.exists():
                manifest = json.loads(mpath.read_text())
            return registry.publish(
                asset.artifact_id, bundle, recipe=asset.recipe,
                version=asset.version, device=asset.device, manifest=manifest)


def default_store(path: str | os.PathLike | None = None) -> ReleaseStore | None:
    """Resolve the release store from an explicit path or the
    ``LAMBDIPY_RELEASE_STORE`` env var; None when neither is set."""
    root = path or os.environ.get(STORE_ENV)
    return ReleaseStore(Path(root)) if root else None
