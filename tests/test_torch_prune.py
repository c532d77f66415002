"""The port's prune pass (``lambdipy_tpu_torch/buildengine/prune.py``) and ELF
guard (``utils/elf.py``) against the JAX package's: one tree gives the same
``PruneReport`` and the same surviving files in both, apart from the
whitelist; the port's whitelist keeps torch's CUDA libraries, the NVIDIA
wheels and triton against any rule (JAX's keeps the XLA/PJRT stack); the
guarded ``strip`` shrinks a real shared object and restores one whose
LOAD alignment it broke; the ELF readers agree on the same bytes. Exact
throughout."""

import shutil
import struct
import subprocess
from pathlib import Path

import pytest

from lambdipy_tpu.buildengine import prune as jprune
from lambdipy_tpu.recipes.schema import PruneSpec as JSpec
from lambdipy_tpu.utils import elf as jelf
from lambdipy_tpu_torch.buildengine import prune as tprune
from lambdipy_tpu_torch.recipes.schema import PruneSpec as TSpec
from lambdipy_tpu_torch.utils import elf as telf

PLAIN = {
    "pkg/__init__.py": b"x = 1\n",
    "pkg/core.py": b"def f(): pass\n",
    "pkg/core.pyi": b"def f() -> None: ...\n",
    "pkg/tests/test_core.py": b"assert True\n",
    "pkg/tests/data/big.bin": b"\0" * 1024,
    "pkg/__pycache__/core.cpython-312.pyc": b"\0" * 10,
    "pkg/docs/index.rst": b"docs\n",
    "pkg/README.md": b"readme\n",
    "pkg/include/pkg.h": b"#define X 1\n",
    "pkg/sub/tests/t.py": b"x\n",
    "pkg-1.0.dist-info/METADATA": b"Name: pkg\n",
    "pkg-1.0.dist-info/RECORD": b"pkg/__init__.py,,\n",
    "pkg-1.0.dist-info/WHEEL": b"Wheel-Version: 1.0\n",
    "pkg-1.0.dist-info/LICENSE.txt": b"MIT\n",
    "pkg-1.0.dist-info/random_extra.txt": b"junk\n",
    "extra/junk/data.json": b"{}\n",
}
# the port's serving stack and JAX's, which only its own whitelist keeps
CUDA_STACK = {
    "torch/lib/libtorch_cuda.so": b"ELFFAKE" * 100,
    "torch/lib/libc10_cuda.so": b"ELFFAKE" * 50,
    "nvidia/cublas/lib/libcublas.so.12": b"ELFFAKE" * 80,
    "nvidia/cudnn/include/cudnn.h": b"#define CUDNN 9\n",
    "triton/backends/nvidia/bin/ptxas": b"ELFFAKE" * 20,
    "triton/tests/test_x.py": b"x\n",
}
TPU_STACK = {
    "libtpu/libtpu.so": b"ELFFAKE" * 100,
    "jaxlib/libjax_common.so": b"ELFFAKE" * 100,
    "jaxlib/_mlir_libs/_mlir.so": b"ELFFAKE" * 10,
}
SPECS = {
    "default": dict(rules=("tests", "pycache", "dist-info-extras", "docs",
                           "pyi", "headers"), strip_so=False),
    "extra": dict(rules=("tests",), extra_remove=("extra/**", "*.md"),
                  strip_so=False),
    "keep": dict(rules=("tests", "docs"), keep=("pkg/tests/test_core.py",),
                 strip_so=False),
    "hostile": dict(rules=("tests", "pycache", "docs", "pyi", "headers"),
                    extra_remove=("*.so", "*.so.*", "torch/**", "nvidia/**",
                                  "triton/**", "libtpu/**", "jaxlib/**"),
                    strip_so=False),
}


def make_tree(root: Path, files: dict) -> Path:
    for rel, content in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(content)
    return root


def files_of(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_one_tree_gives_the_same_report_in_both(spec, tmp_path):
    """No whitelisted entry in the tree: the two passes are one rule
    engine."""
    a = make_tree(tmp_path / "jax", PLAIN)
    b = make_tree(tmp_path / "port", PLAIN)
    want = jprune.prune_tree(a, JSpec(**SPECS[spec]))
    got = tprune.prune_tree(b, TSpec(**SPECS[spec]))
    assert got.as_dict() == want.as_dict()
    assert files_of(b) == files_of(a)


def test_the_whitelists_differ_only_in_the_stack_they_keep(tmp_path):
    tree = {**PLAIN, **CUDA_STACK, **TPU_STACK}
    a = make_tree(tmp_path / "jax", tree)
    b = make_tree(tmp_path / "port", tree)
    jprune.prune_tree(a, JSpec(**SPECS["hostile"]))
    got = tprune.prune_tree(b, TSpec(**SPECS["hostile"]))
    kept, gone = files_of(b), files_of(a)
    for rel, content in CUDA_STACK.items():  # byte for byte, any rule
        assert kept[rel] == content, rel
        assert rel not in gone
    for rel in TPU_STACK:
        assert rel in gone and rel not in kept
    assert {k: v for k, v in kept.items() if k not in CUDA_STACK} == \
        {k: v for k, v in gone.items() if k not in TPU_STACK}
    # a kept file below a removed directory vetoes its removal, reported
    assert got.whitelisted == ["torch/lib"]
    assert tprune.SERVING_WHITELIST == ("*libtorch_cuda*", "*libc10_cuda*",
                                        "nvidia/*", "triton/*")


def test_a_whitelisted_file_vetoes_its_parents_removal(tmp_path):
    site = make_tree(tmp_path / "s", CUDA_STACK)
    tprune.prune_tree(site, TSpec(rules=(), extra_remove=("torch", "nvidia"),
                                  strip_so=False))
    assert files_of(site) == CUDA_STACK


def test_unknown_rules_are_rejected_in_both(tmp_path):
    (tmp_path / "s").mkdir()
    for mod, spec in ((jprune, JSpec), (tprune, TSpec)):
        with pytest.raises(ValueError, match="unknown prune rules"):
            mod.prune_tree(tmp_path / "s", spec(rules=("bogus",)))


def _shared_object(tmp_path, name="mod.so", debug=True) -> Path:
    if not shutil.which("g++"):
        pytest.skip("no g++")
    src = tmp_path / "x.cc"
    src.write_text('extern "C" int forty_two() { return 42; }\n')
    so = tmp_path / name
    subprocess.run(["g++", *(["-g"] if debug else []), "-shared", "-fPIC",
                    "-o", str(so), str(src)], check=True)
    return so


def _misalign(path: Path) -> None:
    """Break the first PT_LOAD's offset/vaddr congruence, as a bad strip
    of an auditwheel-processed object does."""
    data = bytearray(path.read_bytes())
    with open(path, "rb") as f:
        hdr = jelf._read_header(f)
    for i in range(hdr["phnum"]):
        off = hdr["phoff"] + i * hdr["phentsize"]
        if struct.unpack_from("<I", data, off)[0] == 1:
            p_offset = struct.unpack_from("<Q", data, off + 8)[0]
            struct.pack_into("<Q", data, off + 8, p_offset + 1)
            break
    path.write_bytes(bytes(data))


def test_the_elf_guards_agree_on_the_same_bytes(tmp_path):
    so = _shared_object(tmp_path)
    broken = tmp_path / "broken.so"
    broken.write_bytes(so.read_bytes())
    _misalign(broken)
    stripped = _shared_object(tmp_path, "stripped.so", debug=False)
    subprocess.run(["strip", "--strip-unneeded", str(stripped)], check=True)
    text = tmp_path / "notelf.so"
    text.write_bytes(b"ELFFAKE" * 10)
    for path in (so, broken, stripped, text):
        assert telf.is_elf(path) == jelf.is_elf(path)
        assert telf.load_segments_aligned(path) == \
            jelf.load_segments_aligned(path)
        assert telf.strippable_sections(path) == jelf.strippable_sections(path)
    assert telf.load_segments_aligned(so) and \
        not telf.load_segments_aligned(broken)
    assert ".symtab" in telf.strippable_sections(so)
    assert telf.strippable_sections(stripped) == []


def test_strip_shrinks_a_real_object_and_spares_the_whitelist(tmp_path):
    site = tmp_path / "s"
    (site / "torch" / "lib").mkdir(parents=True)
    so = _shared_object(tmp_path)
    shutil.copy(so, site / "mod.so")
    shutil.copy(so, site / "torch" / "lib" / "libtorch_cuda.so")
    before = so.read_bytes()
    report = tprune.prune_tree(site, TSpec(rules=(), strip_so=True))
    assert report.sos_stripped == 1
    assert (site / "mod.so").stat().st_size < len(before)
    assert (site / "torch/lib/libtorch_cuda.so").read_bytes() == before
    assert "torch/lib/libtorch_cuda.so" in report.whitelisted


def test_the_strip_guard_restores_a_broken_object(tmp_path, monkeypatch):
    site = tmp_path / "s"
    site.mkdir()
    so = site / "mod.so"
    shutil.copy(_shared_object(tmp_path), so)
    before = so.read_bytes()
    real_run = subprocess.run

    def breaking_strip(cmd, **kw):
        if cmd[0] == "strip":
            _misalign(Path(cmd[-1]))
            return subprocess.CompletedProcess(cmd, 0, "", "")
        return real_run(cmd, **kw)

    monkeypatch.setattr(tprune.subprocess, "run", breaking_strip)
    report = tprune.prune_tree(site, TSpec(rules=(), strip_so=True))
    monkeypatch.undo()
    assert report.sos_stripped == 0
    assert so.read_bytes() == before
