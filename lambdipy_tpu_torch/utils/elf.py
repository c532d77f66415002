"""Minimal ELF inspection for the prune pass — no external deps; the twin
of ``lambdipy_tpu/utils/elf.py``, byte for byte in what it reads.

Why this exists: ``strip --strip-unneeded`` corrupts some manylinux-built
shared objects (observed live on numpy's bundled
``libscipy_openblas64_.so``: post-strip the dynamic loader rejects it with
"ELF load command address/offset not page-aligned"). Those wheels are
post-processed by auditwheel/patchelf and carry LOAD segments whose
offset/vaddr congruence binutils strip does not preserve. The prune pass
therefore (a) only strips objects that actually have strippable sections,
and (b) validates LOAD alignment after stripping, restoring the original
bytes when strip broke it: one wrong ``strip`` breaks imports in ways
only the fresh-interpreter smoke catches.
"""

from __future__ import annotations

import struct
from pathlib import Path

_ELF_MAGIC = b"\x7fELF"
_PT_LOAD = 1


def is_elf(path: Path) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == _ELF_MAGIC
    except OSError:
        return False


def _read_header(f) -> dict | None:
    ident = f.read(16)
    if len(ident) < 16 or ident[:4] != _ELF_MAGIC:
        return None
    if ident[4] != 2 or ident[5] != 1:  # only ELF64 little-endian (x86-64 / arm64 hosts)
        return None
    rest = f.read(48)
    if len(rest) < 48:
        return None
    (e_type, e_machine, e_version, e_entry, e_phoff, e_shoff, e_flags,
     e_ehsize, e_phentsize, e_phnum, e_shentsize, e_shnum, e_shstrndx) = struct.unpack(
        "<HHIQQQIHHHHHH", rest)
    return {
        "phoff": e_phoff, "phentsize": e_phentsize, "phnum": e_phnum,
        "shoff": e_shoff, "shentsize": e_shentsize, "shnum": e_shnum,
        "shstrndx": e_shstrndx,
    }


def load_segments_aligned(path: Path) -> bool:
    """True when every PT_LOAD segment satisfies p_offset ≡ p_vaddr
    (mod p_align) — the invariant the dynamic loader enforces."""
    with open(path, "rb") as f:
        hdr = _read_header(f)
        if hdr is None:
            return True  # not inspectable -> don't block
        f.seek(hdr["phoff"])
        for _ in range(hdr["phnum"]):
            ent = f.read(hdr["phentsize"])
            if len(ent) < 56:
                return True
            p_type, _flags, p_offset, p_vaddr = struct.unpack("<IIQQ", ent[:24])
            p_align = struct.unpack("<Q", ent[48:56])[0]
            if p_type == _PT_LOAD and p_align > 1:
                if (p_offset % p_align) != (p_vaddr % p_align):
                    return False
    return True


def strippable_sections(path: Path) -> list[str]:
    """Names of .symtab/.debug* sections present — empty means stripping
    would save nothing (manylinux wheels ship pre-stripped)."""
    with open(path, "rb") as f:
        hdr = _read_header(f)
        if hdr is None or hdr["shnum"] == 0:
            return []
        f.seek(hdr["shoff"])
        raw = f.read(hdr["shentsize"] * hdr["shnum"])
        entries = []
        for i in range(hdr["shnum"]):
            ent = raw[i * hdr["shentsize"]:(i + 1) * hdr["shentsize"]]
            if len(ent) < 64:
                return []
            sh_name, _sh_type = struct.unpack("<II", ent[:8])
            sh_offset, sh_size = struct.unpack("<QQ", ent[24:40])
            entries.append((sh_name, sh_offset, sh_size))
        # section name string table
        strndx = hdr["shstrndx"]
        if strndx >= len(entries):
            return []
        str_off, str_size = entries[strndx][1], entries[strndx][2]
        f.seek(str_off)
        strtab = f.read(str_size)
        out = []
        for sh_name, _, _ in entries:
            end = strtab.find(b"\0", sh_name)
            name = strtab[sh_name:end if end >= 0 else None].decode("latin1")
            if name == ".symtab" or name.startswith(".debug"):
                out.append(name)
        return out
