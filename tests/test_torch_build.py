"""The port's kernel build (``horovod_tpu_torch/ops/build.py``) on the CPU:
what it compiles, what its cache key covers, and that the ctypes
signatures match the C entries in ``csrc/*.cu``.  No compiler is run."""

import ctypes
import re

import pytest

from horovod_tpu_torch.ops import build

PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(hvd_\w+)\s*\(([^)]*)\)')
C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "int64_t": ctypes.c_int64}


def _prototypes():
    """{entry: [ctypes type of each parameter]} parsed from the sources:
    a pointer as c_void_p, else by its type's name."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for name, params in PROTOTYPE.findall(src.read_text()):
            types = []
            for param in params.split(","):
                words = param.replace("const", " ").split()
                if "*" in param:
                    types.append(ctypes.c_void_p)
                else:
                    types.append(C_TYPES[words[0]])
            found[name] = types
    return found


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "x.cuh"\n')
    (tmp_path / "b.cu").write_text("// b\n")
    (tmp_path / "x.cuh").write_text("// header\n")
    (tmp_path / "notes.txt").write_text("not a source\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_only_cu_files_are_compile_units(csrc):
    assert [p.name for p in build._sources()] == ["a.cu", "b.cu"]


@pytest.mark.parametrize("edit", ["x.cuh", "a.cu", "b.cu"])
def test_digest_follows_sources_and_headers(csrc, edit):
    """An edited header rebuilds the library as an edited source does."""
    before = build._digest()
    assert build._digest() == before
    path = csrc / edit
    path.write_text(path.read_text() + "// edited\n")
    assert build._digest() != before


def test_digest_ignores_other_files(csrc):
    before = build._digest()
    (csrc / "notes.txt").write_text("edited\n")
    assert build._digest() == before


def test_digest_follows_a_new_header(csrc):
    before = build._digest()
    (csrc / "y.cuh").write_text("// new\n")
    assert build._digest() != before


def test_the_repo_has_a_shared_header():
    """The TMA/wgmma kernels include csrc/sm90.cuh, which the digest
    covers though it is no compile unit."""
    names = {p.name for p in build._sources()}
    assert "sm90.cuh" not in names
    assert (build.CSRC / "sm90.cuh").exists()
    for src in ("matmul.cu", "flash_attention.cu"):
        assert '#include "sm90.cuh"' in (build.CSRC / src).read_text()


def test_every_entry_has_its_signature():
    protos = _prototypes()
    assert set(protos) == set(build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_signature_matches_the_source(name):
    """Each ctypes signature has the C entry's parameters, in order, with
    every pointer (tensors and the stream) as c_void_p: ctypes would pass
    an unannotated Python int as a 32-bit int and cut a pointer."""
    assert build._SIGNATURES[name] == _prototypes()[name]
