"""The port's kernel build cache (``k_llms_tpu_torch/ops/_ext.py``): each
kernel library is named by a hash of its source, of every shared header in
``csrc/`` and of the compiler flags, so an edited header rebuilds every
library and an unchanged tree reuses them. No compiler is needed: these
tests only name the libraries."""

import os
import re
import shutil

import pytest

from k_llms_tpu_torch.ops import _ext

KERNELS = sorted(_ext.KERNELS)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build helper reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_ext.CSRC_DIR, copy)
    monkeypatch.setattr(_ext, "CSRC_DIR", str(copy))
    return copy


@pytest.mark.parametrize("name", KERNELS)
def test_library_path_changes_with_a_shared_header(csrc_copy, name):
    before = _ext.library_path(name)
    header = csrc_copy / "mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _ext.library_path(name)
    assert after != before
    assert os.path.dirname(after) == _ext.BUILD_DIR and after.endswith(".so")


@pytest.mark.parametrize("name", KERNELS)
def test_library_path_changes_with_a_new_header(csrc_copy, name):
    before = _ext.library_path(name)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _ext.library_path(name) != before


def test_library_path_follows_its_own_source_only(csrc_copy):
    """Editing one kernel's source renames that library alone."""
    before = {name: _ext.library_path(name) for name in KERNELS}
    src = csrc_copy / _ext.KERNELS["w4_matmul"][0]
    src.write_text(src.read_text() + "\n// edited\n")
    after = {name: _ext.library_path(name) for name in KERNELS}
    assert after["w4_matmul"] != before["w4_matmul"]
    assert {n: p for n, p in after.items() if n != "w4_matmul"} == {
        n: p for n, p in before.items() if n != "w4_matmul"
    }


def test_unchanged_copy_names_the_same_libraries(csrc_copy, monkeypatch):
    copied = {name: _ext.library_path(name) for name in KERNELS}
    monkeypatch.undo()
    assert {name: _ext.library_path(name) for name in KERNELS} == copied


@pytest.mark.parametrize("name", KERNELS)
def test_every_local_include_is_a_hashed_header(name):
    """A source includes only ``csrc/*.cuh`` files of its own directory
    (which the hash covers), never another ``.cu`` or a path outside."""
    with open(os.path.join(_ext.CSRC_DIR, _ext.KERNELS[name][0])) as f:
        local = re.findall(r'^#include "([^"]+)"', f.read(), flags=re.M)
    for inc in local:
        assert inc.endswith(".cuh") and "/" not in inc
        assert os.path.exists(os.path.join(_ext.CSRC_DIR, inc))
