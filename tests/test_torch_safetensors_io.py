"""The port's safetensors reader and writer (``models/safetensors_io.py``)
against the ``safetensors`` package: files the package writes read back
equal through the port, files the port writes read back equal through the
package, across the six dtypes the loader handles; a truncated file and an
offset past the data raise."""

import json
import struct

import numpy as np
import pytest
import torch

from k_llms_tpu_torch.models.safetensors_io import SafetensorsFile, save_file

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.int32, torch.int64]


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = (3, 5 + i) if i % 2 else (7 + i,)
        if dt.is_floating_point:
            t = (torch.randn(shape, generator=g) * 100).to(dt)
        else:
            info = torch.iinfo(dt)
            t = torch.randint(max(info.min, -2**40), min(info.max, 2**40), shape, generator=g,
                              dtype=torch.int64).to(dt)
        out[f"t.{str(dt).replace('torch.', '')}"] = t
    out["scalar"] = torch.tensor(4, dtype=torch.int32)
    out["empty"] = torch.zeros((0, 3), dtype=torch.float32)
    return out


def _same(a, b):
    assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
    assert torch.equal(a.reshape(-1).view(torch.uint8) if a.numel() else a,
                       b.reshape(-1).view(torch.uint8) if b.numel() else b)


def test_reader_matches_safe_open(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file as st_save

    tensors = _tensors()
    path = str(tmp_path / "a.safetensors")
    st_save(tensors, path, metadata={"format": "pt", "note": "x"})
    f = SafetensorsFile(path)
    assert f.metadata == {"format": "pt", "note": "x"}
    with safe_open(path, framework="pt") as ref:
        assert sorted(f.keys()) == sorted(ref.keys())
        for key in ref.keys():
            got = f.get_tensor(key)
            _same(got, ref.get_tensor(key))
            assert f.shape(key) == tuple(got.shape) and f.dtype(key) == got.dtype


def test_bf16_is_a_view_of_the_mapping(tmp_path):
    """BF16 comes out of the mapped file without a copy: the tensor's
    storage is the mapping's, and a write to it (the mapping is private)
    leaves the file as it was."""
    from safetensors.torch import save_file as st_save

    t = torch.arange(64, dtype=torch.float32).to(torch.bfloat16).reshape(8, 8)
    path = str(tmp_path / "b.safetensors")
    st_save({"w": t}, path)
    f = SafetensorsFile(path)
    a, b = f.get_tensor("w"), f.get_tensor("w")
    assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    a[0, 0] = 99.0
    assert b[0, 0].item() == 99.0  # same mapping
    _same(SafetensorsFile(path).get_tensor("w"), t)


def test_writer_read_back_by_safetensors(tmp_path):
    from safetensors import safe_open

    tensors = _tensors(1)
    path = str(tmp_path / "c.safetensors")
    written = save_file(tensors, path, metadata={"format": "k_llms_tpu_torch.params"})
    assert written == len(open(path, "rb").read())
    (n,) = struct.unpack("<Q", open(path, "rb").read(8))
    assert n % 8 == 0
    with safe_open(path, framework="pt") as ref:
        assert ref.metadata() == {"format": "k_llms_tpu_torch.params"}
        assert sorted(ref.keys()) == sorted(tensors)
        for key, t in tensors.items():
            _same(ref.get_tensor(key), t)
    # and by the port's own reader
    f = SafetensorsFile(path)
    for key, t in tensors.items():
        _same(f.get_tensor(key), t)


def test_writer_takes_non_contiguous_views(tmp_path):
    """A transposed view is written in its logical (row-major) order."""
    from safetensors.numpy import load_file

    w = torch.randn(4, 6)
    path = str(tmp_path / "d.safetensors")
    save_file({"wt": w.t()}, path)
    np.testing.assert_array_equal(load_file(path)["wt"], w.t().numpy())


def _write_raw(path, header, data):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["truncated_data", "offset_past_end", "header_past_end",
                                  "shape_disagrees", "unsupported_dtype", "too_short"])
def test_corrupt_files_raise(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    good = {"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}
    if case == "truncated_data":
        tensors = _tensors(2)
        save_file(tensors, path)
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:-5])
    elif case == "offset_past_end":
        _write_raw(path, {"w": {"dtype": "F32", "shape": [4], "data_offsets": [16, 32]}}, bytes(16))
    elif case == "header_past_end":
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 1 << 20) + b"{}")
    elif case == "shape_disagrees":
        _write_raw(path, {"w": {"dtype": "F32", "shape": [5], "data_offsets": [0, 16]}}, bytes(16))
    elif case == "unsupported_dtype":
        _write_raw(path, {"w": {"dtype": "F64", "shape": [2], "data_offsets": [0, 16]}}, bytes(16))
    else:
        open(path, "wb").write(b"\x01\x02")
    with pytest.raises(ValueError):
        SafetensorsFile(path)
    # The well-formed twin of these headers reads.
    ok = str(tmp_path / "ok.safetensors")
    _write_raw(ok, good, np.arange(4, dtype=np.float32).tobytes())
    assert SafetensorsFile(ok).get_tensor("w").tolist() == [0.0, 1.0, 2.0, 3.0]
