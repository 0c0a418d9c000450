"""The port's safetensors reader and writer against the ``safetensors``
package: every dtype, 0-d and empty tensors, metadata, a sharded index,
bf16 through ``safetensors.torch``, files written by each read by the
other with equal arrays, and malformed headers refused."""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from quantizations_tpu_torch.models import safetensors_io as sio

torch.set_num_threads(1)

_RNG = np.random.default_rng(0)
ARRAYS = {
    "f64": _RNG.standard_normal((3, 4)),
    "f32": _RNG.standard_normal((5, 7)).astype(np.float32),
    "f16": _RNG.standard_normal((2, 3)).astype(np.float16),
    "i64": _RNG.integers(-2**40, 2**40, (6,)),
    "i32": _RNG.integers(-2**31, 2**31 - 1, (3, 1), dtype=np.int32),
    "i16": _RNG.integers(-2**15, 2**15 - 1, (4,), dtype=np.int16),
    "i8": _RNG.integers(-128, 127, (9,), dtype=np.int8),
    "u8": _RNG.integers(0, 255, (2, 5), dtype=np.uint8),
    "bool": _RNG.integers(0, 2, (7,)).astype(bool),
    "zero_d": np.array(3.5, np.float32),
    "empty": np.zeros((0, 4), np.float32),
    "empty_i8": np.zeros((3, 0), np.int8),
}


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_port_file_read_by_safetensors(tmp_path, name):
    path = str(tmp_path / "a.safetensors")
    sio.save_file({name: ARRAYS[name], "pad": ARRAYS["i8"]}, path)
    got = st_load(path)
    assert _same(got[name], ARRAYS[name]) and _same(got["pad"], ARRAYS["i8"])


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_safetensors_file_read_by_port(tmp_path, name):
    path = str(tmp_path / "a.safetensors")
    st_save({name: ARRAYS[name], "pad": ARRAYS["i8"]}, path)
    got = sio.load_file(path)
    assert _same(got[name].numpy(), ARRAYS[name])
    assert _same(got["pad"].numpy(), ARRAYS["i8"])


def test_whole_set_both_ways_and_metadata(tmp_path):
    a, b = str(tmp_path / "port.safetensors"), str(tmp_path / "st.safetensors")
    sio.save_file(ARRAYS, a, metadata={"format": "pt", "note": "x"})
    st_save(ARRAYS, b, metadata={"format": "np"})
    got = st_load(a)
    for k, v in ARRAYS.items():
        assert _same(got[k], v), k
    with safe_open(a, "np") as f:
        assert f.metadata() == {"format": "pt", "note": "x"}
    port = sio.SafetensorsFile(b)
    assert port.metadata == {"format": "np"}
    assert set(port.keys()) == set(ARRAYS)
    for k, v in ARRAYS.items():
        assert _same(port.get(k).numpy(), v), k


def test_header_padding_and_layout(tmp_path):
    """The header is padded with spaces to a multiple of 8 and every
    tensor starts at a multiple of its item size."""
    path = tmp_path / "a.safetensors"
    sio.save_file({"b": np.zeros(3, np.int8), "a": np.ones(2, np.float64),
                   "c": np.ones(1, np.float16)}, str(path))
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    assert n % 8 == 0 and raw[8:8 + n].decode().endswith(("}", " "))
    header = json.loads(raw[8:8 + n])
    for name, e in header.items():
        item = {"F64": 8, "F16": 2, "I8": 1}[e["dtype"]]
        assert e["data_offsets"][0] % item == 0, name


def test_bf16_through_safetensors_torch(tmp_path):
    t = {"w": torch.randn(4, 8, generator=torch.Generator().manual_seed(0)
                          ).to(torch.bfloat16),
         "s": torch.tensor(2.5, dtype=torch.bfloat16)}
    a, b = str(tmp_path / "port.safetensors"), str(tmp_path / "st.safetensors")
    sio.save_file(t, a)
    st_save_torch(t, b)
    for path, load in ((a, st_load_torch), (b, sio.load_file)):
        got = load(path)
        for k, v in t.items():
            assert got[k].dtype == torch.bfloat16 and got[k].shape == v.shape
            assert torch.equal(got[k], v), (path, k)


def test_sharded_index(tmp_path):
    """A directory with ``model.safetensors.index.json`` reads each name
    from its shard; a single ``model.safetensors`` reads as one."""
    shard_a = {"x": ARRAYS["f32"], "y": ARRAYS["u8"]}
    shard_b = {"z": ARRAYS["i64"]}
    st_save(shard_a, str(tmp_path / "model-00001-of-00002.safetensors"))
    sio.save_file(shard_b, str(tmp_path / "model-00002-of-00002.safetensors"))
    wm = {"x": "model-00001-of-00002.safetensors",
          "y": "model-00001-of-00002.safetensors",
          "z": "model-00002-of-00002.safetensors"}
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": 0}, "weight_map": wm}))
    read = sio.read_tensors(str(tmp_path))
    assert read.names == {"x", "y", "z"}
    for k, v in {**shard_a, **shard_b}.items():
        assert _same(read(k).numpy(), v), k

    single = tmp_path / "single"
    single.mkdir()
    sio.save_file(shard_a, str(single / "model.safetensors"))
    read = sio.read_tensors(str(single))
    assert read.names == {"x", "y"}
    assert _same(read("y").numpy(), ARRAYS["u8"])
    with pytest.raises(FileNotFoundError):
        sio.read_tensors(str(tmp_path / "nowhere"))


def test_read_owns_its_memory(tmp_path):
    """A read tensor is a copy: writing it leaves the file alone."""
    path = str(tmp_path / "a.safetensors")
    sio.save_file({"x": ARRAYS["f32"]}, path)
    f = sio.SafetensorsFile(path)
    t = f.get("x")
    t.zero_()
    assert _same(f.get("x").numpy(), ARRAYS["f32"])


def _raw(header, data: bytes, n=None) -> bytes:
    js = json.dumps(header).encode()
    return struct.pack("<Q", len(js) if n is None else n) + js + data


def _entry(dtype, shape, begin, end):
    return {"dtype": dtype, "shape": shape, "data_offsets": [begin, end]}


MALFORMED = {
    "overlap": _raw({"a": _entry("F32", [2], 0, 8),
                     "b": _entry("F32", [2], 4, 12)}, bytes(12)),
    "gap": _raw({"a": _entry("F32", [1], 0, 4),
                 "b": _entry("F32", [1], 8, 12)}, bytes(12)),
    "past_end": _raw({"a": _entry("F32", [4], 0, 16)}, bytes(8)),
    "short_of_end": _raw({"a": _entry("F32", [1], 0, 4)}, bytes(8)),
    "header_past_end": _raw({"a": _entry("F32", [1], 0, 4)}, bytes(4),
                            n=10 ** 6),
    "not_json": struct.pack("<Q", 4) + b"{{{{",
    "not_object": _raw([1, 2], b""),
    "unknown_dtype": _raw({"a": _entry("F8", [4], 0, 4)}, bytes(4)),
    "shape_mismatch": _raw({"a": _entry("F32", [3], 0, 8)}, bytes(8)),
    "negative_dim": _raw({"a": _entry("F32", [-1], 0, 0)}, b""),
    "no_offsets": _raw({"a": {"dtype": "F32", "shape": [1]}}, bytes(4)),
    "truncated": b"\x01\x02",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_header_raises(tmp_path, case):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(MALFORMED[case])
    with pytest.raises(ValueError):
        sio.SafetensorsFile(str(path))


def test_writer_refuses_what_the_format_lacks(tmp_path):
    path = str(tmp_path / "a.safetensors")
    with pytest.raises(ValueError):
        sio.save_file({"x": np.zeros(2, np.complex64)}, path)
    with pytest.raises(ValueError):
        sio.save_file({"x": np.zeros(2, np.float32)}, path,
                      metadata={"k": 1})
    with pytest.raises(ValueError):
        sio.save_file({"__metadata__": np.zeros(1, np.float32)}, path)
