"""The safetensors file format, read and written with numpy and torch only
(the port's own copy of what the ``safetensors`` package does for the
JAX package's loaders).

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of
UTF-8 JSON, then the raw tensor bytes. The JSON maps each tensor name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
byte section) and may hold ``"__metadata__"``, a string-to-string map.
The header is padded with spaces to a multiple of 8 bytes, as
``safetensors`` writes it.

:func:`read_tensors` reads a model directory one tensor per call through
a memory map, so peak host memory is one tensor. bf16 has no numpy type:
its bytes are read as 16-bit integers and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, Mapping, Optional, Union

import numpy as np
import torch

__all__ = ["SafetensorsFile", "TensorReader", "read_tensors", "load_file",
           "save_file"]

# safetensors dtype code -> numpy storage type (bf16 as int16 bits)
_NP = {"F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
       "BF16": np.dtype("<i2"), "I64": np.dtype("<i8"), "I32": np.dtype("<i4"),
       "I16": np.dtype("<i2"), "I8": np.dtype("i1"), "U8": np.dtype("u1"),
       "BOOL": np.dtype("?")}
_TORCH_CODE = {torch.float64: "F64", torch.float32: "F32",
               torch.float16: "F16", torch.bfloat16: "BF16",
               torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
               torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_NP_CODE = {np.dtype(dt).str.lstrip("<>|="): code for code, dt in (
    ("F64", "<f8"), ("F32", "<f4"), ("F16", "<f2"), ("I64", "<i8"),
    ("I32", "<i4"), ("I16", "<i2"), ("I8", "i1"), ("U8", "u1"),
    ("BOOL", "?"))}

Array = Union[np.ndarray, torch.Tensor]


def _encode(arr: Array):
    """(safetensors dtype code, C-ordered numpy array of the bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype not in _TORCH_CODE:
            raise ValueError(f"safetensors: unsupported dtype {t.dtype}")
        code = _TORCH_CODE[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return code, t.numpy()
    a = np.asarray(arr, order="C")       # keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16":       # ml_dtypes' extension type
        return "BF16", a.view(np.int16)
    key = a.dtype.str.lstrip("<>|=")
    if key not in _NP_CODE or a.dtype.byteorder == ">":
        raise ValueError(f"safetensors: unsupported dtype {a.dtype}")
    return _NP_CODE[key], a


def save_file(tensors: Mapping[str, Array], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (numpy arrays or torch tensors, any device) to
    ``path`` in the safetensors format, with an optional string-to-string
    ``metadata`` map. Tensors are laid out by decreasing item size, then
    name, so every tensor starts at a multiple of its item size."""
    if metadata is not None and not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in metadata.items()):
        raise ValueError("safetensors: metadata must map str to str")
    enc = {}
    for name, arr in tensors.items():
        if name == "__metadata__":
            raise ValueError("safetensors: '__metadata__' is no tensor name")
        enc[name] = _encode(arr)
    order = sorted(enc, key=lambda n: (-enc[n][1].dtype.itemsize, n))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    pos = 0
    for name in order:
        code, a = enc[name]
        header[name] = {"dtype": code, "shape": list(a.shape),
                        "data_offsets": [pos, pos + a.nbytes]}
        pos += a.nbytes
    js = json.dumps(header, separators=(",", ":")).encode("utf-8")
    js += b" " * (-len(js) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(js)))
        f.write(js)
        for name in order:
            a = enc[name][1]
            if a.nbytes:
                f.write(a.reshape(-1).view(np.uint8).data)


class SafetensorsFile:
    """One safetensors file: its header, checked, and a memory map of its
    byte section. :meth:`get` copies one tensor out to a CPU tensor.

    Raises ``ValueError`` on a malformed header: a length past the end of
    the file, JSON that is not an object, an unknown dtype, a shape that
    does not match its byte range, or byte ranges that overlap, leave a
    gap or do not end at the end of the file."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: shorter than the 8-byte header "
                                 "length")
            (n,) = struct.unpack("<Q", head)
            if 8 + n > size:
                raise ValueError(f"{path}: header of {n} bytes runs past "
                                 f"the file's {size}")
            try:
                header = json.loads(f.read(n).decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}: header is not JSON: {e}") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: header is not a JSON object")
        self.metadata = header.pop("__metadata__", None)
        self._start = 8 + n
        self.entries = {}
        spans = []
        for name, e in header.items():
            try:
                code, shape = e["dtype"], [int(s) for s in e["shape"]]
                begin, end = (int(o) for o in e["data_offsets"])
            except (TypeError, KeyError, ValueError):
                raise ValueError(f"{path}: bad entry for {name!r}: {e!r}") \
                    from None
            if code not in _NP:
                raise ValueError(f"{path}: {name!r} has unknown dtype "
                                 f"{code!r}")
            if min(shape, default=0) < 0 or end - begin != \
                    int(np.prod(shape)) * _NP[code].itemsize:
                raise ValueError(f"{path}: {name!r} of shape {shape} and "
                                 f"{code} does not fill bytes {begin}..{end}")
            self.entries[name] = (code, tuple(shape), begin, end)
            spans.append((begin, end, name))
        pos = 0
        for begin, end, name in sorted(spans):
            if begin != pos:
                raise ValueError(f"{path}: {name!r} starts at byte {begin}, "
                                 f"expected {pos} (an overlap or a gap)")
            pos = end
        if self._start + pos != size:
            raise ValueError(f"{path}: tensors end at byte {self._start + pos}"
                             f" but the file has {size}")
        self._mm = (np.memmap(path, dtype=np.uint8, mode="r",
                              offset=self._start, shape=(pos,))
                    if pos else np.zeros(0, np.uint8))

    def keys(self) -> Iterable[str]:
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        """Tensor ``name`` as a CPU tensor that owns its memory."""
        code, shape, begin, end = self.entries[name]
        a = np.frombuffer(self._mm[begin:end], dtype=_NP[code]).reshape(shape)
        t = torch.from_numpy(a.copy())
        return t.view(torch.bfloat16) if code == "BF16" else t


class TensorReader:
    """``read(name) -> CPU tensor`` over a model directory's safetensors
    file or shards, opening each shard at its first read. ``names`` is
    the set of tensor names."""

    def __init__(self, model_dir: str, name2file: Dict[str, str]):
        self.model_dir = model_dir
        self._name2file = name2file
        self._files: Dict[str, SafetensorsFile] = {}
        self.names = set(name2file)

    def _file(self, fname: str) -> SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(
                os.path.join(self.model_dir, fname))
        return self._files[fname]

    def __call__(self, name: str) -> torch.Tensor:
        return self._file(self._name2file[name]).get(name)


def read_tensors(model_dir: str) -> TensorReader:
    """The tensors of an HF model directory: ``model.safetensors``, or the
    shards that ``model.safetensors.index.json``'s ``weight_map`` lists."""
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            name2file = dict(json.load(f)["weight_map"])
        return TensorReader(model_dir, name2file)
    single = os.path.join(model_dir, "model.safetensors")
    if not os.path.exists(single):
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    reader = TensorReader(model_dir, {})
    names = list(reader._file("model.safetensors").keys())
    reader._name2file = dict.fromkeys(names, "model.safetensors")
    reader.names = set(names)
    return reader


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors."""
    f = SafetensorsFile(path)
    return {name: f.get(name) for name in f.keys()}
