"""Native (C++) host-side data core, bound with ctypes (``tpuic/native``).

Two shared libraries from the C++ sources beside this file, which are
byte for byte ``tpuic``'s:

- ``dataprep`` (``dataprep.cpp``): the fused resize + augment + normalise
  pass over one decoded image (the decode path's ``load``).
- ``decode`` (``decode.cpp``): libjpeg/libpng decode and nearest resize to
  ``[S, S, 3]`` uint8.  JPEG decodes DCT-scaled, so its pixels differ from
  PIL's below full scale; PNG is bitwise the PIL + NumPy path's.  The pack
  (``tpuic_torch/data/pack.py``) decodes through it.

Each is compiled at first use, never at import, with

    g++ -O3 -shared -fPIC -std=c++17 <src> \
        -o tpuic_torch/_build/lib<name>-<hash>.so

(``-ljpeg -lpng`` for ``decode``), where the hash covers the flags and
the source, so an edited source rebuilds and an unchanged one loads from
the build directory.  Each build writes a file of its own and renames it
into place, so processes that build at once leave one whole library.  An
ABI-version symbol gates the load.

When no compiler is present or the build fails (``decode.cpp`` needs
``jpeglib.h`` and ``png.h``), the binding is unavailable and callers use
PIL and the NumPy transforms, which give the same PNG bits.  ``status()``
says which, with the compiler's first error line.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_COMPILERS = ("g++", "c++", "clang++")

_lock = threading.Lock()


def _first_error(text: str) -> str:
    """The compiler's first line that names an error, else its first line."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    for ln in lines:
        if "error" in ln.lower():
            return ln
    return lines[0] if lines else "no output"


class _Lib:
    """Build-on-first-use ctypes library with an ABI version gate."""

    def __init__(self, src: str, name: str, abi_symbol: str, abi: int,
                 link: Sequence[str] = ()) -> None:
        self.src = _HERE / src
        self.name = name
        self.abi_symbol = abi_symbol
        self.abi = abi
        self.link = list(link)
        self._lib = None
        self._tried = False
        self.error: Optional[str] = None

    @property
    def path(self) -> Path:
        h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(self.link)).encode())
        h.update(self.src.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def _build(self) -> Optional[Path]:
        """Compile into a file of this process's own, then rename it into
        place; the temporary file is removed on every other path."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        errors = []
        for cxx in _COMPILERS:
            tmp = self.path.with_suffix(f".{os.getpid()}.tmp.so")
            try:
                r = subprocess.run(
                    [cxx, *CXX_FLAGS, str(self.src), "-o", str(tmp),
                     *self.link], capture_output=True, text=True,
                    timeout=120)
                if r.returncode == 0:
                    os.replace(tmp, self.path)
                    return self.path
                errors.append(f"{cxx}: {_first_error(r.stderr)}")
            except FileNotFoundError:
                continue
            except (OSError, subprocess.TimeoutExpired) as e:
                errors.append(f"{cxx}: {e}")
            finally:
                tmp.unlink(missing_ok=True)
        self.error = (errors[0] if errors else
                      f"no C++ compiler found ({', '.join(_COMPILERS)})")
        return None

    def _open(self, path: Optional[Path]):
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            if int(getattr(lib, self.abi_symbol)()) != self.abi:
                self.error = f"{path.name}: ABI version mismatch"
                return None
            return lib
        except (OSError, AttributeError) as e:
            self.error = f"{path.name}: {e}"
            return None

    def load(self):
        with _lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            lib = self._open(self.path) if self.path.is_file() else None
            if lib is None:
                lib = self._open(self._build())
            self._lib = lib
            return lib


_dataprep = _Lib("dataprep.cpp", "tpuic_dataprep",
                 "tpuic_dataprep_abi_version", 1)
_decode = _Lib("decode.cpp", "tpuic_decode", "tpuic_decode_abi_version", 1,
               link=["-ljpeg", "-lpng"])


def _load():
    lib = _dataprep.load()
    if lib is not None and not getattr(lib, "_sigs_set", False):
        lib.tpuic_prep_image.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.tpuic_prep_image.restype = None
        lib._sigs_set = True
    return lib


def _load_decode():
    lib = _decode.load()
    if lib is not None and not getattr(lib, "_sigs_set", False):
        lib.tpuic_decode_resize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.tpuic_decode_resize.restype = ctypes.c_int
        lib._sigs_set = True
    return lib


def available() -> bool:
    return _load() is not None


def decode_available() -> bool:
    return _load_decode() is not None


def status(*names: str) -> dict:
    """Per library (``"decode"``, ``"dataprep"``; default both):
    ``"built"`` or ``"unavailable: <the compiler's first error line>"``,
    building it first if needed."""
    libs = {"decode": (_load_decode, _decode),
            "dataprep": (_load, _dataprep)}
    out = {}
    for key in names or tuple(libs):
        loader, lib = libs[key]
        out[key] = ("built" if loader() is not None
                    else f"unavailable: {lib.error}")
    return out


COLOR_NONE, COLOR_SATURATION, COLOR_BRIGHTNESS, COLOR_CONTRAST = 0, 1, 2, 3


def prep_image(img: np.ndarray, size: int, *, rot_k: int = 0,
               vflip: bool = False, hflip: bool = False,
               color_op: int = COLOR_NONE, factor: float = 1.0,
               mean=None, std=None) -> Optional[np.ndarray]:
    """Fused resize + augment + normalise of an HWC uint8 image: ``[size,
    size, 3]`` float32, or None when the core is unavailable (the caller
    takes the NumPy transforms)."""
    lib = _load()
    if lib is None:
        return None
    from tpuic_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    img = np.ascontiguousarray(img, np.uint8)
    assert img.ndim == 3 and img.shape[2] == 3, img.shape
    mean = np.ascontiguousarray(
        IMAGENET_MEAN if mean is None else mean, np.float32)
    std = np.ascontiguousarray(
        IMAGENET_STD if std is None else std, np.float32)
    out = np.empty((size, size, 3), np.float32)
    lib.tpuic_prep_image(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size,
        int(rot_k) & 3, int(bool(vflip)), int(bool(hflip)), int(color_op),
        float(factor),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def decode_resize(data: bytes, size: int) -> Optional[np.ndarray]:
    """Decode JPEG/PNG bytes and nearest-resize to ``[size, size, 3]``
    uint8; None when the decoder is unavailable or the bytes are not a
    JPEG/PNG it can decode (the caller takes PIL)."""
    lib = _load_decode()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.tpuic_decode_resize(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size), int(size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None
