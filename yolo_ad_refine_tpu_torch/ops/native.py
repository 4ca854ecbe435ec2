"""ctypes bindings for the port's native C++ host ops: greedy NMS and
letterbox (``csrc/yat_ops.cpp``) and the threaded JPEG loader
(``csrc/yat_loader.cpp``).

Counterpart of ``yolo_ad_refine_tpu/ops/native.py``, with its functions,
signatures and return values. Each library is compiled at first use into
``csrc/build/lib<name>-<hash>.so``; the hash covers the source, the
compiler and the flags, so an edited source is rebuilt. Nothing is built at
import. The loader decodes with libjpeg (``g++ ... -ljpeg``, as in the JAX
package); on a machine without libjpeg's header or library it is built
with nvJPEG instead (``nvcc ... -DYAT_NVJPEG -lnvjpeg``: the planes are
decoded on the GPU, then upsampled and converted to BGR on the host by
libjpeg's own filters, and letterboxed there), and ``loader_decoder()``
says which one loaded. A build that fails raises,
naming the missing compiler, header or library and carrying the compiler's
log: nothing falls back to cv2 (the JAX package warns and returns None).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from yolo_ad_refine_tpu_torch.utils import LOGGER, kernels

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = CSRC / "build"
CXX = "g++"
# library -> (source, compiler: "cxx" or "nvcc", flags before the source, flags after it)
BUILDS = {
    "yat_ops": ("yat_ops.cpp", "cxx", ["-O3", "-shared", "-fPIC"], []),
    "yat_loader": ("yat_loader.cpp", "cxx", ["-O3", "-shared", "-fPIC"], ["-ljpeg"]),
    "yat_loader_nvjpeg": ("yat_loader.cpp", "nvcc",
                          ["-O3", "-shared", "-Xcompiler", "-fPIC", "-x", "cu", "-DYAT_NVJPEG"],
                          ["-lnvjpeg"]),
}
DECODERS = {"yat_loader": "libjpeg", "yat_loader_nvjpeg": "nvJPEG"}

_libs: dict[str, ctypes.CDLL] = {}
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_uint8_p = ctypes.POINTER(ctypes.c_uint8)


def _compiler(name: str) -> str:
    """The compiler of ``name``'s build; raises when it is not installed."""
    if BUILDS[name][1] == "nvcc":
        try:
            return kernels.nvcc_path()
        except RuntimeError as e:
            raise RuntimeError(f"native {name}: {e}") from None
    if shutil.which(CXX) is None:
        raise RuntimeError(f"native {name}: the C++ compiler {CXX!r} was not found; it builds "
                           f"csrc/{BUILDS[name][0]}")
    return CXX


def library_path(name: str) -> Path:
    src, kind, pre, post = BUILDS[name]
    flags = " ".join([CXX if kind == "cxx" else kind, *pre, *post])
    digest = hashlib.sha256((CSRC / src).read_bytes() + flags.encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def _cause(log: str) -> str:
    """What the compiler's or the dynamic loader's message says is missing."""
    if "jpeglib.h" in log:
        return "the libjpeg header jpeglib.h is missing (libjpeg's development files)"
    if "cannot find -ljpeg" in log or "libjpeg.so" in log:
        return "the libjpeg library (libjpeg.so) is missing"
    if "nvjpeg" in log:
        return "nvJPEG (nvjpeg.h, libnvjpeg.so of the CUDA toolkit) is missing"
    return "the compiler failed"


def build(name: str) -> Path:
    """Compile library ``name`` unless it is built; returns its path.
    Raises RuntimeError with the cause and the compiler's log."""
    out = library_path(name)
    if out.exists():
        return out
    src, _, pre, post = BUILDS[name]
    cc = _compiler(name)
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cc, *pre, str(CSRC / src), "-o", str(tmp), *post]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        log = (proc.stdout + proc.stderr).strip()
        raise RuntimeError(f"native {name}: {_cause(log)}: {' '.join(cmd)} exited "
                           f"{proc.returncode}:\n{log}")
    os.replace(tmp, out)
    LOGGER.info(f"built native {name}: {out.name}")
    return out


def _open(name: str, signatures: dict) -> ctypes.CDLL:
    path = build(name)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:  # built elsewhere, or against a library this machine lacks
        raise RuntimeError(f"native {name}: {_cause(str(e))}: {path} does not load: {e}") from e
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def get_lib() -> ctypes.CDLL:
    """The native NMS / letterbox library, built at first use."""
    if "yat_ops" not in _libs:
        _libs["yat_ops"] = _open("yat_ops", {
            "yat_nms": (ctypes.c_int, [_c_float_p, _c_float_p, _c_float_p, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]),
            "yat_letterbox": (None, [_c_uint8_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, _c_uint8_p, _c_float_p]),
        })
    return _libs["yat_ops"]


_LOADER_SIGNATURES = {
    "yat_load_image": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, _c_uint8_p, _c_float_p]),
    "yat_loader_create": (ctypes.c_void_p, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "yat_loader_next": (ctypes.c_int, [ctypes.c_void_p, _c_uint8_p, _c_float_p]),
    "yat_loader_next_indexed": (ctypes.c_int, [ctypes.c_void_p, _c_uint8_p, _c_float_p,
                                               ctypes.POINTER(ctypes.c_int)]),
    "yat_loader_destroy": (None, [ctypes.c_void_p]),
}


def get_loader_lib() -> ctypes.CDLL:
    """The native JPEG loader, built at first use: with libjpeg, or with
    nvJPEG where libjpeg's header or library is missing. Raises when
    neither builds, with both causes."""
    if "loader" not in _libs:
        try:
            _libs["loader"] = _open("yat_loader", _LOADER_SIGNATURES)
            _libs["loader"].decoder = "libjpeg"
        except RuntimeError as e:
            if "libjpeg" not in str(e).split(":\n")[0]:
                raise
            try:
                lib = _open("yat_loader_nvjpeg", _LOADER_SIGNATURES)
            except RuntimeError as e2:
                raise RuntimeError(f"native loader: neither decoder builds:\n{e}\n{e2}") from e2
            LOGGER.info(f"native loader: {_cause(str(e))}; it decodes with nvJPEG")
            lib.decoder = "nvJPEG"
            _libs["loader"] = lib
    return _libs["loader"]


def loader_decoder() -> str:
    """"libjpeg" or "nvJPEG": the decoder of the loader, built if needed."""
    return get_loader_lib().decoder


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_c_float_p)


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_c_uint8_p)


def nms_native(boxes: np.ndarray, scores: np.ndarray, cls: np.ndarray,
               iou_thres: float = 0.45, conf_thres: float = 0.25, max_det: int = 300,
               max_wh: float = 7680.0, agnostic: bool = False) -> np.ndarray:
    """Greedy NMS in C++ over (n, 4) xyxy boxes, their scores and classes.
    Returns the kept indices, score-descending."""
    lib = get_lib()
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    scores = np.ascontiguousarray(scores, np.float32)
    cls = np.ascontiguousarray(cls, np.float32)
    if not len(boxes) == len(scores) == len(cls):
        raise ValueError(f"nms_native: {len(boxes)} boxes, {len(scores)} scores, "
                         f"{len(cls)} classes")
    keep = np.zeros(len(boxes), np.int32)
    n = lib.yat_nms(_fptr(boxes), _fptr(scores), _fptr(cls), len(boxes), iou_thres, conf_thres,
                    max_det, max_wh, int(agnostic),
                    keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return keep[:n]


def letterbox_native(img: np.ndarray, size: int, scaleup: bool = True):
    """C++ letterbox of an (h, w, 3) uint8 image. Returns (out uint8
    (size, size, 3), (ratio, ratio), (dw, dh))."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"letterbox_native takes an (h, w, 3) image, not {img.shape}")
    h, w = img.shape[:2]
    out = np.empty((size, size, 3), np.uint8)
    meta = np.zeros(3, np.float32)
    lib.yat_letterbox(_u8ptr(img), h, w, size, int(scaleup), _u8ptr(out), _fptr(meta))
    return out, (float(meta[0]), float(meta[0])), (float(meta[1]), float(meta[2]))


def load_image_native(path: str, imgsz: int):
    """Decode and letterbox one JPEG natively. Returns (img (s, s, 3) BGR
    uint8, (h0, w0), ratio, (dw, dh)), or None for a file libjpeg cannot
    decode (the loader's own rule: such files are skipped)."""
    lib = get_loader_lib()
    out = np.empty((imgsz, imgsz, 3), np.uint8)
    meta = np.zeros(5, np.float32)
    if lib.yat_load_image(str(path).encode(), imgsz, _u8ptr(out), _fptr(meta)) != 0:
        return None
    return out, (int(meta[0]), int(meta[1])), float(meta[2]), (float(meta[3]), float(meta[4]))


class NativeBatchLoader:
    """Threaded decode + letterbox batches over a list of JPEG paths, in
    order; a file libjpeg cannot decode is skipped. Iterates (imgs (b, s, s,
    3) uint8 BGR, meta (b, 5) [h0, w0, r, dw, dh]); ``indices`` holds the
    last batch's positions in ``paths``."""

    def __init__(self, paths, imgsz: int, batch: int, threads: int = 4):
        self._lib = get_loader_lib()
        self.paths = [str(p) for p in paths]
        self.imgsz = imgsz
        self.batch = batch
        self._keepalive = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._h = self._lib.yat_loader_create(self._keepalive, len(self.paths), imgsz, batch,
                                              threads)
        self.indices = np.zeros(0, np.int32)

    def __iter__(self):
        while self._h:
            imgs = np.empty((self.batch, self.imgsz, self.imgsz, 3), np.uint8)
            meta = np.zeros((self.batch, 5), np.float32)
            idx = np.zeros(self.batch, np.int32)
            n = self._lib.yat_loader_next_indexed(self._h, _u8ptr(imgs), _fptr(meta),
                                                  idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
            if n == 0:
                break
            self.indices = idx[:n]
            yield imgs[:n], meta[:n]

    def close(self):
        if self._h:
            self._lib.yat_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        if hasattr(self, "_h"):
            self.close()
