"""Image I/O (mirror of mgm_tpu/io.py, numpy only), with the behavioural
contract of the reference iio layer.

The reference links a 6.2 kLoC C library (iio) whose job here is:
read any of PNG/JPEG/TIFF/PNM/PFM/NPY into planar float32, and write
float images with the format chosen by extension
(iio.c:5154 read, iio.c:5732 write).  The primary implementation is our
native library (native/iio_lite.cc, bound via ctypes) -- format sniffed
by magic number like iio's guess_format (iio.c:4743); Python imaging
libraries are the fallback when the shared object isn't built.
Everything is normalised to channel-last (H, W, C) float32 arrays.
"""
from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

_NATIVE = None


def _native():
    """Load native/libiio_lite.so once; None when unavailable."""
    global _NATIVE
    if _NATIVE is None:
        path = os.path.join(os.path.dirname(__file__), os.pardir, "native",
                            "libiio_lite.so")
        try:
            lib = ctypes.CDLL(os.path.abspath(path))
            lib.iio_lite_read.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.iio_lite_write.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.iio_lite_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            _NATIVE = lib
        except OSError:
            _NATIVE = False
    return _NATIVE or None


def _native_read(path: str) -> np.ndarray | None:
    lib = _native()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_float)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    if lib.iio_lite_read(path.encode(), ctypes.byref(buf), ctypes.byref(w),
                         ctypes.byref(h), ctypes.byref(c)) != 0:
        return None
    try:
        n = w.value * h.value * c.value
        split = np.ctypeslib.as_array(buf, shape=(n,)).copy()
    finally:
        lib.iio_lite_free(buf)
    # split planes (c, h, w) -> (h, w, c)
    return np.moveaxis(split.reshape(c.value, h.value, w.value), 0, -1)


def _native_write(path: str, img: np.ndarray) -> bool:
    lib = _native()
    if lib is None:
        return False
    h, w, c = img.shape
    split = np.ascontiguousarray(np.moveaxis(img, -1, 0), np.float32)
    ptr = split.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    return lib.iio_lite_write(path.encode(), ptr, w, h, c) == 0


def _write_tiff(path: str, img: np.ndarray) -> None:
    """An (H, W, C) float32 array as a baseline little-endian TIFF: one
    uncompressed strip, chunky samples, SampleFormat 3 (IEEE float)."""
    h, w, c = img.shape
    data = np.ascontiguousarray(img, "<f4").tobytes()
    per_sample = struct.pack(f"<{c}H", *[32] * c), struct.pack(
        f"<{c}H", *[3] * c)                # BitsPerSample, SampleFormat
    head = 8 + 2 + 12 * 11 + 4             # header and the IFD's 11 tags
    spill = [v for v in per_sample if len(v) > 4]
    strip = head + sum(len(v) for v in spill)
    spill_at = iter(range(head, strip, len(per_sample[0])))
    ifd = struct.pack("<H", 11)
    for tag, typ, val in ((256, 4, w), (257, 4, h), (258, 3, per_sample[0]),
                          (259, 3, 1), (262, 3, 1), (273, 4, strip),
                          (277, 3, c), (278, 4, h), (279, 4, len(data)),
                          (284, 3, 1), (339, 3, per_sample[1])):
        if isinstance(val, bytes):         # one SHORT per sample
            raw = val if len(val) <= 4 else struct.pack("<I", next(spill_at))
            ifd += struct.pack("<HHI", tag, typ, c) + raw.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHI", tag, typ, 1) + struct.pack(
                "<I" if typ == 4 else "<H", val).ljust(4, b"\0")
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8) + ifd + b"\0" * 4
                + b"".join(spill) + data)


def _read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        nch = 3 if header == b"PF" else 1
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        data = np.frombuffer(f.read(), dtype="<f4" if scale < 0 else ">f4")
        img = data.reshape(h, w, nch).astype(np.float32)
        # PFM scanlines are stored bottom-to-top
        return img[::-1]


def _write_pfm(path: str, img: np.ndarray) -> None:
    if img.shape[2] not in (1, 3):
        raise ValueError("PFM supports 1 or 3 channels")
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.shape[2] == 3 else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1], dtype="<f4").tobytes())


def _read_asc(path: str) -> np.ndarray:
    """iio's ASC format: "w h 1 c" header then w*h*c ascii floats
    (iio.c read_beheaded_asc)."""
    with open(path) as f:
        toks = f.read().split()
    w, h, _, c = (int(t) for t in toks[:4])
    data = np.asarray([float(t) for t in toks[4:4 + w * h * c]],
                      dtype=np.float32)
    return data.reshape(h, w, c)


def read_image(path: str) -> np.ndarray:
    """Read an image as (H, W, C) float32."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".npy", ".asc", ".csv", ".dlm"):
        native = _native_read(path)
        if native is not None:
            return np.asarray(native, np.float32)
    if ext == ".npy":
        img = np.load(path)
    elif ext == ".asc":
        img = _read_asc(path)
    elif ext in (".csv", ".dlm"):
        # single-plane ascii matrices (iio.c read_beheaded_csv/dlm)
        img = np.loadtxt(path, delimiter="," if ext == ".csv" else None,
                         dtype=np.float32)
    elif ext == ".pfm":
        img = _read_pfm(path)
    elif ext in (".tif", ".tiff"):
        # float/multi-sample TIFFs (incl. those written by the reference's
        # iio) exceed PIL's TIFF support; imageio handles them
        import imageio.v3 as iio3

        img = iio3.imread(path)
        if img.ndim == 3 and img.shape[0] in (1, 2, 3, 4) \
                and img.shape[0] < img.shape[2]:
            img = np.moveaxis(img, 0, -1)  # multi-page planar -> HWC
    else:
        from PIL import Image

        with Image.open(path) as im:
            if im.mode in ("I;16", "I;16B", "I;16L"):
                im = im.convert("I")
            img = np.asarray(im)
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def write_image(path: str, img: np.ndarray) -> None:
    """Write an (H, W[, C]) float array; format picked by extension.

    Float-preserving formats: .tif/.tiff (float32 TIFF), .pfm, .npy.
    .png/.jpg are quantised to uint8 (matching iio's behaviour of
    casting floats for integer formats).
    """
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        np.save(path, img)
        return
    if ext == ".asc":
        h, w, c = img.shape
        with open(path, "w") as f:
            f.write(f"{w} {h} 1 {c}\n")
            np.savetxt(f, img.reshape(-1, 1), fmt="%.9g")
        return
    if ext in (".csv", ".dlm"):
        np.savetxt(path, img[:, :, 0],
                   delimiter="," if ext == ".csv" else " ", fmt="%.9g")
        return
    if ext in (".tif", ".tiff", ".pfm", ".png") and _native_write(path, img):
        return
    if ext == ".pfm":
        _write_pfm(path, img)
        return
    if ext in (".tif", ".tiff"):
        _write_tiff(path, img)
        return
    from PIL import Image

    # integer formats: clip to [0, 255] like iio does for png/jpeg
    q = np.clip(np.nan_to_num(img), 0, 255).astype(np.uint8)
    if q.shape[2] == 1:
        Image.fromarray(q[:, :, 0]).save(path)
    else:
        Image.fromarray(q).save(path)
